"""Share of the traced stretch in which no operation ran on the card
(kernels, copies and fills merged on the profiler's timeline)."""


def read(run):
    return run.trace.idle_pct() if run.trace else None
