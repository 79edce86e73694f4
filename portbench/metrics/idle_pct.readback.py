"""Share of the traced stretch in which the card was idle while the detecting
thread was in the program's `detect.readback` span (the wait for the card, the
copy back, `.numpy()`).  Where the card is behind the host, this holds the
card's own gaps between the kernels still queued, which the host waits out
here: overlapping the copy back moves only the rest (portbench.metrics._spans)."""
from portbench.metrics._spans import idle_pct


def read(run):
    return idle_pct(run, "readback")
