"""Share of the traced stretch in which the card was idle while the detecting
thread was enqueuing work: innermost in the program's `model.forward`,
`detect.head` or `detect` span.  Where the host is ahead of the card it
holds the card's own gaps between the kernels it already had queued too
(portbench.metrics._spans)."""
from portbench.metrics._spans import idle_pct


def read(run):
    return idle_pct(run, "launch")
