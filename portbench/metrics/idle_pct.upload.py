"""Share of the traced stretch in which the card was idle while the detecting
thread was in the program's `detect.upload` span (the pageable copy to the card
and the input's conversion): portbench.metrics._spans."""
from portbench.metrics._spans import idle_pct


def read(run):
    return idle_pct(run, "upload")
