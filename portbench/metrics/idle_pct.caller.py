"""Share of the traced stretch in which the card was idle while the detecting
thread was in none of the program's spans: the caller's own work between
detect calls (portbench.metrics._spans)."""
from portbench.metrics._spans import idle_pct


def read(run):
    return idle_pct(run, "caller")
