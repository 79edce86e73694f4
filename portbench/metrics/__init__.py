"""Per-layer metrics: one reader a metric, in a file named as the metric
(`<name>.py`), whose `read(run)` takes the run's record
(portbench.harness.RunRecord) and returns the number, or None when the run
has nothing for it to read (the harness then leaves the metric out).
Files whose names start with `_` hold the arithmetic the readers share."""
