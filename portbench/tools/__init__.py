"""Tools that set the benchmark's fixed numbers once, on the card: the
serving knee (sweep.py) and the readings that the correctness limits are
set from (calibrate.py).  The benchmark's own runs do not run them."""
