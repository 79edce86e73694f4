"""Run one cell of BENCHMARK.json once, on the CUDA card(s) of this machine:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line, last on standard output, and each number
the correctness check compared beside its limit, last on standard error.
Exits non-zero, printing no result, without the cards the cell needs,
without the program under test (fdt_torch) or its weights in the checkout,
or when JAX, flax or the JAX package got loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
sys.path.insert(0, str(ROOT))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START, ROOT))
