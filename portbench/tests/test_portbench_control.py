"""The control of the correctness check: the program with its int8 path
switched on, the nearest precision below the configurations' bfloat16, has
to come out not correct, on the card (marked cuda) at each cell's own size
on three seeds, beside the program itself on the same seeds, which has to
come out correct.  At the CPU tests' tiny sizes every box overlaps every
other, so the control is run at the cells' sizes only."""
import json
import time

import pytest

from portbench import harness
from portbench import entries
from portbench.tests.conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def int8_entry(cell):
    control = cell.family.build(cell, quant="int8")
    return entries.load(cell.traffic["kind"]).run(cell, detector=control)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes_on_the_card(workload, cuda_device):
    for seed in SEEDS:
        for entry, want in ((None, True), (int8_entry, False)):
            cell = harness.load_cell(REPO, workload, seed, 3.0, False, cuda_device,
                                     time.perf_counter())
            result = harness.run_cell(cell, entry=entry)
            assert result["correct"] is want, (seed, want, result["checks"])
