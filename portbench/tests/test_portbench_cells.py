"""A tiny CPU run of each cell prints the contract's last line: the device
named cpu, no device metric, every number compared beside its limit."""
import json

import pytest

from portbench import harness
from portbench.tests.conftest import run_tiny, tiny_cells

CELLS = tiny_cells()
DEVICE_METRICS = {"idle_pct.serve", "idle_pct.batch", "mfu.batch", "model.conv_ms",
                  "model.other_ms", "head.ms", "k1_roofline"}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cpu_run_prints_the_result_line(tiny_root, workload, trace, capsys):
    result = run_tiny(tiny_root, workload, trace=trace)
    harness.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 0}
    assert "breakdown" not in line
    names = set(line["metrics"])
    assert not names & DEVICE_METRICS
    if trace:
        assert names == ({"serve.batch_mean"} if workload.endswith(".serve") else set())
    else:
        assert "setup_s" in names and len(names) == 2
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all(" limit " in t for t in tail)
