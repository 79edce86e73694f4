"""Fixtures of the benchmark's CPU tests: a checkout root in a temporary
directory holding BENCHMARK.json, the serving cell's entries added, and
copies of the benchmark's data files, with every traffic mix cut to a size
the CPU runs in seconds and the entries' warm-up and traced stretch cut to
match, and a way to run one cell there on the CPU."""
import json
import pathlib
import shutil
import sys
import time

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

DATA_DIRS = ("configs", "traffic", "limits", "metrics")
TINY = {"serve": dict(width=96, height=64, rate_per_s=20, frames=4, check_requests=4,
                      max_batch=4),
        "batch": dict(width=64, height=64, batch=2, distinct_batches=2, check_batches=1)}
# The serving cell's BENCHMARK.json entries: its entry, mix, limits and
# readers are in portbench/, the cell is not in BENCHMARK.json yet (its p95
# spreads too widely for a bound; PERF.md, Open questions).
SERVE_CELL = {
    "workloads": [{"name": "try1.serve", "config": "pyramidbox_try1",
                   "traffic": "open_poisson_640x480", "chips": 1, "why": "serving"}],
    "end_to_end": [{"name": "latency_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": ["try1.serve"]}],
    "per_layer": [{"name": "serve.batch_mean", "unit": "requests", "better": "higher",
                   "source": "program_counter", "layer": "serving", "moves": "latency_p95_ms",
                   "workloads": ["try1.serve"]},
                  {"name": "idle_pct.serve", "unit": "%", "better": "lower",
                   "source": "device_trace", "layer": "device", "moves": "latency_p95_ms",
                   "workloads": ["try1.serve"]}]}


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for key, entries in SERVE_CELL.items():
        bench[key] += entries
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    for d in DATA_DIRS:
        shutil.copytree(REPO / "portbench" / d, tmp / "portbench" / d)
    (tmp / "net_weight").symlink_to(REPO / "net_weight")
    for mix in (tmp / "portbench" / "traffic").glob("*.json"):
        spec = json.loads(mix.read_text())
        spec.update(TINY[spec["kind"]])
        mix.write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    from portbench.entries import batch, serve

    monkeypatch.setattr(batch, "WARMUP_S", 0.0)
    monkeypatch.setattr(batch, "TRACE_S", 0.5)
    monkeypatch.setattr(serve, "WARM_S", 0.5)
    monkeypatch.setattr(serve, "TRACE_S", 0.5)
    return make_root(tmp_path)


def tiny_cells() -> list[str]:
    """The cells of BENCHMARK.json and the serving cell."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"] + SERVE_CELL["workloads"]]


def run_tiny(root, workload, seed=2**31 + 7, seconds=1.0, trace=False, entry=None):
    """One run of `workload` under `root` on the CPU: the result object."""
    import torch

    from portbench import harness
    cell = harness.load_cell(root, workload, seed, seconds, trace, torch.device("cpu"),
                             time.perf_counter())
    return harness.run_cell(cell, entry=entry)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
