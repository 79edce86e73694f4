"""Run one cell of BENCHMARK.json once and print its result line.

The cell names a configuration (its file in BENCHMARK.json, whose "family"
picks portbench/families/<family>.py: the program's builder, the reference
and the operation count) and a traffic mix (portbench/traffic/<name>.json,
whose "kind" picks portbench/entries/<kind>.py); its correctness limits are
portbench/limits/<workload>.json and each per-layer metric is read by
portbench/metrics/<metric>.py, all under the checkout's root.  Adding any
of them adds files and entries; no code here names a cell, a configuration,
a family, a mix, a kind or a metric.

Order of a run: set-up (load, warm-up; timed as setup_s from the process's
start), the window, the device's peak memory, the program freed, then the
reference over the checked answers (not timed), the per-layer metrics of a
traced run, and a look at sys.modules for JAX.  The numbers compared go
to standard error as the last lines and under "checks", last, in the
result line on standard output.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import pathlib
import sys
import time

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "fdt")
BENCH_DIR = "portbench"  # under the checkout's root: traffic/, limits/, metrics/
THREADS = 4


class SpecError(ValueError):
    """BENCHMARK.json or a file it names is missing or does not fit."""


@dataclasses.dataclass
class Cell:
    root: pathlib.Path
    workload: dict
    config: dict
    family: object         # the configuration's module of portbench/families
    traffic: dict
    limits: dict
    metrics: list          # per-layer metric entries of BENCHMARK.json this cell reports
    end_to_end: list       # end-to-end metric entries this cell reports
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float


def _load_json(path: pathlib.Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError) as e:
        raise SpecError(f"{path}: {e}") from e


def _reports(entry: dict, name: str, e2e_of_cell: set | None) -> bool:
    """Whether the cell `name` reports a metric: the cells its "workloads"
    list names; without one, every cell (an end-to-end metric) or every
    cell that reports the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in entry:
        return name in entry["workloads"]
    return e2e_of_cell is None or entry["moves"] in e2e_of_cell


def load_cell(root: pathlib.Path, name: str, seed: int, seconds: float, trace: bool,
              device, t_start: float, bench: dict | None = None) -> Cell:
    bench = bench or _load_json(root / "BENCHMARK.json")
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"] if c["name"] == work["config"]), None)
    if conf is None:
        raise SpecError(f"no config {work['config']!r} in BENCHMARK.json")
    from portbench import families

    here = root / BENCH_DIR
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    config = _load_json(root / conf["file"])
    family = families.load(config.get("family", ""))
    if family is None:
        raise SpecError(f"{conf['file']}: no family {config.get('family')!r} in "
                        f"portbench/families")
    return Cell(root=root, workload=work, config=config, family=family,
                traffic=_load_json(here / "traffic" / f"{work['traffic']}.json"),
                limits=_load_json(here / "limits" / f"{name}.json"), metrics=per_layer,
                end_to_end=e2e, seed=seed, seconds=seconds, trace=trace, device=device,
                t_start=t_start)


@dataclasses.dataclass
class RunRecord:
    """What a per-layer reader may read (portbench/metrics/__init__.py)."""
    cell: Cell
    trace: object
    stats: dict
    untraced_images_per_s: float | None
    traced_refs: list
    head: object
    check_device: object

    def flops_per_image(self) -> int:
        return self.cell.family.flops_per_image(self.cell)

    def part_ms_per_image(self, part: str) -> float | None:
        if self.trace is None or not self.trace.images:
            return None
        s = self.trace.parts_s().get(part)
        return None if not s else s / self.trace.images * 1e3


def read_metric(name: str, run: RunRecord):
    path = run.cell.root / BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def check(cell: Cell, outcome, ref=None) -> tuple[dict, list]:
    """The reference over the checked frames, row against row: ({number:
    value}, the reference's results)."""
    from portbench.check import compare_image, summarize

    results = (ref or cell.family.reference(cell))(outcome.frames, outcome.head)
    per_image = [compare_image(rows, r, outcome.head.nms_thresh, outcome.cut,
                               outcome.head.top_k, cell.device)
                 for rows, r in zip(outcome.rows, results)]
    return summarize(per_image), results


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def device_facts(cell: Cell) -> dict:
    import torch
    if cell.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(cell.device),
            "count": cell.workload["chips"], "memory_peak_bytes": 0}


def run_cell(cell: Cell, entry=None) -> dict:
    """One run of `cell`: the result line's object (without printing)."""
    import torch

    from portbench import entries
    from portbench.check import judge

    torch.set_num_threads(THREADS)
    module = entries.load(cell.traffic.get("kind", ""))
    if module is None:
        raise SpecError(f"traffic kind {cell.traffic.get('kind')!r} has no module in "
                        f"portbench/entries")
    outcome = (entry or module.run)(cell)
    device = device_facts(cell)
    device["memory_peak_bytes"] = int(outcome.memory_peak_bytes)
    gc.unfreeze()  # the program's state, frozen at the end of set-up, is freed now
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, refs = getattr(module, "check", check)(cell, outcome)
    correct, checks = judge(numbers, cell.limits["limits"])
    correct &= outcome.failed == 0
    checks["failed"] = {"value": outcome.failed, "limit": 0}

    result = {"correct": bool(correct), "attempted": outcome.attempted,
              "failed": outcome.failed}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.metrics}
    if cell.trace:
        tr = outcome.trace
        run = RunRecord(cell, tr if tr is not None and tr.ops else None, outcome.stats,
                        outcome.untraced_images_per_s, [refs[i] for i in outcome.traced],
                        outcome.head, cell.device)
        values = {m["name"]: read_metric(m["name"], run) for m in cell.metrics}
        if tr is not None and tr.ops:
            device["busy_s"] = tr.busy_s
            device["window_s"] = tr.window_s
    else:
        values = {m["name"]: outcome.metrics.get(m["name"]) for m in cell.end_to_end}
    result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()
                         if v is not None}
    result["device"] = device
    if cell.trace and outcome.trace is not None and outcome.trace.ops:
        result["breakdown"] = outcome.trace.breakdown()
    result["notes"] = {**outcome.notes, **{k: v for k, v in numbers.items()
                                           if k not in checks}}
    result["checks"] = checks
    return result


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float, root: pathlib.Path) -> int:
    args = parse_args(argv)
    try:
        bench = _load_json(root / "BENCHMARK.json")
        chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    except (SpecError, StopIteration, KeyError) as e:
        print(f"portbench: {e!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if importlib.util.find_spec("fdt_torch") is None:
        print("portbench: the program under test (fdt_torch) is not in this checkout",
              file=sys.stderr)
        return 4
    try:
        cell = load_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), t_start, bench)
        weights = root / cell.config.get("weights", "")
        if "weights" in cell.config and not weights.exists():
            raise SpecError(f"weights {weights} are not in this checkout")
        result = run_cell(cell)
    except SpecError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded in this process that the benchmark must not "
              f"load: {', '.join(found)}", file=sys.stderr)
        return 5
    emit(result)
    return 0


def emit(result: dict) -> None:
    """Each number compared beside its limit, last on standard error; the
    result, one JSON line, last on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
