"""The serving knee: one serving cell at a list of offered rates, in one
process on the card, each rate a window of its own.  For each rate it
prints the share of requests answered inside the window, the latency
quantiles, and whether the queue grew: the median latency of the window's
last fifth of requests against its first fifth.

    python3 portbench/tools/sweep.py --workload try1.serve --rates 200,400,600 \\
        --seconds 8 --seed 7 --out results/sweep.json
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.entries import serve  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(ROOT, args.workload, args.seed, args.seconds, False, dev,
                             time.perf_counter())
    cell.traffic["check_requests"] = 0
    det = cell.family.build(cell)
    rows = []
    for rate in [float(r) for r in args.rates.split(",")]:
        cell.traffic["rate_per_s"] = rate
        o = serve.run(cell, detector=det)
        lat = o.latencies_ms
        fifth = max(1, len(lat) // 5)
        row = {"rate_per_s": rate, "offered": o.attempted, "failed": o.failed,
               "answered_in_window": o.notes["completed_in_window"] / o.attempted,
               "p50_ms": float(np.nanpercentile(lat, 50)), "p95_ms": float(np.nanpercentile(lat, 95)),
               "p99_ms": float(np.nanpercentile(lat, 99)),
               "first_fifth_p50_ms": float(np.nanmedian(lat[:fifth])),
               "last_fifth_p50_ms": float(np.nanmedian(lat[-fifth:])),
               "batch_mean": o.stats["mean_batch_size"],
               "generator_late_ms_max": o.notes["generator_late_ms_max"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"card": torch.cuda.get_device_name(dev), "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
