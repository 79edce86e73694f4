"""Readings for a cell's correctness limits, in one process on the card:
the program's numbers on many seeds, then the control's, the program with
its int8 path switched on (the nearest precision below the configuration's
bfloat16), on a few seeds, each over a short window at the cell's own load
and sizes.  `unmatched_share` is also read at every pair of the given
score margins and IoUs (portbench.check's COVER_SCORE_MARGIN, COVER_IOU).

    python3 portbench/tools/calibrate.py --workload try1.serve \\
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3 --out results/cal.json
"""
import argparse
import itertools
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import check, entries, harness  # noqa: E402


def readings(cell, det, ref, margins, ious) -> dict:
    outcome = entries.load(cell.traffic["kind"]).run(cell, detector=det)
    numbers, results = harness.check(cell, outcome, ref)
    grid, held = {}, (check.COVER_SCORE_MARGIN, check.COVER_IOU)
    for check.COVER_SCORE_MARGIN, check.COVER_IOU in itertools.product(margins, ious):
        grid[f"{check.COVER_SCORE_MARGIN}/{check.COVER_IOU}"] = check.summarize([
            check.compare_image(rows, r, outcome.head.nms_thresh, outcome.cut,
                                outcome.head.top_k, cell.device)
            for rows, r in zip(outcome.rows, results)])["unmatched_share"]
    check.COVER_SCORE_MARGIN, check.COVER_IOU = held
    return {"numbers": numbers, "unmatched_grid": grid, "metrics": outcome.metrics,
            "failed": outcome.failed, "notes": outcome.notes}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--margins", default="0.01,0.02,0.05")
    ap.add_argument("--ious", default="0.2,0.3")
    ap.add_argument("--rate", type=float, default=None,
                    help="a serving cell's offered rate, in place of its mix's")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    margins = [float(x) for x in args.margins.split(",")]
    ious = [float(x) for x in args.ious.split(",")]
    dev = torch.device("cuda", 0)
    def load(seed):
        cell = harness.load_cell(ROOT, args.workload, seed, args.seconds, False, dev,
                                 time.perf_counter())
        if args.rate:
            cell.traffic["rate_per_s"] = args.rate
        return cell

    cell = load(0)
    ref = cell.family.reference(cell)
    out = {"workload": args.workload, "seconds": args.seconds, "rate": args.rate,
           "card": torch.cuda.get_device_name(dev), "program": {}, "control": {}}
    for side, seeds, quant in (("program", args.seeds, None),
                               ("control", args.control_seeds, "int8")):
        det = cell.family.build(cell, quant=quant)
        for seed in [int(s) for s in seeds.split(",")]:
            out[side][seed] = r = readings(load(seed), det, ref, margins, ious)
            print(side, seed, json.dumps({k: round(v, 6) for k, v in r["numbers"].items()}),
                  r["unmatched_grid"], flush=True)
        del det
        torch.cuda.empty_cache()
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
