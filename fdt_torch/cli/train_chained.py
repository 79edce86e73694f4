"""Chain train_pyramid as a sequence of bounded-lifetime processes
(counterpart of scripts/train_chained.py, with its flags and defaults).

Each chunk of --chunk iterations is one child process
`python -m fdt_torch.cli.train_pyramid`, which saves
`{save_folder}/{net}_pyramid_{end}` at its end; the next chunk resumes from
that checkpoint directory (weights, momentum and step).  Flags this CLI does
not know (--device, --input_size, --batch_size, ...) pass through to every
chunk.  A chunk that exits with the stall watchdog's code (86) is re-run from
the same checkpoint up to --stall-retries times; any other failure ends the
chain with its exit code.

--journal <name> replays a schedule of the reference's experiment journal
(draw_curve/log:1-24): every journal phase (lr / momentum / batch_size up to
an iteration) becomes chained processes with those flags.  --journal-scale
shrinks every phase boundary for smoke runs.

Every process builds its dataset and shuffle stream afresh, as in fdt
(fdt_torch/train/driver.py): a chained run equals one process that saves and
restores at the same boundaries, not one that never restarts.

  python -m fdt_torch.cli.train_chained --net repo --chunk 500 --iter 1500 \\
      --batch_size 8 --lr 2e-5 --momentum 0.6 \\
      --annoPath data/mini/gen_anno_file_mini_train --save_folder weights_of_mine/
  python -m fdt_torch.cli.train_chained --net try3 --journal try3
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

from fdt_torch.utils.watchdog import STALL_EXIT_CODE

CHUNK_MODULE = "fdt_torch.cli.train_pyramid"

# draw_curve/log:1-24, one dict per journal phase ("end" = last iteration of
# the phase; lr/momentum/batch_size = the flags logged for it)
JOURNAL = {
    # repo ResNet50 (log:20-23): momentum 0.3 -> 0.9 -> 0.6 across restarts
    "repo": [dict(end=9000, lr=1e-4, momentum=0.3, batch_size=7),
             dict(end=15000, lr=2e-5, momentum=0.9, batch_size=7),
             dict(end=120000, lr=2e-5, momentum=0.6, batch_size=7)],
    # try3 (log:13-15): lr drop + batch 16 -> 14 at 18k
    "try3": [dict(end=18000, lr=1e-4, momentum=0.3, batch_size=16),
             dict(end=24000, lr=2e-5, momentum=0.3, batch_size=14)],
    # try1 final finetune (log:8-9)
    "try1": [dict(end=24000, lr=1e-4, momentum=0.3, batch_size=8),
             dict(end=36000, lr=2e-5, momentum=0.6, batch_size=8)],
}


def journal_phases(name: str, scale: float, total_cap: int | None):
    """Journal phases with boundaries scaled (smoke runs) and optionally
    capped; phases starting past the cap drop out."""
    phases = []
    for p in JOURNAL[name]:
        p = dict(p, end=max(1, int(round(p["end"] * scale))))
        if total_cap is not None:
            p["end"] = min(p["end"], total_cap)
        if not phases or p["end"] > phases[-1]["end"]:
            phases.append(p)
    return phases


def run_chunk(cmd, stall_retries: int, label: str = "", resume=None,
              call=subprocess.call) -> int:
    """Run one chunk process; re-run it on the stall watchdog's exit code.

    A stalled chunk made no checkpoint past `resume`, so the retry command is
    the same: it resumes from the same checkpoint and redoes at most one
    chunk of work.  Any other nonzero exit is returned (a real failure ends
    the chain, it does not loop)."""
    retries = stall_retries
    while True:
        rc = call(cmd)
        if rc == STALL_EXIT_CODE and retries > 0:
            retries -= 1
            print(f"# chunk {label} stalled (exit {rc}); retrying from "
                  f"{resume or 'scratch'} ({retries} retries left)", flush=True)
            continue
        return rc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunk", default=500, type=int, help="iterations per process")
    ap.add_argument("--net", default="repo")
    ap.add_argument("--iter", default=1500, type=int)
    ap.add_argument("--start_iter", default=0, type=int)
    ap.add_argument("--resume", default=None,
                    help="the first chunk's --resume: a checkpoint directory, a variables "
                         "npz or a torch .pth")
    ap.add_argument("--save_folder", default="weights_of_mine/")
    ap.add_argument("--journal", default=None, choices=sorted(JOURNAL),
                    help="replay this journal schedule (draw_curve/log); per-phase "
                         "lr/momentum/batch_size override the plain flags, --iter caps "
                         "the total")
    ap.add_argument("--journal-scale", default=1.0, type=float,
                    help="scale journal phase boundaries (smoke runs)")
    ap.add_argument("--stall-retries", default=2, type=int,
                    help="re-run a chunk this many times when it exits with the stall "
                         "watchdog's code (86); the retry resumes from the same "
                         "checkpoint; other failures still end the chain")
    return ap


def main(argv=None) -> int:
    args, passthrough = build_parser().parse_known_args(argv)
    name = f"{args.net}_pyramid"
    if args.journal:
        phases = journal_phases(args.journal, args.journal_scale,
                                args.iter if args.iter else None)
    else:
        phases = [dict(end=args.iter)]

    start = args.start_iter
    resume = args.resume
    for phase in phases:
        if start >= phase["end"]:
            continue  # resumed past this phase
        phase_flags = []
        for k in ("lr", "momentum", "batch_size"):
            if k in phase:
                phase_flags += [f"--{k}", str(phase[k])]
        if args.journal:
            print(f"# journal {args.journal} phase to {phase['end']}: "
                  f"{' '.join(phase_flags)}", flush=True)
        while start < phase["end"]:
            end = min(start + args.chunk, phase["end"])
            # run_pyramid_training saves on absolute iteration % save_point
            # and at total_iters, so {save_folder}/{name}_{end} exists for
            # every chunk even when end is not a multiple of (end - start)
            cmd = [sys.executable, "-m", CHUNK_MODULE,
                   "--net", args.net, "--iter", str(end), "--start_iter", str(start),
                   "--save_point", str(end - start), "--save_folder", args.save_folder] \
                + phase_flags + passthrough
            if resume:
                cmd += ["--resume", resume]
            print(f"# chunk {start}..{end}: {' '.join(cmd)}", flush=True)
            rc = run_chunk(cmd, args.stall_retries, label=f"{start}..{end}", resume=resume)
            if rc != 0:
                return rc
            resume = os.path.join(args.save_folder, f"{name}_{end}")
            start = end
    print(f"# chained training done: {resume}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
