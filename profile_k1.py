#!/usr/bin/env python3
"""Time kernel K1 (fdt_torch.ops.nms.nms_keep_tiled) on one CUDA card.

    python3 profile_k1.py [--tree DIR ...] [--out FILE]

Each --tree is the root of a checkout whose fdt_torch is built (into its own
fdt_torch/_build) and timed, in the order given, so that two versions of K1
are compared inside one run (for example old, new, new, old); the default is
this checkout.  Each tree runs in a process of its own.  For every case of
chip_smoke.K1_TIMED it prints one JSON line: the time a call by CUDA events,
the wrapper's host time a call, each kernel's device time from torch.profiler,
the pair tests the greedy walk needs and the bound they give.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent


def run_tree(tree: pathlib.Path) -> list[dict]:
    """Build the tree's kernels and time its K1 (in this process)."""
    import torch

    sys.path.insert(0, str(tree))
    from fdt_torch.ops import _build

    if pathlib.Path(_build.__file__).resolve().parents[2] != tree:
        raise RuntimeError(f"imported {_build.__file__}, not the tree {tree}")
    _build.build(fresh=True)
    _build.library()
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    name = torch.cuda.get_device_name(0)
    return [{"tree": str(tree), "card": name, "case": case, **result}
            for case, result in chip_smoke.k1_timings().items()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", type=pathlib.Path,
                    help="checkout root whose fdt_torch is timed (repeatable)")
    ap.add_argument("--one", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=pathlib.Path, help="also write the lines here")
    args = ap.parse_args()
    if args.one:  # the child process of one tree
        for line in run_tree(args.one.resolve()):
            print(json.dumps(line), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profile_k1: CUDA is not available", file=sys.stderr)
        return 2
    lines = []
    for tree in args.tree or [REPO]:
        proc = subprocess.run([sys.executable, __file__, "--one", str(tree)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        lines += [line for line in proc.stdout.splitlines() if line.startswith("{")]
    for line in lines:
        print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
