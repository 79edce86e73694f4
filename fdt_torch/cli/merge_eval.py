"""Merge multi-process eval part files into one reference-layout dump
(counterpart of scripts/merge_eval.py).

Each process of a sharded eval writes `data_of_<net>.part<i>_of_<n>.npz`;
merging all the parts in process order reproduces the unsharded
`data_of_<net>.npy` bit for bit, tied confidences included.

  python -m fdt_torch.cli.merge_eval draw_curve/data/data_of_repo.part*_of_4.npz \
      --out draw_curve/data/data_of_repo.npy
"""
from __future__ import annotations

import argparse
import re


def _part_key(path: str) -> tuple:
    """(part index, declared part count) from the filename."""
    m = re.search(r"\.part(\d+)_of_(\d+)\.npz$", path)
    if not m:
        raise ValueError(f"not a part file: {path}")
    return int(m.group(1)), int(m.group(2))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parts", nargs="+", help="part .npz files (any order; "
                                             "sorted by part index)")
    ap.add_argument("--out", required=True, help="merged .npy dump path")
    args = ap.parse_args(argv)

    import numpy as np

    from fdt_torch.eval.pr import average_precision, merge_part_files
    keys = sorted(_part_key(p) for p in args.parts)
    parts = sorted(args.parts, key=_part_key)
    counts = {n for _, n in keys}
    idx = [i for i, _ in keys]
    expect = list(range(next(iter(counts)))) if len(counts) == 1 else None
    if idx != expect:
        raise ValueError(f"need ALL parts 0..n-1 of one run, got indices "
                         f"{idx} of {sorted(counts)}-part run(s)")
    dump = merge_part_files(parts)
    np.save(args.out, dump)
    print(f"merged {len(parts)} parts -> {args.out}: "
          f"detections {dump.shape[1] - 1}, gt {int(dump[1, -1])}, "
          f"AP {average_precision(dump):.4f}")


if __name__ == "__main__":
    main()
