"""What the port's CLIs share: the --device flag and the eval summary line."""
from __future__ import annotations

import argparse


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (pass 'cpu' for the CPU)")


def print_eval_summary(dump, process_index, process_count) -> None:
    """The line fdt's eval scripts print after a run."""
    from fdt_torch.eval.pr import average_precision
    shard = ("" if not process_count or process_count <= 1 else
             f"  [shard {process_index}/{process_count} only - merge part files "
             "with python -m fdt_torch.cli.merge_eval]")
    print(f"detections: {dump.shape[1] - 1}  gt: {int(dump[1, -1])}  "
          f"AP: {average_precision(dump):.4f}{shard}")
