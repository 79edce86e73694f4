"""Train PyramidBox (counterpart of scripts/train_pyramid.py, with its flags
and defaults; --device replaces --platform).

  python -m fdt_torch.cli.train_pyramid --net repo --batch_size 7 --lr 2e-5
  python -m fdt_torch.cli.train_pyramid --net try3 --batch_size 16 --lr 1e-4 \\
      --momentum 0.3 --eval_freq 500 --train_pretrain 5000

Runs on the CUDA card unless --device cpu.  Ends with one `[train] {...}`
JSON line: iterations, wall seconds, the seconds the loop waited on the
prefetch queue and the host's augmentation rate.

--journal NAME replays a schedule of the reference's experiment journal
through fdt_torch.cli.train_chained (each phase's lr / momentum / batch_size
as chained processes), passing on the flags fdt's script passes
(scripts/train_pyramid.py:98-121), --device in place of --platform.
"""
from __future__ import annotations

import argparse
import json
import os

from fdt_torch.cli._common import add_device_flag

# flags fdt's CLI has that this one refuses, and the slice that brings them
_REFUSED = {
    "dp_devices": "data parallelism is ROADMAP Queue 1 item 5 (distribution)",
    "sp_devices": "spatial partitioning is ROADMAP Queue 1 item 5 (distribution)",
    "num_processes": "multi-process training is ROADMAP Queue 1 item 5 (distribution)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--net", default="repo",
                    choices=["repo", "try1", "try2", "try3", "try4", "try5"])
    ap.add_argument("--batch_size", default=7, type=int)
    ap.add_argument("--lr", default=2e-5, type=float)
    ap.add_argument("--momentum", default=0.6, type=float)
    ap.add_argument("--iter", default=120000, type=int)
    ap.add_argument("--save_point", default=3000, type=int)
    ap.add_argument("--start_iter", default=0, type=int)
    ap.add_argument("--resume", default=None,
                    help="a variables npz (fdt's format), a torch .pth (loaded as fdt "
                         "loads it, strict=False) or a checkpoint directory of this CLI "
                         "(full state: momentum and step too)")
    ap.add_argument("--eval_freq", default=0, type=int)
    ap.add_argument("--stall_timeout", default=0, type=float,
                    help="seconds without synced step progress before the process "
                         "hard-exits 86; 0 disables; the first step is exempt")
    ap.add_argument("--startup_timeout", default=0, type=float,
                    help="like --stall_timeout, before the first synced step; 0 disables")
    ap.add_argument("--train_pretrain", default=0, type=int,
                    help="freeze the backbone before this iteration (try3-try5)")
    ap.add_argument("--input_size", default=640, type=int,
                    help="train resolution (the reference trains at 640)")
    ap.add_argument("--bf16", action="store_true",
                    help="mixed precision: bf16 forward and backward under autocast, "
                         "float32 parameters, optimizer state and loss")
    ap.add_argument("--remat", action="store_true",
                    help="recompute activations in the backward pass: every Bottleneck "
                         "and extra layer on the flagship, the whole forward on the "
                         "mobile variants; same gradients, less activation memory")
    ap.add_argument("--dp_devices", default=0, type=int, help="refused (not ported)")
    ap.add_argument("--sp_devices", default=1, type=int, help="refused (not ported)")
    ap.add_argument("--num_processes", default=1, type=int, help="refused above 1")
    ap.add_argument("--process_id", default=0, type=int)
    ap.add_argument("--coordinator", default="127.0.0.1:12360")
    ap.add_argument("--max_gt", default=None, type=int, help="GT pad bucket")
    ap.add_argument("--journal", default=None,
                    help="replay a journal schedule from draw_curve/log (repo | try3 | "
                         "try1) through fdt_torch.cli.train_chained")
    ap.add_argument("--annoPath", default="./image_and_anno/anno/gen_anno_file_train")
    ap.add_argument("--evalAnnoPath", default="./image_and_anno/anno/gen_anno_file_val")
    ap.add_argument("--save_folder", default="weights_of_mine/")
    add_device_flag(ap)
    return ap


def _refuse(args) -> None:
    given = {"dp_devices": args.dp_devices != 0, "sp_devices": args.sp_devices > 1,
             "num_processes": args.num_processes > 1}
    for flag, on in given.items():
        if on:
            raise SystemExit(f"--{flag}: {_REFUSED[flag]}")


def journal_argv(args) -> list[str]:
    """train_chained's arguments for --journal: the flags fdt's script passes
    on (not --save_point: the chained runner derives it a chunk)."""
    argv = ["--net", args.net, "--journal", args.journal, "--iter", str(args.iter),
            "--start_iter", str(args.start_iter), "--save_folder", args.save_folder,
            "--annoPath", args.annoPath]
    if args.resume:
        argv += ["--resume", args.resume]
    argv += ["--input_size", str(args.input_size)]
    if args.device:
        argv += ["--device", args.device]
    if args.stall_timeout:
        argv += ["--stall_timeout", str(args.stall_timeout)]
    if args.startup_timeout:
        argv += ["--startup_timeout", str(args.startup_timeout)]
    return argv


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse(args)
    if args.journal:
        from fdt_torch.cli import train_chained
        return train_chained.main(journal_argv(args))

    import torch

    from fdt_torch.models import build_pyramidbox
    from fdt_torch.train.checkpoint import load_weights
    from fdt_torch.train.driver import TrainConfig, run_pyramid_training
    from fdt_torch.train.loops import PyramidTrainer, xavier_init

    model = xavier_init(build_pyramidbox(args.net, remat=args.remat and args.net == "repo"), 0)
    freeze = (lambda p: "features" in p) if args.net in ("try3", "try4", "try5") else None
    trainer = PyramidTrainer(model, args.net, momentum=args.momentum,
                             input_size=args.input_size, freeze_predicate=freeze,
                             remat=args.remat and args.net != "repo",
                             dtype=torch.bfloat16 if args.bf16 else torch.float32,
                             device=args.device)
    if args.resume:
        load_weights(args.resume, trainer, strict=False)
    os.makedirs(args.save_folder, exist_ok=True)
    cfg = TrainConfig(batch_size=args.batch_size, lr=args.lr, total_iters=args.iter,
                      save_point=args.save_point, eval_freq=args.eval_freq,
                      train_pretrain=args.train_pretrain, start_iter=args.start_iter,
                      save_folder=args.save_folder, max_gt=args.max_gt,
                      name=f"{args.net}_pyramid", stall_timeout=args.stall_timeout,
                      startup_timeout=args.startup_timeout)
    stats: dict = {}
    run_pyramid_training(trainer, args.annoPath, cfg,
                         val_anno=args.evalAnnoPath if args.eval_freq else None, stats=stats)
    images = stats["iterations"] * args.batch_size
    print("[train] " + json.dumps({
        "net": args.net, "iterations": stats["iterations"], "step": trainer.step,
        "wall_s": round(stats["wall_s"], 3), "wait_s": round(stats["wait_s"], 3),
        "wait_share": round(stats["wait_s"] / stats["wall_s"], 4) if stats["wall_s"] else None,
        "augment_images_per_s": (round(stats["augmented"] / stats["augment_s"], 2)
                                 if stats["augment_s"] else None),
        "images_per_s": round(images / stats["wall_s"], 2) if stats["wall_s"] else None}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
