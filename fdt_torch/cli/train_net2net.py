"""Net2net distillation (counterpart of scripts/train_net2net.py, with its
flags, and --device).

  python -m fdt_torch.cli.train_net2net --train intermedia --student try1 \\
      --teacher_weights net_weight/repo_mini.npz

A frozen ResNet50 PyramidBox teacher (--teacher_weights: a variables npz,
a checkpoint directory of the port or a reference .pth, read as fdt reads
it, strict=False) teaches a xavier-initialised try1 or try2 student on
WIDER-FACE batches at 640².  fdt's default teacher,
./net_weight/Res50_pyramid.pth, is not in the repo: the default here is the
repo's net_weight/repo_mini.npz.  Every --save_point iterations a checkpoint
`<save_folder>/<mode>_net_<it>` and the losses `<mode>_loss_<it>.npy`; a
chained run resumes with --start_iter and --resume.  Runs on the CUDA card
unless --device cpu.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from fdt_torch.cli._common import add_device_flag

INPUT_SIZE = 640  # the reference's distillation resolution


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", default="intermedia",
                    choices=["intermedia", "source", "overall"])
    ap.add_argument("--student", default="try1", choices=["try1", "try2"])
    ap.add_argument("--teacher_weights", default="net_weight/repo_mini.npz",
                    help="a variables npz, a checkpoint directory or a torch .pth "
                         "(fdt's default, ./net_weight/Res50_pyramid.pth, is absent)")
    ap.add_argument("--batch_size", default=8, type=int)
    ap.add_argument("--lr", default=1e-3, type=float)
    ap.add_argument("--iter", default=500000, type=int)
    ap.add_argument("--save_point", default=2000, type=int)
    ap.add_argument("--start_iter", default=0, type=int,
                    help="resume iteration count (pairs with --resume: bound each "
                         "process's lifetime and chain through checkpoints)")
    ap.add_argument("--resume", default=None,
                    help="a checkpoint directory from a previous save_point")
    ap.add_argument("--momentum", default=0.5, type=float)
    ap.add_argument("--stall_timeout", default=0, type=float,
                    help="seconds without synced step progress before the process "
                         "hard-exits 86; 0 disables")
    ap.add_argument("--startup_timeout", default=0, type=float,
                    help="like --stall_timeout but before the first step; 0 disables")
    ap.add_argument("--annoPath", default="./image_and_anno/anno/gen_anno_file_train")
    ap.add_argument("--save_folder", default="weights_of_mine/")
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from fdt_torch.data.widerface import WiderFaceDataset
    from fdt_torch.models import build_pyramidbox
    from fdt_torch.train.checkpoint import (load_model_weights, restore_checkpoint,
                                            save_checkpoint)
    from fdt_torch.train.driver import prefetch_batches
    from fdt_torch.train.loops import xavier_init
    from fdt_torch.train.net2net import Net2NetTrainer
    from fdt_torch.utils.watchdog import StallWatchdog

    teacher = load_model_weights(args.teacher_weights, build_pyramidbox("repo"), strict=False)
    trainer = Net2NetTrainer(xavier_init(build_pyramidbox(args.student), 0), teacher,
                             args.train, momentum=args.momentum, input_size=INPUT_SIZE,
                             device=args.device)
    if args.resume:
        restore_checkpoint(args.resume, trainer)

    dataset = WiderFaceDataset(args.annoPath, size=INPUT_SIZE)
    batches = prefetch_batches(dataset, args.batch_size, pin=trainer.device.type == "cuda")
    loss_save = np.zeros(args.save_point + 1)
    idx = 0
    try:
        with StallWatchdog(args.stall_timeout, name=f"n2n_{args.train}",
                           startup_limit_s=args.startup_timeout) as watchdog:
            for it in range(args.start_iter + 1, args.iter + 1):
                images, _ = next(batches)
                t0 = time.time()
                metrics = trainer.train_step(images, args.lr)
                loss_save[idx] = float(metrics["loss"])  # syncs the step
                watchdog.beat()
                idx += 1
                if it % 20 == 0:
                    print(f"iter {it} || loss {float(metrics['loss']):.4f} "
                          f"|| parts {metrics['parts'].cpu().numpy().round(4)} "
                          f"|| {time.time() - t0:.2f}s", flush=True)
                if it % args.save_point == 0:
                    save_checkpoint(trainer, args.save_folder, f"{args.train}_net", it)
                    np.save(f"{args.save_folder}/{args.train}_loss_{it}.npy", loss_save)
                    loss_save = np.zeros(args.save_point + 1)
                    idx = 0
    finally:
        batches.close()  # stop the prefetch worker thread
    if args.iter % args.save_point != 0:
        save_checkpoint(trainer, args.save_folder, f"{args.train}_net_final", args.iter)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
