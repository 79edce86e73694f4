"""Train FaceBoxes on WIDER-FACE (counterpart of scripts/train_facebox.py,
with its flags and defaults, and --device).

  python -m fdt_torch.cli.train_facebox --batch_size 16 --lr 1e-3 \\
      --annoPath ./image_and_anno/anno/gen_anno_file_train

Images are augmented on raw pixels (pyramid_augment with mean (0, 0, 0)) at
1024² and divided by 255 in the trainer: FaceBoxes' input protocol.  Faces
are class 1.  Checkpoints are `<save_folder>/facebox_<iteration>`; --resume
continues from the latest.  Runs on the CUDA card unless --device cpu.
"""
from __future__ import annotations

import argparse
import functools
import os

from fdt_torch.cli._common import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch_size", default=16, type=int)
    ap.add_argument("--lr", default=1e-3, type=float)
    ap.add_argument("--momentum", default=0.9, type=float)
    ap.add_argument("--weight_decay", default=5e-4, type=float)
    ap.add_argument("--iter", default=120000, type=int)
    ap.add_argument("--save_point", default=3000, type=int)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in save_folder")
    ap.add_argument("--annoPath", default="./image_and_anno/anno/gen_anno_file_train")
    ap.add_argument("--save_folder", default="weights_of_mine/")
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from fdt_torch.config import FACEBOX
    from fdt_torch.data.augment import pyramid_augment
    from fdt_torch.data.widerface import WiderFaceDataset
    from fdt_torch.models import FaceBox
    from fdt_torch.train.checkpoint import (latest_checkpoint, restore_checkpoint,
                                            save_checkpoint)
    from fdt_torch.train.facebox_train import FaceBoxTrainer
    from fdt_torch.train.loops import pad_targets, xavier_init

    trainer = FaceBoxTrainer(xavier_init(FaceBox(), 0), cfg=FACEBOX, momentum=args.momentum,
                             weight_decay=args.weight_decay, device=args.device)
    if args.resume:
        path = latest_checkpoint(args.save_folder, "facebox")
        if path:
            restore_checkpoint(path, trainer)
            print(f"resumed from {path}")
    # raw-pixel augmentation: FaceBoxes divides raw pixels by 255 (in the
    # trainer); the pyramid family's mean-subtracted output would shift them
    dataset = WiderFaceDataset(args.annoPath, size=FACEBOX.input_size,
                               augment=functools.partial(pyramid_augment, mean=(0, 0, 0)))
    os.makedirs(args.save_folder, exist_ok=True)
    it = trainer.step
    while it < args.iter:
        for images, targets in dataset.batches(args.batch_size):
            gt_boxes, _, gt_valid = pad_targets(targets)
            gt_labels = gt_valid.astype("int32")  # faces are class 1 in FaceBoxes
            metrics = trainer.train_step(images, gt_boxes, gt_labels, gt_valid, args.lr)
            it += 1
            if it % 10 == 0:
                print(f"iter {it}: loss {float(metrics['loss']):.4f} "
                      f"(loc {float(metrics['loc']):.4f} conf {float(metrics['conf']):.4f})",
                      flush=True)
            if it % args.save_point == 0 or it >= args.iter:
                save_checkpoint(trainer, args.save_folder, "facebox", it)
            if it >= args.iter:
                break
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
