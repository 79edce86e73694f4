"""Score trained checkpoints by held-out AP and pick the best (counterpart
of scripts/select_checkpoint.py, with its flags; --device replaces
--platform).

One detector (budget 2048) is built on the device, and every checkpoint's
weights are loaded into that same model in turn; each val image, read by
Pillow and resized to 640² (within 1 LSB of cv2's resize), is detected at
the in-graph candidate floor 0.05 and nms 0.35, its rows taken at
--threshold, and scored by the eval protocol's TfConfAccumulator and
average_precision.  Prints `# <path>: AP <ap>` a checkpoint, then fdt's JSON
line {"net", "aps", "best", "best_ap"}.  Runs on the CUDA card unless
--device cpu.

  python -m fdt_torch.cli.select_checkpoint --net repo \\
      --checkpoints 'weights_of_mine/repo_r5/repo_pyramid_*'
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np

from fdt_torch.cli._common import add_device_flag

CONF = 0.05   # in-graph candidate floor; the row walk applies the eval threshold
SIZE = 640    # the shared square the val images are resized to


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--net", default="repo")
    ap.add_argument("--checkpoints", required=True,
                    help="glob of checkpoint directories, variables .npz or torch .pth")
    ap.add_argument("--val", default="data/mini/gen_anno_file_mini_val")
    ap.add_argument("--threshold", type=float, default=0.1)
    add_device_flag(ap)
    return ap


def checkpoint_step(path: str) -> int:
    """The trailing step of a checkpoint's name (0 without one)."""
    return int((re.findall(r"(\d+)$", path) or [0])[0])


def load_val(anno: str) -> list:
    """[(640² BGR uint8 image, [N, 4] xywh GT in its pixels)] of an anno file."""
    from fdt_torch.apps.serving import resize_bilinear
    from fdt_torch.data.anno import parse_anno_file
    from fdt_torch.data.image_io import imread
    val = []
    for rec in parse_anno_file(anno):
        im = imread(rec.path)
        if im is None:
            raise FileNotFoundError(f"{rec.path}: not a readable image")
        ih, iw, _ = im.shape
        val.append((resize_bilinear(im, SIZE, SIZE),
                    rec.boxes_xywh.astype(np.float32)
                    * [SIZE / iw, SIZE / ih, SIZE / iw, SIZE / ih]))
    return val


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from fdt_torch.eval.pr import TfConfAccumulator, average_precision
    from fdt_torch.infer.pyramidbox import detections_to_rows
    from fdt_torch.models.loader import load_pyramidbox_detector
    from fdt_torch.train.checkpoint import load_model_weights

    paths = sorted(glob.glob(args.checkpoints), key=checkpoint_step)
    if not paths:
        raise SystemExit(f"no checkpoints match {args.checkpoints}")
    val = load_val(args.val)
    det = load_pyramidbox_detector(args.net, None, budget=2048, device=args.device)
    out = {"net": args.net, "aps": {}}
    for path in paths:
        load_model_weights(path, det.model, strict=False)  # the same model, new weights
        acc = TfConfAccumulator()
        for img, gt in val:
            t = det.detect_tensor(img[None], conf_thresh=CONF, nms_thresh=0.35)[0]
            acc.add(detections_to_rows(t, args.threshold, [SIZE] * 4), gt)
        ap_v = float(average_precision(acc.finalize()))
        out["aps"][os.path.basename(path)] = round(ap_v, 4)
        print(f"# {path}: AP {ap_v:.4f}", flush=True)
    best = max(out["aps"], key=out["aps"].get)
    out["best"] = best
    out["best_ap"] = out["aps"][best]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
