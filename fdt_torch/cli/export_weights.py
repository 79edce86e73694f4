"""Export a checkpoint to a shippable weight file (counterpart of
scripts/export_weights.py, with its flags, plus --image and --device).

--checkpoint is a checkpoint directory of the port, a variables npz or a
torch .pth/.pt (read through a --net model).

--out *.npz  fdt's compact variables npz: params float16, batch_stats float32
             (the optimizer state and step stay in the checkpoint).
--out *.pth  a torch state dict that the reference repo's models load strict
             (net.load_state_dict semantics, pyramid.py:353-364).

--check loads the written file into a --net detector on the device and
prints its detections at 0.35 on --image (resized to 640²) or, without it,
on a seeded 640² frame: fdt's check image is the reference's own sample
photo, which this repo does not hold.

  python -m fdt_torch.cli.export_weights --checkpoint weights_of_mine/try3_pyramid_3000 \\
      --out net_weight/try3_mini.npz --net try3 --check
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from fdt_torch.cli._common import add_device_flag

CHECK_SEED = 0


def check_frame(image: str | None) -> tuple[np.ndarray, str]:
    """The --check frame: --image read by Pillow and resized to 640², or a
    seeded 640² frame."""
    if image is None:
        return (np.random.RandomState(CHECK_SEED).randint(0, 256, (640, 640, 3), np.uint8),
                "the seeded frame")
    from fdt_torch.apps.serving import resize_bilinear
    from fdt_torch.data.image_io import imread
    img = imread(image)
    if img is None:
        raise SystemExit(f"--image {image}: not a readable image")
    return resize_bilinear(img, 640, 640), image


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint directory, variables npz or torch .pth")
    ap.add_argument("--out", required=True, help="output .npz or .pth path")
    ap.add_argument("--net", default="try3",
                    help="variant for reading a .pth and for the optional --check forward")
    ap.add_argument("--check", action="store_true",
                    help="reload the written file and run a detection forward")
    ap.add_argument("--image", default=None,
                    help="the --check image (default: a seeded 640² frame)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from fdt_torch.models.loader import (TORCH_SUFFIXES, save_variables_npz,
                                         save_variables_pth)
    from fdt_torch.models.pyramidbox_mobile import build_pyramidbox
    from fdt_torch.train.checkpoint import read_variables

    model = build_pyramidbox(args.net) if args.checkpoint.endswith(TORCH_SUFFIXES) else None
    variables = read_variables(args.checkpoint, model)
    if args.out.endswith(TORCH_SUFFIXES):
        save_variables_pth(variables, args.out)
    else:
        save_variables_npz(variables, args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)", flush=True)

    if args.check:
        from fdt_torch.models.loader import load_pyramidbox_detector
        det = load_pyramidbox_detector(args.net, args.out, device=args.device)
        img, what = check_frame(args.image)
        rows = det.detect_face(img, threshold=0.35)
        print(f"check: {len(rows)} detections >= 0.35 on {what}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
