"""Video detection demos of the three detector families (counterpart of
scripts/video_demo.py: the reference's Video.py, FACEBOX/Video.py and
MTCNN/Video.py).

--source is a directory of frames (the port decodes no camera or video
file); --out a directory for the overlaid frames.  The port reads weights
from variables npz files or reference .pth/.pt state dicts: --weights for
PyramidBox and FaceBoxes, --pnet, --rnet and --onet for MTCNN (fdt's script
defaults to the reference's .pt files, which this repo does not hold).

  python -m fdt_torch.cli.video_demo --detector pyramid --net repo \
      --weights net_weight/repo_mini.npz --source clip --out clip_demo
"""
from __future__ import annotations

import argparse

from fdt_torch.cli._common import add_device_flag


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--detector", default="pyramid", choices=["pyramid", "facebox", "mtcnn"])
    ap.add_argument("--net", default="repo", help="pyramid variant")
    ap.add_argument("--weights", default=None, help="variables npz or .pth (pyramid, facebox)")
    ap.add_argument("--pnet", default=None, help="MTCNN: PNet variables npz or .pt")
    ap.add_argument("--rnet", default=None, help="MTCNN: RNet variables npz or .pt")
    ap.add_argument("--onet", default=None, help="MTCNN: ONet variables npz or .pt")
    ap.add_argument("--source", required=True, help="directory of frames")
    ap.add_argument("--out", default=None, help="output directory of PNG frames")
    ap.add_argument("--display", action="store_true")
    ap.add_argument("--max_frames", default=None, type=int)
    ap.add_argument("--host_cascade", action="store_true",
                    help="MTCNN only: the host-loop cascade instead of the device cascade")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from fdt_torch.apps.video import facebox_demo, mtcnn_demo, pyramidbox_demo
    from fdt_torch.data.frames import read_frames

    kw = dict(frames=read_frames(args.source), out_dir=args.out, display=args.display,
              max_frames=args.max_frames)
    if args.detector == "pyramid":
        from fdt_torch.models.loader import load_pyramidbox_detector
        fps = pyramidbox_demo(load_pyramidbox_detector(args.net, args.weights,
                                                       device=args.device), **kw)
    elif args.detector == "facebox":
        if not args.weights:
            ap.error("--detector facebox needs --weights (a FaceBoxes variables npz or .pth)")
        from fdt_torch.models.loader import load_facebox_detector
        fps = facebox_demo(load_facebox_detector(args.weights, device=args.device), **kw)
    else:
        paths = (args.pnet, args.rnet, args.onet)
        if not all(paths):
            ap.error("--detector mtcnn needs --pnet, --rnet and --onet")
        if args.host_cascade:
            from fdt_torch.infer.mtcnn import load_mtcnn_detector
            det = load_mtcnn_detector(*paths, device=args.device)
        else:
            # the budget ladder: typical frames run the small tiers, crowded
            # ones escalate (sticky), with the keep sets of the full budgets
            from fdt_torch.infer.mtcnn_device import FAST_BUDGETS, MID_BUDGETS
            from fdt_torch.models.loader import load_mtcnn_cascade
            det = load_mtcnn_cascade(*paths, fast_budgets=(FAST_BUDGETS, MID_BUDGETS),
                                     device=args.device)
        fps = mtcnn_demo(det, **kw)
    print(f"average fps: {fps:.2f}")


if __name__ == "__main__":
    main()
