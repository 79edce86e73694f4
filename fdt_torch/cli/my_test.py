"""PyramidBox WIDER-FACE val evaluation (counterpart of scripts/my_test.py,
with the same flags and dump names).

  python -m fdt_torch.cli.my_test --net repo --weights net_weight/repo_mini.npz \
      --anno image_and_anno/anno/gen_anno_file_val --threshold 0

Writes <data_save_folder>/data_of_<net>.npy in the reference dump layout.
"""
from __future__ import annotations

import argparse

from fdt_torch.cli._common import add_device_flag, print_eval_summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--net", default="repo",
                    choices=["repo", "try1", "try2", "try3", "try4", "try5"])
    ap.add_argument("--weights", default=None, help="variables npz or torch .pth")
    ap.add_argument("--threshold", default=0.0, type=float)
    ap.add_argument("--anno", default="./image_and_anno/anno/gen_anno_file_val")
    ap.add_argument("--data_save_folder", default="./draw_curve/data/")
    ap.add_argument("--display_dir", default=None,
                    help="write annotated images here (headless)")
    ap.add_argument("--display", action="store_true",
                    help="live GT/pred window; 's' saves a snapshot "
                         "(needs a display server)")
    ap.add_argument("--img_save_folder", default="./image_and_anno/test_image/")
    ap.add_argument("--limit", default=None, type=int)
    ap.add_argument("--process_index", default=None, type=int,
                    help="multi-process eval: this process's contiguous "
                         "record shard; writes a raw .npz part file to merge "
                         "with python -m fdt_torch.cli.merge_eval")
    ap.add_argument("--process_count", default=None, type=int)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from fdt_torch.eval.runner import eval_pyramidbox
    from fdt_torch.models.loader import load_pyramidbox_detector
    det = load_pyramidbox_detector(args.net, args.weights, device=args.device)
    dump = eval_pyramidbox(det, args.anno, args.threshold,
                           dump_path=f"{args.data_save_folder}/data_of_{args.net}.npy",
                           display_dir=args.display_dir, display=args.display,
                           snapshot_dir=args.img_save_folder,
                           snapshot_prefix=f"{args.net}_thresh_{args.threshold}",
                           limit=args.limit, process_index=args.process_index,
                           process_count=args.process_count)
    print_eval_summary(dump, args.process_index, args.process_count)


if __name__ == "__main__":
    main()
