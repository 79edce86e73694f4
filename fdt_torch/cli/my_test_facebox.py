"""FaceBoxes WIDER-FACE val evaluation (counterpart of
scripts/my_test_facebox.py, with the same flags and dump name).

--weights is a variables npz in fdt's format or a reference .pth/.pt state
dict.  It is required: fdt's default, the reference's faceboxes.pt, is not
in this repo.

  python -m fdt_torch.cli.my_test_facebox --weights faceboxes.npz \
      --anno image_and_anno/anno/gen_anno_file_val
"""
from __future__ import annotations

import argparse

from fdt_torch.cli._common import add_device_flag, print_eval_summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", required=True, help="variables npz or torch .pth/.pt")
    ap.add_argument("--anno", default="./image_and_anno/anno/gen_anno_file_val")
    ap.add_argument("--data_save_folder", default="./draw_curve/data/")
    ap.add_argument("--limit", default=None, type=int)
    ap.add_argument("--process_index", default=None, type=int,
                    help="multi-process eval shard; merge part files with "
                         "python -m fdt_torch.cli.merge_eval")
    ap.add_argument("--process_count", default=None, type=int)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from fdt_torch.eval.runner import eval_facebox
    from fdt_torch.models.loader import load_facebox_detector
    det = load_facebox_detector(args.weights, device=args.device)
    dump = eval_facebox(det, args.anno,
                        dump_path=f"{args.data_save_folder}/data_of_facebox.npy",
                        limit=args.limit, process_index=args.process_index,
                        process_count=args.process_count)
    print_eval_summary(dump, args.process_index, args.process_count)


if __name__ == "__main__":
    main()
