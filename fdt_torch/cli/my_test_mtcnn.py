"""MTCNN WIDER-FACE val evaluation (counterpart of scripts/my_test_mtcnn.py,
with the same flags and dump name).

fdt's script runs its host cascade; the port runs its device cascade
(MTCNNDeviceCascade), whose keep sets are the host cascade's.  The nets are
variables npz files in fdt's format or the reference's .pt files; they are
required, as fdt's defaults (the reference's .pt files) are not in this repo.

  python -m fdt_torch.cli.my_test_mtcnn --pnet pnet.npz --rnet rnet.npz \
      --onet onet.npz --anno image_and_anno/anno/gen_anno_file_val
"""
from __future__ import annotations

import argparse
import dataclasses

from fdt_torch.cli._common import add_device_flag, print_eval_summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pnet", required=True, help="PNet variables npz or .pt")
    ap.add_argument("--rnet", required=True, help="RNet variables npz or .pt")
    ap.add_argument("--onet", required=True, help="ONet variables npz or .pt")
    ap.add_argument("--min_face", default=24.0, type=float)  # My_test_mtcnn.py:13
    ap.add_argument("--anno", default="./image_and_anno/anno/gen_anno_file_val")
    ap.add_argument("--data_save_folder", default="./draw_curve/data/")
    ap.add_argument("--limit", default=None, type=int)
    ap.add_argument("--process_index", default=None, type=int,
                    help="multi-process eval shard; merge part files with "
                         "python -m fdt_torch.cli.merge_eval")
    ap.add_argument("--process_count", default=None, type=int)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from fdt_torch.config import MTCNN
    from fdt_torch.eval.runner import eval_mtcnn
    from fdt_torch.models.loader import load_mtcnn_cascade
    cfg = dataclasses.replace(MTCNN, min_face_size=args.min_face)
    det = load_mtcnn_cascade(args.pnet, args.rnet, args.onet, cfg=cfg, device=args.device)
    dump = eval_mtcnn(det, args.anno,
                      dump_path=f"{args.data_save_folder}/data_of_mtcnn.npy",
                      limit=args.limit, process_index=args.process_index,
                      process_count=args.process_count)
    print_eval_summary(dump, args.process_index, args.process_count)


if __name__ == "__main__":
    main()
