"""Generate MTCNN stage training data (counterpart of
scripts/gen_mtcnn_data.py, with its flags and defaults, and --device).

Stages:
  pnet      random-crop patch factory from WIDER-style annotations
  rnet      hard examples mined with a trained PNet (--pnet_ckpt)
  onet      hard examples mined with trained PNet and RNet (--pnet_ckpt,
            --rnet_ckpt)
  assemble  merge and subsample stage anno lists into one training file

  python -m fdt_torch.cli.gen_mtcnn_data pnet --anno wider_anno.txt --out mtcnn_data/
  python -m fdt_torch.cli.gen_mtcnn_data rnet --anno wider_anno.txt \\
      --pnet_ckpt model_store/pnet_epoch_10

The checkpoints are checkpoint directories of the port, variables npz
files in fdt's format or the reference's .pt files.  They are required:
fdt falls back to the reference's own .pt nets, which this repo does not
hold.  The nets a stage never calls are the stage trainer's
initialisation.  The mining runs the host cascade
(fdt_torch.infer.mtcnn.MTCNNDetector) on the CUDA card unless --device cpu.
"""
from __future__ import annotations

import argparse

import numpy as np

from fdt_torch.cli._common import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stage", choices=["pnet", "rnet", "onet", "assemble"])
    ap.add_argument("--anno", help="WIDER-style anno (path x1 y1 x2 y2 …)")
    ap.add_argument("--prefix", default="")
    ap.add_argument("--out", default="mtcnn_data/")
    ap.add_argument("--pnet_ckpt", default=None,
                    help="trained PNet: a checkpoint directory, a variables npz or a .pt")
    ap.add_argument("--rnet_ckpt", default=None,
                    help="trained RNet (stage onet): a checkpoint directory, a variables npz "
                         "or a .pt")
    ap.add_argument("--files", nargs="*", help="anno lists for assemble")
    ap.add_argument("--seed", default=0, type=int)
    add_device_flag(ap)
    return ap


def mining_detector(pnet_ckpt: str, rnet_ckpt: str | None, device=None):
    """The host cascade of the trained nets; the nets not given are the
    stage trainer's initialisation (MTCNNStageTrainer's lecun_init)."""
    from fdt_torch.infer.mtcnn import MTCNNDetector
    from fdt_torch.models.mtcnn import ONet, PNet, RNet
    from fdt_torch.train.checkpoint import load_model_weights
    from fdt_torch.train.mtcnn_train import lecun_init
    pnet = load_model_weights(pnet_ckpt, PNet())
    rnet = load_model_weights(rnet_ckpt, RNet()) if rnet_ckpt else lecun_init(RNet())
    return MTCNNDetector(pnet, rnet, lecun_init(ONet()), device=device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from fdt_torch.data.mtcnn_data import (assemble_annotations, gen_hard_example_data,
                                           gen_pnet_train_data)
    if args.stage == "assemble":
        n = assemble_annotations(args.out, args.files, np.random.RandomState(args.seed))
        print(f"assembled {n} lines into {args.out}")
        return 0
    if args.stage == "pnet":
        st = gen_pnet_train_data(args.anno, args.prefix, args.out,
                                 np.random.RandomState(args.seed))
    else:
        if args.pnet_ckpt is None or (args.stage == "onet" and args.rnet_ckpt is None):
            need = "--pnet_ckpt" if args.stage == "rnet" else "--pnet_ckpt and --rnet_ckpt"
            raise SystemExit(f"{args.stage}: {need} required (fdt falls back to the "
                             "reference's .pt nets, which the repo does not hold)")
        det = mining_detector(args.pnet_ckpt, args.rnet_ckpt if args.stage == "onet" else None,
                              args.device)
        if args.stage == "rnet":
            def detect(img):
                _, aligned = det.detect_pnet(img)
                return aligned
            size = 24
        else:
            def detect(img):
                _, aligned = det.detect_pnet(img)
                if aligned is None:
                    return None
                _, aligned = det.detect_rnet(img, aligned)
                return aligned
            size = 48
        st = gen_hard_example_data(detect, args.anno, args.prefix, args.out, size)
    print(f"pos {st.pos} neg {st.neg} part {st.part}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
