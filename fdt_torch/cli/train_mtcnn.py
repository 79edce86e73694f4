"""Train an MTCNN cascade stage (counterpart of scripts/train_mtcnn.py, with
its flags and defaults, and --device).

  python -m fdt_torch.cli.train_mtcnn pnet --anno mtcnn_data/imglist_12.txt

The anno file is an assembled list (python -m fdt_torch.cli.gen_mtcnn_data
assemble); its mirror images are added unless --no-flip.  A checkpoint
`<store>/<stage>_epoch_<epoch>` is written after every epoch.  Runs on the
CUDA card unless --device cpu.
"""
from __future__ import annotations

import argparse

from fdt_torch.cli._common import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stage", choices=["pnet", "rnet", "onet"])
    ap.add_argument("--anno", required=True,
                    help="assembled anno file (see python -m fdt_torch.cli.gen_mtcnn_data)")
    ap.add_argument("--prefix", default="")
    ap.add_argument("--epochs", default=10, type=int)
    ap.add_argument("--batch_size", default=512, type=int)
    ap.add_argument("--lr", default=0.01, type=float)
    ap.add_argument("--store", default="model_store/")
    ap.add_argument("--no-flip", action="store_true")
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from fdt_torch.data.mtcnn_data import append_flipped_images, parse_mtcnn_imdb
    from fdt_torch.train.mtcnn_train import train_stage

    imdb = parse_mtcnn_imdb(args.anno, args.prefix)
    if not args.no_flip:
        imdb = append_flipped_images(imdb)
    print(f"{len(imdb)} training records", flush=True)
    trainer = train_stage(args.stage, imdb, args.epochs, args.batch_size, args.store,
                          base_lr=args.lr, device=args.device)
    print(f"{args.stage}: {trainer.step} steps", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
