"""Generate and validate the one-line anno files (counterpart of
scripts/gen_anno.py; the reference's image_and_anno/anno/gen_anno.py).

  python -m fdt_torch.cli.gen_anno wider_face_val_bbx_gt.txt images_val \\
      image_and_anno/anno/gen_anno_file_val

Prints the records written, every message of the validator and
"test finished", as fdt's script does.
"""
from __future__ import annotations

import argparse

from fdt_torch.data.anno import generate_anno_file, validate_anno_file


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("bbx_gt", help="wider_face_{train,val}_bbx_gt.txt")
    ap.add_argument("img_dir", help="images_{train,val} directory")
    ap.add_argument("out", help="output gen_anno_file path")
    args = ap.parse_args(argv)
    n = generate_anno_file(args.bbx_gt, args.img_dir, args.out)
    print(f"generated {n} records")
    for msg in validate_anno_file(args.out):
        print(msg)
    print("test finished")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
