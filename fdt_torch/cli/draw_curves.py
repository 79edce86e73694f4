"""Plot PR/ROC overlays or training-loss curves from dump files (counterpart
of scripts/draw_curves.py).

  python -m fdt_torch.cli.draw_curves pr_roc data_of_repo.npy --out curves
  python -m fdt_torch.cli.draw_curves loss repo_loss_*.npy --out loss.png
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("pr_roc", help="PR + ROC overlay from eval dumps")
    pr.add_argument("dumps", nargs="+", help="data_of_<net>.npy files")
    pr.add_argument("--labels", nargs="*", default=None)
    pr.add_argument("--out", default="curves")

    ls = sub.add_parser("loss", help="assembled training-loss curve")
    ls.add_argument("dumps", nargs="+", help="<name>_loss_<iter>.npy files in order")
    ls.add_argument("--index", type=int, default=0,
                    help="0 total, 1 face_loc, 2 face_conf, 3 head_loc, 4 head_conf")
    ls.add_argument("--smooth", type=int, default=1)
    ls.add_argument("--eval", action="store_true", dest="iseval")
    ls.add_argument("--out", default="loss.png")
    args = ap.parse_args(argv)

    import numpy as np

    if args.cmd == "pr_roc":
        from fdt_torch.eval.curves import plot_pr_roc
        from fdt_torch.eval.pr import average_precision
        labels = args.labels or [d.split("data_of_")[-1].removesuffix(".npy")
                                 for d in args.dumps]
        plot_pr_roc(args.dumps, labels, out_prefix=args.out)
        for d, label in zip(args.dumps, labels):
            print(f"{label}: AP = {average_precision(np.load(d)):.4f}")
        print(f"wrote {args.out}_pr.png / {args.out}_roc.png")
    else:
        from fdt_torch.eval.curves import assemble_loss, plot_curves
        series = assemble_loss(args.dumps, index=args.index,
                               smooth=args.smooth, iseval=args.iseval)
        plot_curves([series], ["loss"], "training loss", "iteration", "loss",
                    out_path=args.out)
        print(f"wrote {args.out} ({series.shape[0]} points)")


if __name__ == "__main__":
    main()
