"""Curve reporting: PR/ROC overlays and training-loss curves (a copy of
fdt/eval/curves.py; the port imports nothing of fdt).

Host-side matplotlib tooling matching draw_curve/draw_pr_roc.py:5-43,
draw_curve/draw_curves.py:5-78 and draw_curve/draw_loss.py, matplotlib
imported inside the functions.  `plot_curves` writes to a file instead of
plt.show() so it works headless.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from fdt_torch.eval.pr import pr_curve, roc_curve


def plot_curves(data_list, labels: Sequence[str], title: str, xlabel: str,
                ylabel: str, label_position: str = "tr",
                out_path: str | None = None):
    """draw_curve equivalent (draw_curves.py:5-30); saves to out_path if given."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.title(title)
    for data, label in zip(data_list, labels):
        if isinstance(data, np.ndarray):
            plt.plot(data, label=label)
        else:
            plt.plot(data[0], data[1], label=label)
    loc = {"bl": "lower left", "br": "lower right",
           "tl": "upper left", "tr": "upper right"}[label_position]
    plt.legend(loc=loc)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.grid()
    if out_path:
        plt.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close()
    else:  # pragma: no cover
        plt.show()


def plot_pr_roc(dump_files: Sequence[str], labels: Sequence[str],
                out_prefix: str = "curves"):
    """PR + ROC overlay from eval .npy dumps (draw_pr_roc.py:22-43)."""
    pr_list, roc_list = [], []
    for f in dump_files:
        dump = np.load(f)
        pr_list.append(pr_curve(dump))   # (recall, precision)
        roc_list.append(roc_curve(dump))
    plot_curves(pr_list, labels, "precision-recall curve",
                xlabel="recall", ylabel="precision", label_position="bl",
                out_path=f"{out_prefix}_pr.png")
    plot_curves(roc_list, labels, "roc curve",
                xlabel="true positive", ylabel="recall", label_position="br",
                out_path=f"{out_prefix}_roc.png")


def assemble_loss(data_files: Sequence[str], isoverall: bool = True,
                  index: int = 0, smooth: int = 1, iseval: bool = False,
                  eval_freq: int = 500) -> np.ndarray:
    """Splice per-checkpoint loss .npy files into one series
    (assemble_data, draw_curves.py:32-78).

    index selects the row of the 5-row dump: 0 total, 1 face_loc, 2 face_conf,
    3 head_loc, 4 head_conf.  smooth > 1 applies the reference's box filter;
    iseval linearly interpolates sparse eval losses to eval_freq spacing.
    """
    assembled = np.array([])
    for f in data_files:
        data = np.load(f)
        data = data[data.nonzero()]
        if isoverall:
            assembled = np.hstack((assembled, data.reshape(5, -1)[index, :]))
        else:
            assembled = np.hstack((assembled, data))
    if smooth > 1:
        out = assembled.copy()
        temp = assembled[0]
        acc = 0.0
        for i, v in enumerate(assembled):
            acc += v
            if (i + 1) % smooth == 0:
                temp = acc / smooth
                acc = 0.0
            out[i] = temp
        assembled = out
    if iseval:
        grid = np.hstack((assembled.reshape(-1, 1),
                          np.zeros((assembled.shape[0], eval_freq - 1))))
        for i in range(grid.shape[0]):
            if i == grid.shape[0] - 1:
                grid[i].fill(grid[i, 0])
                break
            for j in range(grid.shape[1]):
                grid[i, j] = (grid[i, 0] * (eval_freq - j) +
                              grid[i + 1, 0] * j) / eval_freq
        assembled = grid.reshape(-1)
    return assembled
