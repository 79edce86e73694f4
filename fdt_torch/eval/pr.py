"""Detection-quality metric harness: per-image TF/confidence accounting and the
`.npy` dump format shared with the reference's PR/ROC tooling (a copy of
fdt/eval/pr.py, which is numpy only; the port imports nothing of fdt).

Reference: utils/calc_performance.py:77-92 (`calc_pr`), My_test.py:105-171
(accumulation + sorted dump), draw_curve/draw_pr_roc.py:5-43 (curve generation).
The dump layout is bit-compatible: a [2, D+1] array whose first row is the
greater-than-IoU-threshold flag per detection, second row the confidence, sorted
by descending confidence, with a final [[0], [total_gt]] column appended.
"""
from __future__ import annotations

import numpy as np


def calc_pr(predict: np.ndarray, truth_xywh: np.ndarray, iou_thresh: float = 0.5):
    """Per-image true/false accounting.

    Args:
      predict: [N,5] float [x1, y1, x2, y2, score].
      truth_xywh: [M,4] [x, y, w, h].
      iou_thresh: match threshold.

    Returns ([2,N] array of (tf_flag, score) columns, M).
    """
    if truth_xywh.shape[0] == 0:
        # image with no GT: every detection is a false positive (the
        # reference's np.max over the empty IoU axis would crash here,
        # calc_performance.py:88)
        return np.vstack((np.zeros(len(predict), np.int32),
                          predict[:, 4])), 0
    truth = np.hstack((truth_xywh[:, :2], truth_xywh[:, 2:] + truth_xywh[:, :2])).astype(np.float64)
    pred = predict[:, :4].astype(np.float64)
    inter_w = np.maximum(0, np.minimum(truth[:, None, 2], pred[None, :, 2]) -
                         np.maximum(truth[:, None, 0], pred[None, :, 0]))
    inter_h = np.maximum(0, np.minimum(truth[:, None, 3], pred[None, :, 3]) -
                         np.maximum(truth[:, None, 1], pred[None, :, 1]))
    inter = inter_w * inter_h
    area_t = (truth[:, 2] - truth[:, 0]) * (truth[:, 3] - truth[:, 1])
    area_p = (pred[:, 2] - pred[:, 0]) * (pred[:, 3] - pred[:, 1])
    iou = inter / (area_t[:, None] + area_p[None, :] - inter)
    tf = (np.max(iou, axis=0) > iou_thresh).astype(np.int32)
    return np.vstack((tf, predict[:, 4])), truth.shape[0]


class TfConfAccumulator:
    """Accumulates per-image calc_pr outputs and writes the reference dump."""

    def __init__(self, iou_thresh: float = 0.5):
        self.iou_thresh = iou_thresh
        self.tf_conf = np.array([[], []])
        self.truth_num = 0

    def add(self, predict: np.ndarray, truth_xywh: np.ndarray):
        if len(predict) == 0:
            self.truth_num += truth_xywh.shape[0]
            return
        tf_conf, n = calc_pr(predict, truth_xywh, self.iou_thresh)
        self.tf_conf = np.hstack((self.tf_conf, tf_conf))
        self.truth_num += n

    def finalize(self) -> np.ndarray:
        """Sorted-desc [2, D+1] dump (My_test.py:169-171)."""
        order = np.argsort(self.tf_conf[1, :])[::-1]
        sorted_tc = self.tf_conf[:, order]
        return np.hstack((sorted_tc, [[0], [self.truth_num]]))

    def raw(self):
        """(tf_conf [2,D] in accumulation order, truth_num) — the shard
        payload for bit-exact multi-process merging (see merge_raw)."""
        return self.tf_conf, self.truth_num

    def save(self, path: str):
        np.save(path, self.finalize())


def merge_raw(parts) -> np.ndarray:
    """Merge per-process RAW accumulator payloads (TfConfAccumulator.raw)
    into the single-process dump.

    Multi-host eval shards the record list into CONTIGUOUS blocks
    (fdt_torch.data.EvalCollector), so concatenating the raw per-process columns in
    process order reproduces the unsharded ACCUMULATION order exactly; the
    same argsort then yields a dump bit-identical to an unsharded run, tied
    confidences included (tests/test_data_eval.py).
    """
    tf_conf = np.hstack([np.asarray(p[0]) for p in parts]
                        or [np.zeros((2, 0))])
    truth_num = sum(p[1] for p in parts)
    order = np.argsort(tf_conf[1, :])[::-1]
    return np.hstack((tf_conf[:, order], [[0], [truth_num]]))


def save_raw_part(raw, path: str) -> None:
    """Persist one process's RAW accumulator payload (TfConfAccumulator.raw)
    as an .npz part file for later merge_part_files."""
    tf_conf, truth_num = raw
    np.savez(path, tf_conf=np.asarray(tf_conf), truth_num=truth_num)


def merge_part_files(paths) -> np.ndarray:
    """merge_raw over part files saved by save_raw_part, in the given order
    (process order ⇒ bit-identical to the unsharded dump)."""
    parts = []
    for p in paths:
        with np.load(p) as d:
            parts.append((d["tf_conf"], int(d["truth_num"])))
    return merge_raw(parts)


def merge_dumps(dumps) -> np.ndarray:
    """Merge per-process FINALIZED dumps into one.

    Value-identical to the unsharded dump (same multiset of columns, same
    descending-confidence order), but EXACTLY tied confidences may permute
    within their tie group relative to an unsharded run, because each shard
    arrives pre-sorted rather than in accumulation order.  When bit-exact
    parity matters (golden comparisons), ship the raw accumulators and use
    merge_raw instead.
    """
    parts = [np.asarray(d) for d in dumps]
    tf_conf = np.hstack([p[:, :-1] for p in parts] or [np.zeros((2, 0))])
    truth_num = sum(p[1, -1] for p in parts)
    order = np.argsort(tf_conf[1, :])[::-1]
    return np.hstack((tf_conf[:, order], [[0], [truth_num]]))


def gen_tp_fp(dump: np.ndarray):
    """Cumulative TP/FP over the sorted dump (draw_curve/draw_pr_roc.py:5-20)."""
    tf, conf = dump[0, :-1], dump[1, :-1]
    truth_num = dump[1, -1]
    tp = np.cumsum(tf)
    fp = np.cumsum(1 - tf)
    return tp, fp, truth_num, conf


def pr_curve(dump: np.ndarray):
    """(recall, precision) arrays (draw_pr_roc.py:22-31)."""
    tp, fp, truth_num, _ = gen_tp_fp(dump)
    recall = tp / truth_num
    precision = tp / np.maximum(tp + fp, 1)
    return recall, precision


def roc_curve(dump: np.ndarray):
    """(false positives, recall) arrays (draw_pr_roc.py:33-43)."""
    tp, fp, truth_num, _ = gen_tp_fp(dump)
    return fp, tp / truth_num


def average_precision(dump: np.ndarray) -> float:
    """AP via trapezoidal integration of the PR curve (for reporting)."""
    recall, precision = pr_curve(dump)
    if recall.size == 0:
        return 0.0
    return float(np.trapezoid(precision, recall))
