"""Fixed-shape greedy NMS (counterpart of fdt/geometry/nms.py:31-189).

The greedy result — boxes in descending-score order, a box suppressed when a
kept earlier box overlaps it by >= the threshold — is computed with static
shapes:

  1. take the top-`budget` boxes by score with a stable descending sort
     (padding carries -inf scores),
  2. solve the greedy recurrence keep[i] = valid[i] ∧ ¬∃j<i: S[j,i] ∧ keep[j]:
     on the card by a hand-written kernel (fdt_torch.ops.nms: K1, tiled, or
     K2, the literal loop), on the CPU by the fixpoint `nms_keep_mask`, which
     is the kernels' plain version,
  3. stable-compact the kept indices to the front.

Every function takes leading batch dimensions: one call solves all the
problems of a batch (fdt vmaps the per-problem function instead).
"""
from __future__ import annotations

import numpy as np
import torch

from fdt_torch.geometry.boxes import intersect, iou_matrix


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, thresh: float,
              mode: str = "union") -> list[int]:
    """Host greedy NMS, the oracle: descending-score order, suppress
    overlap >= thresh, 'union' (IoU) or 'minimum' (inter / min-area)."""
    boxes = np.asarray(boxes, np.float64)
    scores = np.asarray(scores, np.float64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1) * (y2 - y1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
        if mode == "union":
            ovr = inter / (areas[i] + areas[order[1:]] - inter)
        elif mode == "minimum":
            ovr = inter / np.minimum(areas[i], areas[order[1:]])
        else:
            raise ValueError(f"unknown NMS mode: {mode}")
        order = order[1:][ovr < thresh]
    return keep


def _overlap_matrix(boxes: torch.Tensor, mode: str) -> torch.Tensor:
    """Pairwise overlap, [..., N, 4] → [..., N, N], point form; row = the
    earlier box.  "union": IoU; "minimum": inter / min(area_a, area_b)."""
    if mode == "union":
        return iou_matrix(boxes, boxes)
    if mode == "minimum":
        inter = intersect(boxes, boxes)
        area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
        return inter / torch.minimum(area[..., :, None], area[..., None, :])
    raise ValueError(f"unknown NMS mode: {mode}")


def nms_keep_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                  mode: str = "union",
                  seg_id: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy-NMS keep mask over boxes already sorted by descending score.

    The plain PyTorch version of kernels K1 and K2 (fdt_torch.ops.nms), by fixpoint
    iteration over the suppression DAG as in fdt/geometry/nms.py:110-128.

    Args:
      boxes: [..., N, 4] point-form boxes in descending-score order.
      valid: [..., N] bool; padding / below-threshold entries are False.
      iou_thresh: overlap >= iou_thresh suppresses.
      mode: "union" | "minimum".
      seg_id: optional [..., N] int segment ids; suppression then acts only
        within a segment.

    Returns: [..., N] bool keep mask (a subset of `valid`).
    """
    n = boxes.shape[-2]
    thresh = torch.tensor(iou_thresh, dtype=torch.float32, device=boxes.device)
    ov = _overlap_matrix(boxes, mode)
    idx = torch.arange(n, device=boxes.device)
    # S[..., j, i]: an earlier (higher-score) valid box j suppresses i.
    suppress = (ov >= thresh) & (idx[:, None] < idx[None, :]) & valid[..., :, None]
    if seg_id is not None:
        suppress &= seg_id[..., :, None] == seg_id[..., None, :]
    keep, prev, it = valid, ~valid, 0
    while it < n and bool(torch.any(keep != prev)):
        new = valid & ~torch.any(suppress & keep[..., :, None], dim=-2)
        keep, prev, it = new, keep, it + 1
    return keep


_IMPLS = ("auto", "xla", "pallas", "pallas_tiled")


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
               budget: int, out_k: int, mode: str = "union",
               valid: torch.Tensor | None = None, impl: str = "auto"):
    """Greedy NMS with fixed-size output.

    Args:
      boxes:  [..., N, 4] point form.
      scores: [..., N]; entries to ignore carry -inf (or pass `valid`).
      iou_thresh: suppression threshold.
      budget: number of top-score boxes entering NMS.
      out_k:  detections returned.
      mode:   "union" | "minimum".
      valid:  optional [..., N] bool mask.
      impl:   fdt's four values, each meaning the same keep set:
        "pallas_tiled" → kernel K1 (nms_keep_tiled, with out_k);
        "pallas"       → kernel K2 (nms_keep_greedy);
        "xla"          → the plain fixpoint nms_keep_mask, on whatever
                         device the tensors are on;
        "auto"         → K1, which is the plain version on a CPU tensor.
        A kernel wrapper computes the plain version for a CPU tensor.

    Returns:
      keep_idx: [..., out_k] int32 indices into the input, in descending-score
        order; entries past `count` are arbitrary (mask with count).
      count:   [...] int32 number of kept boxes (≤ out_k).
    """
    from fdt_torch.ops.nms import nms_keep_greedy, nms_keep_tiled

    if impl not in _IMPLS:
        raise ValueError(f"unknown NMS impl {impl!r}; expected one of {_IMPLS}")
    n = scores.shape[-1]
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
    k = min(budget, n)
    # stable: equal scores keep index order, as lax.top_k breaks ties toward
    # the lower index (torch.topk promises no order among ties)
    top_scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, order = top_scores[..., :k], order[..., :k]
    top_boxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    top_valid = top_scores > -torch.inf
    if impl == "pallas":
        keep = nms_keep_greedy(top_boxes, top_valid, iou_thresh, mode=mode)
    elif impl == "xla":
        keep = nms_keep_mask(top_boxes, top_valid, iou_thresh, mode=mode)
    else:
        keep = nms_keep_tiled(top_boxes, top_valid, iou_thresh, mode=mode,
                              out_k=out_k)
    # stable-compact kept entries to the front (they are already score-ordered)
    comp = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices
    count = torch.clamp(keep.sum(dim=-1), max=out_k).to(torch.int32)
    if out_k <= k:
        keep_idx = torch.gather(order, -1, comp[..., :out_k])
    else:
        pad = order.new_zeros(*order.shape[:-1], out_k - k)
        keep_idx = torch.cat([torch.gather(order, -1, comp), pad], dim=-1)
    return keep_idx.to(torch.int32), count
