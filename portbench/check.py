"""The comparison that decides `correct`: the rows the timed path returned
for an image against the plain reference's forward and head on the same
image (portbench.reference).

Each returned row is matched to the prior whose reference box lies nearest
(largest coordinate gap) and read against that prior's reference score.
A cell holds the numbers its portbench/limits/<workload>.json names:

  unmatched_share   rows of either side, scored at least COVER_SCORE_MARGIN
                    above the image's cut (the threshold, or the lowest
                    returned score when top_k rows came back), that no row of
                    the other side overlaps by IoU >= COVER_IOU, over all
                    such rows: detections lost or invented.  Every image's
                    rows count, so a dropped or misplaced answer shows.
  overlapping_kept  pairs of returned rows of one image whose IoU is at or
                    above the NMS threshold (+1e-4 for the rounding of rows
                    scaled to pixels): greedy NMS never keeps one.
  score_gap_mean    the mean over returned rows of |row score - reference
                    score|,
  score_bias        and |the mean of row score - reference score|: scores
                    rescaled, shifted or left as logits show here even
                    where the ranking, and so the rows, stay.

For the record: score_gap (the widest), box_gap_px (the widest box gap).
"""
from __future__ import annotations

import numpy as np
import torch

OVERLAP_ROUNDING = 1e-4
COVER_SCORE_MARGIN = 0.02
COVER_IOU = 0.2


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lo = torch.maximum(a[:, None, :2], b[None, :, :2])
    hi = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (hi - lo).clamp(min=0).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def _nearest(rows: torch.Tensor, boxes: torch.Tensor, block: int = 256):
    """For each row box, the index of the nearest box and the gap (largest
    coordinate difference)."""
    idx, gap = [], []
    for i in range(0, len(rows), block):
        d = (rows[i:i + block, None, :] - boxes[None, :, :]).abs().amax(-1)
        g, j = d.min(-1)
        idx.append(j)
        gap.append(g)
    if not idx:
        return rows.new_zeros(0, dtype=torch.long), rows.new_zeros(0)
    return torch.cat(idx), torch.cat(gap)


def compare_image(rows: np.ndarray, ref, nms_thresh: float, cut: float, top_k: int,
                  device="cpu") -> dict:
    """Numbers of one image: `rows` the program's [n, 5] pixel rows, `ref`
    the reference's ImageResult, `cut` the score threshold of the rows."""
    dev = torch.device(device)
    rows_t = torch.as_tensor(np.asarray(rows, np.float32), device=dev).reshape(-1, 5)
    boxes = torch.as_tensor(ref.boxes, device=dev)
    scores = torch.as_tensor(ref.scores, device=dev)
    idx, gap = _nearest(rows_t[:, :4], boxes)
    score_gaps = rows_t[:, 4] - scores[idx]
    iou = _iou(rows_t[:, :4], rows_t[:, :4])
    pairs = torch.triu(iou >= nms_thresh + OVERLAP_ROUNDING, diagonal=1)
    if len(rows_t) >= top_k:
        cut = max(cut, float(rows_t[:, 4].min()))
    ref_rows = torch.as_tensor(ref.rows, device=dev).reshape(-1, 5)
    sure = cut + COVER_SCORE_MARGIN
    a = ref_rows[ref_rows[:, 4] >= sure]
    b = rows_t[rows_t[:, 4] >= sure]
    cover = _iou(a[:, :4], rows_t[:, :4]) >= COVER_IOU
    support = _iou(b[:, :4], ref_rows[:, :4]) >= COVER_IOU
    return {"score_gaps": score_gaps.cpu().numpy(),
            "box_gap_px": float(gap.max()) if len(gap) else 0.0,
            "overlapping_kept": int(pairs.sum()),
            "uncovered": int((~cover.any(-1)).sum()) if len(rows_t) else len(a),
            "unsupported": int((~support.any(-1)).sum()) if len(ref_rows) else len(b),
            "considered": len(a) + len(b), "rows": len(rows_t), "ref_rows": len(ref_rows)}


def summarize(per_image: list[dict]) -> dict:
    signed = np.concatenate([p["score_gaps"] for p in per_image] + [np.zeros(0, np.float32)])
    gaps = np.abs(signed)
    total = lambda k: sum(p[k] for p in per_image)  # noqa: E731
    unmatched = total("uncovered") + total("unsupported")
    return {"unmatched_share": unmatched / max(total("considered"), 1),
            "overlapping_kept": total("overlapping_kept"),
            "uncovered": total("uncovered"), "unsupported": total("unsupported"),
            "considered": total("considered"),
            "score_gap": float(gaps.max()) if len(gaps) else 0.0,
            "score_gap_mean": float(gaps.mean()) if len(gaps) else 0.0,
            "score_bias": abs(float(signed.mean())) if len(gaps) else 0.0,
            "box_gap_px": max((p["box_gap_px"] for p in per_image), default=0.0),
            "rows": total("rows"), "ref_rows": total("ref_rows"), "images": len(per_image)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every held number under its limit, {name: {"value", "limit"}}).  A
    count limit of 0 is met by 0 alone; a gap must stay below its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers[name]
        passed = value <= limit if limit == 0 else value < limit
        ok &= bool(passed)
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
