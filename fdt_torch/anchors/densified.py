"""FaceBoxes anchor-densification default boxes and the train-time target
encoder (counterpart of fdt/anchors/densified.py).

The 21,824-box grid of the 1024² config, in its enumeration order: per
layer, the (h, w) cells, then the aspect ratios, then the density offsets
(dx outer, dy inner) on layer 0 only.  Center form, normalized by the input
size; float64 arithmetic cast to float32, bit-equal to fdt's.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from fdt_torch.geometry.boxes import encode, iou_matrix, point_form

from fdt_torch.config import FACEBOX, FaceBoxConfig


@functools.lru_cache(maxsize=None)
def _facebox_default_boxes_cached(cfg: FaceBoxConfig) -> np.ndarray:
    scale = float(cfg.input_size)
    steps = [s / scale for s in cfg.steps]
    sizes = [s / scale for s in cfg.sizes]
    boxes = []
    for i, fmsize in enumerate(cfg.feature_map_sizes):
        for h, w in itertools.product(range(fmsize), repeat=2):
            cx = (w + 0.5) * steps[i]
            cy = (h + 0.5) * steps[i]
            s = sizes[i]
            for j, ar in enumerate(cfg.aspect_ratios[i]):
                if i == 0:
                    for dx, dy in itertools.product(cfg.density[j], repeat=2):
                        boxes.append((cx + dx / 8.0 * s * ar, cy + dy / 8.0 * s * ar,
                                      s * ar, s * ar))
                else:
                    boxes.append((cx, cy, s * ar, s * ar))
    out = np.array(boxes, dtype=np.float32)
    out.flags.writeable = False  # cached: shared by every caller
    return out


def facebox_default_boxes(cfg: FaceBoxConfig = FACEBOX) -> np.ndarray:
    """[21824, 4] center-form default boxes for the 1024² config (read-only)."""
    return _facebox_default_boxes_cached(cfg)


def facebox_encode(gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   default_boxes_cs: torch.Tensor, threshold: float = 0.35):
    """FaceBoxes' train-time targets for a batch (fdt/anchors/densified.py:44-93).

    Every default box takes its best GT by IoU (invalid GT rows at -1, the
    first maximum on ties); every valid GT claims its best default box, and
    where two GT claim one box the last GT wins, as fdt's loop over the GT
    does: each box takes the largest index among the valid GT that claim it
    (`scatter_reduce` with "amax").  conf is the matched GT's label, 0 below
    `threshold`, 1 on a claimed box, and 0 everywhere in an image with no
    valid GT; invalid GT rows are replaced by [0, 0, 1, 1] before encoding
    with variances (0.1, 0.2).

    Args:
      gt_boxes: [B, G, 4] point-form normalized GT (padded).
      gt_labels: [B, G] integer labels (faces are 1 in FaceBoxes).
      gt_valid: [B, G] bool.
      default_boxes_cs: [P, 4] center-form default boxes.
    Returns (loc [B, P, 4], conf [B, P] int64).
    """
    overlaps = iou_matrix(gt_boxes, point_form(default_boxes_cs))      # [B, G, P]
    overlaps = torch.where(gt_valid[..., None], overlaps, torch.full_like(overlaps, -1.0))
    iou = overlaps.amax(dim=1)                                           # [B, P]
    max_index = overlaps.argmax(dim=1)                                   # [B, P]
    best_default = overlaps.argmax(dim=2)                                # [B, G]
    j = torch.arange(gt_boxes.shape[1], device=gt_boxes.device).expand_as(best_default)
    claim = torch.full_like(max_index, -1)
    claim.scatter_reduce_(1, best_default, torch.where(gt_valid, j, -1), "amax")
    forced = claim >= 0
    max_index = torch.where(forced, claim, max_index)

    safe = torch.tensor((0.0, 0.0, 1.0, 1.0), dtype=gt_boxes.dtype, device=gt_boxes.device)
    safe_gt = torch.where(gt_valid[..., None], gt_boxes, safe)
    matched = torch.gather(safe_gt, 1, max_index[..., None].expand(-1, -1, 4))
    loc = encode(matched, default_boxes_cs, (0.1, 0.2))
    conf = torch.gather(gt_labels.long(), 1, max_index)
    conf = torch.where(iou < threshold, torch.zeros_like(conf), conf)
    conf = torch.where(forced, torch.ones_like(conf), conf)
    conf = torch.where(gt_valid.any(dim=1, keepdim=True), conf, torch.zeros_like(conf))
    return loc, conf
