"""GT ↔ prior matching over a batch (counterpart of fdt/geometry/matching.py).

Each matcher takes padded GT ([B, G, 4] point form, [B, G] labels, a [B, G]
validity mask) and priors [P, 4] in center form, and returns
(loc_t [B, P, 4], conf_t [B, P] int64):
  conf_t = gt_label + 1 for matched priors, 0 (background) below `threshold`
           and everywhere in an image with no valid GT;
  loc_t  = variance-encoded regression targets; an invalid GT row is
           replaced by a unit box first, so no NaN or inf enters them.

The batch axis is fdt's `vmap`.  `argmax` takes the first maximal index, as
`jnp.argmax` does.
"""
from __future__ import annotations

import torch

from fdt_torch.geometry.boxes import encode, iou_matrix, point_form

_SAFE_BOX = (0.0, 0.0, 1.0, 1.0)


def _overlaps(gt_boxes, gt_valid, priors):
    """[B, G, P] IoU of every GT with every prior, -1 on invalid GT rows."""
    overlaps = iou_matrix(gt_boxes, point_form(priors))
    return torch.where(gt_valid[..., None], overlaps, torch.full_like(overlaps, -1.0))


def _gather_targets(gt_boxes, gt_labels, gt_valid, priors, variances,
                    best_truth_overlap, best_truth_idx, threshold):
    safe = torch.tensor(_SAFE_BOX, dtype=gt_boxes.dtype, device=gt_boxes.device)
    safe_gt = torch.where(gt_valid[..., None], gt_boxes, safe)
    matches = torch.gather(safe_gt, 1, best_truth_idx[..., None].expand(-1, -1, 4))
    conf = torch.gather(gt_labels.long(), 1, best_truth_idx) + 1
    conf = torch.where(best_truth_overlap < threshold, torch.zeros_like(conf), conf)
    conf = torch.where(gt_valid.any(dim=1, keepdim=True), conf, torch.zeros_like(conf))
    return encode(matches, priors, variances), conf


def match_default(threshold: float, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                  gt_valid: torch.Tensor, priors: torch.Tensor, variances):
    """Best-GT-per-prior matching, no bipartite force-assign
    (fdt/geometry/matching.py:39-58)."""
    overlaps = _overlaps(gt_boxes, gt_valid, priors)
    return _gather_targets(gt_boxes, gt_labels, gt_valid, priors, variances,
                           overlaps.amax(dim=1), overlaps.argmax(dim=1), threshold)


def match_ensure_max_prior(threshold: float, gt_boxes: torch.Tensor,
                           gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                           priors: torch.Tensor, variances):
    """Bipartite matching: every valid GT claims its best prior (overlap := 2)
    (fdt/geometry/matching.py:61-91).

    fdt walks the GTs in order, so when two GTs claim one prior the last one
    wins; here each prior takes the largest index among the valid GTs that
    claim it (`scatter_reduce` with "amax"), which is the same result without
    relying on the order of repeated-index writes."""
    overlaps = _overlaps(gt_boxes, gt_valid, priors)
    best_truth_overlap = overlaps.amax(dim=1)
    best_truth_idx = overlaps.argmax(dim=1)
    best_prior_idx = overlaps.argmax(dim=2)                        # [B, G]
    g = gt_boxes.shape[1]
    j = torch.arange(g, device=gt_boxes.device).expand_as(best_prior_idx)
    claim = torch.full_like(best_truth_idx, -1)
    claim.scatter_reduce_(1, best_prior_idx, torch.where(gt_valid, j, -1), "amax")
    claimed = claim >= 0
    best_truth_overlap = torch.where(claimed, torch.full_like(best_truth_overlap, 2.0),
                                     best_truth_overlap)
    best_truth_idx = torch.where(claimed, claim, best_truth_idx)
    return _gather_targets(gt_boxes, gt_labels, gt_valid, priors, variances,
                           best_truth_overlap, best_truth_idx, threshold)
