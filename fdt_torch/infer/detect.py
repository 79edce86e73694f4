"""SSD test-time detection head: decode → per-class threshold → NMS → fixed
output (counterpart of fdt/infer/detect.py:20-53).

fdt vmaps a per-image function; here the batch and the classes are leading
dimensions, so every image × class problem goes through one NMS kernel launch.

A per-prior extra of points (RetinaFace's five landmarks) rides the same
selection: it is gathered by the kept indices and decoded against the kept
rows' priors after NMS, so that top_k rows are decoded and not every prior.
"""
from __future__ import annotations

import torch

from fdt_torch.config import DetectConfig
from fdt_torch.geometry.boxes import decode
from fdt_torch.geometry.nms import nms_padded
from fdt_torch.utils import trace


def decode_points(pred: torch.Tensor, priors: torch.Tensor, variance: float) -> torch.Tensor:
    """Point offsets [..., 2k] against center-form priors [..., 4] → points
    [..., 2k] (x, y of each), as the box centre decodes: prior_xy + pred ·
    variance · prior_wh (biubug6's decode_landm)."""
    pts = pred.unflatten(-1, (-1, 2))
    return (priors[..., None, :2] + pts * variance * priors[..., None, 2:]).flatten(-2)


def ssd_detect(loc: torch.Tensor, conf: torch.Tensor, priors: torch.Tensor,
               cfg: DetectConfig, budget: int | None = None,
               extra: torch.Tensor | None = None) -> torch.Tensor:
    """Args:
      loc:    [B, P, 4] location predictions.
      conf:   [B, P, C] softmax class scores.
      priors: [P, 4] center-form priors.
      cfg:    DetectConfig (top_k / conf_thresh / nms_thresh / nms_top_k / variance).
      budget: override of cfg.nms_top_k (boxes entering NMS).
      extra:  optional [B, P, E] point offsets (E even: landmarks), decoded
              for the kept rows alone (decode_points, cfg.variance[0]).

    Returns: [B, C, top_k, 5 + E]; row = [score, x1, y1, x2, y2, then the E
      decoded point coordinates], normalized like the box; class 0 and rows
      past the kept count are zeros.
    """
    b, p, c = conf.shape
    budget = min(budget or cfg.nms_top_k, p)
    boxes = decode(loc, priors, cfg.variance)                    # [B, P, 4]
    scores = conf[..., 1:].transpose(1, 2)                       # [B, C-1, P]
    boxes = boxes[:, None].expand(b, c - 1, p, 4)
    valid = scores > cfg.conf_thresh
    idx, count = nms_padded(boxes, scores, cfg.nms_thresh, budget=budget,
                            out_k=cfg.top_k, valid=valid)
    if cfg.drop_single_candidate:
        count = torch.where(valid.sum(dim=-1) == 1, 0, count)
    idx = idx.long()
    rows = torch.cat([torch.gather(scores, -1, idx)[..., None],
                      torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))],
                     dim=-1)                                     # [B, C-1, top_k, 5]
    if extra is not None:
        with trace.span("detect.landmarks"):
            e = extra.shape[-1]
            kept = torch.gather(extra[:, None].expand(b, c - 1, p, e), -2,
                                idx[..., None].expand(*idx.shape, e))
            rows = torch.cat([rows, decode_points(kept, priors[idx], cfg.variance[0])],
                             dim=-1)                             # [B, C-1, top_k, 5 + E]
    keep = torch.arange(cfg.top_k, device=conf.device) < count[..., None]
    rows = torch.where(keep[..., None], rows, 0.0)
    return torch.cat([rows.new_zeros(b, 1, cfg.top_k, rows.shape[-1]), rows], dim=1)
