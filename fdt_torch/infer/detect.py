"""SSD test-time detection head: decode → per-class threshold → NMS → fixed
output (counterpart of fdt/infer/detect.py:20-53).

fdt vmaps a per-image function; here the batch and the classes are leading
dimensions, so every image × class problem goes through one NMS kernel launch.
"""
from __future__ import annotations

import torch

from fdt_torch.config import DetectConfig
from fdt_torch.geometry.boxes import decode
from fdt_torch.geometry.nms import nms_padded


def ssd_detect(loc: torch.Tensor, conf: torch.Tensor, priors: torch.Tensor,
               cfg: DetectConfig, budget: int | None = None) -> torch.Tensor:
    """Args:
      loc:    [B, P, 4] location predictions.
      conf:   [B, P, C] softmax class scores.
      priors: [P, 4] center-form priors.
      cfg:    DetectConfig (top_k / conf_thresh / nms_thresh / nms_top_k / variance).
      budget: override of cfg.nms_top_k (boxes entering NMS).

    Returns: [B, C, top_k, 5]; row = [score, x1, y1, x2, y2]; class 0 and rows
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
    keep = torch.arange(cfg.top_k, device=conf.device) < count[..., None]
    rows = torch.where(keep[..., None], rows, 0.0)
    return torch.cat([rows.new_zeros(b, 1, cfg.top_k, 5), rows], dim=1)
