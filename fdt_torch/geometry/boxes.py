"""Box algebra on tensors (counterpart of fdt/geometry/boxes.py:18-100).

Every function keeps fdt's operation order, so float32 results agree with
the JAX package up to the last-bit differences of `exp` between libraries.

Conventions: "point form" = [x1, y1, x2, y2]; "center form" = [cx, cy, w, h];
leading batch dimensions broadcast.
"""
from __future__ import annotations

import torch


def point_form(boxes: torch.Tensor) -> torch.Tensor:
    """Center form [cx,cy,w,h] → point form [x1,y1,x2,y2]."""
    half = boxes[..., 2:] / 2
    return torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], dim=-1)


def center_size(boxes: torch.Tensor) -> torch.Tensor:
    """Point form [x1,y1,x2,y2] → center form [cx,cy,w,h]."""
    return torch.cat([(boxes[..., 2:] + boxes[..., :2]) / 2,
                      boxes[..., 2:] - boxes[..., :2]], dim=-1)


def intersect(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection area, [..., A, 4] × [..., B, 4] → [..., A, B]."""
    max_xy = torch.minimum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    min_xy = torch.maximum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    wh = torch.clamp(max_xy - min_xy, min=0.0)
    return wh[..., 0] * wh[..., 1]


def iou_matrix(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, [..., A, 4] × [..., B, 4] → [..., A, B] (point form)."""
    inter = intersect(box_a, box_b)
    area_a = ((box_a[..., 2] - box_a[..., 0]) * (box_a[..., 3] - box_a[..., 1]))[..., :, None]
    area_b = ((box_b[..., 2] - box_b[..., 0]) * (box_b[..., 3] - box_b[..., 1]))[..., None, :]
    return inter / (area_a + area_b - inter)


def pair_distance(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Center+size pseudo-distance of [..., N, 4] against [..., M, 4] point-form
    boxes → [..., N, M] (fdt/geometry/boxes.py:60-77; the tracker's non-IoU
    mode, calc_performance.py:34-51):
      dz = mean(size_a - size_b);  dxy = center_b - center_a
      dist = (dz² + dx² + dy²) ** 0.25
    """
    a_hi, a_lo = box_a[..., :, None, 2:], box_a[..., :, None, :2]
    b_hi, b_lo = box_b[..., None, :, 2:], box_b[..., None, :, :2]
    d_xy = (b_hi + b_lo) / 2 - (a_hi + a_lo) / 2
    d_sz = (a_hi - a_lo) - (b_hi - b_lo)
    d_z = (d_sz[..., 0] + d_sz[..., 1]) / 2
    dis = d_z * d_z + d_xy[..., 0] * d_xy[..., 0] + d_xy[..., 1] * d_xy[..., 1]
    return torch.pow(dis, 0.25)


def encode(matched: torch.Tensor, priors: torch.Tensor, variances) -> torch.Tensor:
    """SSD variance encoding of matched GT (point form) against priors (center
    form): the inverse of :func:`decode`."""
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2 - priors[..., :2]
    g_cxcy = g_cxcy / (variances[0] * priors[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / priors[..., 2:]
    g_wh = torch.log(g_wh) / variances[1]
    return torch.cat([g_cxcy, g_wh], dim=-1)


def decode(loc: torch.Tensor, priors: torch.Tensor, variances) -> torch.Tensor:
    """SSD variance decoding: loc deltas + priors (center form) → point form."""
    cxcy = priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    x1y1 = cxcy - wh / 2
    return torch.cat([x1y1, x1y1 + wh], dim=-1)
