"""Pair tests that greedy NMS needs on given boxes, and the least time the
NMS kernel (K1) could take for them.

A valid box is tested against the kept boxes before it, in order, up to and
including the first that suppresses it.  With out_k the walk ends at the
out_k-th keep and later boxes need no test.  An overlap test is 13 float32
operations (2 min, 2 max, 2 sub, 2 clamp and 1 mul for the intersection;
add, sub, div, compare); the kernel reads each box (16 bytes) and its valid
flag once and writes its keep flag once.
"""
from __future__ import annotations

import torch

from portbench.metrics._peaks import bound_s

OPS_PER_PAIR = 13
BYTES_PER_BOX = 16 + 1 + 1


def overlap(boxes: torch.Tensor) -> torch.Tensor:
    """IoU of every pair of [N, 4] point-form boxes, [N, N]."""
    lo = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    hi = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    inter = (hi - lo).clamp(min=0).prod(-1)
    area = (boxes[:, 2:] - boxes[:, :2]).prod(-1)
    return inter / (area[:, None] + area[None, :] - inter)


def pairs_needed(boxes: torch.Tensor, valid: torch.Tensor, keep: torch.Tensor,
                 thresh: float, out_k: int | None = None) -> int:
    """boxes [N, 4] in score order, valid and keep [N] bool (keep: the
    greedy walk's mask) → the pair tests the walk needs."""
    n = valid.shape[-1]
    idx = torch.arange(n, device=valid.device)
    before = keep[:, None] & (idx[:, None] < idx[None, :])  # [j, i]: j kept, tested by i
    hits = (overlap(boxes) >= torch.tensor(thresh, dtype=torch.float32,
                                           device=valid.device)) & before
    through = torch.cumsum(before.int(), dim=0)  # [j, i]: tests of i among 0..j
    tests = torch.where(hits.any(dim=0), through.gather(0, hits.int().argmax(dim=0)[None])[0],
                        through[-1])
    if out_k is not None:
        valid = valid & (torch.cumsum(keep.long(), dim=0) - keep.long() < out_k)
    return int((tests * valid).sum())


def k1_bound_s(pairs: int, boxes: int) -> float:
    return bound_s(pairs * OPS_PER_PAIR, "float32", boxes * BYTES_PER_BOX)
