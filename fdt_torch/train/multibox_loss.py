"""SSD MultiBox loss with hard negative mining (counterpart of
fdt/train/multibox_loss.py), fixed-shape and on the device.

  * smooth-L1 (sum) over the positive priors' encoded offsets;
  * softmax CE with hard negatives at `negpos_ratio`:1 per image: the
    nonpositive CE ranked descending by two stable sorts, as fdt's two
    `jnp.argsort`s (stable), so tied CE values pick the same negatives;
    num_neg = clamp(ratio·num_pos, max=P-1);
  * normalised by the total positives N; an empty selection gives
    loss_c = 10 and N = 1; N == 0 gives N = batch size.  Under a
    torch.distributed process group N, the selection and the batch size are
    the global batch's, and each rank returns its part of the global loss.
    On the 2-D data x space mesh they are summed over the data group: every
    rank of a space group holds its data index's whole head outputs and
    returns the same part, and the data group holds each image once.

The loss math runs in float32; no gradient flows into the targets.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fdt_torch.dist import multihost
from fdt_torch.geometry.matching import match_default, match_ensure_max_prior


@dataclasses.dataclass(frozen=True)
class MultiBoxLossConfig:
    """The reference trainers' criterion parameters (fdt's MultiBoxLossConfig)."""
    num_classes: int = 2
    overlap_thresh: float = 0.35
    negpos_ratio: int = 3
    bipartite: bool = False
    variances: Tuple[float, float] = (0.1, 0.2)


def multibox_loss(loc_data: torch.Tensor, conf_data: torch.Tensor, priors: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                  cfg: MultiBoxLossConfig = MultiBoxLossConfig()):
    """loc_data [B, P, 4], conf_data [B, P, C], priors [P, 4] center form,
    gt_boxes [B, G, 4] padded point form (normalised), gt_labels [B, G],
    gt_valid [B, G] bool → (loss_l, loss_c) scalars."""
    match = match_ensure_max_prior if cfg.bipartite else match_default
    with torch.no_grad():
        loc_t, conf_t = match(cfg.overlap_thresh, gt_boxes, gt_labels, gt_valid,
                              priors, cfg.variances)
    return multibox_loss_from_targets(loc_data, conf_data, loc_t, conf_t,
                                      cfg.negpos_ratio)


def multibox_loss_from_targets(loc_data, conf_data, loc_t, conf_t, negpos_ratio: int = 3):
    """The loss tail for encoded targets (loc_t [B, P, 4], conf_t [B, P]
    integer class ids)."""
    b, p, _ = conf_data.shape
    loc_t = loc_t.detach()
    conf_t = conf_t.detach().long()
    pos = conf_t > 0                                           # [B, P]

    diff = torch.abs(loc_data - loc_t)
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    loss_l = torch.sum(sl1 * pos[..., None])

    lse = torch.logsumexp(conf_data, dim=-1)                   # [B, P]
    gathered = torch.gather(conf_data, -1, conf_t[..., None])[..., 0]
    ce = lse - gathered

    with torch.no_grad():
        ce_rank = torch.where(pos, torch.zeros_like(ce), ce)
        order = torch.sort(-ce_rank, dim=1, stable=True).indices
        rank = torch.sort(order, dim=1, stable=True).indices
        num_pos = pos.sum(dim=1, keepdim=True)                 # [B, 1]
        num_neg = torch.clamp(negpos_ratio * num_pos, max=p - 1)
        sel = pos | (rank < num_neg)
        # the global batch's positives, selection and size: this rank's own,
        # or, under a process group, summed over the ranks (fdt's step is one
        # graph over the global batch; each rank returns its part of the
        # global loss, and the parts sum to it)
        counts = multihost.sum_over_ranks(torch.stack([
            num_pos.sum().float(), sel.sum().float(),
            torch.full((), float(b), device=num_pos.device)]), group=multihost.data_group())
        n, has_sel, b = counts[0], counts[1] > 0, counts[2]
        n = torch.where(has_sel, n, torch.ones_like(n))
        n = torch.where(n == 0, b, n)
    loss_c = torch.sum(ce * sel)
    # one rank of each data group carries the constant
    empty = 10.0 if multihost.is_data_main() else 0.0
    loss_c = torch.where(has_sel, loss_c, torch.full_like(loss_c, empty))
    return loss_l / n, loss_c / n
