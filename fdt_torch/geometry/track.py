"""The IoU tracker's slot state and its greedy association in plain PyTorch
(counterpart of fdt/track/device_tracker.py:42-194).

The association of a frame is sequential by nature: tracks are visited in
creation order, and each match consumes a detection that a later track may
not take.  fdt runs it on the device as one `lax.scan` over the frames of a
chunk with a `fori_loop` over the live slots, and emits one small record a
frame:

    assign [T]  detection matched to each slot (-1 none)
    finish [T]  slot finished this frame (it joins the finished list)
    spawn  [N]  slot spawned for each unmatched detection (-1 none)

`associate_chunk_plain` is that scan in plain PyTorch: the CPU path and the
oracle of kernel K3 (fdt_torch.ops.track.associate_chunk), which runs it on
the card in one launch.  Slot visits follow creation order, which is the host
tracker's list order (matched tracks keep their relative order, new tracks
append); consumption takes a masked argmax over the original detection
indices, which picks the element the host's shrinking-list argmax picks.
"""
from __future__ import annotations

import dataclasses

import torch

from fdt_torch.config import TrackerConfig

# Dead-slot sentinel of the int32 creation counter: larger than any live key
# (a float counter would lose integer precision past 2^24 spawned tracks)
_DEAD_ORDER = 2**31 - 1


@dataclasses.dataclass
class _Slots:
    """Slot state, tensors of extent [T] on one device."""
    last_box: torch.Tensor   # [T, 4] float32
    max_score: torch.Tensor  # [T] float32
    length: torch.Tensor     # [T] int32
    order: torch.Tensor      # [T] int32 creation counter (_DEAD_ORDER = dead)
    alive: torch.Tensor      # [T] bool
    next_key: torch.Tensor   # [1] int32 global creation counter


def init_slots(t_max: int, device) -> _Slots:
    return _Slots(last_box=torch.zeros((t_max, 4), dtype=torch.float32, device=device),
                  max_score=torch.zeros((t_max,), dtype=torch.float32, device=device),
                  length=torch.zeros((t_max,), dtype=torch.int32, device=device),
                  order=torch.full((t_max,), _DEAD_ORDER, dtype=torch.int32, device=device),
                  alive=torch.zeros((t_max,), dtype=torch.bool, device=device),
                  next_key=torch.zeros((1,), dtype=torch.int32, device=device))


def _iou_row(boxes: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """IoU of [N,4] boxes vs one box (fdt's _iou_to_last semantics)."""
    lt = torch.maximum(boxes[:, :2], ref[:2])
    rb = torch.minimum(boxes[:, 2:], ref[2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[:, 0] * wh[:, 1]
    a = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    b = (ref[2] - ref[0]) * (ref[3] - ref[1])
    return inter / (a + b - inter)


def _distance_row(boxes: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Center+size pseudo-distance (calculate_distance, calc_performance.py:34-51)."""
    d_xy = (ref[2:] + ref[:2]) / 2 - (boxes[:, 2:] + boxes[:, :2]) / 2
    d_sz = (boxes[:, 2:] - boxes[:, :2]) - (ref[2:] - ref[:2])
    d_z = (d_sz[:, 0] + d_sz[:, 1]) / 2
    dis = d_z * d_z + d_xy[:, 0] * d_xy[:, 0] + d_xy[:, 1] * d_xy[:, 1]
    return torch.pow(dis, 0.25)


def associate_chunk_plain(slots: _Slots, boxes: torch.Tensor, scores: torch.Tensor,
                          valid: torch.Tensor, cfg: TrackerConfig):
    """The greedy association over a chunk of frames (fdt's _associate_chunk,
    fdt/track/device_tracker.py:93-194), in plain PyTorch.

    boxes [F,N,4] float32, scores [F,N] float32, valid [F,N] bool →
    (new slots, assign [F,T] int32, finish [F,T] bool, spawn [F,N] int32,
    overflow [F] int32).  `slots` is not modified: an overflow redo restarts
    from it.  The walk over a frame's live slots reads their count and
    order on the host.
    """
    t_max = slots.alive.shape[0]
    f, n = valid.shape
    dev = boxes.device
    last_box, max_score = slots.last_box.clone(), slots.max_score.clone()
    length, order = slots.length.clone(), slots.order.clone()
    alive, next_key = slots.alive.clone(), slots.next_key.clone()
    assign = torch.full((f, t_max), -1, dtype=torch.int32, device=dev)
    finish = torch.zeros((f, t_max), dtype=torch.bool, device=dev)
    spawn = torch.empty((f, n), dtype=torch.int32, device=dev)
    overflow = torch.empty((f,), dtype=torch.int32, device=dev)
    det_ids = torch.arange(n, dtype=torch.int64, device=dev)
    dead = torch.tensor(_DEAD_ORDER, dtype=torch.int32, device=dev)
    for fi in range(f):
        b, sc, v = boxes[fi], scores[fi], valid[fi]
        visit = torch.argsort(torch.where(alive, order, dead), stable=True)
        consumed = ~v
        # the trip count is the live slots: they sort first, and the body is
        # an exact no-op for a dead slot
        for s in visit[:int(alive.sum())].tolist():
            rem = v & ~consumed
            any_rem = rem.any()
            if cfg.use_iou:
                aff = torch.where(rem, _iou_row(b, last_box[s]), -torch.inf)
                best = torch.argmax(aff)
                hit = aff[best] > cfg.sigma_iou
            else:
                aff = torch.where(rem, _distance_row(b, last_box[s]), torch.inf)
                best = torch.argmin(aff)
                hit = aff[best] < cfg.sigma_dis
            matched = alive[s] & any_rem & hit
            # matched: extend the track, consume the detection
            last_box[s] = torch.where(matched, b[best], last_box[s])
            max_score[s] = torch.where(matched, torch.maximum(max_score[s], sc[best]),
                                       max_score[s])
            length[s] = length[s] + matched.to(torch.int32)
            consumed[best] = consumed[best] | matched
            assign[fi, s] = torch.where(matched, best.to(torch.int32), assign[fi, s])
            # unmatched with detections remaining: finish or discard
            # (any_rem False is the reference's silent drop)
            dies = alive[s] & ~matched
            finish[fi, s] = (dies & any_rem & (max_score[s] > cfg.sigma_h)
                             & (length[s] > cfg.t_min))
            alive[s] = alive[s] & matched

        # spawn new tracks from unconsumed detections, in detection order,
        # into free slots lowest id first (slots freed above included)
        free = ~alive
        free_slots = torch.argsort(alive.to(torch.uint8), stable=True)
        n_free = free.sum()
        new = v & ~consumed
        rank = torch.cumsum(new, 0, dtype=torch.int32) - 1
        can = new & (rank < n_free)
        slot_of = torch.where(can, free_slots[rank.clamp(0, t_max - 1)].to(torch.int32), -1)
        overflow[fi] = (new & ~can).sum()
        # non-spawning entries go to a dump row past t_max: a -1 must never
        # alias a real slot (duplicate scatter indices have no write order)
        safe_slot = torch.where(can, slot_of, t_max).long()
        spawn_mask = torch.zeros(t_max + 1, dtype=torch.bool, device=dev)
        spawn_mask[safe_slot] = True
        spawn_mask = spawn_mask[:t_max]
        det_of_slot = torch.zeros(t_max + 1, dtype=torch.int64, device=dev)
        det_of_slot[safe_slot] = det_ids
        det_of_slot = det_of_slot[:t_max]
        last_box = torch.where(spawn_mask[:, None], b[det_of_slot], last_box)
        max_score = torch.where(spawn_mask, sc[det_of_slot], max_score)
        length = torch.where(spawn_mask, 1, length)
        order = torch.where(spawn_mask, next_key + rank[det_of_slot],
                            torch.where(alive, order, dead))
        alive = alive | spawn_mask
        next_key = next_key + can.sum(dtype=torch.int32)
        spawn[fi] = slot_of
    new_slots = _Slots(last_box=last_box, max_score=max_score, length=length, order=order,
                       alive=alive, next_key=next_key)
    return new_slots, assign, finish, spawn, overflow
