"""The IoU tracker's greedy association scan by a hand-written CUDA kernel.

K3, associate_chunk (fdt_torch/csrc/track_assoc.cu), replaces fdt's
_associate_chunk (fdt/track/device_tracker.py:93-194), a `lax.scan` over the
frames of a chunk with a `fori_loop` over the live slots that XLA compiles;
it is not a Pallas kernel.  One launch runs a whole chunk with no host read.
The kernel has two variants, which its C entry picks by size and reports:
the shared-memory one (`launches`) holds the slot state, a frame's
affinities and its detections in shared memory, for N <= 1024 and a state
that fits; the device-memory one (`global_launches`) takes every other
shape.  For CPU tensors the wrapper computes the plain version,
fdt_torch.geometry.track.associate_chunk_plain; for CUDA tensors it
launches one of the variants or raises.
"""
from __future__ import annotations

import ctypes

import torch

from fdt_torch.config import TrackerConfig
from fdt_torch.geometry.track import _Slots, associate_chunk_plain
from fdt_torch.utils.trace import Counter

launches = Counter()         # K3, the shared-memory variant
global_launches = Counter()  # K3, the device-memory variant

_INT_MAX = 2**31 - 1


def _check(slots: _Slots, boxes: torch.Tensor, scores: torch.Tensor,
           valid: torch.Tensor) -> None:
    """Shapes, dtypes and one device for every tensor; contiguity on the card."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [F, N, 4], got {tuple(boxes.shape)}")
    f, n, _ = boxes.shape
    t = slots.alive.shape[0] if slots.alive.dim() == 1 else 0
    if n < 1 or t < 1:
        raise ValueError(f"need N >= 1 detections and T >= 1 slots, got N={n}, T={t}")
    if f > _INT_MAX or 3 * t + n > _INT_MAX:  # C ints of the kernel (its scratch)
        raise ValueError(f"problem too large for the kernel: F={f}, N={n}, T={t}")
    want = {"boxes": (boxes, torch.float32, (f, n, 4)),
            "scores": (scores, torch.float32, (f, n)),
            "valid": (valid, torch.bool, (f, n)),
            "last_box": (slots.last_box, torch.float32, (t, 4)),
            "max_score": (slots.max_score, torch.float32, (t,)),
            "length": (slots.length, torch.int32, (t,)),
            "order": (slots.order, torch.int32, (t,)),
            "alive": (slots.alive, torch.bool, (t,)),
            "next_key": (slots.next_key, torch.int32, (1,))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != boxes.device:
            raise ValueError(f"{name} is on {x.device}, boxes on {boxes.device}")
        if boxes.device.type == "cuda" and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {boxes.device}")
    if boxes.device.type == "cuda" and (boxes.data_ptr() % 16 or slots.last_box.data_ptr() % 16):
        raise ValueError("boxes and last_box must be 16-byte aligned (read as float4)")


def associate_chunk(slots: _Slots, boxes: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, cfg: TrackerConfig):
    """The greedy association over a chunk of frames.

    Args:
      slots:  the pre-chunk slot state (not modified).
      boxes:  [F, N, 4] float32 detection boxes, pixels.
      scores: [F, N] float32.
      valid:  [F, N] bool.
      cfg:    the thresholds (use_iou, sigma_iou, sigma_dis, sigma_h, t_min).

    Returns: (new slots, assign [F, T] int32, finish [F, T] bool,
      spawn [F, N] int32, overflow [F] int32), as
      associate_chunk_plain.  On the card one launch, no host read.
    """
    _check(slots, boxes, scores, valid)
    if boxes.device.type == "cpu":
        return associate_chunk_plain(slots, boxes, scores, valid, cfg)
    from fdt_torch.ops._build import library

    f, n, _ = boxes.shape
    t = slots.alive.shape[0]
    new = _Slots(last_box=torch.empty_like(slots.last_box),
                 max_score=torch.empty_like(slots.max_score),
                 length=torch.empty_like(slots.length),
                 order=torch.empty_like(slots.order),
                 alive=torch.empty_like(slots.alive),
                 next_key=torch.empty_like(slots.next_key))
    dev = boxes.device
    assign = torch.empty((f, t), dtype=torch.int32, device=dev)
    finish = torch.empty((f, t), dtype=torch.bool, device=dev)
    spawn = torch.empty((f, n), dtype=torch.int32, device=dev)
    overflow = torch.empty((f,), dtype=torch.int32, device=dev)
    # the device-memory variant's live, keys, visit and consumed lists
    scratch = torch.empty((3 * t + n,), dtype=torch.int32, device=dev)
    ptrs = [x.data_ptr() for x in (
        slots.last_box, slots.max_score, slots.length, slots.order, slots.alive,
        slots.next_key, boxes, scores, valid, new.last_box, new.max_score, new.length,
        new.order, new.alive, new.next_key, assign, finish, spawn, overflow, scratch)]
    rows = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().fdt_track_associate(
            *ptrs, t, f, n, float(cfg.sigma_iou), float(cfg.sigma_dis), float(cfg.sigma_h),
            int(cfg.t_min), int(bool(cfg.use_iou)), stream, ctypes.byref(rows))
    if err != 0:
        raise RuntimeError(f"fdt_track_associate launch failed: CUDA error {err}")
    (launches if rows.value else global_launches).count += 1
    return new, assign, finish, spawn, overflow
