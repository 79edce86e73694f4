"""Greedy-NMS keep masks by hand-written CUDA kernels.

K1, nms_keep_tiled (fdt_torch/csrc/nms_tiled.cu), replaces the TPU kernel
fdt/ops/pallas_nms.py::_nms_kernel_tiled, reached through
pallas_nms_keep_tiled (fdt/ops/pallas_nms.py:189-235).  K2, nms_keep_greedy
(fdt_torch/csrc/nms_greedy.cu), replaces fdt/ops/pallas_nms.py::_nms_kernel,
reached through pallas_nms_keep (:238-270).  One launch solves every problem
of a batch: on the detectors' paths, the B images × classes of a call.  For a
CPU tensor a wrapper computes the plain version,
fdt_torch.geometry.nms.nms_keep_mask; for a CUDA tensor it launches its
kernel or raises.
"""
from __future__ import annotations

import functools
import math

import torch

from fdt_torch.geometry.nms import nms_keep_mask
from fdt_torch.utils.trace import Counter

_MODES = {"union": 0, "minimum": 1}
_MAX_WORDS = 65535  # K1: words of 64 boxes; keeps the mask launch's grid.y in range
# K2 takes problems of at most 8192 boxes: the limit of the Pallas kernel's
# VMEM that it replaces (fdt/ops/pallas_nms.py:4-5), kept as the wrapper's
# contract; a block of its cluster then stages at most 28 KB
_GREEDY_MAX_BOXES = 8192


launches = Counter()         # K1
greedy_launches = Counter()  # K2


def _check(boxes: torch.Tensor, valid: torch.Tensor, mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"unknown NMS mode: {mode}")
    if boxes.dim() < 2 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [..., N, 4], got {tuple(boxes.shape)}")
    if valid.shape != boxes.shape[:-1] or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool {tuple(boxes.shape[:-1])}, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {boxes.device}")


def _check_card(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    """What a kernel takes besides _check's shapes."""
    if boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be float32, got {boxes.dtype}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    if valid.device != boxes.device:
        raise ValueError("boxes and valid must be on one device")


def nms_keep_tiled(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                   mode: str = "union", seg_id: torch.Tensor | None = None,
                   out_k: int | None = None) -> torch.Tensor:
    """Greedy-NMS keep mask over boxes sorted by descending score.

    Args:
      boxes:  [P, N, 4] (or [..., N, 4]) float32 point-form boxes.
      valid:  [P, N] bool.
      iou_thresh: overlap >= iou_thresh suppresses.
      mode:   "union" | "minimum".
      seg_id: optional [P, N] int segment ids; suppression acts only within
        equal ids.  Not combinable with out_k.
      out_k:  when set, only the first out_k keeps of each problem are
        guaranteed (the kernel stops there; later entries read False) —
        exact for consumers that take the first out_k keeps (nms_padded).

    Returns: [P, N] bool keep mask.
    """
    _check(boxes, valid, mode)
    if seg_id is not None and out_k is not None:
        raise ValueError("out_k early exit is global; incompatible with seg_id")
    if seg_id is not None and seg_id.shape != valid.shape:
        raise ValueError(f"seg_id must be {tuple(valid.shape)}, got "
                         f"{tuple(seg_id.shape)}")
    if boxes.device.type == "cpu":
        return nms_keep_mask(boxes, valid, iou_thresh, mode=mode, seg_id=seg_id)
    return _launch_tiled(boxes, valid, iou_thresh, mode, seg_id, out_k)


@functools.lru_cache(maxsize=64)
def _scratch_words(n: int) -> int:
    """int64 words of K1's scratch for one problem of n boxes."""
    from fdt_torch.ops._build import library

    return library().fdt_nms_tiled_scratch_words(n)


def _launch_tiled(boxes, valid, iou_thresh, mode, seg_id, out_k):
    from fdt_torch.ops._build import library

    _check_card(boxes, valid)
    n = boxes.shape[-2]
    p = math.prod(boxes.shape[:-2])
    words = (n + 63) // 64
    if words > _MAX_WORDS or p > 65535:  # grid.y and grid.z of the mask launch
        raise ValueError(f"problem too large for the kernel: P={p}, N={n}")
    seg_ptr = None
    if seg_id is not None:
        if (seg_id.dtype != torch.int32 or not seg_id.is_contiguous()
                or seg_id.device != boxes.device):
            raise ValueError("seg_id must be a contiguous int32 tensor on the "
                             "device of boxes")
        seg_ptr = seg_id.data_ptr()
    keep = torch.empty(valid.shape, dtype=torch.uint8, device=boxes.device)
    scratch = torch.empty((p, _scratch_words(n)), dtype=torch.int64, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = library().fdt_nms_tiled(
            boxes.data_ptr(), valid.data_ptr(), seg_ptr, scratch.data_ptr(),
            keep.data_ptr(), p, n, float(iou_thresh), _MODES[mode],
            0 if out_k is None else int(out_k), stream)
    if err != 0:
        raise RuntimeError(f"fdt_nms_tiled launch failed: CUDA error {err}")
    launches.count += 1
    return keep.view(torch.bool)


def nms_keep_greedy(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                    mode: str = "union") -> torch.Tensor:
    """Greedy-NMS keep mask over boxes sorted by descending score, by the
    literal one-box-at-a-time loop (K2).  The same function as
    nms_keep_tiled without seg_id and out_k.  On the card one launch solves
    every problem, each on a cluster of 8 blocks.

    Args:
      boxes:  [P, N, 4] (or [..., N, 4]) float32 point-form boxes; N ≤ 8192
        on the card (the wrapper's contract, as in fdt).
      valid:  [P, N] bool.
      iou_thresh: overlap >= iou_thresh suppresses.
      mode:   "union" | "minimum".

    Returns: [P, N] bool keep mask.
    """
    _check(boxes, valid, mode)
    if boxes.device.type == "cpu":
        return nms_keep_mask(boxes, valid, iou_thresh, mode=mode)
    from fdt_torch.ops._build import library

    _check_card(boxes, valid)
    n = boxes.shape[-2]
    p = math.prod(boxes.shape[:-2])
    if n > _GREEDY_MAX_BOXES or p > 2**31 - 1:  # the contract; a C int
        raise ValueError(f"problem too large for the kernel: P={p}, N={n} "
                         f"(N ≤ {_GREEDY_MAX_BOXES})")
    keep = torch.empty(valid.shape, dtype=torch.uint8, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = library().fdt_nms_greedy(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), p, n,
            float(iou_thresh), _MODES[mode], stream)
    if err != 0:
        raise RuntimeError(f"fdt_nms_greedy launch failed: CUDA error {err}")
    greedy_launches.count += 1
    return keep.view(torch.bool)
