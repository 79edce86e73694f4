"""End-to-end PyramidBox inference for every variant (counterpart of
fdt/infer/pyramidbox.py:56-191).

uint8 BGR batch → mean subtraction → forward → softmax → decode → per-class
top-5000 (nms_top_k) → greedy NMS (kernel K1 on the card) → [B, 2, top_k, 5], then a
host row walk that reproduces the reference's `while score >= threshold`
semantics, including the [[0, 0, 0, 0, 0.4]] sentinel.

Two compute types: float32 (for parity) and bfloat16 with channels_last, the
bench mode.  `precision` is fdt's: "highest" (the default) turns TF32 off for
the forward, as fdt's precision="highest" keeps full float32; "default"
allows it.  Priors are cached per (width, height), from the source shapes of the
first forward at that size (exact for try4/try5 too, whose maps break the
ceil-halving rule; fdt takes them from an abstract trace).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from fdt_torch.anchors import pyramid_face_priors
from fdt_torch.config import PIXEL_MEAN_BGR, PYRAMID_CONFIGS, PyramidConfig
from fdt_torch.infer.detect import ssd_detect


def detections_to_rows(det: np.ndarray, threshold: float, scale) -> np.ndarray:
    """Walk a [C, top_k, 5] detection tensor like the reference's My_test.py.

    For every class (including background class 0, whose rows are zeros) take
    the PREFIX of rows with score >= threshold, scale boxes to pixels, and
    stack [x1, y1, x2, y2, score] rows.  Returns the
    [[0, 0, 0, 0, 0.4]] sentinel when nothing qualifies.
    """
    rows = []
    scale = np.asarray(scale, np.float32)
    for cl in range(det.shape[0]):
        s = det[cl, :, 0]
        take = int(np.cumprod(s >= threshold).sum())
        if take:
            rows.append(np.column_stack([det[cl, :take, 1:5] * scale,
                                         s[:take]]))
    if not rows:
        return np.array([[0, 0, 0, 0, 0.4]], np.float32)
    return np.concatenate(rows, axis=0)


# fdt's precision values → whether the forward may use TF32 on the card
PRECISIONS = {"highest": False, "default": True}


def _check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{tuple(PRECISIONS)}")
    return precision


@contextlib.contextmanager
def tf32_for(precision: str):
    """TF32 for cuDNN convolutions and matmuls as `precision` says, for the
    body only: the global torch.backends flags are restored after."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    allowed = PRECISIONS[precision]
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _resolve_device(device) -> torch.device:
    """`None` means the CUDA card; raise if there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


class PyramidBoxDetector:
    """PyramidBox detector of any variant on one device.

    Args:
      model: the variant's model (fdt_torch.models.build_pyramidbox) with its
        weights loaded (moved to `device`).
      cfg: a PyramidConfig or its name ("repo", "try1" … "try5"): the priors,
        the default thresholds and the NMS budget (detect.nms_top_k).
      dtype: torch.float32, or torch.bfloat16 (computed channels_last).
      device: None → "cuda" (raises if absent); "cpu" for the CPU.
      precision: "highest" (TF32 off for the forward) or "default" (TF32
        allowed), as fdt's detector.

    `source_shapes[(width, height)]` holds the (f_width, f_height) of every
    source map, recorded at the first forward at that size.
    """

    def __init__(self, model, cfg: PyramidConfig | str = "repo",
                 dtype: torch.dtype = torch.float32, device=None,
                 precision: str = "highest"):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.precision = _check_precision(precision)
        self.cfg = PYRAMID_CONFIGS[cfg] if isinstance(cfg, str) else cfg
        self.dtype = dtype
        self.device = _resolve_device(device)
        self.memory_format = (torch.channels_last if dtype == torch.bfloat16
                              else torch.contiguous_format)
        self.model = model.eval().to(self.device, dtype=dtype,
                                     memory_format=self.memory_format)
        self._mean = torch.tensor(PIXEL_MEAN_BGR, dtype=torch.float32,
                                  device=self.device)
        self._priors: dict[tuple[int, int], torch.Tensor] = {}
        self.source_shapes: dict[tuple[int, int], tuple] = {}

    def _priors_for(self, width: int, height: int, source_shapes) -> torch.Tensor:
        priors = self._priors.get((width, height))
        if priors is None:
            if len(source_shapes) != len(self.cfg.face_priors.strides):
                raise ValueError(f"the model has {len(source_shapes)} source maps; "
                                 f"config {self.cfg.name!r} has priors for "
                                 f"{len(self.cfg.face_priors.strides)}")
            self.source_shapes[(width, height)] = tuple(source_shapes)
            priors = self._priors[(width, height)] = torch.from_numpy(
                pyramid_face_priors(self.cfg, source_shapes, width, height)
            ).to(self.device)
        return priors

    @torch.inference_mode()
    def detect_device(self, images_u8: torch.Tensor, conf_thresh: float | None = None,
                      nms_thresh: float | None = None) -> torch.Tensor:
        """[B,H,W,3] uint8 BGR tensor → [B, 2, top_k, 5] float32 tensor on
        the detector's device (no host synchronisation)."""
        if images_u8.dim() != 4 or images_u8.shape[-1] != 3 or images_u8.dtype != torch.uint8:
            raise ValueError(f"expected [B,H,W,3] uint8, got {images_u8.dtype} "
                             f"{tuple(images_u8.shape)}")
        b, h, w, _ = images_u8.shape
        dcfg = dataclasses.replace(
            self.cfg.detect,
            conf_thresh=self.cfg.detect.conf_thresh if conf_thresh is None else conf_thresh,
            nms_thresh=self.cfg.detect.nms_thresh if nms_thresh is None else nms_thresh)
        x = images_u8.to(self.device, non_blocking=True).float() - self._mean
        x = x.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=self.memory_format)
        with tf32_for(self.precision):
            out = self.model(x)
        priors = self._priors_for(w, h, out["source_shapes"])
        conf = F.softmax(out["face_conf"], dim=-1)
        return ssd_detect(out["face_loc"], conf, priors, dcfg)

    def detect_tensor(self, images_u8, conf_thresh: float | None = None,
                      nms_thresh: float | None = None) -> np.ndarray:
        """[B,H,W,3] uint8 BGR (numpy or tensor) → [B, 2, top_k, 5] numpy."""
        if not torch.is_tensor(images_u8):
            images_u8 = torch.from_numpy(np.ascontiguousarray(images_u8))
        return self.detect_device(images_u8, conf_thresh, nms_thresh).cpu().numpy()
