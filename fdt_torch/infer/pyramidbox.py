"""End-to-end PyramidBox inference for every variant (counterpart of
fdt/infer/pyramidbox.py:56-191).

uint8 BGR batch → mean subtraction → forward → softmax → decode → per-class
top-5000 (nms_top_k) → greedy NMS (kernel K1 on the card) → [B, 2, top_k, 5], then a
host row walk that reproduces the reference's `while score >= threshold`
semantics, including the [[0, 0, 0, 0, 0.4]] sentinel.

Two compute types: float32 (for parity) and bfloat16 with channels_last, the
bench mode; `quant="int8"` runs every conv of reduction 32 or more in int8
(fdt_torch/ops/quant.py: kernels K5 and K4 on the card).  `precision` is fdt's: "highest" (the default) turns TF32 off for
the forward, as fdt's precision="highest" keeps full float32; "default"
allows it.  Priors are cached per (width, height), from the source shapes of the
first forward at that size (exact for try4/try5 too, whose maps break the
ceil-halving rule; fdt takes them from an abstract trace), in an LRU of 64
sizes as fdt bounds its per-shape executables: native-resolution eval sees
hundreds of sizes.

`mesh=` (fdt_torch.dist.Mesh) is fdt's data-parallel inference: the model is
replicated to each device of the mesh once, and each batch is padded by
repeating its last row to a mesh multiple, split, run shard by shard without
waiting for a card, gathered on the mesh's first device and cut back.
Images are independent, so the answers are the unsharded detector's, up to
the convolution algorithms a card picks for another batch size.

On a CUDA device without a mesh or int8, detect_tensor replays a CUDA graph
of the device chain (fdt_torch.infer.graphs): everything from the uint8
batch on the card to the [B, 2, top_k, 5] output (mean, permute, cast,
channels-last, the forward, softmax, ssd_detect with K1), captured on a
batch shape's second call at its thresholds, replayed from its third; a
first call runs eagerly (`_detect_on`).  The CPU, a mesh, int8 and
detect_device called directly (whose callers keep the device tensor past
the next call) always run eagerly.

Spans (fdt_torch.utils.trace, recorded only while recording is on): `detect`
around a whole call, its count the batch size (detect_tensor, or
detect_device when called directly); under it `detect.upload` (the pageable
copy to the device, mean, permute, cast, channels-last; on a replay the
copy into the graph's input alone), `model.forward` (the host's enqueue of
the network; on a replay the graph's launch, the whole chain's enqueue),
`detect.head` (priors, softmax, ssd_detect with K1's launch; nothing in it
waits for the card; not opened on a replay, whose graph holds that work) and
`detect.readback` (the wait for the card, the copy back, `.numpy()`).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from fdt_torch.anchors import pyramid_face_priors
from fdt_torch.config import DetectConfig, PIXEL_MEAN_BGR, PYRAMID_CONFIGS, PyramidConfig
from fdt_torch.dist.mesh import replicated, run_sharded
from fdt_torch.infer import graphs
from fdt_torch.infer.detect import ssd_detect
from fdt_torch.ops.quant import check_mode, int8_convs
from fdt_torch.utils import trace


def detections_to_rows(det: np.ndarray, threshold: float, scale,
                       shrink: float = 1.0) -> np.ndarray:
    """Walk a [C, top_k, 5] detection tensor like the reference's My_test.py.

    For every class (including background class 0, whose rows are zeros) take
    the PREFIX of rows with score >= threshold, scale boxes to pixels, divide
    by `shrink`, and stack [x1, y1, x2, y2, score] rows.  Returns the
    [[0, 0, 0, 0, 0.4]] sentinel when nothing qualifies.
    """
    rows = []
    scale = np.asarray(scale, np.float32)
    for cl in range(det.shape[0]):
        s = det[cl, :, 0]
        take = int(np.cumprod(s >= threshold).sum())
        if take:
            rows.append(np.column_stack([det[cl, :take, 1:5] * scale / shrink,
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


def place_model(model, device: torch.device, dtype: torch.dtype, memory_format,
                quant: str | None = None):
    """`model` in eval mode on `device`, in `dtype` and `memory_format`.

    quant=None moves the model passed in, in place.  quant="int8" moves a
    copy whose convs int8_convs swapped (fdt_torch.ops.quant), quantized from
    the copy's float32 weights before the cast, as fdt quantizes its float32
    params whatever the compute dtype; the model passed in, and a float
    detector holding it, are unchanged.  Raises ValueError if the model's
    weights are no longer float32 (a bf16 detector cast it in place).
    """
    if check_mode(quant) is None:
        return model.eval().to(device, dtype=dtype, memory_format=memory_format)
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise ValueError("quant='int8' quantizes float32 weights; this model was cast "
                         "(build the int8 detector first, or from a fresh model)")
    qmodel = int8_convs(copy.deepcopy(model)).eval()
    return qmodel.to(device, dtype=dtype, memory_format=memory_format)


def _resolve_device(device, mesh=None) -> torch.device:
    """`None` means the CUDA card, or the first device of `mesh`; raise if
    there is no card, or if `device` is not the mesh's first."""
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.devices[0]:
            raise ValueError(f"device {device} is not the mesh's first device "
                             f"{mesh.devices[0]}")
        device = mesh.devices[0]
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
      cfg: a PyramidConfig or its name ("repo", "try1" … "try5"): the priors
        and, unless `detect_cfg` is given, the detect head's settings.
      detect_cfg: a DetectConfig for the detect head (top_k, default
        thresholds, variance); defaults to cfg.detect.
      budget: boxes of each class entering NMS (fdt's default, 5000).
      dtype: torch.float32, or torch.bfloat16 (computed channels_last).
      device: None → "cuda" (raises if absent); "cpu" for the CPU.
      precision: "highest" (TF32 off for the forward) or "default" (TF32
        allowed), as fdt's detector.
      quant: None, or "int8" for fdt's post-training int8 inference
        (place_model; the model passed in is not changed).
      mesh: an fdt_torch.dist.Mesh for data-parallel batches (the module's
        docstring); `device` is then its first device.

    `source_shapes[(width, height)]` holds the (f_width, f_height) of every
    source map, recorded at the first forward at that size, for the sizes the
    LRU of `_priors_max` sizes still holds.
    """

    def __init__(self, model, cfg: PyramidConfig | str = "repo",
                 detect_cfg: DetectConfig | None = None, budget: int = 5000,
                 dtype: torch.dtype = torch.float32, device=None,
                 precision: str = "highest", quant: str | None = None, mesh=None):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.precision = _check_precision(precision)
        self.quant = check_mode(quant)
        self.cfg = PYRAMID_CONFIGS[cfg] if isinstance(cfg, str) else cfg
        self.detect_cfg = detect_cfg or self.cfg.detect
        self.budget = budget
        self.dtype = dtype
        self.mesh = mesh
        self.device = _resolve_device(device, mesh)
        self.memory_format = (torch.channels_last if dtype == torch.bfloat16
                              else torch.contiguous_format)
        self.model = place_model(model, self.device, dtype, self.memory_format, quant)
        # the model on each device that runs a shard (only self.model without a mesh)
        self._models = replicated(mesh, self.model) if mesh else {self.device: self.model}
        self._means = {d: torch.tensor(PIXEL_MEAN_BGR, dtype=torch.float32, device=d)
                       for d in self._models}
        # (width, height) → (source shapes, {device: priors}), least
        # recently used first
        self._priors: OrderedDict = OrderedDict()
        self._priors_max = 64
        self._graphs = graphs.GraphCache(self.device)

    @property
    def source_shapes(self) -> dict[tuple[int, int], tuple]:
        return {size: shapes for size, (shapes, _) in self._priors.items()}

    def _priors_for(self, width: int, height: int, source_shapes, device) -> torch.Tensor:
        key = (width, height)
        entry = self._priors.get(key)
        if entry is None:
            if len(source_shapes) != len(self.cfg.face_priors.strides):
                raise ValueError(f"the model has {len(source_shapes)} source maps; "
                                 f"config {self.cfg.name!r} has priors for "
                                 f"{len(self.cfg.face_priors.strides)}")
            entry = self._priors[key] = (tuple(source_shapes), {})
        self._use_priors(key)
        on = entry[1]
        if device not in on:
            on[device] = torch.from_numpy(
                pyramid_face_priors(self.cfg, entry[0], width, height)).to(device)
        return on[device]

    def _use_priors(self, key: tuple[int, int]) -> None:
        """`key` (width, height) becomes the priors LRU's most recent size
        (a graph replay's size too, whose graph holds its own priors), and the
        LRU is cut to its bound."""
        if key in self._priors:
            self._priors.move_to_end(key)
        while len(self._priors) > self._priors_max:  # also after the bound is lowered
            self._priors.popitem(last=False)

    def _dcfg(self, images_u8: torch.Tensor, conf_thresh, nms_thresh) -> DetectConfig:
        """The call's detect settings, once its batch is checked."""
        if images_u8.dim() != 4 or images_u8.shape[-1] != 3 or images_u8.dtype != torch.uint8:
            raise ValueError(f"expected [B,H,W,3] uint8, got {images_u8.dtype} "
                             f"{tuple(images_u8.shape)}")
        return dataclasses.replace(
            self.detect_cfg,
            conf_thresh=self.detect_cfg.conf_thresh if conf_thresh is None else conf_thresh,
            nms_thresh=self.detect_cfg.nms_thresh if nms_thresh is None else nms_thresh)

    @torch.inference_mode()
    def detect_device(self, images_u8: torch.Tensor, conf_thresh: float | None = None,
                      nms_thresh: float | None = None) -> torch.Tensor:
        """[B,H,W,3] uint8 BGR tensor → [B, 2, top_k, 5] float32 tensor on
        the detector's device (no host synchronisation; with a mesh, shard
        by shard, gathered there).  Always eager: the tensor is the
        caller's to keep."""
        dcfg = self._dcfg(images_u8, conf_thresh, nms_thresh)
        with trace.span_once("detect", len(images_u8)):
            if self.mesh is None:
                return self._detect_on(self.device, images_u8, dcfg)
            return run_sharded(self.mesh, lambda d, x: self._detect_on(d, x, dcfg),
                               images_u8, self.device)

    def _model_input(self, images_u8: torch.Tensor, device) -> torch.Tensor:
        """A uint8 BGR batch on `device` → the model's input there."""
        x = images_u8.float() - self._means[device]
        return x.permute(0, 3, 1, 2).to(self.dtype).contiguous(memory_format=self.memory_format)

    def _head(self, out: dict, priors: torch.Tensor, dcfg) -> torch.Tensor:
        conf = F.softmax(out["face_conf"], dim=-1)
        return ssd_detect(out["face_loc"], conf, priors, dcfg, budget=self.budget)

    def _detect_on(self, device, images_u8: torch.Tensor, dcfg) -> torch.Tensor:
        _, h, w, _ = images_u8.shape
        with trace.span("detect.upload"):
            x = self._model_input(images_u8.to(device, non_blocking=True), device)
        with tf32_for(self.precision), trace.span("model.forward"):
            out = self._models[device](x)
        with trace.span("detect.head"):
            return self._head(out, self._priors_for(w, h, out["source_shapes"], device), dcfg)

    def _graph_chain(self, static_in: torch.Tensor, dcfg) -> tuple:
        """The device chain a graph holds, from the uint8 batch on the card
        to the [B, 2, top_k, 5] output, and the tensors it reads besides the
        model and its input."""
        _, h, w, _ = static_in.shape
        x = self._model_input(static_in, self.device)
        with tf32_for(self.precision):
            out = self.model(x)
        priors = self._priors_for(w, h, out["source_shapes"], self.device)
        return self._head(out, priors, dcfg), (priors, self._means[self.device])

    def detect_tensor(self, images_u8, conf_thresh: float | None = None,
                      nms_thresh: float | None = None) -> np.ndarray:
        """[B,H,W,3] uint8 BGR (numpy or tensor) → [B, 2, top_k, 5] numpy;
        through a CUDA graph of the batch's shape where one applies (the
        module's docstring)."""
        with trace.span("detect", len(images_u8)):
            if not torch.is_tensor(images_u8):
                images_u8 = torch.from_numpy(np.ascontiguousarray(images_u8))
            if self.device.type in graphs.DEVICE_TYPES and self.mesh is None and self.quant is None:
                return self._detect_graphed(images_u8, conf_thresh, nms_thresh)
            det = self.detect_device(images_u8, conf_thresh, nms_thresh)
            with trace.span("detect.readback"):
                return det.cpu().numpy()

    @torch.inference_mode()
    def _detect_graphed(self, images_u8: torch.Tensor, conf_thresh, nms_thresh) -> np.ndarray:
        dcfg = self._dcfg(images_u8, conf_thresh, nms_thresh)
        self._use_priors((images_u8.shape[2], images_u8.shape[1]))
        return self._graphs.detect((tuple(images_u8.shape), dcfg, self.budget), images_u8,
                                   self.model, lambda x: self._graph_chain(x, dcfg),
                                   lambda x: self._detect_on(self.device, x, dcfg))

    def detect_face(self, image_bgr: np.ndarray, threshold: float,
                    shrink: float = 1.0, nms_thresh: float = 0.35) -> np.ndarray:
        """Single-image eval-protocol detection (My_test.py's detect_face).

        With shrink != 1 the image is first resized as cv2.resize(fx=shrink,
        fy=shrink) resizes it (`shrink_image`).  Returns [N, 5] rows
        [x1, y1, x2, y2, score] in the pixels of the image before the shrink.
        """
        if shrink != 1.0:
            image_bgr = shrink_image(image_bgr, shrink)
        h, w, _ = image_bgr.shape
        det = self.detect_tensor(image_bgr[None], conf_thresh=threshold,
                                 nms_thresh=nms_thresh)[0]
        return detections_to_rows(det, threshold, [w, h, w, h], shrink)


def shrink_image(image_bgr: np.ndarray, fx: float) -> np.ndarray:
    """cv2.resize(image, None, fx=fx, fy=fx, interpolation=INTER_LINEAR) of an
    [H, W, 3] uint8 image, within 1 LSB: the destination is rint(H·fx) ×
    rint(W·fx), and a destination pixel u samples source (u + 0.5)/fx − 0.5,
    cv2's mapping by the factor and not by the ratio of the sizes."""
    from fdt_torch.infer.mtcnn_device import _resize_level
    h, w = image_bgr.shape[:2]
    x = torch.from_numpy(np.ascontiguousarray(image_bgr)).permute(2, 0, 1)[None].float()
    y = _resize_level(x, int(np.rint(h * fx)), int(np.rint(w * fx)), fx)
    return y[0].permute(1, 2, 0).clamp(0, 255).to(torch.uint8).numpy()
