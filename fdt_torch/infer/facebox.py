"""End-to-end FaceBoxes inference (counterpart of fdt/infer/facebox.py:65-154).

uint8 BGR batch at the config's square size → /255 (no mean subtraction) →
forward → softmax → decode against the densified default boxes → per image
`score > conf_thresh` → greedy NMS over the top `budget` (2048) → the first
`out_k` (750) keeps.  The batch is a leading dimension of the NMS problem,
so a call makes one NMS launch (kernel K1 on the card, by nms_padded's
"auto").

Two compute types, as PyramidBoxDetector: float32 and bfloat16 with
channels_last; `precision` "highest" (the default, TF32 off for the forward)
or "default" (TF32 allowed), as fdt's; `quant="int8"`, fdt's int8 inference
(every conv of reduction 32 or more, the 7×7 stem too, through kernels K5 and
K4 on the card).  fdt's stem_impl="s2d" is a TPU rearrangement of the same
RDCL convs, so the port runs the direct convs.  `mesh=` is fdt's
data-parallel inference, as PyramidBoxDetector's: the model replicated to
each device of an fdt_torch.dist.Mesh, every batch padded to a mesh
multiple, split, run shard by shard, gathered and cut back.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fdt_torch.anchors import facebox_default_boxes
from fdt_torch.config import FACEBOX, FaceBoxConfig
from fdt_torch.geometry.boxes import decode
from fdt_torch.dist.mesh import replicated, run_sharded
from fdt_torch.geometry.nms import nms_padded
from fdt_torch.infer.pyramidbox import _check_precision, _resolve_device, place_model, tf32_for
from fdt_torch.ops.quant import check_mode


class FaceBoxDetector:
    """FaceBoxes detector on one device.

    Args:
      model: a fdt_torch.models.FaceBox with its weights loaded (moved to
        `device`).
      cfg: FaceBoxConfig (input size, default-box grid, thresholds).
      budget: boxes entering NMS; out_k: detections kept per image.
      dtype: torch.float32, or torch.bfloat16 (computed channels_last).
      device: None → "cuda" (raises if absent); "cpu" for the CPU.
      precision: "highest" (TF32 off for the forward) or "default" (TF32
        allowed), as fdt's detector.
      quant: None, or "int8" (the model passed in is not changed; see
        fdt_torch.infer.pyramidbox.place_model).
      mesh: an fdt_torch.dist.Mesh for data-parallel batches; `device` is
        then its first device.
    """

    def __init__(self, model, cfg: FaceBoxConfig = FACEBOX, budget: int = 2048,
                 out_k: int = 750, dtype: torch.dtype = torch.float32, device=None,
                 precision: str = "highest", quant: str | None = None, mesh=None):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.precision = _check_precision(precision)
        self.quant = check_mode(quant)
        self.cfg = cfg
        self.budget = budget
        self.out_k = out_k
        self.dtype = dtype
        self.mesh = mesh
        self.device = _resolve_device(device, mesh)
        self.memory_format = (torch.channels_last if dtype == torch.bfloat16
                              else torch.contiguous_format)
        self.model = place_model(model, self.device, dtype, self.memory_format, quant)
        # the model on each device that runs a shard (only self.model without a mesh)
        self._models = replicated(mesh, self.model) if mesh else {self.device: self.model}
        boxes = facebox_default_boxes(cfg)
        self._default_boxes = {d: torch.tensor(boxes, device=d) for d in self._models}

    def _check(self, images_u8: torch.Tensor) -> None:
        s = self.cfg.input_size
        if (images_u8.dim() != 4 or tuple(images_u8.shape[1:]) != (s, s, 3)
                or images_u8.dtype != torch.uint8):
            raise ValueError(f"expected [B,{s},{s},3] uint8, got {images_u8.dtype} "
                             f"{tuple(images_u8.shape)}")

    def _sharded(self, fn, images_u8: torch.Tensor):
        self._check(images_u8)
        if self.mesh is None:
            return fn(self.device, images_u8)
        return run_sharded(self.mesh, fn, images_u8, self.device)

    @torch.inference_mode()
    def candidates(self, images_u8: torch.Tensor):
        """[B,S,S,3] uint8 BGR tensor → (boxes [B,P,4] normalized point form,
        face probabilities [B,P]), float32 on the detector's device: every
        default box before the threshold and NMS."""
        return self._sharded(self._candidates_on, images_u8)

    def _candidates_on(self, device, images_u8: torch.Tensor):
        x = images_u8.to(device, non_blocking=True).float() / 255.0
        x = x.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=self.memory_format)
        with tf32_for(self.precision):
            loc, conf = self._models[device](x)
        probs = F.softmax(conf, dim=-1)[..., 1]
        return decode(loc, self._default_boxes[device], self.cfg.variance), probs

    @torch.inference_mode()
    def detect_device(self, images_u8: torch.Tensor):
        """[B,S,S,3] uint8 BGR tensor → (boxes [B,out_k,4] normalized,
        scores [B,out_k], count [B] int32) on the detector's device; rows past
        each count are zeros (no host synchronisation; with a mesh, shard by
        shard, gathered there)."""
        return self._sharded(self._detect_on, images_u8)

    def _detect_on(self, device, images_u8: torch.Tensor):
        boxes, probs = self._candidates_on(device, images_u8)
        idx, count = nms_padded(boxes, probs, self.cfg.nms_thresh, budget=self.budget,
                                out_k=self.out_k, valid=probs > self.cfg.conf_thresh)
        idx = idx.long()
        keep = torch.arange(self.out_k, device=device) < count[:, None]
        kept_boxes = torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4))
        return (torch.where(keep[..., None], kept_boxes, 0.0),
                torch.where(keep, torch.gather(probs, 1, idx), 0.0), count)

    def detect_batch(self, images_u8) -> list[tuple[np.ndarray, np.ndarray]]:
        """[B,S,S,3] uint8 BGR (numpy or tensor) → per image (boxes [n,4]
        normalized, scores [n])."""
        if not torch.is_tensor(images_u8):
            images_u8 = torch.from_numpy(np.ascontiguousarray(images_u8))
        boxes, scores, count = (t.cpu().numpy() for t in self.detect_device(images_u8))
        return [(boxes[i, :c], scores[i, :c]) for i, c in enumerate(count)]

    def detect(self, image_bgr: np.ndarray):
        """One image at any resolution, resized to the square input on the
        host.  Returns (boxes [n,4] in the image's pixels, scores [n])."""
        from fdt_torch.apps.serving import resize_bilinear
        h, w = image_bgr.shape[:2]
        s = self.cfg.input_size
        (boxes, scores), = self.detect_batch(resize_bilinear(image_bgr, s, s)[None])
        return boxes * np.array([w, h, w, h], np.float32), scores
