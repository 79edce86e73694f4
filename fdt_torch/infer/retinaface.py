"""End-to-end RetinaFace inference on the port's dense-detector path.

RetinaFaceDetector is PyramidBoxDetector's path (infer/pyramidbox.py) as it
stands: the upload and mean, bf16 channels-last, `tf32_for`, a CUDA graph of
the device chain replayed from a batch shape's third call (infer/graphs.py),
eager on the CPU, on a mesh and under int8, and the spans `detect`,
`detect.upload`, `model.forward`, `detect.head`, `detect.readback`.  What it
changes is RetinaFace's own: its priors (fdt_torch.anchors.retina_priors,
two a cell) and a head that carries the five landmarks through the same
threshold, sort, budget, K1 and compaction (ssd_detect's `extra`), so that
a detect returns [B, 2, top_k, 15] rows [score, x1, y1, x2, y2, then x, y of
each landmark], normalized.  Its settings are test_widerface.py's
(fdt_torch.config.RETINA_RES50).

Tracing beside the shared spans: span `detect.landmarks` (in ssd_detect)
around the landmark gather and decode, on the eager path (a graph replay
holds that work, as it holds `detect.head`'s); Counter `landmark_rows`, the
faces returned with landmarks, counted on the host from each readback of
detect_tensor.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fdt_torch.anchors import retina_priors
from fdt_torch.config import RETINA_RES50, RetinaConfig
from fdt_torch.infer.detect import ssd_detect
from fdt_torch.infer.pyramidbox import PyramidBoxDetector, shrink_image
from fdt_torch.utils import trace

landmark_rows = trace.Counter()


def landmark_rows_of(det: np.ndarray, threshold: float, width: float, height: float,
                     shrink: float = 1.0) -> np.ndarray:
    """A [C, top_k, 15] detection tensor → [N, 15] float32 rows [x1, y1, x2,
    y2, score, then x, y of each landmark] in pixels, divided by `shrink`:
    the prefix of each face class's rows with score >= threshold ([0, 15]
    when none; RetinaFace's protocol has no sentinel row)."""
    box = np.array([width, height] * 2, np.float32) / shrink
    points = np.array([width, height] * 5, np.float32) / shrink
    rows = [np.zeros((0, 15), np.float32)]
    for d in det[1:]:  # class 0 is the background's zeros
        take = int(np.cumprod(d[:, 0] >= threshold).sum())
        rows.append(np.column_stack([d[:take, 1:5] * box, d[:take, 0], d[:take, 5:15] * points]))
    return np.concatenate(rows).astype(np.float32)


class RetinaFaceDetector(PyramidBoxDetector):
    """RetinaFace on one device, through PyramidBoxDetector's path.

    Args as PyramidBoxDetector's, with `model` a
    fdt_torch.models.retinaface.RetinaFace and `cfg` a RetinaConfig (its
    priors and, unless `detect_cfg` is given, the detect head's settings)."""

    def __init__(self, model, cfg: RetinaConfig = RETINA_RES50, **kw):
        super().__init__(model, cfg, **kw)

    def _prior_strides(self) -> tuple:
        return self.cfg.steps

    def _make_priors(self, source_shapes, width: int, height: int) -> np.ndarray:
        return retina_priors(self.cfg, source_shapes, width, height)

    def _head(self, out: dict, priors: torch.Tensor, dcfg) -> torch.Tensor:
        conf = F.softmax(out["face_conf"], dim=-1)
        return ssd_detect(out["face_loc"], conf, priors, dcfg, budget=self.budget,
                          extra=out["face_landm"])

    def detect_tensor(self, images_u8, conf_thresh: float | None = None,
                      nms_thresh: float | None = None) -> np.ndarray:
        """[B,H,W,3] uint8 BGR (numpy or tensor) → [B, 2, top_k, 15] numpy."""
        det = super().detect_tensor(images_u8, conf_thresh, nms_thresh)
        landmark_rows.count += int(np.count_nonzero(det[:, 1:, :, 0] > 0))
        return det

    def detect_face(self, image_bgr: np.ndarray, threshold: float | None = None,
                    shrink: float = 1.0, nms_thresh: float | None = None) -> np.ndarray:
        """One image at test_widerface.py's settings (or those given) →
        [N, 15] rows (landmark_rows_of) in the pixels of the image before the
        shrink."""
        if shrink != 1.0:
            image_bgr = shrink_image(image_bgr, shrink)
        h, w, _ = image_bgr.shape
        threshold = self.detect_cfg.conf_thresh if threshold is None else threshold
        det = self.detect_tensor(image_bgr[None], conf_thresh=threshold,
                                 nms_thresh=nms_thresh)[0]
        return landmark_rows_of(det, threshold, w, h, shrink)
