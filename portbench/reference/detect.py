"""Plain SSD test-time detection over the reference forward: face priors,
softmax, variance decode, per-image threshold, score sort, budget, greedy
NMS and the top_k rows, written from the PyramidBox detect head's published
behaviour (S3FD's Detect: conf > threshold, top nms_top_k by score,
greedy NMS at IoU >= nms_thresh, keep top_k) without the port's code.

Priors: one per cell of each source map, centre ((j + 0.5) · stride / W,
(i + 0.5) · stride / H), side (box / W, box / H), float64 cast to float32.
Ties in score keep index order (a stable sort).  A class with exactly one
candidate above the threshold is dropped, as the reference detector does.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from portbench.reference.pyramidbox import PyramidBoxRef, load_weights

PIXEL_MEAN_BGR = (104.0, 117.0, 123.0)
FACE_STRIDES = (4, 8, 16, 32, 64, 128)
FACE_BOXES = (16, 32, 64, 128, 256, 512)
VARIANCE = (0.1, 0.2)


@dataclasses.dataclass(frozen=True)
class HeadSettings:
    conf_thresh: float
    nms_thresh: float
    budget: int = 5000
    top_k: int = 750


@dataclasses.dataclass
class ImageResult:
    """One image through the reference, in pixels of the image.

    scores [P], boxes [P, 4]: every prior's face score and decoded box.
    rows [m, 5]: the kept detections, [x1, y1, x2, y2, score], best first.
    sorted_boxes [k, 4], sorted_valid [k], keep [k]: the NMS problem in
    score order (normalized boxes, as the detector's kernel sees them) and
    its full greedy keep mask (k = the budget, or fewer priors)."""
    scores: np.ndarray
    boxes: np.ndarray
    rows: np.ndarray
    sorted_boxes: np.ndarray
    sorted_valid: np.ndarray
    keep: np.ndarray


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuDNN convolutions and matmuls inside the body."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def face_priors(shapes, width: int, height: int) -> np.ndarray:
    parts = []
    for (fw, fh), stride, box in zip(shapes, FACE_STRIDES, FACE_BOXES):
        cx = (np.arange(fw, dtype=np.float64) + 0.5) * stride / width
        cy = (np.arange(fh, dtype=np.float64) + 0.5) * stride / height
        p = np.empty((fh, fw, 4), np.float64)
        p[..., 0] = cx[None, :]
        p[..., 1] = cy[:, None]
        p[..., 2] = box / width
        p[..., 3] = box / height
        parts.append(p.reshape(-1, 4).astype(np.float32))
    return np.concatenate(parts)


def decode(loc: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    cxcy = priors[..., :2] + loc[..., :2] * VARIANCE[0] * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * VARIANCE[1])
    x1y1 = cxcy - wh / 2
    return torch.cat([x1y1, x1y1 + wh], -1)


def iou_one(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one box against many, float32, point form."""
    wx = np.clip(np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0]), 0, None)
    wy = np.clip(np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1]), 0, None)
    inter = wx * wy
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / (area + areas - inter)


def greedy_nms(boxes: np.ndarray, valid: np.ndarray, thresh: float,
               top_k: int) -> np.ndarray:
    """Keep mask of greedy NMS over score-sorted boxes: a valid box is kept
    unless an earlier kept box overlaps it by IoU >= thresh; the walk stops
    after top_k keeps (later boxes stay unkept)."""
    keep = np.zeros(len(boxes), bool)
    alive = valid.copy()
    kept = 0
    for i in range(len(boxes)):
        if not alive[i]:
            continue
        keep[i] = True
        kept += 1
        if kept == top_k:
            break
        rest = slice(i + 1, None)
        alive[rest] &= ~(iou_one(boxes[i], boxes[rest]) >= np.float32(thresh))
    return keep


def detect_image(scores: np.ndarray, boxes: np.ndarray, head: HeadSettings,
                 width: int, height: int) -> ImageResult:
    """The head over one image's scores [P] and normalized boxes [P, 4]."""
    valid = scores > np.float32(head.conf_thresh)
    masked = np.where(valid, scores, -np.inf).astype(np.float32)
    order = np.argsort(-masked, kind="stable")[:min(head.budget, len(scores))]
    s_boxes, s_valid = boxes[order], valid[order]
    keep = greedy_nms(s_boxes, s_valid, head.nms_thresh, head.top_k)
    if valid.sum() == 1:
        keep[:] = False
    scale = np.array([width, height, width, height], np.float32)
    kept = order[keep]
    rows = np.column_stack([boxes[kept] * scale, scores[kept]]).astype(np.float32)
    return ImageResult(scores, boxes * scale, rows, s_boxes, s_valid, keep)


class ReferenceDetector:
    """Weights npz → float32 forward (TF32 off) → detect_image per image."""

    def __init__(self, weights_path: str, variant: str, device="cpu"):
        self.device = torch.device(device)
        self.net = PyramidBoxRef(load_weights(weights_path, self.device), variant)

    @torch.inference_mode()
    def __call__(self, frames_u8: np.ndarray, head: HeadSettings,
                 block: int = 8) -> list[ImageResult]:
        """[n, H, W, 3] uint8 BGR → one ImageResult per frame, `block`
        frames a forward."""
        out = []
        n, h, w, _ = frames_u8.shape
        mean = torch.tensor(PIXEL_MEAN_BGR, device=self.device)
        for i in range(0, n, block):
            x = torch.from_numpy(np.ascontiguousarray(frames_u8[i:i + block])).to(self.device)
            x = (x.float() - mean).permute(0, 3, 1, 2).contiguous()
            with full_float32():
                loc, logits, shapes = self.net(x)
            priors = torch.from_numpy(face_priors(shapes, w, h)).to(self.device)
            scores = torch.softmax(logits, -1)[..., 1].cpu().numpy()
            boxes = decode(loc, priors).cpu().numpy()
            out += [detect_image(s, b, head, w, h) for s, b in zip(scores, boxes)]
        return out
