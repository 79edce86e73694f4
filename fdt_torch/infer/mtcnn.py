"""MTCNN's three-stage cascade with the bookkeeping on the host (counterpart
of fdt/infer/mtcnn.py).

The reference cascade (MTCNN/mtcnn/core/detect.py:66-620): PNet over an
image pyramid, one call a level; RNet on 24² and ONet on 48² crops of the
squared candidates; greedy numpy NMS between the stages.  The nets run on
the detector's device (the card unless told otherwise); the candidate lists,
crops and NMS stay on the host, as in fdt, which reproduces the reference's
candidate sets, its in-place clamp of the squared boxes in pad()
(detect.py:183-244) included.

The two resizes are module-level functions, so that a test can put cv2's in
their place: `resize_level` (cv2.resize(fx=) of a pyramid level) and
`resize_crop` (cv2.resize of a crop to the net's size).  Each is within 1
LSB of cv2's, whose weights are 11-bit fixed point.

Each PNet level runs at its own size, and RNet and ONet at the batch the
stage has: fdt pads levels to 64-pixel buckets and batches to powers of two
so that XLA compiles few shapes, and its valid-cell mask gives the same
cells as an unpadded level.
"""
from __future__ import annotations

import numpy as np
import torch

from fdt_torch.config import MTCNN, MTCNNConfig
from fdt_torch.geometry.nms import nms_numpy
from fdt_torch.infer.pyramidbox import _check_precision, _resolve_device, shrink_image, tf32_for


def resize_level(image: np.ndarray, scale: float) -> np.ndarray:
    """A pyramid level: cv2.resize(image, None, fx=scale, fy=scale,
    interpolation=cv2.INTER_LINEAR) of an [H, W, 3] uint8 image, within 1
    LSB (pyramidbox.shrink_image); at scale 1 the image itself, which cv2
    copies (the first level at min_face_size 12, half the pyramid's
    pixels)."""
    return image if scale == 1.0 else shrink_image(image, scale)


def resize_crop(crop: np.ndarray, size: int) -> np.ndarray:
    """A candidate's crop at the net's input size: cv2.resize(crop, (size,
    size)) of an [h, w, 3] uint8 crop, within 1 LSB (resize_bilinear)."""
    from fdt_torch.apps.serving import resize_bilinear
    return resize_bilinear(crop, size, size)


def generate_bounding_box(score_map: np.ndarray, reg: np.ndarray, scale: float,
                          threshold: float, stride: int = 2,
                          cellsize: int = 12) -> np.ndarray:
    """Score-map cells above threshold → [N,9] boxes (detect.py:134-181).
    Rows: x1, y1, x2, y2, score, reg0..3 (coords mapped to the original image)."""
    ys, xs = np.where(score_map > threshold)
    if ys.size == 0:
        return np.array([])
    score = score_map[ys, xs]
    r = reg[ys, xs]  # [N,4]
    return np.column_stack([
        np.round((stride * xs) / scale),
        np.round((stride * ys) / scale),
        np.round((stride * xs + cellsize) / scale),
        np.round((stride * ys + cellsize) / scale),
        score, r,
    ])


def square_bbox(bbox: np.ndarray) -> np.ndarray:
    """Center-preserving squarification (detect.py:102-131)."""
    sq = bbox.copy()
    h = bbox[:, 3] - bbox[:, 1] + 1
    w = bbox[:, 2] - bbox[:, 0] + 1
    la = np.maximum(h, w)
    sq[:, 0] = bbox[:, 0] + w * 0.5 - la * 0.5
    sq[:, 1] = bbox[:, 1] + h * 0.5 - la * 0.5
    sq[:, 2] = sq[:, 0] + la - 1
    sq[:, 3] = sq[:, 1] + la - 1
    return sq


def pad_clamp(dets: np.ndarray, w: int, h: int):
    """Crop bookkeeping for out-of-image boxes (detect.py:183-244).

    Returns (dy, edy, dx, edx, y, ey, x, ex, tmpw, tmph) int32 arrays and,
    like the reference, which writes through numpy views, clamps dets[:, :4]
    in place.
    """
    tmpw = (dets[:, 2] - dets[:, 0] + 1).astype(np.int32)
    tmph = (dets[:, 3] - dets[:, 1] + 1).astype(np.int32)
    n = dets.shape[0]
    dx = np.zeros(n)
    dy = np.zeros(n)
    edx, edy = tmpw.copy().astype(float) - 1, tmph.copy().astype(float) - 1
    x, y, ex, ey = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]

    idx = np.where(ex > w - 1)
    edx[idx] = tmpw[idx] + w - 2 - ex[idx]
    ex[idx] = w - 1
    idx = np.where(ey > h - 1)
    edy[idx] = tmph[idx] + h - 2 - ey[idx]
    ey[idx] = h - 1
    idx = np.where(x < 0)
    dx[idx] = 0 - x[idx]
    x[idx] = 0
    idx = np.where(y < 0)
    dy[idx] = 0 - y[idx]
    y[idx] = 0
    return [a.astype(np.int32) for a in (dy, edy, dx, edx, y, ey, x, ex, tmpw, tmph)]


def _apply_regression(boxes: np.ndarray, reg: np.ndarray, scores: np.ndarray) -> np.ndarray:
    bw = boxes[:, 2] - boxes[:, 0] + 1
    bh = boxes[:, 3] - boxes[:, 1] + 1
    return np.column_stack([
        boxes[:, 0] + reg[:, 0] * bw,
        boxes[:, 1] + reg[:, 1] * bh,
        boxes[:, 2] + reg[:, 2] * bw,
        boxes[:, 3] + reg[:, 3] * bh,
        scores,
    ])


class MTCNNDetector:
    """PNet, RNet and ONet → the full cascade, detect_face().

    Args:
      pnet, rnet, onet: fdt_torch.models PNet / RNet / ONet with their
        weights (models.load_mtcnn_nets), moved to `device`.
      cfg: MTCNNConfig (thresholds, pyramid).
      precision: "highest" (TF32 off for the nets) or "default" (TF32
        allowed), as fdt's detector.
      device: None → "cuda" (raises if absent); "cpu" for the CPU.
    """

    def __init__(self, pnet, rnet, onet, cfg: MTCNNConfig = MTCNN,
                 precision: str = "highest", device=None):
        self.cfg = cfg
        self.precision = _check_precision(precision)
        self.device = _resolve_device(device)
        self.pnet, self.rnet, self.onet = (
            m.eval().to(self.device, dtype=torch.float32) for m in (pnet, rnet, onet))

    @torch.inference_mode()
    def _forward(self, net, x: np.ndarray) -> tuple:
        """[B, H, W, 3] float32 numpy through `net` on the device → its
        outputs as float32 numpy arrays."""
        x = torch.from_numpy(x).to(self.device).permute(0, 3, 1, 2).contiguous()
        with tf32_for(self.precision):
            outs = net(x)
        return tuple(o.cpu().numpy() for o in outs)

    def _run_pnet_level(self, im_resized: np.ndarray):
        """One pyramid level → (score map [h', w'], regressions [h', w', 4]);
        every cell's 12×12 window lies inside the level."""
        cls_map, reg = self._forward(self.pnet,
                                     im_resized[None].astype(np.float32) / 255.0)
        return cls_map[0, 0], reg[0].transpose(1, 2, 0)

    def detect_pnet(self, im: np.ndarray):
        """Image-pyramid proposal stage (detect.py:246-350)."""
        cfg = self.cfg
        net_size = 12
        current_scale = net_size / cfg.min_face_size
        im_resized = resize_level(im, current_scale)
        all_boxes = []
        while min(im_resized.shape[0], im_resized.shape[1]) > net_size:
            cls_map, reg = self._run_pnet_level(im_resized)
            boxes = generate_bounding_box(cls_map, reg, current_scale,
                                          cfg.thresholds[0], cfg.stride, cfg.cell_size)
            current_scale *= cfg.scale_factor
            im_resized = resize_level(im, current_scale)
            if boxes.size == 0:
                continue
            keep = nms_numpy(boxes[:, :4], boxes[:, 4], cfg.pnet_nms_per_level, "minimum")
            all_boxes.append(boxes[keep])
        if not all_boxes:
            return None, None
        all_boxes = np.vstack(all_boxes)
        keep = nms_numpy(all_boxes[:, :4], all_boxes[:, 4], cfg.pnet_nms_merge, "union")
        all_boxes = all_boxes[keep]
        boxes_align = _apply_regression(all_boxes[:, :4], all_boxes[:, 5:9], all_boxes[:, 4])
        return all_boxes[:, :5], boxes_align

    def _crop_batch(self, im: np.ndarray, dets: np.ndarray, size: int) -> np.ndarray:
        """Square-pad-crop-resize every candidate (detect.py:396-405)."""
        h, w, _ = im.shape
        dy, edy, dx, edx, y, ey, x, ex, tmpw, tmph = pad_clamp(dets, w, h)
        crops = np.zeros((dets.shape[0], size, size, 3), np.float32)
        for i in range(dets.shape[0]):
            tmp = np.zeros((tmph[i], tmpw[i], 3), np.uint8)
            tmp[dy[i]:edy[i] + 1, dx[i]:edx[i] + 1] = im[y[i]:ey[i] + 1, x[i]:ex[i] + 1]
            crops[i] = resize_crop(tmp, size).astype(np.float32) / 255.0
        return crops

    def detect_rnet(self, im: np.ndarray, dets: np.ndarray):
        """Refinement stage (detect.py:352-465)."""
        if dets is None:
            return None, None
        cfg = self.cfg
        dets = square_bbox(dets)
        dets[:, 0:4] = np.round(dets[:, 0:4])
        crops = self._crop_batch(im, dets, 24)  # pad_clamp clamps dets in place
        cls_map, reg = self._forward(self.rnet, crops)
        keep_inds = np.where(cls_map > cfg.thresholds[1])[0]
        if len(keep_inds) == 0:
            return None, None
        boxes, cls, reg = dets[keep_inds], cls_map[keep_inds], reg[keep_inds]
        keep = nms_numpy(boxes[:, :4], boxes[:, 4], cfg.rnet_nms, "union")
        if len(keep) == 0:
            return None, None
        keep_boxes, keep_cls, keep_reg = boxes[keep], cls[keep], reg[keep]
        keep_boxes[:, 4] = keep_cls[:, 0]
        boxes_align = _apply_regression(keep_boxes[:, :4], keep_reg, keep_cls[:, 0])
        return keep_boxes, boxes_align

    def detect_onet(self, im: np.ndarray, dets: np.ndarray):
        """Output stage with landmarks (detect.py:467-583)."""
        if dets is None:
            return None, None
        cfg = self.cfg
        dets = square_bbox(dets)
        dets[:, 0:4] = np.round(dets[:, 0:4])
        crops = self._crop_batch(im, dets, 48)
        cls_map, reg, landmark = self._forward(self.onet, crops)
        keep_inds = np.where(cls_map > cfg.thresholds[2])[0]
        if len(keep_inds) == 0:
            return None, None
        boxes = dets[keep_inds]
        cls, reg, landmark = cls_map[keep_inds], reg[keep_inds], landmark[keep_inds]

        boxes_align = _apply_regression(boxes[:, :4], reg, cls[:, 0])
        bw = boxes[:, 2] - boxes[:, 0] + 1
        bh = boxes[:, 3] - boxes[:, 1] + 1
        lm = np.empty_like(landmark)
        lm[:, 0::2] = boxes[:, 0:1] + landmark[:, 0::2] * bw[:, None]
        lm[:, 1::2] = boxes[:, 1:2] + landmark[:, 1::2] * bh[:, None]

        keep = nms_numpy(boxes_align[:, :4], boxes_align[:, 4], cfg.onet_nms, "minimum")
        return boxes_align[keep], lm[keep]

    def detect_face(self, img: np.ndarray):
        """Full cascade (detect.py:585-620): → (boxes [N,5], landmarks [N,10]),
        or two empty arrays."""
        _, boxes_align = self.detect_pnet(img)
        if boxes_align is None:
            return np.array([]), np.array([])
        _, boxes_align = self.detect_rnet(img, boxes_align)
        if boxes_align is None:
            return np.array([]), np.array([])
        boxes_align, landmark_align = self.detect_onet(img, boxes_align)
        if boxes_align is None:
            return np.array([]), np.array([])
        return boxes_align, landmark_align


def load_mtcnn_detector(p_path: str, r_path: str, o_path: str,
                        cfg: MTCNNConfig = MTCNN, **kw) -> MTCNNDetector:
    """An MTCNNDetector from three weight files (PNet, RNet, ONet): variables
    npz files in fdt's format or the reference's `.pt` files, loaded strict
    (fdt/infer/mtcnn.py:272-290), as models.load_mtcnn_cascade reads them.
    **kw go to the detector (precision=, device=; None is the card)."""
    from fdt_torch.models.loader import load_mtcnn_files
    return MTCNNDetector(*load_mtcnn_files(p_path, r_path, o_path), cfg, **kw)
