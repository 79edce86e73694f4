"""Host-side training augmentation (counterpart of fdt/data/augment.py).

PyramidBox's data-anchor-sampling pipeline as pure functions of an explicit
RandomState:

  ConvertFromInts → ToAbsoluteCoords → PhotometricDistort → data-anchor crop
  → RandomMirror → ToPercentCoords → Resize(size, random interp) →
  SubtractMeans / Normalize

fdt's cv2 calls are fdt_torch.data.resize's numpy versions.  No draw depends
on a pixel, so with the same RandomState the port draws the same numbers in
the same order as fdt: boxes, labels and the final RNG state are equal, and
the pixels differ only by the resize's float32 rounding (and where a hue
truncated to an integer lands on the other side of one).  It stays on the
host: branchy, shape-changing work feeding fixed-shape batches to the card.
"""
from __future__ import annotations

import math

import numpy as np

from fdt_torch.data.resize import (INTER_AREA, INTER_CUBIC, INTER_LANCZOS4,
                                   INTER_LINEAR, INTER_NEAREST, bgr_to_hsv,
                                   hsv_to_bgr, resize)

_ANCHORS = (16, 32, 64, 128, 256, 512)
_MAX_SIZE = 12000


def _interp_methods():
    return [INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_NEAREST, INTER_LANCZOS4]


def _clip255(x):
    return np.clip(x, 0, 255)


def photometric_distort(image: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Brightness/contrast/saturation/hue jitter (augmentations.py:440-494).

    Takes/returns float32 BGR in [0,255]; branch structure follows the
    reference: brightness always, then contrast-first or contrast-last.
    """
    im = image.copy()
    im = _clip255(im + rng.uniform(-32, 32))
    contrast_first = rng.randint(2)
    if contrast_first:
        im = _clip255(im * rng.uniform(0.5, 1.5))
    im = bgr_to_hsv(im.astype(np.float32))
    im[:, :, 1] = _clip255(im[:, :, 1] * rng.uniform(0.5, 1.5))
    im = hsv_to_bgr(im)
    im = bgr_to_hsv(im.astype(np.float32))
    # H is in [0, 360): the reference's % 180 is kept, it is fdt's arithmetic
    im[:, :, 0] = (im[:, :, 0].astype(int) + rng.randint(-18, 18)) % 180
    im = hsv_to_bgr(im.astype(np.float32))
    if not contrast_first:
        im = _clip255(im * rng.uniform(0.5, 1.5))
    return im.astype(np.float32)


def data_anchor_crop(image: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                     rng: np.random.RandomState):
    """PyramidBox data-anchor-sampling (RandomBaiduCrop, augmentations.py:231-370).

    Picks a random GT face, snaps its side to the nearest anchor in {16…512},
    rescales the whole image by anchor/side · 2^U(-1,1) (area-capped at 12000²),
    then rejection-samples (50 tries) a 640×640 window containing GT centers,
    mean-padding when the window exceeds image bounds.
    """
    height, width, _ = image.shape
    if len(boxes) == 0:
        # no face to anchor the crop on (the reference crashes here,
        # augmentations.py:292; WiderFaceDataset filters such records, but a
        # custom dataset may still hand one in): fall back to a plain resize
        return resize(image, (640, 640)), boxes.reshape(0, 4), labels
    box_area = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    rand_idx = rng.randint(len(box_area))
    rand_side = box_area[rand_idx] ** 0.5

    anchor_idx = int(np.argmin([abs(a - rand_side) for a in _ANCHORS]))
    target_anchor = _ANCHORS[rng.randint(min(anchor_idx + 1, 5) + 1)]
    ratio = float(target_anchor) / rand_side * (2 ** rng.uniform(-1, 1))
    if int(height * ratio * width * ratio) > _MAX_SIZE * _MAX_SIZE:
        ratio = (_MAX_SIZE * _MAX_SIZE / (height * width)) ** 0.5

    interp = _interp_methods()[rng.randint(5)]
    image = resize(image, None, ratio, ratio, interp)
    boxes = boxes * ratio
    height, width, _ = image.shape

    xmin, ymin = boxes[rand_idx, 0], boxes[rand_idx, 1]
    bw = boxes[rand_idx, 2] - boxes[rand_idx, 0] + 1
    bh = boxes[rand_idx, 3] - boxes[rand_idx, 1] + 1
    w = h = 640

    sample_boxes = []
    for _ in range(50):
        if w < max(height, width):
            w_off = rng.uniform(xmin + bw - w, xmin) if bw <= w else rng.uniform(xmin, xmin + bw - w)
            h_off = rng.uniform(ymin + bh - h, ymin) if bh <= h else rng.uniform(ymin, ymin + bh - h)
        else:
            w_off = rng.uniform(width - w, 0)
            h_off = rng.uniform(height - h, 0)
        rect = np.array([int(math.floor(w_off)), int(math.floor(h_off)),
                         int(math.floor(w_off)) + w, int(math.floor(h_off)) + h])

        # sampled window must contain a whole GT box or overlap one by > 0.7
        m1 = (rect[0] <= boxes[:, 0]) & (rect[1] <= boxes[:, 1])
        m2 = (rect[2] >= boxes[:, 2]) & (rect[3] >= boxes[:, 3])
        inter_wh = np.clip(np.minimum(boxes[:, 2:], rect[2:]) -
                           np.maximum(boxes[:, :2], rect[:2]), 0, None)
        inter = inter_wh[:, 0] * inter_wh[:, 1]
        area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        area_r = (rect[2] - rect[0]) * (rect[3] - rect[1])
        overlap = inter / (area_b + area_r - inter)
        if (m1 & m2).any() or overlap.max() > 0.7:
            sample_boxes.append(rect)

    if not sample_boxes:
        return image, boxes, labels

    rect = sample_boxes[rng.randint(len(sample_boxes))]
    centers = (boxes[:, :2] + boxes[:, 2:]) / 2.0
    keep = ((rect[0] < centers[:, 0]) & (rect[1] < centers[:, 1]) &
            (rect[2] > centers[:, 0]) & (rect[3] > centers[:, 1]))
    out_boxes = boxes[keep].copy()
    out_labels = labels[keep]
    out_boxes[:, :2] -= rect[:2]
    out_boxes[:, 2:] -= rect[:2]

    if rect[0] < 0 or rect[1] < 0:
        pad_w = width if rect[0] >= 0 else width - rect[0]
        pad_h = height if rect[1] >= 0 else height - rect[1]
        canvas = np.empty((pad_h, pad_w, 3), dtype=float)
        canvas[:] = (104, 117, 123)
        top = 0 if rect[1] >= 0 else -rect[1]
        left = 0 if rect[0] >= 0 else -rect[0]
        canvas[top:top + height, left:left + width] = image
        x0 = max(rect[0], 0)
        y0 = max(rect[1], 0)
        crop = canvas[y0:y0 + (rect[3] - rect[1]), x0:x0 + (rect[2] - rect[0])].copy()
        return crop, out_boxes, out_labels

    return image[rect[1]:rect[3], rect[0]:rect[2]].copy(), out_boxes, out_labels


def expand(image, boxes, rng, mean=(104, 117, 123)):
    """Mean-filled canvas expansion (Expand, augmentations.py:376-399).

    Inactive in the reference's PyramidAugmentation compose (497-513) but part
    of its augmentation toolbox; provided for SSD-style training recipes.
    Boxes are absolute pixel coords.
    """
    if rng.randint(2):
        return image, boxes
    height, width, depth = image.shape
    ratio = rng.uniform(1, 4)
    left = rng.uniform(0, width * ratio - width)
    top = rng.uniform(0, height * ratio - height)
    canvas = np.empty((int(height * ratio), int(width * ratio), depth),
                      dtype=image.dtype)
    canvas[:, :, :] = mean
    canvas[int(top):int(top) + height, int(left):int(left) + width] = image
    boxes = boxes.copy()
    boxes[:, :2] += (int(left), int(top))
    boxes[:, 2:] += (int(left), int(top))
    return canvas, boxes


def random_mirror(image, boxes, rng):
    """Horizontal flip (augmentations.py:404-411)."""
    _, width, _ = image.shape
    if rng.randint(2):
        image = image[:, ::-1]
        boxes = boxes.copy()
        boxes[:, 0::2] = width - boxes[:, 2::-2]
    return image, boxes


def resize_random_interp(image, size, rng):
    interp = _interp_methods()[rng.randint(5)]
    return resize(image.astype(np.float32), (size, size), interpolation=interp)


def pyramid_augment(image: np.ndarray, boxes_percent: np.ndarray, labels: np.ndarray,
                    rng: np.random.RandomState, size: int = 640,
                    mean=(104, 117, 123)):
    """Full PyramidAugmentation pipeline (augmentations.py:497-513).

    Args:
      image: HWC uint8/float BGR.
      boxes_percent: [N,4] point-form boxes normalized to [0,1].
      labels: [N].
    Returns (image [size,size,3] float32 mean-subtracted, boxes percent, labels).
    """
    h, w, _ = image.shape
    image = image.astype(np.float32)
    boxes = boxes_percent * np.array([w, h, w, h], np.float32)
    image = photometric_distort(image, rng)
    image, boxes, labels = data_anchor_crop(image, boxes, labels, rng)
    image, boxes = random_mirror(image, boxes, rng)
    h, w, _ = image.shape
    boxes = boxes / np.array([w, h, w, h], np.float32)
    image = resize_random_interp(image, size, rng)
    image = image - np.array(mean, np.float32)
    return image.astype(np.float32), boxes.astype(np.float32), labels


def pyramid_normal_augment(image, boxes_percent, labels, rng, size: int = 640,
                           mean=(0.406, 0.456, 0.485), std=(0.225, 0.224, 0.229)):
    """Mean/std variant (PyramidNormalAugmentation, augmentations.py:516-533)."""
    img, boxes, labels = pyramid_augment(image, boxes_percent, labels, rng,
                                         size, mean=(0, 0, 0))
    img = img / 256.0
    img = (img - np.array(mean, np.float32)) / np.array(std, np.float32)
    return img.astype(np.float32), boxes, labels


def base_transform(image, size: int, mean=(104, 117, 123)):
    """Plain resize + mean-subtract eval transform (BaseTransform,
    reference data/__init__.py:6-21; unused by the reference's main paths but
    part of its exported data API).  cv2 resizes a uint8 image in fixed
    point and rounds: a uint8 input here is resized in float32 and rounded,
    within one level of cv2's."""
    x = resize(image, (size, size))
    if image.dtype == np.uint8:
        x = np.clip(np.rint(x), 0, 255)
    return x.astype(np.float32) - np.array(mean, np.float32)
