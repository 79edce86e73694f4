"""Debug visualizers for the data factories and anchor matchers (counterpart
of fdt/utils/visualize.py:40-122).

  * vis_two / vis_face — MTCNN before/after-calibration overlays and final
    detections with landmarks (MTCNN/mtcnn/core/vision.py:6-140), drawn with
    matplotlib's Agg backend and saved to a path; matplotlib is imported
    inside the functions, as the card's machine has none.
  * draw_matched_anchors — the FaceBoxes encoder check: the GT boxes and the
    anchor centres the encoder matched, one image per anchor scale group
    (DataEncoder.test_encode, FACEBOX/encoderl.py:93-156).  It runs the
    port's facebox_encode and draws with Pillow what fdt draws with cv2:
    rectangles, and circles rasterised as cv2.circle rasterises a one-pixel
    circle (its midpoint walk, `circle_offsets`), so the images are fdt's
    pixel for pixel; the JPEGs are written by data.image_io.imwrite.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _agg_plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _panel(plt, im_rgb, dets, thresh):
    plt.imshow(im_rgb)
    for det in dets:
        if det[4] <= thresh:
            continue
        x1, y1, x2, y2 = det[:4]
        plt.gca().add_patch(plt.Rectangle((x1, y1), x2 - x1, y2 - y1, fill=False,
                                          edgecolor="red", linewidth=0.7))
        if det.shape[0] >= 15:  # landmark columns present
            lm = det[5:15].reshape(5, 2)
            plt.scatter(lm[:, 0], lm[:, 1], c="yellow", linewidths=0.1, marker="x", s=5)


def _save_or_return(plt, fig, save_path):
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)
        return None
    return fig


def vis_two(im_rgb: np.ndarray, dets_before: np.ndarray, dets_after: np.ndarray,
            thresh: float = 0.9, save_path: str | None = None):
    """Side-by-side detections before/after box calibration (vision.py:6-84);
    the figure, or None once saved to `save_path`."""
    plt = _agg_plt()
    fig = plt.figure()
    plt.subplot(121)
    _panel(plt, im_rgb, dets_before, thresh)
    plt.subplot(122)
    _panel(plt, im_rgb, dets_after, thresh)
    return _save_or_return(plt, fig, save_path)


def vis_face(im_rgb: np.ndarray, dets: np.ndarray, landmarks: np.ndarray | None = None,
             save_path: str | None = None):
    """Final detections + 5-point landmarks overlay (vision.py:87-140); the
    figure, or None once saved to `save_path`."""
    plt = _agg_plt()
    from matplotlib.patches import Circle
    fig = plt.figure()
    plt.imshow(im_rgb)
    for det in dets:
        x1, y1, x2, y2 = det[:4]
        plt.gca().add_patch(plt.Rectangle((x1, y1), x2 - x1, y2 - y1, fill=False,
                                          edgecolor="yellow", linewidth=0.9))
    if landmarks is not None:
        for row in landmarks:
            for x, y in row.reshape(5, 2):
                plt.gca().add_patch(Circle((x, y), radius=2, alpha=0.4, color="red"))
    return _save_or_return(plt, fig, save_path)


@functools.lru_cache(maxsize=None)
def circle_offsets(radius: int) -> tuple[tuple[int, int], ...]:
    """The (dx, dy) pixels of cv2.circle(..., radius, thickness=1) around its
    centre: OpenCV's midpoint walk over one octant, mirrored eight ways."""
    pts = set()
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for x, y in ((dx, dy), (dy, dx)):
            pts |= {(x, y), (-x, y), (x, -y), (-x, -y)}
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return tuple(sorted(pts))


def matched_anchors(gt_boxes_norm: np.ndarray, threshold: float = 0.35) -> np.ndarray:
    """[P] bool: the default boxes facebox_encode matches to normalized
    point-form GT boxes (its conf is not 0)."""
    from fdt_torch.anchors.densified import facebox_default_boxes, facebox_encode
    gt = torch.from_numpy(np.asarray(gt_boxes_norm, np.float32).reshape(1, -1, 4))
    n = gt.shape[1]
    _, conf = facebox_encode(gt, torch.ones(1, n, dtype=torch.int64),
                             torch.ones(1, n, dtype=torch.bool),
                             torch.from_numpy(np.array(facebox_default_boxes())), threshold)
    return conf[0].numpy() != 0


def draw_matched_anchors(image_bgr: np.ndarray, gt_boxes_norm: np.ndarray,
                         save_prefix: str | None = None, threshold: float = 0.35):
    """FaceBoxes encoder debug view (DataEncoder.test_encode, encoderl.py:93-156).

    Per anchor scale group (the 32², 16² and 8² maps) the anchor centres:
    matched anchors as green circles of radius 4, the others as red circles
    of radius 1, over the GT boxes in green.  Returns the list of BGR
    images; with `save_prefix`, also writes `{prefix}_{i}.jpg` like the
    reference's test_encoder_{i}.jpg."""
    from PIL import Image, ImageDraw

    from fdt_torch.anchors.densified import facebox_default_boxes
    from fdt_torch.data.image_io import imwrite

    gt = np.asarray(gt_boxes_norm, np.float32).reshape(-1, 4)
    defaults = facebox_default_boxes()
    matched = matched_anchors(gt, threshold)
    s = image_bgr.shape[1]  # the reference scales by one side (encoderl.py:109)
    # an RGB-mode image over the BGR bytes: colours are given in BGR order
    base = Image.fromarray(np.ascontiguousarray(image_bgr))
    draw = ImageDraw.Draw(base)
    for box in gt:
        x1, y1, x2, y2 = (int(v * s) for v in box)
        draw.rectangle([min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2)],
                       outline=(0, 255, 0))
    n32, n16 = 32 * 32 * 21, 16 * 16
    groups = [(0, n32), (n32, n32 + n16), (n32 + n16, len(defaults))]
    out = []
    for gi, (lo, hi) in enumerate(groups):
        im = base.copy()
        draw = ImageDraw.Draw(im)
        for i in range(lo, hi):
            cx, cy = int(defaults[i, 0] * s), int(defaults[i, 1] * s)
            radius, colour = (4, (0, 255, 0)) if matched[i] else (1, (0, 0, 255))
            draw.point([(cx + dx, cy + dy) for dx, dy in circle_offsets(radius)], fill=colour)
        arr = np.asarray(im).copy()
        if save_prefix:
            imwrite(f"{save_prefix}_{gi}.jpg", arr)
        out.append(arr)
    return out
