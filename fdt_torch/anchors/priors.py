"""Vectorized SSD prior (anchor) generation (copy of fdt/anchors/priors.py).

Priors are a pure function of static shapes, generated with numpy once per
(config, feature-shape, image-shape) and cached.  Row order is row-major over
(i=rows, j=cols), then scale, then aspect ratio — [cx, cy, side_x, side_y]
center form, normalized by image width/height.  The arithmetic is float64
cast to float32, so the priors are bit-equal to fdt's.
"""
from __future__ import annotations

import functools

import numpy as np

from fdt_torch.config import PriorConfig, PyramidConfig, RetinaConfig


@functools.lru_cache(maxsize=None)
def _prior_grid_cached(strides, boxes, scales, aspect_ratios,
                       idx: int, f_width: int, f_height: int,
                       width: int, height: int) -> np.ndarray:
    stride, box, n_scale = strides[idx], boxes[idx], scales[idx]
    ars = aspect_ratios[idx]
    j = (np.arange(f_width, dtype=np.float64) + 0.5) * stride / width    # [W]
    i = (np.arange(f_height, dtype=np.float64) + 0.5) * stride / height  # [H]
    cx = np.broadcast_to(j[None, :], (f_height, f_width))
    cy = np.broadcast_to(i[:, None], (f_height, f_width))

    per_cell = []
    for s in range(n_scale):
        box_scale = (2 ** (1 / 3)) ** s
        sx = box * box_scale / width
        sy = box * box_scale / height
        per_cell.append((sx, sy))
        for ar in ars:
            per_cell.append((sx / np.sqrt(ar), sy * np.sqrt(ar)))

    k = len(per_cell)
    out = np.empty((f_height, f_width, k, 4), dtype=np.float64)
    out[..., 0] = cx[..., None]
    out[..., 1] = cy[..., None]
    for a, (sx, sy) in enumerate(per_cell):
        out[..., a, 2] = sx
        out[..., a, 3] = sy
    out = out.reshape(-1, 4).astype(np.float32)
    out.flags.writeable = False  # cached: shared by every caller
    return out


def prior_grid(cfg: PriorConfig, idx: int, f_width: int, f_height: int,
               width: int, height: int) -> np.ndarray:
    """Priors for one source map: [f_height * f_width * k, 4] center form."""
    return _prior_grid_cached(cfg.strides, cfg.boxes, cfg.scales, cfg.aspect_ratios,
                              idx, f_width, f_height, width, height)


def feature_map_sizes(width: int, height: int, strides) -> list[tuple[int, int]]:
    """(f_width, f_height) per stride: every downsampling of the backbone
    computes out = floor((in - 1) / 2) + 1 = ceil(in / 2)."""
    shapes = []
    for s in strides:
        fw, fh = width, height
        t = s
        while t > 1:
            fw = (fw - 1) // 2 + 1
            fh = (fh - 1) // 2 + 1
            t //= 2
        shapes.append((fw, fh))
    return shapes


def pyramid_face_priors(cfg: PyramidConfig, source_shapes, width: int, height: int) -> np.ndarray:
    """Concatenated face priors over all source maps.

    source_shapes: [(f_width, f_height)] per source, from the model's forward.
    """
    parts = [prior_grid(cfg.face_priors, idx, fw, fh, width, height)
             for idx, (fw, fh) in enumerate(source_shapes)]
    return np.concatenate(parts, axis=0)


def pyramid_head_priors(cfg: PyramidConfig, source_shapes, width: int, height: int) -> np.ndarray:
    """Concatenated head-supervision priors over sources[1:]."""
    parts = [prior_grid(cfg.head_priors, idx - 1, fw, fh, width, height)
             for idx, (fw, fh) in enumerate(source_shapes) if idx > 0]
    return np.concatenate(parts, axis=0)


def retina_priors(cfg: RetinaConfig, source_shapes, width: int, height: int) -> np.ndarray:
    """RetinaFace's priors (biubug6's layers/functions/prior_box.py): for each
    source map in turn its cells row-major, each cell's `min_sizes` in order,
    [cx, cy, s/W, s/H] with centre ((j + 0.5)·step/W, (i + 0.5)·step/H),
    unclipped; float64 arithmetic cast to float32.

    source_shapes: [(f_width, f_height)] per source, from the model's
    forward (ceil(W/step) × ceil(H/step) for RetinaFace's ResNet-50)."""
    parts = []
    for (fw, fh), step, sizes in zip(source_shapes, cfg.steps, cfg.min_sizes):
        cx = (np.arange(fw, dtype=np.float64) + 0.5) * step / width
        cy = (np.arange(fh, dtype=np.float64) + 0.5) * step / height
        p = np.empty((fh, fw, len(sizes), 4), np.float64)
        p[..., 0] = cx[None, :, None]
        p[..., 1] = cy[:, None, None]
        p[..., 2] = np.asarray(sizes, np.float64) / width
        p[..., 3] = np.asarray(sizes, np.float64) / height
        parts.append(p.reshape(-1, 4))
    return np.concatenate(parts).astype(np.float32)
