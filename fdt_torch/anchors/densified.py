"""FaceBoxes anchor-densification default boxes (copy of
fdt/anchors/densified.py:1-41).

The 21,824-box grid of the 1024² config, in its enumeration order: per
layer, the (h, w) cells, then the aspect ratios, then the density offsets
(dx outer, dy inner) on layer 0 only.  Center form, normalized by the input
size; float64 arithmetic cast to float32, bit-equal to fdt's.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np

from fdt_torch.config import FACEBOX, FaceBoxConfig


@functools.lru_cache(maxsize=None)
def _facebox_default_boxes_cached(cfg: FaceBoxConfig) -> np.ndarray:
    scale = float(cfg.input_size)
    steps = [s / scale for s in cfg.steps]
    sizes = [s / scale for s in cfg.sizes]
    boxes = []
    for i, fmsize in enumerate(cfg.feature_map_sizes):
        for h, w in itertools.product(range(fmsize), repeat=2):
            cx = (w + 0.5) * steps[i]
            cy = (h + 0.5) * steps[i]
            s = sizes[i]
            for j, ar in enumerate(cfg.aspect_ratios[i]):
                if i == 0:
                    for dx, dy in itertools.product(cfg.density[j], repeat=2):
                        boxes.append((cx + dx / 8.0 * s * ar, cy + dy / 8.0 * s * ar,
                                      s * ar, s * ar))
                else:
                    boxes.append((cx, cy, s * ar, s * ar))
    out = np.array(boxes, dtype=np.float32)
    out.flags.writeable = False  # cached: shared by every caller
    return out


def facebox_default_boxes(cfg: FaceBoxConfig = FACEBOX) -> np.ndarray:
    """[21824, 4] center-form default boxes for the 1024² config (read-only)."""
    return _facebox_default_boxes_cached(cfg)
