"""Convolution operations of one image of a cell, counted from the
reference's frozen architecture and the weight file's shapes
(portbench.reference.pyramidbox.conv_flops): the same count whatever
implements the network."""
from __future__ import annotations

import functools

from portbench.reference.pyramidbox import conv_flops, weight_shapes


@functools.lru_cache(maxsize=None)
def flops_per_image(variant: str, weights_path: str, height: int, width: int) -> int:
    return conv_flops(variant, weight_shapes(weights_path), height, width)
