"""PyramidBox detectors: the ResNet50 flagship ("repo") and the MobileNet
trunk "try1", chosen by the configuration's "variant"; weights from the
npz its "weights" names, in its "dtype", with its "budget" and "top_k"."""
from __future__ import annotations

import dataclasses

import torch

from portbench.metrics._flops import flops_per_image as _flops

SERVICE = "pyramidbox"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(cell, quant=None):
    from fdt_torch.config import PYRAMID_CONFIGS
    from fdt_torch.models.loader import load_pyramidbox_detector

    c = cell.config
    detect_cfg = dataclasses.replace(PYRAMID_CONFIGS[c["variant"]].detect, top_k=c["top_k"])
    return load_pyramidbox_detector(c["variant"], str(cell.root / c["weights"]),
                                    detect_cfg=detect_cfg, budget=c["budget"],
                                    dtype=DTYPES[c["dtype"]], device=cell.device, quant=quant)


def reference(cell):
    from portbench.reference.detect import ReferenceDetector

    return ReferenceDetector(str(cell.root / cell.config["weights"]), cell.config["variant"],
                             cell.device)


def flops_per_image(cell) -> int:
    t = cell.traffic
    return _flops(cell.config["variant"], str(cell.root / cell.config["weights"]),
                  t["height"], t["width"])
