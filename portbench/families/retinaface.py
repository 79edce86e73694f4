"""RetinaFace-ResNet50 (biubug6/Pytorch_Retinaface's cfg_re50): seeded
weights in biubug6's state-dict names from the configuration's
"weights_seed" (portbench.reference.retinaface.seeded_state_dict), written
to a `.pth` during set-up and loaded through the program's own loader, in
the configuration's "dtype", with its "budget" and "top_k"."""
from __future__ import annotations

import dataclasses
import os
import tempfile

import torch

from portbench.reference.retinaface import ReferenceDetector, conv_flops, seeded_state_dict

SERVICE = "retinaface"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(cell, quant=None):
    from fdt_torch.config import RETINA_RES50
    from fdt_torch.models.loader import load_retinaface_detector

    c = cell.config
    detect_cfg = dataclasses.replace(RETINA_RES50.detect, top_k=c["top_k"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "Resnet50_seeded.pth")
        torch.save(seeded_state_dict(c["weights_seed"]), path)
        return load_retinaface_detector(path, dtype=DTYPES[c["dtype"]], device=cell.device,
                                        budget=c["budget"], detect_cfg=detect_cfg, quant=quant)


def reference(cell):
    return ReferenceDetector(seeded_state_dict(cell.config["weights_seed"]), cell.device)


def flops_per_image(cell) -> int:
    return conv_flops(cell.traffic["height"], cell.traffic["width"])
