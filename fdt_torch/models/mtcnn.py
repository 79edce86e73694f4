"""MTCNN's cascade networks PNet, RNet and ONet (counterpart of
fdt/models/mtcnn.py:28-90).

NCHW modules whose names are the reference's torch paths (`pre_layer.0`,
`conv4_1`, ...), which are fdt's flax names with `__` spelled `.`.  Every
convolution is VALID (padding 0), every pool is MaxPool2d(k, s) in floor
mode without padding, and every PReLU holds one slope, as in fdt and the
reference.  Each net returns float32 sigmoid probabilities and regressions.

RNet and ONet flatten NCHW before their first Linear, as the reference does;
fdt flattens NHWC, so the loader permutes that Linear's input columns
(`flatten_chw` names the layer and the (C, H, W) it flattens).

The reference's PNet and RNet also define a landmark head that their forward
never runs (PNet.conv4_3, RNet.conv5_3; fdt/models/mtcnn.py:114-124).  The
port does not build it: `reference_extras` names its tensors and shapes, which
a reference state dict carries and models.torch_convert skips on a load and
writes zero-filled on an export, as fdt's mtcnn_export_extras does.
"""
from __future__ import annotations

import torch
from torch import nn


class PNet(nn.Module):
    """12×12-receptive-field proposal FCN → (probability map [B,1,H',W'],
    regression map [B,4,H',W'])."""

    flatten_chw: dict = {}
    reference_extras = {"conv4_3.weight": (10, 32, 1, 1), "conv4_3.bias": (10,)}

    def __init__(self):
        super().__init__()
        self.pre_layer = nn.Sequential(
            nn.Conv2d(3, 10, 3), nn.PReLU(), nn.MaxPool2d(2, 2),
            nn.Conv2d(10, 16, 3), nn.PReLU(),
            nn.Conv2d(16, 32, 3), nn.PReLU())
        self.conv4_1 = nn.Conv2d(32, 1, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x: torch.Tensor):
        x = self.pre_layer(x)
        return torch.sigmoid(self.conv4_1(x)).float(), self.conv4_2(x).float()


class RNet(nn.Module):
    """24×24 refinement net → (probability [B,1], regression [B,4])."""

    flatten_chw = {"conv4": (64, 2, 2)}
    reference_extras = {"conv5_3.weight": (10, 128), "conv5_3.bias": (10,)}

    def __init__(self):
        super().__init__()
        self.pre_layer = nn.Sequential(
            nn.Conv2d(3, 28, 3), nn.PReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(28, 48, 3), nn.PReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(48, 64, 2), nn.PReLU())
        self.conv4 = nn.Linear(64 * 2 * 2, 128)
        self.prelu4 = nn.PReLU()
        self.conv5_1 = nn.Linear(128, 1)
        self.conv5_2 = nn.Linear(128, 4)

    def forward(self, x: torch.Tensor):
        x = self.prelu4(self.conv4(self.pre_layer(x).flatten(1)))
        return torch.sigmoid(self.conv5_1(x)).float(), self.conv5_2(x).float()


class ONet(nn.Module):
    """48×48 output net → (probability [B,1], regression [B,4], landmarks
    [B,10])."""

    flatten_chw = {"conv5": (128, 2, 2)}

    def __init__(self):
        super().__init__()
        self.pre_layer = nn.Sequential(
            nn.Conv2d(3, 32, 3), nn.PReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(32, 64, 3), nn.PReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 64, 3), nn.PReLU(), nn.MaxPool2d(2, 2),
            nn.Conv2d(64, 128, 2), nn.PReLU())
        self.conv5 = nn.Linear(128 * 2 * 2, 256)
        self.prelu5 = nn.PReLU()
        self.conv6_1 = nn.Linear(256, 1)
        self.conv6_2 = nn.Linear(256, 4)
        self.conv6_3 = nn.Linear(256, 10)

    def forward(self, x: torch.Tensor):
        x = self.prelu5(self.conv5(self.pre_layer(x).flatten(1)))
        return (torch.sigmoid(self.conv6_1(x)).float(), self.conv6_2(x).float(),
                self.conv6_3(x).float())
