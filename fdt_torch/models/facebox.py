"""FaceBoxes network (counterpart of fdt/models/facebox.py).

RDCL (CReLU stem) → 3×Inception → strided necks → multibox heads.  NCHW;
the heads permute to channels-last before reshaping, so the 21 anchors per
cell of layer 0 come out in fdt's NHWC order.  Module names are fdt's flax
names with `__` → `.` (the reference's torch paths, `multilbox` included).

Input: [B, 3, S, S] float (BGR / 255).  Output: loc [B, P, 4], conf [B, P, 2]
(logits), float32; P = 21824 at S = 1024.
"""
from __future__ import annotations

import torch
from torch import nn

from fdt_torch.models.common import ConvBNReLU, batch_norm, conv, crelu, max_pool


class Inception(nn.Module):
    """4-branch 128→128 inception block."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvBNReLU(128, 32, 1)
        self.conv2 = ConvBNReLU(128, 32, 1)
        self.conv3 = ConvBNReLU(128, 24, 1)
        self.conv4 = ConvBNReLU(24, 32, 3, padding=1)
        self.conv5 = ConvBNReLU(128, 24, 1)
        self.conv6 = ConvBNReLU(24, 32, 3, padding=1)
        self.conv7 = ConvBNReLU(32, 32, 3, padding=1)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(max_pool(x, 3, 1, 1))
        x3 = self.conv4(self.conv3(x))
        x4 = self.conv7(self.conv6(self.conv5(x)))
        return torch.cat([x1, x2, x3, x4], dim=1)


class MultiBoxHeads(nn.Module):
    """Per-source 3×3 loc/conf heads."""

    num_anchors = (21, 1, 1)
    in_channels = (128, 256, 256)

    def __init__(self):
        super().__init__()
        self.loc_layers = nn.ModuleList(
            [conv(c, a * 4, 3, 1, 1) for c, a in zip(self.in_channels, self.num_anchors)])
        self.conf_layers = nn.ModuleList(
            [conv(c, a * 2, 3, 1, 1) for c, a in zip(self.in_channels, self.num_anchors)])

    def forward(self, xs):
        b = xs[0].shape[0]
        locs = [layer(x).permute(0, 2, 3, 1).reshape(b, -1, 4)
                for layer, x in zip(self.loc_layers, xs)]
        confs = [layer(x).permute(0, 2, 3, 1).reshape(b, -1, 2)
                 for layer, x in zip(self.conf_layers, xs)]
        return torch.cat(locs, 1), torch.cat(confs, 1)


class FaceBox(nn.Module):
    """forward(x [B,3,S,S]) → (loc [B,P,4], conf [B,P,2]) float32."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 24, 7, 4, 3)
        self.bn1 = batch_norm(24)
        self.conv2 = conv(48, 64, 5, 2, 2)
        self.bn2 = batch_norm(64)
        self.inception1 = Inception()
        self.inception2 = Inception()
        self.inception3 = Inception()
        self.conv3_1 = ConvBNReLU(128, 128, 1)
        self.conv3_2 = ConvBNReLU(128, 256, 3, 2, 1)
        self.conv4_1 = ConvBNReLU(256, 128, 1)
        self.conv4_2 = ConvBNReLU(128, 256, 3, 2, 1)
        self.multilbox = MultiBoxHeads()

    def forward(self, x):
        # RDCL: the direct convs (fdt's s2d stem is a TPU rearrangement of them)
        x = max_pool(crelu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = max_pool(crelu(self.bn2(self.conv2(x))), 3, 2, 1)
        # MSCL and the heads
        x = self.inception3(self.inception2(self.inception1(x)))
        hs = [x]
        x = self.conv3_2(self.conv3_1(x))
        hs.append(x)
        x = self.conv4_2(self.conv4_1(x))
        hs.append(x)
        loc, conf = self.multilbox(hs)
        return loc.float(), conf.float()
