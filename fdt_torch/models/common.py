"""Shared building blocks (counterpart of fdt/models/common.py:24-175).

NCHW modules; parameter names follow fdt's flax names with `__` → `.`,
which are the reference torch module paths.  BatchNorm eps is 1e-5.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv(cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
         *, bias: bool = True, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, padding, dilation=dilation,
                     bias=bias)


def batch_norm(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


def max_pool(x: torch.Tensor, kernel: int = 3, stride: int = 2,
             padding: int = 1) -> torch.Tensor:
    """MaxPool2d; torch pads with -inf, as fdt's max_pool does."""
    return F.max_pool2d(x, kernel, stride, padding)


class SSHContext(nn.Module):
    """SSH context module: 3×3 ‖ (dilated 3×3 → 3×3) ‖ (dilated → dilated → 3×3),
    concatenated to 2*xchannels channels."""

    def __init__(self, cin: int, xchannels: int = 256):
        super().__init__()
        xc = xchannels
        self.conv1 = conv(cin, xc, 3, 1, 1)
        self.conv2 = conv(cin, xc // 2, 3, 1, 2, dilation=2)
        self.conv2_1 = conv(xc // 2, xc // 2, 3, 1, 1)
        self.conv2_2 = conv(xc // 2, xc // 2, 3, 1, 2, dilation=2)
        self.conv2_2_1 = conv(xc // 2, xc // 2, 3, 1, 1)

    def forward(self, x):
        x1 = F.relu(self.conv1(x))
        x2 = F.relu(self.conv2(x))
        x2_1 = F.relu(self.conv2_1(x2))
        x2_2 = F.relu(self.conv2_2(x2))
        x2_2 = F.relu(self.conv2_2_1(x2_2))
        return torch.cat([x1, x2_1, x2_2], dim=1)


class ContextTexture(nn.Module):
    """LFPN top-down fusion: 1×1 convs + 2× bilinear upsample + crop + add."""

    def __init__(self, up_channels: int, main_in: int, main_channels: int):
        super().__init__()
        self.up_conv = conv(up_channels, main_channels, 1)
        self.main_conv = conv(main_in, main_channels, 1)

    def forward(self, up, main):
        up = self.up_conv(up)
        main = self.main_conv(main)
        h, w = up.shape[-2:]
        # half-pixel centres, as fdt's jax.image.resize(method="linear")
        res = F.interpolate(up, size=(2 * h, 2 * w), mode="bilinear",
                            align_corners=False)
        res = res[:, :, :main.shape[2], :main.shape[3]]
        return res + main


def max_in_out_conf(tmp_conf: torch.Tensor, first_source: bool) -> torch.Tensor:
    """PyramidBox max-in-out confidence, channels last: [B,H,W,4] → [B,H,W,2].

    Source 0: max over the first 3 channels is background, the 4th is face.
    Sources 1+: the 1st channel is background, max over the last 3 is face.
    """
    if first_source:
        neg = torch.amax(tmp_conf[..., :3], dim=-1, keepdim=True)
        pos = tmp_conf[..., 3:4]
    else:
        neg = tmp_conf[..., 0:1]
        pos = torch.amax(tmp_conf[..., 1:4], dim=-1, keepdim=True)
    return torch.cat([neg, pos], dim=-1)
