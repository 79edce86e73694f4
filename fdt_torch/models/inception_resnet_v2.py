"""Inception-ResNet-v2 (counterpart of fdt/models/inception_resnet_v2.py).

The reference ships this classifier at MTCNN/mtcnn/core/resnet_inception_v2.py
(BasicConv2d:8-20, Mixed_5b:23-51, Block35:54-84, Mixed_6a:87-106,
Block17:109-133, Mixed_7a:136-164, Block8:167-194, InceptionResnetV2:197-279);
no reference script imports it.  As in fdt, two generic modules read the
branch spec tables:

  * InceptionMix   parallel branches, channel concat (Mixed_5b/6a/7a).
  * ResidualScale  branches → concat → 1×1 'conv2d' → x + scale·out →
                   optional ReLU (Block35/17/8).

Module names are the reference's torch paths: a one-step branch is the
BasicConv2d `branch{i}` itself, a longer one the Sequential `branch{i}` whose
steps take its indices, pools included.  A reference state dict therefore
loads straight in (models.torch_convert), and loader.flax_paths /
from_jax_variables carry fdt's variables both ways.

Kept from the reference: BatchNorm eps 1e-3 with torch momentum 0 (running
statistics never move), AvgPool2d(3, 1, 1, count_include_pad=False), an
unpadded MaxPool2d(3, 2), no ReLU after the last Block8, and a final 8×8
average pool, which sets the input floor at 299².
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

# A branch is a tuple of steps; each step is
#   ("conv", features, kernel, stride, padding)  — BasicConv2d
#   ("avgpool",)                                 — AvgPool2d(3, 1, 1, count_include_pad=False)
#   ("maxpool",)                                 — MaxPool2d(3, stride=2)
# Mixed_5b (resnet_inception_v2.py:23-51)
MIXED_5B = (
    (("conv", 96, 1, 1, 0),),
    (("conv", 48, 1, 1, 0), ("conv", 64, 5, 1, 2)),
    (("conv", 64, 1, 1, 0), ("conv", 96, 3, 1, 1), ("conv", 96, 3, 1, 1)),
    (("avgpool",), ("conv", 64, 1, 1, 0)),
)
# Mixed_6a (resnet_inception_v2.py:87-106)
MIXED_6A = (
    (("conv", 384, 3, 2, 0),),
    (("conv", 256, 1, 1, 0), ("conv", 256, 3, 1, 1), ("conv", 384, 3, 2, 0)),
    (("maxpool",),),
)
# Mixed_7a (resnet_inception_v2.py:136-164)
MIXED_7A = (
    (("conv", 256, 1, 1, 0), ("conv", 384, 3, 2, 0)),
    (("conv", 256, 1, 1, 0), ("conv", 288, 3, 2, 0)),
    (("conv", 256, 1, 1, 0), ("conv", 288, 3, 1, 1), ("conv", 320, 3, 2, 0)),
    (("maxpool",),),
)
# Block35 / Block17 / Block8 branch plans (resnet_inception_v2.py:54-84,
# 109-133, 167-194).  (1,7)/(7,1) kernels carry tuple paddings.
BLOCK35 = (
    (("conv", 32, 1, 1, 0),),
    (("conv", 32, 1, 1, 0), ("conv", 32, 3, 1, 1)),
    (("conv", 32, 1, 1, 0), ("conv", 48, 3, 1, 1), ("conv", 64, 3, 1, 1)),
)
BLOCK17 = (
    (("conv", 192, 1, 1, 0),),
    (("conv", 128, 1, 1, 0), ("conv", 160, (1, 7), 1, (0, 3)),
     ("conv", 192, (7, 1), 1, (3, 0))),
)
BLOCK8 = (
    (("conv", 192, 1, 1, 0),),
    (("conv", 192, 1, 1, 0), ("conv", 224, (1, 3), 1, (0, 1)),
     ("conv", 256, (3, 1), 1, (1, 0))),
)


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-3, momentum 0) + ReLU
    (resnet_inception_v2.py:8-20)."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, momentum=0.0)
        self.relu = nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.relu(self.bn(self.conv(x)))


def _branch(spec, cin: int) -> tuple[nn.Module, int]:
    """One branch of a spec table → (its module, its output channels)."""
    steps, c = [], cin
    for step in spec:
        if step[0] == "avgpool":
            steps.append(nn.AvgPool2d(3, 1, 1, count_include_pad=False))
        elif step[0] == "maxpool":
            steps.append(nn.MaxPool2d(3, 2))
        else:
            _, features, kernel, stride, padding = step
            steps.append(BasicConv2d(c, features, kernel, stride, padding))
            c = features
    return (steps[0] if len(steps) == 1 else nn.Sequential(*steps)), c


class InceptionMix(nn.Module):
    """Parallel branches → channel concat (Mixed_5b/6a/7a)."""

    def __init__(self, branches, cin: int):
        super().__init__()
        self.out_channels = 0
        for i, spec in enumerate(branches):
            module, c = _branch(spec, cin)
            self.add_module(f"branch{i}", module)
            self.out_channels += c

    def branches(self, x: torch.Tensor) -> torch.Tensor:
        """The branches' outputs, concatenated over channels."""
        return torch.cat([m(x) for name, m in self.named_children()
                          if name.startswith("branch")], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.branches(x)


class ResidualScale(InceptionMix):
    """branches → concat → 1×1 'conv2d' (with bias) → x + scale·out →
    optional ReLU (Block35/17/8, resnet_inception_v2.py:76-84,126-133,186-194)."""

    def __init__(self, branches, channels: int, scale: float, relu: bool = True):
        super().__init__(branches, channels)
        self.conv2d = nn.Conv2d(self.out_channels, channels, 1)
        self.scale, self.relu = scale, relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2d(self.branches(x)) * self.scale + x
        return torch.relu(out) if self.relu else out


class InceptionResnetV2(nn.Module):
    """The full classifier (resnet_inception_v2.py:197-279): NCHW float
    images of at least 299² → [B, num_classes] logits.

    `repeats` sets the three residual towers (the reference's 10× Block35,
    20× Block17, 9× Block8), so that tests can build reduced ones."""

    def __init__(self, num_classes: int = 1001, repeats: Sequence[int] = (10, 20, 9)):
        super().__init__()
        self.conv2d_1a = BasicConv2d(3, 32, 3, 2)
        self.conv2d_2a = BasicConv2d(32, 32, 3, 1)
        self.conv2d_2b = BasicConv2d(32, 64, 3, 1, 1)
        self.maxpool_3a = nn.MaxPool2d(3, 2)
        self.conv2d_3b = BasicConv2d(64, 80, 1, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3, 1)
        self.maxpool_5a = nn.MaxPool2d(3, 2)
        self.mixed_5b = InceptionMix(MIXED_5B, 192)
        self.repeat = nn.Sequential(*[ResidualScale(BLOCK35, 320, 0.17)
                                      for _ in range(repeats[0])])
        self.mixed_6a = InceptionMix(MIXED_6A, 320)
        self.repeat_1 = nn.Sequential(*[ResidualScale(BLOCK17, 1088, 0.10)
                                        for _ in range(repeats[1])])
        self.mixed_7a = InceptionMix(MIXED_7A, 1088)
        self.repeat_2 = nn.Sequential(*[ResidualScale(BLOCK8, 2080, 0.20)
                                        for _ in range(repeats[2])])
        self.block8 = ResidualScale(BLOCK8, 2080, 1.0, relu=False)
        self.conv2d_7b = BasicConv2d(2080, 1536, 1, 1)
        self.avgpool_1a = nn.AvgPool2d(8, count_include_pad=False)
        self.classif = nn.Linear(1536, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool_3a(self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x))))
        x = self.maxpool_5a(self.conv2d_4a(self.conv2d_3b(x)))
        x = self.repeat(self.mixed_5b(x))
        x = self.repeat_1(self.mixed_6a(x))
        x = self.repeat_2(self.mixed_7a(x))
        x = self.conv2d_7b(self.block8(x))
        return self.classif(self.avgpool_1a(x).flatten(1))
