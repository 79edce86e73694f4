"""PyramidBox (S3FD + LFPN + SSH context + max-in-out) with a ResNet50
backbone (counterpart of fdt/models/pyramidbox.py:25-179).

NCHW throughout; the heads are fdt_torch.models.common's add_pyramid_heads
and face_outputs, shared with the mobile variants.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from fdt_torch.models import fused
from fdt_torch.models.common import (ContextTexture, NestedSequential, SSHContext,
                                     add_pyramid_heads, batch_norm, checkpoint,
                                     conv, face_outputs, max_pool)


class Bottleneck(nn.Module):
    """ResNet50 bottleneck.  Where a Folding holds its convs (fused.py) each
    runs as one cuDNN call: conv3's epilogue takes bn3, the downsample's
    folded bias, the shortcut's add and the ReLU."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        p = planes
        self.conv1 = conv(cin, p, 1, bias=False)
        self.bn1 = batch_norm(p)
        self.conv2 = conv(p, p, 3, stride, 1, bias=False)
        self.bn2 = batch_norm(p)
        self.conv3 = conv(p, 4 * p, 1, bias=False)
        self.bn3 = batch_norm(4 * p)
        self.downsample = None
        if stride != 1 or cin != 4 * p:
            self.downsample = nn.Sequential(conv(cin, 4 * p, 1, stride, bias=False),
                                            batch_norm(4 * p))

    def conv_chains(self):
        last = (self.conv3, self.bn3, *(self.downsample or ()))
        return [(self.conv1, self.bn1), (self.conv2, self.bn2), last]

    def forward(self, x):
        out = fused.conv_bn(self.conv1, self.bn1, x)
        out = fused.conv_bn(self.conv2, self.bn2, out)
        sc = x if self.downsample is None else fused.conv_bn(*self.downsample, x, relu=False)
        return fused.conv_bn(self.conv3, self.bn3, out, add=sc)


def _resnet_stage(cin: int, num_blocks: int, planes: int, stride: int) -> NestedSequential:
    return NestedSequential(*[Bottleneck(cin if i == 0 else 4 * planes, planes,
                                      stride if i == 0 else 1)
                           for i in range(num_blocks)])


def resnet50_trunk(module: nn.Module, num_blocks: Sequence[int] = (3, 4, 6, 3)) -> None:
    """Register torchvision's ResNet-50 (v1.5: the stride on the 3×3) on
    `module` as `conv1`, `bn1`, `layer1` … `layer4`: the stem's conv 7×7/2
    and BatchNorm, then the bottleneck stages of 256, 512, 1024 and 2048
    channels at strides 4, 8, 16 and 32."""
    module.conv1 = conv(3, 64, 7, 2, 3, bias=False)
    module.bn1 = batch_norm(64)
    module.layer1 = _resnet_stage(64, num_blocks[0], 64, 1)
    module.layer2 = _resnet_stage(256, num_blocks[1], 128, 2)
    module.layer3 = _resnet_stage(512, num_blocks[2], 256, 2)
    module.layer4 = _resnet_stage(1024, num_blocks[3], 512, 2)


def stem_chains(module: nn.Module) -> list:
    """The conv chain of the stem that resnet50_trunk registered on `module`."""
    return [(module.conv1, module.bn1)]


def resnet_stem(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The stem of a module that resnet50_trunk built: conv 7×7/2 → BN →
    ReLU → max-pool 3/2/1 (the module keeps the pool's input height on a
    space mesh)."""
    return max_pool(fused.conv_bn(module.conv1, module.bn1, x), 3, 2, 1, owner=module)


class ExtraLayer(NestedSequential):
    """conv1×1 → bn → relu → conv3×3/2 → bn → relu (ReLUs at indices 2 and 5);
    each conv's bias folds into its BatchNorm's shift (fused.py)."""

    def __init__(self, cin: int, mid: int, out: int):
        super().__init__(conv(cin, mid, 1), batch_norm(mid), nn.ReLU(),
                         conv(mid, out, 3, 2, 1), batch_norm(out), nn.ReLU())

    def conv_chains(self):
        return [(self[0], self[1]), (self[3], self[4])]

    def forward(self, x):
        return fused.conv_bn(self[3], self[4], fused.conv_bn(self[0], self[1], x))


class PyramidBox(nn.Module):
    """forward(x [B,3,H,W], heads=False) → dict:
      face_loc  [B, P, 4] float32    face_conf [B, P, 2] float32 (logits,
      max-in-out applied)            source_shapes: ((f_width, f_height), ...)
      head_loc  [B, Ph, 4], head_conf [B, Ph, 2] float32 with `heads`
      features  [c2, ..., c7], sources (the six SSH maps), NCHW, with
                `features` (net2net distillation's taps)

    remat: while gradients are recorded, every Bottleneck and extra layer is
    checkpointed (fdt's per-block nn.remat), so only block-boundary
    activations stay live; the parameters and outputs are unchanged.
    """

    _SSH_IN = {"conv2_SSH": 256, "conv3_SSH": 512, "conv4_SSH": 1024,
               "conv5_SSH": 2048, "conv6_SSH": 512, "conv7_SSH": 256}

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3), remat: bool = False):
        super().__init__()
        self.remat = remat
        resnet50_trunk(self, num_blocks)
        self.layer5 = ExtraLayer(2048, 512, 512)
        self.layer6 = ExtraLayer(512, 128, 256)

        self.latlayer_fc = conv(2048, 2048, 1)
        self.latlayer_c6 = conv(512, 512, 1)
        self.latlayer_c7 = conv(256, 256, 1)
        self.conv5_ct_py = ContextTexture(2048, 1024, 1024)
        self.conv4_ct_py = ContextTexture(1024, 512, 512)
        self.conv3_ct_py = ContextTexture(512, 256, 256)
        self.smooth_c3 = conv(256, 256, 3, 1, 1)
        self.smooth_c4 = conv(512, 512, 3, 1, 1)
        self.smooth_c5 = conv(1024, 1024, 3, 1, 1)
        for name, cin in self._SSH_IN.items():
            self.add_module(name, SSHContext(cin, 256))

        add_pyramid_heads(self, 6, 512)

    def conv_chains(self):
        # try1 shares the SSH and declares no chain: folded, its held score
        # bias drifts from float32's by 0.0014-0.0016 (PERF.md §6)
        return stem_chains(self) + [c for name in self._SSH_IN
                                    for c in getattr(self, name).relu_chains()]

    def _blocks(self, blocks, x):
        remat = self.remat and torch.is_grad_enabled()
        for block in blocks:
            x = checkpoint(block, x) if remat else block(x)
        return x

    def forward(self, x: torch.Tensor, heads: bool = False, features: bool = False) -> dict:
        c1 = resnet_stem(self, x)
        c2 = self._blocks(self.layer1, c1)
        c3 = self._blocks(self.layer2, c2)
        c4 = self._blocks(self.layer3, c3)
        c5 = self._blocks(self.layer4, c4)
        c6 = self._blocks([self.layer5], c5)
        c7 = self._blocks([self.layer6], c6)

        c5_lat = self.latlayer_fc(c5)
        c6_lat = self.latlayer_c6(c6)
        c7_lat = self.latlayer_c7(c7)
        c4_fuse = self.conv5_ct_py(c5_lat, c4)
        c3_fuse = self.conv4_ct_py(c4_fuse, c3)
        c2_fuse = self.conv3_ct_py(c3_fuse, c2)
        c2_fuse = self.smooth_c3(c2_fuse)
        c3_fuse = self.smooth_c4(c3_fuse)
        c4_fuse = self.smooth_c5(c4_fuse)

        sources = [self.conv2_SSH(c2_fuse), self.conv3_SSH(c3_fuse),
                   self.conv4_SSH(c4_fuse), self.conv5_SSH(c5_lat),
                   self.conv6_SSH(c6_lat), self.conv7_SSH(c7_lat)]

        return face_outputs(self, sources, heads,
                            [c2, c3, c4, c5, c6, c7] if features else None)
