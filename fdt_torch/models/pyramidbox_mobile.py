"""PyramidBox mobile variants try1…try5 (counterpart of
fdt/models/pyramidbox_mobile.py).

  try1  hand-built MobileNet trunk mimicking the ResNet50 channel plan
  try2  thin 64/128/256/512 trunk + per-stage 1×1 channel expanders
  try3  stock MobileNetV2 `features` tapped at 4 stages + an extra S64 block,
        5 source maps, 128-channel SSH
  try4  try3 with a 7×7/pad-1 stem and InvertedResidual-augmented smooths,
        whose 1×1/pad-1 smooth convs grow the maps they smooth
  try5  try4 with the 3×3 stem and the 3×3 smooth_c5 restored

NCHW; module names are fdt's flax names with `__` → `.`, so flax weights
carry across mechanically (fdt_torch.models.loader).  Every variant returns
the output of fdt_torch.models.pyramidbox.PyramidBox; the head-supervision
branch is computed only with `heads=True` (training), the distillation taps
only with `features=True` (net2net): try1/try2 tap c2..c7 (try2's after its
channel expanders), try3-try5 c2..c6 after their smoothing convs, as fdt
taps them.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from fdt_torch.models.common import (ContextTexture, SSHContext,
                                     add_pyramid_heads, batch_norm, conv,
                                     face_outputs, max_pool)
from fdt_torch.models.pyramidbox import PyramidBox


class MobileNetV1Block(nn.Module):
    """Depthwise-separable conv: dw → bn → relu → pw (children conv1, bn, conv2)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, dilation: int = 1, bias: bool = False):
        super().__init__()
        self.conv1 = conv(cin, cin, kernel, stride, padding, dilation=dilation,
                          groups=cin, bias=bias)
        self.bn = batch_norm(cin)
        self.conv2 = conv(cin, features, 1, bias=False)

    def forward(self, x):
        return self.conv2(F.relu(self.bn(self.conv1(x))))


class MobileNetV2Block(nn.Module):
    """Inverted residual: pw-expand → dw → pw-linear, with the input added
    when side_way (children conv1/bn1 … conv3/bn3)."""

    def __init__(self, cin: int, features: int, t: int = 2, kernel: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 side_way: bool = False, bias: bool = False):
        super().__init__()
        hidden = cin * t
        self.side_way = side_way
        self.conv1 = conv(cin, hidden, 1, bias=False)
        self.bn1 = batch_norm(hidden)
        self.conv2 = conv(hidden, hidden, kernel, stride, padding, dilation=dilation,
                          groups=hidden, bias=bias)
        self.bn2 = batch_norm(hidden)
        self.conv3 = conv(hidden, features, 1, bias=False)
        self.bn3 = batch_norm(features)

    def forward(self, x):
        y = F.relu6(self.bn1(self.conv1(x)))
        y = F.relu6(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return y + x if self.side_way else y


class InvertedResidual(nn.Module):
    """Stock MobileNetV2 inverted residual: child `conv`, a Sequential whose
    ReLU6s sit at indices 2 (and 5) as in the torch reference."""

    def __init__(self, cin: int, features: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = round(cin * expand_ratio)
        self.use_res = stride == 1 and cin == features
        dw = [conv(hidden, hidden, 3, stride, 1, groups=hidden, bias=False),
              batch_norm(hidden), nn.ReLU6()]
        pw = [conv(hidden, features, 1, bias=False), batch_norm(features)]
        expand = ([] if expand_ratio == 1 else
                  [conv(cin, hidden, 1, bias=False), batch_norm(hidden), nn.ReLU6()])
        self.conv = nn.Sequential(*expand, *dw, *pw)

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_res else y


class PyramidBoxMobileV1(nn.Module):
    """try1/try2: hand-built MobileNet trunks with the full 6-source
    PyramidBox neck."""

    def __init__(self, variant: str = "try1"):
        super().__init__()
        if variant not in ("try1", "try2"):
            raise ValueError(f"unknown V1 variant: {variant}")
        m2, seq = MobileNetV2Block, nn.Sequential
        self.try2 = variant == "try2"
        self.conv1_my = MobileNetV1Block(3, 64, 7, 2, 3)
        self.bn1 = batch_norm(64)
        if not self.try2:  # t = 2 everywhere
            self.layer1_my = seq(m2(64, 64, 2, side_way=True), m2(64, 64, 2, side_way=True),
                                 m2(64, 256, 2))
            self.layer2_my = seq(m2(256, 64, 2, 5, 2, 2), m2(64, 512, 2, 3, 1, 2, dilation=2))
            self.layer3_my = seq(m2(512, 256, 2, 5, 2, 2),
                                 m2(256, 256, 2, 5, 1, 2, side_way=True),
                                 m2(256, 1024, 2, 3, 1, 2, dilation=2))
            self.layer4_my = seq(m2(1024, 256, 2, 5, 2, 2), m2(256, 2048, 2, 3, 1, 1))
            self.layer5_my = m2(2048, 512, 2, 3, 2)
            self.layer6_my = m2(512, 256, 2, 3, 2)
            smooth_bias = False
        else:              # t = 4 by default, 1×1 channel expanders after the trunk
            self.layer1_my = seq(*[m2(64, 64, 4, side_way=True) for _ in range(3)])
            self.layer2_my = seq(m2(64, 64, 4, 3, 2), m2(64, 64, 4, side_way=True),
                                 m2(64, 64, 4, side_way=True), m2(64, 128, 4))
            self.layer3_my = seq(m2(128, 128, 2, 3, 2),
                                 *[m2(128, 128, 2, side_way=True) for _ in range(4)],
                                 m2(128, 256, 2))
            self.layer4_my = seq(m2(256, 256, 4, 3, 2), m2(256, 256, 4, side_way=True),
                                 m2(256, 512, 4))
            self.layer5_my = m2(512, 512, 4, 3, 2, bias=True)
            self.layer6_my = m2(512, 256, 4, 3, 2, bias=True)
            self.layer1_adj = conv(64, 256, 1, bias=False)
            self.layer2_adj = conv(128, 512, 1, bias=False)
            self.layer3_adj = conv(256, 1024, 1, bias=False)
            self.layer4_adj = conv(512, 2048, 1, bias=False)
            smooth_bias = True

        # LFPN with grouped lateral 1×1s
        self.latlayer_fc_my = conv(2048, 2048, 1, groups=4)
        self.latlayer_c6_my = conv(512, 512, 1, groups=2)
        self.latlayer_c7_my = conv(256, 256, 1)
        self.conv5_ct_py = ContextTexture(2048, 1024, 1024)
        self.conv4_ct_py = ContextTexture(1024, 512, 512)
        self.conv3_ct_py = ContextTexture(512, 256, 256)
        self.smooth_c3_my = MobileNetV1Block(256, 256, bias=smooth_bias)
        self.smooth_c4_my = MobileNetV1Block(512, 512, bias=smooth_bias)
        self.smooth_c5_my = MobileNetV1Block(1024, 1024, bias=smooth_bias)
        for name, cin in (("conv2_SSH", 256), ("conv3_SSH", 512), ("conv4_SSH", 1024),
                          ("conv5_SSH", 2048), ("conv6_SSH", 512), ("conv7_SSH", 256)):
            self.add_module(name, SSHContext(cin, 256))
        add_pyramid_heads(self, 6, 512)

    def forward(self, x, heads: bool = False, features: bool = False) -> dict:
        c1 = max_pool(F.relu(self.bn1(self.conv1_my(x))), 3, 2, 1, owner=self)
        c2 = self.layer1_my(c1)
        c3 = self.layer2_my(c2)
        c4 = self.layer3_my(c3)
        c5 = self.layer4_my(c4)
        c6 = self.layer5_my(c5)
        c7 = self.layer6_my(c6)
        if self.try2:
            c2, c3 = self.layer1_adj(c2), self.layer2_adj(c3)
            c4, c5 = self.layer3_adj(c4), self.layer4_adj(c5)

        c5_lat = self.latlayer_fc_my(c5)
        c6_lat = self.latlayer_c6_my(c6)
        c7_lat = self.latlayer_c7_my(c7)
        c4_fuse = self.conv5_ct_py(c5_lat, c4)
        c3_fuse = self.conv4_ct_py(c4_fuse, c3)
        c2_fuse = self.conv3_ct_py(c3_fuse, c2)
        c2_fuse = self.smooth_c3_my(c2_fuse)
        c3_fuse = self.smooth_c4_my(c3_fuse)
        c4_fuse = self.smooth_c5_my(c4_fuse)

        sources = [self.conv2_SSH(c2_fuse), self.conv3_SSH(c3_fuse),
                   self.conv4_SSH(c4_fuse), self.conv5_SSH(c5_lat),
                   self.conv6_SSH(c6_lat), self.conv7_SSH(c7_lat)]
        return face_outputs(self, sources, heads,
                            [c2, c3, c4, c5, c6, c7] if features else None)


# MobileNetV2 (expand ratio, channels, blocks, first stride) per group
_MB2_CFGS = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]
_MB2_TAPS = (3, 6, 13, 17)  # features.<i> outputs that become c2, c3, c4, c5


class PyramidBoxMobileV2(nn.Module):
    """try3/try4/try5: stock MobileNetV2 backbone, 5 source maps, 128-ch SSH."""

    def __init__(self, variant: str = "try3"):
        super().__init__()
        if variant not in ("try3", "try4", "try5"):
            raise ValueError(f"unknown V2 variant: {variant}")
        stem_k = 7 if variant == "try4" else 3  # the 7×7/pad-1 stem quirk of try4
        features = [nn.Sequential(conv(3, 32, stem_k, 2, 1, bias=False), batch_norm(32),
                                  nn.ReLU6())]
        cin = 32
        for t, c, n, s in _MB2_CFGS:
            for i in range(n):
                features.append(InvertedResidual(cin, c, s if i == 0 else 1, t))
                cin = c
        self.features = nn.Sequential(*features)
        self.layer6 = InvertedResidual(320, 160, 2, 6)

        # try4 / try5: 1×1 convs with padding 1, which grow the maps by 2
        k6, k5 = {"try4": (1, 1), "try5": (1, 3)}.get(variant, (3, 3))
        self.smooth_c6 = conv(160, 160, k6, 1, 1)
        self.smooth_c5 = conv(320, 320, k5, 1, 1)
        self.conv4_ct_py = ContextTexture(320, 96, 96)
        self.conv3_ct_py = ContextTexture(96, 32, 32)
        self.conv2_ct_py = ContextTexture(32, 24, 24)
        for name, ch, t in (("smooth_c2", 24, 4), ("smooth_c3", 32, 4), ("smooth_c4", 96, 2)):
            smooth = conv(ch, ch, 3, 1, 1)
            if variant in ("try4", "try5"):
                smooth = nn.Sequential(InvertedResidual(ch, ch, 1, t), smooth)
            self.add_module(name, smooth)
        for name, cin in (("conv2_SSH", 24), ("conv3_SSH", 32), ("conv4_SSH", 96),
                          ("conv5_SSH", 320), ("conv6_SSH", 160)):
            self.add_module(name, SSHContext(cin, 128))
        add_pyramid_heads(self, 5, 256)

    def forward(self, x, heads: bool = False, features: bool = False) -> dict:
        taps = []
        h = x
        for i, block in enumerate(self.features):
            h = block(h)
            if i in _MB2_TAPS:
                taps.append(h)
        c2, c3, c4, c5 = taps
        c6 = self.smooth_c6(self.layer6(c5))
        c5 = self.smooth_c5(c5)
        c4 = self.conv4_ct_py(c5, c4)
        c3 = self.conv3_ct_py(c4, c3)
        c2 = self.conv2_ct_py(c3, c2)
        c2 = self.smooth_c2(c2)
        c3 = self.smooth_c3(c3)
        c4 = self.smooth_c4(c4)
        sources = [self.conv2_SSH(c2), self.conv3_SSH(c3), self.conv4_SSH(c4),
                   self.conv5_SSH(c5), self.conv6_SSH(c6)]
        return face_outputs(self, sources, heads, [c2, c3, c4, c5, c6] if features else None)


def build_pyramidbox(variant: str, remat: bool = False) -> nn.Module:
    """The model of any PyramidBox variant: "repo" (ResNet50) or try1…try5.

    remat: per-block checkpointing, flagship only, as fdt's build_pyramidbox (the
    trainer checkpoints a mobile variant's whole forward instead)."""
    if variant == "repo":
        return PyramidBox(remat=remat)
    if remat:
        raise ValueError("remat is only wired for the 'repo' flagship")
    if variant in ("try1", "try2"):
        return PyramidBoxMobileV1(variant)
    if variant in ("try3", "try4", "try5"):
        return PyramidBoxMobileV2(variant)
    raise ValueError(f"unknown PyramidBox variant: {variant}")
