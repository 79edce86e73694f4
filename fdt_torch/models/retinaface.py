"""RetinaFace with a ResNet-50 body (Deng et al., "RetinaFace: Single-stage
Dense Face Localisation in the Wild", arXiv:1905.00641), as
biubug6/Pytorch_Retinaface builds it (`cfg_re50`; models/retinaface.py and
models/net.py), at its published widths.

  body   torchvision's ResNet-50 to layer4 (the trunk of
         models/pyramidbox.py), returning C3, C4, C5: 512, 1024, 2048
         channels at strides 8, 16, 32
  fpn    1×1 conv → BN → ReLU laterals to 256 channels; P4 = merge2(P4 +
         nearest(P5)), P3 = merge1(P3 + nearest(P4)), each merge a 3×3 conv
         → BN → ReLU
  ssh1-3 one SSH a level: relu(cat[3×3 to 128; 3×3 to 64 → 3×3 to 64;
         that 64 → 3×3 → 3×3 to 64]), every conv 3×3 without bias and
         followed by BatchNorm, ReLU inside only after conv5X5_1 and conv7X7_2
  heads  ClassHead / BboxHead / LandmarkHead: a 1×1 conv with bias a level
         over 2 anchors (2·2, 2·4, 2·10 outputs), NHWC-flattened to
         [B, P, k] and the levels concatenated

Module names are biubug6's, so its state dict loads key for key
(`module.` stripped: fdt_torch.models.loader.load_retinaface).  LeakyReLU
with slope 0, as the 256-channel FPN and SSH build it, is a ReLU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fdt_torch.models import fused
from fdt_torch.models.common import batch_norm, conv
from fdt_torch.models.pyramidbox import resnet50_trunk, resnet_stem, stem_chains

ANCHORS = 2  # priors a cell, one a min_size


class ConvBN(nn.Sequential):
    """Conv → BatchNorm → ReLU, children 0, 1, 2; one cuDNN call where a
    Folding holds the conv (fused.py)."""

    def conv_chains(self):
        return [(self[0], self[1])]

    def forward(self, x):
        return fused.conv_bn(self[0], self[1], x)


def conv_bn(cin: int, cout: int, kernel: int = 3) -> ConvBN:
    """biubug6's conv_bn (3×3), conv_bn1X1 (kernel=1) and conv_bn_no_relu:
    conv without bias → BatchNorm → ReLU.  The SSH's conv_bn_no_relu
    branches take here the ReLU that biubug6 applies after their
    concatenation (ReLU distributes over it; nn.ReLU holds no state, so the
    state dict's names are biubug6's)."""
    return ConvBN(conv(cin, cout, kernel, 1, kernel // 2, bias=False), batch_norm(cout), nn.ReLU())


class ResNet50Body(nn.Module):
    """torchvision's ResNet-50 up to layer4; forward → (C3, C4, C5)."""

    def __init__(self):
        super().__init__()
        resnet50_trunk(self)

    def conv_chains(self):
        return stem_chains(self)

    def forward(self, x):
        c2 = self.layer1(resnet_stem(self, x))
        c3 = self.layer2(c2)
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)


class FPN(nn.Module):
    def __init__(self, in_channels=(512, 1024, 2048), out_channels: int = 256):
        super().__init__()
        self.output1 = conv_bn(in_channels[0], out_channels, 1)
        self.output2 = conv_bn(in_channels[1], out_channels, 1)
        self.output3 = conv_bn(in_channels[2], out_channels, 1)
        self.merge1 = conv_bn(out_channels, out_channels)
        self.merge2 = conv_bn(out_channels, out_channels)

    def forward(self, c3, c4, c5):
        p3, p4, p5 = self.output1(c3), self.output2(c4), self.output3(c5)
        p4 = self.merge2(p4 + F.interpolate(p5, size=p4.shape[-2:], mode="nearest"))
        p3 = self.merge1(p3 + F.interpolate(p4, size=p3.shape[-2:], mode="nearest"))
        return p3, p4, p5


class SSH(nn.Module):
    def __init__(self, in_channel: int = 256, out_channel: int = 256):
        super().__init__()
        quarter = out_channel // 4
        self.conv3X3 = conv_bn(in_channel, out_channel // 2)
        self.conv5X5_1 = conv_bn(in_channel, quarter)
        self.conv5X5_2 = conv_bn(quarter, quarter)
        self.conv7X7_2 = conv_bn(quarter, quarter)
        self.conv7x7_3 = conv_bn(quarter, quarter)  # sic: biubug6's name

    def forward(self, x):
        t = self.conv5X5_1(x)
        return torch.cat([self.conv3X3(x), self.conv5X5_2(t), self.conv7x7_3(self.conv7X7_2(t))],
                         dim=1)


class Head(nn.Module):
    """One level's ClassHead (k=2), BboxHead (k=4) or LandmarkHead (k=10)."""

    def __init__(self, in_channels: int, k: int):
        super().__init__()
        self.k = k
        self.conv1x1 = conv(in_channels, ANCHORS * k, 1)

    def forward(self, x):
        return self.conv1x1(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1, self.k)


class RetinaFace(nn.Module):
    """forward(x [B,3,H,W]) → dict:
      face_loc  [B, P, 4] float32     face_conf [B, P, 2] float32 (logits)
      face_landm [B, P, 10] float32   source_shapes ((f_width, f_height), ...)
    P = 2 · Σ f_width · f_height over the three levels, prior-major in the
    order of fdt_torch.anchors.retina_priors."""

    def __init__(self, out_channels: int = 256):
        super().__init__()
        self.body = ResNet50Body()
        self.fpn = FPN((512, 1024, 2048), out_channels)
        self.ssh1 = SSH(out_channels, out_channels)
        self.ssh2 = SSH(out_channels, out_channels)
        self.ssh3 = SSH(out_channels, out_channels)
        self.ClassHead = nn.ModuleList([Head(out_channels, 2) for _ in range(3)])
        self.BboxHead = nn.ModuleList([Head(out_channels, 4) for _ in range(3)])
        self.LandmarkHead = nn.ModuleList([Head(out_channels, 10) for _ in range(3)])

    def forward(self, x: torch.Tensor) -> dict:
        levels = self.fpn(*self.body(x))
        feats = [ssh(p) for ssh, p in zip((self.ssh1, self.ssh2, self.ssh3), levels)]

        def heads(modules):
            return torch.cat([h(f) for h, f in zip(modules, feats)], dim=1).float()
        return {"face_loc": heads(self.BboxHead), "face_conf": heads(self.ClassHead),
                "face_landm": heads(self.LandmarkHead),
                "source_shapes": tuple((f.shape[3], f.shape[2]) for f in feats)}
