"""Plain float32 PyramidBox forward: the ResNet50 flagship ("repo") and the
MobileNet trunk "try1", written from the architecture (Tang et al., ECCV
2018, arXiv:1803.07737, as built by limacv/Face-detection-and-tracking)
with nothing but torch.nn.functional calls on a dict of weights.

Weights come from a variables npz (`params/<module>/<leaf>` float16,
`batch_stats/<module>/<leaf>` float32); a conv kernel is stored HWIO and
used OIHW.  BatchNorm is in inference form with eps 1e-5.  A conv's groups
follow from its kernel: input channels over the kernel's input channels.

`PyramidBoxRef(weights, variant)(x)` takes a [B, 3, H, W] float32 batch
(mean already subtracted) and returns (loc [B, P, 4], logits [B, P, 2],
source shapes [(f_width, f_height), ...]): the six face heads, max-in-out
applied, prior-major in row-major cell order.  The head-supervision branch
is not computed: detection never reads it.

`conv_flops(variant, shapes, height, width)` counts the multiply-adds of
every convolution of one image by running the same forward on the meta
device, so the count is of this frozen architecture, whatever implements it.
"""
from __future__ import annotations

import zipfile

import numpy as np
import torch
import torch.nn.functional as F

VARIANTS = ("repo", "try1")
BN_EPS = 1e-5


def load_weights(path: str, device="cpu") -> dict[str, torch.Tensor]:
    """{"<module>/<leaf>": float32 tensor} from a variables npz; kernels OIHW."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            _, *mod, leaf = key.split("/")
            a = np.asarray(z[key], np.float32)
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1)
            out["/".join(mod + [leaf])] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def weight_shapes(path: str) -> dict[str, tuple[int, ...]]:
    """The shapes load_weights would give, read from the npz headers only."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            with zf.open(name) as f:
                major, _ = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0 if major == 1
                        else np.lib.format.read_array_header_2_0)
                shape, _, _ = read(f)
            _, *mod, leaf = name[:-len(".npy")].split("/")
            if leaf == "kernel":
                shape = tuple(shape[i] for i in (3, 2, 0, 1))
            out["/".join(mod + [leaf])] = tuple(shape)
    return out


class PyramidBoxRef:
    """The forward of one variant over a weight dict (see the module doc)."""

    def __init__(self, weights: dict[str, torch.Tensor], variant: str):
        if variant not in VARIANTS:
            raise ValueError(f"the reference has {VARIANTS}, not {variant!r}")
        self.w = weights
        self.variant = variant
        self.macs = 0  # multiply-adds of the convolutions run so far

    # -- layers ---------------------------------------------------------------

    def conv(self, name, x, stride=1, pad=0, dil=1):
        k = self.w[f"{name}/kernel"]
        groups = x.shape[1] // k.shape[1]
        y = F.conv2d(x, k, self.w.get(f"{name}/bias"), stride, pad, dil, groups)
        self.macs += y[0].numel() * k.shape[1] * k.shape[2] * k.shape[3]
        return y

    def bn(self, name, x):
        w = self.w
        return F.batch_norm(x, w[f"{name}/mean"], w[f"{name}/var"], w[f"{name}/scale"],
                            w[f"{name}/bias"], False, 0.0, BN_EPS)

    def ssh(self, name, x):
        x1 = F.relu(self.conv(f"{name}/conv1", x, 1, 1))
        x2 = F.relu(self.conv(f"{name}/conv2", x, 1, 2, 2))
        x2_1 = F.relu(self.conv(f"{name}/conv2_1", x2, 1, 1))
        x2_2 = F.relu(self.conv(f"{name}/conv2_2", x2, 1, 2, 2))
        x2_2 = F.relu(self.conv(f"{name}/conv2_2_1", x2_2, 1, 1))
        return torch.cat([x1, x2_1, x2_2], 1)

    def context(self, name, up, main):
        """LFPN fusion: 1×1 convs, 2× bilinear upsample (half-pixel), crop, add."""
        up = self.conv(f"{name}/up_conv", up)
        main = self.conv(f"{name}/main_conv", main)
        h, w = up.shape[-2:]
        up = F.interpolate(up, size=(2 * h, 2 * w), mode="bilinear", align_corners=False)
        return up[:, :, :main.shape[2], :main.shape[3]] + main

    def bottleneck(self, name, x, stride):
        out = F.relu(self.bn(f"{name}/bn1", self.conv(f"{name}/conv1", x)))
        out = F.relu(self.bn(f"{name}/bn2", self.conv(f"{name}/conv2", out, stride, 1)))
        out = self.bn(f"{name}/bn3", self.conv(f"{name}/conv3", out))
        if f"{name}/downsample__0/kernel" in self.w:
            x = self.bn(f"{name}/downsample__1", self.conv(f"{name}/downsample__0", x, stride))
        return F.relu(out + x)

    def extra(self, name, x):
        x = F.relu(self.bn(f"{name}/1", self.conv(f"{name}/0", x)))
        return F.relu(self.bn(f"{name}/4", self.conv(f"{name}/3", x, 2, 1)))

    def mb1(self, name, x, stride=1, pad=1):
        """Depthwise-separable: dw conv, bn, relu, 1×1 conv."""
        x = F.relu(self.bn(f"{name}/bn", self.conv(f"{name}/conv1", x, stride, pad)))
        return self.conv(f"{name}/conv2", x)

    def mb2(self, name, x, stride=1, pad=1, dil=1, residual=False):
        """Inverted residual: 1×1 expand, dw, 1×1 project, ReLU6s."""
        y = F.relu6(self.bn(f"{name}/bn1", self.conv(f"{name}/conv1", x)))
        y = F.relu6(self.bn(f"{name}/bn2", self.conv(f"{name}/conv2", y, stride, pad, dil)))
        y = self.bn(f"{name}/bn3", self.conv(f"{name}/conv3", y))
        return y + x if residual else y

    # -- trunks ---------------------------------------------------------------

    def trunk_repo(self, x):
        c1 = F.max_pool2d(F.relu(self.bn("bn1", self.conv("conv1", x, 2, 3))), 3, 2, 1)
        feats, h = [], c1
        for layer, (blocks, stride) in enumerate(((3, 1), (4, 2), (6, 2), (3, 2)), 1):
            for i in range(blocks):
                h = self.bottleneck(f"layer{layer}/{i}", h, stride if i == 0 else 1)
            feats.append(h)
        c2, c3, c4, c5 = feats
        c6 = self.extra("layer5", c5)
        c7 = self.extra("layer6", c6)
        return (c2, c3, c4, c5, c6, c7), "", ("smooth_c3", "smooth_c4", "smooth_c5"), None

    def trunk_try1(self, x):
        c1 = F.max_pool2d(F.relu(self.bn("bn1", self.mb1("conv1_my", x, 2, 3))), 3, 2, 1)
        h = self.mb2("layer1_my__0", c1, residual=True)
        h = self.mb2("layer1_my__1", h, residual=True)
        c2 = self.mb2("layer1_my__2", h)
        h = self.mb2("layer2_my__0", c2, 2, 2)
        c3 = self.mb2("layer2_my__1", h, 1, 2, 2)
        h = self.mb2("layer3_my__0", c3, 2, 2)
        h = self.mb2("layer3_my__1", h, 1, 2, residual=True)
        c4 = self.mb2("layer3_my__2", h, 1, 2, 2)
        h = self.mb2("layer4_my__0", c4, 2, 2)
        c5 = self.mb2("layer4_my__1", h, 1, 1)
        c6 = self.mb2("layer5_my", c5, 2, 1)
        c7 = self.mb2("layer6_my", c6, 2, 1)
        smooth = ("smooth_c3_my", "smooth_c4_my", "smooth_c5_my")
        return (c2, c3, c4, c5, c6, c7), "_my", smooth, self.mb1

    def __call__(self, x: torch.Tensor):
        trunk = self.trunk_repo if self.variant == "repo" else self.trunk_try1
        (c2, c3, c4, c5, c6, c7), lat, smooth, smooth_fn = trunk(x)
        c5_lat = self.conv(f"latlayer_fc{lat}", c5)
        c6_lat = self.conv(f"latlayer_c6{lat}", c6)
        c7_lat = self.conv(f"latlayer_c7{lat}", c7)
        c4_fuse = self.context("conv5_ct_py", c5_lat, c4)
        c3_fuse = self.context("conv4_ct_py", c4_fuse, c3)
        c2_fuse = self.context("conv3_ct_py", c3_fuse, c2)
        fused = [c2_fuse, c3_fuse, c4_fuse]
        fused = [smooth_fn(n, f) if smooth_fn else self.conv(n, f, 1, 1)
                 for n, f in zip(smooth, fused)]
        maps = fused + [c5_lat, c6_lat, c7_lat]
        sources = [self.ssh(f"conv{i + 2}_SSH", m) for i, m in enumerate(maps)]
        b = x.shape[0]
        locs, logits, shapes = [], [], []
        for i, s in enumerate(sources):
            conf = self.conv(f"face_conf__{i}", s, 1, 1).permute(0, 2, 3, 1)
            shapes.append((conf.shape[2], conf.shape[1]))
            if i == 0:  # max-in-out: three background channels, one face
                neg, pos = conf[..., :3].amax(-1, keepdim=True), conf[..., 3:4]
            else:       # one background channel, three face
                neg, pos = conf[..., :1], conf[..., 1:].amax(-1, keepdim=True)
            logits.append(torch.cat([neg, pos], -1).reshape(b, -1, 2))
            loc = self.conv(f"face_loc__{i}", s, 1, 1).permute(0, 2, 3, 1)
            locs.append(loc.reshape(b, -1, 4))
        return torch.cat(locs, 1), torch.cat(logits, 1), shapes


def conv_flops(variant: str, shapes: dict[str, tuple[int, ...]], height: int,
               width: int) -> int:
    """Operations (2 × multiply-adds) of the convolutions of one image of
    height × width through `variant`, from weight shapes alone."""
    meta = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    net = PyramidBoxRef(meta, variant)
    net(torch.empty(1, 3, height, width, device="meta"))
    return 2 * net.macs
