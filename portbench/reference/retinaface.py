"""Plain float32 RetinaFace-ResNet50 (Deng et al., arXiv:1905.00641) as
biubug6/Pytorch_Retinaface builds and tests it: `cfg_re50` of data/config.py;
the network of models/retinaface.py and models/net.py (FPN, SSH, conv_bn,
conv_bn_no_relu, conv_bn1X1) on torchvision's ResNet-50; the priors of
layers/functions/prior_box.py; `decode` and `decode_landm` of
utils/box_utils.py; and the test-time settings of test_widerface.py
(BGR minus (104, 117, 123), softmax, score > 0.02, the top 5000 by score,
greedy NMS at 0.4, 750 kept).  Written with nothing but torch.nn.functional
calls on a dict of weights in biubug6's state-dict names; it imports nothing
of fdt_torch, fdt or JAX.

`RetinaFaceRef(weights)(x)` takes a [B, 3, H, W] float32 batch (mean already
subtracted) and returns (loc [B, P, 4], logits [B, P, 2], landm [B, P, 10],
source shapes [(f_width, f_height), ...]).  `ReferenceDetector(state_dict,
device)(frames_u8, head)` runs it with TF32 off (full_float32) and the head
on each image: one LandmarkResult an image.

Departures from the published code, each as the port's detector and the
PyramidBox reference have it:
  - IoU is taken on normalized boxes, without py_cpu_nms's +1 pixel in
    widths and heights, and a box is suppressed at IoU >= the threshold
    (py_cpu_nms keeps IoU <= it): K1's rule.
  - Ties in score keep index order (a stable sort; test_widerface.py's
    argsort()[::-1] puts the later index first).
  - The greedy walk stops at the 750th keep, which gives test_widerface.py's
    keep_top_k rows.
  - LeakyReLU with slope 0 (the 256-channel FPN and SSH) is written as a
    ReLU: equal values (it gives -0.0 where ReLU gives +0.0).
  - Images run in blocks of `block` frames a forward, not one at a time.

`seeded_state_dict(seed)` makes weights in biubug6's names on the CPU,
deterministically: conv weights by torchvision's ResNet init (normal,
fan-out, gain √2) and BatchNorm γ = 1, β = 0; then every BatchNorm's
running statistics are set by one float32 pass of this reference in train
mode over seeded noise frames (each BN's mean and biased variance of its
input, then normalising with them), so that each BN normalises its input as
in a trained net; and the three heads of each level are scaled so that, on
those frames, the class logit difference (face − background) and every box
and landmark output spread by about one unit: scores neither saturated nor
all ≈ 0.5, since with flat scores the ranking of a bf16 program against this
float32 reference is decided by rounding.

`conv_flops(height, width)` counts the multiply-adds of every convolution
of one image by running the same forward on the meta device, so the count
is of this frozen architecture, whatever implements it.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.detect import (PIXEL_MEAN_BGR, HeadSettings, ImageResult, decode,
                                        full_float32, greedy_nms)

STEPS = (8, 16, 32)
MIN_SIZES = ((16, 32), (64, 128), (256, 512))
VARIANCE = (0.1, 0.2)
STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))  # ResNet-50: blocks, planes
FPN_IN = (512, 1024, 2048)
OUT = 256
HEADS = (("ClassHead", 2), ("BboxHead", 4), ("LandmarkHead", 10))
ANCHORS = 2
BN_EPS = 1e-5
BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
CALIBRATION_FRAMES = 2
CALIBRATION_SIZE = 512
RESIDUAL_GAMMA = 0.1


@dataclasses.dataclass
class LandmarkResult(ImageResult):
    """ImageResult with landmarks, in pixels: landmarks [P, 10] every
    prior's decoded points, row_landmarks [m, 10] the kept rows'."""
    landmarks: np.ndarray
    row_landmarks: np.ndarray


def priors(shapes, width: int, height: int) -> np.ndarray:
    """[P, 4] center-form priors: per level its cells row-major, each cell's
    min_sizes in order; float64 cast to float32, unclipped."""
    parts = []
    for (fw, fh), step, sizes in zip(shapes, STEPS, MIN_SIZES):
        for i in range(fh):
            for j in range(fw):
                for s in sizes:
                    parts.append(((j + 0.5) * step / width, (i + 0.5) * step / height,
                                  s / width, s / height))
    return np.asarray(parts, np.float64).astype(np.float32).reshape(-1, 4)


def feature_maps(width: int, height: int) -> list[tuple[int, int]]:
    """(f_width, f_height) of each level: ceil(W/step) × ceil(H/step)."""
    return [(math.ceil(width / s), math.ceil(height / s)) for s in STEPS]


def decode_landm(pre: torch.Tensor, priors_t: torch.Tensor) -> torch.Tensor:
    """biubug6's decode_landm: prior_xy + pre · 0.1 · prior_wh, five points."""
    return torch.cat([priors_t[..., :2] + pre[..., 2 * k:2 * k + 2] * VARIANCE[0]
                      * priors_t[..., 2:] for k in range(5)], -1)


class RetinaFaceRef:
    """The forward over a weight dict (see the module doc).  With
    `calibrating` set, each BatchNorm takes its input's mean and biased
    variance as its running statistics (written into the dict) first."""

    def __init__(self, weights: dict[str, torch.Tensor]):
        self.w = weights
        self.macs = 0  # multiply-adds of the convolutions run so far
        self.calibrating = False

    def conv(self, name, x, stride=1, pad=0):
        k = self.w[f"{name}.weight"]
        y = F.conv2d(x, k, self.w.get(f"{name}.bias"), stride, pad)
        self.macs += y[0].numel() * k.shape[1] * k.shape[2] * k.shape[3]
        return y

    def bn(self, name, x):
        w = self.w
        if self.calibrating:
            w[f"{name}.running_mean"] = x.mean((0, 2, 3))
            w[f"{name}.running_var"] = x.var((0, 2, 3), unbiased=False)
        return F.batch_norm(x, w[f"{name}.running_mean"], w[f"{name}.running_var"],
                            w[f"{name}.weight"], w[f"{name}.bias"], False, 0.0, BN_EPS)

    def conv_bn(self, name, x, relu=True):
        """conv_bn / conv_bn_no_relu (3×3, pad 1) / conv_bn1X1 (1×1)."""
        pad = self.w[f"{name}.0.weight"].shape[-1] // 2
        y = self.bn(f"{name}.1", self.conv(f"{name}.0", x, 1, pad))
        return F.relu(y) if relu else y

    def bottleneck(self, name, x, stride):
        out = F.relu(self.bn(f"{name}.bn1", self.conv(f"{name}.conv1", x)))
        out = F.relu(self.bn(f"{name}.bn2", self.conv(f"{name}.conv2", out, stride, 1)))
        out = self.bn(f"{name}.bn3", self.conv(f"{name}.conv3", out))
        if f"{name}.downsample.0.weight" in self.w:
            x = self.bn(f"{name}.downsample.1", self.conv(f"{name}.downsample.0", x, stride))
        return F.relu(out + x)

    def body(self, x):
        h = F.max_pool2d(F.relu(self.bn("body.bn1", self.conv("body.conv1", x, 2, 3))), 3, 2, 1)
        feats = []
        for layer, (blocks, _) in enumerate(STAGES, 1):
            for i in range(blocks):
                stride = 2 if i == 0 and layer > 1 else 1
                h = self.bottleneck(f"body.layer{layer}.{i}", h, stride)
            feats.append(h)
        return feats[1:]  # C3, C4, C5

    def ssh(self, name, x):
        t = self.conv_bn(f"{name}.conv5X5_1", x)
        return F.relu(torch.cat([
            self.conv_bn(f"{name}.conv3X3", x, relu=False),
            self.conv_bn(f"{name}.conv5X5_2", t, relu=False),
            self.conv_bn(f"{name}.conv7x7_3", self.conv_bn(f"{name}.conv7X7_2", t), relu=False)],
            1))

    def features(self, x) -> list[torch.Tensor]:
        """The three SSH outputs."""
        c3, c4, c5 = self.body(x)
        p3 = self.conv_bn("fpn.output1", c3)
        p4 = self.conv_bn("fpn.output2", c4)
        p5 = self.conv_bn("fpn.output3", c5)
        p4 = self.conv_bn("fpn.merge2", p4 + F.interpolate(p5, size=p4.shape[-2:], mode="nearest"))
        p3 = self.conv_bn("fpn.merge1", p3 + F.interpolate(p4, size=p3.shape[-2:], mode="nearest"))
        return [self.ssh(f"ssh{i}", p) for i, p in enumerate((p3, p4, p5), 1)]

    def head(self, kind: str, k: int, feats) -> torch.Tensor:
        b = feats[0].shape[0]
        return torch.cat([self.conv(f"{kind}.{i}.conv1x1", f).permute(0, 2, 3, 1).reshape(b, -1, k)
                          for i, f in enumerate(feats)], 1)

    def __call__(self, x: torch.Tensor):
        feats = self.features(x)
        shapes = [(f.shape[3], f.shape[2]) for f in feats]
        return (self.head("BboxHead", 4, feats), self.head("ClassHead", 2, feats),
                self.head("LandmarkHead", 10, feats), shapes)


def state_shapes() -> dict[str, tuple[int, ...]]:
    """Every parameter and running statistic of biubug6's RetinaFace-ResNet50
    state dict (num_batches_tracked aside) and its shape."""
    out: dict[str, tuple[int, ...]] = {}

    def bn(name, c):
        out.update({f"{name}.{leaf}": (c,) for leaf in BN_LEAVES})

    def conv_bn(name, cin, cout, k):
        out[f"{name}.0.weight"] = (cout, cin, k, k)
        bn(f"{name}.1", cout)

    out["body.conv1.weight"] = (64, 3, 7, 7)
    bn("body.bn1", 64)
    cin = 64
    for layer, (blocks, planes) in enumerate(STAGES, 1):
        for i in range(blocks):
            name = f"body.layer{layer}.{i}"
            for conv, shape in (("1", (planes, cin, 1, 1)), ("2", (planes, planes, 3, 3)),
                                ("3", (4 * planes, planes, 1, 1))):
                out[f"{name}.conv{conv}.weight"] = shape
                bn(f"{name}.bn{conv}", shape[0])
            if i == 0:
                out[f"{name}.downsample.0.weight"] = (4 * planes, cin, 1, 1)
                bn(f"{name}.downsample.1", 4 * planes)
            cin = 4 * planes
    for i, c in enumerate(FPN_IN, 1):
        conv_bn(f"fpn.output{i}", c, OUT, 1)
    for i in (1, 2):
        conv_bn(f"fpn.merge{i}", OUT, OUT, 3)
    for j in (1, 2, 3):
        for name, cin, cout in (("conv3X3", OUT, OUT // 2), ("conv5X5_1", OUT, OUT // 4),
                                ("conv5X5_2", OUT // 4, OUT // 4),
                                ("conv7X7_2", OUT // 4, OUT // 4),
                                ("conv7x7_3", OUT // 4, OUT // 4)):
            conv_bn(f"ssh{j}.{name}", cin, cout, 3)
    for kind, k in HEADS:
        for i in range(3):
            out[f"{kind}.{i}.conv1x1.weight"] = (ANCHORS * k, OUT, 1, 1)
            out[f"{kind}.{i}.conv1x1.bias"] = (ANCHORS * k,)
    return out


@functools.lru_cache(maxsize=4)
def seeded_state_dict(seed: int, size: int = CALIBRATION_SIZE,
                      frames: int = CALIBRATION_FRAMES) -> dict[str, torch.Tensor]:
    """Seeded weights in biubug6's names (the module doc), float32 on the
    CPU, with a num_batches_tracked beside every BatchNorm as torch saves
    one; BatchNorm statistics from `frames` noise frames of size × size.
    Cached: callers must not change the tensors."""
    gen = torch.Generator().manual_seed(int(seed))
    w: dict[str, torch.Tensor] = {}
    for name, shape in state_shapes().items():
        leaf = name.rsplit(".", 1)[1]
        if leaf == "weight" and len(shape) == 4:  # torchvision: normal, fan-out, gain √2
            std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            w[name] = torch.randn(shape, generator=gen) * std
        elif name.endswith(".bn3.weight"):
            w[name] = torch.full(shape, RESIDUAL_GAMMA)
        else:
            w[name] = torch.ones(shape) if leaf in ("weight", "running_var") else torch.zeros(shape)
    x = torch.randint(0, 256, (frames, 3, size, size), generator=gen).float()
    x -= torch.tensor(PIXEL_MEAN_BGR)[:, None, None]
    net = RetinaFaceRef(w)
    net.calibrating = True
    with torch.no_grad():
        feats = net.features(x)
        for kind, k in HEADS:
            for i, f in enumerate(feats):
                name = f"{kind}.{i}.conv1x1"
                out = net.conv(name, f).permute(0, 2, 3, 1).reshape(-1, ANCHORS, k)
                spread = (out[..., 1] - out[..., 0]).std() if kind == "ClassHead" else out.std()
                w[f"{name}.weight"] /= spread
    for name in [n for n in w if n.endswith(".running_mean")]:
        w[name.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    return {k: v.contiguous() for k, v in w.items()}


@functools.lru_cache(maxsize=None)
def conv_flops(height: int, width: int) -> int:
    """Operations (2 × multiply-adds) of the convolutions of one image of
    height × width, from the architecture alone."""
    net = RetinaFaceRef({k: torch.empty(s, device="meta") for k, s in state_shapes().items()})
    net(torch.empty(1, 3, height, width, device="meta"))
    return 2 * net.macs


def detect_image(scores: np.ndarray, boxes: np.ndarray, landms: np.ndarray,
                 head: HeadSettings, width: int, height: int) -> LandmarkResult:
    """The head over one image's scores [P], normalized boxes [P, 4] and
    landmarks [P, 10]: score > threshold, a stable sort by score, the top
    `budget`, greedy NMS, `top_k` kept; no class with a single candidate is
    dropped."""
    valid = scores > np.float32(head.conf_thresh)
    masked = np.where(valid, scores, -np.inf).astype(np.float32)
    order = np.argsort(-masked, kind="stable")[:min(head.budget, len(scores))]
    s_boxes, s_valid = boxes[order], valid[order]
    keep = greedy_nms(s_boxes, s_valid, head.nms_thresh, head.top_k)
    box_scale = np.array([width, height] * 2, np.float32)
    point_scale = np.array([width, height] * 5, np.float32)
    kept = order[keep]
    rows = np.column_stack([boxes[kept] * box_scale, scores[kept]]).astype(np.float32)
    return LandmarkResult(scores, boxes * box_scale, rows, s_boxes, s_valid, keep,
                          landms * point_scale, landms[kept] * point_scale)


class ReferenceDetector:
    """A biubug6-named state dict → float32 forward (TF32 off) →
    detect_image per image."""

    def __init__(self, state_dict: dict[str, torch.Tensor], device="cpu"):
        self.device = torch.device(device)
        self.net = RetinaFaceRef({k: v.to(self.device, torch.float32)
                                  for k, v in state_dict.items()
                                  if not k.endswith("num_batches_tracked")})

    @torch.inference_mode()
    def __call__(self, frames_u8: np.ndarray, head: HeadSettings,
                 block: int = 8) -> list[LandmarkResult]:
        """[n, H, W, 3] uint8 BGR → one LandmarkResult per frame, `block`
        frames a forward."""
        out = []
        n, h, w, _ = frames_u8.shape
        mean = torch.tensor(PIXEL_MEAN_BGR, device=self.device)
        for i in range(0, n, block):
            x = torch.from_numpy(np.ascontiguousarray(frames_u8[i:i + block])).to(self.device)
            x = (x.float() - mean).permute(0, 3, 1, 2).contiguous()
            with full_float32():
                loc, logits, landm, shapes = self.net(x)
            if shapes != feature_maps(w, h):
                raise ValueError(f"source maps {shapes}, expected {feature_maps(w, h)}")
            p = torch.from_numpy(priors(feature_maps(w, h), w, h)).to(self.device)
            scores = torch.softmax(logits, -1)[..., 1].cpu().numpy()
            boxes = decode(loc, p).cpu().numpy()
            landms = decode_landm(landm, p).cpu().numpy()
            out += [detect_image(s, b, lm, head, w, h) for s, b, lm in zip(scores, boxes, landms)]
        return out
