"""Shared building blocks (counterpart of fdt/models/common.py:24-175).

NCHW modules; parameter names follow fdt's flax names with `__` → `.`,
which are the reference torch module paths.  BatchNorm eps is 1e-5.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from fdt_torch.dist import multihost, space
from fdt_torch.models import fused


def conv(cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
         *, bias: bool = True, dilation: int = 1, groups: int = 1) -> nn.Conv2d:
    """nn.Conv2d; inside `fdt_torch.ops.quant.quantized("int8")` (read when
    the model is built) passed through int8_convs, so an eligible conv is an
    Int8Conv2d with the same parameters, as fdt's conv() builds Int8Conv
    inside its trace-time switch."""
    from fdt_torch.ops.quant import int8_convs, quant_mode
    c = nn.Conv2d(cin, cout, kernel, stride, padding, dilation=dilation, groups=groups,
                  bias=bias)
    return int8_convs(c) if quant_mode() == "int8" else c


# > 0 while no BatchNorm may update its running statistics: the recompute
# of a checkpointed forward, and eval_loss's train-mode forward.  A plain
# counter, not thread-local: autograd recomputes on its own device threads.
_STATS_FROZEN = 0


@contextlib.contextmanager
def running_stats_frozen():
    """Train-mode BatchNorm in the body normalises with batch statistics but
    leaves every running statistic as it was."""
    global _STATS_FROZEN
    _STATS_FROZEN += 1
    try:
        yield
    finally:
        _STATS_FROZEN -= 1


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train mode updates the running statistics as
    flax's nn.BatchNorm(momentum=0.9) does: with the BIASED batch variance
    (torch stores the unbiased one, ×n/(n−1)), and not at all inside
    `running_stats_frozen()`.  Eval mode and the state dict are
    nn.BatchNorm2d's.

    While a torch.distributed process group exists, train mode normalises
    with the statistics of the GLOBAL batch, as fdt's SPMD step does:
    [Σx, Σx², count] summed over the ranks by a differentiable all-reduce,
    mean = Σx/n and var = max(Σx²/n − mean², 0) in float32 (flax's
    formula), so every rank updates the same running statistics.

    An eval-mode forward counts in `fused.bn_unfused`: a BatchNorm folded
    into its conv (fused.py) is not called."""

    def forward(self, x):
        if not self.training:
            fused.bn_unfused.count += 1
            return super().forward(x)
        if multihost.group() is not None:
            return self._forward_global(x)
        # one fused pass: torch writes the batch mean and the unbiased
        # variance into fresh buffers (momentum 1), the biased one is
        # recovered from it.  A checkpoint's recompute takes the same call,
        # so that it saves the same tensors for the backward.
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        if _STATS_FROZEN:
            return y
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(mean, alpha=1 - 0.9)
            self.running_var.mul_(0.9).add_(var * ((n - 1) / n), alpha=1 - 0.9)
        return y

    def _forward_global(self, x):
        c = x.shape[1]
        xf = x.float()
        local = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                           xf.new_full((1,), x.numel() // c)])
        total = multihost.all_reduce_sum(local)
        n = total[2 * c]
        mean = total[:c] / n
        var = torch.clamp(total[c:2 * c] / n - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        if not _STATS_FROZEN:
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(mean, alpha=1 - 0.9)
                self.running_var.mul_(0.9).add_(var, alpha=1 - 0.9)
        return y.to(x.dtype)


def checkpoint(fn, *args):
    """torch.utils.checkpoint of fn(*args) (non-reentrant): the backward
    recomputes fn's activations instead of keeping them.  The recompute runs
    under running_stats_frozen(), so a BatchNorm inside updates its running
    statistics once a step, as fdt's lifted nn.remat does."""
    from torch.utils.checkpoint import checkpoint as torch_checkpoint
    return torch_checkpoint(fn, *args, use_reentrant=False,
                            context_fn=lambda: (contextlib.nullcontext(),
                                                running_stats_frozen()))


def batch_norm(features: int) -> BatchNorm2d:
    return BatchNorm2d(features, eps=1e-5, momentum=0.1)


class NestedSequential(nn.Sequential):
    """A Sequential that fdt builds as one flax module with numbered
    children (ResNetStage, _ExtraLayer): its children nest under it in flax
    paths ("layer1/0/conv1"), where a plain Sequential's index is joined to
    its name ("downsample__0")."""


def max_pool(x: torch.Tensor, kernel: int = 3, stride: int = 2,
             padding: int = 1, owner: nn.Module | None = None) -> torch.Tensor:
    """MaxPool2d; torch pads with -inf, as fdt's max_pool does.  While a
    space group exists, the pool of `owner` (the model that calls it, which
    keeps its input's global height) pools its rank's band."""
    if owner is not None and multihost.space_group() is not None:
        h = space.op_height(owner, "max_pool", x)
        if h is not None:
            return space.max_pool2d(x, h, kernel, stride, padding)
    return F.max_pool2d(x, kernel, stride, padding)


def crelu(x: torch.Tensor) -> torch.Tensor:
    """Concatenated ReLU: relu(cat[x, -x]) along channels, x first."""
    return F.relu(torch.cat([x, -x], dim=1))


class ConvBNReLU(NestedSequential):
    """Sequential(Conv, BatchNorm, ReLU): children '0'/'1'/'2', as fdt's
    ConvBNReLU and the reference's conv_bn_relu."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(conv(cin, features, kernel, stride, padding),
                         batch_norm(features), nn.ReLU())


class SSHContext(nn.Module):
    """SSH context module: 3×3 ‖ (dilated 3×3 → 3×3) ‖ (dilated → dilated → 3×3),
    concatenated to 2*xchannels channels.  Each conv's ReLU is its epilogue
    where a Folding holds it (fused.py): the flagship's do, try1's do not."""

    def __init__(self, cin: int, xchannels: int = 256):
        super().__init__()
        xc = xchannels
        self.conv1 = conv(cin, xc, 3, 1, 1)
        self.conv2 = conv(cin, xc // 2, 3, 1, 2, dilation=2)
        self.conv2_1 = conv(xc // 2, xc // 2, 3, 1, 1)
        self.conv2_2 = conv(xc // 2, xc // 2, 3, 1, 2, dilation=2)
        self.conv2_2_1 = conv(xc // 2, xc // 2, 3, 1, 1)

    def relu_chains(self):
        """Its conv → ReLU chains (fused.py), which a model that folds them
        declares among its own `conv_chains()`."""
        return [(c, None) for c in (self.conv1, self.conv2, self.conv2_1, self.conv2_2,
                                    self.conv2_2_1)]

    def forward(self, x):
        x1 = fused.conv_bn(self.conv1, None, x)
        x2 = fused.conv_bn(self.conv2, None, x)
        x2_1 = fused.conv_bn(self.conv2_1, None, x2)
        x2_2 = fused.conv_bn(self.conv2_2, None, x2)
        x2_2 = fused.conv_bn(self.conv2_2_1, None, x2_2)
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
        if multihost.space_group() is not None:
            h_up, h_main = space.op_height(self, "up", up), space.op_height(self, "main", main)
            if h_up is not None:  # the band of the cropped map: main's band
                return space.upsample_crop(up, h_up, h_main, main.shape[3]) + main
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


def add_pyramid_heads(model: nn.Module, n_sources: int, channels: int) -> None:
    """Register the PyramidBox heads on `model`: face_conf / face_loc over
    every source and the head-supervision branch head_loc / head_conf over
    sources[1:].  Detection never computes the head branch (fdt's compiled
    graph drops it as dead code too); training asks for it
    (`face_outputs(heads=True)`)."""
    model.face_conf = nn.ModuleList([conv(channels, 4, 3, 1, 1) for _ in range(n_sources)])
    model.face_loc = nn.ModuleList([conv(channels, 4, 3, 1, 1) for _ in range(n_sources)])
    model.head_loc = nn.ModuleList([conv(channels, 4, 3, 1, 1) for _ in range(n_sources - 1)])
    model.head_conf = nn.ModuleList([conv(channels, 2, 3, 1, 1) for _ in range(n_sources - 1)])


def _head(conv: nn.Module, source: torch.Tensor) -> torch.Tensor:
    """A head conv over a source map: on the space axis of a 2-D mesh, its
    output over the whole map (space.whole_map), which the loss needs."""
    return space.whole_map(conv, conv(source))


def face_outputs(model: nn.Module, sources, heads: bool = False,
                 features: list | None = None) -> dict:
    """The face heads of `model` over its source maps (max-in-out applied),
    reshaped channels-last into prior-major [B, P, ·] float32 tensors, so that
    prior order matches fdt's NHWC reshape, and the source shapes.  With
    `heads` (training) also the head-supervision branch over sources[1:]:
    head_loc [B, Ph, 4] and head_conf [B, Ph, 2], float32.  With `features`
    (net2net distillation's taps, fdt's return_features) also "features",
    that list, and "sources", the source maps, both NCHW."""
    b = sources[0].shape[0]
    locs, confs, shapes = [], [], []
    for i, s in enumerate(sources):
        conf = _head(model.face_conf[i], s)
        shapes.append((conf.shape[3], conf.shape[2]))
        tmp_conf = conf.permute(0, 2, 3, 1)
        confs.append(max_in_out_conf(tmp_conf, first_source=(i == 0)).reshape(b, -1, 2))
        locs.append(_head(model.face_loc[i], s).permute(0, 2, 3, 1).reshape(b, -1, 4))
    out = {
        "face_loc": torch.cat(locs, 1).float(),
        "face_conf": torch.cat(confs, 1).float(),
        "source_shapes": tuple(shapes),
    }
    if heads:
        out["head_loc"] = torch.cat([
            _head(model.head_loc[i], s).permute(0, 2, 3, 1).reshape(b, -1, 4)
            for i, s in enumerate(sources[1:])], 1).float()
        out["head_conf"] = torch.cat([
            _head(model.head_conf[i], s).permute(0, 2, 3, 1).reshape(b, -1, 2)
            for i, s in enumerate(sources[1:])], 1).float()
    if features is not None:
        out["features"] = list(features)
        out["sources"] = list(sources)
    return out
