"""Conv → BatchNorm → ReLU chains as one cuDNN convolution each.

In eval mode a BatchNorm is a per-channel affine, so it folds into the conv
before it: w' = w·γ/√(var+ε) and b' = (b − μ)·γ/√(var+ε) + β, computed in
float32 (float64 for a float64 model) from the live parameters and cast to
the conv's dtype.  The bias,
a residual add and the ReLU then run in the convolution's epilogue
(`torch.cudnn_convolution_relu`, `torch.cudnn_convolution_add_relu`, which
computes relu(conv(x, w') + z + b')), so the activation is written once
instead of once by the conv and once more by each of the BatchNorm, the add
and the ReLU.  A conv with a bias and no BatchNorm takes the epilogue with
its own weights.  A ResNet downsample's BatchNorm folds into its conv,
which then runs bare: its folded bias joins the epilogue bias of the
block's last conv, relu(W3·y + b3' + Wd'·x + bd').

fold(model) builds a Folding: the folded weights of every chain that a
module of `model` declares (its `conv_chains()`), kept outside the model's
parameters, buffers and state dict, so the module tree and the state dict
are unchanged.  A chain's forward takes the fused call through conv_bn()
only while a Folding that holds its conv is active on the thread
(`with active(folding):`) and the conv is in eval mode; otherwise, and for
every conv it does not hold, the modules run as they are.  On a CPU tensor
the fused call's plain version runs: F.conv2d with w' and b', the add, the
ReLU.  The flagship and RetinaFace declare their chains; try1 declares
none: folded, its scores drift from float32's past what its benchmark
cell holds (PERF.md §6).

Precision: the fused call rounds its output once (cuDNN's epilogue equals
an exact float32 computation rounded once), where the modules round the
conv's output and then the BatchNorm's, add's or bias add's.  The fold
itself rounds w' and b' to bf16, one rounding more than the modules'
float32 affine: a fixed error a channel, 0.1-0.25% of the output's root
mean square on the card (PERF.md §6 has the readings against float32).

Which convs fold: an nn.Conv2d itself (not an Int8Conv2d, whose folded
weights would change its quantisation scales, nor a space mesh's
BandConv2d), with groups 1, before a BatchNorm with running statistics and
an affine.  A grouped or depthwise conv keeps its modules: on the card
cuDNN runs its fused call as one conv2d_grouped_direct_kernel ten times
slower than the unfused conv, BatchNorm and ReLU together.
PyramidBoxDetector builds one Folding a model for a bf16 model on a CUDA
card without int8 (`applies`); float32 (the parity mode), the CPU and int8
keep the unfused modules.

Weights loaded in place after the fold (select_checkpoint's
`load_state_dict`) reach the next answer: Folding.refresh(), which the
detector calls once a detect call, reads each source tensor's `_version`
and `data_ptr` and, where one changed, folds every chain again into the
same storage, so a captured CUDA graph reads the new folded weights.

Counters (counted on the host when a forward is enqueued: eager calls and
graph captures count, replays do not): `fused_convs`, convolutions
enqueued through the fused epilogue (on a CPU tensor, its plain version);
`bn_unfused`, eval-mode BatchNorms run as their own pass
(common.BatchNorm2d counts it).
"""
from __future__ import annotations

import contextlib
import contextvars
import operator

import torch
import torch.nn.functional as F
from torch import nn

from fdt_torch.utils import trace

fused_convs = trace.Counter()
bn_unfused = trace.Counter()

_VERSION = operator.attrgetter("_version")
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("fdt_torch_folding", default=None)


def applies(device: torch.device, dtype: torch.dtype, quant) -> bool:
    """Whether a detector's model on `device` in `dtype` folds its chains."""
    return device.type == "cuda" and dtype == torch.bfloat16 and quant is None


def _foldable(conv: nn.Module, bn: nn.Module | None) -> bool:
    if type(conv) is not nn.Conv2d or conv.groups != 1 or conv.padding_mode != "zeros":
        return False
    if bn is None:
        return conv.bias is not None
    return isinstance(bn, nn.BatchNorm2d) and bn.affine and bn.track_running_stats


def _scale_shift(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, shift) a channel, bn(conv(x)) = conv_nobias(x)·scale + shift,
    in float32, or in float64 for a float64 model."""
    acc = torch.promote_types(conv.weight.dtype, torch.float32)
    scale = bn.weight.to(acc) / torch.sqrt(bn.running_var.to(acc) + bn.eps)
    b = conv.bias.to(acc) if conv.bias is not None else 0.0
    return scale, (b - bn.running_mean.to(acc)) * scale + bn.bias.to(acc)


class Folded:
    """One conv of a chain: its folded weight and bias, or, with no
    BatchNorm, the conv's own.  `carried` is a downsample's Folded whose
    bias this conv's epilogue adds; a `bare` conv (that downsample) runs
    with no bias."""

    def __init__(self, conv: nn.Conv2d, bn: nn.BatchNorm2d | None,
                 carried: Folded | None = None, bare: bool = False):
        self.conv, self.bn, self.carried, self.bare = conv, bn, carried, bare
        self.weight = self.bias = None
        if bn is not None:
            self.fold()

    def sources(self) -> list[tuple[dict, str]]:
        """(dict, key) of every tensor the folded values are computed from."""
        if self.bn is None:
            return []
        out = [(self.conv._parameters, n) for n in ("weight", "bias")
               if self.conv._parameters.get(n) is not None]
        out += [(self.bn._parameters, n) for n in ("weight", "bias")]
        out += [(self.bn._buffers, n) for n in ("running_mean", "running_var")]
        return out + (self.carried.sources() if self.carried is not None else [])

    def fold(self) -> None:
        """(Re)compute the folded weight and bias, in place where their
        storage already holds this dtype on this device."""
        w = self.conv.weight
        with torch.no_grad():
            scale, shift = _scale_shift(self.conv, self.bn)
            if self.carried is not None:
                shift = shift + _scale_shift(self.carried.conv, self.carried.bn)[1]
            new_w = w.to(scale.dtype) * scale.view(-1, 1, 1, 1)
            held = None if self.weight is None else (self.weight.dtype, self.weight.device)
            if held != (w.dtype, w.device):
                self.weight = torch.empty_like(w)
                self.bias = torch.empty(shift.shape, dtype=w.dtype, device=w.device)
            self.weight.copy_(new_w)
            self.bias.copy_(shift)

    def __call__(self, x: torch.Tensor, relu: bool, add: torch.Tensor | None) -> torch.Tensor:
        c = self.conv
        w, b = (c.weight, c.bias) if self.bn is None else (self.weight, self.bias)
        if self.bare:
            b = None
        if relu:
            fused_convs.count += 1
            if x.is_cuda and add is None:
                return torch.cudnn_convolution_relu(x, w, b, c.stride, c.padding, c.dilation,
                                                    c.groups)
            if x.is_cuda:
                return torch.cudnn_convolution_add_relu(x, w, add, 1.0, b, c.stride, c.padding,
                                                        c.dilation, c.groups)
        y = F.conv2d(x, w, b, c.stride, c.padding, c.dilation, c.groups)
        if add is not None:
            y = y + add
        return F.relu(y) if relu else y


class Folding:
    """The folded chains of one model (the module's docstring)."""

    def __init__(self, entries: list[Folded]):
        self.entries = {e.conv: e for e in entries}
        self._folded = [e for e in entries if e.bn is not None]
        slots = {(id(d), k): (d, k) for e in self._folded for d, k in e.sources()}
        self._slots = list(slots.values())
        self._stamp = self._read()

    def _read(self) -> list:
        """Each source's version, then each one's data pointer: an in-place
        write bumps the first, a move or a new tensor changes the second."""
        now = [d[k] for d, k in self._slots]
        return list(map(_VERSION, now)) + list(map(torch.Tensor.data_ptr, now))

    def refresh(self) -> bool:
        """Fold every chain again, each into its own storage, if a source
        changed since the last fold; whether one had."""
        now = self._read()
        if now == self._stamp:
            return False
        for e in self._folded:
            e.fold()
        self._stamp = now
        return True


def fold(model: nn.Module) -> Folding | None:
    """A Folding of every foldable chain that a module of `model` declares
    in `conv_chains()`: tuples (conv, bn) with bn None for a conv with bias
    and no BatchNorm, or (conv, bn, downsample conv, downsample bn) for a
    residual block's last conv; None where nothing folds."""
    entries = []
    for m in model.modules():
        for conv, bn, *shortcut in getattr(m, "conv_chains", lambda: ())():
            if not _foldable(conv, bn):
                continue
            carried = None
            if shortcut:
                if not _foldable(*shortcut) or bn is None:
                    continue
                carried = Folded(*shortcut, bare=True)
                entries.append(carried)
            entries.append(Folded(conv, bn, carried))
    if not entries or any(d[k].is_inference() for e in entries for d, k in e.sources()):
        return None  # inference tensors keep no version: a load could not be seen
    return Folding(entries)


@contextlib.contextmanager
def active(folding: Folding | None):
    """`folding`'s chains take the fused call in the body, on this thread
    (None: no chain does)."""
    token = _ACTIVE.set(folding)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def _entry(conv: nn.Module) -> Folded | None:
    folding = _ACTIVE.get()
    if folding is None or conv.training:
        return None
    return folding.entries.get(conv)


def conv_bn(conv: nn.Module, bn: nn.Module | None, x: torch.Tensor, relu: bool = True,
            add: torch.Tensor | None = None) -> torch.Tensor:
    """relu(bn(conv(x)) + add), the BatchNorm, the add and the ReLU each
    optional: one fused call where the active Folding holds `conv`, else
    the modules."""
    e = _entry(conv)
    if e is not None:
        return e(x, relu, add)
    y = conv(x)
    if bn is not None:
        y = bn(y)
    if add is not None:
        y = y + add
    return F.relu(y) if relu else y
