"""int8 post-training quantized inference (counterpart of fdt/ops/quant.py).

Weights are quantized per output channel and activations per tensor, both
symmetric (scale = amax/127, 1 for a zero tensor, q = clip(round(x/scale),
-127, 127)); XLA compiles fdt's amax/127 into amax * float32(1/127), and the
port computes that product, as fdt's compiled detectors do.  The convolution accumulates int8 × int8 products in int32, then
`float(acc) * (sx * sw[c])` is rounded to the model's dtype and the bias is
added in that dtype.  The activation's amax covers the whole batch tensor, as
in fdt, so an answer depends on the other images of its batch.  A conv whose
reduction kh·kw·cin/groups is below MIN_QUANT_REDUCTION keeps the float path.

Two hand-written CUDA kernels carry the quantized path on the card, neither
replacing a Pallas kernel (fdt leaves this path to XLA):

  K5, quantize_int8 (fdt_torch/csrc/quantize_int8.cu): the per-tensor amax
      and the quantization of fdt's quantize_symmetric(x, axes=None)
      (fdt/ops/quant.py:69-79, called at :121), written NHWC, with the scale
      left on the device (no host read);
  K4, conv_int8 (fdt_torch/csrc/conv_int8.cu): the int8 convolution and its
      dequantization epilogue (fdt/ops/quant.py:122-133), an implicit GEMM
      on the int8 tensor cores.

For CPU tensors each wrapper computes its plain version (quantize_int8_plain,
conv_int8_plain); for CUDA tensors it launches its kernel or raises.

`int8_convs` is the one place that decides which convs run in int8: it
swaps, in place, every eligible Conv2d of a model for an Int8Conv2d.  The
detectors' `quant="int8"` reaches every model through it, and so does the
mode switch `quantized("int8")`, fdt's API, which is read when a model is
built (fdt_torch.models.common.conv then passes each new conv through
int8_convs) where fdt reads it at trace time.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

from fdt_torch.ops.nms import _Launches

# Quantize a conv only when its per-output reduction (kh*kw*cin/groups) is at
# least this large; smaller convs keep the float path (fdt/ops/quant.py:41)
MIN_QUANT_REDUCTION = 32
# K4's block tile along N (output channels of a group) and K (the reduction):
# pack_weight pads the weights to these, so the kernel reads them unmasked
TILE_N, TILE_K = 64, 32
# float32(1/127): XLA rewrites fdt's division by the constant 127 into a
# product with its float32 reciprocal (the kernel's kInv127)
_INV127 = torch.tensor(1 / 127, dtype=torch.float32)

launches = _Launches()           # K4
quantize_launches = _Launches()  # K5

_STATE = threading.local()


def quant_mode() -> str | None:
    """The active quantization mode ("int8") or None; read by
    fdt_torch.models.common.conv when a model is built."""
    return getattr(_STATE, "mode", None)


def check_mode(mode: str | None) -> str | None:
    """`mode` if it is a quantization mode (None or "int8"); else ValueError."""
    if mode not in (None, "int8"):
        raise ValueError(f"unknown quantization mode: {mode!r}")
    return mode


@contextlib.contextmanager
def quantized(mode: str | None = "int8"):
    """Build-time switch: model convs built inside go through int8_convs."""
    check_mode(mode)
    prev = quant_mode()
    _STATE.mode = mode
    try:
        yield
    finally:
        _STATE.mode = prev


def quantize_symmetric(x: torch.Tensor, dims=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization: (q, scale) with x ≈ q * scale.

    `dims`: the reduction dims of the amax (None: the whole tensor; per output
    channel of an OIHW weight: (1, 2, 3), where fdt's HWIO kernel takes
    (0, 1, 2)).  The scale keeps the reduced dims: amax * float32(1/127),
    the product XLA compiles fdt's amax / 127.0 into (bit-equal to fdt's
    jitted function); zero tensors get scale 1.  A NaN quantizes to 0 and a
    NaN amax gives scale 1, as in fdt (XLA converts a NaN to int8 0).
    """
    xf = x.float()
    if dims is None:
        amax = xf.abs().amax().reshape([1] * x.dim())
    else:
        amax = xf.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(amax > 0, amax * _INV127, torch.ones_like(amax))
    r = torch.round(xf / scale)
    q = torch.where(torch.isnan(r), 0.0, r.clamp(-127, 127))
    return q.to(torch.int8), scale


def quantize_int8_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: [B,C,H,W] float32 or bf16 → (q [B,H,W,C] int8,
    contiguous; scale [1] float32)."""
    q, scale = quantize_symmetric(x)
    return q.permute(0, 2, 3, 1).contiguous(), scale.reshape(1)


def _check_activation(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"expected a [B,C,H,W] float32 or bfloat16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _dense(x: torch.Tensor) -> bool:
    """Contiguous NCHW or channels-last: every element once, no gaps."""
    return x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric quantization of an activation (K5 on the card).

    Args:
      x: [B,C,H,W] float32 or bfloat16, NCHW or channels-last.
    Returns: (q [B,H,W,C] int8 contiguous, scale [1] float32 on x's device).
    On the card two launches (the amax, then the quantization); the scale
    stays on the device.
    """
    _check_activation(x)
    if x.device.type == "cpu":
        return quantize_int8_plain(x)
    from fdt_torch.ops._build import library

    if not _dense(x):
        raise ValueError("x must be contiguous, NCHW or channels-last")
    if x.numel() >= 2**31:
        raise ValueError(f"tensor too large for the kernel: {x.numel()} elements")
    b, c, h, w = x.shape
    q = torch.empty((b, h, w, c), dtype=torch.int8, device=x.device)
    scale = torch.empty((1,), dtype=torch.float32, device=x.device)
    partials = torch.empty((library().fdt_quantize_int8_partials(x.numel()),),
                           dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = library().fdt_quantize_int8(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), partials.data_ptr(),
            int(x.dtype == torch.bfloat16), b, c, h, w, *x.stride(), stream)
    if err != 0:
        raise RuntimeError(f"fdt_quantize_int8 launch failed: CUDA error {err}")
    quantize_launches.count += 1
    return q, scale


def pack_weight(wq: torch.Tensor, groups: int) -> torch.Tensor:
    """int8 OIHW weights → K4's layout: [groups, Ng padded to TILE_N, K padded
    to TILE_K], K in (kh, kw, cin) order (the order of an NHWC patch), zeros
    in the padding."""
    o, cg, kh, kw = wq.shape
    ng, k = o // groups, kh * kw * cg
    packed = torch.zeros((groups, -(-ng // TILE_N) * TILE_N, -(-k // TILE_K) * TILE_K),
                         dtype=torch.int8, device=wq.device)
    packed[:, :ng, :k] = wq.permute(0, 2, 3, 1).reshape(groups, ng, k)
    return packed


def unpack_weight(packed: torch.Tensor, out_channels: int, cg: int,
                  kernel: tuple[int, int]) -> torch.Tensor:
    """pack_weight's inverse: the int8 OIHW weights."""
    groups = packed.shape[0]
    ng, (kh, kw) = out_channels // groups, kernel
    return (packed[:, :ng, :kh * kw * cg].reshape(out_channels, kh, kw, cg)
            .permute(0, 3, 1, 2))


def conv_output_size(size: int, kernel: int, stride: int, padding: int,
                     dilation: int) -> int:
    return (size + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def _epilogue(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
              bias: torch.Tensor | None, out_dtype: torch.dtype) -> torch.Tensor:
    """fdt's dequantization (fdt/ops/quant.py:128-133): the per-channel scale
    sx * sw first, then float(acc) * scale rounded to out_dtype, then the
    bias added in out_dtype."""
    s = (sx.reshape(()) * sw).reshape(1, -1, 1, 1)
    y = (acc.to(torch.float32) * s).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype).reshape(1, -1, 1, 1)
    return y


def conv_int8_plain(xq, sx, wpack, sw, bias, *, kernel, stride, padding, dilation,
                    groups, out_dtype, channels_last) -> torch.Tensor:
    """K4's plain version: the int8 convolution as float64 F.conv2d on the
    int8 values (exact: every partial sum is an integer below 2^53), cast to
    int32, then _epilogue.  Same arguments as conv_int8."""
    b, h, w, c = xq.shape
    wq = unpack_weight(wpack, sw.numel(), c // groups, kernel)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double(), None, stride, padding,
                   dilation, groups).to(torch.int32)
    y = _epilogue(acc, sx, sw, bias, out_dtype)
    return y.contiguous(memory_format=torch.channels_last if channels_last
                        else torch.contiguous_format)


def _check_conv(xq, sx, wpack, sw, bias, kernel, groups, out_dtype) -> None:
    if xq.dim() != 4 or xq.dtype != torch.int8:
        raise ValueError(f"xq must be [B,H,W,C] int8, got {xq.dtype} {tuple(xq.shape)}")
    c = xq.shape[-1]
    if groups < 1 or c % groups:
        raise ValueError(f"{c} input channels do not split into {groups} groups")
    n = sw.numel()
    k = kernel[0] * kernel[1] * (c // groups)
    if (wpack.dtype != torch.int8 or wpack.dim() != 3 or wpack.shape[0] != groups
            or n % groups or wpack.shape[1] < n // groups or wpack.shape[1] % TILE_N
            or wpack.shape[2] < k or wpack.shape[2] % TILE_K):
        raise ValueError(f"wpack must be pack_weight's int8 [groups, Ng, K] layout "
                         f"(groups {groups}, N {n}, K {k}), got {wpack.dtype} "
                         f"{tuple(wpack.shape)}")
    if sx.dtype != torch.float32 or sx.numel() != 1 or sw.dtype != torch.float32 or sw.dim() != 1:
        raise ValueError("sx must be one float32 value and sw a float32 vector")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if bias is not None and (bias.dtype != out_dtype or bias.shape != (n,)):
        raise ValueError(f"bias must be {out_dtype} ({n},), got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    tensors = [t for t in (sx, wpack, sw, bias) if t is not None]
    if any(t.device != xq.device for t in tensors):
        raise ValueError(f"every tensor must be on {xq.device}")
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xq.device}")


def conv_int8(xq: torch.Tensor, sx: torch.Tensor, wpack: torch.Tensor, sw: torch.Tensor,
              bias: torch.Tensor | None, *, kernel, stride, padding, dilation, groups: int,
              out_dtype: torch.dtype, channels_last: bool) -> torch.Tensor:
    """int8 × int8 → int32 convolution with fdt's dequantization (K4 on the
    card).

    Args:
      xq: [B,H,W,C] int8 activation (quantize_int8's q); sx: [1] float32 its
        scale.
      wpack: pack_weight's int8 weights; sw: [Cout] float32 their per-channel
        scales.
      bias: [Cout] in out_dtype, or None.
      kernel, stride, padding, dilation: (h, w) pairs; groups: int.
      out_dtype: float32 or bfloat16; channels_last: the output's layout.
    Returns: [B, Cout, Ho, Wo] in out_dtype.  On the card one launch.
    """
    _check_conv(xq, sx, wpack, sw, bias, kernel, groups, out_dtype)
    args = dict(kernel=kernel, stride=stride, padding=padding, dilation=dilation,
                groups=groups, out_dtype=out_dtype, channels_last=channels_last)
    if xq.device.type == "cpu":
        return conv_int8_plain(xq, sx, wpack, sw, bias, **args)
    from fdt_torch.ops._build import library

    if not all(t.is_contiguous() for t in (xq, wpack, sw)):
        raise ValueError("xq, wpack and sw must be contiguous")
    b, h, w, c = xq.shape
    ho, wo = (conv_output_size(s, k, st, p, d) for s, k, st, p, d in
              zip((h, w), kernel, stride, padding, dilation))
    n = sw.numel()
    if ho < 1 or wo < 1 or xq.numel() >= 2**31 or b * ho * wo * max(n, 1) >= 2**31:
        raise ValueError(f"unsupported conv: input {tuple(xq.shape)}, output "
                         f"{ho}x{wo}x{n}")
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    y = torch.empty((b, n, ho, wo), dtype=out_dtype, device=xq.device, memory_format=fmt)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = library().fdt_conv_int8(
            xq.data_ptr(), sx.data_ptr(), wpack.data_ptr(), sw.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            b, h, w, c, ho, wo, *kernel, *stride, *padding, *dilation, groups, n,
            wpack.shape[1], wpack.shape[2], *y.stride(), int(out_dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"fdt_conv_int8 launch failed: CUDA error {err}")
    launches.count += 1
    return y


def reduction(conv: nn.Conv2d) -> int:
    """Multiply-accumulates per output element: kh·kw·cin/groups."""
    return conv.kernel_size[0] * conv.kernel_size[1] * (conv.in_channels // conv.groups)


def is_channels_last(x: torch.Tensor) -> bool:
    """x is laid out channels-last (and not also plain contiguous)."""
    return not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)


class Int8Conv2d(nn.Conv2d):
    """nn.Conv2d running its contraction in int8 (fdt's Int8Conv).

    The parameters are nn.Conv2d's, with the same names, so a state dict of
    the float model loads unchanged.  The int8 weights and their per-channel
    scales are computed once from the weights (by quantize_weights: at the
    swap, at a state-dict load, or else at the first forward) and kept beside
    them, following the module across devices; fdt computes the same values
    inside its graph.  A conv whose reduction is below MIN_QUANT_REDUCTION
    keeps fdt's float path by staying an nn.Conv2d (int8_convs), so this
    class refuses one.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.padding_mode != "zeros" or isinstance(self.padding, str):
            raise ValueError("Int8Conv2d takes zero padding given as integers")
        if reduction(self) < MIN_QUANT_REDUCTION:
            raise ValueError(f"reduction {reduction(self)} is below MIN_QUANT_REDUCTION "
                             f"({MIN_QUANT_REDUCTION}): such a conv stays an nn.Conv2d")
        self._int8 = None  # (packed int8 weights, per-channel scales)

    def quantize_weights(self) -> None:
        """Quantize the current weights, in float32, per output channel."""
        wq, sw = quantize_symmetric(self.weight.detach().float(), dims=(1, 2, 3))
        self._int8 = (pack_weight(wq, self.groups), sw.reshape(-1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._int8 is None:
            self.quantize_weights()
        wpack, sw = self._int8
        xq, sx = quantize_int8(x)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return conv_int8(xq, sx, wpack, sw, bias, kernel=self.kernel_size,
                         stride=self.stride, padding=self.padding, dilation=self.dilation,
                         groups=self.groups, out_dtype=x.dtype,
                         channels_last=is_channels_last(x))

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        if self._int8 is not None:  # the device follows; the int8 values stay
            self._int8 = tuple(t.to(self.weight.device) for t in self._int8)
        return self

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.quantize_weights()


def _as_int8(conv: nn.Conv2d) -> Int8Conv2d:
    """An Int8Conv2d of conv's geometry holding conv's parameter objects."""
    q = Int8Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride,
                   conv.padding, conv.dilation, conv.groups, bias=conv.bias is not None,
                   padding_mode=conv.padding_mode, device="meta")
    q.weight, q.bias = conv.weight, conv.bias
    q.train(conv.training)
    q.quantize_weights()
    return q


def int8_convs(module: nn.Module) -> nn.Module:
    """Swap, in place, every Conv2d of module whose reduction reaches
    MIN_QUANT_REDUCTION for an Int8Conv2d holding the same parameter
    objects, quantized from the weights as they are now; the others stay
    nn.Conv2d and keep the float path.  Returns module, or its Int8Conv2d
    when module itself is such a conv.  To keep a model unchanged, pass a
    copy (fdt_torch.infer.pyramidbox.place_model)."""
    if isinstance(module, nn.Conv2d):
        return _as_int8(module) if reduction(module) >= MIN_QUANT_REDUCTION else module
    for name, child in module.named_children():
        setattr(module, name, int8_convs(child))
    return module
