"""Image height sharded over the `space` axis of the 2-D data x space mesh
(fdt_torch.dist.mesh.make_mesh_2d): the band geometry, the halo exchanges
and the gather of the head outputs.

fdt shards its NHWC images as P("data", "space") and XLA's SPMD partitioner
inserts every convolution's halo exchange.  The port writes them by hand:

  * Band rule.  A map of global height h is split over the n space ranks as
    band(h, n, r) = [r·h//n, (r+1)·h//n): it depends on h, n and the rank
    alone, so two maps of one global height always have the same bands and
    a residual add, ContextTexture's add and a channel concatenation stay
    local.  A band may be empty (a 1-row map over 2 ranks).
  * An op on a band (conv2d, max_pool2d, upsample_crop) computes its own
    output band.  The input rows that band reads form a window; the rows of
    the window that other ranks hold are fetched by an exchange, rows past
    a global edge are the op's fill (zeros for a conv, -inf for max-pool),
    and the op then runs with no padding along H.  A rank whose output band
    is empty still takes part in the exchange and runs the op on a window
    of one output row, of fill alone, that it drops: its band stays in the
    autograd graph, so every rank runs every collective of the backward,
    in the same order (autograd runs the nodes in reverse creation order).
  * The exchange is an autograd.Function over the space group's all_gather
    (gloo takes card tensors in all_gather; its send/recv take host tensors
    only): forward, each rank gathers the rows the other ranks' windows need
    from it; backward, the gradients of the fetched rows go back the same
    way and each owner adds them into its band's gradient.  A halo reaches
    as many ranks as it needs (a 2-row halo over 1-row bands).
  * gather_rows collects a band over the whole map (the head outputs, which
    the MultiBox loss needs whole); its backward keeps the rank's own band.

The ops take a global height, which PyramidTrainer records once at the
global size: `recording()` makes every op run whole and store its input's
height on its module (op_height), keyed by module so that remat's
recompute finds it again.  An op with no recorded height (a model no
trainer planned, such as a detector's) runs whole.  The pure functions
(band, conv_out_height, conv_rows, upsample_rows, window_pieces,
halo_plan) need no process group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from fdt_torch.dist import multihost

# > 0 while the ops run whole at the global size and record their heights
# (a plain counter, as common.running_stats_frozen's)
_RECORDING = 0


# -- band geometry ---------------------------------------------------------------

def band(h: int, n: int, r: int) -> tuple[int, int]:
    """Rows [lo, hi) of a map of global height h that space rank r of n holds."""
    return r * h // n, (r + 1) * h // n


def conv_out_height(h: int, kernel: int, stride: int = 1, dilation: int = 1,
                    pad: tuple[int, int] = (0, 0)) -> int:
    """Output height of a conv or pool over h rows padded by pad (top, bottom)."""
    return (h + pad[0] + pad[1] - dilation * (kernel - 1) - 1) // stride + 1


def conv_rows(a: int, b: int, kernel: int, stride: int = 1, dilation: int = 1,
              pad_top: int = 0) -> tuple[int, int]:
    """Input rows [lo, hi) that output rows [a, b) (b > a) of a conv or pool
    read: [a·s − p, (b−1)·s − p + d·(k−1)]; rows outside the map are fill."""
    return a * stride - pad_top, (b - 1) * stride - pad_top + dilation * (kernel - 1) + 1


def upsample_rows(a: int, b: int, h: int) -> tuple[int, int]:
    """Input rows [lo, hi) that output rows [a, b) (b > a) of a ×2 bilinear
    upsample (half-pixel centres, clamped at the edges) of h rows read: row i
    samples rows ⌊(i−1)/2⌋ and ⌈i/2⌉, clipped to the map.  Run on these rows
    alone, the upsample gives rows [2·lo, 2·hi), of which [a, b) sample at
    the whole map's positions: away from a global edge the window keeps one
    row on each side, and at one it ends where the map does."""
    return max(0, (a - 1) // 2), min(h, b // 2 + 1)


def window_pieces(h: int, n: int, lo: int, hi: int, real: bool = True) -> tuple:
    """The window of global rows [lo, hi) over a map of h rows in n bands, as
    ((q, u, v), ...) in row order: rows [u, v) held by rank q, or fill
    (q = -1) past an edge; all fill when not `real`."""
    if not real:
        return ((-1, lo, hi),)
    out = []
    if lo < 0:
        out.append((-1, lo, min(0, hi)))
    for q in range(n):
        b_lo, b_hi = band(h, n, q)
        u, v = max(lo, b_lo), min(hi, b_hi)
        if u < v:
            out.append((q, u, v))
    if hi > h:
        out.append((-1, max(lo, h), hi))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Who sends which rows to whom for one op, the same on every rank.

    pieces[r]: rank r's window (window_pieces); pairs: (src, dst, u, v), the
    rows [u, v) src sends dst, ordered by dst then row (so by src within a
    dst, bands being in rank order); width / back_width: the rows of the
    largest forward / backward payload (0: nothing to exchange)."""
    h: int
    n: int
    pieces: tuple
    pairs: tuple
    width: int
    back_width: int

    def sends(self, r: int) -> list:
        """The pairs rank r sends, in its forward payload's order."""
        return [p for p in self.pairs if p[0] == r]

    def receives(self, r: int) -> list:
        """The pairs rank r receives, in its backward payload's order."""
        return [p for p in self.pairs if p[1] == r]

    def offset(self, pair: tuple, backward: bool = False) -> int:
        """Row offset of `pair` in its sender's forward payload, or (backward)
        in its receiver's backward payload."""
        src, dst = pair[:2]
        same = self.receives(dst) if backward else self.sends(src)
        return sum(v - u for (_, _, u, v) in same[:same.index(pair)])


@functools.lru_cache(maxsize=4096)
def halo_plan(h: int, n: int, windows: tuple) -> HaloPlan:
    """The exchange of an op whose rank r reads windows[r] = (lo, hi, real)
    of an input of global height h."""
    pieces = tuple(window_pieces(h, n, *w) for w in windows)
    pairs = tuple((q, r, u, v) for r in range(n) for (q, u, v) in pieces[r]
                  if q >= 0 and q != r)
    width = max(sum(v - u for (s, _, u, v) in pairs if s == r) for r in range(n))
    back = max(sum(v - u for (_, d, u, v) in pairs if d == r) for r in range(n))
    return HaloPlan(h, n, pieces, pairs, width, back)


def conv_windows(h_out: int, n: int, kernel: int, stride: int, dilation: int,
                 pad_top: int) -> tuple:
    """Each rank's (lo, hi, real) window for a conv or pool of output height
    h_out: its output band's rows, or, for an empty band, one output row's
    rows of fill."""
    out = []
    for r in range(n):
        a, b = band(h_out, n, r)
        out.append((*conv_rows(a, max(b, a + 1), kernel, stride, dilation, pad_top), a < b))
    return tuple(out)


# -- the transport -----------------------------------------------------------------

class GroupComm:
    """The space group's all_gather (torch.distributed: NCCL on cards, gloo
    on the CPU or when asked)."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def all_gather(self, x: torch.Tensor) -> list:
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return out


def space_comm() -> GroupComm:
    """This process's space group; raises without one."""
    group = multihost.space_group()
    if group is None:
        raise RuntimeError("no space group: make_mesh_2d(n_data, n_space) with n_space > 1 "
                           "makes one")
    return GroupComm(group)


def _rows(x: torch.Tensor, u: int, v: int) -> torch.Tensor:
    return x[:, :, u:v]


def _payload(parts: list, like: torch.Tensor, width: int) -> torch.Tensor:
    """The row slices `parts` stacked along H, zero-padded to `width` rows."""
    b, c, _, w = like.shape
    used = sum(p.shape[2] for p in parts)
    if used < width:
        parts = parts + [like.new_zeros((b, c, width - used, w))]
    return torch.cat(parts, 2)


class _Exchange(torch.autograd.Function):
    """This rank's band → its window of the op's input (see the module's
    docstring); the backward sends the fetched rows' gradients back."""

    @staticmethod
    def forward(ctx, x, plan: HaloPlan, comm, fill: float):
        r = comm.rank
        lo = band(plan.h, plan.n, r)[0]
        ctx.plan, ctx.comm, ctx.shape = plan, comm, x.shape
        gathered = None
        if plan.width:
            sends = [_rows(x, u - lo, v - lo) for (_, _, u, v) in plan.sends(r)]
            gathered = comm.all_gather(_payload(sends, x, plan.width))
        b, c, _, w = x.shape
        parts = []
        for (q, u, v) in plan.pieces[r]:
            if q < 0:
                parts.append(x.new_full((b, c, v - u, w), fill))
            elif q == r:
                parts.append(_rows(x, u - lo, v - lo))
            else:
                at = plan.offset((q, r, u, v))
                parts.append(gathered[q][:, :, at:at + v - u])
        return torch.cat(parts, 2) if len(parts) > 1 else parts[0].clone()

    @staticmethod
    def backward(ctx, grad):
        plan, comm = ctx.plan, ctx.comm
        r = comm.rank
        lo = band(plan.h, plan.n, r)[0]
        gx = grad.new_zeros(ctx.shape)
        at, back = 0, []
        for (q, u, v) in plan.pieces[r]:
            if q == r:
                gx[:, :, u - lo:v - lo] += grad[:, :, at:at + v - u]
            elif q >= 0:
                back.append(grad[:, :, at:at + v - u])
            at += v - u
        if plan.back_width:
            gathered = comm.all_gather(_payload(back, grad, plan.back_width))
            for pair in plan.sends(r):
                _, dst, u, v = pair
                off = plan.offset(pair, backward=True)
                gx[:, :, u - lo:v - lo] += gathered[dst][:, :, off:off + v - u]
        return gx, None, None, None


def exchange(x: torch.Tensor, h: int, windows: tuple, fill: float = 0.0,
             comm=None) -> torch.Tensor:
    """This rank's window (windows[rank] = (lo, hi, real)) of a map of global
    height h whose band x [B, C, rows, W] it holds; rows past an edge (and
    every row of a window that is not real) are `fill`."""
    comm = comm or space_comm()
    plan = halo_plan(h, comm.size, windows)
    if not plan.width and plan.pieces[comm.rank] == ((comm.rank,) + band(h, comm.size, comm.rank),):
        return x  # no rank fetches a row and the window is the band (a 1×1 conv): no copy
    return _Exchange.apply(x, plan, comm, fill)


class _GatherRows(torch.autograd.Function):
    """The bands of a map of global height h → the whole map, on every rank."""

    @staticmethod
    def forward(ctx, x, h: int, comm):
        n = comm.size
        sizes = [band(h, n, q)[1] - band(h, n, q)[0] for q in range(n)]
        ctx.rows = band(h, n, comm.rank)
        b, c, rows, w = x.shape
        padded = x if rows == max(sizes) else torch.cat(
            [x, x.new_zeros((b, c, max(sizes) - rows, w))], 2)
        gathered = comm.all_gather(padded)
        return torch.cat([g[:, :, :s] for g, s in zip(gathered, sizes)], 2)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[:, :, lo:hi].contiguous(), None, None


def gather_rows(x: torch.Tensor, h: int, comm=None) -> torch.Tensor:
    """The whole map of global height h from each space rank's band x; the
    gradient of each rank keeps its own band's rows (every rank computes the
    same gradient of the whole map)."""
    comm = comm or space_comm()
    return _GatherRows.apply(x, h, comm)


# -- the ops on a band -----------------------------------------------------------

def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads(padding) -> tuple:
    """((top, bottom), (left, right)) from an int, (ph, pw) or ((t, b), (l, r))."""
    ph, pw = _pair(padding)
    return _pair(ph), _pair(pw)


def _w_padded(window: torch.Tensor, pad_w: tuple[int, int], fill: float):
    """(window, the op's W padding): symmetric padding stays the op's own,
    other padding is applied here."""
    if pad_w[0] == pad_w[1]:
        return window, pad_w[0]
    return F.pad(window, pad_w, value=fill), 0


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias, h: int, stride=1, padding=0,
           dilation=1, groups: int = 1, comm=None) -> torch.Tensor:
    """F.conv2d of a map of global height h (zero padding), on this rank's
    band x: returns the rank's band of the output."""
    comm = comm or space_comm()
    (sh, sw), (dh, dw) = _pair(stride), _pair(dilation)
    pad_h, pad_w = _pads(padding)
    k = weight.shape[2]
    h_out = conv_out_height(h, k, sh, dh, pad_h)
    window = exchange(x, h, conv_windows(h_out, comm.size, k, sh, dh, pad_h[0]), 0.0, comm)
    window, pw = _w_padded(window, pad_w, 0.0)
    y = F.conv2d(window, weight, bias, (sh, sw), (0, pw), (dh, dw), groups)
    a, b = band(h_out, comm.size, comm.rank)
    return y[:, :, :b - a]


def max_pool2d(x: torch.Tensor, h: int, kernel: int, stride: int, padding: int = 0,
               comm=None) -> torch.Tensor:
    """F.max_pool2d (padding with -inf) of a map of global height h, on this
    rank's band x: returns the rank's band of the output."""
    comm = comm or space_comm()
    h_out = conv_out_height(h, kernel, stride, 1, (padding, padding))
    windows = conv_windows(h_out, comm.size, kernel, stride, 1, padding)
    window = exchange(x, h, windows, float("-inf"), comm)
    y = F.max_pool2d(window, kernel, stride, (0, padding))
    a, b = band(h_out, comm.size, comm.rank)
    return y[:, :, :b - a]


def upsample_crop(x: torch.Tensor, h: int, h_out: int, w_out: int, comm=None) -> torch.Tensor:
    """ContextTexture's ×2 bilinear upsample (half-pixel centres) of a map of
    global height h, cropped to [h_out, w_out], on this rank's band x:
    returns the rank's band of the cropped map (global height h_out ≤ 2h)."""
    comm = comm or space_comm()
    windows = []
    for r in range(comm.size):
        a, b = band(h_out, comm.size, r)
        windows.append((*upsample_rows(a, b, h), True) if a < b else (0, 1, False))
    windows = tuple(windows)
    window = exchange(x, h, windows, 0.0, comm)
    lo, _, _ = windows[comm.rank]
    a, b = band(h_out, comm.size, comm.rank)
    res = F.interpolate(window, size=(2 * window.shape[2], 2 * window.shape[3]),
                        mode="bilinear", align_corners=False)
    at = a - 2 * lo if a < b else 0
    return res[:, :, at:at + b - a, :w_out]


# -- the modules -----------------------------------------------------------------

@contextlib.contextmanager
def recording():
    """Every op of the body runs whole and stores its input's global height
    on its module (op_height)."""
    global _RECORDING
    _RECORDING += 1
    try:
        yield
    finally:
        _RECORDING -= 1


def is_recording() -> bool:
    return _RECORDING > 0


def op_height(owner: nn.Module, name: str, x: torch.Tensor) -> int | None:
    """The global height of the input `x` of `owner`'s op `name`, which
    then runs on its band: while recording, x's height is stored and None
    returned (the op runs whole); None too when none was recorded (a model
    no trainer planned, which takes whole images: the op runs whole)."""
    heights = owner.__dict__.setdefault("space_heights", {})
    if _RECORDING:
        heights[name] = x.shape[2]
        return None
    return heights.get(name)


class BandConv2d(nn.Conv2d):
    """An nn.Conv2d that, while a space group exists, convolves its rank's
    band (conv2d) of an input whose global height it recorded; the plain
    conv otherwise (no group, or no height recorded).  band_convs makes a
    model's convs this class in place."""

    def forward(self, x):
        if multihost.space_group() is None:
            return super().forward(x)
        h = op_height(self, "x", x)
        if h is None:
            return super().forward(x)
        return conv2d(x, self.weight, self.bias, h, self.stride, self.padding,
                      self.dilation, self.groups)

    def out_height(self) -> int:
        """The global height of this conv's output (from the recorded input's)."""
        return conv_out_height(self.space_heights["x"], self.kernel_size[0], self.stride[0],
                               self.dilation[0], (self.padding[0],) * 2)


def band_convs(model: nn.Module) -> nn.Module:
    """Every nn.Conv2d of `model` (not a subclass: an int8 conv keeps its
    class) made a BandConv2d in place: the same object, parameters and state
    dict.  Returns the model."""
    for m in model.modules():
        if type(m) is nn.Conv2d:
            if m.padding_mode != "zeros" or isinstance(m.padding, str):
                raise ValueError(f"{m}: a banded conv takes zero padding given as integers")
            m.__class__ = BandConv2d
    return model


def whole_map(conv: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """y = conv(...) over the whole map: y itself, or, while a space group
    exists and conv ran banded, the rows of every space rank's band."""
    if (multihost.space_group() is None or _RECORDING
            or "x" not in conv.__dict__.get("space_heights", {})):
        return y
    return gather_rows(y, conv.out_height())
