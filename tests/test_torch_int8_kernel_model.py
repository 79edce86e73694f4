"""Numpy models of the int8 path's kernels on the CPU: K4's wgmma variant
(fdt_torch/csrc/conv_int8.cu, conv_int8_wgmma_kernel) and K5
(fdt_torch/csrc/quantize_int8.cu), and the wrapper's choice of K4 variant.

K4's model follows the kernel's producer and consumers: 128-row tiles of
output pixels by N tiles of conv_tile_n(N), walked by a persistent grid;
stages of 64 bytes of K, each four 16-byte chunks whose tap and channel
advance by addition; a row's chunk read from the NHWC activation at its
window's corner plus the tap's offset, zero at the image's edge, past K and
past M; the weight chunk of the tile's rows from pack_weight's K-chunk-major
layout (rows past the padded N left stale); two k32 products a stage; the
stores of the dense bf16 path (16-byte pieces of a staged row).  K5's model
follows its grid: as many blocks as a turn of 4 chunks a thread needs, at
most the resident ones; each block's share and partial maximum of |x|'s
bits; the grid barrier of an arrival counter and a generation; the second
walk in reverse.  Both are held to the plain versions, so that a fault of
order or addressing shows here before the card runs it.
"""
import collections
import itertools
import math
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt_torch.models import FaceBox  # noqa: E402
from fdt_torch.models.loader import build_pyramidbox  # noqa: E402
from fdt_torch.ops import quant  # noqa: E402

torch.set_num_threads(1)

TILE_M, STAGE_K, CHUNK = 128, 64, 16  # the kernel's kTileM, kStageK, 16-byte chunks
K5_THREADS, K5_UNROLL = 512, 4
RESIDENT = 132 * 2  # K5's resident blocks on an H100 (2 blocks of 512 threads an SM)
NOT_WRITTEN = 1000  # no int8 value

# (int8 convs a forward runs, of them the wgmma variant's): the flagship
# runs 111 (its 3-channel stem takes mma_sync), try1 79 (its 3-channel
# stem and its two grouped 1×1s), FaceBoxes 33 (its stem and the six convs
# of 24 input channels)
MODELS = {
    "flagship": (lambda: build_pyramidbox("repo"), (8, 3, 640, 640), 111, 110),
    "try1": (lambda: build_pyramidbox("try1"), (8, 3, 640, 640), 79, 76),
    "facebox": (FaceBox, (16, 3, 1024, 1024), 33, 26),
}


def model_convs(name: str) -> list:
    """(conv, input shape, output shape) of every int8 conv a forward of the
    model runs, at its main path's size, from a forward on the meta device."""
    build, shape, _, _ = MODELS[name]
    with torch.device("meta"):
        model = build().eval()
    seen = []

    def hook(mod, inputs, out):
        seen.append((mod, tuple(inputs[0].shape), tuple(out.shape)))

    # the convs int8_convs swaps (the meta tensors cannot be quantized)
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)
               and quant.reduction(m) >= quant.MIN_QUANT_REDUCTION]
    with torch.no_grad():
        model(torch.empty(shape, device="meta"))
    for h in handles:
        h.remove()
    return seen


@pytest.mark.parametrize("name", list(MODELS))
def test_every_int8_conv_gets_a_variant_and_a_tile(name):
    """Every int8 conv of the flagship, try1 and FaceBoxes at its main
    path's size: the variant conv_variant picks on K5's output (aligned),
    the wgmma variant for all but the convs named in MODELS, an N tile that
    holds N (or the widest), and the mma_sync variant exactly where a
    16-byte piece of a patch row could straddle two taps or the conv is
    grouped."""
    _, _, runs, wgmma = MODELS[name]
    convs = model_convs(name)
    assert len(convs) == runs
    picks = collections.Counter()
    for conv, (b, c, h, w), (_, n, ho, wo) in convs:
        v = quant.conv_variant(c, conv.groups, 0)
        picks[v] += 1
        assert v == ("wgmma" if conv.groups == 1 and c % 16 == 0 else "mma_sync")
        tile = quant.conv_tile_n(n)
        assert tile in quant.WGMMA_TILE_N and (tile >= n or tile == quant.WGMMA_TILE_N[-1])
        assert b * ho * wo < 2**31
    assert picks == {"wgmma": wgmma, "mma_sync": runs - wgmma}


def test_flagship_conv_classes_and_tiles():
    """The flagship's 111 int8 convs by the classes the sweeps report: 51
    wide k×k, 47 1×1, 12 heads (N 4, tile 8) and the 7×7 stem; every wide
    and 1×1 conv on a tile of 64 to 256."""
    convs = model_convs("flagship")
    classes = collections.Counter(chip_smoke.int8_conv_class(c) for c, _, _ in convs)
    assert classes == {"wide kxk": 51, "1x1": 47, "head": 12, "stem": 1}
    for conv, _, (_, n, _, _) in convs:
        cls = chip_smoke.int8_conv_class(conv)
        if cls != "stem":
            assert quant.conv_tile_n(n) == (8 if cls == "head" else min(n, 256))


@pytest.mark.parametrize("name", [*chip_smoke.INT8_EDGES, *chip_smoke.INT8_TILE_EDGES])
def test_edge_cases_get_the_expected_variant(name):
    """The card's edge cases: the 3- and 12-channel and grouped edges take
    mma_sync, every other one wgmma (K5's output is aligned; the offset
    views are of x, not of q)."""
    x, conv, _ = chip_smoke.int8_edge_case(name)
    xq, _ = quant.quantize_int8(x)
    v = quant.conv_variant(xq.shape[-1], conv.groups, xq.data_ptr())
    want = "mma_sync" if conv.groups > 1 or conv.in_channels % 16 else "wgmma"
    assert v == want
    if name in chip_smoke.INT8_TILE_EDGES:
        assert v == "wgmma"


def test_unaligned_activation_takes_mma_sync():
    assert quant.conv_variant(64, 1, 16 * 9) == "wgmma"
    assert quant.conv_variant(64, 1, 16 * 9 + 1) == "mma_sync"
    assert quant.conv_variant(48, 1, 0) == "wgmma"
    assert quant.conv_variant(24, 1, 0) == "mma_sync"
    assert quant.conv_variant(64, 2, 0) == "mma_sync"


def _advance(tap: list, step: int, c: int, kw: int) -> None:
    """A producer thread's tap (kr, ks) and channel c0, `step` bytes of K on."""
    tap[2] += step
    while tap[2] >= c:
        tap[2] -= c
        tap[1] += 1
        if tap[1] == kw:
            tap[1], tap[0] = 0, tap[0] + 1


def k4_wgmma_model(xq: np.ndarray, wpack: np.ndarray, n: int, kernel, stride, padding,
                   dilation, grid: int = 132, seed: int = 0):
    """K4's wgmma variant in numpy: xq [B,H,W,C] int8, wpack pack_weight's
    [1, Kp/16, Ngp, 16] → (acc [M, n] int64, writes [M, n]: how often the
    dense path's 16-byte stores write each output, or None where N is not a
    multiple of 8)."""
    b, h, w, c = xq.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    ho, wo = (quant.conv_output_size(*a) for a in
              zip((h, w), kernel, stride, padding, dilation))
    m_total = b * ho * wo
    chunks, ngp = wpack.shape[1], wpack.shape[2]
    assert chunks * CHUNK % STAGE_K == 0 and c % CHUNK == 0
    stages = chunks * CHUNK // STAGE_K
    bn = quant.conv_tile_n(n)
    tiles_m = -(-m_total // TILE_M)
    tiles = tiles_m * -(-n // bn)
    flat = xq.reshape(-1).astype(np.int64)
    rng = np.random.RandomState(seed)
    acc = np.full((m_total, n), -(2**40), np.int64)  # every output is written once
    writes = np.zeros((m_total, n), np.int64) if n % 8 == 0 else None
    walked = []
    for block in range(min(tiles, grid)):
        walked += list(range(block, tiles, min(tiles, grid)))  # the persistent walk
    assert sorted(walked) == list(range(tiles))
    a_smem = rng.randint(-128, 128, (TILE_M, 4, CHUNK))   # shared memory starts stale
    b_smem = rng.randint(-128, 128, (bn, 4, CHUNK))
    for tile in walked:
        m0, n0 = (tile % tiles_m) * TILE_M, (tile // tiles_m) * bn
        m = m0 + np.arange(TILE_M)
        row_ok = m < m_total
        bi, rem = m // (ho * wo), m % (ho * wo)
        hi0, wi0 = (rem // wo) * sh - ph, (rem % wo) * sw - pw
        row = ((bi * h + hi0) * w + wi0) * c
        rows_b = min(bn, ngp - n0)
        # the producer threads of chunk j: tap (kr, ks) and channel c0 of K
        # chunk 4 st + j, advanced 64 bytes a stage
        taps = []
        for j in range(4):
            tap = [0, 0, CHUNK * j]
            _advance(tap, 0, c, kw)
            taps.append(tap)
        tile_acc = np.zeros((TILE_M, bn), np.int64)
        for st in range(stages):
            for j in range(4):
                kr, ks, c0 = taps[j]
                b_smem[:rows_b, j] = wpack[0, st * 4 + j, n0:n0 + rows_b]
                hi, wi = hi0 + kr * dh, wi0 + ks * dw
                ok = row_ok & (kr < kh) & (hi >= 0) & (hi < h) & (wi >= 0) & (wi < w)
                src = row + (kr * dh * w + ks * dw) * c + c0
                a_smem[:, j] = 0
                a_smem[ok, j] = flat[src[ok][:, None] + np.arange(CHUNK)]
                _advance(taps[j], STAGE_K, c, kw)
            for kk in range(STAGE_K // 32):  # two wgmma k32 products a stage
                a = a_smem[:, 2 * kk:2 * kk + 2].reshape(TILE_M, 32)
                bt = b_smem[:, 2 * kk:2 * kk + 2].reshape(bn, 32)
                tile_acc += a @ bt.T
        cols = min(bn, n - n0)
        rows = min(TILE_M, m_total - m0)
        acc[m0:m0 + rows, n0:n0 + cols] = tile_acc[:rows, :cols]
        if writes is not None:  # staged row r, piece p → y[m0 + r, n0 + 8p : + 8]
            for r, p in itertools.product(range(rows), range(bn // 8)):
                if 8 * p < cols:
                    writes[m0 + r, n0 + 8 * p:n0 + 8 * p + 8] += 1
    return acc, writes


def _reference_acc(xq: np.ndarray, conv) -> np.ndarray:
    """The int32 sums of the conv on xq [B,H,W,C], by float64 F.conv2d on
    the int8 values (exact), [M, N]."""
    wq = quant.unpack_weight(conv._int8[0], conv.out_channels, conv.in_channels,
                             conv.kernel_size)
    xt = torch.from_numpy(xq).permute(0, 3, 1, 2).double()
    acc = F.conv2d(xt, wq.double(), None, conv.stride, conv.padding, conv.dilation)
    return acc.permute(0, 2, 3, 1).reshape(-1, conv.out_channels).numpy().astype(np.int64)


# the edge cases that take the wgmma variant (groups 1, channels a multiple
# of 16), cut to a batch of 1 (and the persistent ones to 16 rows) so that
# the model stays fast
MODEL_CASES = [name for name, case in [*chip_smoke.INT8_EDGES.items(),
                                       *chip_smoke.INT8_TILE_EDGES.items()]
               if case[9] == 1 and case[1] % 16 == 0]


@pytest.mark.parametrize("name", MODEL_CASES)
def test_k4_wgmma_model_equals_the_convolution(name):
    """The model's int32 sums equal F.conv2d's on the int8 values for each
    wgmma edge case, with a small grid (so that blocks walk several tiles),
    and the dense path writes every output exactly once."""
    x, conv, _ = chip_smoke.int8_edge_case(name)
    x = x[:1]
    if name.startswith("persistent"):
        x = x[:, :, :16]
    xq, _ = quant.quantize_int8(x.float())
    xq = xq.numpy()
    wpack, _ = conv.float()._int8
    acc, writes = k4_wgmma_model(xq, wpack.numpy(), conv.out_channels, conv.kernel_size,
                                 conv.stride, conv.padding, conv.dilation, grid=3)
    np.testing.assert_array_equal(acc, _reference_acc(xq, conv))
    if writes is not None:
        assert (writes == 1).all()


def test_k4_wgmma_model_on_a_flagship_geometry():
    """A flagship 3×3 conv (256 → 256) and its stride-2 sibling on a small
    input: the model against the convolution."""
    rng = np.random.RandomState(7)
    for stride in (1, 2):
        conv = quant.Int8Conv2d(256, 256, 3, stride, 1)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(rng.randn(256, 256, 3, 3).astype(np.float32)))
        conv.quantize_weights()
        xq = rng.randint(-127, 128, (1, 11, 9, 256)).astype(np.int8)
        acc, writes = k4_wgmma_model(xq, conv._int8[0].numpy(), 256, (3, 3), (stride, stride),
                                     (1, 1), (1, 1), grid=2)
        np.testing.assert_array_equal(acc, _reference_acc(xq, conv))
        assert (writes == 1).all()


class GridBarrier:
    """K5's grid barrier: (arrived, generation, amax) kept across calls; the
    last block in reduces the partials, resets the count and bumps the
    generation; a block waiting on the generation it read before arriving
    is released by that bump."""

    def __init__(self):
        self.arrived, self.generation, self.amax = 0, 0, 0

    def run(self, partials: np.ndarray, order) -> int:
        waiting = {}
        for block in order:
            gen = self.generation
            self.arrived += 1
            if self.arrived == len(partials):
                self.amax = int(partials.max())
                self.arrived = 0
                self.generation = (self.generation + 1) % 2**32
                assert all(self.generation != g for g in waiting.values())
            else:
                waiting[block] = gen
                assert self.generation == gen  # held until the last block
        return self.amax


def k5_quantize(v: np.ndarray, scale: np.float32) -> np.ndarray:
    """K5's quantize(): rint(v * fl(1 / scale)), and the correctly rounded
    quotient only where that product lies within 2^-14 of a half-integer (or
    the scale is subnormal or infinite, whose reciprocal is not used);
    clipped to ±127, NaN to 0."""
    scale = np.float32(scale)
    with np.errstate(all="ignore"):
        inv = np.float32(1) / scale if scale >= np.finfo(np.float32).tiny else np.float32(0)
        y = (v * inv).astype(np.float32)
        r = np.rint(y)
        near_half = np.abs(np.abs(y - r) - np.float32(0.5))
        slow = (inv == 0) | (near_half <= np.float32(2.0**-14))
        r = np.where(slow, np.rint(v / scale), r)
    return np.where(np.isnan(r), 0, np.clip(r, -127, 127)).astype(np.int64)


def k5_grid(n: int, element_size: int, resident: int = RESIDENT) -> int:
    """K5's blocks for n elements (fdt_quantize_int8_grid): a turn of
    K5_UNROLL 16-byte chunks a thread, at most the resident blocks."""
    chunks = -(-n // (16 // element_size))
    return max(1, min(resident, -(-chunks // (K5_UNROLL * K5_THREADS))))


def k5_model(x: torch.Tensor, resident: int = RESIDENT, barrier: GridBarrier | None = None):
    """K5 in numpy: (q [B,H,W,C] int8, scale float32, the blocks, each
    thread's first and second walks over its 16-byte chunks)."""
    xf = x.float()
    b, c, h, w = x.shape
    n = x.numel()
    vec = 16 // x.element_size()
    aligned = x.data_ptr() % 16 == 0
    sb, sc, sh, sw = x.stride()
    nhwc = sc == 1 and sw == c and sh == w * c and sb == h * w * c
    grid = k5_grid(n, x.element_size(), resident)
    stride = grid * K5_THREADS
    chunks = n // vec if aligned else 0
    turns = -(-chunks // (K5_UNROLL * stride))
    # the dense storage in memory order, as |x|'s float32 bits
    storage = (xf.permute(0, 2, 3, 1) if quant.is_channels_last(x) else xf).reshape(-1).numpy()
    bits = np.abs(storage).view(np.uint32)
    first, second = collections.defaultdict(list), collections.defaultdict(list)
    partials = np.zeros(grid, np.uint32)
    for turn, u in itertools.product(range(turns), range(K5_UNROLL)):
        i0 = turn * K5_UNROLL * stride + u * stride
        for gtid in range(stride):
            i = i0 + gtid
            if i < chunks:
                first[gtid].append(i)
                partials[gtid // K5_THREADS] = max(partials[gtid // K5_THREADS],
                                                   bits[i * vec:(i + 1) * vec].max())
    for i in range(chunks * vec, n):
        blk = (i - chunks * vec) % stride // K5_THREADS
        partials[blk] = max(partials[blk], bits[i])
    barrier = barrier or GridBarrier()
    order = np.random.RandomState(n % 1000).permutation(grid)
    amax = np.array(barrier.run(partials, order), np.uint32).view(np.float32)
    scale = np.float32(amax * np.float32(1 / 127)) if amax > 0 else np.float32(1)
    q_storage = np.full(n, NOT_WRITTEN, np.int64)  # q in NHWC order

    def quantize(v):
        return k5_quantize(np.asarray(v, np.float32), scale)

    x_nhwc = xf.permute(0, 2, 3, 1).reshape(-1).numpy()
    if aligned and nhwc:
        for i in range(chunks * vec, n):
            q_storage[i] = quantize(x_nhwc[i])
        for turn in reversed(range(turns)):
            for u in reversed(range(K5_UNROLL)):
                i0 = turn * K5_UNROLL * stride + u * stride
                for gtid in range(stride):
                    i = i0 + gtid
                    if i < chunks:
                        second[gtid].append(i)
                        assert (q_storage[i * vec:(i + 1) * vec] == NOT_WRITTEN).all()
                        q_storage[i * vec:(i + 1) * vec] = quantize(x_nhwc[i * vec:(i + 1) * vec])
    else:
        for gtid in range(stride):
            for i in range(n - 1 - gtid, -1, -stride):
                assert q_storage[i] == NOT_WRITTEN
                q_storage[i] = quantize(x_nhwc[i])
    assert (q_storage != NOT_WRITTEN).all()
    q = torch.from_numpy(q_storage.astype(np.int8).reshape(b, h, w, c))
    return q, torch.tensor([scale]), grid, first, second


# K5's edges: NaN and inf, the zero tensor, offset views (the scalar walk),
# NCHW (the strided walk), several turns of a small resident grid
K5_CASES = ["nan-inf-f32-nchw", "inf-bf16-cl", "zero-bf16-cl", "zero-f32-nchw",
            "offset-view-bf16-cl", "offset-view-f32-cl", "head-n4-bf16-cl",
            "strided-odd-bf16-cl", "cin12-f32-cl", "n24-k144-bf16-cl"]


@pytest.mark.parametrize("resident", [1, 3, RESIDENT])
@pytest.mark.parametrize("name", K5_CASES)
def test_k5_model_equals_the_plain_version(name, resident):
    """The model's q and scale bit-equal to quantize_int8_plain, with one,
    three and the card's resident blocks; on an aligned channels-last x the
    second walk of each thread is its first reversed; the grid is as small
    as the work allows."""
    x, _, _ = chip_smoke.int8_edge_case(name)
    q, scale, grid, first, second = k5_model(x, resident)
    q_plain, s_plain = quant.quantize_int8_plain(x)
    assert torch.equal(q, q_plain)
    assert scale.numpy().view(np.uint32)[0] == s_plain.numpy().view(np.uint32)[0]
    assert grid <= resident
    # the 16-byte walk on an aligned channels-last x; else element by element
    vectorized = x.data_ptr() % 16 == 0 and quant.is_channels_last(x)
    assert bool(second) == vectorized
    for gtid, walk in first.items():
        assert second[gtid] == walk[::-1] or not vectorized


def test_k5_barrier_generations_across_calls():
    """Three calls through one state buffer: each releases its blocks only
    after the last arrives, leaves the count at 0 and the generation one
    further, with no memset between the calls."""
    barrier = GridBarrier()
    for call, name in enumerate(("nan-inf-f32-nchw", "zero-bf16-cl", "inf-bf16-cl")):
        x, _, _ = chip_smoke.int8_edge_case(name)
        q, scale, _, _, _ = k5_model(x, 3, barrier)
        assert barrier.arrived == 0 and barrier.generation == call + 1
        assert torch.equal(q, quant.quantize_int8_plain(x)[0])


def test_k5_grid_sizes():
    """The grid a call takes: enough blocks for a turn of 4 chunks a thread,
    at most the resident ones (a 52M-element flagship input walks 13 turns
    of the card's 264 blocks)."""
    for n, size, want in ((1, 2, 1), (8 * 2048 * 4, 2, 4), (8 * 2048 * 4 + 1, 2, 5),
                          (4 * 2048 * 4, 4, 4), (8 * 256 * 160 * 160, 2, RESIDENT)):
        assert k5_grid(n, size) == want
    chunks = 8 * 256 * 160 * 160 // 8
    assert math.ceil(chunks / (K5_UNROLL * RESIDENT * K5_THREADS)) == 13


@pytest.mark.parametrize("amax", [1.0, 3.7, 1e-3, 6.0e4, 3.0e38, 2.0e-36, 1.0e-40, np.inf])
def test_k5_quotient_shortcut_is_exact(amax):
    """K5's product-then-divide-near-a-boundary quotient equals the correctly
    rounded division's rint on random values up to the amax and on values a
    few ulps either side of every half-integer step (k + 0.5) * scale."""
    amax = np.float32(amax)
    scale = np.float32(amax * np.float32(1 / 127)) if amax > 0 else np.float32(1)
    rng = np.random.RandomState(sum(map(ord, repr(float(amax)))))
    v = [(rng.uniform(-1, 1, 200_000) * amax).astype(np.float32)]
    with np.errstate(all="ignore"):
        steps = ((np.arange(-128, 128) + np.float32(0.5)) * scale).astype(np.float32)
        for ulps in range(-3, 4):
            v.append(np.nextafter(steps, np.float32(np.inf) if ulps > 0 else np.float32(-np.inf))
                     if ulps else steps)
            for _ in range(abs(ulps) - 1):
                v[-1] = np.nextafter(v[-1], np.float32(np.inf) if ulps > 0 else np.float32(-np.inf))
        v = np.concatenate(v + [np.array([0, -0.0, np.inf, -np.inf, np.nan], np.float32)])
        want = np.rint(v / scale)
    want = np.where(np.isnan(want), 0, np.clip(want, -127, 127)).astype(np.int64)
    np.testing.assert_array_equal(k5_quantize(v, scale), want)


def _struct_fields(source: str, name: str) -> list[tuple[str, str]]:
    """(type, name) of each field of C struct `name` in
    fdt_torch/csrc/`source`, in order."""
    import re

    text = (REPO / "fdt_torch" / "csrc" / source).read_text()
    body = re.sub(r"//[^\n]*", "", re.search(r"struct %s \{(.*?)\};" % name, text, re.S).group(1))
    fields = []
    for decl in filter(str.strip, body.split(";")):
        ctype, names = re.match(r"\s*(uint64_t|long long)\s+(.*)", decl, re.S).groups()
        fields += [(ctype, n.strip()) for n in names.split(",")]
    return fields


@pytest.mark.parametrize("source, name, packer, pointers", [
    ("conv_int8.cu", "ConvArgs", quant._CONV_ARGS, 7),
    ("quantize_int8.cu", "QuantArgs", quant._QUANT_ARGS, 5)])
def test_packed_arguments_match_the_c_structs(source, name, packer, pointers):
    """The wrappers pack as many 64-bit fields as the C struct holds: the
    pointers and the stream unsigned (uint64_t) first, then the numbers
    (long long)."""
    fields = _struct_fields(source, name)
    assert [t for t, _ in fields] == ["uint64_t"] * pointers + ["long long"] * (len(fields) - pointers)
    assert fields[pointers - 1][1] == "stream" and fields[pointers][1] == "device"
    assert packer.format == f"<{pointers}Q{len(fields) - pointers}q"
    assert packer.size == 8 * len(fields)
