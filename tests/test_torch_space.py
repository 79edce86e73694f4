"""The band geometry and the halo exchanges of fdt_torch.dist.space, in one
process: the S bands of a map are S threads, each with a loopback comm
whose all_gather meets the others' at a barrier, so the exchange's
autograd.Function runs as it does across processes, backward included.

Over H from 1 to 40 rows and S from 1 to 4 bands (empty bands included),
with the kernels, strides, dilations and paddings the models use, the
bands' outputs and input gradients, concatenated, equal the unsharded op:
the outputs of max-pool and of ContextTexture's upsample-and-crop exactly,
the convolutions' within 1e-6 of the map's largest value (their sums run
in another order), and every input gradient within 1e-6 of its largest
value (a row read by two bands sums its gradient's terms in another
grouping).
"""
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import HealthCheck, assume, given, settings, strategies as st

from fdt_torch.dist import space

torch.set_num_threads(1)

TOL = 1e-6
SETTINGS = settings(max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])

# (kernel, stride, dilation, padding, depthwise) of the models' convolutions
CONVS = [
    (1, 1, 1, 0, False),  # 1×1 laterals, bottleneck convs
    (1, 1, 1, 1, False),  # try4/try5's 1×1 smooths with padding 1: grow by 2
    (1, 2, 1, 0, False),  # ResNet's strided downsample
    (3, 1, 1, 1, False),  # heads, smooths, SSH
    (3, 2, 1, 1, False),  # strided 3×3, extra layers
    (3, 1, 2, 2, False),  # SSH's dilation-2 convs
    (3, 1, 1, 1, True),   # depthwise
    (3, 2, 1, 1, True),   # strided depthwise
    (5, 2, 1, 2, True),   # try1's 5×5 depthwise
    (7, 2, 1, 3, False),  # the flagship's stem
    (7, 2, 1, 1, False),  # try4's 7×7/pad-1 stem
]


class Loopback:
    """S ranks of one process: each thread's comm all_gathers through a
    shared slot list and a barrier (broken, so that no thread hangs, when
    one fails)."""

    def __init__(self, n: int):
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=60)

    def comm(self, rank: int):
        loop = self

        class Comm:
            size = loop.n

            def all_gather(self, x):
                loop.slots[self.rank] = x.detach().clone()
                loop.barrier.wait()
                out = [s.clone() for s in loop.slots]
                loop.barrier.wait()
                return out

        c = Comm()
        c.rank = rank
        return c

    def run(self, fn) -> list:
        """fn(rank, comm) on n threads; their results by rank."""
        results, errors = [None] * self.n, []

        def main(r):
            try:
                results[r] = fn(r, self.comm(r))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=main, args=(r,)) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results


def banded(x: torch.Tensor, n: int, op, grad_out: torch.Tensor, h_out: int):
    """op(band, comm) on each of n bands of x (global height x.shape[2]),
    backward with each rank's band of grad_out: (the output bands and the
    input gradient bands, each concatenated along H)."""

    def rank(r, comm):
        lo, hi = space.band(x.shape[2], n, r)
        xr = x[:, :, lo:hi].detach().clone().requires_grad_(True)
        y = op(xr, comm)
        a, b = space.band(h_out, n, r)
        assert y.shape[2] == b - a
        y.backward(grad_out[:, :, a:b])
        return y.detach(), xr.grad

    outs = Loopback(n).run(rank)
    return torch.cat([o[0] for o in outs], 2), torch.cat([o[1] for o in outs], 2)


def whole(x: torch.Tensor, op, seed: int):
    """(op(x), a seeded output gradient, x's gradient)."""
    x = x.detach().clone().requires_grad_(True)
    y = op(x)
    g = torch.from_numpy(np.random.RandomState(seed).randn(*y.shape).astype(np.float32))
    y.backward(g)
    return y.detach(), g, x.grad


def close(got: torch.Tensor, want: torch.Tensor) -> None:
    """Within TOL of the map's largest value (a sum's rounding scales with it)."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= TOL * max(1.0, float(want.abs().max())), err


def _input(h: int, w: int, c: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).randn(2, c, h, w).astype(np.float32))


def test_band_rule():
    assert [space.band(5, 4, r) for r in range(4)] == [(0, 1), (1, 2), (2, 3), (3, 5)]
    assert [space.band(1, 2, r) for r in range(2)] == [(0, 0), (0, 1)]  # an empty band
    for h in range(0, 41):
        for n in range(1, 5):
            bands = [space.band(h, n, r) for r in range(n)]
            assert bands[0][0] == 0 and bands[-1][1] == h
            assert all(bands[r][1] == bands[r + 1][0] for r in range(n - 1))


def test_a_halo_spans_ranks_when_bands_are_thinner_than_it():
    """The flagship's 5-row map over 4 ranks under SSH's dilation-2 conv:
    rank 1 (row 1) reads rows -1..3, from ranks 0, 2 and 3 and the fill."""
    windows = space.conv_windows(5, 4, 3, 1, 2, 2)
    assert windows[1] == (-1, 4, True)
    plan = space.halo_plan(5, 4, windows)
    assert plan.pieces[1] == ((-1, -1, 0), (0, 0, 1), (1, 1, 2), (2, 2, 3), (3, 3, 4))
    assert [p[0] for p in plan.receives(1)] == [0, 2, 3]
    assert plan.width == max(sum(v - u for (_, _, u, v) in plan.sends(r)) for r in range(4))


def test_conv_rows_and_heights():
    assert space.conv_out_height(640, 7, 2, 1, (3, 3)) == 320
    assert space.conv_out_height(64, 7, 2, 1, (1, 1)) == 30   # try4's stem
    assert space.conv_out_height(15, 1, 1, 1, (1, 1)) == 17   # grown by 2
    assert space.conv_rows(0, 1, 1, 1, 1, 1) == (-1, 0)      # a grown map's edge row: fill
    assert space.upsample_rows(0, 4, 2) == (0, 2)
    assert space.upsample_rows(5, 7, 10) == (2, 4)


@SETTINGS
@given(h=st.integers(1, 40), n=st.integers(1, 4), spec=st.sampled_from(CONVS),
       w=st.integers(1, 6), seed=st.integers(0, 2 ** 16))
def test_conv_bands_equal_the_whole_conv(h, n, spec, w, seed):
    k, s, d, p, depthwise = spec
    h_out = space.conv_out_height(h, k, s, d, (p, p))
    assume(h_out >= 1 and (w + 2 * p - d * (k - 1) - 1) // s + 1 >= 1)
    c = 3
    cout, groups = (c, c) if depthwise else (4, 1)
    rng = np.random.RandomState(seed + 1)
    # weights of unit gain (fan-in scaled, as the models' init), so every map is O(1)
    weight = torch.from_numpy((rng.randn(cout, c // groups, k, k)
                               / np.sqrt(k * k * c // groups)).astype(np.float32))
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32))
    x = _input(h, w, c, seed)
    want, g, gx = whole(x, lambda t: F.conv2d(t, weight, bias, s, p, d, groups), seed + 2)
    got, got_gx = banded(x, n, lambda t, comm: space.conv2d(
        t, weight, bias, h, s, p, d, groups, comm=comm), g, h_out)
    close(got, want)
    close(got_gx, gx)


@SETTINGS
@given(h=st.integers(1, 40), n=st.integers(1, 4), w=st.integers(1, 6),
       seed=st.integers(0, 2 ** 16))
def test_conv_weight_gradient_is_the_sum_of_the_bands(h, n, w, seed):
    """The parameters' gradient summed over the bands (the all-reduce of the
    step) is the whole conv's, the 3×3/2 case."""
    rng = np.random.RandomState(seed)
    w0 = torch.from_numpy((rng.randn(4, 3, 3, 3) / np.sqrt(27)).astype(np.float32))
    x = _input(h, w, 3, seed + 1)
    h_out = space.conv_out_height(h, 3, 2, 1, (1, 1))
    wf = w0.clone().requires_grad_(True)
    y = F.conv2d(x, wf, None, 2, 1)
    g = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
    y.backward(g)

    def rank(r, comm):
        lo, hi = space.band(h, n, r)
        wr = w0.clone().requires_grad_(True)
        yr = space.conv2d(x[:, :, lo:hi], wr, None, h, 2, 1, comm=comm)
        a, b = space.band(h_out, n, r)
        yr.backward(g[:, :, a:b])
        return wr.grad

    close(sum(Loopback(n).run(rank)), wf.grad)


@SETTINGS
@given(h=st.integers(1, 40), n=st.integers(1, 4), w=st.integers(1, 6),
       seed=st.integers(0, 2 ** 16))
def test_max_pool_bands_equal_the_whole_pool_exactly(h, n, w, seed):
    x = _input(h, w, 3, seed)
    h_out = space.conv_out_height(h, 3, 2, 1, (1, 1))
    want, g, gx = whole(x, lambda t: F.max_pool2d(t, 3, 2, 1), seed + 1)
    got, got_gx = banded(x, n, lambda t, comm: space.max_pool2d(t, h, 3, 2, 1, comm=comm),
                         g, h_out)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # an input row under up to two windows of each band: its gradient sums
    # the same terms in another grouping
    close(got_gx, gx)


@SETTINGS
@given(h=st.integers(1, 20), n=st.integers(1, 4), w=st.integers(1, 5),
       crop=st.integers(0, 3), crop_w=st.integers(0, 1), seed=st.integers(0, 2 ** 16))
def test_upsample_and_crop_bands_equal_the_whole_map_exactly(h, n, w, crop, crop_w, seed):
    """ContextTexture's ×2 bilinear upsample (half-pixel centres) and its crop
    to main's height: 2h − crop rows (an odd main when crop is odd)."""
    h_main, w_main = max(1, 2 * h - crop), max(1, 2 * w - crop_w)
    x = _input(h, w, 3, seed)

    def up_crop(t):
        res = F.interpolate(t, size=(2 * h, 2 * w), mode="bilinear", align_corners=False)
        return res[:, :, :h_main, :w_main]

    want, g, gx = whole(x, up_crop, seed + 1)
    got, got_gx = banded(x, n, lambda t, comm: space.upsample_crop(
        t, h, h_main, w_main, comm=comm), g, h_main)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    close(got_gx, gx)


@pytest.mark.parametrize("h,n", [(1, 2), (5, 4), (7, 3), (16, 4)])
def test_gather_rows_is_the_whole_map_and_keeps_the_own_band_s_gradient(h, n):
    x = _input(h, 4, 3, h * n)
    g = _input(h, 4, 3, h * n + 1)

    def rank(r, comm):
        lo, hi = space.band(h, n, r)
        xr = x[:, :, lo:hi].clone().requires_grad_(True)
        full = space.gather_rows(xr, h, comm=comm)
        (full * g).sum().backward()
        return full.detach(), xr.grad

    outs = Loopback(n).run(rank)
    for full, _ in outs:
        np.testing.assert_array_equal(full.numpy(), x.numpy())
    np.testing.assert_array_equal(torch.cat([o[1] for o in outs], 2).numpy(), g.numpy())


def test_an_empty_band_still_takes_part_in_every_exchange():
    """A 3-row map over 4 ranks: rank 0's band is empty (as try3's 1-row map
    over 2 ranks), yet it runs the exchange forward and backward, which the
    other ranks need (a rank that skipped it would leave them waiting)."""
    calls = []
    x = _input(3, 2, 3, 0)
    weight = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 3, 3).astype(np.float32))

    def rank(r, comm):
        gather = comm.all_gather

        def counted(t):
            calls.append(r)
            return gather(t)

        comm.all_gather = counted
        lo, hi = space.band(3, 4, r)
        xr = x[:, :, lo:hi].clone().requires_grad_(True)
        y = space.conv2d(xr, weight, None, 3, 1, 1, comm=comm)
        y.sum().backward()
        return y.shape[2], xr.grad.shape[2]

    assert Loopback(4).run(rank) == [(0, 0), (1, 1), (1, 1), (1, 1)]
    assert sorted(calls) == [0, 0, 1, 1, 2, 2, 3, 3]  # forward and backward, every rank


def test_band_convs_keeps_the_module_and_its_state():
    from fdt_torch.models import build_pyramidbox
    model = build_pyramidbox("try3")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params = [id(p) for p in model.parameters()]
    space.band_convs(model)
    assert all(type(m) is not torch.nn.Conv2d for m in model.modules())
    assert [id(p) for p in model.parameters()] == params
    after = model.state_dict()
    assert after.keys() == before.keys()
    assert all(torch.equal(after[k], before[k]) for k in before)
    # no space group: the banded convs are the plain ones
    x = torch.randn(1, 3, 64, 64)
    with torch.no_grad():
        out = model.eval()(x)
    fresh = build_pyramidbox("try3").eval()
    fresh.load_state_dict(before)
    with torch.no_grad():
        want = fresh(x)
    assert torch.equal(out["face_conf"], want["face_conf"])
