"""fdt_torch's K2 wrapper (nms_keep_greedy) and nms_padded(impl=) against
fdt: the per-box Pallas kernel pallas_nms_keep in interpret mode, and
fdt.geometry.nms_padded with each of its four impl values (the Pallas ones
in interpret mode), on the cases of tests/test_pallas_nms.py.

On the CPU the kernel wrappers compute the plain version; keep masks,
keep_idx[:count] and count must be bit-equal all the same.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fdt.geometry import nms as jax_nms
from fdt.ops.pallas_nms import pallas_nms_keep
from fdt_torch.geometry import nms
from fdt_torch.ops import nms as nms_op

torch.set_num_threads(1)

IMPLS = ["xla", "pallas", "pallas_tiled", "auto"]


def make_boxes(rng, n, spread=4.0, size=2.0):
    centers = rng.rand(n, 2) * spread
    wh = rng.rand(n, 2) * size + 0.5
    return np.concatenate([centers - wh / 2, centers + wh / 2], 1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _sorted_case(seed, n, degenerate=False):
    """Score-sorted boxes as in tests/test_pallas_nms.py; with `degenerate`,
    a few zero-area boxes (x2 = x1, y2 = y1), whose 0/0 overlaps are NaN."""
    rng = np.random.RandomState(seed)
    boxes = make_boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    if degenerate:
        boxes[::17, 2:] = boxes[::17, :2]
    return boxes[np.argsort(-scores, kind="stable")], scores


@pytest.mark.parametrize("mode", ["union", "minimum"])
@pytest.mark.parametrize("seed,n,degenerate", [(0, 200, False), (1, 200, False),
                                               (0, 300, False), (1, 300, False),
                                               (2, 300, True)],
                         ids=["n200-s0", "n200-s1", "n300-s0", "n300-s1", "degenerate"])
def test_keep_greedy_matches_pallas_kernel(mode, seed, n, degenerate):
    boxes, _ = _sorted_case(seed, n, degenerate)
    valid = np.ones(n, bool)
    want = np.asarray(pallas_nms_keep(jnp.asarray(boxes), jnp.asarray(valid), 0.5,
                                      mode=mode, interpret=True))
    before = nms_op.greedy_launches.count
    got = nms_op.nms_keep_greedy(_t(boxes)[None], _t(valid)[None], 0.5, mode=mode)
    assert nms_op.greedy_launches.count == before  # the plain version: no launch
    assert got.shape == (1, n) and got.dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), nms_op.nms_keep_tiled(_t(boxes)[None], _t(valid)[None], 0.5,
                                           mode=mode).numpy())


def test_keep_greedy_respects_valid():
    boxes = np.array([[0, 0, 1, 1], [0, 0, 1, 1]], np.float32)
    valid = np.array([False, True])
    want = np.asarray(pallas_nms_keep(jnp.asarray(boxes), jnp.asarray(valid), 0.5,
                                      interpret=True))
    got = nms_op.nms_keep_greedy(_t(boxes), _t(valid), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [False, True])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", [
    # seed, n, mode, thresh, budget, out_k, spread, with_valid, degenerate
    (0, 300, "union", 0.5, 300, 100, 4.0, False, False),
    (1, 300, "minimum", 0.5, 300, 100, 4.0, True, False),
    (2, 300, "union", 0.45, 250, 400, 6.0, True, True),    # out_k > budget: padded
    (4, 1000, "minimum", 0.4, 1000, 750, 30.0, True, True),
], ids=["union", "minimum-valid", "degenerate-padded", "n1000-degenerate"])
def test_nms_padded_impl_matches_fdt(impl, case):
    seed, n, mode, thresh, budget, out_k, spread, with_valid, degenerate = case
    rng = np.random.RandomState(seed)
    boxes = make_boxes(rng, n, spread=spread, size=3.0)
    if degenerate:
        boxes[::13, 2:] = boxes[::13, :2]
    scores = rng.rand(n).astype(np.float32)
    valid = (scores > 0.3) if with_valid else None
    kw = dict(budget=budget, out_k=out_k, mode=mode)
    idx, count = nms.nms_padded(_t(boxes), _t(scores), thresh,
                                valid=None if valid is None else _t(valid), impl=impl, **kw)
    with pltpu.force_tpu_interpret_mode():
        jidx, jcount = jax_nms.nms_padded(
            jnp.asarray(boxes), jnp.asarray(scores), thresh,
            valid=None if valid is None else jnp.asarray(valid), impl=impl, **kw)
    c = int(jcount)
    assert idx.dtype == torch.int32 and idx.shape == (out_k,) and c > 0
    assert int(count) == c
    np.testing.assert_array_equal(idx.numpy()[:c], np.asarray(jidx)[:c])


def test_nms_padded_impls_agree_on_batched_problems():
    """Leading dimensions are problems: every impl gives the same indices."""
    rng = np.random.RandomState(8)
    boxes = make_boxes(rng, 2 * 3 * 500, spread=25.0, size=3.0).reshape(2, 3, 500, 4)
    scores = rng.rand(2, 3, 500).astype(np.float32)
    valid = _t(scores > 0.25)
    out = [nms.nms_padded(_t(boxes), _t(scores), 0.4, budget=400, out_k=200,
                          valid=valid, impl=impl) for impl in IMPLS]
    for idx, count in out[1:]:
        assert torch.equal(count, out[0][1])
        for i, c in np.ndenumerate(count.numpy()):
            assert torch.equal(idx[i][:c], out[0][0][i][:c])


def test_nms_padded_rejects_unknown_impl():
    boxes, scores = torch.zeros(5, 4), torch.zeros(5)
    with pytest.raises(ValueError, match="impl"):
        nms.nms_padded(boxes, scores, 0.5, budget=5, out_k=3, impl="triton")


def test_keep_greedy_rejects_bad_arguments():
    boxes = torch.zeros(2, 10, 4)
    valid = torch.ones(2, 10, dtype=torch.bool)
    with pytest.raises(ValueError, match="mode"):
        nms_op.nms_keep_greedy(boxes, valid, 0.5, mode="iou")
    with pytest.raises(ValueError, match="valid"):
        nms_op.nms_keep_greedy(boxes, valid.float(), 0.5)
    with pytest.raises(ValueError, match="boxes"):
        nms_op.nms_keep_greedy(boxes[..., :3], valid, 0.5)
