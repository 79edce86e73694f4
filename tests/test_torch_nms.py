"""fdt_torch greedy NMS against fdt's: the fixpoint, the Pallas tiled kernel
(interpret mode) and nms_padded, on the cases of tests/test_pallas_nms.py.

Keep masks, keep_idx[:count] and count must be bit-equal: the overlap test
repeats fdt's float32 operations in the same order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdt.geometry import nms as jax_nms
from fdt.ops.pallas_nms import pallas_nms_keep_tiled
from fdt_torch.geometry import nms
from fdt_torch.ops import nms as nms_op

torch.set_num_threads(1)


def make_boxes(rng, n, spread=4.0, size=2.0):
    centers = rng.rand(n, 2) * spread
    wh = rng.rand(n, 2) * size + 0.5
    return np.concatenate([centers - wh / 2, centers + wh / 2], 1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("mode", ["union", "minimum"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keep_mask_matches_fdt(mode, seed):
    rng = np.random.RandomState(seed)
    n = 300  # > 2 tiles of 128 and of 64, not a multiple of either
    boxes = make_boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    sorted_boxes = boxes[np.argsort(-scores, kind="stable")]
    valid = rng.rand(n) > 0.1
    ours = nms.nms_keep_mask(_t(sorted_boxes), _t(valid), 0.5, mode=mode).numpy()
    fixpoint = np.asarray(jax_nms.nms_keep_mask(jnp.asarray(sorted_boxes),
                                                jnp.asarray(valid), 0.5, mode=mode))
    tiled = np.asarray(pallas_nms_keep_tiled(jnp.asarray(sorted_boxes),
                                             jnp.asarray(valid), 0.5, mode=mode,
                                             interpret=True))
    np.testing.assert_array_equal(ours, fixpoint)
    np.testing.assert_array_equal(ours, tiled)
    # the kernel wrapper takes the plain version for a CPU tensor
    wrapped = nms_op.nms_keep_tiled(_t(sorted_boxes), _t(valid), 0.5, mode=mode)
    np.testing.assert_array_equal(wrapped.numpy(), ours)


@pytest.mark.parametrize("mode", ["union", "minimum"])
@pytest.mark.parametrize("n", [300, 4500])
def test_keep_mask_segmented_matches_fdt(mode, n):
    rng = np.random.RandomState(3)
    boxes = make_boxes(rng, n, spread=6.0)
    valid = rng.rand(n) > 0.1
    seg = (rng.rand(n) * 7).astype(np.int32)
    ours = nms_op.nms_keep_tiled(_t(boxes), _t(valid), 0.4, mode=mode,
                                 seg_id=_t(seg)).numpy()
    fixpoint = np.asarray(jax_nms.nms_keep_mask(
        jnp.asarray(boxes), jnp.asarray(valid), 0.4, mode=mode, seg_id=jnp.asarray(seg)))
    tiled = np.asarray(pallas_nms_keep_tiled(
        jnp.asarray(boxes), jnp.asarray(valid), 0.4, mode=mode,
        seg_id=jnp.asarray(seg), interpret=True))
    np.testing.assert_array_equal(ours, fixpoint)
    np.testing.assert_array_equal(ours, tiled)


@pytest.mark.parametrize("out_k", [16, 100, 750])
def test_out_k_prefix_matches_fdt(out_k):
    """A dense scene (most boxes kept): the first out_k keeps of the port
    equal those of the capped Pallas kernel, and nothing is kept that the
    uncapped kernel would not keep."""
    rng = np.random.RandomState(7)
    n = 1500
    boxes = make_boxes(rng, n, spread=100.0)
    valid = np.ones(n, bool)
    ours = nms_op.nms_keep_tiled(_t(boxes), _t(valid), 0.5, out_k=out_k).numpy()
    capped = np.asarray(pallas_nms_keep_tiled(jnp.asarray(boxes), jnp.asarray(valid),
                                              0.5, interpret=True, out_k=out_k))
    full = np.asarray(jax_nms.nms_keep_mask(jnp.asarray(boxes), jnp.asarray(valid), 0.5))
    m = min(out_k, int(full.sum()))
    np.testing.assert_array_equal(np.flatnonzero(ours)[:m], np.flatnonzero(capped)[:m])
    np.testing.assert_array_equal(ours, full)
    assert not np.any(capped & ~ours)


def _padded_case(seed, n, mode, thresh, budget, out_k, spread, with_valid):
    rng = np.random.RandomState(seed)
    boxes = make_boxes(rng, n, spread=spread, size=3.0)
    scores = rng.rand(n).astype(np.float32)
    valid = (scores > 0.3) if with_valid else None
    return boxes, scores, valid, dict(budget=budget, out_k=out_k, mode=mode)


@pytest.mark.parametrize("case", [
    # seed, n, mode, thresh, budget, out_k, spread, with_valid
    (3, 2048, "union", 0.45, 2048, 128, 50.0, False),     # dense, out_k exit
    (4, 2048, "minimum", 0.45, 2048, 750, 50.0, True),
    (5, 4500, "union", 0.35, 4000, 750, 200.0, True),    # budget < n
    (6, 300, "union", 0.5, 5000, 750, 4.0, True),        # out_k > budget: padded
], ids=["dense-out128", "minimum-valid", "budget-cut", "out_k-padded"])
def test_nms_padded_matches_fdt(case):
    seed, n, mode, thresh, budget, out_k, spread, with_valid = case
    boxes, scores, valid, kw = _padded_case(seed, n, mode, thresh, budget, out_k,
                                            spread, with_valid)
    idx, count = nms.nms_padded(_t(boxes), _t(scores), thresh,
                                valid=None if valid is None else _t(valid), **kw)
    jidx, jcount = jax_nms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores), thresh,
                                      valid=None if valid is None else jnp.asarray(valid),
                                      impl="xla", **kw)
    c = int(jcount)
    assert idx.dtype == torch.int32 and idx.shape == (out_k,)
    assert int(count) == c
    np.testing.assert_array_equal(idx.numpy()[:c], np.asarray(jidx)[:c])


def test_nms_padded_tied_scores_break_toward_lower_index():
    """Scores on a coarse grid tie often; the stable sort must order ties by
    index as lax.top_k does, so the kept indices are bit-equal."""
    rng = np.random.RandomState(11)
    n = 1000
    boxes = make_boxes(rng, n, spread=30.0, size=3.0)
    scores = (rng.randint(0, 6, n) / 5).astype(np.float32)
    valid = scores > 0.1
    idx, count = nms.nms_padded(_t(boxes), _t(scores), 0.4, budget=700, out_k=300,
                                valid=_t(valid))
    jidx, jcount = jax_nms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores), 0.4,
                                      budget=700, out_k=300, valid=jnp.asarray(valid),
                                      impl="xla")
    c = int(jcount)
    assert int(count) == c > 0
    np.testing.assert_array_equal(idx.numpy()[:c], np.asarray(jidx)[:c])


def test_nms_padded_batched_equals_per_problem():
    """Leading dimensions are independent problems (fdt vmaps instead)."""
    rng = np.random.RandomState(12)
    b, c, n = 2, 3, 400
    boxes = np.stack([make_boxes(rng, n, spread=20.0) for _ in range(b * c)]).reshape(b, c, n, 4)
    scores = rng.rand(b, c, n).astype(np.float32)
    valid = scores > 0.2
    idx, count = nms.nms_padded(_t(boxes), _t(scores), 0.4, budget=350, out_k=120,
                                valid=_t(valid))
    assert idx.shape == (b, c, 120) and count.shape == (b, c)
    for i in range(b):
        for j in range(c):
            jidx, jcount = jax_nms.nms_padded(
                jnp.asarray(boxes[i, j]), jnp.asarray(scores[i, j]), 0.4, budget=350,
                out_k=120, valid=jnp.asarray(valid[i, j]), impl="xla")
            k = int(jcount)
            assert int(count[i, j]) == k
            np.testing.assert_array_equal(idx[i, j].numpy()[:k], np.asarray(jidx)[:k])


@pytest.mark.parametrize("mode", ["union", "minimum"])
def test_nms_numpy_oracle_matches_fdt(mode):
    rng = np.random.RandomState(5)
    boxes = make_boxes(rng, 200)
    scores = rng.rand(200).astype(np.float32)
    assert nms.nms_numpy(boxes, scores, 0.5, mode) == jax_nms.nms_numpy(boxes, scores, 0.5, mode)
    order = np.argsort(-scores, kind="stable")
    keep = nms.nms_keep_mask(_t(boxes[order]), torch.ones(200, dtype=torch.bool), 0.5,
                             mode=mode).numpy()
    assert sorted(order[keep].tolist()) == sorted(nms.nms_numpy(boxes, scores, 0.5, mode))


def test_degenerate_boxes_suppress_nothing():
    """0/0 overlaps are NaN and compare False, in the plain version as in fdt."""
    boxes = np.array([[0, 0, 0, 0], [0, 0, 0, 0], [1, 1, 2, 2]], np.float32)
    valid = np.ones(3, bool)
    ours = nms.nms_keep_mask(_t(boxes), _t(valid), 0.3).numpy()
    theirs = np.asarray(jax_nms.nms_keep_mask(jnp.asarray(boxes), jnp.asarray(valid), 0.3))
    np.testing.assert_array_equal(ours, theirs)
    assert ours.all()


def test_wrapper_rejects_bad_arguments():
    boxes = torch.zeros(2, 10, 4)
    valid = torch.ones(2, 10, dtype=torch.bool)
    with pytest.raises(ValueError, match="seg_id"):
        nms_op.nms_keep_tiled(boxes, valid, 0.5, seg_id=torch.zeros(2, 10, dtype=torch.int32),
                              out_k=3)
    with pytest.raises(ValueError, match="mode"):
        nms_op.nms_keep_tiled(boxes, valid, 0.5, mode="iou")
    with pytest.raises(ValueError, match="valid"):
        nms_op.nms_keep_tiled(boxes, valid.float(), 0.5)
    with pytest.raises(ValueError, match="boxes"):
        nms_op.nms_keep_tiled(boxes[..., :3], valid, 0.5)


def test_cpu_path_does_not_count_launches():
    before = nms_op.launches.count
    nms_op.nms_keep_tiled(torch.zeros(1, 5, 4), torch.ones(1, 5, dtype=torch.bool), 0.5)
    assert nms_op.launches.count == before
