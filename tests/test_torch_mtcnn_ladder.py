"""fdt_torch's MTCNN budget ladder and NMS calls on the CPU: escalation on
both polarities and its stickiness, as tests/test_mtcnn_device.py:120-193
pins them for fdt and against fdt's own ladder; the LRU bound of the sticky
starts; the four K1 calls a tier run makes; and K1's segmented path on the
cascade's own per-level candidates against fdt's Pallas kernel in interpret
mode."""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import fdt.infer.mtcnn_device as jmd  # noqa: E402
from fdt.ops.pallas_nms import pallas_nms_keep_tiled  # noqa: E402
from fdt_torch.infer import mtcnn_device as md  # noqa: E402
from fdt_torch.ops import nms as nms_op  # noqa: E402
from tests.test_torch_mtcnn import (assert_rows_match, fdt_cascade, frame,  # noqa: E402
                                    port_cascade)

torch.set_num_threads(1)

TINY = dict(pnet_cand_k=64, merge_k=16, rnet_k=16, onet_k=8, out_k=4)  # saturates


def _tiers_run(cascade) -> list:
    """Record the tier of every run of `cascade` into the returned list."""
    calls = []
    run = cascade._run
    cascade._run = lambda x, tier="full", **kw: calls.append(tier) or run(x, tier, **kw)
    return calls


def test_ladder_escalates_past_saturated_tiers_and_sticks():
    """Two saturating tiers: the answer is the full budgets' (as fdt's
    ladder's), the flag the full tier's, and the shape then starts at full."""
    im = frame(5, 120, 160)
    full = port_cascade("sparse")
    want_b, want_lm = full.detect_face(im)
    ladder = port_cascade("sparse", fast_budgets=(md.DeviceBudgets(**TINY),
                                                  md.DeviceBudgets(**TINY)))
    assert ladder.tier_names == ("fast", "fast1")
    calls = _tiers_run(ladder)
    boxes, lm = ladder.detect_face(im)
    assert calls == ["fast", "fast1", "full"] and ladder.last_tier == "full"
    assert ladder.last_saturated is full.last_saturated is False and len(want_b) > 0
    np.testing.assert_array_equal(boxes, want_b)
    np.testing.assert_array_equal(lm, want_lm)
    assert ladder._start_tier[(120, 160)] == 2
    calls.clear()
    boxes2, _ = ladder.detect_face(im)
    assert calls == ["full"]  # sticky: straight to the full budgets
    np.testing.assert_array_equal(boxes2, want_b)

    fdt = fdt_cascade("sparse", fast_budgets=(jmd.DeviceBudgets(**TINY),
                                              jmd.DeviceBudgets(**TINY)))
    fdt_b, fdt_lm = fdt.detect_face(im)
    assert fdt._start_tier[(120, 160)] == 2 and fdt.last_saturated is False
    assert_rows_match(boxes, lm, fdt_b, fdt_lm)


def test_ladder_answers_from_an_unsaturated_tier():
    """An unsaturated cheap tier answers, equal to the full budgets'."""
    im = frame(5, 120, 160)
    ladder = port_cascade("sparse", budgets=md.DeviceBudgets(), fast_budgets=md.FAST_BUDGETS)
    calls = _tiers_run(ladder)
    boxes, lm = ladder.detect_face(im)
    assert calls == ["fast"] and ladder.last_tier == "fast" and not ladder.last_saturated
    assert (120, 160) not in ladder._start_tier
    full_b, full_lm = port_cascade("sparse", budgets=md.DeviceBudgets()).detect_face(im)
    assert len(full_b) > 0
    np.testing.assert_array_equal(boxes, full_b)
    np.testing.assert_array_equal(lm, full_lm)
    fdt_b, fdt_lm = fdt_cascade("sparse", budgets=jmd.DeviceBudgets(),
                                fast_budgets=jmd.FAST_BUDGETS).detect_face(im)
    assert_rows_match(boxes, lm, fdt_b, fdt_lm)


def test_one_saturated_image_sends_the_whole_batch_on():
    """A batch of a busy frame, which saturates the cheap tier, and a black
    one, which does not: both are answered by the next tier; the black
    frame's answer is the one its cheap tier gives alone, and fdt's batch
    ladder gives the same."""
    images = np.stack([frame(7, 120, 160), np.zeros((120, 160, 3), np.uint8)])
    tiny = md.DeviceBudgets(**TINY)
    assert port_cascade("sparse", budgets=tiny).detect_batch(images)[3].tolist() == [True, False]
    ladder = port_cascade("sparse", fast_budgets=tiny)
    calls = _tiers_run(ladder)
    boxes, lm, counts, sat = ladder.detect_batch(images)
    assert calls == ["fast", "full"] and ladder.last_tier == "full"
    assert ladder._start_tier[("batch", 2, 120, 160)] == 1
    full = port_cascade("sparse").detect_batch(images)
    for got, want in zip((boxes, lm, counts, sat), full):
        np.testing.assert_array_equal(got, want)
    alone = port_cascade("sparse", budgets=tiny).detect_batch(images[1:])
    assert int(alone[2][0]) == int(counts[1])
    np.testing.assert_array_equal(alone[0][0, :counts[1]], boxes[1, :counts[1]])
    fdt = fdt_cascade("sparse", fast_budgets=jmd.DeviceBudgets(**TINY)).detect_batch(images)
    np.testing.assert_array_equal(counts, fdt[2])
    np.testing.assert_array_equal(sat, fdt[3])
    for i, c in enumerate(counts):
        assert_rows_match(boxes[i, :c], lm[i, :c], fdt[0][i, :c], fdt[1][i, :c])


def test_sticky_starts_are_lru_bounded():
    ladder = port_cascade("saturated", fast_budgets=md.DeviceBudgets(**TINY))
    ladder._start_tier_max = 2
    for h in (40, 44, 48):
        ladder.detect_face(frame(h, h, 64))
    assert list(ladder._start_tier) == [(44, 64), (48, 64)]


def test_each_tier_run_makes_four_k1_calls(monkeypatch):
    """Every NMS of a tier run goes through K1's wrapper: the per-level NMS
    with seg_id over pnet_cand_k boxes, the three others by nms_padded's
    "auto" with out_k; no plain fixpoint is called directly."""
    seen = []

    def spy(boxes, valid, thresh, mode="union", seg_id=None, out_k=None):
        seen.append((boxes.shape[-2], mode, seg_id is not None, out_k))
        return keep_tiled(boxes, valid, thresh, mode=mode, seg_id=seg_id, out_k=out_k)

    def plain(*args, **kwargs):
        raise AssertionError("the plain fixpoint was called directly")

    keep_tiled = nms_op.nms_keep_tiled
    monkeypatch.setattr(nms_op, "nms_keep_tiled", spy)
    monkeypatch.setattr(md, "nms_keep_tiled", spy)
    monkeypatch.setattr("fdt_torch.geometry.nms.nms_keep_mask", plain)
    tiny = md.DeviceBudgets(**TINY)
    ladder = port_cascade("saturated", fast_budgets=tiny)
    ladder.detect_batch(np.stack([frame(8, 96, 128)] * 2))
    assert ladder.last_tier == "full"
    b = md.FAST_BUDGETS
    assert seen == [(64, "minimum", True, None), (16, "union", False, 16),
                    (16, "union", False, 8), (8, "minimum", False, 4),
                    (b.pnet_cand_k, "minimum", True, None), (b.merge_k, "union", False, b.merge_k),
                    (b.rnet_k, "union", False, b.onet_k), (b.onet_k, "minimum", False, b.out_k)]


@pytest.mark.parametrize("setting,h,w", [("saturated", 120, 160), ("sparse", 120, 160),
                                         ("saturated", 96, 128)])
def test_k1_segmented_path_on_cascade_candidates_matches_fdt_pallas(setting, h, w):
    """K1's plain version, which the card holds K1 to bit for bit, against
    fdt's tiled Pallas kernel in interpret mode, segmented by pyramid level
    ('minimum' 0.4), on the cascade's own per-level candidates (N = 2048)."""
    cascade = port_cascade(setting)
    boxes, valid, seg = cascade.pnet_candidates(np.stack([frame(9, h, w), frame(10, h, w)]),
                                                tier="full")
    assert boxes.shape[-2] == md.FAST_BUDGETS.pnet_cand_k and seg.dtype == torch.int32
    ours = nms_op.nms_keep_tiled(boxes, valid, 0.4, mode="minimum", seg_id=seg)
    assert int(valid.sum()) > 50 and int(seg[valid].unique().numel()) > 1
    for p in range(len(boxes)):
        want = pallas_nms_keep_tiled(jnp.asarray(boxes[p].numpy()),
                                     jnp.asarray(valid[p].numpy()), 0.4, mode="minimum",
                                     seg_id=jnp.asarray(seg[p].numpy()), interpret=True)
        np.testing.assert_array_equal(ours[p].numpy(), np.asarray(want))
