"""A numpy model of K3's step order (fdt_torch/csrc/track_assoc.cu, the
shared-memory variant), held bit for bit to the plain association and to
fdt's _associate_chunk on the CPU.

The kernel computes a frame's affinities up front, maps each to a 32-bit
key (zero canonicalised, NaN first, argmin's order reversed), walks the
live slots in visit order with each of 32 lanes owning a contiguous range
of K detections (a step takes the warp's maximum key, the lowest lane
holding it, then that lane's lowest k), records per step the matched
detection or whether any detection was left, and applies every update
after the walk.  This model does the same, so that a fault of that order
shows here before the card runs it.  The affinities come from the plain
version's own row functions: the model is of the order, not the arithmetic.
"""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.track.device_tracker import _associate_chunk  # noqa: E402
from fdt.track.device_tracker import init_slots as jax_init_slots  # noqa: E402
from fdt_torch.config import TrackerConfig  # noqa: E402
from fdt_torch.geometry.track import (_DEAD_ORDER, _distance_row, _iou_row,  # noqa: E402
                                      associate_chunk_plain, init_slots)
torch.set_num_threads(1)

NAN_KEY = np.uint32(0xFFFFFFFF)


def lane_dets(n: int) -> int:
    """Detections a lane of the walk owns: K, a power of two, 32 K >= n."""
    k = 1
    while 32 * k < n:
        k *= 2
    return k


def order_key(v, descending: bool) -> np.ndarray:
    """The kernel's order_key of float32 values: unsigned keys in argmax's
    (descending) or argmin's order, NaN first, -0.0 equal to +0.0."""
    v = np.asarray(v, np.float32)
    u = np.where(v == 0, np.float32(0), v).view(np.uint32)
    k = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    if not descending:
        k = ~k
    return np.where(np.isnan(v), NAN_KEY, k).astype(np.uint32)


def _i32(x: int) -> int:
    """x wrapped to int32, as the int32 counters of the kernel and torch."""
    return int(np.array(x & 0xFFFFFFFF, np.uint32).view(np.int32))


def _walk_step(keys: np.ndarray, rem: np.ndarray, k: int):
    """One step of the walk on a row of keys [32 K] (detection order) and
    the unconsumed valid flags: (top key, winner j)."""
    masked = np.where(rem, keys, np.uint32(0)).reshape(32, k)  # lane l owns l*K..l*K+K-1
    lane_max = masked.max(axis=1)
    top = lane_max.max()
    wl = int(np.flatnonzero(lane_max == top)[0])
    wk = int(np.flatnonzero(masked[wl] == top)[0])
    return top, wl * k + wk


def associate_chunk_model(slots, boxes, scores, valid, cfg):
    """K3's step order in numpy; the arguments and results are those of
    associate_chunk_plain (CPU tensors).  Also returns, a frame, the steps'
    (top key, winner j, matched, affinity row, unconsumed valid flags before
    the step) for the tests' own checks."""
    t, (f, n) = slots.alive.shape[0], valid.shape
    k = lane_dets(n)
    last_box, max_score = slots.last_box.clone(), slots.max_score.numpy().copy()
    length, order = slots.length.numpy().copy(), slots.order.numpy().copy()
    alive, key = slots.alive.numpy().copy(), int(slots.next_key[0])
    thr = order_key(cfg.sigma_iou if cfg.use_iou else cfg.sigma_dis, cfg.use_iou)
    assign = np.full((f, t), -1, np.int32)
    finish = np.zeros((f, t), bool)
    spawn = np.full((f, n), -1, np.int32)
    overflow = np.zeros(f, np.int32)
    steps = []
    for fr in range(f):
        b, sc, v = boxes[fr], scores[fr].numpy(), valid[fr].numpy()
        # A: live slots in slot order, ranked by (order, slot)
        live = np.flatnonzero(alive)
        visit = live[np.lexsort((live, order[live]))]
        row = _iou_row if cfg.use_iou else _distance_row
        values = [row(b, last_box[s]).numpy() for s in visit]  # from pre-frame boxes
        aff = np.zeros((len(visit), 32 * k), np.uint32)
        for i, vals in enumerate(values):
            aff[i, :n] = order_key(vals, cfg.use_iou)
        # B: the walk, the only serial part
        rem = np.zeros(32 * k, bool)
        rem[:n] = v
        res = {}
        frame_steps = []
        for i, s in enumerate(visit):
            top, j = _walk_step(aff[i], rem, k)
            matched = top > thr and top != NAN_KEY
            frame_steps.append((top, j, matched, values[i], rem[:n].copy()))
            if matched:
                rem[j] = False
            res[s] = j if matched else (-1 if top != 0 else -2)
        steps.append(frame_steps)
        # C: apply after the walk
        for s, r in res.items():
            if r >= 0:
                last_box[s] = b[r]
                max_score[s] = np.maximum(max_score[s], sc[r])  # NaN propagates
                length[s] += 1
                assign[fr, s] = r
            else:
                finish[fr, s] = r == -1 and max_score[s] > np.float32(cfg.sigma_h) \
                    and length[s] > cfg.t_min
                alive[s] = False
        order[~alive] = _DEAD_ORDER
        free = np.flatnonzero(~alive)
        new = np.flatnonzero(rem[:n])
        spawned = min(len(new), len(free))
        for rank, j in enumerate(new[:spawned]):
            s = free[rank]
            last_box[s] = b[j]
            max_score[s], length[s], alive[s] = sc[j], 1, True
            order[s] = _i32(key + rank)
            spawn[fr, j] = s
        overflow[fr] = len(new) - spawned
        key = _i32(key + spawned)
    new_slots = type(slots)(
        last_box=last_box, max_score=torch.from_numpy(max_score),
        length=torch.from_numpy(length), order=torch.from_numpy(order),
        alive=torch.from_numpy(alive), next_key=torch.tensor([key], dtype=torch.int32))
    records = [torch.from_numpy(a) for a in (assign, finish, spawn, overflow)]
    return new_slots, *records, steps


def _run(cfg, t_max, chunks, against):
    """Every chunk through the model and `against` (plain or fdt) from empty
    slots, each from its own state: records and state equal after each.
    Returns the model's steps."""
    model, other = init_slots(t_max, "cpu"), against.init(t_max)
    steps = []
    for c, chunk in enumerate(chunks):
        tensors = [torch.from_numpy(a) for a in chunk]
        model, *got, chunk_steps = associate_chunk_model(model, *tensors, cfg)
        steps += chunk_steps
        other, want = against.step(other, chunk, tensors, cfg)
        for name, g, w in zip(("assign", "finish", "spawn", "overflow"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name}, chunk {c}")
        for name in ("last_box", "max_score", "length", "order", "alive"):
            np.testing.assert_array_equal(  # bits: -0.0 apart from +0.0
                getattr(model, name).numpy().view(np.uint8),
                np.asarray(getattr(other, name)).view(np.uint8),
                err_msg=f"state {name} after chunk {c}")
        assert int(model.next_key[0]) == int(np.asarray(other.next_key).reshape(-1)[0])
    return steps


class _Plain:
    init = staticmethod(lambda t: init_slots(t, "cpu"))

    @staticmethod
    def step(slots, chunk, tensors, cfg):
        slots, *records = associate_chunk_plain(slots, *tensors, cfg)
        return slots, [r.numpy() for r in records]


class _Fdt:
    init = staticmethod(jax_init_slots)

    @staticmethod
    def step(slots, chunk, tensors, cfg):
        boxes, scores, valid = chunk
        slots, records = _associate_chunk(
            slots, jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), cfg.sigma_iou,
            cfg.sigma_dis, cfg.sigma_h, cfg.t_min, cfg.use_iou)
        return slots, [np.asarray(r) for r in records]


def _random_case(seed, use_iou):
    stream = chip_smoke.track_stream(seed)
    return (TrackerConfig(use_iou=use_iou, t_min=3), 64,
            [chip_smoke.pad_rows(stream[:17], 16), chip_smoke.pad_rows(stream[17:], 16)])


@pytest.mark.parametrize("name", chip_smoke.TRACK_EDGES)
def test_model_equals_plain_on_k3_edges(name):
    """Bit for bit on every case K3 is held to on the card."""
    _run(*chip_smoke.track_edge_case(name), _Plain)


@pytest.mark.parametrize("use_iou", [True, False])
@pytest.mark.parametrize("seed", [0, 7, 11, 13])
def test_model_equals_plain_on_random_streams(seed, use_iou):
    _run(*_random_case(seed, use_iou), _Plain)


@pytest.mark.parametrize("name", ["signed-zero", "inf-boxes", "iou-ties", "distance-ties",
                                  "nan-sentinel-meets-zero-area", "n33", "overflow-t8"])
def test_model_equals_fdt_on_small_cases(name):
    _run(*chip_smoke.track_edge_case(name), _Fdt)


def test_model_equals_fdt_on_a_random_stream():
    _run(*_random_case(7, True), _Fdt)


def test_order_key_on_zeros_infinities_nans_and_ties():
    inf, nan = np.float32(np.inf), np.float32(np.nan)
    vals = np.array([-inf, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0, inf], np.float32)
    for descending in (True, False):
        keys = order_key(vals, descending)
        assert keys[3] == keys[4]                      # -0.0 ties +0.0
        ranked = keys[[0, 1, 2, 4, 5, 6, 7]].astype(np.int64)
        assert (np.diff(ranked) > 0).all() if descending else (np.diff(ranked) < 0).all()
        assert 0x007FFFFF <= keys.min() and keys.max() <= 0xFF800000
        # every NaN payload, either sign, is the one first key
        nans = np.array([nan, -nan, np.uint32(0x7F800001).view(np.float32),
                         np.uint32(0xFFC00001).view(np.float32)], np.float32)
        assert (order_key(nans, descending) == NAN_KEY).all()
    # ties go to the lowest j: across lanes (K = 2: j 1 in lane 0, j 2 in
    # lane 1) and within a lane
    keys = np.zeros(64, np.uint32)
    keys[[1, 2, 5]] = order_key(np.float32(0.5), True)
    rem = np.ones(64, bool)
    assert _walk_step(keys, rem, 2) == (keys[1], 1)
    rem[1] = False
    assert _walk_step(keys, rem, 2) == (keys[2], 2)
    # a NaN beats every value, and the first NaN wins; nothing left is key 0
    keys[[40, 9]] = NAN_KEY
    assert _walk_step(keys, np.ones(64, bool), 2) == (NAN_KEY, 9)
    assert _walk_step(keys, np.zeros(64, bool), 2)[0] == 0


def test_signed_zero_case_ties_minus_and_plus_zero_at_a_match():
    """The case's walk matches a maximum that -0.0 and +0.0 share, with the
    first of the tied detections -0.0 in one step and +0.0 in another: a
    key that told them apart would move the match."""
    steps = _run(*chip_smoke.track_edge_case("signed-zero"), _Plain)
    first_signs = set()
    for frame in steps:
        for top, j, matched, row, rem in frame:
            tied = np.flatnonzero(rem & (row == 0))
            if matched and top == order_key(np.float32(0), True) and len(tied) > 1:
                signs = np.signbit(row[tied])
                assert j == tied[0]
                if signs.any() and not signs.all():
                    first_signs.add(bool(signs[0]))
    assert first_signs == {True, False}


def test_inf_boxes_case_meets_infinite_and_nan_affinities():
    for name in ("inf-boxes", "inf-boxes-distance"):
        cfg, t_max, chunks = chip_smoke.track_edge_case(name)
        boxes = np.concatenate([c[0] for c in chunks])
        assert np.isinf(boxes).any() and np.isfinite(boxes).any()
        steps = _run(cfg, t_max, chunks, _Plain)
        tops = [step[0] for frame in steps for step in frame]
        assert NAN_KEY in tops and any(step[2] for frame in steps for step in frame)
