"""fdt_torch's IoU tracking (host tracker, slot state, the association's plain
version and the device tracker) against fdt's, on inputs made from numpy
seeds: the quirk scenarios of tests/test_tracker.py, its randomized streams
(chip_smoke.track_stream) and the edges of kernel K3
(chip_smoke.TRACK_EDGES).  The kernel itself runs on the card only
(tests/test_torch_cuda.py)."""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import fdt.track.iou_tracker as jax_iou_tracker  # noqa: E402
from fdt.config import TrackerConfig as JaxTrackerConfig  # noqa: E402
from fdt.track import IoUTracker as JaxIoUTracker  # noqa: E402
from fdt.track.device_tracker import DeviceIoUTracker as JaxDeviceIoUTracker  # noqa: E402
from fdt.track.device_tracker import _associate_chunk  # noqa: E402
from fdt.track.device_tracker import init_slots as jax_init_slots  # noqa: E402
from fdt_torch.config import TRACKER, TrackerConfig  # noqa: E402
from fdt_torch.ops import track as track_op  # noqa: E402
from fdt_torch.track import (DeviceIoUTracker, FusedVideoTracker, IoUTracker,  # noqa: E402
                             load_tracks, save_tracks, track_detections)
from fdt_torch.geometry.track import _DEAD_ORDER, associate_chunk_plain, init_slots  # noqa: E402

torch.set_num_threads(1)


def det(x1, y1, x2, y2, s):
    return [x1, y1, x2, y2, s]


def _jax_cfg(cfg: TrackerConfig) -> JaxTrackerConfig:
    return JaxTrackerConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def test_config_is_fdts():
    assert TRACKER.__dataclass_fields__.keys() == JaxTrackerConfig.__dataclass_fields__.keys()
    assert _jax_cfg(TRACKER) == JaxTrackerConfig()
    assert _DEAD_ORDER == int(jnp.iinfo(jnp.int32).max)


# the scenarios of tests/test_tracker.py:16-92: frames, config
SCENARIOS = {
    "basic-lifecycle": (
        [[det(0, 0, 10, 10, 0.9)], [det(1, 0, 11, 10, 0.95)], [det(2, 0, 12, 10, 0.7)],
         [det(100, 100, 110, 110, 0.8)]], dict(sigma_iou=0.4, sigma_h=0.6, t_min=2)),
    "unmatched-finishes-in-loop": (
        [[det(0, 0, 10, 10, 0.9)]] * 3 + [[det(500, 500, 510, 510, 0.1)]],
        dict(sigma_iou=0.4, sigma_h=0.6, t_min=2)),
    "empty-frame-drops-silently": (
        [[det(0, 0, 10, 10, 0.9)]] * 3 + [[]] + [[det(0, 0, 10, 10, 0.9)]],
        dict(sigma_iou=0.4, sigma_h=0.6, t_min=2)),
    "flush-takes-len-equal-t_min": (
        [[det(0, 0, 10, 10, 0.9)]] * 3, dict(sigma_iou=0.4, sigma_h=0.6, t_min=3)),
    "loop-needs-len-above-t_min": (
        [[det(0, 0, 10, 10, 0.9)]] * 3 + [[det(500, 500, 510, 510, 0.1)]],
        dict(sigma_iou=0.4, sigma_h=0.6, t_min=3)),
    "greedy-order-and-removal": (
        [[det(0, 0, 10, 10, 0.9), det(20, 0, 30, 10, 0.8)],
         [det(1, 0, 11, 10, 0.5), det(21, 0, 31, 10, 0.5)],
         [det(2, 0, 12, 10, 0.5), det(22, 0, 32, 10, 0.5)]],
        dict(sigma_iou=0.4, sigma_h=0.6, t_min=2)),
    "distance-mode": (
        [[det(0, 0, 10, 10, 0.9)], [det(3, 0, 13, 10, 0.9)], [det(6, 0, 16, 10, 0.9)]],
        dict(use_iou=False, sigma_dis=8.0, sigma_h=0.6, t_min=2)),
}


@pytest.mark.parametrize("name", SCENARIOS)
def test_host_tracker_equals_fdts_on_the_quirk_scenarios(name, tmp_path):
    frames, kw = SCENARIOS[name]
    frames = [np.asarray(f, np.float64).reshape(-1, 5) for f in frames]
    cfg = TrackerConfig(**kw)
    got = track_detections(frames, cfg)
    assert got == jax_iou_tracker.track_detections(frames, _jax_cfg(cfg))
    host = IoUTracker(cfg)
    for f in frames:
        host.step(f)
    assert host.flush() == got and host.active == [] and host.frame_num == len(frames)
    path = tmp_path / "tracks.npy"
    save_tracks(got, str(path))
    assert load_tracks(str(path)) == got


def test_host_tracker_quirks():
    """The three quirks, spelled out on the port alone."""
    frames, kw = SCENARIOS["empty-frame-drops-silently"]
    assert track_detections([np.asarray(f).reshape(-1, 5) for f in frames],
                            TrackerConfig(**kw)) == []
    frames, kw = SCENARIOS["flush-takes-len-equal-t_min"]
    assert len(track_detections(np.asarray(frames), TrackerConfig(**kw))) == 1
    frames, kw = SCENARIOS["loop-needs-len-above-t_min"]
    tracks = track_detections([np.asarray(f) for f in frames], TrackerConfig(**kw))
    assert all(t["start_frame"] != 1 or len(t["bboxes"]) != 3 for t in tracks)


class _Compared:
    """Records the affinity each host-tracker step compares with its
    threshold (the row's max IoU or min distance) by wrapping fdt's row
    functions."""

    def __init__(self, monkeypatch):
        self.iou, self.dis = [], []
        iou, dis = jax_iou_tracker._iou_to_last, jax_iou_tracker._distance_to_last

        def iou_rec(dets, last):
            out = iou(dets, last)
            self.iou.append(np.nanmax(out) if np.isfinite(out).any() else np.nan)
            return out

        def dis_rec(dets, last):
            out = dis(dets, last)
            self.dis.append(np.nanmin(out) if np.isfinite(out).any() else np.nan)
            return out

        monkeypatch.setattr(jax_iou_tracker, "_iou_to_last", iou_rec)
        monkeypatch.setattr(jax_iou_tracker, "_distance_to_last", dis_rec)

    def assert_clear_of(self, cfg, margin: float = 1e-6):
        """No compared affinity within `margin` of its threshold: float32 and
        float64 then decide alike."""
        iou, dis = np.asarray(self.iou), np.asarray(self.dis)
        assert not (np.abs(iou - cfg.sigma_iou) <= margin).any()
        assert not (np.abs(dis - cfg.sigma_dis) <= margin).any()


def _host_tracks(stream, cfg):
    host = JaxIoUTracker(_jax_cfg(cfg))
    for rows in stream:
        host.step(rows)
    return host.flush()


@pytest.mark.parametrize("use_iou", [True, False])
@pytest.mark.parametrize("seed", [0, 7, 11])
def test_device_tracker_on_cpu_matches_fdt(use_iou, seed, monkeypatch):
    """The port's DeviceIoUTracker (plain association, CPU) against fdt's
    DeviceIoUTracker and fdt's host IoUTracker, chunked unevenly: the same
    tracks in the same order, start frames, boxes (copied from the rows, so
    bit-equal) and max scores."""
    cfg = TrackerConfig(use_iou=use_iou, t_min=3)
    stream = chip_smoke.track_stream(seed)
    compared = _Compared(monkeypatch)
    want = _host_tracks(stream, cfg)
    compared.assert_clear_of(cfg)
    assert want, "the stream must finish a track"

    jdev = JaxDeviceIoUTracker(_jax_cfg(cfg), t_max=64)
    jdev.step_chunk(stream[:17])
    jdev.step_chunk(stream[17:])
    dev = DeviceIoUTracker(cfg, t_max=64, device="cpu")
    dev.step_chunk(stream[:17])        # uneven chunking on purpose
    dev.step_chunk(stream[17:23])
    dev.step_chunk(stream[23:])
    got = dev.flush()
    assert got == jdev.flush()
    assert got == want


def _jax_records(slots, chunk, cfg):
    boxes, scores, valid = chunk
    new, (assign, finish, spawn, overflow) = _associate_chunk(
        slots, jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), cfg.sigma_iou,
        cfg.sigma_dis, cfg.sigma_h, cfg.t_min, cfg.use_iou)
    return new, [np.asarray(a) for a in (assign, finish, spawn, overflow)]


def _check_chunks_against_fdt(cfg, t_max, chunks):
    """Run the chunks through fdt's _associate_chunk and the port's plain
    version from empty slots: equal records and equal state after each."""
    jslots, slots = jax_init_slots(t_max), init_slots(t_max, "cpu")
    for chunk in chunks:
        jslots, want = _jax_records(jslots, chunk, cfg)
        slots, *got = associate_chunk_plain(
            slots, *(torch.from_numpy(a) for a in chunk), cfg)
        for name, g, w in zip(("assign", "finish", "spawn", "overflow"), got, want):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        for name in ("last_box", "max_score", "length", "order", "alive"):
            np.testing.assert_array_equal(getattr(slots, name).numpy(),
                                          np.asarray(getattr(jslots, name)), err_msg=name)
        assert int(slots.next_key) == int(jslots.next_key)
    return slots


@pytest.mark.parametrize("name", chip_smoke.TRACK_EDGES)
def test_plain_association_records_equal_fdts_on_k3_edges(name):
    """associate_chunk_plain against fdt's _associate_chunk on
    chip_smoke.TRACK_EDGES (the cases K3 is held to on the card): the NaN of
    a sentinel-born track meeting a zero-area row, ties, both modes, pad
    widths 1 to 750, an overflowing chunk, more than 64 live tracks."""
    cfg, t_max, chunks = chip_smoke.track_edge_case(name)
    slots = _check_chunks_against_fdt(cfg, t_max, chunks)
    if name == "overflow-t8":
        _, _, _, _, overflow = associate_chunk_plain(
            init_slots(t_max, "cpu"), *(torch.from_numpy(a) for a in chunks[0]), cfg)
        assert int(overflow.sum()) > 0
    if name == "live-over-64":
        assert int(slots.alive.sum()) > 64


def test_plain_association_leaves_its_input_state_alone():
    cfg, t_max, chunks = chip_smoke.track_edge_case("iou-mode")
    slots = init_slots(t_max, "cpu")
    slots, *_ = associate_chunk_plain(slots, *(torch.from_numpy(a) for a in chunks[0]), cfg)
    before = {k: v.clone() for k, v in vars(slots).items()}
    associate_chunk_plain(slots, *(torch.from_numpy(a) for a in chunks[1]), cfg)
    assert all(torch.equal(v, before[k]) for k, v in vars(slots).items())


def test_nan_sentinel_case_has_a_nan_iou():
    """A track born of the sentinel row (last box [0, 0, 0, 0]) meets a
    zero-area row: its IoU is 0/0 = NaN, which the argmax takes first, so
    the track matches nothing, dies, and its slot is the first reused."""
    from fdt_torch.geometry.track import _iou_row

    cfg, t_max, chunks = chip_smoke.track_edge_case("nan-sentinel-meets-zero-area")
    boxes, scores, valid = (torch.from_numpy(a) for a in chunks[0])
    first, *_ = associate_chunk_plain(init_slots(t_max, "cpu"), boxes[:1], scores[:1],
                                      valid[:1], cfg)
    assert first.alive[0] and not first.last_box[0].any()
    row = _iou_row(boxes[1], first.last_box[0])
    assert row[0] == 0 and torch.isnan(row[1]) and int(torch.argmax(row)) == 1
    _, assign, finish, spawn, _ = associate_chunk_plain(
        init_slots(t_max, "cpu"), boxes, scores, valid, cfg)
    assert spawn[0, 0] == 0 and (assign[1] == -1).all() and not finish[1].any()
    assert spawn[1].tolist() == [0, 1]  # slot 0, freed in this frame, first


def test_device_tracker_autogrows_from_t_max_8():
    """More simultaneous tracks than t_max must grow the slots, not fail:
    the host tracker is unbounded."""
    cfg, _, chunks = chip_smoke.track_edge_case("overflow-t8")
    stream = chip_smoke.unpad_rows(chunks)   # 24 separated persistent boxes
    assert len(stream) == 6 and all(len(r) == 24 for r in stream)
    dev = DeviceIoUTracker(cfg, t_max=8, device="cpu")
    dev.step_chunk(stream)
    got = dev.flush()
    assert dev.t_max >= 24 and dev.slots.alive.shape == (dev.t_max,)
    assert got == track_detections(stream, cfg)
    assert got == jax_iou_tracker.track_detections(stream, _jax_cfg(cfg))


def test_device_tracker_flush_resets_device_state():
    """Stepping after flush() starts fresh (the IoUTracker contract)."""
    cfg = TrackerConfig(t_min=1)
    rows = np.array([[10, 10, 50, 50, 0.9]], np.float32)
    dev = DeviceIoUTracker(cfg, t_max=8, device="cpu")
    for _ in range(3):
        dev.step(rows)
    first = dev.flush()
    assert len(first) == 1 and len(first[0]["bboxes"]) == 3
    assert not bool(dev.slots.alive.any()) and int(dev.slots.next_key) == 0
    for _ in range(2):
        dev.step(rows)
    second = dev.flush()
    assert len(second) == 2          # the finished list accumulates (reference)
    assert len(second[1]["bboxes"]) == 2 and second[1]["start_frame"] == 4


def test_device_tracker_keeps_a_grown_pad_width():
    dev = DeviceIoUTracker(TRACKER, pad_n=4, device="cpu")
    dev.step_chunk([np.zeros((9, 5), np.float32)])
    dev.step_chunk([np.zeros((2, 5), np.float32)])
    assert dev.pad_n == 16


def test_trackers_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceIoUTracker(TRACKER)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    cfg, t_max, chunks = chip_smoke.track_edge_case("iou-mode")
    tensors = [torch.from_numpy(a) for a in chunks[0]]
    before = track_op.launches.count
    got = track_op.associate_chunk(init_slots(t_max, "cpu"), *tensors, cfg)
    want = associate_chunk_plain(init_slots(t_max, "cpu"), *tensors, cfg)
    assert track_op.launches.count == before
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    assert all(torch.equal(getattr(got[0], k), getattr(want[0], k)) for k in vars(want[0]))


def test_wrapper_checks_dtypes_and_shapes():
    cfg, t_max, chunks = chip_smoke.track_edge_case("iou-mode")
    boxes, scores, valid = (torch.from_numpy(a) for a in chunks[0])
    slots = init_slots(t_max, "cpu")
    with pytest.raises(ValueError, match="boxes must be torch.float32"):
        track_op.associate_chunk(slots, boxes.double(), scores, valid, cfg)
    with pytest.raises(ValueError, match="valid must be"):
        track_op.associate_chunk(slots, boxes, scores, valid.to(torch.uint8), cfg)
    with pytest.raises(ValueError, match="scores must be"):
        track_op.associate_chunk(slots, boxes, scores[:, :-1], valid, cfg)
    with pytest.raises(ValueError, match="N >= 1"):
        track_op.associate_chunk(slots, boxes[:, :0], scores[:, :0], valid[:, :0], cfg)
    slots.order = slots.order.long()
    with pytest.raises(ValueError, match="order must be"):
        track_op.associate_chunk(slots, boxes, scores, valid, cfg)


class _Detector:
    """The attributes FusedVideoTracker reads of a detector before its first
    chunk."""

    def __init__(self):
        from fdt_torch.config import PYRAMID_CONFIGS
        self.cfg = PYRAMID_CONFIGS["try3"]
        self.device = torch.device("cpu")


def test_fused_tracker_refuses_a_cap_outside_top_k_and_a_floor_at_zero():
    detector = _Detector()
    for cap in (0, -1, 751):
        with pytest.raises(ValueError, match="det_cap"):
            FusedVideoTracker(detector, det_cap=cap)
    with pytest.raises(ValueError, match="score_floor"):
        FusedVideoTracker(detector, TrackerConfig(score_floor=0.0))
    tracker = FusedVideoTracker(detector)
    assert tracker.det_cap == tracker.pad_n == 750 and tracker.device.type == "cpu"
    assert (tracker.conf_thresh, tracker.nms_thresh) == (0.2, 0.35)
