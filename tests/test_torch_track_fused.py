"""The port's fused detect + associate (FusedVideoTracker) as a whole, on the
CPU at 128²: against its own unfused path (detect_tensor, then
detections_to_rows, then the host IoUTracker) at the same chunk shapes, and
with the trained try3 weights against fdt's track_detections over fdt's own
detections of the same frames."""
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import fdt.track.iou_tracker as jax_iou_tracker  # noqa: E402
from fdt.config import TrackerConfig as JaxTrackerConfig  # noqa: E402
from fdt.infer.pyramidbox import PyramidBoxDetector as JaxDetector  # noqa: E402
from fdt.infer.pyramidbox import detections_to_rows as jax_rows  # noqa: E402
from fdt.models.pyramidbox_mobile import build_pyramidbox as jax_build  # noqa: E402
from fdt_torch.config import TrackerConfig  # noqa: E402
from fdt_torch.infer import PyramidBoxDetector, detections_to_rows  # noqa: E402
from fdt_torch.models import (build_pyramidbox, from_jax_variables, load_npz,  # noqa: E402
                              load_pyramidbox_detector)
from fdt_torch.ops import track as track_op  # noqa: E402
from fdt_torch.track import FusedVideoTracker, track_detections  # noqa: E402

torch.set_num_threads(1)

SIZE, FRAMES, CHUNK = 128, 6, 3
SCALE = [SIZE] * 4


def _frames() -> np.ndarray:
    """A seeded frame panned 3 px a frame (tests/test_tracker.py:216-218)."""
    base = np.random.RandomState(7).randint(0, 255, (SIZE, SIZE, 3), np.uint8)
    return np.stack([np.roll(base, 3 * f, axis=1) for f in range(FRAMES)])


@pytest.fixture(scope="module")
def seeded_detector():
    model = build_pyramidbox("try3")
    model.load_state_dict(from_jax_variables(chip_smoke.seeded_variables(model, 0)),
                          strict=True)
    return PyramidBoxDetector(model, "try3", device="cpu")


def _unfused(detector, frames, floor, cap=None, **kw):
    """detect_tensor in the fused tracker's chunks, then the host row walk,
    capped at `cap` rows a frame."""
    det = np.concatenate([detector.detect_tensor(frames[i:i + CHUNK], **kw)
                          for i in range(0, len(frames), CHUNK)])
    return det, [detections_to_rows(d, floor, SCALE)[:cap] for d in det]


def _fused(detector, cfg, frames, **kw):
    tracker = FusedVideoTracker(detector, cfg, **kw)
    for i in range(0, len(frames), CHUNK):
        tracker.step_frames(frames[i:i + CHUNK])  # chunks carry the slot state over
    return tracker, tracker.flush()


def test_fused_equals_unfused_at_the_same_chunk_shapes(seeded_detector):
    """Seeded try3: its scores saturate (about 300 rows a frame at 1.0), so
    det_cap = 16 keeps the top rows as bench.py's rows[:32] does; tracks,
    histories and scores bit-equal; one K1 wrapper call a chunk and no
    kernel launch on the CPU."""
    frames = _frames()
    cfg = TrackerConfig(score_floor=0.5, t_min=2)
    _, rows = _unfused(seeded_detector, frames, 0.5, cap=16)
    assert min(map(len, rows)) == 16
    want = track_detections(rows, cfg)
    assert want, "the fixture must finish a track"
    before = track_op.launches.count
    tracker, got = _fused(seeded_detector, cfg, frames, det_cap=16)
    assert got == want and tracker.frame_num == FRAMES
    assert track_op.launches.count == before


def test_fused_overflow_redo_grows_and_stays_equal(seeded_detector):
    """t_max = 2 forces the grow-and-redo path (the association re-runs from
    the rows already read back); lookahead 2 puts a second chunk in flight
    behind the overflowing one."""
    frames = _frames()
    cfg = TrackerConfig(score_floor=0.5, t_min=2)
    want = track_detections(_unfused(seeded_detector, frames, 0.5, cap=16)[1], cfg)
    for lookahead in (0, 1, 2):
        tracker, got = _fused(seeded_detector, cfg, frames, det_cap=16, t_max=2,
                              lookahead=lookahead)
        assert got == want
        assert tracker.t_max >= 16 and tracker.slots.alive.shape == (tracker.t_max,)


def test_fused_sentinel_rows_equal_unfused(seeded_detector):
    """A floor above every score: every frame is the [[0, 0, 0, 0, 0.4]]
    sentinel row on both paths."""
    frames = _frames()
    det, _ = _unfused(seeded_detector, frames, 1.0)
    hi = float(det[:, 1, :, 0].max()) + 0.1
    cfg = TrackerConfig(score_floor=hi, t_min=1, sigma_h=0.3)
    rows = [detections_to_rows(d, hi, SCALE) for d in det]
    assert all(r.tolist() == [[0, 0, 0, 0, np.float32(0.4)]] for r in rows)
    tracker = FusedVideoTracker(seeded_detector, cfg)
    tracker.step_frames(frames)
    assert tracker.flush() == track_detections(rows, cfg)


def _clear_floor(scores: np.ndarray, lo: float, hi: float) -> tuple[float, float]:
    """The midpoint of the widest gap between consecutive scores in
    [lo, hi], and half that gap."""
    s = np.unique(scores[(scores >= lo) & (scores <= hi)])
    k = int(np.argmax(np.diff(s)))
    return float((s[k] + s[k + 1]) / 2), float((s[k + 1] - s[k]) / 2)


def test_fused_trained_try3_matches_fdts_tracks(monkeypatch):
    """The trained try3 at 128²: the port's fused tracker against fdt's
    track_detections over fdt's JAX detect_tensor rows of the same frames.
    Tracks, start frames and lengths equal; scores within 1e-5; boxes within
    1e-3 px.  Guards on fdt's side: no score within 4× the two detectors'
    measured score difference of the floor, and no compared IoU within 1e-4
    of sigma_iou."""
    path = str(REPO / chip_smoke.VARIANT_WEIGHTS["try3"])
    frames = _frames()
    conf, nms = 0.05, 0.35
    jdet = JaxDetector(load_npz(path), jax_build("try3"), "try3", precision="highest")
    theirs = jdet.detect_tensor(frames, conf_thresh=conf, nms_thresh=nms)
    detector = load_pyramidbox_detector("try3", path, device="cpu")
    ours, _ = _unfused(detector, frames, 1.0, conf_thresh=conf, nms_thresh=nms)
    diff = float(np.abs(ours - theirs).max())
    assert diff < 1e-5
    floor, half_gap = _clear_floor(theirs[:, 1, :, 0], 0.07, 0.11)
    assert half_gap > 4 * diff
    cfg = TrackerConfig(score_floor=floor, t_min=2, sigma_h=0.1)

    compared = []
    iou = jax_iou_tracker._iou_to_last
    monkeypatch.setattr(jax_iou_tracker, "_iou_to_last",
                        lambda d, last: compared.append(np.nanmax(iou(d, last)))
                        or iou(d, last))
    rows = [jax_rows(d, floor, SCALE) for d in theirs]
    want = jax_iou_tracker.track_detections(
        rows, JaxTrackerConfig(score_floor=floor, t_min=2, sigma_h=0.1))
    # the boxes differ by at most diff × 128 px (~1e-3), which moves the IoU
    # of boxes of 10 px or more by ~1e-4 at most
    assert not (np.abs(np.asarray(compared) - cfg.sigma_iou) <= 1e-4).any()
    assert want and min(map(len, rows)) > 3

    _, got = _fused(detector, cfg, frames, threshold=conf, nms_thresh=nms)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["start_frame"] == w["start_frame"]
        assert len(g["bboxes"]) == len(w["bboxes"])
        assert abs(g["max_score"] - w["max_score"]) <= 1e-5
        np.testing.assert_allclose(g["bboxes"], w["bboxes"], rtol=0, atol=1e-3)
