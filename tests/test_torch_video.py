"""The port's video paths against fdt's, on the CPU: track_video (host and
device trackers) and track_video_fused, render_tracks' colour and overlay
arithmetic, the frame reader, the demos and the CLIs.

fdt reads a video file with cv2; the port decodes no video.  So the test
writes a 6-frame 128×128 mp4 with cv2, fdt reads the file, and the test
decodes it with cv2 and hands the same frames to the port.  With the trained
try3 at 128² (the precedent of tests/test_torch_track_fused.py): tracks,
start frames and lengths equal, max_score within 1e-5, boxes within 1e-3 px,
guarded on fdt's side (the detection floor at the middle of a wide gap
between scores, no compared IoU within 1e-4 of sigma_iou).
"""
import dataclasses
import pathlib
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import fdt.track.iou_tracker as jax_iou_tracker  # noqa: E402
from fdt.config import DetectConfig as JaxDetectConfig  # noqa: E402
from fdt.config import TrackerConfig as JaxTrackerConfig  # noqa: E402
from fdt.infer.pyramidbox import PyramidBoxDetector as JaxDetector  # noqa: E402
from fdt.models.pyramidbox_mobile import build_pyramidbox as jax_build  # noqa: E402
from fdt.track.display import render_tracks as jax_render_tracks  # noqa: E402
from fdt.track.fused import track_video_fused as jax_track_video_fused  # noqa: E402
from fdt_torch.config import DetectConfig, TrackerConfig  # noqa: E402
from fdt_torch.data.frames import fit_frame, read_frames  # noqa: E402
from fdt_torch.models import load_npz, load_pyramidbox_detector  # noqa: E402
from fdt_torch.ops import track as track_op  # noqa: E402
from fdt_torch.track import track_video, track_video_fused  # noqa: E402
from fdt_torch.track.display import _composite, _track_colour, render_tracks  # noqa: E402

torch.set_num_threads(1)

SIZE, FRAMES, BATCH = 128, 6, 3
CONF, NMS = 0.05, 0.35
LEGS = ("host", "device", "fused")
TRY3 = str(REPO / chip_smoke.VARIANT_WEIGHTS["try3"])


def _frames() -> np.ndarray:
    """A seeded frame panned 3 px a frame (tests/test_tracker.py:216-218)."""
    base = np.random.RandomState(7).randint(0, 255, (SIZE, SIZE, 3), np.uint8)
    return np.stack([np.roll(base, 3 * f, axis=1) for f in range(FRAMES)])


def write_video(path: pathlib.Path, frames) -> None:
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()


def decode_video(path: pathlib.Path) -> list:
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """(the mp4's path, its frames as cv2 decodes them)."""
    path = tmp_path_factory.mktemp("video") / "clip.mp4"
    write_video(path, _frames())
    frames = decode_video(path)
    assert len(frames) == FRAMES and frames[0].shape == (SIZE, SIZE, 3)
    return path, frames


def _clear_floor(scores: np.ndarray, lo: float, hi: float) -> tuple[float, float]:
    """The midpoint of the widest gap between consecutive scores in
    [lo, hi], and half that gap."""
    s = np.unique(scores[(scores >= lo) & (scores <= hi)])
    k = int(np.argmax(np.diff(s)))
    return float((s[k] + s[k + 1]) / 2), float((s[k + 1] - s[k]) / 2)


@pytest.fixture(scope="module")
def detectors(video):
    """fdt's and the port's trained try3 detecting at conf 0.05, and the
    tracker setting whose floor lies in a wide gap of fdt's scores on the
    video's frames (guarded against the two detectors' measured difference)."""
    _, frames = video
    jdet = JaxDetector(load_npz(TRY3), jax_build("try3"), "try3", precision="highest",
                       detect_cfg=dataclasses.replace(JaxDetectConfig(), conf_thresh=CONF,
                                                      nms_thresh=NMS))
    det = load_pyramidbox_detector("try3", TRY3, device="cpu",
                                   detect_cfg=dataclasses.replace(DetectConfig(),
                                                                  conf_thresh=CONF,
                                                                  nms_thresh=NMS))
    stack = np.stack(frames)
    theirs = np.concatenate([jdet.detect_tensor(stack[i:i + BATCH])
                             for i in range(0, FRAMES, BATCH)])
    ours = np.concatenate([det.detect_tensor(stack[i:i + BATCH])
                           for i in range(0, FRAMES, BATCH)])
    diff = float(np.abs(ours - theirs).max())
    assert diff < 1e-5
    floor, half_gap = _clear_floor(theirs[:, 1, :, 0], 0.07, 0.11)
    assert half_gap > 4 * diff
    return jdet, det, dict(score_floor=floor, t_min=2, sigma_h=0.1)


@pytest.fixture(scope="module")
def fdt_tracks(video, detectors):
    """fdt's tracks of the video file through its three legs, and every IoU
    its host tracker compared against sigma_iou."""
    path, _ = video
    jdet, _, setting = detectors
    cfg = JaxTrackerConfig(**setting)
    compared = []
    iou = jax_iou_tracker._iou_to_last

    def recording(d, last):
        compared.append(np.nanmax(iou(d, last)))
        return iou(d, last)

    jax_iou_tracker._iou_to_last = recording
    try:
        host = jax_iou_tracker.track_video(str(path), jdet, cfg, batch_size=BATCH,
                                           frame_size=(SIZE, SIZE))
    finally:
        jax_iou_tracker._iou_to_last = iou
    return {"host": host, "compared": compared,
            "device": jax_iou_tracker.track_video(str(path), jdet, cfg, batch_size=BATCH,
                                                  frame_size=(SIZE, SIZE),
                                                  device_tracker=True),
            "fused": jax_track_video_fused(str(path), jdet, cfg, batch_size=BATCH,
                                           frame_size=(SIZE, SIZE))}


@pytest.mark.parametrize("leg", LEGS)
def test_video_leg_matches_fdt(video, detectors, fdt_tracks, leg):
    """The port's leg on the frames cv2 decodes from the file against fdt's
    same leg on the file: tracks, start frames and lengths equal, max_score
    within 1e-5, boxes within 1e-3 px; K3 launches nowhere on the CPU."""
    _, frames = video
    _, det, setting = detectors
    want = fdt_tracks[leg]
    # the boxes differ by at most ~1e-5 × 128 px, which moves the IoU of boxes
    # of 10 px or more by ~1e-4 at most
    compared = np.asarray(fdt_tracks["compared"])
    assert compared.size and not (np.abs(compared - 0.4) <= 1e-4).any()
    assert want and any(len(t["bboxes"]) > 2 for t in want)
    cfg = TrackerConfig(**setting)
    before = track_op.launches.count
    kw = dict(batch_size=BATCH, frame_size=(SIZE, SIZE))
    if leg == "fused":
        got = track_video_fused(iter(frames), det, cfg, **kw)
    else:
        got = track_video(iter(frames), det, cfg, device_tracker=leg == "device", **kw)
    assert track_op.launches.count == before
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["start_frame"] == w["start_frame"]
        assert len(g["bboxes"]) == len(w["bboxes"])
        assert abs(g["max_score"] - w["max_score"]) <= 1e-5
        np.testing.assert_allclose(g["bboxes"], w["bboxes"], rtol=0, atol=1e-3)


def test_frames_not_at_frame_size_are_fitted_as_cv2_fits_them(video, detectors):
    """A frame of another size goes through resize_bilinear (within 1 LSB of
    cv2.resize); one at frame_size is taken as it is."""
    _, frames = video
    _, det, setting = detectors
    small = [cv2.resize(f, (96, 112)) for f in frames]
    fitted = [fit_frame(f, (SIZE, SIZE)) for f in small]
    assert fit_frame(frames[0], (SIZE, SIZE)) is frames[0]
    for f, s in zip(fitted, small):
        assert np.abs(f.astype(int) - cv2.resize(s, (SIZE, SIZE))).max() <= 1
    cfg = TrackerConfig(**setting)
    assert (track_video(small, det, cfg, batch_size=BATCH, frame_size=(SIZE, SIZE))
            == track_video(fitted, det, cfg, batch_size=BATCH, frame_size=(SIZE, SIZE)))


# --- render_tracks ------------------------------------------------------------------------

def test_track_colour_equals_cv2_for_every_hue():
    for hue in range(256):
        want = cv2.cvtColor(np.uint8([[(hue, 255, 255)]]), cv2.COLOR_HSV2BGR)[0, 0].tolist()
        assert _track_colour(hue) == want, hue
    assert _track_colour(300) == _track_colour(300 - 256)


def test_composite_bit_equal_to_cv2():
    """cv2's BGR2GRAY, threshold(1, THRESH_BINARY_INV), bitwise_and with the
    mask and saturating add, on seeded frames and drawboards: random ones
    with black pixels, and boards of levels 0-3 alone, whose gray lies on
    both sides of the threshold."""
    rng = np.random.RandomState(0)
    for shape, top in (((48, 64, 3), 256), ((31, 17, 3), 256), ((1 << 14, 1, 3), 4)):
        image = rng.randint(0, 256, shape, dtype=np.uint8)
        board = rng.randint(0, top, shape, dtype=np.uint8)
        board[rng.rand(*shape[:2]) < 0.3] = 0
        mask = cv2.threshold(cv2.cvtColor(board, cv2.COLOR_BGR2GRAY), 1, 255,
                             cv2.THRESH_BINARY_INV)[1]
        want = cv2.add(cv2.bitwise_and(image, image, mask=mask), board)
        np.testing.assert_array_equal(_composite(image, board), want)


def _seed_drawing_hue(at_least: int) -> int:
    """The first seed whose RandomState's first randint(0, 360), the first
    track's hue, is at least `at_least`."""
    return next(s for s in range(1000) if np.random.RandomState(s).randint(0, 360) >= at_least)


TRACKS = [{"bboxes": [[10, 12, 60, 70], [14, 12, 64, 70], [18, 14, 68, 72]],
           "max_score": 0.9, "start_frame": 2}]


def test_fdt_render_tracks_raises_on_a_hue_over_255(video):
    """fdt's np.uint8([[(hue, 255, 255)]]) raises under NumPy 2 for a hue of
    256 or more (about 29% of tracks); NumPy 1.x wrapped it silently."""
    path, _ = video
    rng = np.random.RandomState(_seed_drawing_hue(256))
    with pytest.raises(OverflowError):
        jax_render_tracks(str(path), TRACKS, rng=rng)


def test_port_draws_a_track_whose_hue_is_over_255(video, tmp_path):
    """The same draw: the port takes the hue modulo 256, as NumPy 1.x did, and
    draws the box in that colour; frames are counted as fdt counts them."""
    _, frames = video
    seed = _seed_drawing_hue(256)
    hue = np.random.RandomState(seed).randint(0, 360)
    n = render_tracks(iter(frames), TRACKS, out_dir=str(tmp_path), dis_width=SIZE,
                      rng=np.random.RandomState(seed))
    assert n == FRAMES and len(list(tmp_path.glob("*.png"))) == FRAMES
    colour = _track_colour(hue % 256)
    x1, y1, x2, _ = TRACKS[0]["bboxes"][1]
    drawn = cv2.imread(str(tmp_path / "000003.png"))  # frame 3: the track's 2nd box
    row = drawn[int(y1 * SIZE / 480), int(x1 * SIZE / 640):int(x2 * SIZE / 640) + 1]
    assert (row == colour).all(axis=1).any()
    # fdt counts the same frames where the hue stays under 256 (seed 0 draws 172)
    low = 0
    assert np.random.RandomState(low).randint(0, 360) < 256
    assert (jax_render_tracks(str(video[0]), TRACKS, dis_width=SIZE,
                              rng=np.random.RandomState(low)) == n)


def test_render_tracks_refuses_display_without_a_server(video, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises(RuntimeError, match="display server"):
        render_tracks(iter(video[1]), TRACKS, display=True)


def test_render_tracks_shows_each_frame_where_a_display_is_named(video, monkeypatch):
    """display=True with a display server named: each rendered frame goes to
    the window (matplotlib, here its Agg backend) until Esc closes it."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from fdt_torch.apps import video as video_app

    monkeypatch.setenv("DISPLAY", ":0")
    shown = []
    monkeypatch.setattr(plt, "pause", lambda s: shown.append(s))
    windows = []
    window_cls = video_app.FrameWindow

    class Kept(window_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            windows.append(self)

        def show(self, frame):
            if len(shown) == 3:  # Esc after the third frame

                class Esc:
                    key = "escape"
                self._key(Esc())
            return super().show(frame)

    monkeypatch.setattr(video_app, "FrameWindow", Kept)
    n = render_tracks(iter(video[1]), TRACKS, dis_width=SIZE, display=True,
                      rng=np.random.RandomState(0))
    assert n == 4 and len(shown) == 4 and windows[0].image is not None


# --- frames -------------------------------------------------------------------------------

def test_read_frames_equals_cv2_imread_in_name_order(tmp_path):
    rng = np.random.RandomState(1)
    names = ["b_002.png", "a_001.jpg", "c_010.png", "c_003.bmp"]
    for name in names:
        cv2.imwrite(str(tmp_path / name), rng.randint(0, 256, (20, 30, 3), dtype=np.uint8))
    (tmp_path / "tracks.npy").write_bytes(b"not a frame")
    got = list(read_frames(tmp_path))
    want = [cv2.imread(str(tmp_path / n)) for n in sorted(names)]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("source", ["video", "camera", "camera-str"])
def test_read_frames_refuses_a_video_file_or_camera(video, source):
    arg = {"video": video[0], "camera": 0, "camera-str": "0"}[source]
    with pytest.raises(ValueError, match="no video decoder"):
        read_frames(arg)


# --- the demos and CLIs -------------------------------------------------------------------

def _mtcnn(kind):
    from fdt_torch.infer import FAST_BUDGETS, MTCNNDetector, MTCNNDeviceCascade
    from fdt_torch.models import load_mtcnn_nets
    nets = load_mtcnn_nets(*chip_smoke.mtcnn_variables("host"))
    if kind == "host":
        return MTCNNDetector(*nets, device="cpu")
    return MTCNNDeviceCascade(*nets, budgets=FAST_BUDGETS, device="cpu")


@pytest.mark.parametrize("family", ["pyramid", "facebox", "mtcnn-host", "mtcnn-device"])
def test_demo_rows_equal_direct_calls(family, tmp_path):
    """run_video through each family's demo on 2 frames at 160×120: each
    frame's rows (recorded from the detector) equal a direct call on the
    fitted frame, an overlaid PNG is written a frame, the fps is positive."""
    from fdt_torch.apps import video as video_app
    from fdt_torch.infer import FaceBoxDetector
    from fdt_torch.models import FaceBox, from_jax_variables

    rng = np.random.RandomState(2)
    frames = [rng.randint(0, 256, (120, 160, 3), dtype=np.uint8) for _ in range(2)]
    calls = []
    if family == "pyramid":
        det = load_pyramidbox_detector("try3", TRY3, device="cpu")
        demo, direct = video_app.pyramidbox_demo, lambda f: det.detect_face(f, 0.05, 1.0, 0.35)
        kw = dict(threshold=0.05)
        method = "detect_face"
    elif family == "facebox":
        model = FaceBox()
        model.load_state_dict(from_jax_variables(chip_smoke.seeded_variables(model, 0)),
                              strict=True)
        det = FaceBoxDetector(model, device="cpu")
        demo, direct, kw, method = video_app.facebox_demo, det.detect, {}, "detect"
    else:
        det = _mtcnn(family.split("-")[1])
        demo, direct, kw, method = video_app.mtcnn_demo, det.detect_face, {}, "detect_face"
    call = getattr(det, method)

    def recorded(frame, *a, **k):
        out = call(frame, *a, **k)
        calls.append((frame.copy(), out))
        return out

    setattr(det, method, recorded)
    fps = demo(det, frames=iter(frames), frame_size=(160, 120), out_dir=str(tmp_path), **kw)
    assert fps > 0 and len(calls) == 2 and len(list(tmp_path.glob("*.png"))) == 2
    setattr(det, method, call)
    for (frame, out), f in zip(calls, frames):
        np.testing.assert_array_equal(frame, f)
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        direct(frame) if isinstance(out, tuple) else (direct(frame),)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["track_video", "track_display", "video_demo"])
def test_cli_help(name):
    r = subprocess.run([sys.executable, "-m", f"fdt_torch.cli.{name}", "--help"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "usage" in r.stdout, r.stderr[-2000:]


def test_track_and_display_clis_on_a_frame_directory(video, tmp_path, capsys):
    """track_video writes the .npy of save_tracks beside the frame directory;
    track_display renders the frames with those tracks into PNGs."""
    from fdt_torch.cli import track_display
    from fdt_torch.cli import track_video as track_video_cli
    from fdt_torch.track import load_tracks

    clip = tmp_path / "clip"
    clip.mkdir()
    for i, f in enumerate(video[1][:3]):
        cv2.imwrite(str(clip / f"{i:06d}.png"), f)
    track_video_cli.main([str(clip) + "/", "--net", "try3", "--weights", TRY3,
                          "--batch", "3", "--device", "cpu"])
    assert "tracks saved to" in capsys.readouterr().out
    tracks = load_tracks(str(tmp_path / "clip.npy"))
    assert isinstance(tracks, list)
    track_display.main([str(clip), "--out", str(tmp_path / "shown")])
    assert "rendered 3 frames" in capsys.readouterr().out
    assert len(list((tmp_path / "shown").glob("*.png"))) == 3
