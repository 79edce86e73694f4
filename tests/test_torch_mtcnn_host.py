"""fdt_torch.infer.mtcnn, MTCNN's host cascade, against fdt's
(fdt/infer/mtcnn.py) on the CPU.

Weights are chip_smoke.mtcnn_variables("host"): the sparse seeded nets with
their crop-placing regressions scaled down, because the reference's host
cascade raises on the inverted crops the unscaled seeded nets make (pinned
below for both packages).  The comparison has two levels:

  * cv2's resizes patched into the port (`resize_level`, `resize_crop`): the
    logic must then equal fdt's, stage by stage and for detect_face, counts
    and keep sets equal, boxes and landmarks within 1e-3 px, scores within
    1e-5, where no score of fdt's lies within 4× the nets' measured output
    difference of its threshold (the guard; measured 1.2e-7 here);
  * the port's own resizes, within 1 LSB of cv2's: held to fdt's own bound
    between its host and device cascades (tests/test_mtcnn_device.py:89-93):
    counts equal, boxes within 2 px, scores within 2e-2, landmarks within
    2 px, against fdt's host cascade and the port's device cascade.

The 480×640 golden that chip_smoke.py holds the card to is written by

    python tests/test_torch_mtcnn_host.py --write-golden

(fdt's host cascade, float32 precision "highest", on the CPU), and re-made
and compared by the slow test below.  On those frames fdt's own host and
device cascades differ by one detection (19 against 18 on the first frame),
so the golden bound allows chip_smoke.MTCNN_HOST_COUNT_DIFF unmatched rows.
"""
import argparse
import functools
import hashlib
import pathlib
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import fdt.infer.mtcnn as jm  # noqa: E402
import fdt.infer.mtcnn_device as jmd  # noqa: E402
from fdt.models.mtcnn import ONet as JaxONet  # noqa: E402
from fdt.models.mtcnn import PNet as JaxPNet  # noqa: E402
from fdt.models.mtcnn import RNet as JaxRNet  # noqa: E402
from fdt_torch.infer import mtcnn as pm  # noqa: E402
from fdt_torch.infer import mtcnn_device as md  # noqa: E402
from fdt_torch.models import load_mtcnn_nets  # noqa: E402
from tests.test_torch_seeded import nest_like  # noqa: E402

torch.set_num_threads(1)

CASES = ((96, 128, 0), (120, 160, 1))  # height, width, frame seed
SCORE_TOL, PX_TOL = 1e-5, 1e-3          # with cv2's resizes: scores, pixels
GUARD = 4                               # × the nets' measured output difference
HOST_TOL = dict(score_tol=chip_smoke.MTCNN_HOST_SCORE_TOL, px_tol=chip_smoke.MTCNN_HOST_PX_TOL)


@functools.lru_cache(maxsize=None)
def flat_variables(setting: str = "host") -> tuple:
    return chip_smoke.mtcnn_variables(setting)


@functools.lru_cache(maxsize=None)
def fdt_variables(setting: str = "host") -> tuple:
    return tuple(nest_like(v, m, s) for v, m, s in
                 zip(flat_variables(setting), (JaxPNet(), JaxRNet(), JaxONet()), (12, 24, 48)))


@functools.lru_cache(maxsize=None)
def fdt_host(setting: str = "host"):
    return jm.MTCNNDetector(*fdt_variables(setting), precision="highest")


def port_host(setting: str = "host"):
    return pm.MTCNNDetector(*load_mtcnn_nets(*flat_variables(setting)), device="cpu")


def _cv2_level(image, scale):
    return cv2.resize(image, None, fx=scale, fy=scale, interpolation=cv2.INTER_LINEAR)


def _cv2_crop(crop, size):
    return cv2.resize(crop, (size, size))


@pytest.fixture
def cv2_resizes(monkeypatch):
    monkeypatch.setattr(pm, "resize_level", _cv2_level)
    monkeypatch.setattr(pm, "resize_crop", _cv2_crop)


# --- the helpers -------------------------------------------------------------------------

def _score_map(rng, h=9, w=11):
    return rng.rand(h, w).astype(np.float32), rng.randn(h, w, 4).astype(np.float32)


def _boxes(rng, n=40, extent=60.0):
    """[n, 5] float64 boxes, some past the image's edges, with scores."""
    xy = rng.uniform(-15, extent, (n, 2))
    wh = rng.uniform(1, 40, (n, 2))
    return np.column_stack([xy, xy + wh, rng.rand(n)])


def test_generate_bounding_box_bit_equal():
    rng = np.random.RandomState(0)
    for scale, thr in ((1.0, 0.6), (0.709, 0.3), (0.25, 0.95), (0.5, 1.1)):
        score_map, reg = _score_map(rng)
        got = pm.generate_bounding_box(score_map, reg, scale, thr)
        want = jm.generate_bounding_box(score_map, reg, scale, thr)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_square_bbox_bit_equal():
    boxes = _boxes(np.random.RandomState(1))
    got = pm.square_bbox(boxes)
    np.testing.assert_array_equal(got, jm.square_bbox(boxes))
    assert got is not boxes and not np.shares_memory(got, boxes)


def test_pad_clamp_bit_equal_and_clamps_in_place():
    """The reference writes the clamp through numpy views: dets[:, :4] come
    back clamped to the image, and detect_rnet returns those boxes."""
    boxes = np.round(jm.square_bbox(_boxes(np.random.RandomState(2))))
    ours, theirs = boxes.copy(), boxes.copy()
    got, want = pm.pad_clamp(ours, 50, 40), jm.pad_clamp(theirs, 50, 40)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ours, theirs)
    assert not np.array_equal(ours, boxes)  # the clamp happened in place
    assert ours[:, [0, 1]].min() >= 0 and ours[:, 2].max() <= 49 and ours[:, 3].max() <= 39


def test_apply_regression_bit_equal():
    rng = np.random.RandomState(3)
    boxes = _boxes(rng)
    reg = rng.randn(len(boxes), 4).astype(np.float32)
    np.testing.assert_array_equal(pm._apply_regression(boxes[:, :4], reg, boxes[:, 4]),
                                  jm._apply_regression(boxes[:, :4], reg, boxes[:, 4]))


@pytest.mark.parametrize("which", ["level", "crop"])
def test_resizes_within_one_lsb_of_cv2(which):
    rng = np.random.RandomState(4)
    for h, w in ((120, 160), (37, 23), (9, 14)):
        image = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        for arg in ((1.0, 0.709, 0.5027, 0.1) if which == "level" else (12, 24, 48)):
            ours = (pm.resize_level if which == "level" else pm.resize_crop)(image, arg)
            theirs = (_cv2_level if which == "level" else _cv2_crop)(image, arg)
            assert ours.dtype == np.uint8 and ours.shape == theirs.shape
            assert np.abs(ours.astype(int) - theirs).max() <= 1


# --- level 1: cv2's resizes patched in ---------------------------------------------------

def _net_diff_and_guard(fdt, port, image, dets_list) -> float:
    """The largest difference between fdt's and the port's nets on the same
    inputs (every PNet level of cv2's pyramid, the RNet and ONet crops of each
    candidate list of `dets_list`), and the guard: no probability of fdt's
    within GUARD × that difference of its stage's threshold."""
    cfg = fdt.cfg
    diff, scores = 0.0, [[], [], []]
    scale = 12 / cfg.min_face_size
    level = _cv2_level(image, scale)
    while min(level.shape[:2]) > 12:
        ours, theirs = port._run_pnet_level(level), fdt._run_pnet_level(level)
        diff = max(diff, *(float(np.abs(a - b).max()) for a, b in zip(ours, theirs)))
        scores[0].append(theirs[0].ravel())
        scale *= cfg.scale_factor
        level = _cv2_level(image, scale)
    for dets in dets_list:
        if dets is None:
            continue
        for stage, (size, net, fwd, name) in enumerate(((24, port.rnet, fdt._rnet_fwd, "rnet"),
                                                        (48, port.onet, fdt._onet_fwd, "onet"))):
            sq = jm.square_bbox(dets)
            sq[:, :4] = np.round(sq[:, :4])
            crops = fdt._crop_batch(image, sq, size)
            ours = port._forward(net, crops)
            theirs = fdt._batched_fwd(fwd, fdt.vars[name], crops)
            diff = max(diff, *(float(np.abs(a - b).max()) for a, b in zip(ours, theirs)))
            scores[stage + 1].append(theirs[0].ravel())
    assert 0 < diff < 1e-5, diff  # float32 sums in another order
    for thr, s in zip(cfg.thresholds, scores):
        if s:
            s = np.concatenate(s)
            assert not (np.abs(s - thr) <= GUARD * diff).any(), (
                f"a score lies within {GUARD}x{diff:.3g} of the threshold {thr}")
    return diff


def assert_same(got, want):
    """Two results of a stage, (boxes [N, 5], landmarks or the regressed
    boxes): counts equal, boxes within PX_TOL, scores within SCORE_TOL, the
    second arrays within PX_TOL (their score column too)."""
    (gb, gl), (wb, wl) = got, want
    if wb is None:
        assert gb is None and gl is None
        return
    assert gb.shape == wb.shape and gl.shape == wl.shape
    if not wb.size:
        return
    np.testing.assert_allclose(gb[:, :4], wb[:, :4], rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(gb[:, 4], wb[:, 4], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(gl, wl, rtol=0, atol=PX_TOL)


@pytest.mark.parametrize("stage", ["pnet", "rnet", "onet", "face"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_stage_equals_fdt_with_cv2_resizes(cv2_resizes, case, stage):
    """Each stage on fdt's own input: detect_pnet on the frame, detect_rnet
    and detect_onet both on fdt's PNet candidates (so that ONet sees a few
    dozen crops at these sizes; fdt's RNet passes 0-2), and detect_face."""
    h, w, seed = case
    image = chip_smoke.golden_frame(seed, h, w)
    fdt, port = fdt_host(), port_host()
    _, p_align = fdt.detect_pnet(image)
    assert p_align is not None and len(p_align) > 10
    _net_diff_and_guard(fdt, port, image, [p_align])
    if stage == "pnet":
        got, want = port.detect_pnet(image), fdt.detect_pnet(image)
    elif stage == "face":
        got, want = port.detect_face(image), fdt.detect_face(image)
    else:
        run = "detect_rnet" if stage == "rnet" else "detect_onet"
        got, want = (getattr(d, run)(image, p_align.copy()) for d in (port, fdt))
    assert_same(got, want)
    if stage == "onet":
        assert want[0] is not None and len(want[0]) > 0


# --- level 2: the port's own resizes -----------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_own_resizes_within_fdts_host_to_device_bound(case):
    """detect_face with the port's resizes against fdt's host cascade, and
    against the port's device cascade (full budgets) on the same frame:
    counts equal, 2 px, 2e-2, 2 px; and each stage's candidates."""
    h, w, seed = case
    image = chip_smoke.golden_frame(seed, h, w)
    fdt, port = fdt_host(), port_host()
    device = md.MTCNNDeviceCascade(*load_mtcnn_nets(*flat_variables()), device="cpu")
    got = port.detect_face(image)
    for want in (fdt.detect_face(image), device.detect_face(image)):
        assert got[0].shape == want[0].shape
        if want[0].size:
            chip_smoke.match_detections(*got, *want, **HOST_TOL)
    _, p_align = fdt.detect_pnet(image)
    for run in ("detect_rnet", "detect_onet"):
        (gb, gl), (wb, wl) = (getattr(d, run)(image, p_align.copy()) for d in (port, fdt))
        assert (gb is None) == (wb is None)
        if wb is not None:
            chip_smoke.match_unordered(gb, gl, wb, wl, **HOST_TOL)


# --- what the reference does with the unscaled seeded nets -------------------------------

def test_inverted_crops_raise_as_in_fdt():
    """The sparse seeded nets regress PNet's candidates into inverted squares
    (chip_smoke's note on MTCNN_HOST_REG): both host cascades raise the same
    ValueError on the first crop of negative size, while the device cascade,
    which samples a window of any size, answers."""
    image = chip_smoke.golden_frame(0, 96, 128)
    with pytest.raises(ValueError, match="negative dimensions"):
        fdt_host("sparse").detect_face(image)
    with pytest.raises(ValueError, match="negative dimensions"):
        port_host("sparse").detect_face(image)
    device = md.MTCNNDeviceCascade(*load_mtcnn_nets(*flat_variables("sparse")), device="cpu")
    assert isinstance(device.detect_face(image)[0], np.ndarray)


# --- construction -----------------------------------------------------------------------

def test_npz_detector_loads_strict_and_defaults_to_the_card(tmp_path):
    from fdt.models.loader import save_variables_npz
    paths = []
    for name, variables in zip(("p", "r", "o"), fdt_variables()):
        paths.append(str(tmp_path / f"{name}net.npz"))
        save_variables_npz(variables, paths[-1])
    det = pm.load_mtcnn_detector(*paths, device="cpu", precision="default")
    slope = fdt_variables()[1]["params"]["prelu4"]["negative_slope"]
    assert det.rnet.prelu4.weight.item() == float(np.float16(slope))
    assert det.device.type == "cpu" and det.precision == "default"
    nets = load_mtcnn_nets(*flat_variables())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pm.MTCNNDetector(*nets)
    with pytest.raises(ValueError, match="precision"):
        pm.MTCNNDetector(*nets, precision="high", device="cpu")


def test_empty_result_is_two_empty_arrays_like_fdt():
    image = np.zeros((40, 50, 3), np.uint8)
    got, want = port_host().detect_face(image), fdt_host().detect_face(image)
    assert [a.shape for a in got] == [a.shape for a in want] == [(0,), (0,)]


# --- the golden --------------------------------------------------------------------------

def make_golden() -> dict:
    """fdt's host cascade (cv2's resizes, float32 "highest") on the sparse
    golden's two 480×640 frames, with the "host" nets."""
    h, w = chip_smoke.MTCNN_H, chip_smoke.MTCNN_W
    images = [chip_smoke.golden_frame(s, h, w) for s in chip_smoke.MTCNN_FRAME_SEEDS]
    out = [fdt_host().detect_face(im) for im in images]
    counts = np.array([len(b) for b, _ in out], np.int64)
    n = int(counts.max())
    boxes = np.zeros((len(images), n, 5))
    lms = np.zeros((len(images), n, 10))
    for i, (b, lm) in enumerate(out):
        boxes[i, :len(b)], lms[i, :len(b)] = b, lm
    return {"boxes": boxes, "landmarks": lms, "counts": counts,
            "frame_seeds": np.array(chip_smoke.MTCNN_FRAME_SEEDS),
            "weights_seed": np.int64(chip_smoke.MTCNN_WEIGHTS_SEED),
            "reg_scale": np.float32(chip_smoke.MTCNN_HOST_REG_SCALE),
            "height": np.int64(h), "width": np.int64(w),
            "frame_sha256": np.str_(hashlib.sha256(np.stack(images).tobytes()).hexdigest())}


def test_host_golden_file_is_consistent():
    g = np.load(chip_smoke.MTCNN_HOST_GOLDEN)
    assert chip_smoke.MTCNN_HOST_GOLDEN.stat().st_size < 20_000
    h, w = int(g["height"]), int(g["width"])
    assert (h, w) == (chip_smoke.MTCNN_H, chip_smoke.MTCNN_W)
    images = np.stack([chip_smoke.golden_frame(int(s), h, w) for s in g["frame_seeds"]])
    assert hashlib.sha256(images.tobytes()).hexdigest() == str(g["frame_sha256"])
    assert int(g["weights_seed"]) == chip_smoke.MTCNN_WEIGHTS_SEED
    assert float(g["reg_scale"]) == float(np.float32(chip_smoke.MTCNN_HOST_REG_SCALE))
    assert (g["counts"] > 10).all()
    for b, c in zip(g["boxes"], g["counts"]):
        assert (b[:c, 4] > jmd.MTCNN.thresholds[2]).all()


@pytest.mark.slow
def test_host_golden_matches_fdt_and_port():
    """Re-make the 480×640 golden with fdt's host cascade, and hold the port's
    host cascade to it: equal with cv2's resizes, within the golden bound
    with its own."""
    g = dict(np.load(chip_smoke.MTCNN_HOST_GOLDEN))
    fresh = make_golden()
    for key in ("boxes", "landmarks", "counts"):
        np.testing.assert_array_equal(fresh[key], g[key])
    port = port_host()
    for i, seed in enumerate(g["frame_seeds"]):
        image = chip_smoke.golden_frame(int(seed), int(g["height"]), int(g["width"]))
        c = int(g["counts"][i])
        chip_smoke.match_unordered(*port.detect_face(image), g["boxes"][i, :c],
                                   g["landmarks"][i, :c], **HOST_TOL,
                                   unmatched=chip_smoke.MTCNN_HOST_COUNT_DIFF)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pm, "resize_level", _cv2_level)
            mp.setattr(pm, "resize_crop", _cv2_crop)
            boxes, lms = port.detect_face(image)
        assert len(boxes) == c
        np.testing.assert_allclose(boxes, g["boxes"][i, :c], rtol=0, atol=PX_TOL)
        np.testing.assert_allclose(lms, g["landmarks"][i, :c], rtol=0, atol=PX_TOL)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the MTCNN host-cascade golden for "
                                             "chip_smoke.py")
    ap.add_argument("--write-golden", action="store_true", required=True)
    ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    golden = make_golden()
    np.savez_compressed(chip_smoke.MTCNN_HOST_GOLDEN, **golden)
    print(f"wrote {chip_smoke.MTCNN_HOST_GOLDEN.relative_to(REPO)}: counts "
          f"{golden['counts'].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
