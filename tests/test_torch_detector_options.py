"""The port's detector options against fdt's: detections_to_rows(shrink=),
detect_face(shrink=, nms_thresh=), PyramidBoxDetector(budget=, detect_cfg=),
and the per-shape LRUs of PyramidBoxDetector (64 sizes) and
FusedVideoTracker (16), on the depth-cut flagship of
tests/test_torch_detector.py (the first block of every ResNet stage of
net_weight/repo_mini.npz) at 160² or less."""
import pathlib
import sys

import cv2
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from fdt.config import DetectConfig as JaxDetectConfig  # noqa: E402
from fdt.infer.pyramidbox import PyramidBoxDetector as JaxDetector  # noqa: E402
from fdt.infer.pyramidbox import detections_to_rows as jax_rows  # noqa: E402
from fdt.models.pyramidbox import PyramidBox as JaxPyramidBox  # noqa: E402
from fdt_torch.config import DetectConfig  # noqa: E402
from fdt_torch.infer import PyramidBoxDetector, detections_to_rows  # noqa: E402
from fdt_torch.infer.pyramidbox import shrink_image  # noqa: E402
from fdt_torch.models import PyramidBox, from_jax_variables, load_npz  # noqa: E402
from tests.test_torch_detector import CUT, _first_blocks  # noqa: E402
from fdt_torch.track import FusedVideoTracker  # noqa: E402

torch.set_num_threads(1)

WEIGHTS = REPO / "net_weight" / "repo_mini.npz"
# float32 on both sides, convolutions summed in another order: scores and
# normalized boxes within 1e-5 (tests/test_torch_detector.py)
TOL = 1e-5


@pytest.fixture(scope="module")
def cut_variables():
    return _first_blocks(load_npz(str(WEIGHTS)))


@pytest.fixture(scope="module")
def cut_model(cut_variables):
    model = PyramidBox(CUT)
    model.load_state_dict(from_jax_variables(cut_variables), strict=True)
    return model


def _port(cut_model, **kw):
    return PyramidBoxDetector(cut_model, device="cpu", **kw)


def _jax(cut_variables, **kw):
    return JaxDetector(cut_variables, JaxPyramidBox(num_blocks=CUT), "repo",
                       precision="highest", **kw)


def _frame(seed: int, h: int, w: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("shrink", [1.0, 0.5, 0.3, 1.7])
@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.99])
def test_detections_to_rows_with_shrink_bit_equal_to_fdt(shrink, threshold):
    rng = np.random.RandomState(int(shrink * 10) + int(threshold * 100))
    det = np.zeros((2, 60, 5), np.float32)
    det[1, :, 0] = np.sort(rng.rand(60).astype(np.float32))[::-1]
    det[1, :, 1:] = rng.rand(60, 4).astype(np.float32)
    scale = [131, 97, 131, 97]
    np.testing.assert_array_equal(detections_to_rows(det, threshold, scale, shrink),
                                  jax_rows(det, threshold, scale, shrink))


@pytest.mark.parametrize("fx", [0.5, 0.3, 0.75, 1.5])
@pytest.mark.parametrize("hw", [(97, 131), (64, 160)])
def test_shrink_image_sizes_equal_cv2_and_pixels_within_one_lsb(fx, hw):
    img = _frame(int(fx * 100), *hw)
    ours = shrink_image(img, fx)
    theirs = cv2.resize(img, None, None, fx=fx, fy=fx, interpolation=cv2.INTER_LINEAR)
    assert ours.shape == theirs.shape and ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1


def test_detect_face_with_shrink_matches_fdt(cut_model, cut_variables):
    """detect_face(shrink=0.5): the port's rows against fdt's detector on the
    port's shrunk pixels (cv2's differ by at most 1 LSB, tested above), walked
    with fdt's detections_to_rows(shrink=)."""
    img = _frame(5, 150, 130)
    port, jdet = _port(cut_model), _jax(cut_variables)
    for threshold, nms in ((0.05, 0.35), (0.2, 0.5)):
        ours = port.detect_face(img, threshold, shrink=0.5, nms_thresh=nms)
        small = shrink_image(img, 0.5)
        h, w = small.shape[:2]
        det = jdet.detect_tensor(small[None], conf_thresh=threshold, nms_thresh=nms)[0]
        theirs = jax_rows(det, threshold, [w, h, w, h], 0.5)
        assert ours.shape == theirs.shape and len(ours) > 10
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL * max(h, w) / 0.5)
    np.testing.assert_allclose(port.detect_face(img, 0.05),
                               jax_rows(jdet.detect_tensor(img[None], 0.05, 0.35)[0], 0.05,
                                        [130, 150, 130, 150]), rtol=0, atol=TOL * 150)


def test_budget_and_detect_cfg_change_the_answer_as_fdts(cut_model, cut_variables):
    frames = np.stack([_frame(6, 96, 128), _frame(7, 96, 128)])
    cases = [dict(budget=40), dict(budget=5000),
             dict(detect_cfg=(DetectConfig(top_k=100, conf_thresh=0.1, nms_thresh=0.45),
                              JaxDetectConfig(top_k=100, conf_thresh=0.1, nms_thresh=0.45)))]
    outs = []
    for kw in cases:
        pkw, jkw = dict(kw), dict(kw)
        if "detect_cfg" in kw:
            pkw["detect_cfg"], jkw["detect_cfg"] = kw["detect_cfg"]
        ours = _port(cut_model, **pkw).detect_tensor(frames, conf_thresh=0.02 if "budget" in kw else None)
        theirs = _jax(cut_variables, **jkw).detect_tensor(
            frames, conf_thresh=0.02 if "budget" in kw else None)
        assert ours.shape == theirs.shape
        np.testing.assert_array_equal((ours[..., 0] > 0).sum(-1), (theirs[..., 0] > 0).sum(-1))
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL)
        outs.append(ours)
    assert (outs[0][:, 1, :, 0] > 0).sum() < (outs[1][:, 1, :, 0] > 0).sum()  # budget bites
    assert outs[2].shape == (2, 2, 100, 5)


def test_loader_passes_budget_and_detect_cfg_through():
    from fdt_torch.models import load_pyramidbox_detector
    cfg = DetectConfig(top_k=10)
    det = load_pyramidbox_detector("try3", None, budget=123, detect_cfg=cfg, device="cpu")
    assert det.budget == 123 and det.detect_cfg is cfg
    assert det.detect_tensor(np.zeros((1, 64, 64, 3), np.uint8)).shape == (1, 2, 10, 5)


def test_priors_lru_holds_its_bound_and_answers_survive_eviction(cut_model):
    det = _port(cut_model)
    assert det._priors_max == 64  # fdt's _jitted_max
    det._priors_max = 3
    sizes = [(64, 64), (64, 96), (96, 64), (80, 80), (64, 128)]  # (h, w)
    first = {hw: det.detect_tensor(_frame(hw[0] + hw[1], *hw)[None], 0.05) for hw in sizes}
    assert len(det._priors) <= 3 and len(det.source_shapes) <= 3
    assert (64, 64) not in det._priors  # the first size was evicted
    for hw in sizes:  # every size again, evicted or not
        np.testing.assert_array_equal(det.detect_tensor(_frame(hw[0] + hw[1], *hw)[None], 0.05),
                                      first[hw])
        assert len(det._priors) <= 3
    assert list(det._priors)[-1] == (128, 64)  # (width, height), most recent last
    det._priors_max = 1  # a lowered bound applies at the next call
    det.detect_tensor(_frame(0, 64, 64)[None])
    assert list(det.source_shapes) == [(64, 64)]


def test_fused_tracker_scales_lru_holds_its_bound(cut_model):
    det = _port(cut_model)
    tracker = FusedVideoTracker(det, det_cap=8)
    assert tracker._scales_max == 16  # fdt's _fused_max
    rng = np.random.RandomState(8)
    fake = torch.from_numpy(rng.rand(2, 2, det.detect_cfg.top_k, 5).astype(np.float32))
    fake[:, :, :, 0] = torch.sort(fake[:, :, :, 0], dim=-1, descending=True).values
    slots = tracker.slots
    want = tracker._post(fake, slots, 100, 60)[1]
    for w in range(101, 120):
        tracker._post(fake, slots, w, 60)
    assert len(tracker._scales) == 16 and (100, 60) not in tracker._scales
    torch.testing.assert_close(tracker._post(fake, slots, 100, 60)[1], want, rtol=0, atol=0)
    assert len(tracker._scales) == 16


def test_fused_tracker_reads_detect_cfg(cut_model):
    det = _port(cut_model, detect_cfg=DetectConfig(top_k=20, conf_thresh=0.15, nms_thresh=0.4))
    tracker = FusedVideoTracker(det)
    assert (tracker.det_cap, tracker.conf_thresh, tracker.nms_thresh) == (20, 0.15, 0.4)
    with pytest.raises(ValueError, match="det_cap"):
        FusedVideoTracker(det, det_cap=21)
