"""fdt_torch PyramidBoxDetector and DetectionService against fdt's.

The detector parity runs a depth-cut model (one bottleneck per stage) with the
first block of every stage of net_weight/repo_mini.npz, so the scores have a
trained model's spread; the same variables go to both packages.

The flagship golden that chip_smoke.py checks on the card is written by

    python tests/test_torch_detector.py --write-golden

(the JAX detector, full depth, float32 precision "highest", on the CPU), and
re-made and compared by the slow test below.
"""
import argparse
import hashlib
import pathlib
import sys
import threading

import jax
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.infer.pyramidbox import PyramidBoxDetector as JaxDetector  # noqa: E402
from fdt.infer.pyramidbox import detections_to_rows as jax_rows  # noqa: E402
from fdt.models.pyramidbox import PyramidBox as JaxPyramidBox  # noqa: E402
from fdt_torch.apps.serving import DetectionService, resize_bilinear  # noqa: E402
from fdt_torch.infer import PyramidBoxDetector, detections_to_rows  # noqa: E402
from fdt_torch.models import PyramidBox, from_jax_variables, load_npz  # noqa: E402

torch.set_num_threads(1)

WEIGHTS = REPO / "net_weight" / "repo_mini.npz"
GOLDEN_SIZE = (640, 640)  # (height, width): the main path's frame size
GOLDEN_SEED = 0
GOLDEN_CONF, GOLDEN_NMS = 0.01, 0.35
GOLDEN_KEEP_ROWS = 200
CUT = (1, 1, 1, 1)


def _first_blocks(variables):
    """Keep block 0 of every ResNet stage: the variables of PyramidBox(CUT)."""
    return {col: {k: ({"0": v["0"]} if k in ("layer1", "layer2", "layer3", "layer4") else v)
                  for k, v in tree.items()}
            for col, tree in variables.items()}


@pytest.fixture(scope="module")
def cut_variables():
    return _first_blocks(load_npz(str(WEIGHTS)))


@pytest.fixture(scope="module")
def port_detector(cut_variables):
    model = PyramidBox(CUT)
    model.load_state_dict(from_jax_variables(cut_variables), strict=True)
    return PyramidBoxDetector(model, device="cpu")


@pytest.fixture(scope="module")
def jax_detector(cut_variables):
    return JaxDetector(cut_variables, JaxPyramidBox(num_blocks=CUT), "repo",
                       precision="highest")


@pytest.mark.parametrize("height,width", [(128, 128), (150, 130)])
def test_detect_tensor_matches_fdt(port_detector, jax_detector, height, width):
    """Equal counts per class; rows within 1e-5 absolute: float32 on both
    sides, convolutions summed in another order (XLA:CPU against torch's CPU
    kernels) move scores and normalized boxes by ~1e-6."""
    images = np.random.RandomState(height).randint(0, 256, (2, height, width, 3),
                                                   dtype=np.uint8)
    ours = port_detector.detect_tensor(images, conf_thresh=0.05, nms_thresh=0.35)
    theirs = jax_detector.detect_tensor(images, conf_thresh=0.05, nms_thresh=0.35)
    assert ours.shape == theirs.shape == (2, 2, 750, 5)
    counts = (ours[..., 0] > 0).sum(-1)
    np.testing.assert_array_equal(counts, (theirs[..., 0] > 0).sum(-1))
    assert counts[:, 1].min() > 50
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    for i in range(2):
        for thr in (0.0, 0.2, 0.99):  # walks zero rows / a prefix / the sentinel
            scale = [width, height, width, height]
            np.testing.assert_allclose(detections_to_rows(ours[i], thr, scale),
                                       jax_rows(theirs[i], thr, scale),
                                       rtol=0, atol=1e-5 * max(height, width))


def test_detections_to_rows_walk_semantics():
    det = np.zeros((2, 4, 5), np.float32)
    det[1, 0] = [0.9, 0.1, 0.1, 0.2, 0.2]
    det[1, 1] = [0.5, 0.3, 0.3, 0.4, 0.4]
    for thr in (0.4, 0.0, 0.95):
        np.testing.assert_array_equal(detections_to_rows(det, thr, [100] * 4),
                                      jax_rows(det, thr, [100] * 4))
    np.testing.assert_allclose(detections_to_rows(det, 0.95, [100] * 4), [[0, 0, 0, 0, 0.4]])


def test_detector_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        PyramidBoxDetector(PyramidBox(CUT))


@pytest.fixture(scope="module")
def service(port_detector):
    svc = DetectionService("pyramidbox", port_detector, frame_size=(128, 96),
                           threshold=0.3, nms_thresh=0.35, max_batch=4, max_wait_ms=50)
    yield svc
    svc.close()


def _direct_rows(det, frame, w, h, threshold=0.3):
    r = detections_to_rows(det.detect_tensor(frame[None], threshold, 0.35)[0],
                           threshold, [w, h, w, h])
    return np.empty((0, 5), np.float32) if not r[:, :4].any() else r.astype(np.float32)


def test_service_answers_concurrent_requests(service, port_detector):
    rng = np.random.RandomState(3)
    sizes = [(96, 128), (96, 128), (120, 160), (60, 90)]  # (h, w); two need a resize
    images = [rng.randint(0, 256, (*sizes[i % 4], 3), dtype=np.uint8) for i in range(8)]
    results, errors = {}, []

    def client(ids):
        for i in ids:
            try:
                results[i] = service.detect(images[i])
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

    threads = [threading.Thread(target=client, args=(range(k, 8, 4),)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and len(results) == 8
    assert not any(t.is_alive() for t in threads)
    assert service.stats()["requests"] >= 8
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        frame = im if (h, w) == (96, 128) else resize_bilinear(im, 128, 96)
        want = _direct_rows(port_detector, frame, w, h)
        assert results[i].shape == want.shape and len(want) > 0
        # the batch a request rides in must not change its answer beyond
        # float32 summation order (the other requests of its batch)
        np.testing.assert_allclose(results[i], want, rtol=0, atol=1e-4)


def test_service_close_leaves_no_live_thread(port_detector):
    before = {t.ident for t in threading.enumerate()}
    svc = DetectionService("pyramidbox", port_detector, frame_size=(64, 64),
                           max_batch=2, max_wait_ms=1)
    worker = svc.batcher._worker
    assert worker.daemon and worker.is_alive()
    svc.detect(np.zeros((64, 64, 3), np.uint8))
    svc.close()
    assert not worker.is_alive()
    assert {t.ident for t in threading.enumerate() if t.is_alive()} <= before
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(np.zeros((64, 64, 3), np.uint8))


def test_service_rejects_other_families_and_bad_input(port_detector):
    with pytest.raises(ValueError, match="family"):
        DetectionService("scrfd", port_detector)
    with DetectionService("pyramidbox", port_detector, frame_size=(64, 64)) as svc:
        with pytest.raises(ValueError, match="HxWx3"):
            svc.submit(np.zeros((64, 64), np.uint8))


@pytest.mark.parametrize("src,dst", [((37, 53), (96, 128)), ((480, 640), (96, 128))],
                         ids=["upscale", "downscale"])
def test_resize_within_one_lsb_of_cv2(src, dst):
    cv2 = pytest.importorskip("cv2")
    im = np.random.RandomState(4).randint(0, 256, (*src, 3), dtype=np.uint8)
    ours = resize_bilinear(im, dst[1], dst[0])
    theirs = cv2.resize(im, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    assert ours.shape == theirs.shape
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1


def make_golden() -> dict:
    """The JAX detector's float32 rows for the seeded golden frame."""
    from fdt.models.loader import load_variables
    h, w = GOLDEN_SIZE
    frame = chip_smoke.golden_frame(GOLDEN_SEED, h, w)
    model = JaxPyramidBox()
    det = JaxDetector(load_variables(model, str(WEIGHTS), w), model, "repo",
                      precision="highest")
    out = det.detect_tensor(frame[None], conf_thresh=GOLDEN_CONF, nms_thresh=GOLDEN_NMS)[0, 1]
    return {"rows": out[:GOLDEN_KEEP_ROWS].astype(np.float32),
            "count": np.int64((out[:, 0] > 0).sum()), "seed": np.int64(GOLDEN_SEED),
            "height": np.int64(h), "width": np.int64(w),
            "conf_thresh": np.float64(GOLDEN_CONF), "nms_thresh": np.float64(GOLDEN_NMS),
            "frame_sha256": np.str_(hashlib.sha256(frame.tobytes()).hexdigest())}


def test_golden_file_is_consistent():
    g = np.load(chip_smoke.GOLDEN)
    assert chip_smoke.GOLDEN.stat().st_size < 100_000
    h, w = int(g["height"]), int(g["width"])
    frame = chip_smoke.golden_frame(int(g["seed"]), h, w)
    assert hashlib.sha256(frame.tobytes()).hexdigest() == str(g["frame_sha256"])
    assert int(g["count"]) >= chip_smoke.GOLDEN_ROWS
    assert np.all(np.diff(g["rows"][:, 0]) <= 0) and g["rows"][chip_smoke.GOLDEN_ROWS - 1, 0] > 0


def test_mask_err_reads_only_the_contract_prefix():
    """chip_smoke's K1 check: with out_k only the first out_k keeps of each
    problem (and any keep the plain mask drops) count."""
    want = torch.tensor([[1, 0, 1, 0, 1, 1], [0, 1, 1, 0, 0, 0]], dtype=torch.bool)
    assert chip_smoke._mask_err(want.clone(), want, None) == 0.0
    late = want.clone()
    late[0, 5] = False  # the 4th keep of problem 0: past out_k = 3
    assert chip_smoke._mask_err(late, want, 3) == 0.0
    assert chip_smoke._mask_err(late, want, None) == 1.0
    early = want.clone()
    early[1, 2] = False  # the 2nd keep of problem 1
    assert chip_smoke._mask_err(early, want, 3) == 1.0
    extra = want.clone()
    extra[0, 3] = True  # a keep the plain mask drops, past the prefix
    assert chip_smoke._mask_err(extra, want, 2) == 1.0


@pytest.mark.slow
def test_flagship_golden_matches_jax_and_port():
    """Re-make the golden with the JAX detector (full depth) and hold it and
    the port's CPU float32 output against the committed file."""
    g = dict(np.load(chip_smoke.GOLDEN))
    fresh = make_golden()
    np.testing.assert_array_equal(fresh["rows"], g["rows"])
    model = PyramidBox()
    model.load_state_dict(from_jax_variables(load_npz(str(WEIGHTS))), strict=True)
    det = PyramidBoxDetector(model, device="cpu")
    frame = chip_smoke.golden_frame(int(g["seed"]), int(g["height"]), int(g["width"]))
    ours = det.detect_tensor(frame[None], float(g["conf_thresh"]), float(g["nms_thresh"]))[0, 1]
    chip_smoke.match_rows(ours, g["rows"], chip_smoke.GOLDEN_ROWS, chip_smoke.GOLDEN_TOL)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the flagship golden for chip_smoke.py")
    ap.add_argument("--write-golden", action="store_true", required=True)
    ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    golden = make_golden()
    chip_smoke.GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(chip_smoke.GOLDEN, **golden)
    print(f"wrote {chip_smoke.GOLDEN.relative_to(REPO)}: {int(golden['count'])} rows, "
          f"top score {golden['rows'][0, 0]:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
