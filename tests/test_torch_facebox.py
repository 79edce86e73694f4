"""fdt_torch's FaceBoxes (default boxes, blocks, model, detector, serving)
against fdt's, on weights made from a numpy seed by chip_smoke.seeded_variables
(faceboxes.pt is not in the repo).  The same variables go to fdt (nested into
its flax tree by tests/test_torch_seeded.py) and, through from_jax_variables,
to the port.

The core tier runs the model at 128², where a FaceBoxConfig of input size
128 (maps 4/2/1) gives a consistent small detector on both sides.  The
1024² golden that chip_smoke.py checks on the card is written by

    python tests/test_torch_facebox.py --write-golden

(fdt's FaceBoxDetector, float32 precision "highest", on the CPU), and
re-made and compared by the slow test below.
"""
import argparse
import hashlib
import pathlib
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.anchors import facebox_default_boxes as jax_default_boxes  # noqa: E402
from fdt.config import FaceBoxConfig as JaxFaceBoxConfig  # noqa: E402
from fdt.infer.facebox import FaceBoxDetector as JaxFaceBoxDetector  # noqa: E402
from fdt.models.facebox import FaceBox as JaxFaceBox  # noqa: E402
from fdt_torch.anchors import facebox_default_boxes  # noqa: E402
from fdt_torch.apps.serving import DetectionService, resize_bilinear  # noqa: E402
from fdt_torch.config import FACEBOX, FACEBOX_PINNED, FaceBoxConfig  # noqa: E402
from fdt_torch.infer import FaceBoxDetector  # noqa: E402
from fdt_torch.models import FaceBox, from_jax_variables, load_facebox_detector  # noqa: E402
from fdt_torch.models.common import ConvBNReLU, crelu  # noqa: E402
from tests.test_torch_seeded import nest_like  # noqa: E402

torch.set_num_threads(1)

WEIGHTS_SEED = 0
GOLDEN_KEEP_ROWS = 120  # chip_smoke compares the first GOLDEN_ROWS, near-tie swaps allowed
SMALL = dict(input_size=128, feature_map_sizes=(4, 2, 1))  # 341 default boxes


@pytest.fixture(scope="module")
def flat():
    return chip_smoke.seeded_variables(FaceBox(), WEIGHTS_SEED)


@pytest.fixture(scope="module")
def variables(flat):
    return nest_like(flat, JaxFaceBox(), 128)


@pytest.fixture(scope="module")
def model(flat):
    m = FaceBox()
    m.load_state_dict(from_jax_variables(flat), strict=True)
    return m.eval()


@pytest.mark.parametrize("cfg", [{}, SMALL, dict(input_size=512, feature_map_sizes=(16, 8, 4))],
                         ids=["1024", "128", "512"])
def test_default_boxes_bit_equal(cfg):
    ours = facebox_default_boxes(FaceBoxConfig(**cfg))
    theirs = jax_default_boxes(JaxFaceBoxConfig(**cfg))
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    if not cfg:
        assert ours.shape == (21824, 4)


def test_configs_match_fdt():
    from fdt.config import FACEBOX as JF, FACEBOX_PINNED as JP
    for ours, theirs in ((FACEBOX, JF), (FACEBOX_PINNED, JP)):
        assert ours.__dict__ == theirs.__dict__


def test_crelu_and_conv_bn_relu_match_fdt():
    from fdt.models.common import ConvBNReLU as JaxConvBNReLU
    from fdt.models.common import crelu as jax_crelu
    x = np.random.RandomState(1).randn(2, 6, 5, 8).astype(np.float32)  # NHWC
    np.testing.assert_array_equal(
        crelu(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy(),
        np.asarray(jax_crelu(jnp.asarray(x))))
    block = ConvBNReLU(8, 16, 3, 1, 1).eval()
    rng = np.random.RandomState(2)
    jv = {"params": {"0": {"kernel": rng.randn(3, 3, 8, 16).astype(np.float32) * 0.2,
                           "bias": rng.randn(16).astype(np.float32) * 0.1},
                     "1": {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
                           "bias": rng.randn(16).astype(np.float32) * 0.1}},
          "batch_stats": {"1": {"mean": rng.randn(16).astype(np.float32) * 0.1,
                                "var": rng.uniform(0.5, 1.5, 16).astype(np.float32)}}}
    block.load_state_dict(from_jax_variables(jv), strict=True)
    want = JaxConvBNReLU(16, 3, padding=1).apply(jv, jnp.asarray(x))
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [128, 160])
def test_forward_matches_flax(variables, model, size):
    """loc and conf agree to 1e-5 of their largest magnitude: float32 on both
    sides, convolutions summed in another order.  The 21 anchors per cell of
    layer 0 come out in fdt's NHWC order."""
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = JaxFaceBox().apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


class _FixedHeads(torch.nn.Module):
    """A stand-in model that returns given loc/conf logits."""

    def __init__(self, loc, conf):
        super().__init__()
        self.out = (torch.from_numpy(loc), torch.from_numpy(conf))

    def forward(self, x):
        return self.out


@pytest.mark.parametrize("pinned", [False, True], ids=["facebox", "pinned"])
def test_post_model_path_matches_fdt(pinned):
    """Softmax, decode against the 21,824 default boxes, `> conf_thresh`,
    nms_padded at budget 2048 / out_k 750, gather: equal counts and the same
    kept boxes in the same order, on seeded [2, 21824, ·] loc and conf
    logits.  Scores agree to one float32 ulp at 1.0 (1.19e-7): XLA's and
    torch's softmax round differently in the last bit; boxes to 1e-6 (`exp`
    in decode, as in test_torch_detect_head)."""
    rng = np.random.RandomState(5)
    loc = (rng.randn(2, 21824, 4) * 0.5).astype(np.float32)
    conf = (rng.randn(2, 21824, 2) * 1.5).astype(np.float32)
    images = np.zeros((2, 1024, 1024, 3), np.uint8)
    cfg, jcfg = ((FACEBOX_PINNED, JaxFaceBoxConfig(conf_thresh=0.4)) if pinned
                 else (FACEBOX, JaxFaceBoxConfig()))
    jdet = JaxFaceBoxDetector({"params": {}, "batch_stats": {}}, cfg=jcfg)

    class Fixed:
        @staticmethod
        def apply(variables, x):
            return jnp.asarray(loc), jnp.asarray(conf)

    jdet.model = Fixed()
    theirs = jdet.detect_batch(images)
    det = FaceBoxDetector(_FixedHeads(loc, conf), cfg=cfg, device="cpu")
    boxes, scores, count = det.detect_device(torch.from_numpy(images))
    assert boxes.shape == (2, 750, 4) and scores.shape == (2, 750)
    for i, (tb, ts) in enumerate(theirs):
        c = len(ts)
        assert int(count[i]) == c > 100
        np.testing.assert_allclose(scores[i, :c].numpy(), ts, rtol=0, atol=1.2e-7)
        np.testing.assert_allclose(boxes[i, :c].numpy(), tb, rtol=0, atol=1e-6)
        assert not scores[i, c:].any() and not boxes[i, c:].any()


@pytest.fixture(scope="module")
def small_detector(model):
    return FaceBoxDetector(model, cfg=FaceBoxConfig(**SMALL), budget=300, out_k=120,
                           device="cpu")


def test_detector_matches_fdt(variables, small_detector):
    """The whole detector at 128²: equal counts, rows within 1e-5 (float32
    on both sides, convolutions summed in another order)."""
    images = np.random.RandomState(6).randint(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    jdet = JaxFaceBoxDetector(variables, cfg=JaxFaceBoxConfig(**SMALL), budget=300,
                              out_k=120, precision="highest")
    theirs = jdet.detect_batch(images)
    ours = small_detector.detect_batch(images)
    for (b, s), (tb, ts) in zip(ours, theirs):
        assert len(s) == len(ts) > 10
        np.testing.assert_allclose(s, ts, rtol=0, atol=1e-5)
        np.testing.assert_allclose(b, tb, rtol=0, atol=1e-5)


def test_bfloat16_detector_runs_channels_last(flat):
    """The bench mode: bf16 weights in channels_last; the detections stay
    within bf16's drift of the float32 ones (about 3 significant digits)."""
    images = np.random.RandomState(6).randint(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    dets = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = FaceBox()
        m.load_state_dict(from_jax_variables(flat), strict=True)
        dets[dtype] = FaceBoxDetector(m, cfg=FaceBoxConfig(**SMALL), budget=300, out_k=120,
                                      dtype=dtype, device="cpu")
    w = dets[torch.bfloat16].model.conv2.weight
    assert w.dtype == torch.bfloat16 and w.is_contiguous(memory_format=torch.channels_last)
    for (b16, s16), (b32, s32) in zip(dets[torch.bfloat16].detect_batch(images),
                                      dets[torch.float32].detect_batch(images)):
        assert s16.dtype == np.float32 and np.isfinite(b16).all() and len(s16) > 10
        assert np.all(np.diff(s16) <= 0)
        np.testing.assert_allclose(s16[:5], s32[:5], rtol=0, atol=1e-2)


def test_detect_any_resolution_scales_to_pixels(small_detector):
    im = np.random.RandomState(7).randint(0, 256, (90, 150, 3), dtype=np.uint8)
    boxes, scores = small_detector.detect(im)
    (nb, ns), = small_detector.detect_batch(resize_bilinear(im, 128, 128)[None])
    np.testing.assert_array_equal(scores, ns)
    np.testing.assert_allclose(boxes, nb * np.array([150, 90, 150, 90], np.float32))


def test_detector_rejects_wrong_frames(small_detector):
    with pytest.raises(ValueError, match="128,128,3"):
        small_detector.detect_batch(np.zeros((1, 96, 128, 3), np.uint8))


def test_npz_loads_strict_into_both(tmp_path, variables, flat):
    """An fdt variables npz (f16 params) loads strict into the port, and both
    detectors read it to the same detections."""
    from fdt.models.loader import load_facebox_detector as jax_load
    from fdt.models.loader import save_variables_npz
    path = str(tmp_path / "facebox.npz")
    save_variables_npz(variables, path)
    det = load_facebox_detector(path, cfg=FaceBoxConfig(**SMALL), device="cpu")
    sd = det.model.state_dict()
    np.testing.assert_array_equal(
        sd["multilbox.loc_layers.0.weight"].numpy(),
        variables["params"]["multilbox"]["loc_layers__0"]["kernel"].astype(np.float16)
        .astype(np.float32).transpose(3, 2, 0, 1))
    images = np.random.RandomState(8).randint(0, 256, (1, 128, 128, 3), dtype=np.uint8)
    (b, s), = det.detect_batch(images)
    (tb, ts), = jax_load(path, cfg=JaxFaceBoxConfig(**SMALL), precision="highest").detect_batch(images)
    assert len(s) == len(ts) > 0
    np.testing.assert_allclose(s, ts, rtol=0, atol=1e-5)


def test_service_answers_match_direct_calls(small_detector):
    """The facebox family serves the detector's fixed square frame: requests
    of mixed sizes from 4 threads, each answer equal to its direct call."""
    svc = DetectionService("facebox", small_detector, frame_size=(640, 480),
                           threshold=0.4, max_batch=4, max_wait_ms=50)
    assert svc.stats()["frame_size"] == [128, 128]
    rng = np.random.RandomState(9)
    sizes = [(128, 128), (96, 160), (200, 150), (64, 64)]
    images = [rng.randint(0, 256, (*sizes[i % 4], 3), dtype=np.uint8) for i in range(8)]
    results, errors = {}, []

    def client(ids):
        for i in ids:
            try:
                results[i] = svc.detect(images[i])
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

    threads = [threading.Thread(target=client, args=(range(k, 8, 4),)) for k in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        svc.close()
    assert not errors and len(results) == 8
    assert not any(t.is_alive() for t in threads)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        frame = im if (h, w) == (128, 128) else resize_bilinear(im, 128, 128)
        (b, s), = small_detector.detect_batch(frame[None])
        keep = s >= 0.4
        want = np.column_stack([b[keep] * np.array([w, h, w, h], np.float32), s[keep]])
        assert results[i].shape == want.shape and results[i].dtype == np.float32
        # float32 summation order of another batch size: ~1e-6 of the frame
        scale = np.array([w, h, w, h, 1], np.float32)
        np.testing.assert_allclose(results[i] / scale, want / scale, rtol=0, atol=1e-5)


def make_golden() -> dict:
    """fdt's float32 FaceBoxes rows for the seeded golden frame."""
    size = chip_smoke.FACEBOX_SIZE
    frame = chip_smoke.golden_frame(chip_smoke.FACEBOX_FRAME_SEED, size, size)
    flat = chip_smoke.seeded_variables(FaceBox(), chip_smoke.FACEBOX_WEIGHTS_SEED)
    det = JaxFaceBoxDetector(nest_like(flat, JaxFaceBox(), 128), precision="highest")
    (boxes, scores), = det.detect_batch(frame[None])
    rows = np.column_stack([scores, boxes]).astype(np.float32)
    return {"rows": rows[:GOLDEN_KEEP_ROWS], "count": np.int64(len(scores)),
            "frame_seed": np.int64(chip_smoke.FACEBOX_FRAME_SEED),
            "weights_seed": np.int64(chip_smoke.FACEBOX_WEIGHTS_SEED),
            "size": np.int64(size),
            "frame_sha256": np.str_(hashlib.sha256(frame.tobytes()).hexdigest())}


def test_golden_file_is_consistent():
    g = np.load(chip_smoke.FACEBOX_GOLDEN)
    assert chip_smoke.FACEBOX_GOLDEN.stat().st_size < 100_000
    size = int(g["size"])
    frame = chip_smoke.golden_frame(int(g["frame_seed"]), size, size)
    assert hashlib.sha256(frame.tobytes()).hexdigest() == str(g["frame_sha256"])
    assert int(g["weights_seed"]) == chip_smoke.FACEBOX_WEIGHTS_SEED
    assert int(g["count"]) >= chip_smoke.GOLDEN_ROWS
    assert np.all(np.diff(g["rows"][:, 0]) <= 0)


@pytest.mark.slow
def test_facebox_golden_matches_jax_and_port():
    """Re-make the 1024² golden with fdt's detector and hold it and the
    port's CPU float32 output against the committed file."""
    g = dict(np.load(chip_smoke.FACEBOX_GOLDEN))
    fresh = make_golden()
    np.testing.assert_array_equal(fresh["rows"], g["rows"])
    assert fresh["count"] == g["count"]
    m = FaceBox()
    m.load_state_dict(from_jax_variables(
        chip_smoke.seeded_variables(FaceBox(), int(g["weights_seed"]))), strict=True)
    size = int(g["size"])
    frame = chip_smoke.golden_frame(int(g["frame_seed"]), size, size)
    (b, s), = FaceBoxDetector(m, device="cpu").detect_batch(frame[None])
    chip_smoke.match_rows(np.column_stack([s, b]), g["rows"], chip_smoke.GOLDEN_ROWS,
                          chip_smoke.GOLDEN_TOL)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the FaceBoxes golden for chip_smoke.py")
    ap.add_argument("--write-golden", action="store_true", required=True)
    ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    golden = make_golden()
    np.savez_compressed(chip_smoke.FACEBOX_GOLDEN, **golden)
    print(f"wrote {chip_smoke.FACEBOX_GOLDEN.relative_to(REPO)}: {int(golden['count'])} "
          f"rows, top score {golden['rows'][0, 0]:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
