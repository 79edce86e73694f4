"""fdt_torch's detectors with quant="int8" against fdt's, on the CPU.

The int8 path is not bit-equal end to end: each conv's per-tensor scale and
rounding follow the float arithmetic before it (BatchNorm, the upsample),
which differs from fdt's in the last bit, and one int8 level moved there
moves every later layer.  fdt's own int8 detector drifts as far under an
input perturbation of 1e-5 of its scale (3.8–4.9% of the output scale
against the port's 2.3–5.5% on the depth-cut flagship at 128²).  So the
detections are held to fdt's int8-against-float protocol
(tests/test_quant.py:160-175, chip_smoke.int8_drift): over the top 100 rows
the median IoU of matched rows ≥ 0.95 and their score difference ≤ 0.08, and
a matched share of at least fdt's 90% or, where fdt's own int8 detector
matches fewer of its float rows on the same images, that share less 0.1
(chip_smoke.int8_min_matched).  Measured here: the port matches 0.94–1.0
of fdt's int8 rows; fdt's int8 matches 0.86–0.99 of its float rows.  As a
control that a detector which skipped quantization would fail, the port's
rows must also match more of fdt's int8 rows than fdt's float rows do
(check_closer_than_float; chip_smoke.check_int8_golden for the golden).

The int8 golden that chip_smoke.py checks on the card is written by

    python tests/test_torch_quant_detectors.py --write-golden

and re-made and compared by the slow tests below: fdt's int8 detector (full
depth, float32, precision "highest", on the CPU, ~80 s) on the flagship
golden's frame, and fdt's own bf16 int8 detector against its bf16 float one
on chip_smoke.flagship_batch() (batch 8, 640², ~8 min), the reference of
the card's bf16 check (chip_smoke.int8_bf16_limits).  On those noise frames
fdt's own int8 falls outside its photo bounds too (matched 0.56–0.63,
median IoU down to 0.947, score differences up to 0.186).
"""
import argparse
import hashlib
import pathlib
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.config import FaceBoxConfig as JaxFaceBoxConfig  # noqa: E402
from fdt.infer.facebox import FaceBoxDetector as JaxFaceBoxDetector  # noqa: E402
from fdt.infer.pyramidbox import PyramidBoxDetector as JaxDetector  # noqa: E402
from fdt.models.facebox import FaceBox as JaxFaceBox  # noqa: E402
from fdt.models.pyramidbox import PyramidBox as JaxPyramidBox  # noqa: E402
from fdt_torch.config import FaceBoxConfig  # noqa: E402
from fdt_torch.infer import FaceBoxDetector, PyramidBoxDetector  # noqa: E402
from fdt_torch.models import (FaceBox, PyramidBox, from_jax_variables, load_npz,  # noqa: E402
                              load_pyramidbox)
from fdt_torch.ops.quant import Int8Conv2d  # noqa: E402
from tests.test_torch_detector import CUT, _first_blocks  # noqa: E402
from tests.test_torch_seeded import nest_like  # noqa: E402

torch.set_num_threads(1)

WEIGHTS = REPO / "net_weight" / "repo_mini.npz"
TRY1 = REPO / "net_weight" / "try1_distilled_mini.npz"
SMALL = dict(input_size=128, feature_map_sizes=(4, 2, 1))
GOLDEN_KEEP_ROWS = 200


def check_rows(fdt_float, fdt_int8, port_int8, n=chip_smoke.INT8_ROWS) -> tuple:
    """The port's int8 rows against fdt's (chip_smoke.check_int8_drift), the
    matched share bounded by fdt's own float-to-int8 share on the same rows.
    Returns (the port's matched share of fdt's int8 rows, the share that
    fdt's float rows match of them) for check_closer_than_float."""
    ref = chip_smoke.int8_drift(fdt_float, fdt_int8, n)["matched"]
    want = chip_smoke.int8_min_matched(ref)
    got = chip_smoke.int8_drift(fdt_int8, port_int8, n)
    assert got["matched"] >= want, (got, ref)
    assert got["median_iou"] >= chip_smoke.INT8_MEDIAN_IOU and \
        got["score_diff"] <= chip_smoke.INT8_SCORE_DIFF, got
    return got["matched"], chip_smoke.int8_drift(fdt_int8, fdt_float, n)["matched"]


def check_closer_than_float(shares) -> None:
    """The control that a detector which skipped quantization fails: over a
    test's images the port's int8 rows match more of fdt's int8 rows than
    fdt's float rows do (a float path matches as many as fdt's float does).
    Measured: 0.97 against 0.90 (flagship), 0.94 against 0.93 (try1), 1.0
    against 0.97 (FaceBoxes); per image the port's share is never lower."""
    got, control = np.mean(shares, axis=0)
    assert got > control, shares


@pytest.fixture(scope="module")
def cut_variables():
    return _first_blocks(load_npz(str(WEIGHTS)))


@pytest.fixture(scope="module")
def cut_model(cut_variables):
    model = PyramidBox(CUT)
    model.load_state_dict(from_jax_variables(cut_variables), strict=True)
    return model.eval()


def test_flagship_int8_matches_fdt(cut_variables, cut_model):
    """The depth-cut flagship (the first block of every stage of
    repo_mini.npz) at 128², batch 2, float32: int8 rows against fdt's."""
    images = np.random.RandomState(128).randint(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    det = PyramidBoxDetector(cut_model, device="cpu", quant="int8")
    assert det.quant == "int8"
    assert sum(isinstance(m, Int8Conv2d) for m in det.model.modules()) == 85
    ours = det.detect_tensor(images, conf_thresh=0.05, nms_thresh=0.35)
    theirs = {q: JaxDetector(cut_variables, JaxPyramidBox(num_blocks=CUT), "repo",
                             precision="highest", quant=q).detect_tensor(images, 0.05, 0.35)
              for q in (None, "int8")}
    assert ours.shape == (2, 2, 750, 5) and np.isfinite(ours).all()
    check_closer_than_float([check_rows(theirs[None][i, 1], theirs["int8"][i, 1], ours[i, 1])
                             for i in range(2)])


def test_try1_int8_matches_fdt():
    """try1 with its trained npz (3 grouped int8 1×1s, 16 float-path convs)
    at 160², batch 2, float32."""
    from fdt.models.loader import load_variables
    from fdt.models.pyramidbox_mobile import build_pyramidbox as jax_build

    images = np.random.RandomState(7).randint(0, 256, (2, 160, 160, 3), dtype=np.uint8)
    det = PyramidBoxDetector(load_pyramidbox(str(TRY1), "try1"), "try1", device="cpu",
                             quant="int8")
    ours = det.detect_tensor(images, conf_thresh=0.05, nms_thresh=0.35)
    jm = jax_build("try1")
    jv = load_variables(jm, str(TRY1), 160)
    check_closer_than_float([check_rows(f[1], q[1], ours[i, 1]) for i, (f, q) in enumerate(zip(*(
        JaxDetector(jv, jm, "try1", precision="highest", quant=quant).detect_tensor(
            images, 0.05, 0.35) for quant in (None, "int8"))))])


@pytest.fixture(scope="module")
def facebox_flat():
    return chip_smoke.seeded_variables(FaceBox(), 0)


def test_facebox_int8_matches_fdt(facebox_flat):
    """FaceBoxes (seeded weights, every conv int8, the 7×7/4 stem too) at a
    128² config, float32: each image's rows against fdt's."""
    images = np.random.RandomState(6).randint(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    model = FaceBox()
    model.load_state_dict(from_jax_variables(facebox_flat), strict=True)
    det = FaceBoxDetector(model, cfg=FaceBoxConfig(**SMALL), budget=300, out_k=120,
                          device="cpu", quant="int8")
    variables = nest_like(facebox_flat, JaxFaceBox(), 128)
    theirs = {q: JaxFaceBoxDetector(variables, cfg=JaxFaceBoxConfig(**SMALL), budget=300,
                                    out_k=120, precision="highest", quant=q
                                    ).detect_batch(images) for q in (None, "int8")}
    shares = []
    for (b, s), (fb, fs), (qb, qs) in zip(det.detect_batch(images), theirs[None],
                                          theirs["int8"]):
        rows = [np.column_stack([sc, bx]) for bx, sc in ((fb, fs), (qb, qs), (b, s))]
        n = min(map(len, rows))
        assert n >= 50
        shares.append(check_rows(*rows, n=n))
    check_closer_than_float(shares)


def test_float_detector_sharing_the_model_is_unchanged(cut_model):
    """An int8 detector (float32 or bf16) built from the model a float
    detector holds leaves that detector's answers and weights as they were."""
    images = np.random.RandomState(3).randint(0, 256, (1, 96, 96, 3), dtype=np.uint8)
    float_det = PyramidBoxDetector(cut_model, device="cpu")
    before = float_det.detect_tensor(images, 0.05, 0.35)
    weight = cut_model.conv1.weight.detach().clone()
    for dtype in (torch.float32, torch.bfloat16):
        q = PyramidBoxDetector(cut_model, dtype=dtype, device="cpu", quant="int8")
        assert q.model is not cut_model and isinstance(q.model.conv1, Int8Conv2d)
        assert np.isfinite(q.detect_tensor(images, 0.05, 0.35)).all()
    assert type(cut_model.conv1) is torch.nn.Conv2d and float_det.model is cut_model
    assert cut_model.conv1.weight.dtype == torch.float32
    assert torch.equal(cut_model.conv1.weight, weight)
    np.testing.assert_array_equal(float_det.detect_tensor(images, 0.05, 0.35), before)
    with pytest.raises(ValueError, match="quantization mode"):
        PyramidBoxDetector(cut_model, device="cpu", quant="int4")
    with pytest.raises(ValueError, match="quantization mode"):
        FaceBoxDetector(FaceBox(), device="cpu", quant="fp8")


def _serve_args(**kw):
    base = dict(detector="pyramid", net="try3", weights=None, threshold=0.4, max_batch=2,
                max_wait_ms=1.0, frame_w=96, frame_h=64, quant="int8", dp_devices=0,
                device="cpu")
    return SimpleNamespace(**{**base, **kw})


def test_serve_quant_int8_builds_pyramid_and_facebox_and_refuses_mtcnn(tmp_path, facebox_flat):
    """`serve --quant int8` builds the quantized pyramid and FaceBoxes services
    (their convs Int8Conv2d), and refuses the mtcnn cascade with fdt's
    message (scripts/serve.py:45-46)."""
    from fdt.models.loader import save_variables_npz
    from fdt_torch.cli import serve

    svc = serve.build_service(_serve_args())
    try:
        assert svc.detector.quant == "int8"
        assert any(isinstance(m, Int8Conv2d) for m in svc.detector.model.modules())
        rows = svc.detect(np.random.RandomState(0).randint(0, 256, (64, 96, 3), np.uint8))
        assert rows.ndim == 2 and rows.shape[1] == 5
    finally:
        svc.close()
    path = str(tmp_path / "facebox.npz")
    save_variables_npz(nest_like(facebox_flat, JaxFaceBox(), 128), path)
    svc = serve.build_service(_serve_args(detector="facebox", weights=path))
    try:
        assert svc.detector.quant == "int8"
        assert isinstance(svc.detector.model.conv1, Int8Conv2d)
    finally:
        svc.close()
    with pytest.raises(SystemExit, match="not supported for the mtcnn cascade"):
        serve.build_service(_serve_args(detector="mtcnn", weights="p.npz,r.npz,o.npz"))


def make_golden() -> dict:
    """fdt's int8 detector's float32 rows for the flagship golden's frame,
    weights and thresholds, and the share of fdt's float golden rows they
    match (chip_smoke.int8_drift)."""
    from fdt.models.loader import load_variables
    g = np.load(chip_smoke.GOLDEN)
    h, w = int(g["height"]), int(g["width"])
    frame = chip_smoke.golden_frame(int(g["seed"]), h, w)
    model = JaxPyramidBox()
    det = JaxDetector(load_variables(model, str(WEIGHTS), w), model, "repo",
                      precision="highest", quant="int8")
    out = det.detect_tensor(frame[None], conf_thresh=float(g["conf_thresh"]),
                            nms_thresh=float(g["nms_thresh"]))[0, 1]
    rows = out[:GOLDEN_KEEP_ROWS].astype(np.float32)
    return {"rows": rows, "count": np.int64((out[:, 0] > 0).sum()),
            "seed": g["seed"], "height": g["height"], "width": g["width"],
            "conf_thresh": g["conf_thresh"], "nms_thresh": g["nms_thresh"],
            "frame_sha256": g["frame_sha256"],
            "fdt_float_matched": np.float64(chip_smoke.int8_drift(g["rows"], rows)["matched"])}


def make_bf16_reference() -> dict:
    """fdt's bf16 int8 flagship against its bf16 float flagship on
    chip_smoke.flagship_batch() (the card's bf16 check's frames), top rows
    at conf 0.01: each image's chip_smoke.int8_drift measures."""
    from fdt.models.loader import load_variables
    frames = chip_smoke.flagship_batch()
    model = JaxPyramidBox(dtype=jnp.bfloat16)
    v = load_variables(model, str(WEIGHTS), chip_smoke.SIZE)
    rows = {q: JaxDetector(v, model, "repo", precision="highest", quant=q).detect_tensor(
        frames, conf_thresh=0.01, nms_thresh=0.35) for q in (None, "int8")}
    drifts = [chip_smoke.int8_drift(rows[None][i, 1], rows["int8"][i, 1])
              for i in range(len(frames))]
    return {f"fdt_bf16_{k}": np.array([d[k] for d in drifts])
            for k in ("matched", "median_iou", "score_diff")}


def test_int8_golden_file_is_consistent():
    g = np.load(chip_smoke.INT8_GOLDEN)
    f = np.load(chip_smoke.GOLDEN)
    assert chip_smoke.INT8_GOLDEN.stat().st_size < 100_000
    for key in ("seed", "height", "width", "conf_thresh", "nms_thresh", "frame_sha256"):
        assert g[key] == f[key], key
    frame = chip_smoke.golden_frame(int(g["seed"]), int(g["height"]), int(g["width"]))
    assert hashlib.sha256(frame.tobytes()).hexdigest() == str(g["frame_sha256"])
    assert int(g["count"]) >= chip_smoke.INT8_ROWS and np.all(np.diff(g["rows"][:, 0]) <= 0)
    assert float(g["fdt_float_matched"]) == chip_smoke.int8_drift(f["rows"], g["rows"])["matched"]
    assert 0.5 < float(g["fdt_float_matched"]) < 1
    for key in ("fdt_bf16_matched", "fdt_bf16_median_iou", "fdt_bf16_score_diff"):
        assert g[key].shape == (chip_smoke.BATCH,) and np.all(g[key] > 0), key
    limits = chip_smoke.int8_bf16_limits(g)
    assert limits["matched"] <= chip_smoke.INT8_MATCHED
    assert limits["median_iou"] <= chip_smoke.INT8_MEDIAN_IOU
    assert limits["score_diff"] >= chip_smoke.INT8_SCORE_DIFF


@pytest.mark.slow
def test_int8_golden_matches_fdt_and_port():
    """Re-make the int8 golden with fdt (full depth) and hold it and the
    port's CPU float32 int8 output against the committed file."""
    g = dict(np.load(chip_smoke.INT8_GOLDEN))
    fresh = make_golden()
    np.testing.assert_array_equal(fresh["rows"], g["rows"])
    det = PyramidBoxDetector(load_pyramidbox(str(WEIGHTS)), device="cpu", quant="int8")
    frame = chip_smoke.golden_frame(int(g["seed"]), int(g["height"]), int(g["width"]))
    ours = det.detect_tensor(frame[None], float(g["conf_thresh"]), float(g["nms_thresh"]))[0, 1]
    chip_smoke.check_int8_golden(g, ours, "the port's CPU int8 flagship")


@pytest.mark.slow
def test_int8_bf16_reference_matches_fdt():
    """Re-make fdt's bf16 int8-against-float measures on the card check's
    frames and hold them to the committed ones."""
    g = np.load(chip_smoke.INT8_GOLDEN)
    for key, value in make_bf16_reference().items():
        np.testing.assert_array_equal(value, g[key])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the int8 flagship golden for chip_smoke.py")
    ap.add_argument("--write-golden", action="store_true", required=True)
    ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    golden = {**make_golden(), **make_bf16_reference()}
    np.savez_compressed(chip_smoke.INT8_GOLDEN, **golden)
    print(f"wrote {chip_smoke.INT8_GOLDEN.relative_to(REPO)}: {int(golden['count'])} rows, "
          f"top score {golden['rows'][0, 0]:.6f}, "
          f"fdt's float rows matched {float(golden['fdt_float_matched']):.3f}; bf16: "
          f"matched {golden['fdt_bf16_matched'].tolist()}, median IoU "
          f"{np.round(golden['fdt_bf16_median_iou'], 4).tolist()}, score "
          f"{np.round(golden['fdt_bf16_score_diff'], 4).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
