"""fdt_torch's PyramidBox mobile variants try1…try5 (models, weight carry,
detector) against fdt's, on weights made from a numpy seed by
chip_smoke.seeded_variables and on the trained npz files of the repo.

The 640² goldens that chip_smoke.py checks on the card (rows for the trained
try1 and try3, source shapes for every variant) are written by

    python tests/test_torch_mobile.py --write-golden

(fdt's PyramidBoxDetector, float32 precision "highest", on the CPU), and
re-made and compared by the slow test below.
"""
import argparse
import dataclasses
import hashlib
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.config import PYRAMID_CONFIGS as JAX_CONFIGS  # noqa: E402
from fdt.infer.pyramidbox import PyramidBoxDetector as JaxDetector  # noqa: E402
from fdt.models.pyramidbox_mobile import build_pyramidbox as jax_build  # noqa: E402
from fdt.models.shapes import trace_source_shapes  # noqa: E402
from fdt_torch.config import PYRAMID_CONFIGS  # noqa: E402
from fdt_torch.infer import PyramidBoxDetector  # noqa: E402
from fdt_torch.models import (build_pyramidbox, from_jax_variables, load_npz,  # noqa: E402
                              load_pyramidbox, load_pyramidbox_detector)
from tests.test_torch_seeded import nest_like  # noqa: E402

torch.set_num_threads(1)

VARIANTS = ["try1", "try2", "try3", "try4", "try5"]
GOLDEN_KEEP_ROWS = 120  # chip_smoke compares the first GOLDEN_ROWS, near-tie swaps allowed
# float32 rounding through 50-70 layers: the port's own float32 forward is
# up to 7.7e-5 of the output scale away from its float64 forward on these
# seeded weights (try4 at 150²), so the two float32 forwards are held to
# 2e-4 of the scale; a wrong layer, weight or layout is off by O(1)
FORWARD_TOL = 2e-4


def seeded_pair(variant: str, seed: int = 0):
    """(fdt variables, port model) with the same seeded weights."""
    model = build_pyramidbox(variant)
    flat = chip_smoke.seeded_variables(model, seed)
    model.load_state_dict(from_jax_variables(flat), strict=True)
    return nest_like(flat, jax_build(variant), 128), model.eval()


def test_configs_match_fdt():
    assert PYRAMID_CONFIGS.keys() == JAX_CONFIGS.keys()
    for name, cfg in PYRAMID_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_CONFIGS[name]), name


@pytest.mark.parametrize("size", [(128, 128), (150, 150)], ids=["128", "150"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_flax(variant, size):
    """face_loc, face_conf, the head-supervision branch the trainer asks for
    (head_loc, head_conf with heads=True) and source_shapes against
    build_pyramidbox(v).apply; 150² makes the LFPN crop its upsampled maps,
    and try4/try5's maps break the ceil-halving rule."""
    variables, model = seeded_pair(variant)
    h, w = size
    x = (np.random.RandomState(h).rand(1, h, w, 3) * 255 - 117).astype(np.float32)
    with jax.default_matmul_precision("highest"):  # jit: 5x faster than eager here
        want = jax.jit(jax_build(variant).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), heads=True)
    assert got["source_shapes"] == want["source_shapes"]
    assert len(got["source_shapes"]) == len(PYRAMID_CONFIGS[variant].face_priors.strides)
    for key in ("face_loc", "face_conf", "head_loc", "head_conf"):
        ref = np.asarray(want[key])
        assert got[key].shape == ref.shape and got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), ref, rtol=0,
                                   atol=FORWARD_TOL * np.abs(ref).max())


def test_depthwise_kernel_layout():
    variables, model = seeded_pair("try3")
    k = variables["params"]["features__2"]["conv__3"]["kernel"]  # [3, 3, 1, 96]
    assert k.shape == (3, 3, 1, 96)
    w = model.state_dict()["features.2.conv.3.weight"].numpy()
    assert w.shape == (96, 1, 3, 3)
    np.testing.assert_array_equal(w, k.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("variant", ["try3", "try1"])
def test_trained_npz_loads_strict(variant):
    path = str(REPO / chip_smoke.VARIANT_WEIGHTS[variant])
    variables = load_npz(path)
    model = load_pyramidbox(path, variant)
    sd = model.state_dict()
    n = sum(1 for col in variables.values() for _ in jax.tree.leaves(col))
    assert n == sum(not k.endswith("num_batches_tracked") for k in sd)
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())
    assert not model.training


def test_try3_detector_matches_fdt():
    """The trained try3 through both detectors at 128² (5 source maps, the
    try3 thresholds and priors): equal counts, rows within 1e-5."""
    path = str(REPO / chip_smoke.VARIANT_WEIGHTS["try3"])
    det = load_pyramidbox_detector("try3", path, device="cpu")
    jdet = JaxDetector(load_npz(path), jax_build("try3"), "try3", precision="highest")
    images = np.random.RandomState(3).randint(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    ours = det.detect_tensor(images, conf_thresh=0.05, nms_thresh=0.35)
    theirs = jdet.detect_tensor(images, conf_thresh=0.05, nms_thresh=0.35)
    assert ours.shape == theirs.shape == (2, 2, 750, 5)
    counts = (ours[..., 0] > 0).sum(-1)
    np.testing.assert_array_equal(counts, (theirs[..., 0] > 0).sum(-1))
    assert counts[:, 1].min() > 20
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    assert det.cfg.name == "try3" and det.source_shapes[(128, 128)] == (
        (32, 32), (16, 16), (8, 8), (4, 4), (2, 2))


@pytest.mark.parametrize("variant", ["try4", "try5"])
def test_detector_takes_source_shapes_from_the_forward(variant):
    """try4/try5 break the ceil-halving rule: the detector's priors follow
    the maps of its first forward, which are fdt's traced shapes."""
    _, model = seeded_pair(variant)
    det = PyramidBoxDetector(model, variant, device="cpu")
    out = det.detect_tensor(np.zeros((1, 150, 130, 3), np.uint8))
    assert out.shape == (1, 2, 750, 5) and np.isfinite(out).all()
    want = trace_source_shapes(jax_build(variant), None, 150, 130)
    assert det.source_shapes[(130, 150)] == tuple(want)
    from fdt.anchors import feature_map_sizes
    assert list(want) != feature_map_sizes(130, 150, (4, 8, 16, 32, 64))


def test_detector_rejects_a_config_of_another_map_count():
    _, model = seeded_pair("try5")
    det = PyramidBoxDetector(model, "try1", device="cpu")
    with pytest.raises(ValueError, match="source maps"):
        det.detect_tensor(np.zeros((1, 64, 64, 3), np.uint8))


def make_golden(variant: str) -> dict:
    """fdt's float32 rows (trained variants) and source shapes at 640²."""
    h = w = chip_smoke.SIZE
    model = jax_build(variant)
    out = {"height": np.int64(h), "width": np.int64(w),
           "source_shapes": np.asarray(trace_source_shapes(model, None, h, w), np.int64)}
    weights = chip_smoke.VARIANT_WEIGHTS.get(variant)
    if weights is None:
        return out
    frame = chip_smoke.golden_frame(chip_smoke.VARIANT_FRAME_SEED, h, w)
    det = JaxDetector(load_npz(str(REPO / weights)), model, variant, precision="highest")
    rows = det.detect_tensor(frame[None], conf_thresh=chip_smoke.VARIANT_CONF,
                             nms_thresh=chip_smoke.VARIANT_NMS)[0, 1]
    out.update(rows=rows[:GOLDEN_KEEP_ROWS].astype(np.float32),
               count=np.int64((rows[:, 0] > 0).sum()),
               seed=np.int64(chip_smoke.VARIANT_FRAME_SEED),
               frame_sha256=np.str_(hashlib.sha256(frame.tobytes()).hexdigest()))
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_golden_file_is_consistent(variant):
    path = chip_smoke.variant_golden(variant)
    g = np.load(path)
    assert path.stat().st_size < 100_000
    assert len(g["source_shapes"]) == len(PYRAMID_CONFIGS[variant].face_priors.strides)
    if variant in chip_smoke.VARIANT_WEIGHTS:
        frame = chip_smoke.golden_frame(int(g["seed"]), int(g["height"]), int(g["width"]))
        assert hashlib.sha256(frame.tobytes()).hexdigest() == str(g["frame_sha256"])
        assert int(g["count"]) >= chip_smoke.GOLDEN_ROWS
        assert np.all(np.diff(g["rows"][:, 0]) <= 0)


@pytest.mark.slow
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_golden_matches_jax_and_port(variant):
    """Re-make the 640² golden with fdt's detector and hold it and the port's
    CPU float32 output against the committed file."""
    g = dict(np.load(chip_smoke.variant_golden(variant)))
    fresh = make_golden(variant)
    np.testing.assert_array_equal(fresh["source_shapes"], g["source_shapes"])
    weights = chip_smoke.VARIANT_WEIGHTS.get(variant)
    if weights is None:
        return
    np.testing.assert_array_equal(fresh["rows"], g["rows"])
    det = load_pyramidbox_detector(variant, str(REPO / weights), device="cpu")
    frame = chip_smoke.golden_frame(int(g["seed"]), int(g["height"]), int(g["width"]))
    ours = det.detect_tensor(frame[None], chip_smoke.VARIANT_CONF, chip_smoke.VARIANT_NMS)[0, 1]
    chip_smoke.match_rows(ours, g["rows"], chip_smoke.GOLDEN_ROWS, chip_smoke.GOLDEN_TOL)
    assert det.source_shapes[(frame.shape[1], frame.shape[0])] == tuple(
        map(tuple, g["source_shapes"].tolist()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the mobile-variant goldens for chip_smoke.py")
    ap.add_argument("--write-golden", action="store_true", required=True)
    ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    for variant in VARIANTS:
        golden = make_golden(variant)
        np.savez_compressed(chip_smoke.variant_golden(variant), **golden)
        print(f"wrote {chip_smoke.variant_golden(variant).relative_to(REPO)}: shapes "
              f"{golden['source_shapes'].tolist()}, rows {int(golden.get('count', 0))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
