"""fdt_torch priors and box algebra against fdt's (same numpy-seeded inputs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdt import anchors as jax_anchors
from fdt import config as jax_config
from fdt.geometry import boxes as jax_boxes
from fdt_torch import anchors, config
from fdt_torch.geometry import boxes

torch.set_num_threads(1)


def test_config_copy_matches_fdt():
    for name in ("name", "input_size", "num_sources"):
        assert getattr(config.PYRAMID_REPO, name) == getattr(jax_config.PYRAMID_REPO, name)
    for part in ("face_priors", "head_priors", "detect"):
        ours = getattr(config.PYRAMID_REPO, part)
        theirs = getattr(jax_config.PYRAMID_REPO, part)
        assert vars(ours) == vars(theirs)
    assert config.PYRAMID_REPO.detect.drop_single_candidate is True
    assert config.PIXEL_MEAN_BGR == jax_config.PIXEL_MEAN_BGR


@pytest.mark.parametrize("width,height", [(640, 640), (150, 130), (97, 203)])
def test_priors_bit_equal(width, height):
    cfg_t, cfg_j = config.PYRAMID_REPO, jax_config.PYRAMID_REPO
    shapes = anchors.feature_map_sizes(width, height, cfg_t.face_priors.strides)
    assert shapes == jax_anchors.feature_map_sizes(width, height,
                                                   cfg_j.face_priors.strides)
    ours = anchors.pyramid_face_priors(cfg_t, shapes, width, height)
    theirs = jax_anchors.pyramid_face_priors(cfg_j, shapes, width, height)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        anchors.pyramid_head_priors(cfg_t, shapes, width, height),
        jax_anchors.pyramid_head_priors(cfg_j, shapes, width, height))


def test_prior_grid_scales_and_aspect_ratios_bit_equal():
    kw = dict(strides=(8, 16), boxes=(16, 32), scales=(2, 3),
              aspect_ratios=((2.0,), (1.5, 3.0)))
    for idx, (fw, fh) in enumerate([(12, 9), (6, 5)]):
        ours = anchors.prior_grid(config.PriorConfig(**kw), idx, fw, fh, 96, 72)
        theirs = jax_anchors.prior_grid(jax_config.PriorConfig(**kw), idx, fw,
                                        fh, 96, 72)
        np.testing.assert_array_equal(ours, theirs)


def _random_point_boxes(rng, n):
    centers = rng.rand(n, 2) * 4
    wh = rng.rand(n, 2) * 2 + 0.5
    return np.concatenate([centers - wh / 2, centers + wh / 2], 1).astype(np.float32)


@pytest.mark.parametrize("fn", ["point_form", "center_size"])
def test_form_conversions_bit_equal(fn, rng):
    x = rng.rand(3, 50, 4).astype(np.float32) * 10
    ours = getattr(boxes, fn)(torch.from_numpy(x)).numpy()
    theirs = np.asarray(getattr(jax_boxes, fn)(jnp.asarray(x)))
    np.testing.assert_array_equal(ours, theirs)


def test_intersect_and_iou_bit_equal(rng):
    a, b = _random_point_boxes(rng, 60), _random_point_boxes(rng, 45)
    for fn in ("intersect", "iou_matrix"):
        ours = getattr(boxes, fn)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        theirs = np.asarray(getattr(jax_boxes, fn)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(ours, theirs)


def test_decode_matches_fdt(rng):
    """Tolerance 1e-6 absolute: the operation order is fdt's, but XLA's and
    torch's float32 `exp` differ in the last bit on some inputs; boxes are
    normalized coordinates of magnitude ~1, so one ulp is ~1e-7."""
    loc = (rng.randn(2, 500, 4) * 1.5).astype(np.float32)
    priors = np.concatenate([rng.rand(500, 2), rng.rand(500, 2) * 0.3 + 0.01],
                            1).astype(np.float32)
    var = config.DetectConfig().variance
    ours = boxes.decode(torch.from_numpy(loc), torch.from_numpy(priors), var).numpy()
    theirs = np.asarray(jax_boxes.decode(jnp.asarray(loc), jnp.asarray(priors), var))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
