"""fdt_torch.infer.detect.ssd_detect against fdt's ssd_detect on the same
loc, conf and priors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdt.config import DetectConfig as JaxDetectConfig
from fdt.infer.detect import ssd_detect as jax_ssd_detect
from fdt_torch.config import DetectConfig
from fdt_torch.infer.detect import ssd_detect

torch.set_num_threads(1)


def _inputs(seed, b, p, c):
    rng = np.random.RandomState(seed)
    loc = (rng.randn(b, p, 4) * 0.8).astype(np.float32)
    logits = rng.randn(b, p, c).astype(np.float32) * 2
    conf = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    priors = np.concatenate([rng.rand(p, 2), rng.rand(p, 2) * 0.2 + 0.02],
                            1).astype(np.float32)
    return loc, conf.astype(np.float32), priors


def _both(loc, conf, priors, budget=None, **cfg):
    ours = ssd_detect(torch.from_numpy(loc), torch.from_numpy(conf),
                      torch.from_numpy(priors), DetectConfig(**cfg), budget=budget).numpy()
    theirs = np.asarray(jax_ssd_detect(jnp.asarray(loc), jnp.asarray(conf),
                                       jnp.asarray(priors), JaxDetectConfig(**cfg),
                                       budget=budget))
    return ours, theirs


@pytest.mark.parametrize("case", [
    # seed, B, P, C, budget, cfg
    (0, 2, 3000, 2, None, dict(conf_thresh=0.35, nms_thresh=0.35, top_k=750)),
    (1, 1, 6000, 2, 5000, dict(conf_thresh=0.05, nms_thresh=0.35, top_k=750)),
    (2, 2, 800, 3, 500, dict(conf_thresh=0.2, nms_thresh=0.5, top_k=100)),
    (3, 1, 400, 2, None, dict(conf_thresh=0.1, nms_thresh=0.45, top_k=750)),
], ids=["flagship-thresholds", "budget-5000-all-valid", "three-classes", "top_k-over-P"])
def test_ssd_detect_matches_fdt(case):
    """Counts and score columns are bit-equal.  Box columns agree to 1e-6:
    they come from decode, whose `exp` differs in the last bit between XLA
    and torch (see test_torch_geometry.test_decode_matches_fdt)."""
    seed, b, p, c, budget, cfg = case
    ours, theirs = _both(*_inputs(seed, b, p, c), budget=budget, **cfg)
    assert ours.shape == theirs.shape == (b, c, cfg["top_k"], 5)
    np.testing.assert_array_equal(ours[:, 0], 0.0)
    np.testing.assert_array_equal((ours[..., 0] > 0).sum(-1), (theirs[..., 0] > 0).sum(-1))
    np.testing.assert_array_equal(ours[..., 0], theirs[..., 0])
    np.testing.assert_allclose(ours[..., 1:], theirs[..., 1:], rtol=0, atol=1e-6)
    assert (ours[..., 0] > 0).sum() > 0


def test_ssd_detect_single_candidate_quirk_bit_equal():
    """One candidate above conf_thresh: the class is dropped (reference
    quirk), unless drop_single_candidate=False (cf. tests/test_pyramidbox.py)."""
    priors = np.array([[0.3, 0.3, 0.2, 0.2], [0.7, 0.7, 0.2, 0.2]], np.float32)
    loc = np.zeros((1, 2, 4), np.float32)
    conf = np.array([[[0.4, 0.6], [0.9, 0.1]]], np.float32)
    ours, theirs = _both(loc, conf, priors, conf_thresh=0.5, top_k=4)
    np.testing.assert_array_equal(ours, theirs)
    assert np.abs(ours).sum() == 0.0
    ours, theirs = _both(loc, conf, priors, conf_thresh=0.5, top_k=4,
                         drop_single_candidate=False)
    np.testing.assert_array_equal(ours, theirs)
    assert ours[0, 1, 0, 0] == pytest.approx(0.6, rel=1e-6)
