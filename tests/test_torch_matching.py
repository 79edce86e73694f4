"""fdt_torch's GT ↔ prior matchers and `encode` against fdt's
(fdt/geometry/matching.py, fdt/geometry/boxes.py).

Both matchers on the same padded GT and priors: conf_t bit-equal, loc_t
within 1e-6 (float32 log and division, last-bit differences between
libraries).  Cases: padded and invalid GT rows, an image with no valid GT,
two GTs whose best prior is the same one (the last GT wins), and tied
overlaps (argmax takes the first index).
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from fdt.geometry import boxes as jax_boxes  # noqa: E402
from fdt.geometry import matching as jax_matching  # noqa: E402
from fdt_torch.geometry import boxes, matching  # noqa: E402

torch.set_num_threads(1)

VARIANCES = (0.1, 0.2)
LOC_TOL = 1e-6
# fdt's batched matchers jitted (threshold and variances static): one compile
# a shape instead of one a jnp op
MATCHERS = {"default": (matching.match_default,
                        jax.jit(jax_matching.match_default_batch, static_argnums=(0, 5))),
            "ensure_max_prior": (matching.match_ensure_max_prior,
                                 jax.jit(jax_matching.match_ensure_max_prior_batch,
                                         static_argnums=(0, 5)))}


def grid_priors(n: int = 12, sizes=(0.1, 0.25)) -> np.ndarray:
    """Center-form priors on an n×n grid, one a size a cell."""
    c = (np.arange(n) + 0.5) / n
    cx, cy = np.meshgrid(c, c)
    return np.concatenate([np.stack([cx.ravel(), cy.ravel(), np.full(n * n, s),
                                     np.full(n * n, s)], -1) for s in sizes]).astype(np.float32)


def case(name: str):
    """(gt_boxes [B,G,4], gt_labels [B,G], gt_valid [B,G], priors [P,4])."""
    rng = np.random.RandomState(sum(map(ord, name)))
    priors = grid_priors()
    b, g = 3, 4
    xy = rng.rand(b, g, 2) * 0.7
    gt = np.concatenate([xy, xy + 0.05 + rng.rand(b, g, 2) * 0.25], -1).astype(np.float32)
    labels = np.zeros((b, g), np.int32)
    valid = np.ones((b, g), bool)
    if name == "padded-invalid":
        valid[0, 2:] = False
        valid[1, 1] = False
        gt[~valid] = 0.0                      # pad_targets' zero rows
        gt[1, 1] = [0.2, 0.2, 0.1, 0.1]       # an inverted box, invalid: ignored
    elif name == "no-gt-image":
        valid[1] = False
        gt[1] = 0.0
    elif name == "same-best-prior":
        # GTs 0 and 2 of image 0 are the same box: both claim one prior,
        # and the last one (2) must win; image 2 has three copies, the last
        # one invalid, so the middle copy wins
        gt[0, 2] = gt[0, 0]
        labels[0] = [0, 1, 2, 3]
        gt[2, 1] = gt[2, 2] = gt[2, 0]
        labels[2] = [5, 6, 7, 8]
        valid[2, 2] = False
    elif name == "tied-overlaps":
        # priors duplicated: every overlap ties with the copy's, and the two
        # GT boxes of image 0 are mirror images with equal overlaps on the
        # symmetric priors
        priors = np.concatenate([priors, priors])
        gt[0, 0] = [0.25, 0.25, 0.45, 0.45]
        gt[0, 1] = [0.55, 0.55, 0.75, 0.75]
        labels[0] = [3, 4, 0, 0]
    return gt, labels, valid, priors


CASES = ["random", "padded-invalid", "no-gt-image", "same-best-prior", "tied-overlaps"]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("matcher", list(MATCHERS))
@pytest.mark.parametrize("threshold", [0.35, 0.05])
def test_matching_matches_fdt(matcher, name, threshold):
    gt, labels, valid, priors = case(name)
    ours, theirs = MATCHERS[matcher]
    loc, conf = ours(threshold, torch.from_numpy(gt), torch.from_numpy(labels),
                     torch.from_numpy(valid), torch.from_numpy(priors), VARIANCES)
    loc_j, conf_j = theirs(threshold, jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid),
                           jnp.asarray(priors), VARIANCES)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(conf_j))
    np.testing.assert_allclose(loc.numpy(), np.asarray(loc_j), rtol=0, atol=LOC_TOL)
    assert np.isfinite(loc.numpy()).all()
    if name == "no-gt-image":
        assert not conf[1].any()
    if threshold == 0.35:
        assert (conf.numpy() > 0).any()


def test_last_gt_wins_and_invalid_rows_claim_nothing():
    """ensure_max_prior: the claimed prior of two identical GTs gets the
    later GT's label; an invalid copy after them does not claim it."""
    gt, labels, valid, priors = case("same-best-prior")
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    _, conf = matching.match_ensure_max_prior(0.35, t(gt), t(labels), t(valid), t(priors),
                                              VARIANCES)
    iou = boxes.iou_matrix(t(gt), boxes.point_form(t(priors)))
    best0 = int(iou[0, 0].argmax())
    assert int(conf[0, best0]) == labels[0, 2] + 1
    best2 = int(iou[2, 0].argmax())
    assert int(conf[2, best2]) == labels[2, 1] + 1


def test_encode_matches_fdt_and_inverts_decode():
    rng = np.random.RandomState(0)
    priors = grid_priors()
    xy = rng.rand(len(priors), 2) * 0.6
    matched = np.concatenate([xy, xy + 0.05 + rng.rand(len(priors), 2) * 0.3], -1).astype(np.float32)
    got = boxes.encode(torch.from_numpy(matched), torch.from_numpy(priors), VARIANCES)
    want = jax_boxes.encode(jnp.asarray(matched), jnp.asarray(priors), VARIANCES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOC_TOL)
    back = boxes.decode(got, torch.from_numpy(priors), VARIANCES)
    np.testing.assert_allclose(back.numpy(), matched, rtol=0, atol=1e-6)
