"""fdt_torch's augmentation, resize and HSV conversions against fdt's
(fdt/data/augment.py) and cv2's.

No random draw depends on a pixel, so each augmentation function given a
RandomState of the same seed returns the boxes and labels fdt returns,
bit-equal, and leaves the RandomState where fdt's leaves it.  The pixels
carry the bounds below:

  * resize (fdt_torch.data.resize) against cv2.resize on float32 images in
    [0, 255]: within RESIZE_TOL = 2e-3 levels for INTER_LINEAR / CUBIC /
    AREA / LANCZOS4 (float32 sums in another order; measured 7.8e-4),
    bit-equal for INTER_NEAREST; output sizes equal;
  * the HSV conversions against cv2.cvtColor: within 1e-4 (H in degrees)
    and 1e-4 levels (measured 3.1e-5 and 1.5e-5);
  * photometric_distort and the whole pipeline: fdt truncates H to an
    integer (`% 180` of its int), so where the port's H lands a float32 ulp
    on the other side of an integer a pixel moves by up to
    v·s/60 ≈ 6.4 levels.  Held to PIXEL_MAX = 8 levels, at most
    PIXEL_OFF_SHARE = 5% of values off by more than 1e-2 (measured 1.7%),
    and a mean difference of at most PIXEL_MEAN = 1e-2 levels (measured
    2.6e-3); pyramid_normal_augment's output is divided by 256·std, so its
    bounds are those divided by 256·0.224.
"""
import pathlib
import sys

import cv2
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import fdt.data.augment as fdt_aug  # noqa: E402
import fdt_torch.data.augment as port_aug  # noqa: E402
from fdt_torch.data import resize as port_resize  # noqa: E402

RESIZE_TOL = 2e-3
HSV_TOL = 1e-4
PIXEL_MAX, PIXEL_OFF_SHARE, PIXEL_MEAN = 8.0, 0.05, 1e-2
NORMAL_SCALE = 256 * 0.224
INTERPS = {"nearest": cv2.INTER_NEAREST, "linear": cv2.INTER_LINEAR,
           "cubic": cv2.INTER_CUBIC, "area": cv2.INTER_AREA, "lanczos4": cv2.INTER_LANCZOS4}
BOXES = np.array([[0.2, 0.2, 0.3, 0.32], [0.6, 0.5, 0.68, 0.61]], np.float32)
LABELS = np.zeros(2, np.float32)


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded BGR image of gradients and mild noise (chip_smoke.photo_like)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 0.4) % 256, (yy * 0.5) % 256, (xx + yy) * 0.2 % 256], -1)
    return np.clip(img + rng.randint(-6, 7, (h, w, 3)), 0, 255).astype(np.uint8)


def same_state(a: np.random.RandomState, b: np.random.RandomState) -> bool:
    sa, sb = a.get_state(), b.get_state()
    return bool((sa[1] == sb[1]).all()) and sa[2:] == sb[2:]


def check_pixels(got, want, scale: float = 1.0):
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.float64) - want) * scale
    assert d.max() <= PIXEL_MAX, d.max()
    assert (d > 1e-2).mean() <= PIXEL_OFF_SHARE, (d > 1e-2).mean()
    assert d.mean() <= PIXEL_MEAN, d.mean()


@pytest.mark.parametrize("interp", list(INTERPS))
@pytest.mark.parametrize("factor", [0.37, 0.5, 0.8, 1.3, 2.0, 3.7])
def test_resize_by_factor_matches_cv2(interp, factor):
    """fx = fy (data_anchor_crop's call): cv2's rint size, and pixels mapped
    by the factor."""
    im = (np.random.RandomState(1).rand(37, 53, 3) * 255).astype(np.float32)
    want = cv2.resize(im, None, None, fx=factor, fy=factor, interpolation=INTERPS[interp])
    got = port_resize.resize(im, None, factor, factor, INTERPS[interp])
    assert got.shape == want.shape
    tol = 0.0 if interp == "nearest" else RESIZE_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("interp", list(INTERPS))
@pytest.mark.parametrize("dsize", [(20, 30), (60, 80), (53, 20), (20, 70), (53, 37)])
def test_resize_to_size_matches_cv2(interp, dsize):
    """dsize (resize_random_interp's call), down, up and mixed: INTER_AREA
    that grows along one axis and shrinks along the other is cv2's linear
    area mode."""
    im = (np.random.RandomState(2).rand(37, 53, 3) * 255).astype(np.float32)
    want = cv2.resize(im, dsize, interpolation=INTERPS[interp])
    got = port_resize.resize(im, dsize, interpolation=INTERPS[interp])
    tol = 0.0 if interp == "nearest" else RESIZE_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_hsv_conversions_match_cv2():
    rng = np.random.RandomState(3)
    im = (rng.rand(40, 50, 3) * 255).astype(np.float32)
    im[0, :3] = [[7, 7, 7], [0, 0, 0], [255, 255, 255]]     # gray: s = 0
    hsv = cv2.cvtColor(im, cv2.COLOR_BGR2HSV)
    np.testing.assert_allclose(port_resize.bgr_to_hsv(im), hsv, rtol=0, atol=HSV_TOL)
    np.testing.assert_allclose(port_resize.hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR),
                               rtol=0, atol=HSV_TOL)
    # the photometric quirks: H truncated and taken % 180, S scaled past 1
    quirk = hsv.copy()
    quirk[..., 0] = (quirk[..., 0].astype(int) + 11) % 180
    quirk[..., 1] *= 1.4
    np.testing.assert_allclose(port_resize.hsv_to_bgr(quirk),
                               cv2.cvtColor(quirk, cv2.COLOR_HSV2BGR), rtol=0, atol=HSV_TOL)


@pytest.mark.parametrize("seed", range(6))
def test_photometric_distort_matches_fdt(seed):
    im = photo(90 + 7 * seed, 120 + 5 * seed, seed).astype(np.float32)
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    check_pixels(port_aug.photometric_distort(im, r2), fdt_aug.photometric_distort(im, r1))
    assert same_state(r1, r2)


@pytest.mark.parametrize("seed", range(8))
def test_data_anchor_crop_matches_fdt(seed):
    """The crop's anchor, scale, interpolation and window draws; boxes and
    labels equal; the canvas padded with the mean where the window leaves the
    image (float64, as fdt's)."""
    im = photo(100 + 9 * seed, 140, seed).astype(np.float32)
    h, w = im.shape[:2]
    boxes = BOXES * np.array([w, h, w, h], np.float32)
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    want = fdt_aug.data_anchor_crop(im, boxes, LABELS, r1)
    got = port_aug.data_anchor_crop(im, boxes, LABELS, r2)
    assert same_state(r1, r2)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=RESIZE_TOL)


def test_data_anchor_crop_without_boxes_resizes():
    im = photo(50, 70, 0).astype(np.float32)
    r1, r2 = np.random.RandomState(0), np.random.RandomState(0)
    want = fdt_aug.data_anchor_crop(im, np.zeros((0, 4), np.float32), LABELS[:0], r1)
    got = port_aug.data_anchor_crop(im, np.zeros((0, 4), np.float32), LABELS[:0], r2)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=RESIZE_TOL)
    assert got[1].shape == want[1].shape == (0, 4) and same_state(r1, r2)


@pytest.mark.parametrize("seed", range(4))
def test_expand_and_mirror_match_fdt(seed):
    im = photo(30, 40, seed).astype(np.float32)
    boxes = BOXES * np.array([40, 30, 40, 30], np.float32)
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    for fn in ("expand", "random_mirror"):
        a_im, a_b = getattr(fdt_aug, fn)(im, boxes, r1)
        b_im, b_b = getattr(port_aug, fn)(im, boxes, r2)
        np.testing.assert_array_equal(b_im, a_im)
        np.testing.assert_array_equal(b_b, a_b)
    assert same_state(r1, r2)


@pytest.mark.parametrize("seed", range(5))
def test_resize_random_interp_matches_fdt(seed):
    im = photo(70, 90, seed).astype(np.float32)
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    want = fdt_aug.resize_random_interp(im, 64, r1)
    got = port_aug.resize_random_interp(im, 64, r2)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)
    assert same_state(r1, r2)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("normal", [False, True], ids=["pyramid", "normal"])
def test_pipeline_matches_fdt(seed, normal):
    """pyramid_augment / pyramid_normal_augment on a uint8 image at 160²."""
    im = photo(120 + 7 * seed, 160 + 5 * seed, seed)
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    name = "pyramid_normal_augment" if normal else "pyramid_augment"
    want = getattr(fdt_aug, name)(im, BOXES, LABELS, r1, 160)
    got = getattr(port_aug, name)(im, BOXES, LABELS, r2, 160)
    assert same_state(r1, r2)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    check_pixels(got[0], want[0], NORMAL_SCALE if normal else 1.0)


def test_base_transform_within_one_level_of_cv2():
    im = photo(45, 61, 1)
    want = fdt_aug.base_transform(im, 32)
    got = port_aug.base_transform(im, 32)
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 1.0
    np.testing.assert_allclose(port_aug.base_transform(im.astype(np.float32), 32),
                               fdt_aug.base_transform(im.astype(np.float32), 32),
                               rtol=0, atol=RESIZE_TOL)
