"""The cv2 operations that training augmentation needs, in numpy on the host.

  resize(image, dsize, fx, fy, interpolation) — cv2.resize of a float32
      [H, W, C] image with INTER_NEAREST, INTER_LINEAR, INTER_CUBIC,
      INTER_AREA or INTER_LANCZOS4 (cv2's integer codes, below);
  bgr_to_hsv / hsv_to_bgr — cv2.cvtColor COLOR_BGR2HSV / COLOR_HSV2BGR of
      a float32 image: H in [0, 360), S in [0, 1], V as the input.

The arithmetic is cv2's (imgproc/src/resize.cpp, color_hsv.simd.hpp): the
source coordinate of a destination pixel is computed in double and rounded
to float, the taps' weights are float32 (cubic A = -0.75, Lanczos over 8
taps, area fractions of the cell), borders replicate, and a pass is
horizontal first, then vertical, accumulated tap by tap in float32.  With
`fx`/`fy` the output is rint(W·fx) × rint(H·fy) and pixels map by the
factor, not by the ratio of the sizes, as cv2 does.  cv2's vector code may
fuse a multiply and an add where this does not: results agree to a few
float32 ulps of the pixel range (tests/test_torch_augment.py states the
bound).
"""
from __future__ import annotations

import math

import numpy as np

# cv2's interpolation codes
INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_LANCZOS4 = 0, 1, 2, 3, 4
FLT_EPSILON = np.float32(np.finfo(np.float32).eps)
_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45),
               (-1, 0), (_S45, _S45), (0, -1), (-_S45, _S45))


def _cubic(x: np.ndarray) -> np.ndarray:
    """cv2's interpolateCubic, A = -0.75, float32: [n] → [n, 4]."""
    a = np.float32(-0.75)
    one = np.float32(1)
    c0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], -1).astype(np.float32)


def _lanczos4(x: np.ndarray) -> np.ndarray:
    """cv2's interpolateLanczos4: [n] float32 → [n, 8] float32."""
    out = np.zeros((len(x), 8), np.float32)
    y0 = -(x.astype(np.float64) + 3) * math.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    total = np.zeros(len(x), np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):  # x = 0: fixed below
        for i, (cs, cc) in enumerate(_LANCZOS_CS):
            y = -(x.astype(np.float64) + 3 - i) * math.pi * 0.25
            out[:, i] = ((cs * s0 + cc * c0) / (y * y)).astype(np.float32)
            total += out[:, i]
        out *= (np.float32(1) / total)[:, None]
    small = x < FLT_EPSILON
    out[small] = 0
    out[small, 3] = 1
    return out


def _interp_taps(ssize: int, dsize: int, scale: float, method: int):
    """(source index [dsize, K], weight [dsize, K]) of one axis, cv2's
    resizeGeneric table with its border rules; `scale` = source / destination."""
    ksize = {INTER_LINEAR: 2, INTER_CUBIC: 4, INTER_LANCZOS4: 8}[method]
    half = ksize // 2
    d = np.arange(dsize, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if method == INTER_LINEAR:
        low, high = s < 0, s >= ssize - 1
        f[low], s[low] = 0, 0
        f[high], s[high] = 0, ssize - 1
        w = np.stack([np.float32(1) - f, f], -1)
    else:
        w = _cubic(f) if method == INTER_CUBIC else _lanczos4(f)
    idx = np.clip(s[:, None] - half + 1 + np.arange(ksize), 0, ssize - 1)
    return idx, w.astype(np.float32)


def _linear_area_taps(ssize: int, dsize: int, scale: float):
    """INTER_AREA where the image grows along an axis: cv2 turns it into a
    linear resize whose fraction is the covered share of the cell."""
    d = np.arange(dsize, dtype=np.float64)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) / scale).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    high = s >= ssize - 1
    f[high], s[high] = 0, ssize - 1
    idx = np.clip(s[:, None] + np.arange(2), 0, ssize - 1)
    return idx, np.stack([np.float32(1) - f, f], -1).astype(np.float32)


def _area_taps(ssize: int, dsize: int, scale: float):
    """cv2's computeResizeAreaTab: each destination pixel averages the source
    cells it covers, weighted by the covered fraction."""
    rows = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        taps += [(sx, np.float32(1.0 / cell)) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((dsize, k), np.int64)
    w = np.zeros((dsize, k), np.float32)
    for dx, taps in enumerate(rows):
        for j, (sx, a) in enumerate(taps):
            idx[dx, j], w[dx, j] = sx, a
    return idx, w


def _apply(image: np.ndarray, idx: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """Σ_k w[:, k] · image[idx[:, k]] along `axis`, tap by tap in float32."""
    out = None
    for k in range(idx.shape[1]):
        shape = [1] * image.ndim
        shape[axis] = -1
        term = np.take(image, idx[:, k], axis=axis) * w[:, k].reshape(shape)
        out = term if out is None else out + term
    return out


def resize(image: np.ndarray, dsize: tuple[int, int] | None = None, fx: float | None = None,
           fy: float | None = None, interpolation: int = INTER_LINEAR) -> np.ndarray:
    """cv2.resize(image, dsize, fx=fx, fy=fy, interpolation=...) of a float32
    [H, W] or [H, W, C] image.  dsize is (width, height); without it the
    output is rint(W·fx) × rint(H·fy)."""
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    if dsize is None:
        dw, dh = int(np.rint(w * fx)), int(np.rint(h * fy))
        if dw <= 0 or dh <= 0:
            raise ValueError(f"resize of {w}x{h} by {fx}, {fy} is empty")
        inv_x, inv_y = fx, fy
    else:
        dw, dh = dsize
        inv_x, inv_y = dw / w, dh / h
    if (dw, dh) == (w, h):
        return image.copy()
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    if interpolation == INTER_NEAREST:
        ix = np.minimum(np.floor(np.arange(dw) * scale_x).astype(np.int64), w - 1)
        iy = np.minimum(np.floor(np.arange(dh) * scale_y).astype(np.int64), h - 1)
        return image[iy][:, ix].copy()
    if interpolation == INTER_AREA and scale_x >= 1 and scale_y >= 1:
        tx, ty = _area_taps(w, dw, scale_x), _area_taps(h, dh, scale_y)
    elif interpolation == INTER_AREA:
        tx, ty = _linear_area_taps(w, dw, scale_x), _linear_area_taps(h, dh, scale_y)
    elif interpolation in (INTER_LINEAR, INTER_CUBIC, INTER_LANCZOS4):
        tx = _interp_taps(w, dw, scale_x, interpolation)
        ty = _interp_taps(h, dh, scale_y, interpolation)
    else:
        raise ValueError(f"unsupported interpolation {interpolation}")
    return _apply(_apply(image, *tx, axis=1), *ty, axis=0)


def bgr_to_hsv(image: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(image, COLOR_BGR2HSV) of a float32 [H, W, 3] image."""
    b, g, r = (image[..., i].astype(np.float32) for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + FLT_EPSILON)
    k = np.float32(60.0) / (diff + FLT_EPSILON)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + np.float32(120), (r - g) * k + np.float32(240)))
    h = np.where(h < 0, h + np.float32(360), h)
    return np.stack([h, s, v], -1).astype(np.float32)


# cv2's HSV → RGB sector table: which of (v, p, q, t) is b, g, r in sectors 0-5
_SECTORS = ((1, 1, 3, 0, 0, 2), (3, 0, 0, 2, 1, 1), (0, 2, 1, 1, 3, 0))


def hsv_to_bgr(image: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(image, COLOR_HSV2BGR) of a float32 [H, W, 3] image (H in
    degrees; any H wraps into [0, 360))."""
    h, s, v = (image[..., i].astype(np.float32) for i in range(3))
    h = h * np.float32(6.0 / 360.0)
    h = h - np.float32(6) * np.floor(h / np.float32(6))
    h = np.where(h >= 6, h - np.float32(6), h)
    sector = np.floor(h)
    h = h - sector
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, np.float32(0), sector)
    h = np.where(bad, np.float32(0), h)
    one = np.float32(1)
    tab = (v, v * (one - s), v * (one - s * h), v * (one - s * (one - h)))
    in_sector = [sector == k for k in range(6)]
    out = np.empty(image.shape, np.float32)
    for c, picks in enumerate(_SECTORS):
        out[..., c] = np.select(in_sector, [tab[k] for k in picks])
    gray = s == 0
    out[gray] = v[gray][:, None]
    return out
