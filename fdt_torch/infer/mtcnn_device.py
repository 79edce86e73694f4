"""MTCNN cascade on the device (counterpart of fdt/infer/mtcnn_device.py).

The reference cascade (MTCNN/mtcnn/core/detect.py:246-620) runs a host
image pyramid, numpy NMS between the stages and a cv2 crop loop.  fdt
rebuilt it as one device program per image shape, and the port keeps that
design, with the batch as a leading dimension of every tensor:

  1. Pyramid atlas: each level resized with cv2.resize's fx-based bilinear
     taps (`_cv2_fx_taps`), rounded like the reference's uint8 levels, and
     stacked at even row offsets in one tall canvas.
  2. One PNet forward over the atlas; cells whose 12×12 window lies inside a
     level carry that level's id (`build_plan`), the others are masked.
  3. Top `pnet_cand_k` cells by score (a stable sort: ties keep index
     order, as lax.top_k), then every level's greedy NMS ('minimum' 0.4) in
     one call of kernel K1 with the level as segment id.
  4. Cross-level NMS ('union' 0.6), regression, then RNet on 24² crops of the
     zero-extended image, NMS ('union' 0.6), ONet on 48² crops, regression,
     landmarks and the final NMS ('minimum' 0.5); each through nms_padded,
     which is K1 with out_k on the card.

Every stage has a fixed candidate budget (`DeviceBudgets`); `saturated`
([B] bool) reports that a budget may have truncated the reference's
unbounded lists.  With `fast_budgets` the cascade runs a ladder of cheaper
budgets first and escalates on saturation, sticky per shape.

fdt's `pnet_impl="s2d"` is a TPU rearrangement of the same convolutions, so
the port runs the direct convolution; its `crop_impl` "gather" (fdt's choice
off the TPU) and "matmul" are both ported.  The crops compute only the rows
up to the batch's largest live count: one host read each for RNet and ONet.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from collections import OrderedDict

import numpy as np
import torch

from fdt_torch.config import MTCNN, MTCNNConfig
from fdt_torch.geometry.nms import nms_padded
from fdt_torch.infer.pyramidbox import _check_precision, _resolve_device, tf32_for
from fdt_torch.ops.nms import nms_keep_tiled

_STAGES = ("pnet", "rnet", "onet")
_CROP_IMPLS = ("gather", "matmul")


@dataclasses.dataclass(frozen=True)
class DeviceBudgets:
    """Static candidate-count caps of the fixed-shape cascade
    (fdt/infer/mtcnn_device.py:48-63)."""
    pnet_cand_k: int = 8192  # above-threshold cells entering per-level PNet NMS
    merge_k: int = 2048      # per-level survivors entering the cross-level NMS
    rnet_k: int = 2048       # crops entering RNet
    onet_k: int = 512        # crops entering ONet
    out_k: int = 256         # final detections returned


#: The cheapest tier, sized to typical scenes; `out_k` equals the full
#: budgets' so that every tier returns blocks of one shape
FAST_BUDGETS = DeviceBudgets(pnet_cand_k=2048, merge_k=512, rnet_k=512,
                             onet_k=128, out_k=256)

#: The middle tier, for 640×480 video frames that overflow FAST;
#: `fast_budgets=(FAST_BUDGETS, MID_BUDGETS)` is the ladder fast → mid → full
MID_BUDGETS = DeviceBudgets(pnet_cand_k=4096, merge_k=1024, rnet_k=1024,
                            onet_k=128, out_k=256)


@dataclasses.dataclass(frozen=True)
class PyramidPlan:
    """Static per-(h, w) pyramid layout and PNet cell→box constants."""
    h: int
    w: int
    levels: tuple  # ((lh, lw, y_off, scale), ...)
    atlas_h: int
    atlas_w: int
    map_h: int
    map_w: int
    cell_boxes: np.ndarray   # [map_h*map_w, 4] f32 (x1,y1,x2,y2 in image coords)
    cell_level: np.ndarray   # [map_h*map_w] int32, -1 for invalid cells


def _pnet_map_size(n: int) -> int:
    """PNet output extent for input extent n (conv3→pool2/2→conv3→conv3, VALID)."""
    return max((n - 2) // 2 - 4, 0)


def _scale_ladder(h: int, w: int, min_face_size: float, scale_factor: float):
    """The reference's pyramid ladder for an (h, w) image: [(lh, lw, s), ...]
    with lh/lw = rint(extent·s), cv2.resize's fx semantics (detect.py:277-284)."""
    net_size = 12
    s = net_size / min_face_size
    out = []
    lh, lw = int(np.rint(h * s)), int(np.rint(w * s))
    while min(lh, lw) > net_size:
        out.append((lh, lw, s))
        s *= scale_factor
        lh, lw = int(np.rint(h * s)), int(np.rint(w * s))
    return out


def n_pyramid_levels(h: int, w: int,
                     min_face_size: float = MTCNN.min_face_size,
                     scale_factor: float = MTCNN.scale_factor) -> int:
    """Length of the reference's pyramid ladder for an (h, w) image."""
    return len(_scale_ladder(h, w, min_face_size, scale_factor))


@functools.lru_cache(maxsize=256)
def build_plan(h: int, w: int, min_face_size: float = MTCNN.min_face_size,
               scale_factor: float = MTCNN.scale_factor,
               cell_size: int = MTCNN.cell_size,
               stride: int = MTCNN.stride,
               max_levels: int | None = None) -> PyramidPlan:
    """Scale ladder, atlas layout and cell→box maps for one image shape.

    Levels stack vertically at even row offsets, so that PNet's stride-2 pool
    grid stays aligned with each level's own grid.  max_levels truncates the
    ladder (the bucketed mode: a padded canvas would grow coarse levels that
    the native image never runs).
    """
    ladder = _scale_ladder(h, w, min_face_size, scale_factor)
    if max_levels is not None:
        ladder = ladder[:max_levels]
    levels = []
    y = 0
    for lh, lw, s in ladder:
        levels.append((lh, lw, y, s))
        y += lh + (lh % 2)  # keep offsets even
    if not levels:
        raise ValueError(f"image {h}x{w} smaller than the 12px net")
    atlas_h, atlas_w = y, max(lw_ for _, lw_, _, _ in levels)
    map_h, map_w = _pnet_map_size(atlas_h), _pnet_map_size(atlas_w)

    boxes = np.zeros((map_h, map_w, 4), np.float32)
    level_id = np.full((map_h, map_w), -1, np.int32)
    for li, (lh_, lw_, y_off, sc) in enumerate(levels):
        if min(lh_, lw_) < cell_size:
            continue
        i0 = y_off // 2
        vh = (lh_ - cell_size) // stride + 1
        vw = (lw_ - cell_size) // stride + 1
        ii = np.arange(vh)
        jj = np.arange(vw)
        # generate_bounding_box (detect.py:134-181): round(stride·cell / scale)
        x1 = np.round((stride * jj) / sc)
        y1 = np.round((stride * ii) / sc)
        x2 = np.round((stride * jj + cell_size) / sc)
        y2 = np.round((stride * ii + cell_size) / sc)
        sl = (slice(i0, i0 + vh), slice(0, vw))
        boxes[sl + (0,)] = x1[None, :]
        boxes[sl + (1,)] = y1[:, None]
        boxes[sl + (2,)] = x2[None, :]
        boxes[sl + (3,)] = y2[:, None]
        level_id[sl] = li
    return PyramidPlan(h, w, tuple(levels), atlas_h, atlas_w, map_h, map_w,
                       boxes.reshape(-1, 4), level_id.reshape(-1))


def _cv2_fx_taps(src: int, dst: int, fx: float):
    """Bilinear taps and weights of cv2.resize(im, None, fx=fx) along one axis.

    cv2 maps dst pixel u → src coordinate (u+0.5)/fx − 0.5 (the inverse of
    the requested factor, not the src/dst size ratio) and, at the borders,
    clamps the tap with its weight forced to 0."""
    g = (np.arange(dst) + 0.5) / fx - 0.5
    i0 = np.floor(g).astype(np.int32)
    f = (g - i0).astype(np.float32)
    f = np.where(i0 < 0, 0.0, f)
    i0 = np.maximum(i0, 0)
    f = np.where(i0 >= src - 1, 0.0, f).astype(np.float32)
    i0 = np.minimum(i0, src - 1).astype(np.int32)
    i1 = np.minimum(i0 + 1, src - 1).astype(np.int32)
    return i0, i1, f


def _resize_level(img255: torch.Tensor, lh: int, lw: int, fx: float) -> torch.Tensor:
    """cv2.resize(uint8 im, None, fx=fx) of [B, 3, H, W] integer-valued
    float32 images → [B, 3, lh, lw], rounded like the reference's uint8 level.

    Rows first, then columns, each output the two-term sum (1−f)·a + f·b, in
    float32: the sums of fdt's constant-matrix contractions, whose other
    terms are zeros (a border tap has f = 0)."""
    _, _, h, w = img255.shape
    dev = img255.device

    def taps(src, dst):
        i0, i1, f = _cv2_fx_taps(src, dst, fx)
        f = torch.from_numpy(f).to(dev)
        return (torch.from_numpy(i0).long().to(dev), torch.from_numpy(i1).long().to(dev),
                1.0 - f, f)

    i0, i1, wy0, wy1 = taps(h, lh)
    rows = img255[:, :, i0] * wy0[:, None] + img255[:, :, i1] * wy1[:, None]
    j0, j1, wx0, wx1 = taps(w, lw)
    return torch.round(rows[..., j0] * wx0 + rows[..., j1] * wx1)


def _atlas(img255: torch.Tensor, plan: PyramidPlan, extent=None) -> torch.Tensor:
    """The pyramid atlas [B, 3, atlas_h, atlas_w] of [B, 3, H, W] images:
    every level resized and placed at its row offset, zeros elsewhere.
    extent (bucketed mode): each level is zeroed past its native extent, so
    that windows inside the native level are untouched and windows across
    the seam see black."""
    b = img255.shape[0]
    dev = img255.device
    atlas = torch.zeros(b, 3, plan.atlas_h, plan.atlas_w, device=dev)
    for li, (lh, lw, y_off, s) in enumerate(plan.levels):
        lvl = _resize_level(img255, lh, lw, s)
        if extent is not None:
            nh, nw = extent[2][li]
            lvl = lvl * ((torch.arange(lh, device=dev) < nh)[:, None]
                         & (torch.arange(lw, device=dev) < nw)[None, :])
        atlas[:, :, y_off:y_off + lh, :lw] = lvl
    return atlas


def _fma(a, b, c) -> torch.Tensor:
    """a·b + c in float32 with one rounding, as fdt's compiled graph computes
    a multiply that feeds an add (XLA fuses the pair into one FMA); float64
    holds the product exactly."""
    return (a.double() * b.double() + c.double()).float()


def _recip(n: int) -> float:
    """The float32 reciprocal of n: fdt's compiled graph multiplies by it
    where the source divides by the constant n."""
    return float(np.float32(1.0 / n))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every b: [B, K, ...] by [B, M] → [B, M, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


def _top_k(scores: torch.Tensor, k: int):
    """lax.top_k's order on [B, N]: descending, ties by the lower index."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


def _apply_regression(boxes, reg, scores):
    """detect.py:336-348 / 445-452: offsets scaled by the inclusive box extent."""
    bw = boxes[..., 2] - boxes[..., 0] + 1.0
    bh = boxes[..., 3] - boxes[..., 1] + 1.0
    extent = torch.stack([bw, bh, bw, bh], dim=-1)
    return torch.cat([_fma(reg, extent, boxes[..., :4]), scores[..., None]], dim=-1)


def _square_round_clamp(boxes, eh: float, ew: float):
    """square_bbox + round + pad clamp (detect.py:102-131, 183-244, 414-415).

    Returns the clamped [..., 4] boxes (what flows onward) and the unclamped
    rounded origin and extent that the crop samples (the zero-padded `tmp`
    canvas of the reference).  eh/ew are the image's extent."""
    bw = boxes[..., 2] - boxes[..., 0] + 1.0
    bh = boxes[..., 3] - boxes[..., 1] + 1.0
    la = torch.maximum(bw, bh)
    x1f = boxes[..., 0] + bw * 0.5 - la * 0.5
    y1f = boxes[..., 1] + bh * 0.5 - la * 0.5
    x1 = torch.round(x1f)
    y1 = torch.round(y1f)
    x2 = torch.round(x1f + la - 1.0)
    y2 = torch.round(y1f + la - 1.0)
    tmpw = x2 - x1 + 1.0
    tmph = y2 - y1 + 1.0
    clamped = torch.stack([torch.clamp(x1, min=0.0), torch.clamp(y1, min=0.0),
                           torch.clamp(x2, max=ew - 1.0),
                           torch.clamp(y2, max=eh - 1.0)], dim=-1)
    return clamped, x1, y1, tmpw, tmph


def _window_coords(tmp, out_size: int):
    """cv2.resize's source coordinates, within the window, of an out_size
    crop of windows of extent tmp: [B, K] → [B, K, S]."""
    u = torch.arange(out_size, dtype=torch.float32, device=tmp.device) + 0.5
    hi = torch.clamp(tmp - 1.0, min=0.0)[..., None]
    s = _fma(u, (tmp * _recip(out_size))[..., None], torch.tensor(-0.5, device=tmp.device))
    return torch.minimum(torch.clamp(s, min=0.0), hi)


def _crop_resize(img255, x1, y1, tmpw, tmph, out_size: int, eh=None, ew=None):
    """Zero-pad crop + cv2.resize of [B, 3, H, W] images at [B, K] windows →
    [B, K, 3, S, S], by four bilinear taps (the "gather" form of
    fdt/infer/mtcnn_device.py:303-334).  Taps outside the image (its extent
    eh × ew when given) read 0, the reference's zero-padded canvas."""
    b, c, h, w = img255.shape
    eh = float(h) if eh is None else eh
    ew = float(w) if ew is None else ew
    gx = x1[..., None] + _window_coords(tmpw, out_size)
    gy = y1[..., None] + _window_coords(tmph, out_size)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0)[:, :, None, None, :]
    fy = (gy - y0)[:, :, None, :, None]
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    flat = img255.reshape(b, c, h * w)
    k = x1.shape[1]

    def fetch(yi, xi):
        iny = (yi >= 0) & (yi.float() < eh)
        inx = (xi >= 0) & (xi.float() < ew)
        idx = (yi.clamp(0, h - 1)[..., :, None] * w + xi.clamp(0, w - 1)[..., None, :]).long()
        px = torch.gather(flat, 2, idx.reshape(b, 1, -1).expand(b, c, -1))
        px = px.reshape(b, c, k, out_size, out_size).permute(0, 2, 1, 3, 4)
        return px * (iny[..., :, None] & inx[..., None, :])[:, :, None]

    def lerp(a, b, f):  # a·(1−f) + b·f, the product b·f rounded first
        return _fma(a, 1 - f, b * f)

    return lerp(lerp(fetch(y0, x0), fetch(y0, x0 + 1), fx),
                lerp(fetch(y0 + 1, x0), fetch(y0 + 1, x0 + 1), fx), fy)


def _crop_axis_weights(orig, tmp, n_src: int, out_size: int):
    """Interpolation weights of one axis of the zero-extended-window crop
    (the sampling of _crop_resize), one [B, K, S, n_src] matrix per tap;
    taps outside the image get weight 0 (the "matmul" form,
    fdt/infer/mtcnn_device.py:337-350, whose one matrix is their sum)."""
    g = _window_coords(tmp, out_size)
    i0 = torch.floor(g)
    f = g - i0
    a0 = orig[..., None] + i0
    r = torch.arange(n_src, dtype=torch.float32, device=orig.device)
    return ((r == a0[..., None]) * (1.0 - f)[..., None],
            (r == (a0 + 1.0)[..., None]) * f[..., None])


def _crop_matmul(img255, x1, y1, tmpw, tmph, out_size: int, eh=None, ew=None):
    """_crop_resize as contractions with per-crop weight matrices, in float32
    without TF32 (fdt's precision="highest" einsums).  Each axis contracts
    once per tap and adds the two: a row of the weights holds one nonzero
    per tap, so each output is the two-term float32 sum that fdt's
    contraction computes, whatever order the matmul sums in."""
    _, _, h, w = img255.shape
    wy = _crop_axis_weights(y1, tmph, h, out_size)
    wx = _crop_axis_weights(x1, tmpw, w, out_size)
    if eh is not None:  # a bucketed canvas: zero the taps past the image
        wy = [m * (torch.arange(h, dtype=torch.float32, device=m.device) < eh) for m in wy]
        wx = [m * (torch.arange(w, dtype=torch.float32, device=m.device) < ew) for m in wx]
    with tf32_for("highest"):
        rows = sum(torch.einsum("bkyh,bchw->bkcyw", m, img255) for m in wy)
        return sum(torch.einsum("bkxw,bkcyw->bkcyx", m, rows) for m in wx)


def _chunked_crop_forward(img255, x1, y1, tmpw, tmph, out_size: int, impl: str,
                          net, out_dims, active: int, chunk: int = 256,
                          eh=None, ew=None):
    """Crop + net forward over [B, K] candidates, `chunk` rows at a time, up
    to the batch's largest live count `active` (fdt's while_loop under vmap
    runs to the same bound, :353-411).  Candidates are score-sorted with the
    live rows first, so every live row is computed as in a whole sweep; rows
    past the computed chunks stay 0, and downstream masking ignores them.
    Returns one [B, K, d] float32 buffer per entry of out_dims."""
    b, k = x1.shape
    chunk = min(chunk, k)
    if k % chunk:
        chunk = k  # odd budgets: one block
    bufs = [torch.zeros(b, k, d, device=x1.device) for d in out_dims]
    crop = _crop_resize if impl == "gather" else _crop_matmul
    for c0 in range(0, math.ceil(active / chunk) * chunk, chunk):
        sl = slice(c0, c0 + chunk)
        crops = crop(img255, x1[:, sl], y1[:, sl], tmpw[:, sl], tmph[:, sl], out_size,
                     eh, ew)
        # round like the reference's uint8 crop canvas, then /255 (ToTensor)
        x = (torch.round(crops) * _recip(255)).reshape(-1, 3, out_size, out_size)
        for buf, out in zip(bufs, net(x)):
            buf[:, sl] = out.reshape(b, -1, out.shape[-1])
    return bufs


class MTCNNDeviceCascade:
    """MTCNN cascade on one device, every image of a batch at once.

    Args:
      pnet, rnet, onet: fdt_torch.models PNet / RNet / ONet with their
        weights (models.load_mtcnn_nets), moved to `device`.
      cfg: MTCNNConfig (thresholds, pyramid).
      budgets: the full DeviceBudgets; fast_budgets: one DeviceBudgets or a
        ladder of them, cheapest first, run before the full budgets.
      precision: "highest" (TF32 off) or "default" (TF32 allowed) for the
        nets; the "matmul" crops always run without TF32, as fdt's
        precision="highest" einsums.
      crop_impl: "gather" (four taps, the default) or "matmul".
      pnet_impl: "direct" only (fdt's "s2d" is a TPU layout of the same
        convolutions).
      device: None → "cuda" (raises if absent); "cpu" for the CPU.

    After each call `last_saturated` says whether a budget may have
    truncated candidates, and `last_tier` names the tier that answered.
    """

    def __init__(self, pnet, rnet, onet, cfg: MTCNNConfig = MTCNN,
                 budgets: DeviceBudgets = DeviceBudgets(),
                 precision: str = "highest", crop_impl: str | None = None,
                 pnet_impl: str | None = None,
                 fast_budgets: DeviceBudgets | tuple | None = None, device=None):
        if crop_impl is not None and crop_impl not in _CROP_IMPLS:
            raise ValueError(f"unknown crop_impl {crop_impl!r}; expected one of "
                             f"{_CROP_IMPLS}")
        if pnet_impl not in (None, "direct"):
            raise ValueError(f"pnet_impl {pnet_impl!r} is not ported: fdt's 's2d' is a "
                             "TPU layout of the same convolutions; use 'direct'")
        self.cfg = cfg
        self.budgets = budgets
        self.precision = _check_precision(precision)
        self.crop_impl = crop_impl or "gather"
        self.device = _resolve_device(device)
        self.pnet, self.rnet, self.onet = (
            m.eval().to(self.device, dtype=torch.float32) for m in (pnet, rnet, onet))
        if fast_budgets is None:
            self.tier_budgets: tuple = ()
        elif isinstance(fast_budgets, DeviceBudgets):
            self.tier_budgets = (fast_budgets,)
        else:
            self.tier_budgets = tuple(fast_budgets)
        self.tier_names = tuple("fast" if i == 0 else f"fast{i}"
                                for i in range(len(self.tier_budgets)))
        # shape key → ladder index to start at, LRU-bounded (an eviction only
        # forgets stickiness: the shape re-runs its cheaper tiers once)
        self._start_tier: OrderedDict = OrderedDict()
        self._start_tier_max = 256
        self._consts: OrderedDict = OrderedDict()  # plan key → device constants
        self._consts_max = 64
        self.last_saturated = False
        self.last_tier = None

    # ----- the cascade ----------------------------------------------------------
    def _plan(self, h: int, w: int, max_levels: int | None = None):
        """(plan, cell_boxes, cell_level) with the constants on the device."""
        key = (h, w, max_levels)
        if key not in self._consts:
            plan = build_plan(h, w, self.cfg.min_face_size, self.cfg.scale_factor,
                              self.cfg.cell_size, self.cfg.stride, max_levels)
            self._consts[key] = (plan, torch.from_numpy(plan.cell_boxes).to(self.device),
                                 torch.from_numpy(plan.cell_level).to(self.device))
            if len(self._consts) > self._consts_max:
                self._consts.popitem(last=False)
        self._consts.move_to_end(key)
        return self._consts[key]

    def _budgets_for(self, tier: str) -> DeviceBudgets:
        """Budgets of a tier name: "full" → self.budgets, "fast" → ladder[0],
        "fast<i>" → ladder[i]."""
        if tier == "full":
            return self.budgets
        return self.tier_budgets[0 if tier == "fast" else int(tier[4:])]

    def _images(self, images) -> torch.Tensor:
        """[B, H, W, 3] images (numpy or tensor, integer-valued) → [B, 3, H, W]
        float32 on the device."""
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.ascontiguousarray(images))
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected [B,H,W,3] images, got {tuple(images.shape)}")
        return images.to(self.device).permute(0, 3, 1, 2).float().contiguous()

    def _candidates(self, img255, budgets: DeviceBudgets, extent=None, max_levels=None):
        """Steps 1-3 up to the per-level NMS input: the atlas, PNet, the
        threshold and the top `pnet_cand_k` cells.  Returns (top scores
        [B, k], boxes [B, k, 4], regressions [B, k, 4], level ids [B, k]
        int32, saturated [B])."""
        b, _, h, w = img255.shape
        plan, cell_boxes, cell_level = self._plan(h, w, max_levels)
        cls_map, reg_map = self.pnet(_atlas(img255, plan, extent) * _recip(255))
        scores = cls_map[:, 0].reshape(b, -1)
        regs = reg_map.permute(0, 2, 3, 1).reshape(b, -1, 4)
        scores = torch.where((cell_level >= 0) & (scores > self.cfg.thresholds[0]),
                             scores, -torch.inf)
        k = min(budgets.pnet_cand_k, scores.shape[1])
        # a cap may have dropped candidates the reference would have carried
        sat = (scores > -torch.inf).sum(-1) > k
        top_s, top_i = _top_k(scores, k)
        return top_s, cell_boxes[top_i], _take(regs, top_i), cell_level[top_i], sat

    def _cascade(self, images, budgets: DeviceBudgets, stage: str = "onet", extent=None,
                 max_levels=None):
        """The cascade on [B, 3, H, W] float32 images up to `stage`.

        extent: None (the array is the image) or (eh, ew, [(lh, lw), ...]),
        the native image and level extents inside a padded canvas (bucketed
        mode).  Returns (boxes [B, n, 5], landmarks [B, n, 10] or the boxes'
        coordinates before ONet, count [B] int32, saturated [B] bool); rows
        past a count are arbitrary."""
        cfg, bud = self.cfg, budgets
        h, w = images.shape[-2:]
        eh, ew = (float(h), float(w)) if extent is None else extent[:2]
        mask_eh, mask_ew = (None, None) if extent is None else (eh, ew)
        arange = functools.partial(torch.arange, device=self.device)

        # 1-3. atlas, PNet, per-level NMS ('minimum' 0.4) in one K1 call
        top_s, top_b, top_r, top_lvl, sat = self._candidates(images, bud, extent, max_levels)
        keep = nms_keep_tiled(top_b, top_s > -torch.inf, cfg.pnet_nms_per_level,
                              mode="minimum", seg_id=top_lvl)

        # 4. cross-level merge NMS ('union' 0.6) and the regression
        flat_s = torch.where(keep, top_s, -torch.inf)
        sat |= (flat_s > -torch.inf).sum(-1) > bud.merge_k
        kidx, kcnt = nms_padded(top_b, flat_s, cfg.pnet_nms_merge, budget=bud.merge_k,
                                out_k=bud.merge_k, mode="union")
        sat |= kcnt == bud.merge_k
        m_scores = torch.where(arange(bud.merge_k) < kcnt[:, None], _take(flat_s, kidx),
                               -torch.inf)
        p_align = _apply_regression(_take(top_b, kidx), _take(top_r, kidx), m_scores)
        if stage == "pnet":
            return p_align, p_align[..., :4], kcnt, sat

        # 5. RNet (detect.py:352-465)
        r_in = min(bud.rnet_k, bud.merge_k)
        sat |= kcnt > r_in
        r_scores, r_sel = _top_k(m_scores, r_in)
        r_clamped, rx1, ry1, rtw, rth = _square_round_clamp(_take(p_align, r_sel), eh, ew)
        # the live candidates come first (-inf sorts last)
        active = int(torch.clamp(kcnt, max=r_in).max())
        r_cls, r_reg = _chunked_crop_forward(images, rx1, ry1, rtw, rth, 24, self.crop_impl,
                                             self.rnet, (1, 4), active, eh=mask_eh,
                                             ew=mask_ew)
        r_cls = r_cls[..., 0]
        # the RNet NMS orders by the PNet score (detect.py:431); the RNet
        # score replaces it only afterwards (detect.py:441)
        r_nms_s = torch.where((r_scores > -torch.inf) & (r_cls > cfg.thresholds[1]),
                              r_scores, -torch.inf)
        kidx, kcnt = nms_padded(r_clamped, r_nms_s, cfg.rnet_nms, budget=r_in,
                                out_k=bud.onet_k, mode="union")
        sat |= kcnt == bud.onet_k
        o_s = torch.where(arange(bud.onet_k) < kcnt[:, None], _take(r_cls, kidx), -torch.inf)
        r_align = _apply_regression(_take(r_clamped, kidx), _take(r_reg, kidx), o_s)
        if stage == "rnet":
            return r_align, r_align[..., :4], kcnt, sat

        # 6. ONet (detect.py:467-583)
        o_clamped, ox1, oy1, otw, oth = _square_round_clamp(r_align, eh, ew)
        o_cls, o_reg, o_lm = _chunked_crop_forward(
            images, ox1, oy1, otw, oth, 48, self.crop_impl, self.onet, (1, 4, 10),
            int(kcnt.max()), chunk=128, eh=mask_eh, ew=mask_ew)
        o_cls = o_cls[..., 0]
        f_s = torch.where((o_s > -torch.inf) & (o_cls > cfg.thresholds[2]), o_cls, -torch.inf)
        o_align = _apply_regression(o_clamped, o_reg, f_s)
        bw = o_clamped[..., 2] - o_clamped[..., 0] + 1.0
        bh = o_clamped[..., 3] - o_clamped[..., 1] + 1.0
        lm = torch.stack([_fma(o_lm[..., 0::2], bw[..., None], o_clamped[..., 0:1]),
                          _fma(o_lm[..., 1::2], bh[..., None], o_clamped[..., 1:2])],
                         dim=-1).reshape(*o_lm.shape)
        kidx, kcnt = nms_padded(o_align[..., :4], f_s, cfg.onet_nms, budget=bud.onet_k,
                                out_k=bud.out_k, mode="minimum")
        sat |= kcnt == bud.out_k
        return _take(o_align, kidx), _take(lm, kidx), kcnt, sat

    @torch.inference_mode()
    def _run(self, images, tier="full", **kw):
        with tf32_for(self.precision):
            return self._cascade(images, self._budgets_for(tier), **kw)

    def _run_tiered(self, run, shape_key):
        """The ladder: run(tier) for each tier from the shape's sticky start;
        the first run whose saturated flags are all False answers, else the
        full budgets do.  A tier that saturates is skipped for this shape
        from then on."""
        start = self._start_tier.get(shape_key, 0)
        if shape_key in self._start_tier:
            self._start_tier.move_to_end(shape_key)
        for i in range(start, len(self.tier_names)):
            out = run(self.tier_names[i])
            if not bool(out[3].any()):
                self.last_tier = self.tier_names[i]
                return out
            self._start_tier[shape_key] = i + 1
            self._start_tier.move_to_end(shape_key)
            if len(self._start_tier) > self._start_tier_max:
                self._start_tier.popitem(last=False)
        self.last_tier = "full"
        return run("full")

    # ----- host API -------------------------------------------------------------
    def detect_device(self, images):
        """[B, H, W, 3] images → (boxes [B, out_k, 5], landmarks
        [B, out_k, 10], counts [B] int32, saturated [B] bool), tensors on the
        device, through the ladder.  One saturated image sends the whole
        batch to the next tier."""
        x = self._images(images)
        out = self._run_tiered(lambda tier: self._run(x, tier), ("batch", x.shape[0], *x.shape[2:]))
        self.last_saturated = bool(out[3].any())
        return out

    def detect_batch(self, images):
        """detect_device as numpy arrays: (boxes [B, out_k, 5], landmarks
        [B, out_k, 10], counts [B], saturated [B] bool)."""
        return tuple(t.cpu().numpy() for t in self.detect_device(images))

    def detect_face(self, img: np.ndarray):
        """One [H, W, 3] image → (boxes [N, 5], landmarks [N, 10]), or two
        empty arrays; the contract of fdt's host MTCNNDetector.detect_face."""
        x = self._images(img[None])
        boxes, lm, count, sat = self._run_tiered(lambda tier: self._run(x, tier),
                                                 tuple(x.shape[2:]))
        return self._rows(boxes[0], lm[0], count[0], sat)

    def _rows(self, boxes, lm, count, sat):
        self.last_saturated = bool(sat.any())
        n = int(count)
        if n == 0:
            return np.array([]), np.array([])
        return boxes[:n].cpu().numpy(), lm[:n].cpu().numpy()

    def detect_stage(self, img: np.ndarray, stage: str) -> np.ndarray:
        """The cascade up to `stage` ("pnet" | "rnet" | "onet") at the full
        budgets → aligned boxes [N, 5] (the reference's per-stage returns)."""
        if stage not in _STAGES:
            raise ValueError(f"unknown stage {stage!r}; expected one of {_STAGES}")
        boxes, _, count, sat = self._run(self._images(img[None]), stage=stage)
        self.last_saturated = bool(sat.any())
        return boxes[0, :int(count[0])].cpu().numpy()

    def detect_face_bucketed(self, img: np.ndarray, multiple: int = 128):
        """detect_face on a canvas whose sides round up to `multiple`, so that
        images of many sizes share one canvas shape (fdt's bucketed mode,
        :703-764).  The last row and column are replicated one pixel into
        the canvas, the pyramid is cut to the native image's level count,
        each level is zeroed past its native extent, and the crops and clamps
        honour the native extent."""
        h, w = img.shape[:2]
        ch = -(-h // multiple) * multiple
        cw = -(-w // multiple) * multiple
        ladder = _scale_ladder(h, w, self.cfg.min_face_size, self.cfg.scale_factor)
        canvas = np.zeros((ch, cw, 3), img.dtype)
        canvas[:h, :w] = img
        if h < ch:
            canvas[h, :w] = img[h - 1]
        if w < cw:
            canvas[:h, w] = img[:, w - 1]
        if h < ch and w < cw:
            canvas[h, w] = img[h - 1, w - 1]
        extent = (float(h), float(w), [(lh, lw) for lh, lw, _ in ladder])
        x = self._images(canvas[None])
        boxes, lm, count, sat = self._run_tiered(
            lambda tier: self._run(x, tier, extent=extent, max_levels=len(ladder)),
            (ch, cw, len(ladder)))
        return self._rows(boxes[0], lm[0], count[0], sat)

    @torch.inference_mode()
    def pnet_candidates(self, images, tier: str = "full"):
        """The per-level NMS input of `tier` on [B, H, W, 3] images: (boxes
        [B, k, 4], valid [B, k], level ids [B, k] int32), for checking and
        timing K1 on the cascade's own candidates."""
        with tf32_for(self.precision):
            top_s, top_b, _, top_lvl, _ = self._candidates(self._images(images),
                                                           self._budgets_for(tier))
        return top_b, top_s > -torch.inf, top_lvl
