"""fdt_torch's MTCNN (config, pyramid plan, resize taps, PNet/RNet/ONet,
loader, atlas, serving, goldens) against fdt's, on the CPU, and the helpers
that tests/test_torch_mtcnn_{gather,matmul,ladder}.py share: the seeded
cascades of both packages, a trace of fdt's compiled cascade with its
intermediates, the guard that a comparison is well posed and the row
comparison.

Weights come from chip_smoke.mtcnn_variables (the reference .pt files are not
in the repo) in two settings, "sparse" and "saturated".  The 480×640 golden
that chip_smoke.py checks on the card is written by

    python tests/test_torch_mtcnn.py --write-golden

(fdt's cascade, float32 precision "highest", on the CPU), and re-made and
compared by the slow test below.
"""
import argparse
import contextlib
import functools
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
import fdt.infer.mtcnn_device as jmd  # noqa: E402
from fdt.models.mtcnn import ONet as JaxONet  # noqa: E402
from fdt.models.mtcnn import PNet as JaxPNet  # noqa: E402
from fdt.models.mtcnn import RNet as JaxRNet  # noqa: E402
from fdt_torch.apps.serving import DetectionService, resize_bilinear  # noqa: E402
from fdt_torch.infer import mtcnn_device as md  # noqa: E402
from fdt_torch.models import (ONet, PNet, RNet, from_jax_variables,  # noqa: E402
                              load_mtcnn_cascade, load_mtcnn_nets)
from tests.test_torch_seeded import nest_like  # noqa: E402

torch.set_num_threads(1)

SETTINGS = tuple(chip_smoke.MTCNN_SHIFTS)  # "saturated", "sparse"
# a comparison of fdt and the port is well posed when no decision of fdt's
# cascade sits nearer its threshold than the two packages' scores can differ:
# RNet's and ONet's thresholds by MARGIN; PNet's threshold and the top-k cut
# by PNET_MARGINS times the largest PNet probability difference measured on
# the frame itself (a threshold needs more than that difference, a cut
# between two scores more than twice it).  Thousands of cells crowd PNet's
# threshold, many nearer than 1e-4, while the two packages' probabilities
# differ in the last bits of float32, so a fixed 1e-4 would refuse every
# frame.
MARGIN = 1e-4
PNET_MARGINS = 4
SCORE_TOL, PX_TOL = 1e-5, 1e-3  # the whole cascade: scores, pixels


@functools.lru_cache(maxsize=None)
def flat_variables(setting: str) -> tuple:
    return chip_smoke.mtcnn_variables(setting)


@functools.lru_cache(maxsize=None)
def fdt_variables(setting: str) -> tuple:
    return tuple(nest_like(v, m, s) for v, m, s in
                 zip(flat_variables(setting), (JaxPNet(), JaxRNet(), JaxONet()), (12, 24, 48)))


def fdt_cascade(setting: str, crop_impl: str = "gather", **kw):
    """fdt's cascade on the CPU, float32 precision "highest", direct PNet."""
    kw.setdefault("budgets", jmd.FAST_BUDGETS)
    return jmd.MTCNNDeviceCascade(*fdt_variables(setting), precision="highest",
                                  crop_impl=crop_impl, pnet_impl="direct", **kw)


def port_cascade(setting: str, crop_impl: str = "gather", **kw):
    kw.setdefault("budgets", md.FAST_BUDGETS)
    return md.MTCNNDeviceCascade(*load_mtcnn_nets(*flat_variables(setting)),
                                 crop_impl=crop_impl, device="cpu", **kw)


def frame(seed: int, h: int, w: int) -> np.ndarray:
    return chip_smoke.golden_frame(seed, h, w)


_sink: list = [None]  # the trace a compiled traced cascade writes into
_traced: dict = {}     # compiled traced cascades, by cascade, shape and budgets


def fdt_trace(cascade, image: np.ndarray, budgets, extent=None, max_levels=None) -> dict:
    """fdt's compiled cascade on one image, with its intermediates.

    While the cascade is traced, the module's NMS calls, its crop forwards,
    lax.top_k and the PNet apply are wrapped so that each sends its inputs
    and outputs to the host by jax.debug.callback; the arithmetic is that of
    the compiled graph.  Returns {"plan", "pnet": [(input, probabilities,
    regressions)], "top_k": [(scores, values, indices)] (PNet's cells, then
    RNet's input), "nms_keep_mask": [(boxes, valid, seg_id, keep)],
    "nms_padded": [(boxes, scores, indices, count)] (merge, RNet, final),
    "crop24"/"crop48": [(x1, y1, tmpw, tmph, active, *outputs)],
    "crops24"/"crops48": [round(crops) / 255 of each chunk], "out": [boxes,
    landmarks, count, saturated]}."""
    h, w = image.shape[:2]
    plan = jmd.build_plan(h, w, max_levels=max_levels)
    rec = _sink[0] = {"plan": plan}
    args = (cascade.vars, jnp.asarray(image)) + (() if extent is None else (extent,))
    key = (id(cascade), h, w, budgets, max_levels, extent is None)
    if key in _traced:
        out = _traced[key](*args)
    else:  # the first call traces, and sees the wrappers
        fn = _traced[key] = jax.jit(functools.partial(cascade._cascade, plan,
                                                      budgets=budgets))
        with _recording(cascade):
            out = fn(*args)
    jax.effects_barrier()
    _sink[0] = None
    rec["out"] = [np.asarray(o) for o in out]
    return rec


@contextlib.contextmanager
def _recording(cascade):
    """fdt's module functions and the cascade's PNet wrapped to send their
    inputs and outputs to _sink[0]."""
    def put(name):
        return lambda *v: _sink[0].setdefault(name, []).append(tuple(map(np.asarray, v)))

    saved = {n: getattr(jmd, n) for n in ("nms_keep_mask", "nms_padded",
                                          "_chunked_crop_forward")}
    top_k, pnet = jax.lax.top_k, cascade.pnet
    inside_nms = [False]

    class PNetRecorder:
        def apply(self, variables, x):
            out = pnet.apply(variables, x)
            jax.debug.callback(put("pnet"), x, *out, ordered=True)
            return out

    def keep_mask(boxes, valid, thresh, **kw):
        out = saved["nms_keep_mask"](boxes, valid, thresh, **kw)
        jax.debug.callback(put("nms_keep_mask"), boxes, valid, kw["seg_id"], out, ordered=True)
        return out

    def padded(boxes, scores, thresh, **kw):
        inside_nms[0] = True  # its own top_k is not the cascade's
        out = saved["nms_padded"](boxes, scores, thresh, **kw)
        inside_nms[0] = False
        jax.debug.callback(put("nms_padded"), boxes, scores, *out, ordered=True)
        return out

    def crop_forward(img255, h, w, x1, y1, tmpw, tmph, size, impl, apply_fn, dims, active,
                     **kw):
        def apply(crops):
            jax.debug.callback(put(f"crops{size}"), crops, ordered=True)
            return apply_fn(crops)

        out = saved["_chunked_crop_forward"](img255, h, w, x1, y1, tmpw, tmph, size, impl,
                                             apply, dims, active, **kw)
        jax.debug.callback(put(f"crop{size}"), x1, y1, tmpw, tmph, active, *out, ordered=True)
        return out

    def recorded_top_k(x, k):
        out = top_k(x, k)
        if not inside_nms[0]:
            jax.debug.callback(put("top_k"), x, *out, ordered=True)
        return out

    try:
        jmd.nms_keep_mask, jmd.nms_padded, jmd._chunked_crop_forward = (
            keep_mask, padded, crop_forward)
        jax.lax.top_k, cascade.pnet = recorded_top_k, PNetRecorder()
        yield
    finally:
        for name, f in saved.items():
            setattr(jmd, name, f)
        jax.lax.top_k, cascade.pnet = top_k, pnet


def score_deltas(port, trace, image, native=None) -> dict:
    """Largest |port − fdt| of each net's probabilities on this frame: PNet on
    fdt's own atlas, RNet and ONet on the port's crops of fdt's windows
    (taps past `native`, the image's (h, w) in a bucketed canvas, read 0)."""
    x, cls, _ = trace["pnet"][0]
    with torch.no_grad():
        ours = port.pnet(torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous())[0]
    deltas = {"pnet": float(np.abs(ours[:, 0].numpy() - cls[..., 0]).max())}
    img255 = torch.from_numpy(image).permute(2, 0, 1)[None].float()
    for size, net in ((24, port.rnet), (48, port.onet)):
        x1, y1, tmpw, tmph, active, probs = trace[f"crop{size}"][0][:6]
        active = int(active)
        window = [_t(a[:active]) for a in (x1, y1, tmpw, tmph)]
        with torch.no_grad():
            eh, ew = native or (None, None)
            ours = md._chunked_crop_forward(img255, *window, size, port.crop_impl, net,
                                            (1,), active, eh=eh, ew=ew)[0]
        deltas[size] = float(np.abs(ours[0, :, 0].numpy() - probs[:active, 0]).max(initial=0))
    return deltas


def assert_well_posed(trace, deltas: dict, cfg=jmd.MTCNN) -> None:
    """No decision of fdt's cascade on this frame sits nearer its threshold
    than the two packages' scores differ on it (`deltas`, from score_deltas),
    by a factor PNET_MARGINS: PNet's threshold over the valid cells and the
    top-`pnet_cand_k` cut; RNet's and ONet's thresholds over their live
    candidates, and those by MARGIN at least."""
    pnet_margin = PNET_MARGINS * deltas["pnet"]
    scores, values, _ = trace["top_k"][0]
    cls = trace["pnet"][0][1][0, ..., 0].reshape(-1)
    near = np.abs(cls[trace["plan"].cell_level >= 0] - cfg.thresholds[0]).min(initial=np.inf)
    assert near > pnet_margin, (
        f"fdt's PNet score within {near:.3g} of its threshold (margin {pnet_margin:.3g}): "
        "the comparison is ill posed on this frame")
    live = np.sort(scores[np.isfinite(scores)])[::-1]
    if len(live) > len(values):
        gap = live[len(values) - 1] - live[len(values)]
        assert gap > pnet_margin, (
            f"fdt's top-{len(values)} cut falls between scores {gap:.3g} apart (margin "
            f"{pnet_margin:.3g}): the comparison is ill posed on this frame")
    for size, thresh in ((24, cfg.thresholds[1]), (48, cfg.thresholds[2])):
        *_, active, cls_out = trace[f"crop{size}"][0][:6]
        need = max(MARGIN, PNET_MARGINS * deltas[size])
        near = np.abs(cls_out[:int(active), 0] - thresh).min(initial=np.inf)
        assert near > need, (
            f"fdt's {'RNet' if size == 24 else 'ONet'} score within {near:.3g} of its "
            f"threshold (margin {need:.3g}): the comparison is ill posed on this frame")


def assert_rows_match(got_boxes, got_lm, want_boxes, want_lm, score_tol: float = SCORE_TOL,
                      px_tol: float = PX_TOL) -> None:
    """chip_smoke.match_detections at the whole cascade's tolerances: equal
    counts, scores within score_tol position by position, boxes and
    landmarks within px_tol of their row or, for a near-tied swap, of a
    nearby row whose score is within score_tol."""
    chip_smoke.match_detections(got_boxes, got_lm, want_boxes, want_lm, score_tol, px_tol)


def _t(a) -> torch.Tensor:
    """numpy (fdt's arrays, one image) → a batch of one on the CPU."""
    return torch.from_numpy(np.array(a))[None]


def _assert_nms_equal(trace_call, thresh: float, mode: str, budget: int, out_k: int) -> int:
    """The port's nms_padded on fdt's own input gives fdt's count and kept
    indices.  Returns the count."""
    from fdt_torch.geometry.nms import nms_padded
    boxes, scores, idx, count = trace_call
    got_idx, got_count = nms_padded(_t(boxes), _t(scores), thresh, budget=budget, out_k=out_k,
                                    mode=mode)
    c = int(count)
    assert int(got_count[0]) == c
    np.testing.assert_array_equal(got_idx[0, :c].numpy(), idx[:c])
    return c


def _assert_crops_and_net(port, trace, size: int, net, crop_impl: str, image,
                          flips: float) -> None:
    """The port's crops of fdt's windows equal fdt's compiled crops but for
    one gray level on at most a share `flips` of the values; the port's net
    on fdt's own crops gives fdt's outputs within 1e-5 (probabilities) and
    1e-5 of their scale."""
    x1, y1, tmpw, tmph, active, *outs = trace[f"crop{size}"][0]
    active = int(active)
    if not active:
        return
    fdt_crops = np.concatenate([c[0] for c in trace[f"crops{size}"]])[:active]
    img255 = torch.from_numpy(image).permute(2, 0, 1)[None].float()
    crop = md._crop_resize if crop_impl == "gather" else md._crop_matmul
    ours = crop(img255, *(_t(a[:active]) for a in (x1, y1, tmpw, tmph)), size)
    ours = (torch.round(ours) * md._recip(255))[0].permute(0, 2, 3, 1).numpy()
    diff = np.abs(ours - fdt_crops) * 255
    assert diff.max() <= 1.0 + 1e-3
    assert (diff > 1e-3).sum() <= flips * diff.size, int((diff > 1e-3).sum())
    with torch.no_grad():
        got = net(torch.from_numpy(np.array(fdt_crops)).permute(0, 3, 1, 2).contiguous())
    for j, (g, w) in enumerate(zip(got, outs)):
        w = w[:active]
        tol = 1e-5 if j == 0 else 1e-5 * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)


def check_stages(setting: str, crop_impl: str, image: np.ndarray, flips: float = 1e-5) -> None:
    """Each stage of the port fed fdt's own inputs, from a trace of fdt's
    compiled cascade at FAST_BUDGETS: the atlas; PNet; the top-k order; the
    per-level keep mask (K1's plain version, segmented); the merge; the glue
    from the merge to RNet's crop windows (regression, top-k, square, round,
    clamp), bit-equal; RNet's crops and outputs; its NMS; the glue to ONet's
    windows; ONet's crops and outputs; the final NMS; then the counts of the
    port's own stages and its saturated flag."""
    from fdt_torch.ops.nms import nms_keep_tiled
    cfg, bud = jmd.MTCNN, jmd.FAST_BUDGETS
    h, w = image.shape[:2]
    jc, port = fdt_cascade(setting, crop_impl), port_cascade(setting, crop_impl)
    tr = fdt_trace(jc, image, bud)

    # atlas and PNet
    x, cls, reg = tr["pnet"][0]
    img255 = torch.from_numpy(image).permute(2, 0, 1)[None].float()
    atlas = (md._atlas(img255, md.build_plan(h, w)) * md._recip(255)).permute(0, 2, 3, 1)
    assert (np.abs(atlas.numpy() - x) * 255 > 1e-3).sum() <= 1e-5 * x.size
    with torch.no_grad():
        pc, pr = port.pnet(torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(pc.permute(0, 2, 3, 1).numpy(), cls, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pr.permute(0, 2, 3, 1).numpy(), reg, rtol=0,
                               atol=1e-5 * np.abs(reg).max())

    # the top-k order over fdt's thresholded scores (ties: the lower index)
    scores, values, top_i = tr["top_k"][0]
    got_v, got_i = md._top_k(_t(scores), len(values))
    np.testing.assert_array_equal(got_v[0].numpy(), values)
    np.testing.assert_array_equal(got_i[0].numpy(), top_i)

    # the per-level NMS ('minimum', segmented by level)
    boxes, valid, seg, keep = tr["nms_keep_mask"][0]
    got_keep = nms_keep_tiled(_t(boxes), _t(valid), cfg.pnet_nms_per_level, mode="minimum",
                              seg_id=_t(seg))
    np.testing.assert_array_equal(got_keep[0].numpy(), keep)

    # the merge and the glue to RNet's windows
    flat_s = tr["nms_padded"][0][1]
    np.testing.assert_array_equal(flat_s, np.where(keep, values, -np.inf).astype(np.float32))
    count = _assert_nms_equal(tr["nms_padded"][0], cfg.pnet_nms_merge, "union", bud.merge_k,
                              bud.merge_k)
    kidx = torch.from_numpy(tr["nms_padded"][0][2].astype(np.int64))[None]
    m_scores = torch.where(torch.arange(bud.merge_k) < count, md._take(_t(flat_s), kidx),
                           -torch.inf)
    top_r = torch.from_numpy(reg.reshape(-1, 4)[top_i])[None]
    p_align = md._apply_regression(md._take(_t(boxes), kidx), md._take(top_r, kidx), m_scores)
    fdt_m, r_values, r_sel = tr["top_k"][1]
    np.testing.assert_array_equal(m_scores[0].numpy(), fdt_m)
    got_v, got_sel = md._top_k(m_scores, len(r_values))
    np.testing.assert_array_equal(got_sel[0].numpy(), r_sel)
    r_clamped, *window = md._square_round_clamp(md._take(p_align, got_sel), float(h), float(w))
    for got, want in zip(window, tr["crop24"][0][:4]):
        np.testing.assert_array_equal(got[0].numpy(), want)

    # RNet, its NMS, the glue to ONet's windows
    _assert_crops_and_net(port, tr, 24, port.rnet, crop_impl, image, flips)
    r_boxes, r_nms_s = tr["nms_padded"][1][:2]
    np.testing.assert_array_equal(r_clamped[0].numpy(), r_boxes)
    r_cls, r_reg = tr["crop24"][0][5:7]
    np.testing.assert_array_equal(
        r_nms_s, np.where(np.isfinite(r_values) & (r_cls[:, 0] > cfg.thresholds[1]), r_values,
                          -np.inf).astype(np.float32))
    count = _assert_nms_equal(tr["nms_padded"][1], cfg.rnet_nms, "union", len(r_values),
                              bud.onet_k)
    kidx = torch.from_numpy(tr["nms_padded"][1][2].astype(np.int64))[None]
    o_s = torch.where(torch.arange(bud.onet_k) < count, md._take(_t(r_cls[:, 0]), kidx),
                      -torch.inf)
    r_align = md._apply_regression(md._take(r_clamped, kidx), md._take(_t(r_reg), kidx), o_s)
    _, *window = md._square_round_clamp(r_align, float(h), float(w))
    for got, want in zip(window, tr["crop48"][0][:4]):
        np.testing.assert_array_equal(got[0].numpy(), want)

    # ONet and the final NMS
    _assert_crops_and_net(port, tr, 48, port.onet, crop_impl, image, flips)
    final = _assert_nms_equal(tr["nms_padded"][2], cfg.onet_nms, "minimum", bud.onet_k,
                              bud.out_k)

    # the port's own stages: counts and the saturated flag
    x = port._images(image[None])
    counts = [int(tr["nms_padded"][i][3]) for i in range(3)]
    for stage, want in zip(("pnet", "rnet", "onet"), counts):
        _, _, got, sat = port._run(x, stage=stage)
        assert int(got[0]) == want, stage
    assert final == counts[2] and bool(sat[0]) == bool(tr["out"][3])


def guard(fdt, port, image, extent=None, max_levels=None) -> None:
    """assert_well_posed for one image, from its trace at FAST_BUDGETS."""
    trace = fdt_trace(fdt, image, jmd.FAST_BUDGETS, extent, max_levels)
    native = None if extent is None else tuple(float(v) for v in extent[0])
    assert_well_posed(trace, score_deltas(port, trace, image, native))


def bucketed_inputs(image: np.ndarray, multiple: int = 128):
    """fdt's bucketed canvas, extent and level count for one image
    (fdt/infer/mtcnn_device.py:737-755), for its trace."""
    h, w = image.shape[:2]
    ch, cw = -(-h // multiple) * multiple, -(-w // multiple) * multiple
    ladder = jmd._scale_ladder(h, w, jmd.MTCNN.min_face_size, jmd.MTCNN.scale_factor)
    canvas = np.zeros((ch, cw, 3), image.dtype)
    canvas[:h, :w] = image
    canvas[h, :w] = image[h - 1]
    canvas[:h, w] = image[:, w - 1]
    canvas[h, w] = image[h - 1, w - 1]
    extent = (jnp.asarray([h, w], jnp.float32),
              jnp.asarray(np.array([(lh, lw) for lh, lw, _ in ladder], np.float32)))
    return canvas, extent, len(ladder)


def check_cascade(setting: str, crop_impl: str, score_tol: float = SCORE_TOL,
                  px_tol: float = PX_TOL) -> None:
    """The whole cascade of both packages at FAST_BUDGETS, after the guard:
    detect_batch on two 120×160 frames, detect_face and detect_stage of each
    stage on a 96×128 frame, detect_face_bucketed on a 100×120 frame (a
    128×128 canvas): equal counts and saturated flags, rows by
    assert_rows_match."""
    jc, port = fdt_cascade(setting, crop_impl), port_cascade(setting, crop_impl)
    match = functools.partial(assert_rows_match, score_tol=score_tol, px_tol=px_tol)
    images = np.stack([frame(s, 120, 160) for s in (1, 2)])
    for im in images:
        guard(jc, port, im)
    want, got = jc.detect_batch(images), port.detect_batch(images)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert (want[2] > 0).all()
    for i, c in enumerate(want[2]):
        match(got[0][i, :c], got[1][i, :c], want[0][i, :c], want[1][i, :c])

    im = frame(3, 96, 128)
    guard(jc, port, im)
    (wb, wl), (gb, gl) = jc.detect_face(im), port.detect_face(im)
    assert port.last_saturated == jc.last_saturated and len(wb) > 0
    match(gb, gl, wb, wl)
    for stage in ("pnet", "rnet", "onet"):
        want_b, got_b = jc.detect_stage(im, stage), port.detect_stage(im, stage)
        assert port.last_saturated == jc.last_saturated, stage
        match(got_b, got_b[:, :0], want_b, want_b[:, :0])

    im = frame(4, 100, 120)
    canvas, extent, levels = bucketed_inputs(im)
    guard(jc, port, canvas, extent=extent, max_levels=levels)
    (wb, wl), (gb, gl) = jc.detect_face_bucketed(im), port.detect_face_bucketed(im)
    assert port.last_saturated == jc.last_saturated and len(wb) > 0
    match(gb, gl, wb, wl)


# --- the pyramid plan and the resize taps ------------------------------------------------

@pytest.mark.parametrize("h,w", [(120, 160), (96, 128), (480, 640), (13, 13), (37, 200),
                                 (720, 1280)])
def test_build_plan_bit_equal(h, w):
    ours, theirs = md.build_plan(h, w), jmd.build_plan(h, w)
    assert ours.levels == theirs.levels
    assert (ours.atlas_h, ours.atlas_w, ours.map_h, ours.map_w) == (
        theirs.atlas_h, theirs.atlas_w, theirs.map_h, theirs.map_w)
    np.testing.assert_array_equal(ours.cell_boxes, theirs.cell_boxes)
    np.testing.assert_array_equal(ours.cell_level, theirs.cell_level)
    assert ours.cell_boxes.dtype == np.float32 and ours.cell_level.dtype == np.int32
    assert md.n_pyramid_levels(h, w) == jmd.n_pyramid_levels(h, w)
    truncated = md.build_plan(h, w, max_levels=1)
    assert truncated.levels == jmd.build_plan(h, w, max_levels=1).levels


def test_bench_shape_plan():
    """480×640: 11 levels, a 1618×640 atlas, an 804×315 PNet map with
    144,944 valid cells."""
    plan = md.build_plan(480, 640)
    assert len(plan.levels) == 11 and (plan.atlas_h, plan.atlas_w) == (1618, 640)
    assert (plan.map_h, plan.map_w) == (804, 315)
    assert int((plan.cell_level >= 0).sum()) == 144944


@pytest.mark.parametrize("h,w", [(12, 200), (5, 5), (200, 11)])
def test_tiny_image_raises_like_fdt(h, w):
    for build in (md.build_plan, jmd.build_plan):
        with pytest.raises(ValueError, match="smaller than the 12px net"):
            build(h, w)


@pytest.mark.parametrize("src,dst,fx", [(480, 480, 1.0), (480, 340, 0.709), (640, 171, 0.2527),
                                        (120, 13, 0.1), (13, 30, 2.3), (160, 9, 0.0572)])
def test_cv2_fx_taps_bit_equal(src, dst, fx):
    for ours, theirs in zip(md._cv2_fx_taps(src, dst, fx), jmd._cv2_fx_taps(src, dst, fx)):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def test_config_and_budgets_match_fdt():
    from fdt.config import MTCNN as JAX_MTCNN
    assert md.MTCNN.__dict__ == JAX_MTCNN.__dict__
    for ours, theirs in ((md.DeviceBudgets(), jmd.DeviceBudgets()),
                         (md.FAST_BUDGETS, jmd.FAST_BUDGETS), (md.MID_BUDGETS, jmd.MID_BUDGETS)):
        assert ours.__dict__ == theirs.__dict__


# --- the nets and the loader ------------------------------------------------------------

@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("net", ["pnet", "rnet", "onet"])
def test_net_matches_fdt(setting, net):
    """Probabilities within 1e-5, regressions and landmarks within 1e-5 of
    their scale, on one numpy input: float32 on both sides, convolutions
    summed in another order.  RNet and ONet hold only with the flatten
    permutation of their first Linear."""
    i = ("pnet", "rnet", "onet").index(net)
    size = (40, 24, 48)[i]
    x = np.random.RandomState(i).randint(0, 256, (6, size, size, 3)).astype(np.float32) / 255
    with jax.default_matmul_precision("highest"):
        want = (JaxPNet, JaxRNet, JaxONet)[i]().apply(fdt_variables(setting)[i], jnp.asarray(x))
    model = load_mtcnn_nets(*flat_variables(setting))[i]
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if g.ndim == 4:  # PNet's maps, NCHW → NHWC
            g = g.transpose(0, 2, 3, 1)
        assert g.dtype == np.float32 and g.shape == w.shape
        tol = 1e-5 if j == 0 else 1e-5 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("net", [RNet, ONet])
def test_flatten_permutation_is_needed(net):
    """Loading the first Linear without the (H, W, C) → (C, H, W) permutation
    scrambles the features: the outputs move by far more than float noise."""
    variables = chip_smoke.seeded_variables(net(), 0)
    right, wrong = net(), net()
    right.load_state_dict(from_jax_variables(variables, net.flatten_chw))
    wrong.load_state_dict(from_jax_variables(variables))
    x = torch.rand(4, 3, 24 if net is RNet else 48, 24 if net is RNet else 48)
    with torch.no_grad():
        assert (right(x)[1] - wrong(x)[1]).abs().max() > 1e-2


def test_prelu_has_one_slope_and_pools_floor():
    pnet = PNet()
    assert all(m.weight.shape == (1,) for m in pnet.modules()
               if isinstance(m, torch.nn.PReLU))
    for m in (RNet(), ONet()):
        pools = [p for p in m.modules() if isinstance(p, torch.nn.MaxPool2d)]
        assert pools and not any(p.ceil_mode or p.padding for p in pools)
    with torch.no_grad():  # 24 → 22 → pool 3/2 → 10 → 8 → 3 → 2: floor mode
        assert RNet().pre_layer(torch.zeros(1, 3, 24, 24)).shape == (1, 64, 2, 2)


def test_npz_cascade_loads_strict(tmp_path):
    """Three npz files in fdt's format (f16 params) load strict into the
    port, PReLU slopes and permuted Linears included."""
    from fdt.models.loader import save_variables_npz
    paths = []
    for name, variables in zip(("p", "r", "o"), fdt_variables("sparse")):
        paths.append(str(tmp_path / f"{name}net.npz"))
        save_variables_npz(variables, paths[-1])
    cascade = load_mtcnn_cascade(*paths, device="cpu")
    slope = fdt_variables("sparse")[1]["params"]["prelu4"]["negative_slope"]
    assert cascade.rnet.prelu4.weight.item() == float(np.float16(slope))
    assert cascade.device.type == "cpu" and cascade.crop_impl == "gather"


def test_cascade_defaults_to_the_card_and_refuses_what_is_not_ported():
    nets = load_mtcnn_nets(*flat_variables("sparse"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            md.MTCNNDeviceCascade(*nets)
    with pytest.raises(ValueError, match="s2d"):
        md.MTCNNDeviceCascade(*nets, pnet_impl="s2d", device="cpu")
    with pytest.raises(ValueError, match="crop_impl"):
        md.MTCNNDeviceCascade(*nets, crop_impl="loop", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        md.MTCNNDeviceCascade(*nets, precision="high", device="cpu")
    cascade = md.MTCNNDeviceCascade(*nets, device="cpu")
    with pytest.raises(ValueError, match="stage"):
        cascade.detect_stage(frame(0, 24, 24), "lnet")
    with pytest.raises(ValueError, match="smaller than the 12px net"):
        cascade.detect_face(frame(0, 11, 40))


def test_empty_result_is_two_empty_arrays_like_fdt():
    """A frame with no face: (np.array([]), np.array([])), as fdt returns
    (:699-700), from detect_face and detect_face_bucketed alike."""
    black = np.zeros((96, 128, 3), np.uint8)
    want = fdt_cascade("sparse").detect_face(black)
    cascade = port_cascade("sparse")
    for got in (cascade.detect_face(black), cascade.detect_face_bucketed(black)):
        for g, w in zip(got, want):
            assert g.shape == w.shape == (0,) and g.dtype == w.dtype


# --- the atlas --------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(120, 160), (96, 128), (480, 640)])
def test_atlas_matches_fdt(h, w):
    """The port's atlas against fdt's compiled one (vmapped over a batch of
    two, as detect_batch runs it): equal but for one gray level on at most
    1e-5 of the pixels (a two-term sum within an ulp of a half-integer,
    which fdt's contraction may round the other way)."""
    images = np.stack([frame(s, h, w) for s in (0, 1)]).astype(np.float32)
    plan = jmd.build_plan(h, w)

    def atlas(image):
        a = jnp.zeros((plan.atlas_h, plan.atlas_w, 3), jnp.float32)
        for lh, lw, y_off, s in plan.levels:
            a = jax.lax.dynamic_update_slice(
                a, jmd._resize_level(image, h, w, lh, lw, s), (y_off, 0, 0))
        return a

    want = np.asarray(jax.jit(jax.vmap(atlas))(jnp.asarray(images)))
    got = md._atlas(torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
                    md.build_plan(h, w)).permute(0, 2, 3, 1).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    assert (diff > 0).sum() <= 1e-5 * diff.size, int((diff > 0).sum())


# --- serving ----------------------------------------------------------------------------

def test_service_rows_match_fdt_rows_mtcnn():
    """The mtcnn family answers [N, 15] rows: fdt's _rows_mtcnn of the
    port's detect_batch, the request's scale applied to boxes and landmarks;
    requests of other sizes resized to the frame by resize_bilinear.  Four
    threads, each answer equal to its direct call."""
    from fdt.apps.serving import DetectionService as JaxService
    cascade = port_cascade("saturated")
    frame_w, frame_h = 160, 120
    rng = np.random.RandomState(3)
    sizes = [(frame_h, frame_w), (90, 200), (240, 320), (120, 160)]
    images = [rng.randint(0, 256, (*sizes[i % 4], 3), dtype=np.uint8) for i in range(8)]
    svc = DetectionService("mtcnn", cascade, frame_size=(frame_w, frame_h), threshold=0.6,
                           max_batch=4, max_wait_ms=50)
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
    # fdt's row function (an unbound method, on a stand-in service holding
    # the port's cascade) on each frame alone
    service = type("Service", (), {"frame_w": frame_w, "frame_h": frame_h, "threshold": 0.6,
                                   "detector": cascade})()
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        f = im if (h, w) == (frame_h, frame_w) else resize_bilinear(im, frame_w, frame_h)
        want = JaxService._rows_mtcnn(service, f[None])[0](w, h)
        got = results[i]
        assert got.dtype == np.float32 and got.shape[1] == 15 and len(got) > 0
        assert got.shape == want.shape
        scale = np.array([w, h] * 2 + [1] + [w, h] * 5, np.float32)
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-5)


# --- the golden -------------------------------------------------------------------------

def _tiers(cascade, images) -> list:
    """The tier each image settles on: the first of the ladder whose run
    leaves the image unsaturated."""
    b, h, w = images.shape[:3]
    tiers = [None] * b
    for name in (*cascade.tier_names, "full"):
        sat = np.asarray(cascade._compiled_batch(b, h, w, name)(cascade.vars,
                                                                jnp.asarray(images))[3])
        tiers = [t or (None if s else name) for t, s in zip(tiers, sat)]
        if all(tiers):
            return tiers
    raise AssertionError("the full budgets saturate")


def make_golden() -> dict:
    """fdt's float32 cascade on the sparse golden batch at 480×640 through
    the ladder FAST → MID → full."""
    h, w = chip_smoke.MTCNN_H, chip_smoke.MTCNN_W
    images = np.stack([frame(s, h, w) for s in chip_smoke.MTCNN_FRAME_SEEDS])
    cascade = fdt_cascade("sparse", budgets=jmd.DeviceBudgets(),
                          fast_budgets=(jmd.FAST_BUDGETS, jmd.MID_BUDGETS))
    boxes, lms, counts, sat = cascade.detect_batch(images)
    tiers = _tiers(cascade, images)
    n = int(counts.max())
    shifts = chip_smoke.MTCNN_SHIFTS["sparse"]
    return {"boxes": boxes[:, :n], "landmarks": lms[:, :n], "counts": counts.astype(np.int64),
            "saturated": np.asarray(sat), "tier": np.str_(tiers[0]) if len(set(tiers)) == 1
            else np.str_("mixed"), "tiers": np.array(tiers),
            "frame_seeds": np.array(chip_smoke.MTCNN_FRAME_SEEDS),
            "weights_seed": np.int64(chip_smoke.MTCNN_WEIGHTS_SEED),
            "pnet_shift": np.float32(shifts["pnet"][1]),
            "rnet_shift": np.float32(shifts["rnet"][1]),
            "height": np.int64(h), "width": np.int64(w),
            "frame_sha256": np.str_(hashlib.sha256(images.tobytes()).hexdigest())}


def test_golden_file_is_consistent():
    g = np.load(chip_smoke.MTCNN_GOLDEN)
    assert chip_smoke.MTCNN_GOLDEN.stat().st_size < 100_000
    h, w = int(g["height"]), int(g["width"])
    assert (h, w) == (chip_smoke.MTCNN_H, chip_smoke.MTCNN_W)
    images = np.stack([frame(int(s), h, w) for s in g["frame_seeds"]])
    assert hashlib.sha256(images.tobytes()).hexdigest() == str(g["frame_sha256"])
    assert int(g["weights_seed"]) == chip_smoke.MTCNN_WEIGHTS_SEED
    shifts = chip_smoke.MTCNN_SHIFTS["sparse"]
    assert (float(g["pnet_shift"]), float(g["rnet_shift"])) == (
        float(np.float32(shifts["pnet"][1])), float(np.float32(shifts["rnet"][1])))
    # the batch overflows FAST and settles on MID, unsaturated, with detections
    assert str(g["tier"]) == "fast1" and list(g["tiers"]) == ["fast1"] * len(images)
    assert not g["saturated"].any() and (g["counts"] > 10).all()
    for b, c in zip(g["boxes"], g["counts"]):
        assert np.all(np.diff(b[:c, 4]) <= 0) and (b[:c, 4] > jmd.MTCNN.thresholds[2]).all()


@pytest.mark.slow
def test_mtcnn_golden_matches_jax_and_port():
    """Re-make the 480×640 golden with fdt's cascade and hold it and the
    port's CPU float32 output against the committed file."""
    g = dict(np.load(chip_smoke.MTCNN_GOLDEN))
    fresh = make_golden()
    for key in ("boxes", "landmarks", "counts", "saturated", "tiers"):
        np.testing.assert_array_equal(fresh[key], g[key])
    cascade = port_cascade("sparse", budgets=md.DeviceBudgets(),
                           fast_budgets=(md.FAST_BUDGETS, md.MID_BUDGETS))
    images = np.stack([frame(int(s), int(g["height"]), int(g["width"]))
                       for s in g["frame_seeds"]])
    boxes, lms, counts, sat = cascade.detect_batch(images)
    assert cascade.last_tier == str(g["tier"])
    np.testing.assert_array_equal(counts, g["counts"])
    np.testing.assert_array_equal(sat, g["saturated"])
    for i, c in enumerate(counts):
        assert_rows_match(boxes[i, :c], lms[i, :c], g["boxes"][i, :c], g["landmarks"][i, :c])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the MTCNN golden for chip_smoke.py")
    ap.add_argument("--write-golden", action="store_true", required=True)
    ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    golden = make_golden()
    np.savez_compressed(chip_smoke.MTCNN_GOLDEN, **golden)
    print(f"wrote {chip_smoke.MTCNN_GOLDEN.relative_to(REPO)}: counts "
          f"{golden['counts'].tolist()}, tiers {golden['tiers'].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
