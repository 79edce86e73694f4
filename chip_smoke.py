#!/usr/bin/env python3
"""Smoke run of fdt_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. device  — the card's name and power limit; exits non-zero without CUDA.
  2. build   — nvcc builds fdt_torch/csrc/*.cu into a fresh fdt_torch/_build/
               (one nvcc per source, all at once, then one link), then
               times one nvcc over all sources, the serial build, beside it.
  3. kernels — K1 (tiled greedy NMS) against its plain PyTorch version on the
               card, bit-equal keep masks (the first out_k keeps with out_k),
               and its time beside the plain version's and its bound; then
               K2 (the one-box-at-a-time loop) against its plain version and
               K1, bit-equal, timed at FaceBoxes' and the flagship's shapes.
  4. flagship — PyramidBox-ResNet50 with net_weight/repo_mini.npz: a float32
               frame against the golden the JAX package produced for it, then
               the bf16 + channels_last detect at batch 8, 640², conf/nms
               0.35/0.35, budget 5000 (images/s from CUDA events), then one
               call at conf 0.01 so that all 5000 candidates enter NMS (K1 is
               checked and timed again on those boxes).
  5. facebox — FaceBoxes at 1024² on seeded weights: a float32 frame against
               the JAX golden, images/s at batch 16 (TF32 on), and K2 through
               nms_padded(impl="pallas") on that batch's own candidates,
               bit-equal to impl="pallas_tiled" (K1).
  6. variants — try3 and try1 with their trained npz files: a float32 frame
               against the JAX goldens, then bf16 images/s at batch 8, 640²;
               try2, try4 and try5 on seeded weights: a detect call whose
               source shapes are those fdt recorded.
  7. serving — DetectionService answers 16 requests from 4 threads (float32)
               for the pyramidbox family (640²) and the facebox family (mixed
               sizes); each answer agrees with the direct call on its frame,
               up to the summation order of another batch size.
Then a JSON line of the kernels and, last, {"ok": true, "device": {...}}.
Any failure exits non-zero; a hang exits non-zero with a traceback.
"""
from __future__ import annotations

import contextlib
import faulthandler
import hashlib
import itertools
import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
WEIGHTS = REPO / "net_weight" / "repo_mini.npz"
GOLDEN_DIR = REPO / "fdt_torch" / "golden"
GOLDEN = GOLDEN_DIR / "flagship_f32.npz"
# a hang must exit with a traceback before whoever runs this script kills
# it, so this stays well under any time limit it is run with (the whole run
# takes under a minute on an H100, the nvcc build included)
HANG_LIMIT_S = 240
WARMUP_S = 2.0  # before each throughput measurement
SIZE, BATCH = 640, 8  # the flagship: bench.py:167-200

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# non-tensor-core operations/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# float32 operations of one pairwise overlap test (2 min, 2 max, 2 sub,
# 2 clamp, 1 mul for the intersection; add, sub, div, compare)
OPS_PER_PAIR = 13

# golden comparison: float32 on both sides, convolutions summed in another
# order (XLA:CPU against cuDNN without TF32): the scores (softmax, in [0, 1])
# and normalized boxes drift by ~1e-6; 1e-3 leaves a wide margin yet catches
# any wrong layer, weight or layout
GOLDEN_ROWS = 100
GOLDEN_TOL = 1e-3

# FaceBoxes: its fixed 1024² frame, weights made from a seed (faceboxes.pt is
# not in the repo), and the batch of the throughput check
FACEBOX_GOLDEN = GOLDEN_DIR / "facebox.npz"
FACEBOX_SIZE, FACEBOX_BATCH = 1024, 16
FACEBOX_FRAME_SEED, FACEBOX_WEIGHTS_SEED = 0, 0

# the mobile variants: trained weights where the repo has them (try1, try3;
# the others run on seeded weights), their 640² frame and golden thresholds
VARIANT_WEIGHTS = {"try3": "net_weight/try3_mini.npz",
                   "try1": "net_weight/try1_distilled_mini.npz"}
VARIANT_FRAME_SEED, VARIANT_WEIGHTS_SEED = 0, 0
VARIANT_CONF, VARIANT_NMS = 0.01, 0.35


def variant_golden(variant: str) -> pathlib.Path:
    return GOLDEN_DIR / f"{variant}.npz"


def seeded_variables(model: torch.nn.Module, seed: int) -> dict:
    """flax-layout variables for the port's `model`, filled from a numpy seed:
    He-scaled HWIO conv kernels, small biases, BatchNorm scale and statistics
    away from identity (var drawn positive).  Module names are the torch
    paths with `.` spelled `__` (one flat level, which from_jax_variables
    reads as it is; the tests nest them into fdt's tree).  No weight file is
    needed: the goldens and this script make the same weights from the seed."""
    rng = np.random.RandomState(seed)
    params, stats = {}, {}
    for name, mod in model.named_modules():
        key = name.replace(".", "__")
        if isinstance(mod, torch.nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            params[key] = {"kernel": (rng.randn(kh, kw, i, o)
                                      * np.sqrt(2.0 / (kh * kw * i))).astype(np.float32)}
            if mod.bias is not None:
                params[key]["bias"] = (rng.randn(o) * 0.05).astype(np.float32)
        elif isinstance(mod, torch.nn.BatchNorm2d):
            c = mod.num_features
            params[key] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                           "bias": (rng.randn(c) * 0.05).astype(np.float32)}
            stats[key] = {"mean": (rng.randn(c) * 0.1).astype(np.float32),
                          "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return {"params": params, "batch_stats": stats}


def golden_frame(seed: int, height: int, width: int) -> np.ndarray:
    """The seeded uint8 BGR frame the golden was made from."""
    return np.random.RandomState(seed).randint(0, 256, (height, width, 3),
                                               dtype=np.uint8)


def match_rows(got: np.ndarray, want: np.ndarray, n: int, tol: float,
               window: int = 3) -> float:
    """Compare the first n [score, x1, y1, x2, y2] rows of two score-sorted
    detection lists; return the largest difference.

    Scores are compared position by position (both lists are sorted, so a
    swap of two near-equal scores moves each by less than their gap).  A row
    whose box differs may have swapped with a near-tied neighbour: it must
    then match a row within `window` positions.  Raises AssertionError.
    """
    if len(got) < n or len(want) < n:
        raise AssertionError(f"need {n} rows, got {len(got)} and {len(want)}")
    err = float(np.abs(got[:n, 0] - want[:n, 0]).max())
    for i in range(n):
        lo, hi = max(0, i - window), min(len(want), i + window + 1)
        diffs = np.abs(want[lo:hi] - got[i]).max(axis=1)
        err = max(err, float(diffs.min()) if diffs[i - lo] > tol else float(diffs[i - lo]))
    if err > tol:
        raise AssertionError(f"rows differ by {err} > {tol}")
    return err


def _phase(name: str, t0: float, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[phase] {name} {time.perf_counter() - t0:.3f}s {extra}".rstrip(),
          flush=True)


def _cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() over `iters` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def _tf32(enabled: bool):
    """TF32 for cuDNN convolutions and matmuls on or off, restored after."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _warm(fn, seconds: float = WARMUP_S) -> None:
    """Call fn() until `seconds` of device work have passed (at least 3
    calls), so that the first timed block does not find the card cold."""
    end = time.perf_counter() + seconds
    for i in itertools.count():
        fn()
        torch.cuda.synchronize()
        if i >= 2 and time.perf_counter() > end:
            return


def _rates(fn, batch: int) -> list[float]:
    """Images/s of three blocks of 5 calls of fn() on `batch` images."""
    return [batch / _cuda_ms(fn, 5) * 1e3 for _ in range(3)]


def _pallas_case(seed, n):
    """The score-sorted boxes of tests/test_pallas_nms.py:10-37."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(n, 2) * 4
    wh = rng.rand(n, 2) * 2 + 0.5
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], 1).astype(np.float32)
    order = np.argsort(-rng.rand(n).astype(np.float32), kind="stable")
    return torch.from_numpy(boxes[order][None]).cuda(), torch.ones(1, n, dtype=torch.bool).cuda()


def _nms_case(seed, p, n, spread, segmented):
    """Score-sorted boxes of P problems, as in tests/test_torch_nms.py."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(p, n, 2) * spread
    wh = rng.rand(p, n, 2) * 3.0 + 0.5
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    valid = rng.rand(p, n) > 0.1
    seg = (rng.rand(p, n) * 7).astype(np.int32) if segmented else None
    cuda = lambda a: None if a is None else torch.from_numpy(a).cuda()  # noqa: E731
    return cuda(boxes), cuda(valid), cuda(seg)


def _mask_err(got: torch.Tensor, want: torch.Tensor, out_k) -> float:
    """Largest |got - want| of two [..., N] keep masks over the positions the
    contract fixes: all of them, or with out_k those up to each problem's
    out_k-th keep of `want`, plus any keep that `want` drops."""
    diff = got != want
    if out_k is not None:
        keeps_before = torch.cumsum(want.int(), dim=-1) - want.int()
        m = want.sum(dim=-1, keepdim=True).clamp(max=out_k)
        diff = (diff & (keeps_before < m)) | (got & ~want)
    return float(diff.int().max())


def _pairs_needed(boxes, valid, keep, thresh, mode="union", out_k=None) -> int:
    """Pair tests the greedy walk needs on this data: each valid box is tested
    against the kept boxes before it, in order, up to and including the first
    that suppresses it.  With out_k the walk ends at each problem's out_k-th
    keep (`keep` is the full mask), and the boxes after it need no test."""
    from fdt_torch.geometry.nms import _overlap_matrix

    n = valid.shape[-1]
    idx = torch.arange(n, device=valid.device)
    later = idx[:, None] < idx[None, :]
    thresh = torch.tensor(thresh, dtype=torch.float32, device=valid.device)
    total = 0
    for b, v, k in zip(boxes.reshape(-1, n, 4), valid.reshape(-1, n), keep.reshape(-1, n)):
        hits = (_overlap_matrix(b, mode) >= thresh) & k[:, None] & later  # [i, j]
        suppressed = hits.any(dim=0)
        kept_through = torch.cumsum(k.long(), dim=0)  # keeps among 0..i
        kept_before = kept_through - k.long()
        tests = torch.where(suppressed, kept_through[hits.int().argmax(dim=0)], kept_before)
        if out_k is not None:
            v = v & (kept_before < out_k)
        total += int((tests * v).sum())
    return total


def phase_kernels(device):
    """K1 against its plain version on the cases of the CPU tests and at
    FaceBoxes' shape with its out_k, then timed at the flagship's shapes."""
    from fdt_torch.geometry.nms import nms_keep_mask
    from fdt_torch.ops import nms as nms_op

    t0 = time.perf_counter()
    cases = []  # seed, P, N, spread, mode, thresh, out_k, segmented
    for seed in (0, 1, 2):
        for mode in ("union", "minimum"):
            cases.append((seed, 1, 300, 4.0, mode, 0.5, None, False))
    for out_k in (16, 100, 750):
        cases.append((7, 1, 1500, 100.0, "union", 0.5, out_k, False))
    cases.append((3, 1, 2048, 50.0, "union", 0.45, 128, False))
    for mode in ("union", "minimum"):
        cases.append((3, 1, 4500, 6.0, mode, 0.4, None, True))
    cases.append((11, 1, 1000, 30.0, "union", 0.4, None, False))
    cases.append((12, FACEBOX_BATCH, 2048, 50.0, "union", 0.5, 750, False))  # FaceBoxes
    flagship = (9, BATCH, 5000, 300.0, "union", 0.35, 750, False)
    cases.append(flagship)
    max_err = 0.0
    for seed, p, n, spread, mode, thresh, out_k, segmented in cases:
        boxes, valid, seg = _nms_case(seed, p, n, spread, segmented)
        got = nms_op.nms_keep_tiled(boxes, valid, thresh, mode=mode, seg_id=seg,
                                    out_k=out_k)
        want = nms_keep_mask(boxes, valid, thresh, mode=mode, seg_id=seg)
        err = _mask_err(got, want, out_k)
        if err != 0:
            raise AssertionError(f"K1 != plain: P={p} N={n} mode={mode} "
                                 f"out_k={out_k} seg={segmented}")
        max_err = max(max_err, err)

    seed, p, n, spread, mode, thresh, out_k, _ = flagship
    boxes, valid, _ = _nms_case(seed, p, n, spread, False)
    full = nms_keep_mask(boxes, valid, thresh)
    timed = _time_keep(lambda: nms_op.nms_keep_tiled(boxes, valid, thresh, out_k=out_k),
                       _pairs_needed(boxes, valid, full, thresh, out_k=out_k), valid)
    plain_ms = _cuda_ms(lambda: nms_keep_mask(boxes, valid, thresh), 2)
    _phase("kernels", t0, cases=len(cases), k1_ms=f"{timed['ms']:.4f}",
           plain_ms=f"{plain_ms:.4f}", bound_ms=f"{timed['bound_ms']:.6f}",
           pairs=timed["pairs"], bytes=timed["bytes"], keeps=full.sum(-1).tolist())
    return {**timed, "plain_ms": plain_ms, "max_abs_err": max_err}


def _time_keep(fn, pairs, valid) -> dict:
    """ms of fn() (20 launches after 3), and its bound: the larger of the
    bytes it must move (boxes and valid in, keep out) at the memory rate and
    its `pairs` tests at the float32 peak."""
    for _ in range(3):
        fn()
    ms = _cuda_ms(fn, 20)
    bytes_moved = valid.numel() * (16 + 1 + 1)
    bound_bytes_ms = bytes_moved / PEAK_BYTES_S * 1e3
    bound_ops_ms = pairs * OPS_PER_PAIR / PEAK_F32_OPS_S * 1e3
    return {"ms": ms, "bound_ms": max(bound_bytes_ms, bound_ops_ms), "pairs": pairs,
            "bytes": bytes_moved,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"}


def phase_k2(device):
    """K2 against its plain version and against K1 without out_k, bit-equal
    keep masks, on the cases of tests/test_pallas_nms.py:10-37 (N = 200 and
    300, seeds 0 and 1, union and minimum, the valid-mask case), a zero-area
    box, N = 1000, FaceBoxes' shape (P = 16, N = 2048) and the flagship's
    (P = 8, N = 5000); timed at the last two."""
    from fdt_torch.geometry.nms import nms_keep_mask
    from fdt_torch.ops import nms as nms_op

    t0 = time.perf_counter()
    cases = []  # name, boxes, valid, mode, thresh
    for n in (200, 300):
        for seed in (0, 1):
            for mode in ("union", "minimum"):
                cases.append((f"pallas-{n}-{seed}-{mode}", *_pallas_case(seed, n), mode, 0.5))
    two = torch.tensor([[[0, 0, 1, 1], [0, 0, 1, 1]]], dtype=torch.float32, device=device)
    cases.append(("valid-mask", two, torch.tensor([[False, True]], device=device), "union", 0.5))
    boxes, valid, _ = _nms_case(13, 1, 600, 10.0, False)
    boxes[:, ::17, 2:] = boxes[:, ::17, :2]  # zero-area boxes: 0/0 suppresses nothing
    for mode in ("union", "minimum"):
        cases.append((f"degenerate-{mode}", boxes, valid, mode, 0.5))
    cases.append(("n1000", *_nms_case(11, 1, 1000, 30.0, False)[:2], "union", 0.4))
    facebox = ("facebox-16x2048", *_nms_case(12, FACEBOX_BATCH, 2048, 50.0, False)[:2],
               "union", 0.5)
    flagship = ("flagship-8x5000", *_nms_case(9, BATCH, 5000, 300.0, False)[:2], "union", 0.35)
    cases += [facebox, flagship]
    max_err = 0.0
    before = nms_op.greedy_launches.count
    for name, boxes, valid, mode, thresh in cases:
        got = nms_op.nms_keep_greedy(boxes, valid, thresh, mode=mode)
        want = nms_keep_mask(boxes, valid, thresh, mode=mode)
        k1 = nms_op.nms_keep_tiled(boxes, valid, thresh, mode=mode)
        err = max(_mask_err(got, want, None), _mask_err(got, k1, None))
        if err != 0:
            raise AssertionError(f"K2 != plain or K1: case {name}")
        max_err = max(max_err, err)
    if nms_op.greedy_launches.count - before != len(cases):
        raise AssertionError("K2 was not launched once on every case")

    timed = {}
    for name, boxes, valid, mode, thresh in (facebox, flagship):
        keep = nms_keep_mask(boxes, valid, thresh, mode=mode)
        timed[name] = _time_keep(
            lambda: nms_op.nms_keep_greedy(boxes, valid, thresh, mode=mode),
            _pairs_needed(boxes, valid, keep, thresh, mode), valid)
        timed[name].update(
            k1_ms=_cuda_ms(lambda: nms_op.nms_keep_tiled(boxes, valid, thresh, mode=mode), 20),
            plain_ms=_cuda_ms(lambda: nms_keep_mask(boxes, valid, thresh, mode=mode), 2),
            keeps=keep.sum(-1).tolist())
    fb, fl = timed[facebox[0]], timed[flagship[0]]
    _phase("kernels_k2", t0, cases=len(cases),
           k2_ms_16x2048=f"{fb['ms']:.4f}", plain_ms_16x2048=f"{fb['plain_ms']:.4f}",
           bound_ms_16x2048=f"{fb['bound_ms']:.6f}", k1_full_ms_16x2048=f"{fb['k1_ms']:.4f}",
           pairs_16x2048=fb["pairs"],
           k2_ms_8x5000=f"{fl['ms']:.4f}", plain_ms_8x5000=f"{fl['plain_ms']:.4f}",
           bound_ms_8x5000=f"{fl['bound_ms']:.6f}", k1_full_ms_8x5000=f"{fl['k1_ms']:.4f}",
           pairs_8x5000=fl["pairs"], keeps_8x5000=fl["keeps"])
    return {**fb, "max_abs_err": max_err, "flagship": fl}


def phase_flagship(device):
    """The float32 golden check, then the bf16 main path at batch 8."""
    from fdt_torch.geometry.nms import nms_keep_mask
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models.loader import load_pyramidbox
    from fdt_torch.ops import nms as nms_op

    t0 = time.perf_counter()
    g = np.load(GOLDEN)
    seed, h, w = int(g["seed"]), int(g["height"]), int(g["width"])
    frame = golden_frame(seed, h, w)
    if hashlib.sha256(frame.tobytes()).hexdigest() != str(g["frame_sha256"]):
        raise AssertionError("the seeded frame differs from the golden's")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det32 = PyramidBoxDetector(load_pyramidbox(str(WEIGHTS)), device=device)
    out = det32.detect_tensor(frame[None], conf_thresh=float(g["conf_thresh"]),
                              nms_thresh=float(g["nms_thresh"]))
    rows = out[0, 1]
    err = match_rows(rows, g["rows"], GOLDEN_ROWS, GOLDEN_TOL)
    _phase("flagship_f32", t0, size=f"{w}x{h}", count=int((rows[:, 0] > 0).sum()),
           golden_count=int(g["count"]), max_abs_err=f"{err:.3g}")

    t0 = time.perf_counter()
    det = PyramidBoxDetector(load_pyramidbox(str(WEIGHTS)), dtype=torch.bfloat16,
                             device=device)
    frames = np.random.RandomState(1).randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    det.detect_tensor(frames, conf_thresh=0.35, nms_thresh=0.35)       # warm-up
    nms_op.launches.reset()
    out = det.detect_tensor(frames, conf_thresh=0.35, nms_thresh=0.35)  # the main path
    launches = nms_op.launches.count
    if out.shape != (BATCH, 2, 750, 5) or not np.isfinite(out).all():
        raise AssertionError(f"bad flagship output {out.shape}")
    if launches < 1:
        raise AssertionError("the flagship did not launch K1")
    staged = torch.from_numpy(frames).to(device)
    _warm(lambda: det.detect_device(staged, 0.35, 0.35))
    rates = _rates(lambda: det.detect_device(staged, 0.35, 0.35), BATCH)
    spread = (max(rates) - min(rates)) / max(rates) * 100
    # conf 0.01: all 5000 candidates enter NMS and the out_k exit is taken;
    # K1's inputs are kept to time it on the flagship's own boxes
    captured = {}
    kernel = nms_op.nms_keep_tiled

    def keep_inputs(*args, **kwargs):
        captured.update(args=args, kwargs=kwargs)
        return kernel(*args, **kwargs)

    nms_op.nms_keep_tiled = keep_inputs
    try:
        dense = det.detect_tensor(frames, conf_thresh=0.01, nms_thresh=0.35)
    finally:
        nms_op.nms_keep_tiled = kernel
    dense_count = (dense[:, 1, :, 0] > 0).sum(axis=1)
    if not np.isfinite(dense).all() or dense_count.min() < 1:
        raise AssertionError(f"conf 0.01 run: counts {dense_count.tolist()}")
    boxes, valid, thresh = captured["args"]
    boxes_err = _mask_err(kernel(*captured["args"], **captured["kwargs"]),
                          nms_keep_mask(boxes, valid, thresh), captured["kwargs"]["out_k"])
    if boxes_err != 0:
        raise AssertionError("K1 != plain on the flagship's boxes")
    real_ms = _cuda_ms(lambda: kernel(*captured["args"], **captured["kwargs"]), 20)
    _phase("flagship_bf16", t0, batch=BATCH, images_per_s=f"{max(rates):.2f}",
           rates=[round(r, 2) for r in rates], spread_pct=f"{spread:.2f}",
           k1_launches=launches, count_035=(out[:, 1, :, 0] > 0).sum(axis=1).tolist(),
           count_001=dense_count.tolist(), k1_flagship_boxes_ms=f"{real_ms:.4f}",
           k1_shape=list(boxes.shape))
    return det32, launches, boxes_err


def _spread(rates) -> float:
    return (max(rates) - min(rates)) / max(rates) * 100


def phase_facebox(device):
    """FaceBoxes at 1024² on seeded weights: a float32 frame (TF32 off)
    against fdt's golden, images/s at batch 16 (TF32 on, bench.py's
    precision="default"), then this slice's path: the detect (K1 through
    nms_padded's "auto") and, on that batch's own candidates,
    nms_padded(impl="pallas") (K2) against impl="pallas_tiled" (K1)."""
    from fdt_torch.geometry.nms import nms_padded
    from fdt_torch.infer import FaceBoxDetector
    from fdt_torch.models import FaceBox, from_jax_variables
    from fdt_torch.ops import nms as nms_op

    t0 = time.perf_counter()
    g = np.load(FACEBOX_GOLDEN)
    size = int(g["size"])
    frame = golden_frame(int(g["frame_seed"]), size, size)
    if hashlib.sha256(frame.tobytes()).hexdigest() != str(g["frame_sha256"]):
        raise AssertionError("the seeded frame differs from the FaceBoxes golden's")
    model = FaceBox()
    model.load_state_dict(from_jax_variables(
        seeded_variables(model, int(g["weights_seed"]))), strict=True)
    det = FaceBoxDetector(model, device=device)
    with _tf32(False):
        (boxes, scores), = det.detect_batch(frame[None])
    err = match_rows(np.column_stack([scores, boxes]), g["rows"], GOLDEN_ROWS, GOLDEN_TOL)
    _phase("facebox_f32", t0, size=f"{size}x{size}", count=len(scores),
           golden_count=int(g["count"]), max_abs_err=f"{err:.3g}")

    t0 = time.perf_counter()
    frames = np.random.RandomState(3).randint(0, 256, (FACEBOX_BATCH, size, size, 3),
                                              dtype=np.uint8)
    staged = torch.from_numpy(frames).to(device)
    cfg = det.cfg
    with _tf32(True):
        _warm(lambda: det.detect_device(staged))
        rates = _rates(lambda: det.detect_device(staged), FACEBOX_BATCH)
        cand_boxes, probs = det.candidates(staged)
        valid = probs > cfg.conf_thresh
        nms = {impl: lambda impl=impl: nms_padded(
            cand_boxes, probs, cfg.nms_thresh, budget=det.budget, out_k=det.out_k,
            valid=valid, impl=impl) for impl in ("pallas", "pallas_tiled")}
        nms_op.launches.reset()
        nms_op.greedy_launches.reset()
        out = det.detect_device(staged)              # this slice's path
        idx2, count2 = nms["pallas"]()
        idx1, count1 = nms["pallas_tiled"]()
        k1_launches, k2_launches = nms_op.launches.count, nms_op.greedy_launches.count
        nms_ms = {impl: _cuda_ms(fn, 20) for impl, fn in nms.items()}
    if k2_launches != 1 or k1_launches != 2:
        raise AssertionError(f"FaceBoxes path: {k1_launches} K1 and {k2_launches} K2 "
                             "launches (want 2 and 1)")
    count = out[2]
    if (out[0].shape != (FACEBOX_BATCH, det.out_k, 4) or not torch.isfinite(out[0]).all()
            or not torch.equal(count, count1)):
        raise AssertionError("bad FaceBoxes output")
    if not (torch.equal(count1, count2) and all(
            torch.equal(idx1[i, :c], idx2[i, :c]) for i, c in enumerate(count1.tolist()))):
        raise AssertionError("nms_padded: impl='pallas' (K2) != 'pallas_tiled' (K1) "
                             "on FaceBoxes' candidates")
    _phase("facebox_batch", t0, batch=FACEBOX_BATCH, images_per_s=f"{max(rates):.2f}",
           rates=[round(r, 2) for r in rates], spread_pct=f"{_spread(rates):.2f}",
           candidates=valid.sum(-1).tolist(), counts=count1.tolist(),
           k1_launches=k1_launches, k2_launches=k2_launches,
           nms_padded_pallas_ms=f"{nms_ms['pallas']:.4f}",
           nms_padded_pallas_tiled_ms=f"{nms_ms['pallas_tiled']:.4f}")
    return det, k2_launches


def phase_variants(device):
    """The mobile variants at 640²: try3 and try1 with their trained npz
    files, a float32 frame (TF32 off) against fdt's golden, then bf16 +
    channels_last images/s at batch 8; try2, try4 and try5 with seeded
    weights, a detect call whose source shapes are fdt's."""
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models import build_pyramidbox, from_jax_variables, load_pyramidbox
    from fdt_torch.ops import nms as nms_op

    for variant, weights in VARIANT_WEIGHTS.items():
        t0 = time.perf_counter()
        g = np.load(variant_golden(variant))
        h, w = int(g["height"]), int(g["width"])
        frame = golden_frame(int(g["seed"]), h, w)
        if hashlib.sha256(frame.tobytes()).hexdigest() != str(g["frame_sha256"]):
            raise AssertionError(f"the seeded frame differs from the {variant} golden's")
        model = load_pyramidbox(str(REPO / weights), variant)
        det = PyramidBoxDetector(model, variant, device=device)
        with _tf32(False):
            rows = det.detect_tensor(frame[None], VARIANT_CONF, VARIANT_NMS)[0, 1]
        err = match_rows(rows, g["rows"], GOLDEN_ROWS, GOLDEN_TOL)
        shapes = tuple(map(tuple, g["source_shapes"].tolist()))
        if det.source_shapes[(w, h)] != shapes:
            raise AssertionError(f"{variant}: source shapes {det.source_shapes[(w, h)]}")
        # the same model, now in bf16 + channels_last
        det = PyramidBoxDetector(model, variant, dtype=torch.bfloat16, device=device)
        frames = np.random.RandomState(1).randint(0, 256, (BATCH, h, w, 3), dtype=np.uint8)
        staged = torch.from_numpy(frames).to(device)
        _warm(lambda: det.detect_device(staged))
        nms_op.launches.reset()
        out = det.detect_tensor(frames)                # the variant's path
        launches = nms_op.launches.count
        if out.shape != (BATCH, 2, 750, 5) or not np.isfinite(out).all() or launches != 1:
            raise AssertionError(f"{variant}: bad bf16 output or {launches} K1 launches")
        rates = _rates(lambda: det.detect_device(staged), BATCH)
        _phase(f"variant_{variant}", t0, weights=weights, max_abs_err=f"{err:.3g}",
               count=int((rows[:, 0] > 0).sum()), golden_count=int(g["count"]),
               batch=BATCH, images_per_s=f"{max(rates):.2f}",
               rates=[round(r, 2) for r in rates], spread_pct=f"{_spread(rates):.2f}",
               k1_launches=launches, count_bf16=(out[:, 1, :, 0] > 0).sum(axis=1).tolist())

    for variant in ("try2", "try4", "try5"):
        t0 = time.perf_counter()
        g = np.load(variant_golden(variant))
        h, w = int(g["height"]), int(g["width"])
        model = build_pyramidbox(variant)
        model.load_state_dict(from_jax_variables(
            seeded_variables(model, VARIANT_WEIGHTS_SEED)), strict=True)
        det = PyramidBoxDetector(model, variant, device=device)
        frame = golden_frame(VARIANT_FRAME_SEED, h, w)
        nms_op.launches.reset()
        out = det.detect_tensor(frame[None])
        launches = nms_op.launches.count
        shapes = tuple(map(tuple, g["source_shapes"].tolist()))
        if out.shape != (1, 2, 750, 5) or not np.isfinite(out).all() or launches != 1:
            raise AssertionError(f"{variant}: bad output or {launches} K1 launches")
        if det.source_shapes[(w, h)] != shapes:
            raise AssertionError(f"{variant}: source shapes {det.source_shapes[(w, h)]} "
                                 f"!= fdt's {shapes}")
        _phase(f"variant_{variant}", t0, weights="seeded", source_shapes=list(shapes),
               count=int((out[0, 1, :, 0] > 0).sum()), k1_launches=launches)


def _rows_agree(got: np.ndarray, want: np.ndarray, threshold: float,
                score_tol: float, px_tol: float) -> bool:
    """Two [N, 5] pixel-row lists of one frame agree: every row of each has a
    row of the other within the tolerances, except rows whose score lies
    within score_tol of the threshold (drift may put them on either side)."""
    for a, b in ((got, want), (want, got)):
        for r in a:
            if r[4] < threshold + score_tol:
                continue
            if not len(b) or not (
                    (np.abs(b[:, :4] - r[:4]).max(axis=1) <= px_tol)
                    & (np.abs(b[:, 4] - r[4]) <= score_tol)).any():
                return False
    return True


def _serve(name, svc, images, want, threshold, t0) -> None:
    """Drive `svc` with `images` from 4 client threads; every answer must
    agree with its direct call `want[i]`."""
    from fdt_torch.ops import nms as nms_op

    results, latencies, errors = {}, [], []
    lock = threading.Lock()

    def client(ids):
        for i in ids:
            t = time.perf_counter()
            try:
                r = svc.detect(images[i])
            except Exception as e:  # noqa: BLE001 — reported below
                with lock:
                    errors.append(e)
                return
            with lock:
                latencies.append(time.perf_counter() - t)
                results[i] = r

    n = len(images)
    threads = [threading.Thread(target=client, args=(range(k, n, 4),)) for k in range(4)]
    nms_op.launches.reset()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    launches = nms_op.launches.count
    stats = svc.stats()
    svc.close()
    if errors or len(results) != n:
        raise AssertionError(f"{name}: {len(results)} answers, errors {errors[:1]}")
    if svc.batcher._worker.is_alive():
        raise AssertionError(f"{name}: worker still alive after close()")
    # float32 convolutions of another batch size sum in another order: scores
    # drift by ~1e-6, pixel boxes by ~1e-3
    bad = [i for i in range(n)
           if not _rows_agree(results[i], want[i], threshold, 1e-4, 0.05)]
    if bad:
        raise AssertionError(f"{name}: answers differ from direct calls: {bad}")
    if launches != stats["batches"]:
        raise AssertionError(f"{name}: {stats['batches']} batches but {launches} K1 launches")
    lat = sorted(latencies)
    _phase(name, t0, requests=len(results), p50_ms=f"{lat[len(lat) // 2] * 1e3:.1f}",
           mean_batch=f"{stats['mean_batch_size']:.2f}", batches=stats["batches"],
           k1_launches=launches, rows=sum(len(r) for r in results.values()))


def phase_serving(det, facebox_det):
    """DetectionService under 4 client threads against direct calls: the
    pyramidbox family (the flagship, 640² requests) and the facebox family
    (requests of mixed sizes, resized to its 1024² frame)."""
    from fdt_torch.apps.serving import DetectionService, resize_bilinear
    from fdt_torch.infer.pyramidbox import detections_to_rows

    t0 = time.perf_counter()
    rng = np.random.RandomState(2)
    frames = [rng.randint(0, 256, (SIZE, SIZE, 3), dtype=np.uint8) for _ in range(16)]
    threshold = 0.25
    want = []
    for f in frames:  # the direct reference: one frame per call
        d = detections_to_rows(det.detect_tensor(f[None], threshold, 0.35)[0],
                               threshold, [SIZE] * 4)
        want.append(d if d[:, :4].any() else np.empty((0, 5), np.float32))
    svc = DetectionService("pyramidbox", det, frame_size=(SIZE, SIZE), threshold=threshold,
                           nms_thresh=0.35, max_batch=BATCH, max_wait_ms=20)
    _serve("serving", svc, frames, want, threshold, t0)

    t0 = time.perf_counter()
    sizes = [(FACEBOX_SIZE, FACEBOX_SIZE), (480, 640), (720, 1280), (300, 400)]  # (h, w)
    images = [rng.randint(0, 256, (*sizes[i % 4], 3), dtype=np.uint8) for i in range(16)]
    threshold = 0.4
    want = []
    for im in images:
        h, w = im.shape[:2]
        frame = (im if (h, w) == (FACEBOX_SIZE, FACEBOX_SIZE)
                 else resize_bilinear(im, FACEBOX_SIZE, FACEBOX_SIZE))
        (b, s), = facebox_det.detect_batch(frame[None])
        keep = s >= threshold
        want.append(np.column_stack([b[keep] * np.array([w, h, w, h], np.float32), s[keep]]))
    svc = DetectionService("facebox", facebox_det, threshold=threshold, max_batch=BATCH,
                           max_wait_ms=20)
    _serve("serving_facebox", svc, images, want, threshold, t0)


def _one_nvcc_s(build) -> float:
    """Seconds of a single nvcc over every source, the build that compiles
    them one after another, for comparison with build.build's concurrent one
    (run second, so it finds the toolkit's files already cached)."""
    out = build.BUILD_DIR / "one_nvcc_reference.so"
    t0 = time.perf_counter()
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
                    *map(str, build._sources())], check=True, capture_output=True,
                   timeout=build.BUILD_TIMEOUT_S)
    out.unlink()
    return time.perf_counter() - t0


def main() -> int:
    faulthandler.dump_traceback_later(HANG_LIMIT_S, exit=True)
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
          f"nvidia-smi failed: {smi.stderr.strip()}")
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    _phase("device", t0, card=repr(name), torch=torch.__version__, cuda=torch.version.cuda)

    from fdt_torch.ops import _build
    t0 = time.perf_counter()
    log = _build.build(fresh=True)
    _build.library()
    build_s = time.perf_counter() - t0
    one_nvcc_s = _one_nvcc_s(_build)
    _phase("build", t0, lib=_build.LIB_PATH.relative_to(REPO), build_s=f"{build_s:.3f}",
           one_nvcc_s=f"{one_nvcc_s:.3f}")
    print("\n".join(line for line in log.splitlines()
                    if "entry function" in line or "registers" in line))

    k1 = phase_kernels(device)
    k2 = phase_k2(device)
    det32, launches, boxes_err = phase_flagship(device)
    facebox_det, k2_launches = phase_facebox(device)
    phase_variants(device)
    phase_serving(det32, facebox_det)

    # PyTorch has no NMS call (and torchvision is not installed): no library_ms
    print(json.dumps({"kernels": [{
        "name": "nms_tiled (K1)", "route": "cuda",
        "source": "fdt_torch/csrc/nms_tiled.cu",
        "replaces": "fdt/ops/pallas_nms.py:69",
        "launches": launches, "max_abs_err": max(k1["max_abs_err"], boxes_err),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None}, {
        "name": "nms_greedy (K2)", "route": "cuda",
        "source": "fdt_torch/csrc/nms_greedy.cu",
        "replaces": "fdt/ops/pallas_nms.py:31",
        "launches": k2_launches, "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
