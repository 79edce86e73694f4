#!/usr/bin/env python3
"""Smoke run of fdt_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. device  — the card's name and power limit; exits non-zero without CUDA.
  2. build   — nvcc builds fdt_torch/csrc/*.cu into a fresh fdt_torch/_build/.
  3. kernels — K1 (greedy NMS) against its plain PyTorch version on the card,
               bit-equal keep masks (the first out_k keeps with out_k), and
               its time beside the plain version's and its bound.
  4. flagship — PyramidBox-ResNet50 with net_weight/repo_mini.npz: a float32
               frame against the golden the JAX package produced for it, then
               the bf16 + channels_last detect at batch 8, 640², conf/nms
               0.35/0.35, budget 5000 (images/s from CUDA events), then one
               call at conf 0.01 so that all 5000 candidates enter NMS (K1 is
               checked and timed again on those boxes).
  5. serving — DetectionService answers 16 requests from 4 threads (float32);
               each answer agrees with the direct detect_tensor rows of its
               frame, up to the summation order of another batch size.
Then a JSON line of the kernels and, last, {"ok": true, "device": {...}}.
Any failure exits non-zero; a hang exits non-zero with a traceback.
"""
from __future__ import annotations

import faulthandler
import hashlib
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
GOLDEN = REPO / "fdt_torch" / "golden" / "flagship_f32.npz"
# a hang must exit with a traceback before whoever runs this script kills
# it, so this stays well under any time limit it is run with (the whole run
# takes under a minute on an H100, the nvcc build included)
HANG_LIMIT_S = 240
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


def _pairs_needed(keep: torch.Tensor, valid: torch.Tensor) -> int:
    """Pair tests a greedy walk needs on this data: each kept box against the
    later boxes up to its problem's extent (1 + last valid index)."""
    n = valid.shape[-1]
    idx = torch.arange(1, n + 1, device=valid.device)
    extent = (idx * valid).amax(dim=-1, keepdim=True)
    return int(((extent - idx) * keep).sum())


def phase_kernels(device):
    """K1 against its plain version on the cases of the CPU tests, then timed
    at the flagship's shapes."""
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
    run = lambda: nms_op.nms_keep_tiled(boxes, valid, thresh, out_k=out_k)  # noqa: E731
    for _ in range(3):
        run()
    ms = _cuda_ms(run, 20)
    plain_ms = _cuda_ms(lambda: nms_keep_mask(boxes, valid, thresh), 2)
    full = nms_keep_mask(boxes, valid, thresh)
    # the work this data needs: the pair tests of each keep up to the 750th
    capped = full & (torch.cumsum(full.int(), dim=-1) <= out_k)
    pairs = _pairs_needed(capped, valid)
    bytes_moved = boxes.numel() * 4 + valid.numel() + full.numel()
    bound_bytes_ms = bytes_moved / PEAK_BYTES_S * 1e3
    bound_ops_ms = pairs * OPS_PER_PAIR / PEAK_F32_OPS_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    _phase("kernels", t0, cases=len(cases), k1_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
           bound_ms=f"{bound_ms:.6f}", pairs=pairs, bytes=bytes_moved,
           keeps=capped.sum(-1).tolist())
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "max_abs_err": max_err}


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
    rates = [BATCH / _cuda_ms(lambda: det.detect_device(staged, 0.35, 0.35), 5) * 1e3
             for _ in range(3)]
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


def phase_serving(det):
    """DetectionService under 4 client threads against direct calls."""
    from fdt_torch.apps.serving import DetectionService
    from fdt_torch.infer.pyramidbox import detections_to_rows
    from fdt_torch.ops import nms as nms_op

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
    results, latencies, errors = {}, [], []
    lock = threading.Lock()

    def client(ids):
        for i in ids:
            t = time.perf_counter()
            try:
                r = svc.detect(frames[i])
            except Exception as e:  # noqa: BLE001 — reported below
                with lock:
                    errors.append(e)
                return
            with lock:
                latencies.append(time.perf_counter() - t)
                results[i] = r

    threads = [threading.Thread(target=client, args=(range(k, 16, 4),)) for k in range(4)]
    nms_op.launches.reset()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    launches = nms_op.launches.count
    stats = svc.stats()
    svc.close()
    if errors or len(results) != 16:
        raise AssertionError(f"serving: {len(results)} answers, errors {errors[:1]}")
    if svc.batcher._worker.is_alive():
        raise AssertionError("serving worker still alive after close()")
    # float32 convolutions of another batch size sum in another order: scores
    # drift by ~1e-6, pixel boxes by ~1e-3
    bad = [i for i in range(16)
           if not _rows_agree(results[i], want[i], threshold, 1e-4, 0.05)]
    if bad:
        raise AssertionError(f"serving answers differ from direct calls: {bad}")
    if launches != stats["batches"]:
        raise AssertionError(f"{stats['batches']} batches but {launches} K1 launches")
    lat = sorted(latencies)
    _phase("serving", t0, requests=len(results), p50_ms=f"{lat[len(lat) // 2] * 1e3:.1f}",
           mean_batch=f"{stats['mean_batch_size']:.2f}", batches=stats["batches"],
           k1_launches=launches, rows=sum(len(r) for r in results.values()))


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
    _phase("build", t0, lib=_build.LIB_PATH.relative_to(REPO))
    print("\n".join(line for line in log.splitlines() if "registers" in line or "smem" in line))

    k1 = phase_kernels(device)
    det32, launches, boxes_err = phase_flagship(device)
    phase_serving(det32)

    print(json.dumps({"kernels": [{
        "name": "nms_tiled (K1)", "route": "cuda",
        "source": "fdt_torch/csrc/nms_tiled.cu",
        "replaces": "fdt/ops/pallas_nms.py:69",
        "launches": launches, "max_abs_err": max(k1["max_abs_err"], boxes_err),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
