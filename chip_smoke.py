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
               on 15 cases and on K1_EDGES; then, on K1_TIMED, its time a
               call, each of its kernels' device time (torch.profiler), the
               wrapper's host time and the pair tests it computes, beside the
               plain version's time and the bound; then K2 (the
               one-box-at-a-time loop, a cluster of blocks a problem)
               against its plain version and K1, bit-equal, on 14 cases and
               on K2_EDGES, and on K2_TIMED (FaceBoxes' and the flagship's
               shapes) the same measures as K1's, its cluster size and the
               clusters the card runs at once.
  4. flagship — PyramidBox-ResNet50 with net_weight/repo_mini.npz: a float32
               frame against the golden the JAX package produced for it (the
               float32 frames of every family are checked with the global
               TF32 flags on: the detectors' default precision="highest"
               turns TF32 off for the forward; the score drift of
               precision="default" is printed beside), then
               the bf16 + channels_last detect at batch 8, 640², conf/nms
               0.35/0.35, budget 5000 (images/s from CUDA events), then one
               call at conf 0.01 so that all 5000 candidates enter NMS (K1 is
               checked and timed again on those boxes).
  5. facebox — FaceBoxes at 1024² on seeded weights: a float32 frame against
               the JAX golden, images/s at batch 16 (precision="default",
               TF32 allowed, bench.py's mode), and K2 through
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
    """The global TF32 flags of cuDNN convolutions and matmuls on or off,
    restored after."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _score_diff(rows: np.ndarray, want: np.ndarray) -> float:
    """Largest score difference over the first GOLDEN_ROWS rows of two
    score-sorted [score, x1, y1, x2, y2] lists, position by position."""
    return float(np.abs(rows[:GOLDEN_ROWS, 0] - want[:GOLDEN_ROWS, 0]).max())


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


def _pairs_needed(boxes, valid, keep, thresh, mode="union", out_k=None, seg=None) -> int:
    """Pair tests the greedy walk needs on this data: each valid box is tested
    against the kept boxes before it in its segment, in order, up to and
    including the first that suppresses it.  With out_k the walk ends at each
    problem's out_k-th keep (`keep` is the full mask), and the boxes after it
    need no test."""
    from fdt_torch.geometry.nms import _overlap_matrix

    n = valid.shape[-1]
    idx = torch.arange(n, device=valid.device)
    later = idx[:, None] < idx[None, :]
    thresh = torch.tensor(thresh, dtype=torch.float32, device=valid.device)
    segs = (torch.zeros_like(valid, dtype=torch.int32) if seg is None else seg).reshape(-1, n)
    total = 0
    for b, v, k, s in zip(boxes.reshape(-1, n, 4), valid.reshape(-1, n), keep.reshape(-1, n),
                          segs):
        before = k[:, None] & later & (s[:, None] == s[None, :])  # [j, i]: j kept, tested by i
        hits = (_overlap_matrix(b, mode) >= thresh) & before
        suppressed = hits.any(dim=0)
        through = torch.cumsum(before.int(), dim=0)  # [j, i]: tests of i among 0..j
        tests = torch.where(suppressed, through.gather(0, hits.int().argmax(dim=0)[None])[0],
                            through[-1])
        if out_k is not None:
            v = v & (torch.cumsum(k.long(), dim=0) - k.long() < out_k)
        total += int((tests * v).sum())
    return total


def _edge_boxes(seed, p, n, spread, valid_frac=0.9):
    """Seeded boxes [P, N, 4] (centres within `spread`, sides 0.5-3.5), a valid
    mask with `valid_frac` of them set, and the generator."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(p, n, 2) * spread
    wh = rng.rand(p, n, 2) * 3.0 + 0.5
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    return boxes, rng.rand(p, n) < valid_frac, rng


def _degenerate(boxes):
    """Zero-area boxes (0/0 overlaps) and NaN coordinates, which suppress
    nothing, in place."""
    boxes[:, ::7, 2:] = boxes[:, ::7, :2]
    for k in range(4):
        boxes[:, 3 + k::11 * 4, k] = np.nan
    return boxes


# K1's edges: where its walk starts, ends or crosses a word (64 boxes) or a
# chunk (words 0-7, 8-15, then 16 at a time) and its degenerate
# inputs.  "at-<i>" names the box at which the out_k-th keep falls.
K1_EDGES = ("out_k-at-127-word-end", "out_k-at-255-word-end", "out_k-at-511-chunk-end",
            "out_k-at-1023-chunk-end", "out_k-at-2047-chunk-end", "out_k-at-300-mid-word",
            "out_k-above-keeps",
            "no-valid", "no-valid-out_k", "last-valid-only", "n1", "n63", "n64", "n65",
            "n8192", "n8192-segments", "segments-across-chunks-union",
            "segments-across-chunks-minimum", "degenerate-union", "degenerate-minimum",
            "p1", "p16-out_k")


def k1_edge_case(name: str):
    """One case of K1_EDGES as numpy arrays: (boxes [P, N, 4] float32, valid
    [P, N] bool, seg [P, N] int32 or None, mode, thresh, out_k or None)."""
    from fdt_torch.geometry.nms import nms_keep_mask

    make = _edge_boxes
    if name.startswith("out_k-at-"):
        # box i is valid and far from every other box, so it is kept: out_k is
        # the number of keeps up to it, which no box after i can change
        i = int(name.split("-")[2])
        boxes, valid, _ = make(i, 1, max(1500, i + 500), 40.0)
        boxes[0, i] = [1000, 1000, 1001, 1001]
        valid[0, i] = True
        prefix = nms_keep_mask(torch.from_numpy(boxes[:, :i + 1]),
                               torch.from_numpy(valid[:, :i + 1]), 0.5)
        return boxes, valid, None, "union", 0.5, int(prefix.sum())
    if name == "out_k-above-keeps":
        boxes, valid, _ = make(20, 2, 1000, 30.0)
        return boxes, valid, None, "union", 0.5, 1005
    if name.startswith("no-valid"):
        boxes, valid, _ = make(21, 2, 500, 10.0)
        return boxes, np.zeros_like(valid), None, "union", 0.5, (
            10 if name.endswith("out_k") else None)
    if name == "last-valid-only":
        boxes, valid, _ = make(22, 2, 1000, 10.0)
        valid[:] = False
        valid[:, -1] = True
        return boxes, valid, None, "union", 0.5, None
    if name.startswith("n8192"):
        boxes, valid, rng = make(23, 2, 8192, 120.0)
        seg = (rng.rand(2, 8192) * 6).astype(np.int32) if name.endswith("segments") else None
        return boxes, valid, seg, "union", 0.4, None
    if name[0] == "n":
        n = int(name[1:])
        boxes, valid, _ = make(24 + n, 3, n, 4.0)
        return boxes, valid, None, "union", 0.5, None
    if name.startswith("segments-across-chunks"):
        # runs of 200 boxes cycle over 3 segments, so every segment spans
        # the chunk ends at 512, 1024 and 2048 boxes
        boxes, valid, _ = make(25, 2, 3000, 12.0)
        seg = np.broadcast_to((np.arange(3000) // 200 % 3).astype(np.int32), (2, 3000))
        return boxes, valid, np.ascontiguousarray(seg), name.split("-")[-1], 0.4, None
    if name.startswith("degenerate"):
        boxes, valid, _ = make(26, 2, 1200, 10.0)
        return _degenerate(boxes), valid, None, name.split("-")[-1], 0.3, None
    if name == "p1":
        boxes, valid, _ = make(27, 1, 2500, 60.0)
        return boxes, valid, None, "union", 0.45, None
    if name == "p16-out_k":
        boxes, valid, _ = make(28, 16, 1000, 40.0)
        return boxes, valid, None, "union", 0.5, 300
    raise KeyError(name)


# K2's edges, for its cluster of 8 blocks a problem that deal the words of
# 64 boxes round robin: problems smaller than a word, than a cluster's
# words (some blocks own none) and at the word and owner boundaries of 8
# and 16 words (N = 511, 512, 513 and 1023, 1024, 1025); an extent
# that ends inside a word; no valid box, or only the last; a suppression
# chain that alternates across owners; every box kept (the heaviest push);
# identical boxes; zero-area and NaN boxes; thresh 0 (no intersection
# skip); more clusters than the card holds at once (P = 64); N = 8192.
K2_EDGES = ("p1-n1", "n63", "n64", "n65", "n300-fewer-words-than-blocks", "n511", "n512",
            "n513", "n1023", "n1024", "n1025", "extent-mid-word", "no-valid", "last-valid-only",
            "chain-across-owners-union", "chain-across-owners-minimum", "no-overlaps",
            "identical", "degenerate-union", "degenerate-minimum", "thresh-zero", "p64",
            "n8192")
CHAIN_WORDS = 18  # the chain case: one chain box in each of 18 words


def k2_edge_case(name: str):
    """One case of K2_EDGES as numpy arrays: (boxes [P, N, 4] float32, valid
    [P, N] bool, mode, thresh)."""
    make = _edge_boxes
    if name == "p1-n1":
        boxes, valid, _ = make(30, 1, 1, 4.0)
        return boxes, np.ones_like(valid), "union", 0.5
    if name == "n300-fewer-words-than-blocks":
        boxes, valid, _ = make(31, 2, 300, 15.0)
        return boxes, valid, "union", 0.5
    if name == "extent-mid-word":
        # the last valid boxes are 699 and 332: inside words 10 and 5
        boxes, valid, _ = make(32, 2, 1000, 25.0)
        valid[0, 700:] = valid[1, 333:] = False
        valid[0, 699] = valid[1, 332] = True
        return boxes, valid, "union", 0.5
    if name == "no-valid":
        boxes, valid, _ = make(33, 2, 600, 10.0)
        return boxes, np.zeros_like(valid), "union", 0.5
    if name == "last-valid-only":
        boxes, valid, _ = make(34, 2, 1000, 10.0)
        valid[:] = False
        valid[:, -1] = True
        return boxes, valid, "union", 0.5
    if name.startswith("chain-across-owners"):
        # chain box k, in word k, is the unit square shifted by 0.3 k: it
        # overlaps box k + 1 by IoU 0.54 (0.7 of the smaller) and box k + 2
        # by 0.25 (0.4), so the even boxes are kept and each odd one, which
        # would have suppressed the next, is suppressed; the other boxes
        # lie far away
        n = 64 * CHAIN_WORDS - 20
        boxes, valid, _ = make(35, 2, n, 40.0)
        boxes += 100.0
        for k in range(CHAIN_WORDS):
            i = min(64 * k + 7 * k % 64, n - 1)
            boxes[:, i] = [0.3 * k, 0.0, 0.3 * k + 1.0, 1.0]
            valid[:, i] = True
        return boxes, valid, name.split("-")[-1], 0.5
    if name == "no-overlaps":
        k = np.arange(2048)
        x, y = (2 * (k % 64)).astype(np.float32), (2 * (k // 64)).astype(np.float32)
        boxes = np.broadcast_to(np.stack([x, y, x + 1, y + 1], -1), (2, 2048, 4)).copy()
        return boxes, np.ones((2, 2048), bool), "union", 0.5
    if name == "identical":
        boxes = np.broadcast_to(np.array([1, 1, 3, 3], np.float32), (2, 700, 4)).copy()
        valid = np.ones((2, 700), bool)
        valid[1, :100] = False
        return boxes, valid, "union", 0.5
    if name.startswith("degenerate"):
        boxes, valid, _ = make(36, 2, 1200, 10.0)
        return _degenerate(boxes), valid, name.split("-")[-1], 0.3
    if name == "thresh-zero":
        boxes, valid, _ = make(37, 2, 700, 30.0)
        return boxes, valid, "union", 0.0
    if name == "p64":
        boxes, valid, _ = make(38, 64, 300, 15.0)
        return boxes, valid, "union", 0.45
    if name == "n8192":
        boxes, valid, _ = make(39, 2, 8192, 120.0)
        return boxes, valid, "union", 0.4
    if name[0] == "n":
        n = int(name[1:])
        boxes, valid, _ = make(30 + n, 3, n, max(4.0, n ** 0.5))
        return boxes, valid, "union", 0.5
    raise KeyError(name)


# K1's timed cases: name →(seed, P, N, spread, mode, thresh, out_k, segmented).
# The flagship's shape (P = 8 images × 1 class, budget 5000, top_k 750) and
# FaceBoxes' (P = 16, budget 2048, out_k 750), each with and without out_k,
# and the segmented problem of the CPU tests (N = 4500)
K1_TIMED = {
    "flagship-8x5000-k750": (9, BATCH, 5000, 300.0, "union", 0.35, 750, False),
    "flagship-8x5000": (9, BATCH, 5000, 300.0, "union", 0.35, None, False),
    "facebox-16x2048-k750": (12, FACEBOX_BATCH, 2048, 50.0, "union", 0.5, 750, False),
    "facebox-16x2048": (12, FACEBOX_BATCH, 2048, 50.0, "union", 0.5, None, False),
    "segmented-1x4500": (3, 1, 4500, 6.0, "union", 0.4, None, True),
}


def _device_split(fn, iters: int = 10):
    """Device time of each `nms_*` CUDA kernel that fn() launches, from
    torch.profiler: ({kernel: {"us": mean µs a call, "launches": a call}},
    [[kernel, µs] of each launch of the last call, in order]).  Both empty
    when the profiler records no device time."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split, launches = {}, []
    for event in prof.events():
        name = re.search(r"nms_\w+_kernel", event.name)
        if name and event.device_type == torch.autograd.DeviceType.CUDA:
            us = event.time_range.elapsed_us()
            launches.append((event.time_range.start, name.group(0), us))
            entry = split.setdefault(name.group(0), {"us": 0.0, "launches": 0})
            entry["us"] += us
            entry["launches"] += 1
    # the trace may miss an event at the start of the window: a kernel's
    # launches a call are its events a call, rounded, and its time a call is
    # their mean time that many times
    for entry in split.values():
        events = entry["launches"]
        entry["launches"] = max(1, round(events / iters))
        entry["us"] = entry["us"] / events * entry["launches"]
    per_call = sum(entry["launches"] for entry in split.values())
    last = sorted(launches)[-per_call:] if per_call else []
    return split, [[name, us] for _, name, us in last]


def k1_timings() -> dict:
    """K1 at each timed case: _kernel_timings (`ms` by CUDA events over 20
    back-to-back calls after 3, the wrapper's host time, each of its
    kernels' device time from torch.profiler) and the bound from the pair
    tests the greedy walk needs on this data."""
    from fdt_torch.geometry.nms import nms_keep_mask
    from fdt_torch.ops import nms as nms_op

    out = {}
    for name, (seed, p, n, spread, mode, thresh, out_k, segmented) in K1_TIMED.items():
        boxes, valid, seg = _nms_case(seed, p, n, spread, segmented)

        def call():
            return nms_op.nms_keep_tiled(boxes, valid, thresh, mode=mode, seg_id=seg,
                                         out_k=out_k)

        full = nms_keep_mask(boxes, valid, thresh, mode=mode, seg_id=seg)
        pairs = _pairs_needed(boxes, valid, full, thresh, mode, out_k, seg)
        out[name] = {**_kernel_timings(call, pairs, valid), "keeps": full.sum(-1).tolist()}
    return out


def _kernel_timings(call, pairs, valid) -> dict:
    """_time_keep's fields for call(), `host_ms` the wrapper's host time a
    call (20 calls enqueued without a wait), `split` and `sequence` from
    _device_split and `device_ms` the sum of its kernels' device times."""
    timed = _time_keep(call, pairs, valid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        call()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    split, sequence = _device_split(call)
    return {**timed, "host_ms": host_ms, "split": split, "sequence": sequence,
            "device_ms": sum(s["us"] for s in split.values()) / 1e3 if split else None}


def _pairs_computed(boxes, valid, keep, thresh, mode="union", out_k=None, seg=None) -> int:
    """Pair tests K1's mask launches compute on this data (nms_tiled.cu; each
    launch taken to see `removed` as it was before it).  For every chunk up
    to the one where the walk ends (the out_k-th keep, or the last valid
    box): each valid column of the chunk against the kept rows of each group
    of earlier words that one block walks, STEP at a time, up to the step
    holding the first that suppresses it; and each valid row of the chunk
    against the valid columns after it in the chunk."""
    from fdt_torch.geometry.nms import _overlap_matrix
    from fdt_torch.ops._build import library

    STEP = 4  # nms_tiled.cu's kStep

    lib = library()
    n = valid.shape[-1]
    words = (n + 63) // 64
    pad = words * 64 - n
    thresh = torch.tensor(thresh, dtype=torch.float32, device=valid.device)
    segs = (torch.zeros_like(valid, dtype=torch.int32) if seg is None else seg).reshape(-1, n)
    total = 0
    for b, v, k, s in zip(boxes.reshape(-1, n, 4), valid.reshape(-1, n), keep.reshape(-1, n),
                          segs):
        if not bool(v.any()):
            continue
        stop = int(torch.nonzero(v)[-1])
        if out_k is not None and int(k.sum()) >= out_k:
            stop = int(torch.nonzero(k)[out_k - 1])
        hits = (_overlap_matrix(b, mode) >= thresh) & (s[:, None] == s[None, :]) & k[:, None]
        hits = torch.nn.functional.pad(hits, (0, pad, 0, pad))
        kp = torch.nn.functional.pad(k, (0, pad)).long()
        vp = torch.nn.functional.pad(v, (0, pad))
        c0 = 0
        while c0 * 64 <= stop:
            c1 = lib.fdt_nms_tiled_chunk_end(c0, words)
            cols = vp[c0 * 64:c1 * 64]
            group = lib.fdt_nms_tiled_cross_words(c0)
            for u0 in range(0, c0, group):
                found = torch.zeros_like(cols)
                for u in range(u0, min(u0 + group, c0)):
                    h = hits[u * 64:(u + 1) * 64, c0 * 64:c1 * 64]
                    rank = torch.cumsum(kp[u * 64:(u + 1) * 64], 0)  # kept rows among 0..j
                    # a column tests the kept rows of word u STEP at a time, up
                    # to the step holding its first suppressor
                    first = (rank[h.int().argmax(0)] + STEP - 1) // STEP * STEP
                    tests = torch.where(h.any(0), first.clamp(max=rank[-1]), rank[-1])
                    total += int((tests * (cols & ~found)).sum())
                    found |= h.any(0)
            later = torch.cumsum(cols.flip(0).long(), 0).flip(0) - cols.long()  # valid after
            total += int((later * cols).sum())
            c0 = c1
    return total


def _kernel_line(tag, name, split, sequence, **fields) -> None:
    """One `[k1]` or `[k2]` line: the fields, each kernel's device µs and
    launches a call, and the device µs of each launch of one call, in order."""
    print(f"[{tag}] {name} " + " ".join(f"{k}={v}" for k, v in fields.items()) + " "
          + " ".join(f"{k}={v['us']:.2f}us/{v['launches']:g}" for k, v in split.items())
          + " launches_us=" + ",".join(f"{k[4:-7]}:{us:.1f}" for k, us in sequence), flush=True)


def phase_kernels(device):
    """K1 against its plain version, bit-equal keep masks (the first out_k
    keeps with out_k), on the cases of the CPU tests, at FaceBoxes' and the
    flagship's shapes, and on its edges (K1_EDGES); then timed on
    K1_TIMED."""
    from fdt_torch.geometry.nms import nms_keep_mask
    from fdt_torch.ops import nms as nms_op

    t0 = time.perf_counter()
    cases = []  # name, boxes, valid, seg, mode, thresh, out_k
    specs = []  # seed, P, N, spread, mode, thresh, out_k, segmented
    for seed in (0, 1, 2):
        for mode in ("union", "minimum"):
            specs.append((seed, 1, 300, 4.0, mode, 0.5, None, False))
    for out_k in (16, 100, 750):
        specs.append((7, 1, 1500, 100.0, "union", 0.5, out_k, False))
    specs.append((3, 1, 2048, 50.0, "union", 0.45, 128, False))
    for mode in ("union", "minimum"):
        specs.append((3, 1, 4500, 6.0, mode, 0.4, None, True))
    specs.append((11, 1, 1000, 30.0, "union", 0.4, None, False))
    specs.append((12, FACEBOX_BATCH, 2048, 50.0, "union", 0.5, 750, False))  # FaceBoxes
    specs.append((9, BATCH, 5000, 300.0, "union", 0.35, 750, False))  # the flagship
    for seed, p, n, spread, mode, thresh, out_k, segmented in specs:
        boxes, valid, seg = _nms_case(seed, p, n, spread, segmented)
        cases.append((f"{p}x{n}-{mode}-seed{seed}-out_k{out_k}-seg{segmented}",
                      boxes, valid, seg, mode, thresh, out_k))
    for name in K1_EDGES:
        boxes, valid, seg, mode, thresh, out_k = k1_edge_case(name)
        cases.append((name, *(None if a is None else torch.from_numpy(a).to(device)
                              for a in (boxes, valid, seg)), mode, thresh, out_k))
    max_err = 0.0
    for name, boxes, valid, seg, mode, thresh, out_k in cases:
        got = nms_op.nms_keep_tiled(boxes, valid, thresh, mode=mode, seg_id=seg,
                                    out_k=out_k)
        want = nms_keep_mask(boxes, valid, thresh, mode=mode, seg_id=seg)
        err = _mask_err(got, want, out_k)
        if err != 0 or (out_k is not None and int(got.sum(-1).max()) > out_k):
            raise AssertionError(f"K1 != plain: case {name}")
        max_err = max(max_err, err)

    timed = k1_timings()
    for name, (seed, p, n, spread, mode, thresh, out_k, segmented) in K1_TIMED.items():
        boxes, valid, seg = _nms_case(seed, p, n, spread, segmented)
        full = nms_keep_mask(boxes, valid, thresh, mode=mode, seg_id=seg)
        timed[name]["pairs_computed"] = _pairs_computed(boxes, valid, full, thresh, mode,
                                                        out_k, seg)
    flagship = timed["flagship-8x5000-k750"]
    seed, p, n, spread, mode, thresh, out_k, _ = K1_TIMED["flagship-8x5000-k750"]
    boxes, valid, _ = _nms_case(seed, p, n, spread, False)
    plain_ms = _cuda_ms(lambda: nms_keep_mask(boxes, valid, thresh), 2)
    _phase("kernels", t0, cases=len(cases), edges=len(K1_EDGES), k1_ms=f"{flagship['ms']:.4f}",
           plain_ms=f"{plain_ms:.4f}", bound_ms=f"{flagship['bound_ms']:.6f}",
           keeps=flagship["keeps"])
    for name, t in timed.items():
        _kernel_line("k1", name, t["split"], t["sequence"], ms=f"{t['ms']:.4f}",
                 device_ms="not_measured" if t["device_ms"] is None else f"{t['device_ms']:.4f}",
                 host_ms=f"{t['host_ms']:.4f}", bound_ms=f"{t['bound_ms']:.6f}",
                 pairs_needed=t["pairs"], pairs_computed=t["pairs_computed"])
    return {**flagship, "plain_ms": plain_ms, "max_abs_err": max_err, "timed": timed}


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


# K2's timed cases: name → (seed, P, N, spread, mode, thresh), FaceBoxes'
# shape (P = 16, budget 2048) and the flagship's (P = 8 images, budget 5000)
K2_TIMED = {
    "facebox-16x2048": (12, FACEBOX_BATCH, 2048, 50.0, "union", 0.5),
    "flagship-8x5000": (9, BATCH, 5000, 300.0, "union", 0.35),
}


def _k2_pairs_computed(boxes, valid, keep, thresh, mode="union") -> int:
    """Pair tests K2 computes on this data (nms_greedy.cu), at most: within
    each word up to the last valid one, each valid box against the valid
    boxes after it in its word (the hit words the walk resolves from); then,
    for each word w, each of its kept boxes against every box of a later
    word that no kept box of a word before w has suppressed (the push does
    not stop at a box's first suppressor, and a box that a kept box of w
    itself suppresses may still be tested by another warp's share)."""
    from fdt_torch.geometry.nms import _overlap_matrix

    n = valid.shape[-1]
    word = torch.arange(n, device=valid.device) // 64
    words = (n + 63) // 64
    thresh = torch.tensor(thresh, dtype=torch.float32, device=valid.device)
    total = 0
    for b, v, k in zip(boxes.reshape(-1, n, 4), valid.reshape(-1, n), keep.reshape(-1, n)):
        if not bool(v.any()):
            continue
        per_word = torch.bincount(word[v], minlength=words)
        total += int((per_word * (per_word - 1) // 2).sum())
        # the earliest word before its own whose kept box suppresses a box
        hits = (_overlap_matrix(b, mode) >= thresh) & k[:, None] & (word[:, None] < word[None, :])
        first = torch.where(hits, word[:, None], words).amin(dim=0)
        kept_through = torch.cumsum(torch.bincount(word[k], minlength=words), 0)
        upto = torch.minimum(word - 1, first)  # the last word whose push tests the box
        tested = torch.where(upto >= 0, kept_through[upto.clamp(min=0)], 0)
        total += int((tested * v).sum())
    return total


def k2_timings() -> dict:
    """K2 at each case of K2_TIMED: _kernel_timings as for K1 and the bound
    from the pair tests the greedy walk needs.  Raises if a keep mask
    differs from the plain version's."""
    from fdt_torch.geometry.nms import nms_keep_mask
    from fdt_torch.ops import nms as nms_op

    out = {}
    for name, (seed, p, n, spread, mode, thresh) in K2_TIMED.items():
        boxes, valid, _ = _nms_case(seed, p, n, spread, False)

        def call():
            return nms_op.nms_keep_greedy(boxes, valid, thresh, mode=mode)

        keep = nms_keep_mask(boxes, valid, thresh, mode=mode)
        if not torch.equal(call(), keep):
            raise AssertionError(f"K2 != plain: {name}")
        out[name] = {
            **_kernel_timings(call, _pairs_needed(boxes, valid, keep, thresh, mode), valid),
            "keeps": keep.sum(-1).tolist()}
    return out


def k2_design() -> dict:
    """This checkout's K2 at each case of K2_TIMED: its blocks a problem (the
    cluster size), the clusters the card runs at once and the pair tests it
    computes."""
    from fdt_torch.geometry.nms import nms_keep_mask
    from fdt_torch.ops._build import library

    lib = library()
    out = {}
    for name, (seed, p, n, spread, mode, thresh) in K2_TIMED.items():
        boxes, valid, _ = _nms_case(seed, p, n, spread, False)
        keep = nms_keep_mask(boxes, valid, thresh, mode=mode)
        out[name] = {"cluster": lib.fdt_nms_greedy_cluster(),
                     "max_clusters": lib.fdt_nms_greedy_max_clusters(n),
                     "pairs_computed": _k2_pairs_computed(boxes, valid, keep, thresh, mode)}
    return out


def phase_k2(device):
    """K2 against its plain version and against K1 without out_k, bit-equal
    keep masks, on the cases of tests/test_pallas_nms.py:10-37 (N = 200 and
    300, seeds 0 and 1, union and minimum, the valid-mask case), a zero-area
    box, N = 1000, FaceBoxes' shape (P = 16, N = 2048), the flagship's
    (P = 8, N = 5000) and its edges (K2_EDGES); then timed on K2_TIMED."""
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
    for name, (seed, p, n, spread, mode, thresh) in K2_TIMED.items():
        cases.append((name, *_nms_case(seed, p, n, spread, False)[:2], mode, thresh))
    for name in K2_EDGES:
        boxes, valid, mode, thresh = k2_edge_case(name)
        cases.append((name, torch.from_numpy(boxes).to(device), torch.from_numpy(valid).to(device),
                      mode, thresh))
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

    timed = k2_timings()
    design = k2_design()
    for name, t in timed.items():
        t.update(design[name])
        seed, p, n, spread, mode, thresh = K2_TIMED[name]
        boxes, valid, _ = _nms_case(seed, p, n, spread, False)
        t.update(
            k1_ms=_cuda_ms(lambda: nms_op.nms_keep_tiled(boxes, valid, thresh, mode=mode), 20),
            plain_ms=_cuda_ms(lambda: nms_keep_mask(boxes, valid, thresh, mode=mode), 2))
    fb, fl = timed["facebox-16x2048"], timed["flagship-8x5000"]
    _phase("kernels_k2", t0, cases=len(cases), edges=len(K2_EDGES), cluster=fb["cluster"],
           k2_ms_16x2048=f"{fb['ms']:.4f}", plain_ms_16x2048=f"{fb['plain_ms']:.4f}",
           bound_ms_16x2048=f"{fb['bound_ms']:.6f}", k1_full_ms_16x2048=f"{fb['k1_ms']:.4f}",
           pairs_16x2048=fb["pairs"],
           k2_ms_8x5000=f"{fl['ms']:.4f}", plain_ms_8x5000=f"{fl['plain_ms']:.4f}",
           bound_ms_8x5000=f"{fl['bound_ms']:.6f}", k1_full_ms_8x5000=f"{fl['k1_ms']:.4f}",
           pairs_8x5000=fl["pairs"], keeps_8x5000=fl["keeps"])
    for name, t in timed.items():
        _kernel_line("k2", name, t["split"], t["sequence"], ms=f"{t['ms']:.4f}",
                     device_ms="not_measured" if t["device_ms"] is None
                     else f"{t['device_ms']:.4f}",
                     host_ms=f"{t['host_ms']:.4f}", bound_ms=f"{t['bound_ms']:.6f}",
                     cluster=t["cluster"], max_clusters=t["max_clusters"],
                     pairs_needed=t["pairs"], pairs_computed=t["pairs_computed"])
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
    model = load_pyramidbox(str(WEIGHTS))
    det32 = PyramidBoxDetector(model, device=device)  # precision="highest"
    threshs = dict(conf_thresh=float(g["conf_thresh"]), nms_thresh=float(g["nms_thresh"]))
    with _tf32(True):  # the global flags on: the detector turns TF32 off itself
        rows = det32.detect_tensor(frame[None], **threshs)[0, 1]
        tf32_rows = PyramidBoxDetector(model, device=device, precision="default").detect_tensor(
            frame[None], **threshs)[0, 1]
    err = match_rows(rows, g["rows"], GOLDEN_ROWS, GOLDEN_TOL)
    _phase("flagship_f32", t0, size=f"{w}x{h}", count=int((rows[:, 0] > 0).sum()),
           golden_count=int(g["count"]), max_abs_err=f"{err:.3g}",
           tf32_scores_max_abs_diff=f"{_score_diff(tf32_rows, g['rows']):.3g}")

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
    out_k = captured["kwargs"]["out_k"]
    full = nms_keep_mask(boxes, valid, thresh)
    boxes_err = _mask_err(kernel(*captured["args"], **captured["kwargs"]), full, out_k)
    if boxes_err != 0:
        raise AssertionError("K1 != plain on the flagship's boxes")
    real_ms = _cuda_ms(lambda: kernel(*captured["args"], **captured["kwargs"]), 20)
    split, sequence = _device_split(lambda: kernel(*captured["args"], **captured["kwargs"]))
    # where each problem's walk ends: the box of its out_k-th keep
    ends = [int(torch.nonzero(k)[min(out_k, int(k.sum())) - 1])
            for k in full.reshape(-1, full.shape[-1])]
    _kernel_line("k1", "flagship-own-boxes", split, sequence, ms=f"{real_ms:.4f}", walk_ends=ends,
             pairs_needed=_pairs_needed(boxes, valid, full, thresh, out_k=out_k),
             pairs_computed=_pairs_computed(boxes, valid, full, thresh, out_k=out_k))
    _phase("flagship_bf16", t0, batch=BATCH, images_per_s=f"{max(rates):.2f}",
           rates=[round(r, 2) for r in rates], spread_pct=f"{spread:.2f}",
           k1_launches=launches, count_035=(out[:, 1, :, 0] > 0).sum(axis=1).tolist(),
           count_001=dense_count.tolist(), k1_flagship_boxes_ms=f"{real_ms:.4f}",
           k1_shape=list(boxes.shape))
    return det32, launches, boxes_err


def _spread(rates) -> float:
    return (max(rates) - min(rates)) / max(rates) * 100


def phase_facebox(device):
    """FaceBoxes at 1024² on seeded weights: a float32 frame (the default
    precision="highest") against fdt's golden, images/s at batch 16
    (precision="default", TF32 allowed, bench.py's mode), then this slice's
    path: the detect (K1 through
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
    det = FaceBoxDetector(model, device=device)  # precision="highest"
    fast = FaceBoxDetector(model, device=device, precision="default")  # bench.py's
    with _tf32(True):  # the global flags on: the detector turns TF32 off itself
        (boxes, scores), = det.detect_batch(frame[None])
        (tf32_boxes, tf32_scores), = fast.detect_batch(frame[None])
    err = match_rows(np.column_stack([scores, boxes]), g["rows"], GOLDEN_ROWS, GOLDEN_TOL)
    tf32_diff = _score_diff(np.column_stack([tf32_scores, tf32_boxes]), g["rows"])
    _phase("facebox_f32", t0, size=f"{size}x{size}", count=len(scores),
           golden_count=int(g["count"]), max_abs_err=f"{err:.3g}",
           tf32_scores_max_abs_diff=f"{tf32_diff:.3g}")

    t0 = time.perf_counter()
    frames = np.random.RandomState(3).randint(0, 256, (FACEBOX_BATCH, size, size, 3),
                                              dtype=np.uint8)
    staged = torch.from_numpy(frames).to(device)
    cfg = fast.cfg
    _warm(lambda: fast.detect_device(staged))
    rates = _rates(lambda: fast.detect_device(staged), FACEBOX_BATCH)
    cand_boxes, probs = fast.candidates(staged)
    valid = probs > cfg.conf_thresh
    nms = {impl: lambda impl=impl: nms_padded(
        cand_boxes, probs, cfg.nms_thresh, budget=fast.budget, out_k=fast.out_k,
        valid=valid, impl=impl) for impl in ("pallas", "pallas_tiled")}
    nms_op.launches.reset()
    nms_op.greedy_launches.reset()
    out = fast.detect_device(staged)             # this slice's path
    idx2, count2 = nms["pallas"]()
    idx1, count1 = nms["pallas_tiled"]()
    k1_launches, k2_launches = nms_op.launches.count, nms_op.greedy_launches.count
    nms_ms = {impl: _cuda_ms(fn, 20) for impl, fn in nms.items()}
    if k2_launches != 1 or k1_launches != 2:
        raise AssertionError(f"FaceBoxes path: {k1_launches} K1 and {k2_launches} K2 "
                             "launches (want 2 and 1)")
    count = out[2]
    if (out[0].shape != (FACEBOX_BATCH, fast.out_k, 4) or not torch.isfinite(out[0]).all()
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
        with _tf32(True):  # the global flags on: the detector turns TF32 off itself
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
        "bound_by": k1["bound_by"], "library_ms": None,
        "device_ms": k1["device_ms"], "host_ms": k1["host_ms"]}, {
        "name": "nms_greedy (K2)", "route": "cuda",
        "source": "fdt_torch/csrc/nms_greedy.cu",
        "replaces": "fdt/ops/pallas_nms.py:31",
        "launches": k2_launches, "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None,
        "device_ms": k2["device_ms"], "host_ms": k2["host_ms"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
