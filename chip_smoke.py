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
  7. mtcnn  — the MTCNN cascade at bench.py's configuration (480×640, batch
               32, the ladder FAST → MID → full) on seeded weights: the
               "sparse" golden batch against fdt's (counts, flags and tier
               equal, scores within 1e-3, boxes and landmarks within 1e-2
               px); on both settings the batch-32 call, 4 K1 launches a tier
               run, images/s and the tier; K1 on the saturated cascade's own
               per-level candidates (32 × 8192, segmented) bit-equal to its
               plain version and timed; the batch's first frame against
               detect_face; DetectionService("mtcnn") under 4 threads.
  8. tracking — bench.py's tracker configuration (64 frames of 480×640 panned
               6 px a frame, chunks of 16, rows capped at 32, t_max 256): K3
               (the greedy association scan; a shared-memory variant and a
               device-memory one for shapes past it) against its plain
               version, records and state bit-equal, on TRACK_EDGES and random
               streams, and on a tracker that grows past the shared-memory
               variant (both variants launched); K3 timed at bench.py's
               density and the device-memory variant at t-over-smem, beside
               the plain version on the card; on trained and seeded flagship
               weights the fused tracker
               (one K1 call and one K3 launch a chunk), its frames/s and those
               of the device-rows and host-rows legs, its tracks bit-equal to
               the unfused path's (also through the grow-and-redo path), and a
               torch.profiler split of one fused chunk.
  9. serving — DetectionService answers 16 requests from 4 threads (float32)
               for the pyramidbox family (640²) and the facebox family (mixed
               sizes); each answer agrees with the direct call on its frame,
               up to the summation order of another batch size.
Then a JSON line of the kernels and, last, {"ok": true, "device": {...}}.
Any failure exits non-zero; a hang exits non-zero with a traceback.
"""
from __future__ import annotations

import contextlib
import dataclasses
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


# MTCNN: bench.py's configuration (bench.py:244-281), 480×640 frames at batch
# 32 through the budget ladder FAST → MID → full, on weights made from a seed
# (the reference .pt files are not in the repo), in two settings:
# "saturated", the plain seeded nets, whose PNet passes more than 8192 cells
# of a 480×640 frame, so that every budget fills; "sparse", the same nets
# with PNet's score bias and RNet's shifted down, so that a 480×640 frame
# overflows FAST_BUDGETS (its per-level survivors pass FAST's merge_k of 512,
# not MID's 1024) and settles on MID_BUDGETS, as bench.py's own frame does
# (bench.py:250-252).  RNet's shift is needed too: the seeded RNet passes
# every crop, which would fill ONet's 128 candidates in every tier.
MTCNN_H, MTCNN_W, MTCNN_BATCH = 480, 640, 32
MTCNN_WEIGHTS_SEED = 1
MTCNN_SHIFTS = {"saturated": {},
                "sparse": {"pnet": ("conv4_1", 0.6), "rnet": ("conv5_1", 1.6)}}
MTCNN_GOLDEN = GOLDEN_DIR / "mtcnn_sparse.npz"
MTCNN_FRAME_SEEDS = (0, 1)  # the sparse golden's batch
MTCNN_PX_TOL = 1e-2  # golden boxes and landmarks, pixels


# IoU tracking: bench.py's tracker configuration (bench.py:501-571), the
# fused detect + associate of 64 frames of 480×640 panned 6 px a frame, in
# chunks of 16, rows capped at 32 a frame, 256 slots to start; the detect's
# conf threshold is the tracker's score floor (TRACKER's 0.4)
TRACK_H, TRACK_W, TRACK_FRAMES, TRACK_BATCH = 480, 640, 64, 16
TRACK_PAN_PX, TRACK_DET_CAP, TRACK_T_MAX = 6, 32, 256
TRACK_NMS = 0.35
TRACK_PASSES = 3
TRACK_WEIGHTS_SEED = 0
# The fused-against-unfused check runs at bench.py's TRACKER and again at a
# setting under which the compared tracks are not empty.  TRACKER finishes
# no track on these frames: the trained weights pass no row of a noise frame
# at the 0.4 floor (every frame is the sentinel row), and the seeded ones
# score all 750 rows 1.0 with boxes that are not finite (a coordinate NaN or
# -inf), so every IoU is NaN and no row extends a track.  At TRACK_CHECK
# every track that was extended once finishes when it ends, and the flush
# emits every live one; the trained check detects at a floor that passes
# about 8 rows a frame, where rows do extend tracks.
TRACK_CHECK = {"sigma_h": 0.0, "t_min": 1}
TRACK_CHECK_ROWS = 8


def bench_frame(h: int, w: int) -> np.ndarray:
    """bench.py's frame where its sample image is absent (bench.py:103-109)."""
    return (np.random.RandomState(0).rand(h, w, 3) * 255).astype(np.uint8)


def pan_frames(frame: np.ndarray, frames: int, step: int = TRACK_PAN_PX) -> np.ndarray:
    """[frames, H, W, 3]: frame k is `frame` shifted left by step·k pixels,
    the border reflected with its edge repeated, which is bench.py's
    cv2.warpAffine(frame, [[1, 0, -step·k], [0, 1, 0]], BORDER_REFLECT)."""
    w = frame.shape[1]
    ext = np.pad(frame, ((0, 0), (0, step * (frames - 1)), (0, 0)), mode="symmetric")
    return np.stack([ext[:, step * k:step * k + w] for k in range(frames)])


def track_stream(seed: int, frames: int = 40, walkers: int = 6, clutter: float = 1.0,
                 extent: float = 400.0) -> list:
    """Synthetic detection stream, [N, 5] float32 rows a frame: drifting
    boxes, clutter and dropouts.  The defaults are tests/test_tracker.py's
    _random_stream (:94-117), draw for draw."""
    rng = np.random.RandomState(seed)
    walk = [(rng.rand(2) * extent, 20 + rng.rand() * 60, 0.3 + rng.rand() * 0.7)
            for _ in range(walkers)]
    stream = []
    for _ in range(frames):
        rows = []
        for i, (c, s, q) in enumerate(walk):
            if rng.rand() < 0.15:      # dropout
                continue
            c = c + rng.randn(2) * 4
            walk[i] = (c, s, q)
            rows.append([c[0] - s / 2, c[1] - s / 2, c[0] + s / 2, c[1] + s / 2,
                         np.clip(q + rng.randn() * 0.1, 0, 1)])
        for _ in range(rng.poisson(clutter)):
            c = rng.rand(2) * extent
            s = 10 + rng.rand() * 40
            rows.append([c[0], c[1], c[0] + s, c[1] + s, rng.rand() * 0.5])
        if rng.rand() < 0.07:
            rows = []                  # empty frame (the silent-drop quirk)
        stream.append(np.asarray(rows, np.float32).reshape(-1, 5))
    return stream


def pad_rows(rows_list, n: int):
    """[F, n, 4] boxes, [F, n] scores and [F, n] valid (numpy) from F frames
    of at most n rows, as DeviceIoUTracker pads them."""
    f = len(rows_list)
    boxes = np.zeros((f, n, 4), np.float32)
    scores = np.zeros((f, n), np.float32)
    valid = np.zeros((f, n), bool)
    for i, rows in enumerate(rows_list):
        rows = np.asarray(rows, np.float32).reshape(-1, 5)
        boxes[i, :len(rows)] = rows[:, :4]
        scores[i, :len(rows)] = rows[:, 4]
        valid[i, :len(rows)] = True
    return boxes, scores, valid


# K3's edges: frames with no rows (the silent drop) and with only the
# sentinel row; a sentinel-born track meeting a zero-area row (IoU 0/0 =
# NaN, taken first by the argmax, so no match); exact ties in IoU and in
# distance; IoU and distance mode on random streams; pad widths N = 1, 32
# (one detection a lane), 33, 64 and 750 (top_k; 32 a lane); a chunk that
# overflows t_max = 8; a walk over more than 64 live tracks; an IoU of -0.0
# (degenerate boxes) tied with +0.0 at a match; infinite box coordinates
# (infinite and NaN affinities) in both modes; a T whose state does not fit
# in shared memory (the device-memory variant); more live slots than one
# tile of affinities holds.
TRACK_EDGES = ("empty-frames", "sentinel-only", "nan-sentinel-meets-zero-area", "iou-ties",
               "distance-ties", "iou-mode", "distance-mode", "n1", "n32", "n33", "n64",
               "n750", "overflow-t8", "live-over-64", "signed-zero", "inf-boxes",
               "inf-boxes-distance", "t-over-smem", "tile-rows")
SENTINEL_ROW = [0.0, 0.0, 0.0, 0.0, 0.4]


def unpad_rows(chunks) -> list:
    """The [N, 5] rows of every frame of pad_rows chunks, in order."""
    return [np.column_stack([b[v], s[v]]) for c in chunks for b, s, v in zip(*c)]


def track_edge_case(name: str):
    """One case of TRACK_EDGES: (TrackerConfig, t_max, chunks), each chunk
    the (boxes, scores, valid) numpy arrays of pad_rows, run in order from
    empty slots."""
    from fdt_torch.config import TrackerConfig

    cfg, t_max = TrackerConfig(t_min=2, sigma_h=0.3), 64
    rows = lambda r: np.asarray(r, np.float32).reshape(-1, 5)  # noqa: E731
    if name == "empty-frames":
        stream = track_stream(1, 14)
        for k in (3, 4, 9):
            stream[k] = rows([])
        split, n = 6, 8
    elif name == "sentinel-only":
        stream, split, n = [rows([SENTINEL_ROW])] * 8, 3, 1
    elif name == "nan-sentinel-meets-zero-area":
        a = [[0, 0, 10, 10, 0.8], [5, 5, 5, 5, 0.9]]   # a box, then a zero-area one
        b = [[5, 5, 5, 5, 0.9], [1, 0, 11, 10, 0.8]]   # the zero-area one first
        stream = [rows([SENTINEL_ROW]), rows(a), rows([SENTINEL_ROW]), rows(b), rows(a),
                  rows([SENTINEL_ROW]), rows([SENTINEL_ROW]), rows(b)]
        split, n = 4, 2
    elif name == "iou-ties":
        # two identical boxes a frame, and a track between two detections of
        # equal IoU (mirrored shifts): the first index wins
        box = [10, 10, 20, 20, 0.9]
        stream = [rows([box, box]), rows([box, box]),
                  rows([[12, 10, 22, 20, 0.9], [8, 10, 18, 20, 0.7]]),
                  rows([[10, 10, 20, 20, 0.9], [14, 10, 24, 20, 0.9], [6, 10, 16, 20, 0.9]])]
        split, n = 2, 3
    elif name == "distance-ties":
        cfg = TrackerConfig(use_iou=False, sigma_dis=8.0, t_min=1, sigma_h=0.3)
        box = [10, 10, 20, 20, 0.9]
        stream = [rows([box, box]), rows([[13, 10, 23, 20, 0.8], [7, 10, 17, 20, 0.8]]),
                  rows([box, [10, 13, 20, 23, 0.5], [10, 7, 20, 17, 0.5]])]
        split, n = 1, 3
    elif name in ("iou-mode", "distance-mode"):
        cfg = TrackerConfig(use_iou=name == "iou-mode", t_min=3)
        stream, split, n = track_stream(7 if name == "iou-mode" else 11), 17, 16
    elif name == "n1":
        stream, split, n = [r[:1] for r in track_stream(2, 20)], 9, 1
    elif name in ("n32", "n33", "n64"):
        n = int(name[1:])
        t_max = 2 * n
        stream = [r[:n] for r in track_stream(n, 20, walkers=n, clutter=3.0, extent=900.0)]
        split = 7
    elif name == "n750":
        t_max, n = 1024, 750
        stream = [r[:n] for r in track_stream(750, 3, walkers=860, clutter=20.0,
                                              extent=6000.0)]
        split = 1
    elif name == "overflow-t8":
        # 24 well-separated persistent boxes, three times t_max
        cfg, t_max = TrackerConfig(t_min=1), 8
        rng = np.random.RandomState(0)
        base = np.stack([np.arange(24) * 50.0, np.zeros(24), np.arange(24) * 50.0 + 40,
                         np.full(24, 40.0), np.full(24, 0.9)], 1).astype(np.float32)
        stream = [base + rng.rand(*base.shape).astype(np.float32) for _ in range(6)]
        split, n = 2, 24
    elif name == "live-over-64":
        t_max, n = 128, 96
        stream = [r[:n] for r in track_stream(64, 8, walkers=84, clutter=2.0,
                                               extent=2500.0)]
        split = 3
    elif name == "signed-zero":
        # a box of negative area (x2 < x1) against a last box of smaller
        # area: inter 0, union negative, IoU -0.0, tied with a far box's
        # +0.0; sigma_iou < 0, so a zero matches and the tie decides which
        # (frame 1: -0.0 first; frame 2: +0.0 first, then -0.0)
        cfg = TrackerConfig(sigma_iou=-0.5, t_min=1, sigma_h=0.3)
        stream = [rows([[0, 0, 5, 5, 0.9]]),
                  rows([[10, 0, 0, 10, 0.7], [100, 100, 110, 110, 0.8]]),
                  rows([[300, 300, 320, 320, 0.6], [500, 500, 505, 505, 0.9]]),
                  rows([[600, 600, 605, 605, 0.5], [20, 0, 10, 10, 0.8], [5, 5, 0, 0, 0.4]]),
                  rows([[10, 0, 0, 10, 0.7], [100, 100, 110, 110, 0.8], [0, 0, 5, 5, 0.9]]),
                  rows([[300, 300, 320, 320, 0.6], [500, 500, 505, 505, 0.9],
                        [7, 3, 1, 1, 0.5]])]
        split, n = 3, 3
    elif name in ("inf-boxes", "inf-boxes-distance"):
        cfg = TrackerConfig(use_iou=name == "inf-boxes", t_min=1, sigma_h=0.3)
        inf = np.inf
        frame = [[0, 0, 10, 10, 0.9], [20, 0, 30, 10, 0.8], [0, 0, inf, 10, 0.7],
                 [-inf, -inf, inf, inf, 0.6], [inf, inf, inf, inf, 0.5], [-inf, 0, 10, 10, 0.4]]
        rng = np.random.RandomState(5)
        stream = [rows([frame[i] for i in rng.permutation(6)[:4 + k % 3]]) for k in range(8)]
        split, n = 4, 6
    elif name == "t-over-smem":
        # the slot state alone (41 B a slot) is past the 227 KB of shared
        # memory a block may take
        t_max, n = 6144, 32
        stream = [r[:n] for r in track_stream(21, 10, walkers=24, clutter=3.0, extent=900.0)]
        split = 5
    elif name == "tile-rows":
        # about 170 live slots against tiles of 97 rows (N = 256, T = 512)
        t_max, n = 512, 256
        stream = [r[:n] for r in track_stream(97, 6, walkers=200, clutter=4.0,
                                               extent=3000.0)]
        split = 3
    else:
        raise KeyError(name)
    return cfg, t_max, [pad_rows(stream[:split], n), pad_rows(stream[split:], n)]


def mtcnn_variables(setting: str) -> tuple:
    """flax-layout variables of (PNet, RNet, ONet) for a setting of
    MTCNN_SHIFTS: seeded_variables with the setting's bias shifts."""
    from fdt_torch.models import ONet, PNet, RNet

    out = []
    for name, model in (("pnet", PNet()), ("rnet", RNet()), ("onet", ONet())):
        variables = seeded_variables(model, MTCNN_WEIGHTS_SEED)
        if name in MTCNN_SHIFTS[setting]:
            layer, shift = MTCNN_SHIFTS[setting][name]
            params = variables["params"][layer]
            params["bias"] = params["bias"] - np.float32(shift)
        out.append(variables)
    return tuple(out)


def variant_golden(variant: str) -> pathlib.Path:
    return GOLDEN_DIR / f"{variant}.npz"


def seeded_variables(model: torch.nn.Module, seed: int) -> dict:
    """flax-layout variables for the port's `model`, filled from a numpy seed:
    He-scaled HWIO conv kernels and [in, out] Dense kernels, small biases,
    BatchNorm scale and statistics away from identity (var drawn positive),
    one PReLU slope in 0.1-0.3.  Module names are the torch
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
        elif isinstance(mod, torch.nn.Linear):
            o, i = mod.weight.shape
            params[key] = {"kernel": (rng.randn(i, o) * np.sqrt(2.0 / i)).astype(np.float32),
                           "bias": (rng.randn(o) * 0.05).astype(np.float32)}
        elif isinstance(mod, torch.nn.PReLU):
            params[key] = {"negative_slope": np.float32(rng.uniform(0.1, 0.3))}
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


def match_detections(got_boxes, got_lm, want_boxes, want_lm, score_tol: float, px_tol: float,
                     window: int = 3) -> tuple[float, float]:
    """Compare two score-sorted MTCNN detection lists of one image, [N, 5]
    boxes and [N, 10] landmarks; return (largest score difference, largest
    pixel difference).

    Counts must be equal.  Scores are compared position by position; a row
    whose box and landmarks differ by more than px_tol may have swapped with
    a near-tied neighbour: it must then match a row within `window` places
    whose score is within score_tol.  Raises AssertionError."""
    got_boxes, want_boxes = np.asarray(got_boxes), np.asarray(want_boxes)
    if len(got_boxes) != len(want_boxes):
        raise AssertionError(f"counts differ: {len(got_boxes)} against {len(want_boxes)}")
    if not len(want_boxes):
        return 0.0, 0.0
    score_err = float(np.abs(got_boxes[:, 4] - want_boxes[:, 4]).max())
    got = np.column_stack([got_boxes[:, :4], got_lm])
    want = np.column_stack([want_boxes[:, :4], want_lm])
    px_err = 0.0
    for i in range(len(got)):
        lo, hi = max(0, i - window), min(len(want), i + window + 1)
        px = np.abs(want[lo:hi] - got[i]).max(axis=1)
        if px[i - lo] > px_tol:
            tied = np.abs(want_boxes[lo:hi, 4] - got_boxes[i, 4]) <= score_tol
            px = px[tied] if tied.any() else px[i - lo:i - lo + 1]
            px_err = max(px_err, float(px.min()))
        else:
            px_err = max(px_err, float(px[i - lo]))
    if score_err > score_tol or px_err > px_tol:
        raise AssertionError(f"detections differ: scores by {score_err:.3g} (tolerance "
                             f"{score_tol}), pixels by {px_err:.3g} (tolerance {px_tol})")
    return score_err, px_err


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


def _device_split(fn, iters: int = 10, pattern: str = r"nms_\w+_kernel"):
    """Device time of each CUDA kernel whose name matches `pattern` (K1's
    and K2's `nms_*` by default) that fn() launches, from torch.profiler:
    ({kernel: {"us": mean µs a call, "launches": a call}}, [[kernel, µs] of
    each launch of the last call, in order]).  Both empty when the profiler
    records no device time."""
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
        name = re.search(pattern, event.name)
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


def mtcnn_cascade(setting: str, device, **kw):
    """The port's MTCNN cascade on `setting`'s seeded weights with bench.py's
    ladder (FAST → MID over the full DeviceBudgets); **kw go to the
    cascade."""
    from fdt_torch.infer import FAST_BUDGETS, MID_BUDGETS, MTCNNDeviceCascade
    from fdt_torch.models import load_mtcnn_nets

    return MTCNNDeviceCascade(*load_mtcnn_nets(*mtcnn_variables(setting)), device=device,
                              fast_budgets=(FAST_BUDGETS, MID_BUDGETS), **kw)


def check_mtcnn_golden(cascade) -> dict:
    """The sparse golden's batch through `cascade` (mtcnn_cascade("sparse")):
    counts, saturated flags and tier equal to fdt's, scores within
    GOLDEN_TOL and boxes and landmarks within MTCNN_PX_TOL, near-tied rows
    matched (match_detections).  Returns the largest differences."""
    g = np.load(MTCNN_GOLDEN)
    h, w = int(g["height"]), int(g["width"])
    images = np.stack([golden_frame(int(seed), h, w) for seed in g["frame_seeds"]])
    if hashlib.sha256(images.tobytes()).hexdigest() != str(g["frame_sha256"]):
        raise AssertionError("the seeded frames differ from the MTCNN golden's")
    boxes, lms, counts, sat = cascade.detect_batch(images)
    if (counts.tolist() != g["counts"].tolist() or sat.tolist() != g["saturated"].tolist()
            or cascade.last_tier != str(g["tier"])):
        raise AssertionError(f"MTCNN golden: counts {counts.tolist()}, saturated "
                             f"{sat.tolist()}, tier {cascade.last_tier}; fdt's "
                             f"{g['counts'].tolist()}, {g['saturated'].tolist()}, {g['tier']}")
    errs = [match_detections(boxes[i, :c], lms[i, :c], g["boxes"][i, :c], g["landmarks"][i, :c],
                             GOLDEN_TOL, MTCNN_PX_TOL) for i, c in enumerate(counts)]
    return {"counts": counts.tolist(), "tier": cascade.last_tier,
            "score_err": max(e[0] for e in errs), "px_err": max(e[1] for e in errs)}


def _count_tier_runs(cascade) -> list:
    """Wrap cascade._run to append each run's tier to the returned list."""
    runs = []
    run = cascade._run

    def counted(images, tier="full", **kw):
        runs.append(tier)
        return run(images, tier, **kw)

    cascade._run = counted
    return runs


def _mtcnn_main_path(name, cascade, staged) -> dict:
    """The batch-32 ladder call on staged frames: K1 launches 4 times a tier
    run (checked on the first call, which may climb the ladder, and on one
    after), valid outputs, then images/s by CUDA events (2 s warm-up, best
    of 3 blocks of 5)."""
    from fdt_torch.ops import nms as nms_op

    runs = _count_tier_runs(cascade)
    launches, tiers = 0, []
    for _ in range(2):
        runs.clear()
        nms_op.launches.reset()
        boxes, lms, counts, sat = cascade.detect_device(staged)  # the main path
        torch.cuda.synchronize()
        if not runs or nms_op.launches.count != 4 * len(runs):
            raise AssertionError(f"{name}: {nms_op.launches.count} K1 launches in "
                                 f"{len(runs)} tier runs {runs} (want 4 a run)")
        launches += nms_op.launches.count
        tiers.append(list(runs))
    b = staged.shape[0]
    live = torch.arange(boxes.shape[1], device=boxes.device) < counts[:, None]
    if (boxes.shape != (b, 256, 5) or lms.shape != (b, 256, 10)
            or not torch.isfinite(boxes[live]).all() or not torch.isfinite(lms[live]).all()
            or not bool((counts > 0).all())):
        raise AssertionError(f"{name}: bad output {tuple(boxes.shape)}, counts "
                             f"{counts.tolist()}")
    _warm(lambda: cascade.detect_device(staged))
    rates = _rates(lambda: cascade.detect_device(staged), b)
    return {"launches": launches, "tiers": tiers, "tier": cascade.last_tier,
            "rates": rates, "counts": counts.tolist(), "saturated": sat.tolist(),
            "boxes": boxes, "lms": lms}


# K3's kernels, both variants (and the one of a checkout from before them)
K3_KERNELS = r"track_assoc_(?:smem_|global_)?kernel"
# kernel name → part of a detect, first match wins (PyTorch's, cuDNN's and
# cuBLAS's kernel names; K1's are nms_*_kernel)
KERNEL_PARTS = (("k1", r"nms_\w+_kernel"), ("k3", K3_KERNELS),
                ("sort", r"[Ss]ort|[Rr]adix"),
                ("conv_matmul", r"conv|cudnn|xmma|gemm|cutlass|implicit|winograd|fft"),
                ("gather_index", r"[Gg]ather|[Ii]ndex|[Ss]catter"))


def _time_split(fn, iters: int = 3) -> dict:
    """One call of fn() by torch.profiler: its host wall ms, the device ms of
    its kernels by part (KERNEL_PARTS, the rest "elementwise_other"), the
    share of the wall time in which the card ran none of them (the kernels
    of one stream do not overlap) and the 8 kernels that took longest.
    Empty parts when the profiler records no device time."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
    parts, kernels = {}, {}
    for event in prof.events():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = event.time_range.elapsed_us() / iters / 1e3
        part = next((p for p, rx in KERNEL_PARTS if re.search(rx, event.name)),
                    "elementwise_other")
        parts[part] = parts.get(part, 0.0) + ms
        kernels[event.name] = kernels.get(event.name, 0.0) + ms
    device_ms = sum(parts.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_pct": 100 * (1 - device_ms / wall_ms) if parts else None, "parts": parts,
            "top": top}


def phase_mtcnn(device):
    """MTCNN at bench.py's configuration (480×640, batch 32, the ladder FAST
    → MID → full): the sparse golden with the global TF32 flags on; the
    batch-32 main path on both weight settings (4 K1 launches a tier run,
    images/s, the tier); K1 on the saturated cascade's own per-level
    candidates (P = 32, N = 8192, segmented), bit-equal to its plain
    version, timed; detect_batch against detect_face on one frame; then
    DetectionService("mtcnn") under 4 client threads.  Returns K1's launches
    on the main path and its largest mask difference."""
    from fdt_torch.apps.serving import DetectionService, resize_bilinear
    from fdt_torch.geometry.nms import nms_keep_mask
    from fdt_torch.ops import nms as nms_op

    t0 = time.perf_counter()
    sparse = mtcnn_cascade("sparse", device)  # precision="highest"
    with _tf32(True):  # the global flags on: the cascade turns TF32 off itself
        golden = check_mtcnn_golden(sparse)
    _phase("mtcnn_golden", t0, counts=golden["counts"], tier=golden["tier"],
           max_score_err=f"{golden['score_err']:.3g}", max_px_err=f"{golden['px_err']:.3g}")

    frames = np.random.RandomState(4).randint(0, 256, (MTCNN_BATCH, MTCNN_H, MTCNN_W, 3),
                                              dtype=np.uint8)
    staged = torch.from_numpy(frames).to(device)
    launches = 0
    cascades = {"sparse": sparse, "saturated": mtcnn_cascade("saturated", device)}
    outs = {}
    for setting, cascade in cascades.items():
        t0 = time.perf_counter()
        out = outs[setting] = _mtcnn_main_path(f"mtcnn_{setting}", cascade, staged)
        launches += out["launches"]
        rates = out["rates"]
        _phase(f"mtcnn_{setting}", t0, batch=MTCNN_BATCH, size=f"{MTCNN_W}x{MTCNN_H}",
               images_per_s=f"{max(rates):.2f}", rates=[round(r, 2) for r in rates],
               spread_pct=f"{_spread(rates):.2f}", tier=out["tier"],
               tier_runs=out["tiers"], k1_launches_per_call=4 * len(out["tiers"][-1]),
               k1_launches=out["launches"], counts_min_max=[min(out["counts"]),
                                                            max(out["counts"])],
               saturated=sum(out["saturated"]))
        split = _time_split(lambda: cascade.detect_device(staged))
        print(f"[mtcnn] {setting} wall_ms={split['wall_ms']:.3f} "
              f"device_ms={split['device_ms']:.3f} idle_pct="
              + ("not_measured" if split["idle_pct"] is None else f"{split['idle_pct']:.1f}")
              + " " + " ".join(f"{k}_ms={v:.3f}" for k, v in sorted(
                  split["parts"].items(), key=lambda kv: -kv[1])), flush=True)
        for name, ms in split["top"]:
            print(f"[mtcnn]   {setting} {ms:8.3f} ms {name[:110]}", flush=True)

    # K1 on the saturated cascade's own per-level candidates
    t0 = time.perf_counter()
    saturated = cascades["saturated"]
    boxes, valid, seg = saturated.pnet_candidates(staged, tier="full")

    def call():
        return nms_op.nms_keep_tiled(boxes, valid, 0.4, mode="minimum", seg_id=seg)

    keep = call()
    mask_err = 0.0
    for p in range(0, MTCNN_BATCH, 2):  # the plain version's [P, N, N] temporaries
        want = nms_keep_mask(boxes[p:p + 2], valid[p:p + 2], 0.4, mode="minimum",
                             seg_id=seg[p:p + 2])
        mask_err = max(mask_err, _mask_err(keep[p:p + 2], want, None))
    if mask_err != 0:
        raise AssertionError("K1 != plain on the saturated cascade's MTCNN candidates")
    pairs = _pairs_needed(boxes, valid, keep, 0.4, "minimum", seg=seg)
    timed = _kernel_timings(call, pairs, valid)
    plain_ms = _cuda_ms(lambda: nms_keep_mask(boxes[:2], valid[:2], 0.4, mode="minimum",
                                              seg_id=seg[:2]), 2)
    _kernel_line("k1", f"mtcnn-saturated-{MTCNN_BATCH}x{boxes.shape[1]}-seg", timed["split"],
                 timed["sequence"], ms=f"{timed['ms']:.4f}",
                 device_ms="not_measured" if timed["device_ms"] is None
                 else f"{timed['device_ms']:.4f}",
                 host_ms=f"{timed['host_ms']:.4f}", bound_ms=f"{timed['bound_ms']:.6f}",
                 bound_by=timed["bound_by"], pairs_needed=pairs,
                 pairs_computed=_pairs_computed(boxes, valid, keep, 0.4, "minimum", seg=seg),
                 plain_ms_2x8192=f"{plain_ms:.4f}", valid=int(valid.sum()),
                 levels=int(seg[valid].unique().numel()))

    # the batch's first frame against detect_face on it alone
    face_b, face_lm = saturated.detect_face(frames[0])
    c = outs["saturated"]["counts"][0]
    err = match_detections(face_b, face_lm, outs["saturated"]["boxes"][0, :c].cpu().numpy(),
                           outs["saturated"]["lms"][0, :c].cpu().numpy(), 1e-4, 1e-2)
    _phase("mtcnn_k1", t0, shape=list(boxes.shape), keeps=int(keep.sum()),
           face_vs_batch_err=[f"{e:.3g}" for e in err], face_count=len(face_b))

    # serving: mixed request sizes resized to the 640×480 frame
    t0 = time.perf_counter()
    rng = np.random.RandomState(5)
    sizes = [(MTCNN_H, MTCNN_W), (720, 1280), (300, 400), (MTCNN_H, MTCNN_W)]
    images = [rng.randint(0, 256, (*sizes[i % 4], 3), dtype=np.uint8) for i in range(16)]
    threshold = 0.6
    svc = DetectionService("mtcnn", sparse, frame_size=(MTCNN_W, MTCNN_H),
                           threshold=threshold, max_batch=8, max_wait_ms=20)
    want = []
    for im in images:  # the direct reference: one frame per call
        h, w = im.shape[:2]
        f = im if (h, w) == (MTCNN_H, MTCNN_W) else resize_bilinear(im, MTCNN_W, MTCNN_H)
        b, lm, counts, _ = sparse.detect_batch(f[None])
        want.append(svc._mtcnn_rows(b[0, :counts[0]], lm[0, :counts[0]], w, h))
    runs = _count_tier_runs(sparse)
    _serve("mtcnn_serving", svc, images, want, threshold, t0,
           launches_per_batch=lambda: 4 * len(runs))
    return launches, mask_err


def k3_launches() -> int:
    """K3's launches so far, both variants (a checkout from before the
    device-memory variant has one counter)."""
    from fdt_torch.ops import track as track_op

    counters = (track_op.launches, getattr(track_op, "global_launches", None))
    return sum(c.count for c in counters if c is not None)


def check_k3_chunks(cfg, t_max: int, chunks, device) -> int:
    """K3 against its plain version on the card: the chunks (pad_rows
    arrays) run in order from empty slots through both, each from its own
    state; every record and the state after each chunk must be bit-equal.
    Returns K3's launches (one a chunk, either variant).  Raises
    AssertionError."""
    from fdt_torch.ops import track as track_op
    from fdt_torch.geometry.track import associate_chunk_plain, init_slots

    k3, plain = init_slots(t_max, device), init_slots(t_max, device)
    before = k3_launches()
    for c, chunk in enumerate(chunks):
        tensors = [torch.from_numpy(a).to(device) for a in chunk]
        k3, *got = track_op.associate_chunk(k3, *tensors, cfg)
        plain, *want = associate_chunk_plain(plain, *tensors, cfg)
        for name, g, w in zip(("assign", "finish", "spawn", "overflow"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"K3 != plain: {name} of chunk {c}")
        for name, g in vars(k3).items():
            if not torch.equal(g, getattr(plain, name)):
                raise AssertionError(f"K3 != plain: state {name} after chunk {c}")
    launches = k3_launches() - before
    if launches != len(chunks):
        raise AssertionError(f"K3 launched {launches} times for {len(chunks)} chunks")
    return launches


def bench_track_stream():
    """bench.py's tracking density for K3 alone: 64 frames of about 28
    walkers and clutter on a 600-px field, rows capped at 32, padded to 32,
    in chunks of 16: a list of pad_rows chunks."""
    stream = [r[:TRACK_DET_CAP] for r in track_stream(5, TRACK_FRAMES, walkers=28,
                                                      clutter=4.0, extent=600.0)]
    return [pad_rows(stream[c:c + TRACK_BATCH], TRACK_DET_CAP)
            for c in range(0, TRACK_FRAMES, TRACK_BATCH)]


# float32 operations of one IoU against a slot's last box (2 min, 2 max,
# 2 sub, 2 clamp, 1 mul for the intersection; 4 sub, 2 mul for the areas;
# add, sub, div; the compare)
OPS_PER_AFFINITY = 19


def k3_work(cfg, t_max: int, chunks) -> dict:
    """What a K3 run of the chunks needs on this data: the dependent slot
    steps (frames × live slots visited), the affinities (each step against
    the detections still unconsumed), the bytes (each input read once, each
    output written once) and the most live slots a frame.  The steps and affinities are counted in one
    pass of the host IoUTracker over the same rows: its active list before a
    frame is K3's live slots in visit order, and a track that stays active
    consumed one row."""
    from fdt_torch.track import IoUTracker

    tracker = IoUTracker(cfg)
    steps = affinities = bytes_moved = most_live = 0
    for boxes, scores, valid in chunks:
        f, n = valid.shape
        # slot state in and out, the detections, the records
        bytes_moved += 2 * (t_max * (16 + 4 + 4 + 4 + 1) + 4) + f * n * (16 + 4 + 1) \
            + f * t_max * (4 + 1) + f * n * 4 + f * 4
        for rows in unpad_rows([(boxes, scores, valid)]):
            before = tracker.active
            tracker.step(rows)
            kept = {id(t) for t in tracker.active}
            matched = 0
            for t in before:
                affinities += len(rows) - matched
                matched += id(t) in kept
            steps += len(before)
            most_live = max(most_live, len(before))
    return {"steps": steps, "affinities": affinities, "bytes": bytes_moved,
            "most_live": most_live}


def k3_rows(t_max: int, n: int) -> int:
    """Rows a tile of affinities K3 takes at T = t_max, N = n on the current
    card, by the kernel's own plan (0: its device-memory variant runs)."""
    from fdt_torch.ops._build import library

    rows = library().fdt_track_rows(t_max, n)
    if rows < 0:
        raise RuntimeError(f"fdt_track_rows: CUDA error {-rows}")
    return rows


# K3 timed (profile_nms.py --kernel k3; chip_smoke times the first): F = 16
# frames a chunk, rows capped at N and padded to N, T slots
def k3_timed_case(name: str):
    """(TrackerConfig, t_max, chunks) of a K3_TIMED case."""
    from fdt_torch.config import TRACKER

    if name == "bench-16x32-t256":
        return TRACKER, TRACK_T_MAX, bench_track_stream()
    frames, n, t_max, stream = {
        "n64-t256": (64, 64, 256, lambda: track_stream(64, 64, walkers=56, clutter=8.0,
                                                       extent=900.0)),
        "n750-t1024": (16, 750, 1024, lambda: track_stream(750, 16, walkers=860, clutter=20.0,
                                                           extent=6000.0))}[name]
    rows = [r[:n] for r in stream()]
    return TRACKER, t_max, [pad_rows(rows[c:c + TRACK_BATCH], n)
                            for c in range(0, frames, TRACK_BATCH)]


K3_TIMED = ("bench-16x32-t256", "n64-t256", "n750-t1024")


def k3_timings(device, cfg, t_max: int, chunks, plain: bool = True) -> dict:
    """K3 on the chunks (pad_rows arrays, run in order from empty slots): ms
    a chunk by CUDA events (20 runs of the chunks after 3), its device ms a
    chunk (torch.profiler), the wrapper's host ms, the plain version's ms a
    chunk on the card (with plain, after holding K3 to it bit for bit on
    the same chunks), and the bound from k3_work."""
    from fdt_torch.ops import track as track_op
    from fdt_torch.geometry.track import associate_chunk_plain, init_slots

    tensors = [[torch.from_numpy(a).to(device) for a in c] for c in chunks]
    if plain:
        check_k3_chunks(cfg, t_max, chunks, device)

    def run(associate):
        slots = init_slots(t_max, device)
        for c in tensors:
            slots, *_ = associate(slots, *c, cfg)

    k3 = lambda: run(track_op.associate_chunk)  # noqa: E731
    for _ in range(3):
        k3()
    ms = _cuda_ms(k3, 20) / len(chunks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        k3()
    host_ms = (time.perf_counter() - t0) / 20 / len(chunks) * 1e3
    torch.cuda.synchronize()
    split, _ = _device_split(k3, pattern=K3_KERNELS)
    device_ms = sum(s["us"] for s in split.values()) / 1e3 / len(chunks) if split else None
    plain_ms = _cuda_ms(lambda: run(associate_chunk_plain), 1) / len(chunks) if plain else None
    work = k3_work(cfg, t_max, chunks)
    bound_bytes_ms = work["bytes"] / len(chunks) / PEAK_BYTES_S * 1e3
    bound_ops_ms = work["affinities"] * OPS_PER_AFFINITY / len(chunks) / PEAK_F32_OPS_S * 1e3
    return {"ms": ms, "device_ms": device_ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "kernels": sorted(split), "steps_per_chunk": work["steps"] / len(chunks),
            "affinities_per_chunk": work["affinities"] / len(chunks),
            "bytes_per_chunk": work["bytes"] / len(chunks)}


def _k3_line(tag: str, k3: dict) -> None:
    print(f"[k3] {tag} ms={k3['ms']:.4f} device_ms="
          + ("not_measured" if k3["device_ms"] is None else f"{k3['device_ms']:.4f}")
          + f" host_ms={k3['host_ms']:.4f} plain_ms="
          + ("not_measured" if k3["plain_ms"] is None else f"{k3['plain_ms']:.4f}")
          + f" bound_ms={k3['bound_ms']:.7f} bound_by={k3['bound_by']}"
          f" steps_per_chunk={k3['steps_per_chunk']:.2f}"
          f" affinities_per_chunk={k3['affinities_per_chunk']:.1f}"
          f" bytes_per_chunk={k3['bytes_per_chunk']:.0f}"
          f" kernels={','.join(k3['kernels'])}",
          flush=True)


def k3_growth_rows():
    """(TrackerConfig, chunks of rows) for a tracker that outgrows K3's
    shared-memory variant: 3 frames of about 40 drifting boxes (pad width
    64; T doubles from 8), then 3 frames of 1,100 separated persistent boxes
    (pad width 2048, past the variant's 1,024; T doubles from 64 to 2048)."""
    from fdt_torch.config import TrackerConfig

    small = track_stream(3, 3, walkers=40, clutter=2.0, extent=1500.0)
    rng = np.random.RandomState(11)
    gx, gy = np.meshgrid(np.arange(34) * 60.0, np.arange(33) * 60.0)
    xy = np.stack([gx.ravel(), gy.ravel()], 1)[:1100]
    big = []
    for _ in range(3):
        corner = xy + rng.rand(*xy.shape) * 4
        big.append(np.column_stack([corner, corner + 40, np.full(len(xy), 0.9)])
                   .astype(np.float32))
    return TrackerConfig(t_min=1, sigma_h=0.3), [small, big]


def check_k3_growth(device) -> dict:
    """A DeviceIoUTracker on the card that grows by doubling from t_max 8
    past K3's shared-memory variant, so that both variants run: the counts
    are set to 0 before its chunks and read after.  Every association call
    (the redone ones too) bit-equal to a CPU tracker's (the plain version)
    in records and state, and the tracks equal to the host tracker's.
    Returns the launches of each variant and the final T.  Raises
    AssertionError."""
    from fdt_torch.ops import track as track_op
    from fdt_torch.track import DeviceIoUTracker, track_detections

    cfg, chunks = k3_growth_rows()
    logs = ([], [])
    card, cpu = (DeviceIoUTracker(cfg, t_max=8, device=where) for where in (device, "cpu"))
    for tracker, log in zip((card, cpu), logs):
        def recorded(*args, inner=tracker._associate, log=log):
            out = inner(*args)
            log.append([x.cpu() for x in (*vars(out[0]).values(), *out[1:])])
            return out

        tracker._associate = recorded
    track_op.launches.reset()
    track_op.global_launches.reset()
    for rows in chunks:
        card.step_chunk(rows)
    launches = {"smem": track_op.launches.count, "global": track_op.global_launches.count}
    for rows in chunks:
        cpu.step_chunk(rows)
    got, want = logs
    if len(got) != len(want) or not all(torch.equal(g, w) for a, b in zip(got, want)
                                        for g, w in zip(a, b)):
        raise AssertionError("K3 on a growing tracker != the plain version")
    tracks = card.flush()
    if tracks != cpu.flush() or tracks != track_detections(
            [r for c in chunks for r in c], cfg):
        raise AssertionError("a growing tracker's tracks on the card != host")
    if not launches["smem"] or not launches["global"]:
        raise AssertionError(f"a growing tracker launched K3's variants {launches} times")
    return {**launches, "calls": len(got), "t_max": card.t_max, "pad_n": card.pad_n,
            "tracks": len(tracks)}


def track_detector(setting: str, device):
    """The flagship in bench.py's tracker mode (bf16, channels_last,
    precision "default", budget 5000, top_k 750): "trained" with
    net_weight/repo_mini.npz, "seeded" with seeded_variables."""
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models import build_pyramidbox, from_jax_variables, load_pyramidbox

    if setting == "trained":
        model = load_pyramidbox(str(WEIGHTS))
    else:
        model = build_pyramidbox("repo")
        model.load_state_dict(from_jax_variables(
            seeded_variables(model, TRACK_WEIGHTS_SEED)), strict=True)
    return PyramidBoxDetector(model, "repo", dtype=torch.bfloat16, device=device,
                              precision="default")


def unfused_tracks(det, chunks, cfg, device_rows: bool = False):
    """The unfused tracking path at the fused tracker's chunk shapes:
    detect_tensor (a host read) and detections_to_rows at cfg.score_floor,
    rows capped at 32, then the host IoUTracker (or, with device_rows,
    DeviceIoUTracker on the card, bench.py's tracker_device leg).  Returns
    (tracks, the [N, 5] rows of every frame, live tracks a frame)."""
    from fdt_torch.infer import detections_to_rows
    from fdt_torch.track import DeviceIoUTracker, IoUTracker

    h, w = chunks[0].shape[1:3]
    floor = cfg.score_floor
    tracker = (DeviceIoUTracker(cfg, t_max=TRACK_T_MAX, device=det.device)
               if device_rows else IoUTracker(cfg))
    all_rows, live_n = [], []
    for chunk in chunks:
        out = det.detect_tensor(chunk, floor, TRACK_NMS)
        rows = [detections_to_rows(o, floor, [w, h, w, h])[:TRACK_DET_CAP] for o in out]
        all_rows += rows
        if device_rows:
            tracker.step_chunk(rows)
        else:
            for r in rows:
                tracker.step(r)
                live_n.append(len(tracker.active))
    return tracker.flush(), all_rows, live_n


def fused_tracker(det, cfg, t_max: int = TRACK_T_MAX):
    """A new FusedVideoTracker at bench.py's shapes, detecting at the floor."""
    from fdt_torch.track import FusedVideoTracker

    return FusedVideoTracker(det, cfg, det_cap=TRACK_DET_CAP, threshold=cfg.score_floor,
                             nms_thresh=TRACK_NMS, t_max=t_max, lookahead=1)


def _fused_pass(tracker, chunks) -> list:
    for chunk in chunks:
        tracker.step_frames(chunk)
    return tracker.flush()


def rows_floor(det, chunks, rows: int = TRACK_CHECK_ROWS) -> float:
    """A detection floor that passes about `rows` rows a frame: the median
    over frames of each frame's rows-th best face score at conf 0.01, moved
    halfway down to the next lower score of the run, so no score lies on it."""
    scores = np.concatenate([det.detect_tensor(c, 0.01, TRACK_NMS)[:, 1, :, 0]
                             for c in chunks])
    top = float(np.median(scores[:, rows - 1]))
    lower = scores[scores < top]
    floor = float(np.float32((top + (lower.max() if lower.size else 0.0)) / 2))
    if not 0 < floor < top or (lower.size and floor <= lower.max()):
        raise AssertionError(f"no floor between the scores near {top}")
    return floor


def same_tracks(got: list, want: list) -> bool:
    """Two track lists are equal: start frames, boxes and max scores, a NaN
    equal to a NaN (the seeded flagship's boxes hold some, and NaN != NaN in
    Python's list comparison)."""
    return len(got) == len(want) and all(
        g.keys() == w.keys() and g["start_frame"] == w["start_frame"]
        and np.array_equal(g["bboxes"], w["bboxes"], equal_nan=True)
        and np.array_equal(g["max_score"], w["max_score"], equal_nan=True)
        for g, w in zip(got, want))


def check_fused(det, chunks, cfg) -> dict:
    """New fused trackers (t_max 256, and 2 for the grow-and-redo path) and
    the device-rows leg against the unfused host path: tracks bit-equal
    (IDs, order, start frames, boxes, max scores).  Raises AssertionError."""
    want, rows, live_n = unfused_tracks(det, chunks, cfg)
    big, small = fused_tracker(det, cfg), fused_tracker(det, cfg, t_max=2)
    for tracker in (big, small):
        got = _fused_pass(tracker, chunks)
        if not same_tracks(got, want):
            raise AssertionError(f"fused tracks (t_max {tracker.t_max}: {len(got)}) != "
                                 f"unfused ({len(want)}) at {cfg}")
    device_tracks, _, _ = unfused_tracks(det, chunks, cfg, device_rows=True)
    if not same_tracks(device_tracks, want):
        raise AssertionError(f"DeviceIoUTracker rows != host at {cfg}")
    return {"tracks": len(want), "live": live_n, "redo_t_max": small.t_max,
            "track_frames": sum(len(t["bboxes"]) for t in want),
            "rows": [len(r) if r[:, :4].any() else 0 for r in rows],  # the sentinel is 0
            "nonfinite_rows": sum(int((~np.isfinite(r)).any(axis=1).sum()) for r in rows)}


def check_k1_tracking(det, chunk, cfg) -> dict:
    """K1 on its arguments in one fused tracking chunk at cfg's floor (16
    images × the face class, N = 5000, out_k 750) against its plain version
    on the card: the largest mask difference, the valid boxes and the keeps.
    Raises AssertionError when a mask differs."""
    from fdt_torch.geometry.nms import nms_keep_mask
    from fdt_torch.ops import nms as nms_op

    captured = {}
    kernel = nms_op.nms_keep_tiled

    def keep_inputs(*args, **kwargs):
        captured.update(args=args, kwargs=kwargs)
        return kernel(*args, **kwargs)

    nms_op.nms_keep_tiled = keep_inputs
    try:
        _fused_pass(fused_tracker(det, cfg), [chunk])
    finally:
        nms_op.nms_keep_tiled = kernel
    boxes, valid, thresh = captured["args"]
    out_k = captured["kwargs"]["out_k"]
    if tuple(boxes.shape) != (TRACK_BATCH, 1, 5000, 4) or out_k != 750:
        raise AssertionError(f"K1 on the tracking path at {tuple(boxes.shape)}, out_k {out_k}")
    mode = captured["kwargs"].get("mode", "union")
    keep = kernel(*captured["args"], **captured["kwargs"])
    err = 0.0
    for p in range(0, TRACK_BATCH, 4):  # the plain version's [P, N, N] temporaries
        want = nms_keep_mask(boxes[p:p + 4], valid[p:p + 4], thresh, mode=mode)
        err = max(err, _mask_err(keep[p:p + 4], want, out_k))
    if err != 0:
        raise AssertionError("K1 != plain on the tracking path's boxes")
    return {"err": err, "valid": int(valid.sum()), "keeps": int(keep.sum())}


def phase_tracking(device):
    """IoU tracking at bench.py's tracker configuration: K3 against its plain
    version on TRACK_EDGES and random streams, bit-equal, and a tracker on
    the card growing from t_max 8; K3 timed at bench.py's density; then, on
    both weight settings, the fused tracker's main path (one K1 wrapper call
    and one K3 launch a chunk), its frames/s and those of the device-rows and
    host-rows legs, new fused trackers' tracks bit-equal to the unfused
    path's (also through the grow-and-redo path) at TRACKER and at
    TRACK_CHECK, K1 on the path's own boxes against its plain version, and a
    torch.profiler split of one fused chunk.  Returns (K1 launches, K1's
    largest mask difference, and the JSON line's fields of K3's two
    variants: the shared-memory one's launches from the main path, the
    device-memory one's from a tracker that outgrows the other)."""
    from fdt_torch.config import TRACKER, TrackerConfig
    from fdt_torch.ops import nms as nms_op
    from fdt_torch.ops import track as track_op
    from fdt_torch.track import DeviceIoUTracker, track_detections

    t0 = time.perf_counter()
    checked = 0
    for name in TRACK_EDGES:
        cfg, t_max, chunks = track_edge_case(name)
        before = track_op.global_launches.count
        checked += check_k3_chunks(cfg, t_max, chunks, device)
        if name == "t-over-smem" and track_op.global_launches.count == before:
            raise AssertionError("t-over-smem did not take K3's device-memory variant")
        if name == "tile-rows" and not (0 < k3_rows(t_max, chunks[0][2].shape[1])
                                        < k3_work(cfg, t_max, chunks)["most_live"]):
            raise AssertionError("tile-rows fits one tile of K3's affinities")
    for seed in (0, 7, 11, 13):
        for use_iou in (True, False):
            stream = track_stream(seed)
            chunks = [pad_rows(stream[:17], 16), pad_rows(stream[17:], 16)]
            checked += check_k3_chunks(TrackerConfig(use_iou=use_iou, t_min=3), 64, chunks,
                                       device)
    # a tracker on the card that outgrows t_max = 8, against the host tracker
    cfg, _, chunks = track_edge_case("overflow-t8")
    rows = unpad_rows(chunks)
    grown = DeviceIoUTracker(cfg, t_max=8, device=device)
    grown.step_chunk(rows)
    if grown.flush() != track_detections(rows, cfg) or grown.t_max < 24:
        raise AssertionError(f"DeviceIoUTracker on the card (grown to {grown.t_max}) != host")
    _phase("tracking_k3", t0, edges=len(TRACK_EDGES), chunks_checked=checked,
           grown_t_max=grown.t_max)
    # the path of K3's device-memory variant: a tracker that outgrows the
    # shared-memory one (counts set to 0 before, read after)
    t0 = time.perf_counter()
    growth = check_k3_growth(device)
    _phase("tracking_k3_growth", t0, smem_launches=growth["smem"],
           global_launches=growth["global"], calls=growth["calls"], t_max=growth["t_max"],
           pad_n=growth["pad_n"], tracks=growth["tracks"])

    t0 = time.perf_counter()
    k3 = k3_timings(device, *k3_timed_case("bench-16x32-t256"))
    _k3_line("bench-16x32-t256", k3)
    k3_global = k3_timings(device, *track_edge_case("t-over-smem"))
    _k3_line("t-over-smem-t6144x32", k3_global)
    _phase("tracking_k3_timed", t0, k3_ms=f"{k3['ms']:.4f}", plain_ms=f"{k3['plain_ms']:.4f}",
           k3_global_ms=f"{k3_global['ms']:.4f}")

    seq = pan_frames(bench_frame(TRACK_H, TRACK_W), TRACK_FRAMES)
    chunks = [torch.from_numpy(seq[c:c + TRACK_BATCH]).to(device)
              for c in range(0, TRACK_FRAMES, TRACK_BATCH)]
    k1_launches = k3_launches = 0
    k1_err = 0.0
    for setting in ("trained", "seeded"):
        t0 = time.perf_counter()
        det = track_detector(setting, device)
        tracker = fused_tracker(det, TRACKER)
        _fused_pass(tracker, chunks[:1])       # first use: build and warm
        _warm(lambda: _fused_pass(tracker, chunks))
        nms_op.launches.reset()
        nms_op.greedy_launches.reset()
        track_op.launches.reset()
        track_op.global_launches.reset()
        _fused_pass(tracker, chunks)           # the main path
        k1, k3_n = nms_op.launches.count, track_op.launches.count
        if (k1 != len(chunks) or k3_n != len(chunks) or nms_op.greedy_launches.count
                or track_op.global_launches.count):
            raise AssertionError(f"tracking {setting}: {k1} K1 calls and {k3_n} K3 launches "
                                 f"for {len(chunks)} chunks (want 1 and 1 a chunk)")
        k1_launches += k1
        k3_launches += k3_n
        rates = {}
        for leg, run in (("fused", lambda: _fused_pass(tracker, chunks)),
                         ("device_rows", lambda: unfused_tracks(det, chunks, TRACKER,
                                                                device_rows=True)),
                         ("host_rows", lambda: unfused_tracks(det, chunks, TRACKER))):
            passes = []
            for _ in range(TRACK_PASSES):
                torch.cuda.synchronize()
                t = time.perf_counter()
                run()
                torch.cuda.synchronize()
                passes.append(TRACK_FRAMES / (time.perf_counter() - t))
            rates[leg] = passes
        # new fused trackers' tracks against the unfused path's (same_tracks),
        # at bench.py's TRACKER and at TRACK_CHECK, whose tracks are not empty
        main = check_fused(det, chunks, TRACKER)
        floor = TRACKER.score_floor if setting == "seeded" else rows_floor(det, chunks)
        check = check_fused(det, chunks, dataclasses.replace(TRACKER, score_floor=floor,
                                                             **TRACK_CHECK))
        extended = check["track_frames"] - check["tracks"]
        if not check["tracks"] or (setting == "trained" and not extended):
            raise AssertionError(f"tracking {setting}: the check at {TRACK_CHECK} and floor "
                                 f"{floor} finished {check['tracks']} tracks, {extended} "
                                 "extensions")
        # K1 on the path's own boxes: seeded at the main floor (5000 valid,
        # boxes not finite), trained at the check's (boxes that suppress)
        k1_check = check_k1_tracking(det, chunks[0], TRACKER if setting == "seeded"
                                     else dataclasses.replace(TRACKER, score_floor=floor))
        k1_err = max(k1_err, k1_check["err"])
        _phase(f"tracking_{setting}", t0, frames=TRACK_FRAMES, batch=TRACK_BATCH,
               size=f"{TRACK_W}x{TRACK_H}", frames_per_s=f"{max(rates['fused']):.2f}",
               rates=[round(r, 2) for r in rates["fused"]],
               spread_pct=f"{_spread(rates['fused']):.2f}",
               device_rows_frames_per_s=f"{max(rates['device_rows']):.2f}",
               device_rows_rates=[round(r, 2) for r in rates["device_rows"]],
               host_rows_frames_per_s=f"{max(rates['host_rows']):.2f}",
               host_rows_rates=[round(r, 2) for r in rates["host_rows"]],
               mean_rows=f"{np.mean(main['rows']):.2f}",
               mean_live=f"{np.mean(main['live']):.2f}",
               nonfinite_rows=main["nonfinite_rows"],
               tracks_finished=main["tracks"], k1_calls_per_chunk=k1 // len(chunks),
               k3_launches_per_chunk=k3_n // len(chunks), redo_t_max=main["redo_t_max"],
               check_floor=floor, check_mean_rows=f"{np.mean(check['rows']):.2f}",
               check_mean_live=f"{np.mean(check['live']):.2f}",
               check_tracks=check["tracks"], check_extensions=extended,
               check_redo_t_max=check["redo_t_max"], k1_check_valid=k1_check["valid"],
               k1_check_keeps=k1_check["keeps"], k1_check_mask_err=k1_check["err"])
        nms_op.launches.reset()
        track_op.launches.reset()
        split = _time_split(lambda: tracker.step_frames(chunks[0]))
        tracker.flush()
        print(f"[tracking] {setting} chunk={TRACK_BATCH}x{TRACK_H}x{TRACK_W} "
              f"wall_ms={split['wall_ms']:.3f} device_ms={split['device_ms']:.3f} idle_pct="
              + ("not_measured" if split["idle_pct"] is None else f"{split['idle_pct']:.1f}")
              + f" k1_calls={nms_op.launches.count} k3_launches={track_op.launches.count} "
              + " ".join(f"{k}_ms={v:.3f}" for k, v in sorted(
                  split["parts"].items(), key=lambda kv: -kv[1])), flush=True)
        for name, ms in split["top"]:
            print(f"[tracking]   {setting} {ms:8.3f} ms {name[:110]}", flush=True)
    k3["launches"], k3_global["launches"] = k3_launches, growth["global"]
    return k1_launches, k1_err, k3, k3_global


def _rows_agree(got: np.ndarray, want: np.ndarray, threshold: float,
                score_tol: float, px_tol: float) -> bool:
    """Two [N, 5] (or, with landmarks, [N, 15]) pixel-row lists of one frame
    agree: every row of each has a row of the other within the tolerances,
    except rows whose score lies within score_tol of the threshold (drift
    may put them on either side)."""
    for a, b in ((got, want), (want, got)):
        for r in a:
            if r[4] < threshold + score_tol:
                continue
            if not len(b) or not (
                    (np.abs(np.delete(b, 4, 1) - np.delete(r, 4)).max(axis=1) <= px_tol)
                    & (np.abs(b[:, 4] - r[4]) <= score_tol)).any():
                return False
    return True


def _serve(name, svc, images, want, threshold, t0, launches_per_batch=None) -> None:
    """Drive `svc` with `images` from 4 client threads; every answer must
    agree with its direct call `want[i]`, and K1 must launch once a batch
    (or launches_per_batch() times in all, read after the run)."""
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
    expected = stats["batches"] if launches_per_batch is None else launches_per_batch()
    if launches != expected:
        raise AssertionError(f"{name}: {stats['batches']} batches, {launches} K1 launches "
                             f"(want {expected})")
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
    mtcnn_launches, mtcnn_err = phase_mtcnn(device)
    track_k1_launches, track_k1_err, k3, k3_global = phase_tracking(device)
    phase_serving(det32, facebox_det)

    # PyTorch has no NMS call (and torchvision is not installed) and no
    # greedy-association call: no library_ms
    print(json.dumps({"kernels": [{
        "name": "nms_tiled (K1)", "route": "cuda",
        "source": "fdt_torch/csrc/nms_tiled.cu",
        "replaces": "fdt/ops/pallas_nms.py:69",
        "launches": launches + mtcnn_launches + track_k1_launches,
        "max_abs_err": max(k1["max_abs_err"], boxes_err, mtcnn_err, track_k1_err),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
        "device_ms": k1["device_ms"], "host_ms": k1["host_ms"]}, {
        "name": "nms_greedy (K2)", "route": "cuda",
        "source": "fdt_torch/csrc/nms_greedy.cu",
        "replaces": "fdt/ops/pallas_nms.py:31",
        "launches": k2_launches, "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None,
        "device_ms": k2["device_ms"], "host_ms": k2["host_ms"]}, {
        "name": "track_assoc_smem (K3, shared memory)", "route": "cuda",
        "source": "fdt_torch/csrc/track_assoc.cu",
        "replaces": "fdt/track/device_tracker.py:93",
        "launches": k3["launches"], "max_abs_err": 0.0,  # bit-equal, or the phase raised
        "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": None,
        "device_ms": k3["device_ms"], "host_ms": k3["host_ms"]}, {
        "name": "track_assoc_global (K3, device memory)", "route": "cuda",
        "source": "fdt_torch/csrc/track_assoc.cu",
        "replaces": "fdt/track/device_tracker.py:93",
        "launches": k3_global["launches"], "max_abs_err": 0.0,
        "ms": k3_global["ms"], "plain_ms": k3_global["plain_ms"],
        "bound_ms": k3_global["bound_ms"], "bound_by": k3_global["bound_by"],
        "library_ms": None, "device_ms": k3_global["device_ms"],
        "host_ms": k3_global["host_ms"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
