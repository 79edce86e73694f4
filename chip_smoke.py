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
  7. int8   — int8 inference (quant="int8"): K5 (the activation quantizer,
               one launch) and K4 (the int8 convolution, its wgmma and
               mma_sync variants) bit-equal to their plain versions on
               INT8_EDGES, INT8_TILE_EDGES and on every int8 conv of the
               flagship (at the main path's batch 8, 640² too), try1 and
               FaceBoxes on the convs' own inputs; the float32 int8
               flagship on the golden frame against fdt's int8 golden
               (INT8_GOLDEN), with a control that a float path fails; the
               bf16 int8 flagship at batch 8, 640² (111 K4 launches, each of
               the variant picked, 110 wgmma; 111 K5, one K1) against the
               bf16 float flagship on the same frames, images/s of both;
               try1 and FaceBoxes once with int8; a profiler split of one
               int8 call (K4 by variant); K4 and K5 timed at the three
               heaviest convs and the stem beside the plain versions, the
               bounds (and their sums over a batch), torch._int_mm on the
               same GEMM and cuDNN's bf16 conv.
  8. mtcnn  — the MTCNN cascade at bench.py's configuration (480×640, batch
               32, the ladder FAST → MID → full) on seeded weights: the
               "sparse" golden batch against fdt's (counts, flags and tier
               equal, scores within 1e-3, boxes and landmarks within 1e-2
               px); on both settings the batch-32 call, 4 K1 launches a tier
               run, images/s and the tier; K1 on the saturated cascade's own
               per-level candidates (32 × 8192, segmented) bit-equal to its
               plain version and timed; the batch's first frame against
               detect_face; DetectionService("mtcnn") under 4 threads.
  9. tracking — bench.py's tracker configuration (64 frames of 480×640 panned
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
 10. serving — DetectionService answers 16 requests from 4 threads (float32)
               for the pyramidbox family (640²) and the facebox family (mixed
               sizes); each answer agrees with the direct call on its frame,
               up to the summation order of another batch size.
 11. http    — the bf16 flagship at 640² behind make_http_server: a fresh
               service's warmup() (timed), then 16 PNG bodies (encode_png)
               from 4 threads, twice, each answer against a direct
               detect_tensor call, K1 once a batch; /healthz before and
               after, 413, 400, 404, ?threshold=; one JPEG body; p50/p99
               latency, requests/s, mean batch, a body's decode ms alone and
               in the server under load (median and most), the service's ms
               a request; 640×480 PNGs (Paeth rows, and the row filters
               Pillow's encoder picks) and a JPEG decoded by the port's
               decoder and by Pillow, timed.
 12. eval    — scripts/my_test.py's protocol on 24 seeded noise PNGs of 8
               sizes (320–1024 a side) with an anno file: eval_pyramidbox
               (float32 flagship, one K1 launch an image) bit-equal to direct
               detect_face calls, 2 merged shards bit-equal, the per-shape
               LRU past a lowered bound; eval_pyramidbox_batched at batch 8
               (one K1 launch a chunk; images at their bucket size against
               the native rows); eval_facebox and eval_mtcnn(bucketed=True)
               bit-equal to direct calls; images/s of each.
 13. mtcnn_host — MTCNN's host cascade (nets on the card, crops and NMS on
               the host) on the "host" nets and the sparse golden's two
               480×640 frames: against fdt's host cascade (the golden
               mtcnn_host_sparse.npz) and the port's device cascade within
               fdt's own host-to-device bound; images/s of both cascades and
               each stage's wall ms split into kernel time and host time.
 14. video   — VIDEO_FRAMES frames of the tracking pan written as PNGs and
               read back through read_frames; track_video (host and device
               trackers) and track_video_fused at batch 8 and 16 on the
               trained flagship in the tracker configuration: tracks equal to
               the unfused path's, K1 and K3 counted on each leg, K1 on one
               batch's boxes against its plain version, frames/s.
 15. video_render — render_tracks of those tracks into PNGs: frames/s, and
               boxes read back in their track's colour.
 16. video_demo — run_video with each family (flagship, FaceBoxes, MTCNN's
               host and device cascades) over DEMO_FRAMES frames: answers
               equal to direct calls, the average fps, K1 launches.
 17. train  — PyramidBox training (fdt_torch.train): the flagship's 3 steps
               (640², batch 2, float32 "highest", lr 1e-6) against fdt's
               golden (train_flagship.npz: loss parts, each leaf's change
               norm, batch_stats samples); the flagship's step at 640², batch
               7 (the reference trainer's), float32 with TF32, bf16 and remat:
               ms (CUDA events), images/s, peak memory; remat's step against
               the plain one, bf16's first loss against float32's; a
               torch.profiler split of the float32 step ([train] split);
               one xavier-initialised step of each of try1-try5 at 640²;
               python -m fdt_torch.cli.train_pyramid over 8 seeded image
               files for 5 iterations, resumed from its checkpoint for 5
               more, then a detect with the trained weights (one K1 call).
 18. train_families — FaceBoxes, net2net and MTCNN training: each family's
               3 steps (float32 "highest") against fdt's goldens
               (train_facebox.npz at 1024², batch 2; train_net2net.npz, each
               mode, repo teacher, try1 student at 640², batch 2;
               train_mtcnn.npz, each stage, batch 64: gradients before the
               update, losses, change norms, update signs); the full-width
               steps timed (FaceBoxes 1024² batch 16, net2net intermedia
               640² batch 8, each MTCNN stage batch 512: median ms, images/s,
               peak memory, device ms and idle share) beside the card's name
               and power limit; python -m fdt_torch.cli.train_facebox for 4
               iterations, resumed to 6, then a FaceBoxes detect of its
               weights (one K1 call); train_net2net for 3 iterations; the
               MTCNN chain gen_mtcnn_data pnet → train_mtcnn pnet →
               gen_mtcnn_data rnet → train_mtcnn rnet (one epoch each) on
               seeded scenes, then the device cascade on the trained nets
               (K1 counted).
 19. interop — reference .pth/.pt weights, each against its npz, every
               output bit-equal: the flagship (640², batch 8, float32) from a
               .pth in fdt's flax_to_torch layout, FaceBoxes (seeded, strict)
               and the device cascade from three .pt files of seeded nets;
               a .pth written from the card model reloads bit-equal.
 20. tooling — train_chained replays try3's journal, scaled to two phases
               of one chunk process each (2 iterations at 640², batch 2,
               from net_weight/try3_mini.npz; each chunk's wall, loop and
               start-up seconds); select_checkpoint over its checkpoints on
               6 seeded drawn-face images (one K1 launch a checkpoint-image;
               APs within 1e-3 of the same CLI on the CPU); export_weights
               --check of the last checkpoint to .pth and .npz.
 21. inception — Inception-ResNet-v2 at full depth, 299², batch 8, float32
               "highest", seeded weights with calibrated BatchNorm statistics:
               within 1e-3 of the scale of the CPU's logits of 2 images, ms
               a batch (CUDA events) and images/s beside the card's name and
               power limit.
 22. dist    — data parallelism (fdt_torch.dist) on the one card: two gloo
               ranks of the flagship's DP train step on cuda:0 (640², a
               global batch of 4, float32 "highest"), bit-equal to each other
               and held to the one-device step on the same rows; DP
               inference on a 2-slot mesh of cuda:0 (the flagship at 640², 9
               images): float32 against the unsharded detector at fdt's DP
               tolerance, int8 bit-equal to the unsharded int8 detector on
               each shard's rows (K1, K4 and K5 counted on the main path);
               the DP step through NCCL at world size 1 (batch 2) against
               the one-device step, both timed.  phase_dist_cards(n) runs
               the same over n cards of one host (called by a script of its
               own on a several-card machine, not part of the one-card main
               path).
Then a [device] line (torch's and nvidia-smi's card counts, NCCL's presence
and version), a JSON line of the kernels and, last, {"ok": true, "device":
{...}}.
Any failure exits non-zero; a hang exits non-zero with a traceback.
"""
from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import hashlib
import io
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
# takes seven to eight and a half minutes on an H100, the nvcc build and its
# one-nvcc reference included)
HANG_LIMIT_S = 720
WARMUP_S = 2.0  # before each throughput measurement
SIZE, BATCH = 640, 8  # the flagship: bench.py:167-200

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# non-tensor-core operations/s and dense int8 tensor-core operations/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_INT8_OPS_S = 1979e12
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
# The host cascade (the reference's, fdt/infer/mtcnn.py) crops each squared
# candidate into an array of its own size, so an empty or inverted square
# raises (ValueError, or an empty resize).  The seeded nets regress offsets
# of order 1, which invert about one PNet candidate in ten: the host cascade
# cannot run on them at all.  Setting "host" is the sparse one with the
# regression layers that place the next stage's crops (PNet's conv4_2,
# RNet's conv5_2) scaled by MTCNN_HOST_REG_SCALE, so that offsets stay in the
# range a trained MTCNN regresses.
MTCNN_HOST_REG = {"pnet": "conv4_2", "rnet": "conv5_2"}
MTCNN_HOST_REG_SCALE = 0.1
MTCNN_GOLDEN = GOLDEN_DIR / "mtcnn_sparse.npz"
# fdt's host cascade on the "host" nets and the sparse golden's frames, and
# the bound between a cascade that resizes as cv2 does and one that does not:
# fdt's own between its host and device cascades (tests/test_mtcnn_device.py:
# 89-93), with one detection more or less, the difference of fdt's own pair
# on the first frame (19 against 18 on the CPU)
MTCNN_HOST_GOLDEN = GOLDEN_DIR / "mtcnn_host_sparse.npz"
MTCNN_HOST_SCORE_TOL, MTCNN_HOST_PX_TOL, MTCNN_HOST_COUNT_DIFF = 2e-2, 2.0, 1
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

# int8 inference (fdt/ops/quant.py; kernels K5 and K4): the golden is fdt's
# int8 detector (precision "highest", on the CPU) on the flagship golden's
# frame, weights and thresholds.  Two row lists are compared over their top
# INT8_ROWS rows by fdt's int8-against-float protocol (tests/test_quant.py:
# 160-175): the median IoU of matched rows and their largest score
# difference at fdt's bounds, and the share of rows matched at IoU > 0.5 at
# least int8_min_matched: fdt's 90%, or, where fdt's own int8 detector
# matches fewer of its float rows on the same input, that share less
# INT8_MATCH_SLACK.  The per-tensor int8 rounding moves a level wherever the
# float arithmetic before it differs in the last bit (BatchNorm, the
# upsample; ROADMAP Queue 3), so the port's int8 drifts from fdt's as fdt's
# own int8 does under a perturbation that small; on the 640² noise frame
# fdt's int8 matches 65% of its float rows (kept in the golden)
INT8_GOLDEN = GOLDEN_DIR / "flagship_int8.npz"
INT8_ROWS = 100
INT8_MATCHED, INT8_MEDIAN_IOU, INT8_SCORE_DIFF = 0.9, 0.95, 0.08
INT8_MATCH_SLACK = 0.1
# K4 and K5 against their plain versions on the card: name → (batch, cin, h,
# w, cout, kernel, stride, padding, dilation, groups, dtype, channels_last,
# bias, fill); fill None is seeded noise ×3, "zero" a zero tensor (scale 1),
# "nan-inf" a NaN and an inf among the noise (amax NaN: scale 1), "inf" one
# inf (scale inf: the outputs are NaN and ±inf), "offset" the noise as a
# channels-last view one element into its storage (not 16-byte aligned)
INT8_EDGES = {
    "stem-k147-f32-nchw": (2, 3, 40, 40, 64, 7, 2, 3, 1, 1, "float32", False, False, None),
    "stem-k147-bf16-cl": (2, 3, 40, 40, 64, 7, 2, 3, 1, 1, "bfloat16", True, False, None),
    "facebox-stem-s4-bf16-cl": (1, 3, 64, 64, 24, 7, 4, 3, 1, 1, "bfloat16", True, True, None),
    "head-n4-bf16-cl": (2, 256, 10, 10, 4, 3, 1, 1, 1, 1, "bfloat16", True, True, None),
    "head-n2-f32-nchw": (2, 256, 10, 10, 2, 3, 1, 1, 1, 1, "float32", False, True, None),
    "grouped-1x1-bf16-cl": (2, 256, 10, 10, 256, 1, 1, 0, 1, 4, "bfloat16", True, True, None),
    "grouped-1x1-f32-nchw": (2, 256, 10, 10, 256, 1, 1, 0, 1, 4, "float32", False, False, None),
    "dilated-f32-nchw": (2, 256, 10, 10, 128, 3, 1, 2, 2, 1, "float32", False, True, None),
    "strided-odd-bf16-cl": (2, 128, 21, 19, 128, 3, 2, 1, 1, 1, "bfloat16", True, True, None),
    "cin12-f32-cl": (2, 12, 17, 17, 40, 3, 1, 1, 1, 1, "float32", True, True, None),
    "k5-s2-f32-nchw": (1, 48, 33, 33, 64, 5, 2, 2, 1, 1, "float32", False, True, None),
    "n100-k4608-bf16-cl": (1, 512, 6, 7, 100, 3, 1, 1, 1, 1, "bfloat16", True, True, None),
    "zero-bf16-cl": (2, 64, 8, 8, 64, 3, 1, 1, 1, 1, "bfloat16", True, True, "zero"),
    "zero-f32-nchw": (2, 64, 8, 8, 64, 3, 1, 1, 1, 1, "float32", False, True, "zero"),
    "nan-inf-f32-nchw": (1, 64, 8, 8, 32, 3, 1, 1, 1, 1, "float32", False, True, "nan-inf"),
    "inf-bf16-cl": (1, 64, 8, 8, 32, 3, 1, 1, 1, 1, "bfloat16", True, True, "inf"),
    "offset-view-bf16-cl": (2, 64, 9, 7, 64, 3, 1, 1, 1, 1, "bfloat16", True, True, "offset"),
    "offset-view-f32-cl": (2, 32, 9, 7, 48, 3, 1, 1, 1, 1, "float32", True, False, "offset"),
    # 4.7M elements: more than K5's grids cover in one pass (kMaxPartials
    # blocks of pass 1, kMaxQuantBlocks of pass 2), so both grid-stride loops
    # take several turns
    "past-caps-bf16-cl": (8, 64, 96, 96, 32, 3, 1, 1, 1, 1, "bfloat16", True, True, None),
    "past-caps-f32-nchw": (8, 64, 96, 96, 32, 3, 1, 1, 1, 1, "float32", False, True, None),
}
# Edges of K4's wgmma variant and K5's grid (the same fields): N tiles of 8,
# 64, 128 and 256 with ragged N (24, 72, 320: two tiles) and M (143 rows),
# K past its last 64-byte stage (144), stride 2 with a 5×5 window, dilation
# 3, float32 outputs through strides, more tiles than the card has SMs (the
# persistent walk: 300 and 600), and more 16-byte chunks than one turn of
# K5's resident grid (10.24M elements)
INT8_TILE_EDGES = {
    "n8-bf16-cl": (2, 64, 9, 11, 8, 3, 1, 1, 1, 1, "bfloat16", True, True, None),
    "n24-k144-bf16-cl": (2, 16, 12, 10, 24, 3, 1, 1, 1, 1, "bfloat16", True, True, None),
    "n72-k5-s2-bf16-cl": (3, 48, 15, 13, 72, 5, 2, 2, 1, 1, "bfloat16", True, False, None),
    "n320-1x1-bf16-cl": (2, 512, 7, 9, 320, 1, 1, 0, 1, 1, "bfloat16", True, True, None),
    "n256-m143-f32-nchw": (1, 64, 13, 11, 256, 3, 1, 1, 1, 1, "float32", False, True, None),
    "n512-dil3-bf16-cl": (1, 128, 20, 20, 512, 3, 1, 3, 3, 1, "bfloat16", True, True, None),
    "n4-f32-cl": (2, 256, 6, 6, 4, 3, 1, 1, 1, 1, "float32", True, True, None),
    "persistent-bf16-cl": (4, 32, 96, 100, 64, 1, 1, 0, 1, 1, "bfloat16", True, True, None),
    "persistent-n512-bf16-cl": (4, 32, 96, 100, 512, 1, 1, 0, 1, 1, "bfloat16", True, False,
                                None),
    "k5-turns-bf16-cl": (8, 128, 100, 100, 8, 1, 1, 0, 1, 1, "bfloat16", True, True, None),
    "k5-turns-f32-nchw": (8, 128, 100, 100, 8, 1, 1, 0, 1, 1, "float32", False, True, None),
}

# Training (phase train): the flagship's train step against fdt's, the golden
# fdt's own PyramidTrainer wrote on the CPU (float32, precision "highest")
# from net_weight/repo_mini.npz with zero momentum: TRAIN_STEPS steps at
# TRAIN_LR on train_batch(TRAIN_SEED, TRAIN_GOLDEN_BATCH); then the timed
# steps at the reference trainer's batch of 7 (fdt/train/driver.py:25)
TRAIN_GOLDEN = GOLDEN_DIR / "train_flagship.npz"
TRAIN_SEED, TRAIN_GOLDEN_BATCH, TRAIN_STEPS, TRAIN_LR = 0, 2, 3, 1e-6
TRAIN_BATCH = 7
TRAIN_SAMPLES = 4  # elements a leaf kept in the golden, at seeded indices
# The golden check's tolerances, float32 on the card (cuDNN, TF32 off)
# against fdt's XLA:CPU steps.  TRAIN_LR = 1e-6 keeps the three steps near
# linear (the loss still falls 13%): at 1e-4 and 1e-5 float32 noise grew to
# 7% and 0.9% of the loss by step 3 between fdt and the port on the CPU, as
# it grows between fdt's own float32 and float64 steps (tests/
# test_torch_train_step.py).  Measured on the CPU (tests/
# test_torch_train_golden.py): losses 5.1e-6 / 2.1e-5 / 1.2e-4 relative by
# step; leaf change norms 5.4e-4 of the largest leaf's at most (a leaf's own
# norm is off by up to 52% only where it is under 1e-4 of the largest:
# biases before a BatchNorm, whose gradients cancel); batch_stats samples
# 3.6e-3 relative.
TRAIN_LOSS_RTOL = (1e-4, 5e-4, 2e-3)
TRAIN_NORM_RTOL, TRAIN_NORM_ATOL = 5e-2, 5e-3
TRAIN_STATS_RTOL = 2e-2
# the bf16 step's first loss against the float32 step's (fdt's bound,
# tests/test_train_driver.py:306-308); remat against plain
# (tests/test_train_driver.py:313-360)
TRAIN_BF16_RTOL = 0.05
# train step kernels → part, first match wins (cuDNN's BatchNorm kernels are
# named cudnn::bn_*, so BatchNorm goes before the convolutions)
TRAIN_PARTS = (("batchnorm", r"batch_norm|bn_fw|bn_bw|bn_|[Bb]atch[Nn]orm"),
               ("sort", r"[Ss]ort|[Rr]adix"),
               ("conv", r"conv|cudnn|xmma|gemm|cutlass|implicit|winograd|fft|dgrad|wgrad"),
               ("optimizer", r"multi_tensor|foreach"))


# Training of the other families (phase train_families): each family's
# FAMILY_STEPS steps against a golden that fdt's own trainer wrote on the
# CPU (float32, precision "highest"; tests/test_torch_<family>_golden.py):
# FaceBoxes at 1024² from seeded_variables(FaceBox(), FACEBOX_WEIGHTS_SEED);
# net2net per mode, teacher net_weight/repo_mini.npz, student
# NET2NET_STUDENT; each MTCNN stage from seeded_variables(net,
# MTCNN_TRAIN_WEIGHTS_SEED) on MTCNN_TRAIN_GOLDEN_BATCH patches that carry
# every label kind.  The lrs keep fdt's float32 steps within 2e-5 of the
# float64 ones (measured with the port on the CPU: FaceBoxes at 1e-4 1.8e-5
# relative by step 3, 2.5e-3 at 1e-3; net2net intermedia at 1e-4 3.1e-6,
# source at 1e-5 3.3e-7 but 1.2e-3 at 1e-4); MTCNN's Adam steps move each
# element by ~lr whatever its gradient, so its steps are held by gradients before the first update,
# losses, change norms and the share of elements whose change has another
# sign.  Then the timed steps at each CLI's default batch.
FAMILY_STEPS = 3
FACEBOX_TRAIN_GOLDEN = GOLDEN_DIR / "train_facebox.npz"
FACEBOX_TRAIN_SEED, FACEBOX_TRAIN_GOLDEN_BATCH, FACEBOX_TRAIN_LR = 0, 2, 1e-4
FACEBOX_TRAIN_BATCH = 16  # scripts/train_facebox.py's default
NET2NET_TRAIN_GOLDEN = GOLDEN_DIR / "train_net2net.npz"
NET2NET_STUDENT = REPO / "net_weight" / "try1_distilled_mini.npz"
NET2NET_MODES = ("intermedia", "source", "overall")
NET2NET_TRAIN_SEED, NET2NET_TRAIN_GOLDEN_BATCH = 0, 2
# by mode: intermedia's loss moves 1.3e-4 in 3 steps at 1e-5, too little for
# its check; at 1e-4 source mode's float32 steps part from float64's
NET2NET_TRAIN_LR = {"intermedia": 1e-4, "source": 1e-5, "overall": 1e-5}
NET2NET_TRAIN_BATCH = 8  # scripts/train_net2net.py's default
MTCNN_TRAIN_GOLDEN = GOLDEN_DIR / "train_mtcnn.npz"
MTCNN_STAGES = ("pnet", "rnet", "onet")
MTCNN_TRAIN_SEED, MTCNN_TRAIN_WEIGHTS_SEED, MTCNN_TRAIN_GOLDEN_BATCH = 0, 2, 64
MTCNN_TRAIN_LR = 1e-3
MTCNN_TRAIN_BATCH = 512  # scripts/train_mtcnn.py's default
# The golden checks' tolerances on the card (cuDNN with TF32 off against
# fdt's XLA:CPU steps): loss parts relative, by step; each parameter leaf's
# change norm within NORM_RTOL of its own plus NORM_ATOL of the largest
# leaf's (the latter for net2net's BatchNorm biases that reach the loss only
# through 1×1 convs into train-mode BatchNorms, which take away any shift of
# a channel: their true gradient is 0 and their change float noise, 1e-9 to
# 1e-8 of the largest leaf's, 30-50% off their own on the CPU); batch_stats
# samples relative;
# MTCNN's gradient norms before the first update within "grad" of their own,
# and the share of elements whose change has another sign.  The CPU's
# errors beside them are in tests/test_torch_*_golden.py, the card's in
# PERF.md (Findings).
FAMILY_TOL = {
    "facebox": {"loss": (5e-5, 2e-4, 1e-3), "norm_rtol": 5e-2, "norm_atol": 5e-3,
                "stats": 2e-2},
    "net2net": {"loss": (1e-4, 5e-4, 2e-3), "norm_rtol": 5e-2, "norm_atol": 5e-3,
                "stats": 5e-2},
    "mtcnn": {"loss": (1e-5, 2e-4, 1e-3), "norm_rtol": 1e-3, "norm_atol": 1e-4,
              "grad": 1e-3, "sign_share": 1e-3},
}
FAMILY_METRICS = {"facebox": ("loss", "loc", "conf"),
                  "mtcnn": ("loss", "cls", "box", "landmark", "accuracy")}


def train_batch(seed: int, batch: int, size: int = SIZE):
    """A seeded training batch as the driver hands it to the trainer:
    mean-subtracted noise images [B, S, S, 3] rounded to float16 (the
    driver's transfer format) and 1-4 seeded faces an image, padded
    (fdt_torch.train.pad_targets)."""
    from fdt_torch.config import PIXEL_MEAN_BGR
    from fdt_torch.train.loops import pad_targets
    rng = np.random.RandomState(seed)
    images = (rng.randint(0, 256, (batch, size, size, 3)).astype(np.float32)
              - np.array(PIXEL_MEAN_BGR, np.float32)).astype(np.float16)
    targets = []
    for _ in range(batch):
        n = rng.randint(1, 5)
        wh = 0.03 + rng.rand(n, 2) * 0.25
        xy = rng.rand(n, 2) * (1 - wh)
        targets.append(np.hstack([xy, xy + wh, np.zeros((n, 1))]).astype(np.float32))
    return (images,) + pad_targets(targets)


def train_leaf_summary(before: dict, after: dict) -> dict:
    """Per leaf (flax path), the change of a train run: its sum, its L2 norm
    and TRAIN_SAMPLES elements after the run at indices seeded by the leaf's
    position in sorted order."""
    names = sorted(after)
    out = {"names": np.array(names), "change_sum": [], "change_norm": [],
           "sample_index": [], "sample_value": []}
    for i, name in enumerate(names):
        a, b = np.asarray(after[name], np.float64).ravel(), np.asarray(before[name],
                                                                      np.float64).ravel()
        idx = np.random.RandomState(i).randint(0, a.size, TRAIN_SAMPLES)
        out["change_sum"].append((a - b).sum())
        out["change_norm"].append(np.sqrt(((a - b) ** 2).sum()))
        out["sample_index"].append(idx)
        out["sample_value"].append(a[idx])
    return {k: np.asarray(v) for k, v in out.items()}


def facebox_train_batch(seed: int, batch: int, size: int = 1024):
    """A seeded FaceBoxes batch: raw 0-255 BGR noise [B, S, S, 3] float32
    (the trainer divides by 255) and 1-4 faces an image, padded, labels 1."""
    from fdt_torch.train.loops import pad_targets
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (batch, size, size, 3)).astype(np.float32)
    targets = []
    for _ in range(batch):
        n = rng.randint(1, 5)
        wh = 0.03 + rng.rand(n, 2) * 0.25
        xy = rng.rand(n, 2) * (1 - wh)
        targets.append(np.hstack([xy, xy + wh, np.ones((n, 1))]).astype(np.float32))
    gt_boxes, _, gt_valid = pad_targets(targets)
    return images, gt_boxes, gt_valid.astype(np.int32), gt_valid


def net2net_batch(seed: int, batch: int, size: int = SIZE):
    """A seeded net2net batch: the prefetcher's mean-subtracted float16
    images [B, S, S, 3] (train_batch's)."""
    return (train_batch(seed, batch, size)[0],)


def mtcnn_train_batch(stage: str, seed: int, batch: int):
    """A seeded batch of a stage's patches: uint8 BGR [B, S, S, 3], labels
    1, 0, -1, -2 in turns (every mask non-empty), box offsets, landmarks."""
    size = {"pnet": 12, "rnet": 24, "onet": 48}[stage]
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (batch, size, size, 3)).astype(np.uint8)
    labels = np.resize(np.array([1, 0, -1, -2], np.float32), batch)
    bbox = (rng.randn(batch, 4) * 0.1).astype(np.float32)
    landmarks = rng.rand(batch, 10).astype(np.float32)
    return images, labels, bbox, landmarks


def family_batch(family: str, key: str, seed: int, batch: int):
    """The batch of a family's golden (key: the net2net mode or MTCNN stage)."""
    if family == "facebox":
        return facebox_train_batch(seed, batch)
    if family == "net2net":
        return net2net_batch(seed, batch)
    return mtcnn_train_batch(key, seed, batch)


def family_step(family: str, trainer, batch, lr: float) -> list[float]:
    """One train step of a family's trainer → its metrics as floats (net2net:
    the loss, then its parts)."""
    if family == "facebox":
        m = trainer.train_step(*batch, lr)
        return [float(m[k]) for k in FAMILY_METRICS[family]]
    if family == "net2net":
        m = trainer.train_step(*batch, lr)
        return [float(m["loss"])] + m["parts"].cpu().double().tolist()
    m = trainer.train_step(*batch)  # Adam at the trainer's base_lr
    return [float(m[k]) for k in FAMILY_METRICS[family]]


def batch_sha256(batch) -> str:
    h = hashlib.sha256()
    for a in batch:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def change_signs(before: dict, after: dict) -> np.ndarray:
    """The sign of every parameter's change over a run, leaves in sorted
    order, as one int8 array of -1, 0 and 1."""
    return np.concatenate([np.sign(np.asarray(after[k], np.float64)
                                   - np.asarray(before[k], np.float64)).ravel()
                           for k in sorted(after) if k.startswith("params/")]).astype(np.int8)


def pack_signs(signs: np.ndarray) -> dict:
    return {"sign_pos": np.packbits(signs > 0), "sign_neg": np.packbits(signs < 0),
            "sign_count": np.int64(signs.size)}


def unpack_signs(g: dict, prefix: str = "") -> np.ndarray:
    n = int(g[prefix + "sign_count"])
    pos = np.unpackbits(g[prefix + "sign_pos"])[:n].astype(np.int8)
    return pos - np.unpackbits(g[prefix + "sign_neg"])[:n].astype(np.int8)


def mtcnn_grad_norms(trainer, batch) -> dict:
    """Per parameter leaf (flax path), the L2 norm of the stage loss's
    gradient before any update; the trainer's gradients are cleared after."""
    from fdt_torch.infer.pyramidbox import tf32_for
    from fdt_torch.models.loader import flax_arrays
    trainer.model.train()
    with tf32_for(trainer.precision):  # the trainer's precision, as train_step takes it
        loss, _ = trainer._loss(*batch)
        loss.backward()
    grads = flax_arrays(trainer.model, {n: p.grad for n, p in trainer.model.named_parameters()})
    trainer.optimizer.zero_grad(set_to_none=True)
    return {"/".join(k): float(np.sqrt((v.astype(np.float64) ** 2).sum()))
            for k, v in grads.items()}


def check_leaf_summary(got: dict, g: dict, prefix: str, tol: dict, what: str) -> dict:
    """A train run's leaf summary (train_leaf_summary) against the golden's
    under `prefix`: each parameter leaf's change norm within tol["norm_rtol"]
    of its own plus tol["norm_atol"] of the largest, and the batch_stats
    samples within tol["stats"] relative.  Returns the errors."""
    names = g[prefix + "names"]
    if list(got["names"]) != list(names):
        raise AssertionError(f"{what}: the leaves differ from the golden's")
    params = np.array([n.startswith("params/") for n in names])
    want = g[prefix + "change_norm"][params]
    scale = want.max()
    norm_err = np.abs(got["change_norm"][params] - want)
    bad = norm_err > tol["norm_rtol"] * want + tol["norm_atol"] * scale
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} leaves' change norms off: "
                             f"{names[params][bad][:5].tolist()}")
    rel = norm_err / np.maximum(want, 1e-30)
    worst = np.argsort(-rel)[:3]
    out = {"norm_err_of_scale": float(norm_err.max() / scale),
           "norm_rel_err_max": float(rel.max()),
           # the three leaves farthest off their own norm: name, that error,
           # and the leaf's norm as a share of the largest leaf's
           "worst_rel_leaves": [f"{n}:{rel[i]:.3g}:{want[i] / scale:.3g}"
                                for n, i in zip(names[params][worst], worst)]}
    if (~params).any():
        want_s = g[prefix + "sample_value"][~params]
        stats_err = np.abs(got["sample_value"][~params] - want_s) / np.maximum(
            np.abs(want_s), 1e-6)
        if stats_err.max() > tol["stats"]:
            raise AssertionError(f"{what}: batch_stats samples off by {stats_err.max():.3g}")
        out["stats_rel_err"] = float(stats_err.max())
    return out


def check_family_golden(family: str, key: str, trainer, g: dict) -> dict:
    """FAMILY_STEPS steps of a family's trainer (float32, "highest", from the
    golden's starting variables) on the golden's batch, held to the golden
    (entries under "<key>/" for net2net's modes and MTCNN's stages) by
    FAMILY_TOL.  Returns the errors."""
    from fdt_torch.models.loader import flat_variables, to_jax_variables
    prefix = "" if family == "facebox" else f"{key}/"
    tol = FAMILY_TOL[family]
    what = f"train_families {family}" + (f" {key}" if prefix else "")
    batch = family_batch(family, key, int(g["seed"]), int(g["batch"]))
    if batch_sha256(batch) != str(g[prefix + "batch_sha256"]):
        raise AssertionError(f"{what}: the seeded batch differs from the golden's")
    before = flat_variables(to_jax_variables(trainer.model))
    out = {}
    if family == "mtcnn":
        grads = mtcnn_grad_norms(trainer, batch)
        want = g[prefix + "grad_norm"]
        got = np.array([grads[n] for n in g[prefix + "names"]])
        diff = np.abs(got - want)
        bad = diff > tol["grad"] * want
        if bad.any():
            worst = int(np.argmax(diff / np.maximum(want, 1e-30)))
            raise AssertionError(f"{what}: {int(bad.sum())} gradient norms off, the worst "
                                 f"{g[prefix + 'names'][worst]} ({got[worst]:.6g} against "
                                 f"{want[worst]:.6g}; largest leaf {want.max():.6g})")
        out["grad_rel_err_max"] = float((diff / np.maximum(want, 1e-30)).max())
        out["grad_err_of_scale"] = float(diff.max() / want.max())
    lr = float(g[prefix + "lr"] if prefix + "lr" in g else g["lr"])
    losses = np.array([family_step(family, trainer, batch, lr) for _ in range(int(g["steps"]))])
    want = g[prefix + "losses"]
    loss_err = np.abs(losses - want) / np.maximum(np.abs(want), 1e-12)
    for step, rtol in enumerate(tol["loss"]):
        if loss_err[step].max() > rtol:
            raise AssertionError(f"{what}: step {step + 1} losses {losses[step]} against "
                                 f"{want[step]} (rtol {rtol})")
    out["loss_rel_err"] = loss_err.max(axis=1).tolist()
    after = flat_variables(to_jax_variables(trainer.model))
    out.update(check_leaf_summary(train_leaf_summary(before, after), g, prefix, tol, what))
    if family == "mtcnn":
        flipped = float(np.mean(change_signs(before, after) != unpack_signs(g, prefix)))
        if flipped > tol["sign_share"]:
            raise AssertionError(f"{what}: {flipped:.3g} of the changes have another sign")
        out["sign_flipped_share"] = flipped
    return out


# The video paths: frames of the tracking phase's pan written as PNGs and
# read back through fdt_torch.data.read_frames, tracked at fdt's batch of 8
# and at 16; the demos run the first DEMO_FRAMES of them
VIDEO_FRAMES, VIDEO_BATCHES, VIDEO_PASSES, DEMO_FRAMES = 32, (8, 16), 2, 16


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
    MTCNN_SHIFTS: seeded_variables with the setting's bias shifts; "host" is
    "sparse" with MTCNN_HOST_REG's layers scaled by MTCNN_HOST_REG_SCALE."""
    from fdt_torch.models import ONet, PNet, RNet

    shifts = MTCNN_SHIFTS["sparse" if setting == "host" else setting]
    out = []
    for name, model in (("pnet", PNet()), ("rnet", RNet()), ("onet", ONet())):
        variables = seeded_variables(model, MTCNN_WEIGHTS_SEED)
        if name in shifts:
            layer, shift = shifts[name]
            params = variables["params"][layer]
            params["bias"] = params["bias"] - np.float32(shift)
        if setting == "host" and name in MTCNN_HOST_REG:
            params = variables["params"][MTCNN_HOST_REG[name]]
            for key in ("kernel", "bias"):
                params[key] = params[key] * np.float32(MTCNN_HOST_REG_SCALE)
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


def match_unordered(got_boxes, got_lm, want_boxes, want_lm, score_tol: float,
                    px_tol: float, unmatched: int = 0) -> tuple[float, float, int]:
    """Match two MTCNN detection lists of one image row to row, in any order:
    each row of `got` takes the first row of `want` not yet taken whose score
    is within score_tol and whose box and landmarks are within px_tol.
    Return (largest score difference, largest pixel difference of the
    matched rows, rows of either list left unmatched); raise AssertionError
    when more than `unmatched` rows are left."""
    got = np.column_stack([np.asarray(got_boxes)[:, :4], got_lm]) if len(got_boxes) else \
        np.empty((0, 14))
    want = np.column_stack([np.asarray(want_boxes)[:, :4], want_lm]) if len(want_boxes) else \
        np.empty((0, 14))
    free = list(range(len(want)))
    score_err = px_err = 0.0
    for i in range(len(got)):
        for j in free:
            px = float(np.abs(got[i] - want[j]).max())
            ds = abs(float(got_boxes[i][4]) - float(want_boxes[j][4]))
            if px <= px_tol and ds <= score_tol:
                free.remove(j)
                score_err, px_err = max(score_err, ds), max(px_err, px)
                break
    left = len(free) + len(got) - (len(want) - len(free))
    if left > unmatched:
        raise AssertionError(f"{left} detections unmatched (at most {unmatched}) within "
                             f"{score_tol} in score and {px_tol} px: {len(got)} against "
                             f"{len(want)}")
    return score_err, px_err, left


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


def _frames_per_s(run, frames: int, passes: int) -> list[float]:
    """frames / s of `passes` calls of run(), each ended by a synchronize."""
    rates = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        rates.append(frames / (time.perf_counter() - t))
    return rates


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
    return det32, det, launches, boxes_err


def _spread(rates) -> float:
    return (max(rates) - min(rates)) / max(rates) * 100


# the fold of conv → BatchNorm → ReLU chains (fdt_torch/models/fused.py) on
# the benchmark's three bf16 detectors: name → (its cell, fused_convs and
# bn_unfused of one forward); try1 folds nothing (PERF.md §6)
FUSED = {"repo": ("res50.eval", 83, 0), "try1": ("try1.batch", 0, 41),
         "retina": ("retina.eval", 69, 0)}
REFOLD_CHECK_US_MAX = 500.0  # the once-a-call check, nothing changed (52-97 µs measured)


def phase_fused(device) -> dict:
    """The fold of conv → BatchNorm → ReLU chains (fdt_torch/models/fused.py)
    on the benchmark's three bf16 detectors at their batch and size (the
    flagship and try1 on their npz, RetinaFace-ResNet50 at its default
    initialisation): the counters of the first (eager) call, which must be
    FUSED's; the device operations and kernels of one graph replay, none of
    them a BatchNorm's where the model folds; and the host microseconds of
    the detector's once-a-call check for weights changed in place
    (`_refold`, nothing changed: nothing folded again, under
    REFOLD_CHECK_US_MAX)."""
    import dataclasses

    from fdt_torch.config import PYRAMID_CONFIGS, RETINA_RES50
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.infer.retinaface import RetinaFaceDetector
    from fdt_torch.models import RetinaFace, fused, load_pyramidbox
    from torch.profiler import ProfilerActivity, profile

    cases = {"repo": (8, 640, 0.0, 0.35), "try1": (32, 640, 0.3, 0.3),
             "retina": (8, 1024, 0.02, 0.4)}
    out = {}
    for name, (batch, size, conf, nms_thresh) in cases.items():
        t0 = time.perf_counter()
        kw = dict(budget=5000, dtype=torch.bfloat16, device=device)
        if name == "retina":
            det = RetinaFaceDetector(RetinaFace().eval(), detect_cfg=dataclasses.replace(
                RETINA_RES50.detect, top_k=750), **kw)
        else:
            weights = WEIGHTS if name == "repo" else REPO / "net_weight/try1_distilled_mini.npz"
            det = PyramidBoxDetector(load_pyramidbox(str(weights), name), name,
                                     detect_cfg=dataclasses.replace(
                                         PYRAMID_CONFIGS[name].detect, top_k=750), **kw)
        frames = np.random.RandomState(4).randint(0, 256, (batch, size, size, 3), dtype=np.uint8)
        fused.fused_convs.reset()
        fused.bn_unfused.reset()
        det.detect_tensor(frames, conf_thresh=conf, nms_thresh=nms_thresh)  # eager
        counts = fused.fused_convs.count, fused.bn_unfused.count
        for _ in range(2):  # the capture, a replay
            det.detect_tensor(frames, conf_thresh=conf, nms_thresh=nms_thresh)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            det.detect_tensor(frames, conf_thresh=conf, nms_thresh=nms_thresh)
        ops = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        kernels = [n for n in ops if not n.startswith(("Memcpy", "Memset"))]
        check_us = []
        for _ in range(5):
            t = time.perf_counter()
            for _ in range(200):
                det._refold()
            check_us.append((time.perf_counter() - t) / 200 * 1e6)
        refolded = [f.refresh() for f in det._folds.values()]
        out[name] = dict(fused_convs=counts[0], bn_unfused=counts[1], replay_operations=len(ops),
                         replay_kernels=len(kernels),
                         batch_norm_kernels=sum("batch_norm" in n for n in kernels),
                         refold_check_us=round(min(check_us), 2),
                         folded_sources=sum(len(f._slots) for f in det._folds.values()))
        _phase("fused", t0, model=name, batch=batch, size=size,
               **{k: v for k, v in out[name].items()})
        assert counts == FUSED[name][1:], (name, counts)
        assert bool(det._folds) == (counts[0] > 0) and not any(refolded), name
        assert counts[0] == 0 or out[name]["batch_norm_kernels"] == 0, out[name]
        assert out[name]["refold_check_us"] < REFOLD_CHECK_US_MAX, out[name]
        del det
        torch.cuda.empty_cache()
    return out


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


def int8_edge_case(name: str, device="cpu"):
    """INT8_EDGES[name] or INT8_TILE_EDGES[name] → (x [B,C,H,W], an
    Int8Conv2d of seeded weights quantized and cast to x's dtype, both on
    `device`, whether x is channels-last)."""
    from fdt_torch.ops.quant import Int8Conv2d

    b, cin, h, w, cout, k, s, p, d, groups, dtype, cl, bias, fill = (
        INT8_EDGES.get(name) or INT8_TILE_EDGES[name])
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.randn(b, cin, h, w).astype(np.float32) * 3
    if fill == "zero":
        x[:] = 0
    elif fill == "nan-inf":
        x.flat[5], x.flat[17] = np.nan, np.inf
    elif fill == "inf":
        x.flat[3] = -np.inf
    conv = Int8Conv2d(cin, cout, k, s, p, dilation=d, groups=groups, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            rng.randn(*conv.weight.shape).astype(np.float32) * 0.05))
        if bias:
            conv.bias.copy_(torch.from_numpy(rng.randn(cout).astype(np.float32)))
    conv.quantize_weights()
    xt = torch.from_numpy(x).to(device, getattr(torch, dtype))
    if cl:
        xt = xt.contiguous(memory_format=torch.channels_last)
    if fill == "offset":
        storage = torch.empty(xt.numel() + 1, dtype=xt.dtype, device=device)
        storage[1:] = xt.permute(0, 2, 3, 1).reshape(-1)
        xt = storage[1:].view(b, h, w, cin).permute(0, 3, 1, 2)
    return xt, conv.to(device, xt.dtype), cl


def _int8_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in float32, a NaN equal to a NaN; inf where only
    one of them is NaN."""
    g, w = got.float(), want.float()
    if not torch.equal(g.isnan(), w.isnan()):
        return float("inf")
    differ = (g != w) & ~g.isnan()
    return float((g - w).abs()[differ].max()) if bool(differ.any()) else 0.0


def check_int8_conv(conv, x: torch.Tensor) -> tuple[float, float]:
    """K5 and K4 on x against their plain versions on x's device: (K5's
    largest error over q and the scale, K4's over the conv's output)."""
    from fdt_torch.ops import quant

    xq, sx = quant.quantize_int8(x)
    xq_p, sx_p = quant.quantize_int8_plain(x)
    k5 = max(_int8_err(xq, xq_p), _int8_err(sx, sx_p))
    wpack, sw = conv._int8
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    args = dict(kernel=conv.kernel_size, stride=conv.stride, padding=conv.padding,
                dilation=conv.dilation, groups=conv.groups, out_dtype=x.dtype,
                channels_last=quant.is_channels_last(x))
    y = quant.conv_int8(xq, sx, wpack, sw, bias, **args)
    return k5, _int8_err(y, quant.conv_int8_plain(xq_p, sx_p, wpack, sw, bias, **args))


def int8_convs_of(model) -> list:
    """The Int8Conv2d modules of a model (each runs in int8)."""
    from fdt_torch.ops.quant import Int8Conv2d

    return [m for m in model.modules() if isinstance(m, Int8Conv2d)]


def check_int8_model(model, run) -> dict:
    """run() through `model`, each int8 conv checked on its own input
    (check_int8_conv): the convs run and checked (a detect runs no conv of
    PyramidBox's head-supervision branch), their geometries, the (kernel,
    stride, dilation) among them, the largest K5 and K4 errors."""
    errs, geoms, seen = [0.0, 0.0], set(), [0]

    def hook(mod, inputs, _out):
        e5, e4 = check_int8_conv(mod, inputs[0])
        errs[0], errs[1] = max(errs[0], e5), max(errs[1], e4)
        seen[0] += 1
        geoms.add((mod.in_channels, mod.out_channels, mod.kernel_size, mod.stride,
                   mod.padding, mod.dilation, mod.groups))

    handles = [m.register_forward_hook(hook) for m in int8_convs_of(model)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return {"convs": seen[0], "geometries": len(geoms), "k5_err": errs[0], "k4_err": errs[1],
            "kernels": sorted({(g[2][0], g[3][0], g[5][0]) for g in geoms})}


def flagship_batch() -> np.ndarray:
    """The bf16 flagship's batch: BATCH seeded noise frames of SIZE²."""
    return np.random.RandomState(1).randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)


def _iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area[:, None] + area_b[None] - inter)


def int8_drift(want: np.ndarray, got: np.ndarray, n: int = INT8_ROWS) -> dict:
    """fdt's int8-against-float measures (tests/test_quant.py:160-175) over
    the first n rows of two score-sorted [score, x1, y1, x2, y2] lists: the
    share of `want`'s rows that a row of `got` overlaps at IoU > 0.5, the
    median best IoU of those, and the largest score difference of those
    pairs."""
    want, got = want[:n], got[:n]
    if len(want) < n or len(got) < n:
        raise AssertionError(f"need {n} rows, got {len(want)} and {len(got)}")
    iou = _iou_np(want[:, 1:], got[:, 1:])
    best = iou.max(1)
    m = best > 0.5
    score = np.abs(want[m, 0] - got[iou.argmax(1)[m], 0])
    return {"matched": float(m.mean()), "median_iou": float(np.median(best[m])) if m.any() else 0.0,
            "score_diff": float(score.max()) if m.any() else float("inf")}


def int8_bf16_limits(golden) -> dict:
    """The bf16 int8 flagship against the bf16 float one on flagship_batch():
    fdt's bounds, each loosened where fdt's own bf16 int8 detector is worse
    against its float one on the same frames (the golden's fdt_bf16_*, one
    value an image): the batch's mean matched share at least
    int8_min_matched of fdt's mean, the lowest median IoU at least fdt's
    lowest, the largest score difference at most fdt's largest."""
    return {"matched": int8_min_matched(float(np.mean(golden["fdt_bf16_matched"]))),
            "median_iou": min(INT8_MEDIAN_IOU, float(np.min(golden["fdt_bf16_median_iou"]))),
            "score_diff": max(INT8_SCORE_DIFF, float(np.max(golden["fdt_bf16_score_diff"])))}


def int8_min_matched(fdt_float_matched: float) -> float:
    """The share of rows that must match: fdt's 90%, or fdt's own
    float-to-int8 share on the same input less INT8_MATCH_SLACK, the lower."""
    return min(INT8_MATCHED, fdt_float_matched - INT8_MATCH_SLACK)


def check_int8_drift(want: np.ndarray, got: np.ndarray, min_matched: float, what: str) -> dict:
    """int8_drift within fdt's bounds on the score and IoU of matched rows and
    at least `min_matched` matched; raises AssertionError."""
    d = int8_drift(want, got)
    if (d["matched"] < min_matched or d["median_iou"] < INT8_MEDIAN_IOU
            or d["score_diff"] > INT8_SCORE_DIFF):
        raise AssertionError(f"{what}: int8 drift {d} beyond matched >= {min_matched:.3f}, "
                             f"median IoU >= {INT8_MEDIAN_IOU}, score <= {INT8_SCORE_DIFF}")
    return d


def check_int8_golden(gq, rows: np.ndarray, what: str) -> dict:
    """rows against the int8 golden's: check_int8_drift at int8_min_matched
    of fdt's own float-to-int8 share, and a control that a detector which
    skipped quantization fails: rows must match more of the golden's rows
    than fdt's float golden rows (GOLDEN) do, 0.65 on the 640² frame, where
    a float path matches as many as fdt's float does.  Adds that share as
    float_matched; raises AssertionError."""
    d = check_int8_drift(gq["rows"], rows, int8_min_matched(float(gq["fdt_float_matched"])),
                         what)
    control = int8_drift(gq["rows"], np.load(GOLDEN)["rows"])["matched"]
    if d["matched"] <= control:
        raise AssertionError(f"{what}: matched {d['matched']} of fdt's int8 rows, no more "
                             f"than fdt's float rows match ({control}): no int8 effect")
    return {**d, "float_matched": control}


def _conv_work(x: torch.Tensor, conv, y: torch.Tensor) -> dict:
    """A K4 call's GEMM (M, N, K), its operations and the bytes it must move
    (xq read once, the weights, scales and bias once, y written once), and
    K5's bytes on the same input (x read, q written)."""
    b, _, ho, wo = y.shape
    m, n = b * ho * wo, conv.out_channels
    k = conv.kernel_size[0] * conv.kernel_size[1] * conv.in_channels // conv.groups
    k4_bytes = (x.numel() + n * k + 4 * n + 4 + y.numel() * y.element_size()
                + (0 if conv.bias is None else n * y.element_size()))
    return {"m": m, "n": n, "k": k, "ops": 2 * m * n * k,
            "k4_bytes": k4_bytes, "k5_bytes": x.numel() * (x.element_size() + 1) + 4}


def _bound_ms(ops: float, peak_ops: float, nbytes: float) -> tuple[float, str]:
    by_ops, by_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def int8_conv_class(conv) -> str:
    """The class of an int8 conv of the flagship: "stem" (input channels a
    group not a multiple of 16: the 7×7 / 2 over 3 channels), "head" (8
    outputs or fewer), "1x1", or "wide kxk"."""
    if conv.in_channels // conv.groups % 16:
        return "stem"
    if conv.out_channels <= 8:
        return "head"
    return "1x1" if tuple(conv.kernel_size) == (1, 1) else "wide kxk"


def int8_variant(conv) -> str:
    """The K4 variant the wrapper picks for conv on K5's output (16-byte
    aligned); "mma_sync" in a checkout from before the variants, which has
    only that kernel."""
    from fdt_torch.ops import quant

    pick = getattr(quant, "conv_variant", None)
    return pick(conv.in_channels, conv.groups, 0) if pick else "mma_sync"


def int8_heaviest(work: dict, shapes: int = 3) -> list:
    """The `shapes` heaviest convs (2·M·N·K) of `work`, then the first conv
    of each other K4 variant (the flagship's stem), so that every variant
    is timed."""
    heavy = sorted(work, key=lambda m: -work[m]["ops"])[:shapes]
    variants = {int8_variant(m) for m in heavy}
    for mod in work:
        if int8_variant(mod) not in variants:
            variants.add(int8_variant(mod))
            heavy.append(mod)
    return heavy


# K4's and K5's kernels (either variant of K4; K5's one-launch kernel, or the
# two of a checkout from before it) in a profiler trace
K4_KERNELS, K5_KERNELS = r"conv_int8_\w*kernel", r"amax_kernel|quantize_\w*kernel"


@torch.inference_mode()
def int8_timings(det, staged, select=int8_heaviest, plain: bool = True,
                 cudnn: bool = True) -> tuple[list, dict]:
    """K4 and K5 on the int8 convs of one detect of `staged` that
    `select(work)` picks (work: conv → _conv_work, in forward order), on the
    convs' own inputs: held to their plain versions there (check_int8_conv;
    raises unless bit-equal), CUDA events over 20 calls, the profiler's
    device time a call (5 calls) and the host time a call of K4's and K5's
    wrappers and of the conv module's forward (20 calls enqueued without a
    wait), beside the plain versions (3
    calls; plain=True), the bounds, torch._int_mm on the
    same (M, N, K) GEMM of random int8 matrices (the im2col that a conv
    through it needs is not counted) and cuDNN's bf16 conv of the same
    shape (cudnn=True), as context.  Returns (a dict a timed conv, in
    select's order; the sums over every int8 conv of the detect: the K4
    bound by variant, the operations-only K4 bound, the K5 bound)."""
    import torch.nn.functional as F

    from fdt_torch.ops import quant

    work, kept = {}, {}
    chosen = set()

    def measure(mod, inputs, out):
        work[mod] = _conv_work(inputs[0], mod, out)

    handles = [m.register_forward_hook(measure) for m in int8_convs_of(det.model)]
    try:
        det.detect_device(staged, 0.35, 0.35)
    finally:
        for h in handles:
            h.remove()
    timed = select(work)
    chosen.update(timed)

    def keep(mod, inputs, _out):
        if mod in chosen:
            kept[mod] = inputs[0]

    handles = [m.register_forward_hook(keep) for m in timed]
    try:
        det.detect_device(staged, 0.35, 0.35)
    finally:
        for h in handles:
            h.remove()
    sums = {"k4_bound_ms": {}, "k4_ops_bound_ms": 0.0, "k5_bound_ms": 0.0, "convs": {}}
    for mod, w in work.items():
        variant = int8_variant(mod)
        bound = _bound_ms(w["ops"], PEAK_INT8_OPS_S, w["k4_bytes"])[0]
        sums["k4_bound_ms"][variant] = sums["k4_bound_ms"].get(variant, 0.0) + bound
        sums["convs"][variant] = sums["convs"].get(variant, 0) + 1
        sums["k4_ops_bound_ms"] += w["ops"] / PEAK_INT8_OPS_S * 1e3
        sums["k5_bound_ms"] += _bound_ms(0, PEAK_INT8_OPS_S, w["k5_bytes"])[0]
    out = []
    for mod in timed:
        x, w = kept.pop(mod), work[mod]
        k5_err, k4_err = check_int8_conv(mod, x)
        if k5_err or k4_err:
            raise AssertionError(f"{tuple(x.shape)}: K5 error {k5_err}, K4 error {k4_err}")
        xq, sx = quant.quantize_int8(x)
        wpack, sw = mod._int8
        bias = None if mod.bias is None else mod.bias.to(x.dtype)
        args = dict(kernel=mod.kernel_size, stride=mod.stride, padding=mod.padding,
                    dilation=mod.dilation, groups=mod.groups, out_dtype=x.dtype,
                    channels_last=quant.is_channels_last(x))
        k4 = _cuda_ms(lambda: quant.conv_int8(xq, sx, wpack, sw, bias, **args), 20)
        k5 = _cuda_ms(lambda: quant.quantize_int8(x), 20)
        device, host = {}, {}
        for key, fn, pattern in (
                ("k4", lambda: quant.conv_int8(xq, sx, wpack, sw, bias, **args), K4_KERNELS),
                ("k5", lambda: quant.quantize_int8(x), K5_KERNELS),
                ("forward", lambda: mod(x), None)):
            if pattern:
                split, _ = _device_split(fn, 5, pattern)
                device[key] = sum(e["us"] for e in split.values()) / 1e3 if split else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            host[key] = (time.perf_counter() - t0) / 20 * 1e3
            torch.cuda.synchronize()
        gen = torch.Generator(device=x.device).manual_seed(0)
        a = torch.randint(-127, 128, (w["m"], w["k"]), dtype=torch.int8, device=x.device,
                          generator=gen)
        bt = torch.randint(-127, 128, (w["n"], w["k"]), dtype=torch.int8, device=x.device,
                           generator=gen)
        try:
            torch._int_mm(a, bt.t())
            int_mm = f"{_cuda_ms(lambda: torch._int_mm(a, bt.t()), 20):.4f}"
        except RuntimeError as e:  # the library refuses the shape: print why
            int_mm = "refused: " + str(e).splitlines()[0][:120]
        del a, bt
        k4_bound, k4_by = _bound_ms(w["ops"], PEAK_INT8_OPS_S, w["k4_bytes"])
        k5_bound, k5_by = _bound_ms(0, PEAK_INT8_OPS_S, w["k5_bytes"])
        line = {"shape": f"{tuple(x.shape)}->{mod.out_channels}:{mod.kernel_size[0]}x"
                         f"{mod.kernel_size[1]}/{mod.stride[0]}",
                "class": int8_conv_class(mod), "variant": int8_variant(mod),
                "mnk": (w["m"], w["n"], w["k"]), "k4_err": k4_err, "k5_err": k5_err,
                "k4_ms": k4, "k4_device_ms": device["k4"], "k4_host_ms": host["k4"],
                "k4_bound_ms": k4_bound, "k4_bound_by": k4_by, "int_mm_ms": int_mm, "k5_ms": k5,
                "k5_device_ms": device["k5"], "k5_host_ms": host["k5"],
                "forward_host_ms": host["forward"], "k5_bound_ms": k5_bound,
                "k5_bound_by": k5_by, "k4_tops": w["ops"] / k4 / 1e9}
        if plain:
            line["k4_plain_ms"] = _cuda_ms(
                lambda: quant.conv_int8_plain(xq, sx, wpack, sw, bias, **args), 3)
            line["k5_plain_ms"] = _cuda_ms(lambda: quant.quantize_int8_plain(x), 3)
        if cudnn:
            weight = mod.weight.detach().to(x.dtype, memory_format=torch.channels_last)
            line["cudnn_bf16_ms"] = _cuda_ms(lambda: F.conv2d(
                x, weight, bias, mod.stride, mod.padding, mod.dilation, mod.groups), 20)
        out.append(line)
        del x, xq
    return out, sums


def _int8_counts() -> tuple[int, int, int]:
    """(K4 launches of both variants, K5's, K1's)."""
    k4 = _k4_counts()
    from fdt_torch.ops import nms as nms_op, quant
    return k4["wgmma"] + k4["mma_sync"], quant.quantize_launches.count, nms_op.launches.count


def _k4_counts() -> dict:
    """K4's launches by variant."""
    from fdt_torch.ops import quant
    return {"wgmma": quant.launches.count, "mma_sync": quant.mma_sync_launches.count}


def _reset_counts() -> None:
    from fdt_torch.ops import nms as nms_op, quant
    for counter in (quant.launches, quant.mma_sync_launches, quant.quantize_launches,
                    nms_op.launches):
        counter.reset()


def k4_picks(model, run) -> dict:
    """run() through `model`: the K4 variant conv_variant names for each int8
    conv's input (quantize_int8's q), counted by variant."""
    from fdt_torch.ops import quant

    picks = {}

    def hook(mod, inputs, _out):
        v = quant.conv_variant(inputs[0].shape[1], mod.groups, 0)
        picks[v] = picks.get(v, 0) + 1

    handles = [m.register_forward_hook(hook) for m in int8_convs_of(model)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return picks


def phase_int8(device, det16):
    """int8 inference (quant="int8": K5 quantizes each int8 conv's input, K4
    runs the conv).  K5 and K4 bit-equal to their plain versions on
    INT8_EDGES, INT8_TILE_EDGES and on every int8 conv of the flagship (bf16
    at the main path's batch 8, 640², bf16 and float32 at a small batch),
    try1 (bf16, its grouped 1×1s) and FaceBoxes (bf16) on the convs' own
    inputs; the float32 int8 flagship on the golden frame against fdt's
    (INT8_GOLDEN, check_int8_golden); the bf16 int8 flagship at batch 8,
    640² (the main path: 111 K4 launches, each of the variant conv_variant
    picks, at least 108 of them wgmma, 111 K5 launches and one K1) against
    the bf16 float flagship `det16` on the same frames, with both
    detectors' images/s from this call; try1 and FaceBoxes once each with
    int8, K4's launches by variant as picked; a _time_split of one int8
    flagship call (K4 by variant); K4 and K5 checked and timed at the three
    heaviest convs and the stem (the mma_sync variant).  Returns the
    launches (K4's by variant), the timings, the sums of the bounds over a
    batch and the largest K4 and K5 errors."""
    from fdt_torch.infer import FaceBoxDetector, PyramidBoxDetector
    from fdt_torch.models import FaceBox, from_jax_variables, load_pyramidbox

    t0 = time.perf_counter()
    for name in [*INT8_EDGES, *INT8_TILE_EDGES]:
        x, conv, _ = int8_edge_case(name, device)
        e5, e4 = check_int8_conv(conv, x)
        if e5 or e4:
            raise AssertionError(f"int8 edge {name}: K5 error {e5}, K4 error {e4}")
    model = load_pyramidbox(str(WEIGHTS))
    det16q = PyramidBoxDetector(model, dtype=torch.bfloat16, device=device, quant="int8")
    det32q = PyramidBoxDetector(model, device=device, quant="int8")
    try1 = PyramidBoxDetector(load_pyramidbox(str(REPO / VARIANT_WEIGHTS["try1"]), "try1"),
                              "try1", dtype=torch.bfloat16, device=device, quant="int8")
    g = np.load(FACEBOX_GOLDEN)
    fb_model = FaceBox()
    fb_model.load_state_dict(from_jax_variables(
        seeded_variables(fb_model, int(g["weights_seed"]))), strict=True)
    facebox = FaceBoxDetector(fb_model, dtype=torch.bfloat16, device=device, quant="int8")
    small = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2, 160, 160, 3), dtype=np.uint8)).to(device)
    fb_frame = torch.from_numpy(golden_frame(int(g["frame_seed"]), FACEBOX_SIZE,
                                             FACEBOX_SIZE)[None]).to(device)
    frames = flagship_batch()
    staged = torch.from_numpy(frames).to(device)
    checked = {
        # the main path's own inputs: every int8 conv at batch 8, 640²
        "flagship_main": check_int8_model(det16q.model,
                                          lambda: det16q.detect_device(staged, 0.35, 0.35)),
        "flagship_bf16": check_int8_model(det16q.model, lambda: det16q.detect_device(small)),
        "flagship_f32": check_int8_model(det32q.model, lambda: det32q.detect_device(small)),
        "try1_bf16": check_int8_model(try1.model, lambda: try1.detect_device(small)),
        "facebox_bf16": check_int8_model(facebox.model, lambda: facebox.detect_device(fb_frame))}
    bad = {k: v for k, v in checked.items() if v["k5_err"] or v["k4_err"]}
    if bad:
        raise AssertionError(f"K5 or K4 != plain on a model's own convs: {bad}")
    _phase("int8_kernels", t0, edges=len(INT8_EDGES) + len(INT8_TILE_EDGES),
           **{f"{k}_convs": v["convs"] for k, v in checked.items()},
           **{f"{k}_geometries": v["geometries"] for k, v in checked.items()},
           flagship_kxsxd=",".join("x".join(map(str, g)) for g in checked["flagship_bf16"]["kernels"]),
           max_abs_err=max(max(v["k5_err"], v["k4_err"]) for v in checked.values()))

    t0 = time.perf_counter()
    gq = np.load(INT8_GOLDEN)
    frame = golden_frame(int(gq["seed"]), int(gq["height"]), int(gq["width"]))
    if hashlib.sha256(frame.tobytes()).hexdigest() != str(gq["frame_sha256"]):
        raise AssertionError("the seeded frame differs from the int8 golden's")
    with _tf32(True):  # the global flags on: the detector turns TF32 off itself
        rows = det32q.detect_tensor(frame[None], float(gq["conf_thresh"]),
                                    float(gq["nms_thresh"]))[0, 1]
    min_matched = int8_min_matched(float(gq["fdt_float_matched"]))
    golden = check_int8_golden(gq, rows, "int8 golden")
    _phase("int8_golden", t0, count=int((rows[:, 0] > 0).sum()), golden_count=int(gq["count"]),
           min_matched=f"{min_matched:.3f}", fdt_float_matched=f"{float(gq['fdt_float_matched']):.3f}",
           **{k: f"{v:.4f}" for k, v in golden.items()},
           scores_max_abs_diff=f"{_score_diff(rows, gq['rows']):.4f}")

    t0 = time.perf_counter()
    picks = k4_picks(det16q.model, lambda: det16q.detect_device(staged, 0.35, 0.35))
    if picks.get("wgmma", 0) < 108:
        raise AssertionError(f"the flagship's K4 variants {picks}: fewer than 108 wgmma")
    torch.cuda.synchronize()
    _reset_counts()
    out = det16q.detect_tensor(frames, conf_thresh=0.35, nms_thresh=0.35)  # the main path
    k4, k5, k1 = _int8_counts()
    k4_by = _k4_counts()
    n_int8 = checked["flagship_bf16"]["convs"]  # the convs a forward runs
    if out.shape != (BATCH, 2, 750, 5) or not np.isfinite(out).all():
        raise AssertionError(f"bad int8 flagship output {out.shape}")
    if k4 != n_int8 or k5 != n_int8 or k1 != 1 or k4_by != {v: picks.get(v, 0) for v in k4_by}:
        raise AssertionError(f"int8 flagship path: {k4} K4 ({k4_by}, picked {picks}), {k5} K5, "
                             f"{k1} K1 launches (want {n_int8}, {n_int8}, 1)")
    rates = {}
    for name, det in (("int8", det16q), ("bf16", det16)):
        _warm(lambda: det.detect_device(staged, 0.35, 0.35))
        rates[name] = _rates(lambda: det.detect_device(staged, 0.35, 0.35), BATCH)
    # int8 against float, the top rows of each image at conf 0.01, held to
    # int8_bf16_limits: what fdt's own bf16 int8 detector shows against its
    # bf16 float one on these frames (kept in the golden)
    dense_q = det16q.detect_tensor(frames, conf_thresh=0.01, nms_thresh=0.35)
    dense_f = det16.detect_tensor(frames, conf_thresh=0.01, nms_thresh=0.35)
    if np.array_equal(dense_q, dense_f):  # the control a float path fails
        raise AssertionError("bf16 int8 rows equal the bf16 float rows: no int8 effect")
    drifts = [int8_drift(dense_f[i, 1], dense_q[i, 1]) for i in range(BATCH)]
    mean_matched = float(np.mean([d["matched"] for d in drifts]))
    limits = int8_bf16_limits(gq)
    if (mean_matched < limits["matched"]
            or min(d["median_iou"] for d in drifts) < limits["median_iou"]
            or max(d["score_diff"] for d in drifts) > limits["score_diff"]):
        raise AssertionError(f"bf16 int8 against bf16 float: {drifts} beyond {limits} "
                             "(matched: the batch's mean)")
    counts = [(out[:, 1, :, 0] > 0).sum(axis=1).tolist(),
              (det16.detect_tensor(frames, 0.35, 0.35)[:, 1, :, 0] > 0).sum(axis=1).tolist()]
    _phase("int8_flagship", t0, batch=BATCH, size=f"{SIZE}x{SIZE}",
           int8_images_per_s=f"{max(rates['int8']):.2f}",
           bf16_images_per_s=f"{max(rates['bf16']):.2f}",
           rates={k: [round(r, 2) for r in v] for k, v in rates.items()},
           k4_launches=k4, k4_wgmma=k4_by["wgmma"], k4_mma_sync=k4_by["mma_sync"],
           k5_launches=k5, k1_launches=k1, count_035_int8=counts[0],
           count_035_bf16=counts[1],
           matched=[round(d["matched"], 2) for d in drifts], mean_matched=f"{mean_matched:.3f}",
           limits={k: round(v, 4) for k, v in limits.items()},
           median_iou_min=f"{min(d['median_iou'] for d in drifts):.4f}",
           score_diff_max=f"{max(d['score_diff'] for d in drifts):.4f}")

    t0 = time.perf_counter()
    launches = {"k4": k4, "k5": k5, "k1": k1, **{f"k4_{v}": c for v, c in k4_by.items()}}
    fb_frames = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (FACEBOX_BATCH, FACEBOX_SIZE, FACEBOX_SIZE, 3), dtype=np.uint8)).to(device)
    for name, run, want in (
            ("try1", lambda: try1.detect_device(staged), checked["try1_bf16"]["convs"]),
            ("facebox", lambda: facebox.detect_device(fb_frames)[0],
             checked["facebox_bf16"]["convs"])):
        model = try1.model if name == "try1" else facebox.model
        picked = k4_picks(model, run)
        torch.cuda.synchronize()
        _reset_counts()
        got = run()
        counts, by = _int8_counts(), _k4_counts()
        if (not bool(torch.isfinite(got).all()) or counts != (want, want, 1)
                or by != {v: picked.get(v, 0) for v in by}):
            raise AssertionError(f"int8 {name}: finite {bool(torch.isfinite(got).all())}, "
                                 f"K4/K5/K1 launches {counts} (want {want}, {want}, 1), K4 "
                                 f"by variant {by} (picked {picked})")
        for key, c in zip(("k4", "k5", "k1"), counts):
            launches[key] += c
        for v, c in by.items():
            launches[f"k4_{v}"] += c
        launches[f"{name}_convs"] = want
        launches[f"{name}_k4"] = by
    split = _time_split(lambda: det16q.detect_device(staged, 0.35, 0.35))
    timed, sums = int8_timings(det16q, staged)
    for t in timed:
        print("[int8] " + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                                  for k, v in t.items()), flush=True)
    print("[int8] split " + " ".join(f"{k}={v:.3f}" for k, v in sorted(split["parts"].items()))
          + f" wall_ms={split['wall_ms']:.3f} device_ms={split['device_ms']:.3f}"
          + f" idle_pct={split['idle_pct']:.1f}" if split["parts"] else "[int8] split: no device time")
    print("[int8] batch bounds " + json.dumps(sums), flush=True)
    _phase("int8_variants", t0, try1_convs=launches["try1_convs"],
           facebox_convs=launches["facebox_convs"], try1_k4=launches["try1_k4"],
           facebox_k4=launches["facebox_k4"], timed_shapes=len(timed))
    # the largest K4 and K5 differences from their plain versions, over every
    # comparison of this phase (0, or it raised)
    errors = {f"k{i}": max([v[f"k{i}_err"] for v in checked.values()]
                           + [t[f"k{i}_err"] for t in timed]) for i in (4, 5)}
    return launches, timed, sums, errors


# K3's kernels, both variants (and the one of a checkout from before them)
K3_KERNELS = r"track_assoc_(?:smem_|global_)?kernel"
# kernel name → part of a detect, first match wins (PyTorch's, cuDNN's and
# cuBLAS's kernel names; K1's are nms_*_kernel)
KERNEL_PARTS = (("k1", r"nms_\w+_kernel"), ("k3", K3_KERNELS),
                ("k4_wgmma", r"conv_int8_wgmma_kernel"), ("k4_mma_sync", r"conv_int8_kernel"),
                ("k5", r"amax_kernel|quantize_\w*kernel"),
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


def unfused_tracks(det, chunks, cfg, device_rows: bool = False,
                   cap: int | None = TRACK_DET_CAP):
    """The unfused tracking path at the fused tracker's chunk shapes:
    detect_tensor (a host read) and detections_to_rows at cfg.score_floor,
    rows capped at `cap` (None: uncapped), then the host IoUTracker (or, with
    device_rows, DeviceIoUTracker on the card, bench.py's tracker_device
    leg).  Returns (tracks, the [N, 5] rows of every frame, live tracks a
    frame)."""
    from fdt_torch.infer import detections_to_rows
    from fdt_torch.track import DeviceIoUTracker, IoUTracker

    h, w = chunks[0].shape[1:3]
    floor = cfg.score_floor
    tracker = (DeviceIoUTracker(cfg, t_max=TRACK_T_MAX, device=det.device)
               if device_rows else IoUTracker(cfg))
    all_rows, live_n = [], []
    for chunk in chunks:
        out = det.detect_tensor(chunk, floor, TRACK_NMS)
        rows = [detections_to_rows(o, floor, [w, h, w, h])[:cap] for o in out]
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
            rates[leg] = _frames_per_s(run, TRACK_FRAMES, TRACK_PASSES)
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


def graph_counts() -> tuple[int, int, int]:
    """The PyramidBox detect path's graph cache counters
    (fdt_torch.infer.graphs): eager calls, captures, replays."""
    from fdt_torch.infer import graphs

    return graphs.graph_eager.count, graphs.graph_captures.count, graphs.graph_replays.count


def k1_through_graphs(before: tuple) -> tuple[int, int]:
    """(K1 launches, calls) of the detect_tensor calls through the graph
    cache since graph_counts() read `before`: a call run eagerly launches K1
    once, a capture twice (its warm-up on a side stream and the capture), a
    replay never (K1 runs inside the graph)."""
    eager, captures, replays = (a - b for a, b in zip(graph_counts(), before))
    return eager + 2 * captures, eager + captures + replays


def _serve(name, svc, images, want, threshold, t0, launches_per_batch=None) -> None:
    """Drive `svc` with `images` from 4 client threads; every answer must
    agree with its direct call `want[i]`, and K1 must launch once a batch
    that runs eagerly (k1_through_graphs for the batches through the graph
    cache), or launches_per_batch() times in all, read after the run."""
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
    before = graph_counts()
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
    graph_k1, graph_calls = k1_through_graphs(before)
    expected = (stats["batches"] - graph_calls + graph_k1 if launches_per_batch is None
                else launches_per_batch())
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


# HTTP front end: the bf16 flagship at 640² (bench.py:167-200) behind
# make_http_server, HTTP_REQUESTS PNG bodies of seeded noise frames POSTed
# from 4 client threads; the threshold is below bench.py's 0.35, at which a
# noise frame passes almost no row.  Each answer is held to a direct
# detect_tensor call on the batch the request rode in: in bf16 the rows of a
# frame move with the batch size (cuDNN picks other kernels), by about 0.1
# in score and, where NMS keeps another box, hundreds of pixels against
# batch 1 (the phase prints batch1_max_score_diff and batch1_max_px_diff)
HTTP_REQUESTS, HTTP_CLIENTS, HTTP_THRESHOLD = 16, 4, 0.25
# WIDER eval: scripts/my_test.py's protocol (threshold 0.0, its default; nms
# 0.35) on EVAL_IMAGES seeded noise PNGs of EVAL_SIZES (h, w): 8 sizes from
# 320 to 1024 a side, four of them at their 128-multiple bucket size
EVAL_SIZES = ((320, 320), (480, 640), (384, 512), (600, 800), (640, 640),
              (768, 1024), (1024, 768), (720, 960))
EVAL_IMAGES, EVAL_THRESHOLD, EVAL_NMS, EVAL_BATCH = 24, 0.0, 0.35, 8
EVAL_CACHE_BOUND = 4  # the detector's per-shape LRU, lowered for the eviction pass


def encode_png(img: np.ndarray, row_filter=2, level: int = 6) -> bytes:
    """[H, W] gray, [H, W, 3] BGR or [H, W, 4] BGRA uint8 → PNG bytes, 8-bit,
    each row filtered with `row_filter` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth), or with row_filter[y] for row y when it is a sequence; zlib at
    `level`."""
    import struct
    import zlib

    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    px = img.reshape(h, w, c)
    if c >= 3:  # BGR(A) → RGB(A)
        px = np.concatenate([px[:, :, 2::-1], px[:, :, 3:]], axis=2)
    raw = px.reshape(h, w * c).astype(np.int16)
    left, up, upleft = (np.zeros_like(raw) for _ in range(3))
    left[:, c:], up[1:], upleft[1:, c:] = raw[:, :-c], raw[:-1], raw[:-1, :-c]
    pa, pb = np.abs(up - upleft), np.abs(left - upleft)
    pc = np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(raw), left, up, (left + up) >> 1, paeth])
    kinds = np.broadcast_to(np.asarray(row_filter, np.uint8), (h,))
    pred = preds[kinds, np.arange(h)]
    rows = np.concatenate([kinds[:, None], ((raw - pred) & 0xFF).astype(np.uint8)], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


def eval_images(seed: int = 3, n: int = EVAL_IMAGES, sizes=EVAL_SIZES) -> list:
    """n seeded noise BGR images, sizes taken from `sizes` in turn."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (*sizes[i % len(sizes)], 3), dtype=np.uint8)
            for i in range(n)]


def gt_boxes(rows: np.ndarray, h: int, w: int, rng) -> np.ndarray:
    """Two [x, y, w, h] int boxes for an image: its best-scoring detection row
    with an area (so that the dump has true positives) and a random box."""
    area = (rows[:, 2] - rows[:, 0]) * (rows[:, 3] - rows[:, 1])
    x1, y1, x2, y2 = rows[np.argmax(np.where(area > 4, rows[:, 4], -1.0)), :4]
    x1, y1 = int(np.clip(round(x1), 0, w - 2)), int(np.clip(round(y1), 0, h - 2))
    found = [x1, y1, max(1, min(int(round(x2)), w - 1) - x1),
             max(1, min(int(round(y2)), h - 1) - y1)]
    bw, bh = rng.randint(16, w // 3), rng.randint(16, h // 3)
    return np.array([found, [rng.randint(0, w - bw), rng.randint(0, h - bh), bw, bh]],
                    np.int32)


def write_eval_set(directory: pathlib.Path, images: list, boxes: list,
                   row_filters=(0, 1, 2)) -> str:
    """Write the images as PNGs (row filters taken in turn) and an anno file
    in gen_anno_file's format; return the anno file's path."""
    lines = []
    for i, (img, b) in enumerate(zip(images, boxes)):
        path = directory / f"eval_{i}.png"
        path.write_bytes(encode_png(img, row_filters[i % len(row_filters)]))
        lines.append(f"{path} {len(b)} {' '.join(str(int(v)) for v in b.reshape(-1))}")
    anno = directory / "gen_anno_file_eval"
    anno.write_text("\n".join(lines) + "\n")
    return str(anno)


def reference_dump(rows_list: list, anno: str) -> np.ndarray:
    """The eval dump of the rows of direct calls, one per anno record."""
    from fdt_torch.data.anno import parse_anno_file
    from fdt_torch.eval.pr import TfConfAccumulator

    acc = TfConfAccumulator()
    for rows, rec in zip(rows_list, parse_anno_file(anno)):
        acc.add(rows, rec.boxes_xywh)
    return acc.finalize()


def _post(url: str, body: bytes, timeout: float = 120):
    """(status, JSON payload) of one POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _http_burst(url: str, bodies: list) -> tuple[dict, list, float]:
    """POST every body from HTTP_CLIENTS threads: ({i: rows}, latencies s, wall s)."""
    results, latencies, errors = {}, [], []
    lock = threading.Lock()

    def client(ids):
        for i in ids:
            t = time.perf_counter()
            try:
                status, payload = _post(url, bodies[i])
                if status != 200:
                    raise AssertionError(f"status {status}: {payload}")
            except Exception as e:  # noqa: BLE001 — reported below
                with lock:
                    errors.append(e)
                return
            rows = np.asarray(payload["detections"], np.float32).reshape(-1, 5)
            with lock:
                latencies.append(time.perf_counter() - t)
                results[i] = rows

    n = len(bodies)
    threads = [threading.Thread(target=client, args=(range(k, n, HTTP_CLIENTS),))
               for k in range(HTTP_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    if errors or len(results) != n:
        raise AssertionError(f"http: {len(results)} answers, errors {errors[:1]}")
    return results, latencies, wall


def _rows_diff(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """(largest score, largest pixel difference) of each row of `got` to its
    nearest row of `want` (0, 0 when either is empty)."""
    if not len(got) or not len(want):
        return 0.0, 0.0
    d = np.abs(got[:, None, :4] - want[None, :, :4]).max(axis=2)
    j = d.argmin(axis=1)
    return (float(np.abs(got[:, 4] - want[j, 4]).max()),
            float(d[np.arange(len(got)), j].max()))


def _median_ms(fn, arg, reps: int):
    """(fn(arg), the median ms of `reps` calls)."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn(arg)
        times.append((time.perf_counter() - t) * 1e3)
    return out, float(np.median(times))


def photo_like(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded BGR image of gradients and mild noise, on which an encoder
    that picks each row's filter (Pillow's, libpng's) mixes them."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 0.4) % 256, (yy * 0.5) % 256, (xx + yy) * 0.2 % 256], -1)
    noise = np.random.RandomState(seed).randint(-6, 7, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def phase_http(det):
    """The bf16 flagship behind make_http_server: a fresh service's warmup(),
    then a burst of PNG bodies from 4 threads, twice, every answer against
    a direct detect_tensor call, K1 as k1_through_graphs counts; /healthz, 413, 400, 404,
    ?threshold= and a JPEG body; then the port's decoder and Pillow timed on
    the same PNG and JPEG bytes."""
    import http.client
    import io
    import zlib

    from PIL import Image
    import urllib.error
    import urllib.request

    from fdt_torch.apps.serving import DetectionService, make_http_server
    from fdt_torch.data import image_io
    from fdt_torch.data.image_io import imdecode
    from fdt_torch.infer.pyramidbox import detections_to_rows
    from fdt_torch.ops import nms as nms_op

    t0 = time.perf_counter()
    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
              for _ in range(HTTP_REQUESTS)]
    bodies = [encode_png(f) for f in frames]
    decode_s = []
    for body, frame in zip(bodies, frames):
        t = time.perf_counter()
        decoded = imdecode(body)
        decode_s.append(time.perf_counter() - t)
        if not np.array_equal(decoded, frame):
            raise AssertionError("http: a PNG body does not decode to its frame")

    def rows(d):
        r = detections_to_rows(d, HTTP_THRESHOLD, [SIZE] * 4)
        return r if r[:, :4].any() else np.empty((0, 5), np.float32)

    # batch 1 of each frame: shows how far the served answers move from it
    alone = [rows(det.detect_tensor(f[None], HTTP_THRESHOLD, 0.35)[0]) for f in frames]
    if sum(len(r) for r in alone) == 0:
        raise AssertionError("http: the direct calls found no rows to compare")
    index = {f.tobytes(): i for i, f in enumerate(frames)}
    recorder = _Recorder(det)
    svc = DetectionService("pyramidbox", recorder, frame_size=(SIZE, SIZE),
                           threshold=HTTP_THRESHOLD, nms_thresh=0.35, max_batch=BATCH,
                           max_wait_ms=20)
    # the server's own spans of a request: the body's decode and the
    # service's submit-to-result (batch window, detect, rows), in ms
    spans, spans_lock = {"decode": [], "service": []}, threading.Lock()

    def timed(name, fn):
        def span(*args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                with spans_lock:
                    spans[name].append((time.perf_counter() - t) * 1e3)
        return span

    decode = image_io.imdecode
    image_io.imdecode = timed("decode", decode)  # make_http_server binds it
    try:
        server = make_http_server(svc, port=0)
    finally:
        image_io.imdecode = decode
    svc.detect = timed("service", svc.detect)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        # a readiness probe, then warmup() on a service that has served
        # nothing: the first burst's p99 shows whether it left a batch size
        # cold.  (The probe takes the process's first HTTP exchange, about
        # 100 ms outside the service on the card, off the burst.)
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health.get("status") != "ok" or health.get("family") != "pyramidbox":
            raise AssertionError(f"http: /healthz said {health}")
        t = time.perf_counter()
        svc.warmup()
        warmup_s = time.perf_counter() - t
        runs = []
        for _ in range(2):
            recorder.calls.clear()
            for v in spans.values():
                v.clear()
            batches = svc.stats()["batches"]
            before = graph_counts()
            nms_op.launches.reset()
            results, latencies, wall = _http_burst(f"{url}/detect", bodies)
            launches, batches = nms_op.launches.count, svc.stats()["batches"] - batches
            if ((launches, batches) != k1_through_graphs(before)
                    or len(recorder.calls) != batches):
                raise AssertionError(f"http: {batches} batches, {launches} K1 launches")
            # the direct reference: detect_tensor again on each batch as served
            want, sizes = {}, []
            for images, _ in recorder.calls:
                sizes.append(len(images))
                for img, d in zip(images, det.detect_tensor(images, HTTP_THRESHOLD, 0.35)):
                    want[index[img.tobytes()]] = rows(d)
            if sorted(want) != list(range(HTTP_REQUESTS)):
                raise AssertionError(f"http: batches held requests {sorted(want)}")
            bad = [i for i in range(HTTP_REQUESTS)
                   if not _rows_agree(results[i], want[i], HTTP_THRESHOLD, 1e-4, 0.05)]
            if bad:
                raise AssertionError(f"http: answers differ from direct calls: {bad}")
            exact = sum(np.array_equal(results[i], want[i]) for i in range(HTTP_REQUESTS))
            drift = [max(_rows_diff(results[i], alone[i]), _rows_diff(alone[i], results[i]))
                     for i in range(HTTP_REQUESTS)]
            runs.append((results, sorted(latencies), wall, sizes, exact, drift,
                         {k: (float(np.median(v)), max(v)) for k, v in spans.items()}))
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health.get("requests") != 2 * HTTP_REQUESTS or health.get("batches") != sum(
                len(r[3]) for r in runs):
            raise AssertionError(f"http: /healthz counted {health} after the bursts")
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.putrequest("POST", "/detect")
        conn.putheader("Content-Length", str((64 << 20) + 1))
        conn.endheaders()  # no body follows: the limit is checked first
        too_big = conn.getresponse().status
        conn.close()
        garbage, _ = _post(f"{url}/detect", b"not an image")
        try:
            unknown = urllib.request.urlopen(f"{url}/nope", timeout=60).status
        except urllib.error.HTTPError as e:
            unknown = e.code
        if (too_big, garbage, unknown) != (413, 400, 404):
            raise AssertionError(f"http: 413/400/404 expected, got {too_big}/{garbage}/{unknown}")
        i = max(range(HTTP_REQUESTS), key=lambda k: len(runs[0][0][k]))
        full = runs[0][0][i]
        cut = float(np.median(full[:, 4]))
        status, payload = _post(f"{url}/detect?threshold={cut}", bodies[i])
        kept = np.asarray(payload["detections"], np.float32).reshape(-1, 5)
        if status != 200 or not 0 < len(kept) < len(full) or kept[:, 4].min() < cut:
            raise AssertionError(f"http: ?threshold={cut} kept {len(kept)} of {len(full)}")
        # a JPEG body (bench.py's serving cell POSTs JPEG) decodes through Pillow
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(frames[0][:, :, ::-1])).save(buf, "JPEG",
                                                                         quality=90)
        jpeg = buf.getvalue()
        recorder.calls.clear()
        before = graph_counts()
        nms_op.launches.reset()
        status, payload = _post(f"{url}/detect", jpeg)
        jpeg_launches = nms_op.launches.count
        if (status != 200 or len(recorder.calls) != 1
                or (jpeg_launches, 1) != k1_through_graphs(before)):
            raise AssertionError(f"http: a JPEG body gave {status}, "
                                 f"{len(recorder.calls)} batches, {jpeg_launches} K1 launches")
        (served, _), = recorder.calls
        if not np.array_equal(served, imdecode(jpeg)[None]):
            raise AssertionError("http: the JPEG body was served as another image")
        jpeg_want = rows(det.detect_tensor(served, HTTP_THRESHOLD, 0.35)[0])
        jpeg_got = np.asarray(payload["detections"], np.float32).reshape(-1, 5)
        if not _rows_agree(jpeg_got, jpeg_want, HTTP_THRESHOLD, 1e-4, 0.05):
            raise AssertionError("http: the JPEG body's answer differs from a direct call")
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    serving.join(30)
    if serving.is_alive() or svc.batcher._worker.is_alive():
        raise AssertionError("http: a server or worker thread outlived close()")
    for k, (results, lat, wall, sizes, exact, drift, split) in enumerate(runs):
        _phase("http" if k == 0 else "http_again", t0, requests=HTTP_REQUESTS,
               p50_ms=f"{lat[len(lat) // 2] * 1e3:.1f}", p99_ms=f"{lat[-1] * 1e3:.1f}",
               requests_per_s=f"{HTTP_REQUESTS / wall:.2f}",
               mean_batch=f"{np.mean(sizes):.2f}", batches=len(sizes), k1_launches=len(sizes),
               rows=sum(len(r) for r in results.values()), bit_equal_to_direct=exact,
               batch1_max_score_diff=f"{max(d[0] for d in drift):.3g}",
               batch1_max_px_diff=f"{max(d[1] for d in drift):.3g}",
               decode_ms=f"{np.mean(decode_s) * 1e3:.3f}",
               server_decode_ms=f"{split['decode'][0]:.2f}",
               server_decode_max_ms=f"{split['decode'][1]:.2f}",
               server_service_ms=f"{split['service'][0]:.2f}",
               server_service_max_ms=f"{split['service'][1]:.2f}",
               body_kb=f"{np.mean(list(map(len, bodies))) / 1e3:.1f}",
               threshold_kept=f"{len(kept)}/{len(full)}", warmup_s=f"{warmup_s:.3f}")
    # the port's decoder against Pillow on the same bytes: a body as served
    # (Up rows), a 640×480 PNG of Paeth rows, one written by Pillow (its
    # encoder picks each row's filter), and the JPEG body (Pillow alone)
    noise, photo = rng.randint(0, 256, (480, 640, 3), dtype=np.uint8), photo_like(480, 640, 7)
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(photo[:, :, ::-1])).save(buf, "PNG")
    cases = {"body": (bodies[0], frames[0]), "paeth": (encode_png(noise, 4), noise),
             "pillow_png": (buf.getvalue(), photo)}
    decode_ms = {}
    for name, (data, want) in cases.items():
        ours, decode_ms[name] = _median_ms(imdecode, data, 1 if name == "paeth" else 3)
        pil, decode_ms[f"{name}_pillow"] = _median_ms(image_io._decode_pillow, data, 5)
        if not (np.array_equal(ours, want) and np.array_equal(pil, want)):
            raise AssertionError(f"http: the {name} PNG decodes to another image")
    _, decode_ms["jpeg_pillow"] = _median_ms(imdecode, jpeg, 5)
    kinds = np.frombuffer(zlib.decompress(_png_idat(cases["pillow_png"][0])), np.uint8)
    mix = np.bincount(kinds.reshape(480, -1)[:, 0], minlength=5).tolist()
    _phase("http_decode", t0, **{f"{k}_ms": f"{v:.3f}" for k, v in decode_ms.items()},
           pillow_png_rows_none_sub_up_avg_paeth="/".join(map(str, mix)),
           jpeg_kb=f"{len(jpeg) / 1e3:.1f}", jpeg_k1_launches=jpeg_launches)
    return sum(len(r[3]) for r in runs) + jpeg_launches


def _png_idat(data: bytes) -> bytes:
    """The joined IDAT payloads of a PNG."""
    import struct

    out, pos = [], 8
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            out.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    return b"".join(out)


class _Recorder:
    """A detector whose detect_tensor calls are kept with their inputs and
    answers."""

    def __init__(self, det):
        self.det, self.device, self.calls = det, det.device, []

    def detect_tensor(self, images, **kw):
        out = self.det.detect_tensor(images, **kw)
        self.calls.append((images, out))
        return out


def phase_eval(det32, facebox_det, device):
    """WIDER eval on the card: eval_pyramidbox at native resolution against
    direct detect_face calls (dumps bit-equal, 2 shards merged bit-equal),
    the per-shape LRU past its bound, eval_pyramidbox_batched, eval_facebox
    and eval_mtcnn(bucketed=True), each dump against direct calls."""
    import tempfile

    from fdt_torch.data.anno import parse_anno_file
    from fdt_torch.eval.batched import bucket_for, eval_pyramidbox_batched
    from fdt_torch.eval.pr import merge_part_files
    from fdt_torch.eval.runner import eval_facebox, eval_mtcnn, eval_pyramidbox
    from fdt_torch.infer.pyramidbox import detections_to_rows
    from fdt_torch.ops import nms as nms_op

    launches = 0
    t0 = time.perf_counter()
    images = eval_images()
    n = len(images)
    want = [det32.detect_face(im, EVAL_THRESHOLD, nms_thresh=EVAL_NMS) for im in images]
    rng = np.random.RandomState(5)
    boxes = [gt_boxes(r, *im.shape[:2], rng) for r, im in zip(want, images)]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        anno = write_eval_set(tmp, images, boxes)
        if [r.boxes_xywh.tolist() for r in parse_anno_file(anno)] != [b.tolist() for b in boxes]:
            raise AssertionError("eval: the anno file does not read back")
        ref = reference_dump(want, anno)
        if not ((ref[0, :-1] == 1).any() and (ref[0, :-1] == 0).any()):
            raise AssertionError("eval: the reference dump lacks a TF flag")
        before = graph_counts()
        nms_op.launches.reset()
        t = time.perf_counter()
        dump = eval_pyramidbox(det32, anno, EVAL_THRESHOLD, str(tmp / "data_of_repo.npy"),
                               progress=False)
        native_s = time.perf_counter() - t
        native_launches = nms_op.launches.count
        launches += native_launches
        if (native_launches, n) != k1_through_graphs(before):
            raise AssertionError(f"eval: {native_launches} K1 launches for {n} images")
        if not np.array_equal(dump, ref) or not np.array_equal(np.load(tmp / "data_of_repo.npy"), ref):
            raise AssertionError("eval: the eval_pyramidbox dump differs from direct calls")
        for i in range(2):
            eval_pyramidbox(det32, anno, EVAL_THRESHOLD, str(tmp / "data_of_repo.npy"),
                            progress=False, process_index=i, process_count=2)
        merged = merge_part_files([str(tmp / f"data_of_repo.part{i}_of_2.npz") for i in range(2)])
        if not np.array_equal(merged, dump):
            raise AssertionError("eval: 2 merged shards differ from the unsharded dump")
        # the per-shape LRU past a bound lowered on the instance: one image of
        # each size, then a size the LRU dropped again (on the card its graph
        # replays; a replay keeps its size in the LRU only while it is there)
        det32._priors_max = EVAL_CACHE_BOUND
        try:
            sizes = len(EVAL_SIZES)
            for i in range(sizes):
                det32.detect_face(images[i], EVAL_THRESHOLD, nms_thresh=EVAL_NMS)
            held = len(det32._priors)
            evicted = [i for i in range(sizes) if images[i].shape[1::-1] not in det32._priors]
            again = [det32.detect_face(images[i], EVAL_THRESHOLD, nms_thresh=EVAL_NMS)
                     for i in evicted[:1]]
        finally:
            det32._priors_max = 64
        if held > EVAL_CACHE_BOUND or not evicted or not np.array_equal(again[0],
                                                                          want[evicted[0]]):
            raise AssertionError(f"eval: LRU held {held} > {EVAL_CACHE_BOUND}, evicted "
                                 f"{evicted}, or an evicted size's answer changed")
        _phase("eval_native", t0, images=n, sizes=len(EVAL_SIZES),
               images_per_s=f"{n / native_s:.2f}", k1_launches=native_launches,
               detections=dump.shape[1] - 1, true_positives=int(dump[0, :-1].sum()),
               gt=int(dump[1, -1]), lru_held=held, lru_bound=EVAL_CACHE_BOUND)

        t0 = time.perf_counter()
        rec = _Recorder(det32)
        before = graph_counts()
        nms_op.launches.reset()
        batched_s = []
        for _ in range(2):  # the first pass meets each chunk's shape for the first time
            rec.calls.clear()
            t = time.perf_counter()
            eval_pyramidbox_batched(rec, anno, EVAL_THRESHOLD, batch_size=EVAL_BATCH,
                                    progress=False)
            batched_s.append(time.perf_counter() - t)
        batched_launches = nms_op.launches.count
        launches += batched_launches
        if (batched_launches, 2 * len(rec.calls)) != k1_through_graphs(before):
            raise AssertionError(f"eval_batched: {batched_launches} K1 launches for "
                                 f"2 × {len(rec.calls)} chunks")
        # eval_pyramidbox_batched's order: buckets as first met, images in anno order
        bucket = [bucket_for(im.shape[1], im.shape[0]) for im in images]
        first = list(dict.fromkeys(bucket))
        order = sorted(range(n), key=lambda i: first.index(bucket[i]))
        got = [det for _, out in rec.calls for det in out]
        # an image at its bucket size rides a chunk of up to EVAL_BATCH where
        # the native path runs batch 1, and cuDNN sums another batch size in
        # another order: its rows are held to the native ones within the
        # tolerance _serve gives every answer of another batch size (1e-4 in
        # score, 0.05 px); the bit-equal ones are counted, not required
        at_size = exact = 0
        worst = (0.0, 0.0)
        for i, det in zip(order, got):
            h, w = images[i].shape[:2]
            if bucket_for(w, h) != (w, h):
                continue
            rows = detections_to_rows(det, EVAL_THRESHOLD, [w, h, w, h])
            at_size += 1
            exact += int(np.array_equal(rows, want[i]))
            if not _rows_agree(rows, want[i], EVAL_THRESHOLD, 1e-4, 0.05):
                raise AssertionError(f"eval_batched: image {i} at its bucket size "
                                     "differs from the native path")
            worst = tuple(map(max, worst, _rows_diff(rows, want[i])))
        _phase("eval_batched", t0, images=n, batch=EVAL_BATCH, chunks=len(rec.calls),
               images_per_s=f"{n / batched_s[1]:.2f}",
               images_per_s_first=f"{n / batched_s[0]:.2f}", k1_launches=batched_launches,
               at_bucket_size=at_size, bit_equal_to_native=exact,
               max_score_diff=f"{worst[0]:.3g}", max_px_diff=f"{worst[1]:.3g}")

        t0 = time.perf_counter()
        nms_op.launches.reset()
        t = time.perf_counter()
        dump = eval_facebox(facebox_det, anno, progress=False)
        facebox_s = time.perf_counter() - t
        facebox_launches = nms_op.launches.count
        launches += facebox_launches
        direct = []
        for im in images:
            b, s = facebox_det.detect(im)
            direct.append(np.column_stack([b, s]) if len(s) else np.empty((0, 5)))
        if facebox_launches != n or not np.array_equal(dump, reference_dump(direct, anno)):
            raise AssertionError(f"eval_facebox: {facebox_launches} K1 launches, or the "
                                 "dump differs from direct calls")
        _phase("eval_facebox", t0, images=n, images_per_s=f"{n / facebox_s:.2f}",
               k1_launches=facebox_launches, detections=dump.shape[1] - 1)

        t0 = time.perf_counter()
        cascade = mtcnn_cascade("sparse", device)
        nms_op.launches.reset()
        mtcnn_s, dumps = [], []
        for _ in range(2):  # the first pass meets each canvas shape for the first time
            cascade._start_tier.clear()  # each pass takes the same ladder decisions
            t = time.perf_counter()
            with warnings_kept() as caught:
                dumps.append(eval_mtcnn(cascade, anno, bucketed=True, progress=False))
            mtcnn_s.append(time.perf_counter() - t)
        dump = dumps[1]
        mtcnn_launches = nms_op.launches.count
        launches += mtcnn_launches
        cascade._start_tier.clear()
        direct = []
        with warnings_kept():
            for im in images:
                b, _ = cascade.detect_face_bucketed(im)
                direct.append(b if b.size else np.empty((0, 5)))
        if (not mtcnn_launches or not np.array_equal(dumps[0], dump)
                or not np.array_equal(dump, reference_dump(direct, anno))):
            raise AssertionError("eval_mtcnn: no K1 launch, or the dump differs from "
                                 "direct calls")
        _phase("eval_mtcnn", t0, images=n, images_per_s=f"{n / mtcnn_s[1]:.2f}",
               images_per_s_first=f"{n / mtcnn_s[0]:.2f}",
               k1_launches=mtcnn_launches, detections=dump.shape[1] - 1,
               saturated_warnings=len(caught))
    return launches


# --- this slice: MTCNN's host cascade and the video paths -----------------------------

def host_cascade(device):
    """The port's host MTCNNDetector on the "host" seeded nets."""
    from fdt_torch.infer import MTCNNDetector
    from fdt_torch.models import load_mtcnn_nets

    return MTCNNDetector(*load_mtcnn_nets(*mtcnn_variables("host")), device=device)


def mtcnn_host_frames() -> list:
    """The host golden's frames, checked against its digest."""
    g = np.load(MTCNN_HOST_GOLDEN)
    h, w = int(g["height"]), int(g["width"])
    images = [golden_frame(int(seed), h, w) for seed in g["frame_seeds"]]
    if hashlib.sha256(np.stack(images).tobytes()).hexdigest() != str(g["frame_sha256"]):
        raise AssertionError("the seeded frames differ from the MTCNN host golden's")
    return images


def check_mtcnn_host_golden(det, images) -> dict:
    """`det` (a host MTCNNDetector on the "host" nets) on the golden's frames
    against fdt's host cascade: rows matched within MTCNN_HOST_SCORE_TOL and
    MTCNN_HOST_PX_TOL, at most MTCNN_HOST_COUNT_DIFF left unmatched a frame
    (match_unordered).  Returns the counts and the largest differences."""
    g = np.load(MTCNN_HOST_GOLDEN)
    counts, errs = [], []
    for i, image in enumerate(images):
        boxes, lms = det.detect_face(image)
        c = int(g["counts"][i])
        counts.append(len(boxes))
        errs.append(match_unordered(boxes, lms, g["boxes"][i, :c], g["landmarks"][i, :c],
                                    MTCNN_HOST_SCORE_TOL, MTCNN_HOST_PX_TOL,
                                    MTCNN_HOST_COUNT_DIFF))
    return {"counts": counts, "golden_counts": g["counts"].tolist(),
            "score_err": max(e[0] for e in errs), "px_err": max(e[1] for e in errs),
            "unmatched": [e[2] for e in errs]}


def phase_mtcnn_host(device) -> int:
    """MTCNN's host cascade on the card (the nets there, crops and NMS on the
    host) on the "host" nets and the sparse golden's two 480×640 frames:
    against fdt's host cascade (the golden) and against the port's device
    cascade on the same frames (counts equal, MTCNN_HOST_* tolerances);
    images/s of both, and each stage's wall ms split into the card's kernel
    time and the rest, the host's.  Returns the device cascade's K1
    launches."""
    from fdt_torch.ops import nms as nms_op

    t0 = time.perf_counter()
    det = host_cascade(device)
    images = mtcnn_host_frames()
    golden = check_mtcnn_host_golden(det, images)
    cascade = mtcnn_cascade("host", device)
    nms_op.launches.reset()
    device_out = [cascade.detect_face(im) for im in images]  # the device cascade's path
    torch.cuda.synchronize()
    launches = nms_op.launches.count
    pair = [match_unordered(*det.detect_face(im), *out, MTCNN_HOST_SCORE_TOL,
                            MTCNN_HOST_PX_TOL) for im, out in zip(images, device_out)]
    if not launches:
        raise AssertionError("mtcnn_host: the device cascade launched no K1")
    n = len(images)
    host_rates = _frames_per_s(lambda: [det.detect_face(im) for im in images], n, 2)
    device_rates = _frames_per_s(lambda: [cascade.detect_face(im) for im in images], n, 2)
    image = images[0]
    _, p_align = det.detect_pnet(image)
    _, r_align = det.detect_rnet(image, p_align)
    stages = {"pnet": lambda: det.detect_pnet(image),
              "rnet": lambda: det.detect_rnet(image, p_align),
              "onet": lambda: det.detect_onet(image, r_align)}
    for name, fn in stages.items():
        split = _time_split(fn, iters=2)
        print(f"[mtcnn_host] {name} wall_ms={split['wall_ms']:.3f} "
              f"device_ms={split['device_ms']:.3f} "
              f"host_ms={split['wall_ms'] - split['device_ms']:.3f} "
              + " ".join(f"{k}_ms={v:.3f}" for k, v in sorted(
                  split["parts"].items(), key=lambda kv: -kv[1])), flush=True)
    _phase("mtcnn_host", t0, frames=n, size=f"{MTCNN_W}x{MTCNN_H}", counts=golden["counts"],
           golden_counts=golden["golden_counts"], unmatched=golden["unmatched"],
           golden_score_err=f"{golden['score_err']:.3g}",
           golden_px_err=f"{golden['px_err']:.3g}",
           device_counts=[len(b) for b, _ in device_out],
           device_score_err=f"{max(e[0] for e in pair):.3g}",
           device_px_err=f"{max(e[1] for e in pair):.3g}",
           host_images_per_s=f"{max(host_rates):.2f}",
           host_rates=[round(r, 2) for r in host_rates],
           device_images_per_s=f"{max(device_rates):.2f}",
           device_rates=[round(r, 2) for r in device_rates],
           pnet_candidates=len(p_align), rnet_candidates=len(r_align),
           device_k1_launches=launches, device_tier=cascade.last_tier)
    return launches


def write_frames(directory: pathlib.Path, frames) -> None:
    """Each BGR frame as <index, 6 digits>.png (encode_png, Up rows, zlib
    level 1)."""
    for i, frame in enumerate(frames):
        (directory / f"{i:06d}.png").write_bytes(encode_png(frame, level=1))


def _counts_zero() -> None:
    from fdt_torch.ops import nms as nms_op
    from fdt_torch.ops import track as track_op
    for counter in (nms_op.launches, nms_op.greedy_launches, track_op.launches,
                    track_op.global_launches):
        counter.reset()


def phase_video(device):
    """The video paths on the flagship in the tracker configuration of
    track_detector("trained"): VIDEO_FRAMES frames of the tracking phase's
    pan, written as PNGs and read back through read_frames (equal to those
    written), then fed to track_video
    (host tracker), track_video(device_tracker=True) and track_video_fused at
    each of VIDEO_BATCHES, each leg's tracks equal (same_tracks) to the
    tracking phase's unfused path on chunks of the same batch, at
    TRACK_CHECK and a floor that passes about TRACK_CHECK_ROWS rows a frame
    (so that the tracks are not empty); K1 calls and K3 launches counted on
    each leg (1 K1 call a batch; 1 K3 launch a batch on the device and fused
    legs); K1 on one batch's boxes against its plain version; frames/s of
    each leg.  Returns (decoded frames, the tracks, the detector, the floor,
    K1 launches, K3 launches by variant, K1's mask difference)."""
    import tempfile

    from fdt_torch.config import TRACKER
    from fdt_torch.data.frames import read_frames
    from fdt_torch.ops import nms as nms_op
    from fdt_torch.ops import track as track_op
    from fdt_torch.track import track_video, track_video_fused

    t0 = time.perf_counter()
    det = track_detector("trained", device)
    seq = pan_frames(bench_frame(TRACK_H, TRACK_W), VIDEO_FRAMES)
    chunks16 = [torch.from_numpy(seq[c:c + TRACK_BATCH]).to(device)
                for c in range(0, VIDEO_FRAMES, TRACK_BATCH)]
    floor = rows_floor(det, chunks16)
    cfg = dataclasses.replace(TRACKER, score_floor=floor, **TRACK_CHECK)
    # track_video detects at the detector's own thresholds: the floor and
    # TRACK_NMS, as the unfused path detects
    det.detect_cfg = dataclasses.replace(det.detect_cfg, conf_thresh=floor,
                                         nms_thresh=TRACK_NMS)
    k1_launches, k3_launches = 0, {"smem": 0, "global": 0}
    lines = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_frames(pathlib.Path(tmp), seq)
        t = time.perf_counter()
        frames = list(read_frames(tmp))
        read_s = time.perf_counter() - t
        if len(frames) != VIDEO_FRAMES or not all(map(np.array_equal, frames, seq)):
            raise AssertionError("video: the frames read back differ from those written")
        for b in VIDEO_BATCHES:
            chunks = [torch.from_numpy(seq[c:c + b]).to(device)
                      for c in range(0, VIDEO_FRAMES, b)]
            want, rows, _ = unfused_tracks(det, chunks, cfg, cap=None)
            legs = {"host": lambda it, b=b: track_video(it, det, cfg, batch_size=b),
                    "device": lambda it, b=b: track_video(it, det, cfg, batch_size=b,
                                                          device_tracker=True),
                    "fused": lambda it, b=b: track_video_fused(it, det, cfg, batch_size=b)}
            for leg, run in legs.items():
                run(frames[:b])  # first use of the batch's shapes
                _counts_zero()
                before = graph_counts()
                got = run(frames)  # the main path
                torch.cuda.synchronize()
                k1, k3 = nms_op.launches.count, track_op.launches.count
                k3g = track_op.global_launches.count
                graph_k1, graph_calls = k1_through_graphs(before)
                if (k1 != len(chunks) - graph_calls + graph_k1
                        or k3 + k3g != (0 if leg == "host" else len(chunks))
                        or nms_op.greedy_launches.count):
                    raise AssertionError(f"video {leg} batch {b}: {k1} K1 calls, {k3} + {k3g} "
                                         f"K3 launches for {len(chunks)} batches")
                if not got or not same_tracks(got, want):
                    raise AssertionError(f"video {leg} batch {b}: {len(got)} tracks != the "
                                         f"unfused path's {len(want)}")
                k1_launches += k1
                k3_launches["smem"] += k3
                k3_launches["global"] += k3g
                rates = _frames_per_s(lambda: run(frames), VIDEO_FRAMES, VIDEO_PASSES)
                lines[f"{leg}_{b}"] = (rates, k1, k3 + k3g, len(got))
        k1_check = check_k1_tracking(det, chunks16[0], cfg)
    _phase("video", t0, frames=VIDEO_FRAMES, size=f"{TRACK_W}x{TRACK_H}", floor=floor,
           read_frames_per_s=f"{VIDEO_FRAMES / read_s:.2f}", tracks=len(want),
           mean_rows=f"{np.mean([len(r) for r in rows]):.2f}",
           k1_check_valid=k1_check["valid"], k1_check_keeps=k1_check["keeps"],
           k1_check_mask_err=k1_check["err"],
           **{f"{name}_frames_per_s": f"{max(r):.2f}" for name, (r, _, _, _) in lines.items()},
           **{f"{name}_k1_k3": f"{k1}/{k3}" for name, (_, k1, k3, _) in lines.items()})
    for name, (rates, k1, k3, n) in lines.items():
        print(f"[video] {name} rates={[round(r, 2) for r in rates]} k1_calls={k1} "
              f"k3_launches={k3} tracks={n}", flush=True)
    return frames, want, det, floor, k1_launches, k3_launches, k1_check["err"]


def phase_video_render(frames, tracks) -> None:
    """render_tracks over the video phase's frames and tracks into a
    temporary directory (800 px wide, as fdt's default): the frame count,
    frames/s, and the first tracks' second boxes read back from their PNG
    frames with the track's colour on the box's top edge (the colours drawn
    from the same RandomState stream, hue modulo 256)."""
    import tempfile

    from fdt_torch.data.image_io import imread
    from fdt_torch.track.display import _track_colour, render_tracks

    t0 = time.perf_counter()
    seed, width = 0, 800
    with tempfile.TemporaryDirectory() as out:
        t = time.perf_counter()
        n = render_tracks(iter(frames), tracks, out_dir=out, dis_width=width,
                          rng=np.random.RandomState(seed))
        render_s = time.perf_counter() - t
        if n != len(frames) or len(list(pathlib.Path(out).glob("*.png"))) != n:
            raise AssertionError(f"video_render: {n} frames rendered of {len(frames)}")
        # the colour each track takes at its start frame, in render_tracks' order
        rng, colours = np.random.RandomState(seed), {}
        for frame_num in range(1, n + 1):
            for i, track in enumerate(tracks):
                if track["start_frame"] == frame_num:
                    colours[i] = _track_colour(rng.randint(0, 360))
        height = int(frames[0].shape[0] * width / frames[0].shape[1])
        ratio_w, ratio_h = width / 640, height / 480
        checked = 0
        for i, track in enumerate(tracks):
            if len(track["bboxes"]) < 2 or track["start_frame"] + 1 > n or checked == 5:
                continue
            x1, y1, x2, _ = track["bboxes"][1]
            y, xa, xb = int(ratio_h * y1), int(ratio_w * x1), int(ratio_w * x2)
            if not (0 <= y < height and 0 <= xa < xb < width):
                continue
            shown = imread(pathlib.Path(out) / f"{track['start_frame'] + 1:06d}.png")
            if not (shown[y, xa:xb + 1] == colours[i]).all(axis=1).any():
                raise AssertionError(f"video_render: track {i}'s box lacks its colour "
                                     f"{colours[i]}")
            checked += 1
    if not checked:
        raise AssertionError("video_render: no track's box to check")
    _phase("video_render", t0, frames=n, tracks=len(tracks), width=width,
           frames_per_s=f"{n / render_s:.2f}", boxes_checked=checked)


def phase_video_demo(det, floor, facebox_det, device, frames) -> int:
    """run_video through each family's demo over the first DEMO_FRAMES frames
    at 640×480: the flagship (track_detector("trained") at the video floor),
    FaceBoxes (seeded, 1024² input) and MTCNN's host and device cascades (the
    "host" nets): each frame's answer, recorded from the detector, equal to
    a direct call on that frame; the demo's average fps.  Returns the K1
    launches of the demos."""
    from fdt_torch.apps.video import facebox_demo, mtcnn_demo, pyramidbox_demo
    from fdt_torch.ops import nms as nms_op

    t0 = time.perf_counter()
    cascade = mtcnn_cascade("host", device)
    families = {"pyramid": (det, "detect_face", pyramidbox_demo, dict(threshold=floor)),
                "facebox": (facebox_det, "detect", facebox_demo, {}),
                "mtcnn_host": (host_cascade(device), "detect_face", mtcnn_demo, {}),
                "mtcnn_device": (cascade, "detect_face", mtcnn_demo, {})}
    launches, fields = 0, {}
    for name, (detector, method, demo, kw) in families.items():
        call, calls = getattr(detector, method), []

        def recorded(frame, *a, call=call, calls=calls, **k):
            out = call(frame, *a, **k)
            calls.append((frame, a, k, out))
            return out

        demo(detector, frames=iter(frames[:2]), **kw)  # first use of the frame shape
        cascade._start_tier.clear()  # the demo and the direct calls climb alike
        setattr(detector, method, recorded)
        try:
            before = graph_counts()
            nms_op.launches.reset()
            fps = demo(detector, frames=iter(frames[:DEMO_FRAMES]), **kw)  # the main path
            torch.cuda.synchronize()
            k1 = nms_op.launches.count
            replays = graph_counts()[2] - before[2]  # K1 ran inside the graph
        finally:
            delattr(detector, method)
        cascade._start_tier.clear()
        for frame, a, k, out in calls:
            want = call(frame, *a, **k)
            got, want = ((out, want) if isinstance(out, tuple) else ((out,), (want,)))
            if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"video_demo {name}: an answer differs from a direct call")
        if len(calls) != DEMO_FRAMES or (name != "mtcnn_host" and not (k1 or replays)):
            raise AssertionError(f"video_demo {name}: {len(calls)} frames, {k1} K1 launches")
        launches += k1
        fields[f"{name}_fps"] = f"{fps:.2f}"
        fields[f"{name}_k1"] = k1
        fields[f"{name}_rows"] = sum(len(out[0] if isinstance(out, tuple) else out)
                                     for *_, out in calls)
    _phase("video_demo", t0, frames=DEMO_FRAMES, **fields)
    return launches


def check_train_golden(trainer, g) -> dict:
    """TRAIN_STEPS steps of `trainer` (the flagship from repo_mini.npz,
    float32, "highest") on the golden's batch, held to fdt's golden: loss
    parts by TRAIN_LOSS_RTOL, each parameter leaf's change norm within
    TRAIN_NORM_RTOL of its own plus TRAIN_NORM_ATOL of the largest, and the
    batch_stats samples within TRAIN_STATS_RTOL (check_leaf_summary).
    Returns the errors."""
    from fdt_torch.models.loader import flat_variables, to_jax_variables

    def leaves(model):
        return flat_variables(to_jax_variables(model))

    batch = train_batch(int(g["seed"]), int(g["batch"]), int(g["size"]))
    if batch_sha256(batch) != str(g["batch_sha256"]):
        raise AssertionError("train: the seeded batch differs from the golden's")
    before = leaves(trainer.model)
    losses = []
    for _ in range(int(g["steps"])):
        m = trainer.train_step(*batch, float(g["lr"]))
        losses.append([float(m[k]) for k in g["parts"]])
    losses = np.array(losses)
    loss_err = np.abs(losses - g["losses"]) / np.abs(g["losses"])
    for step, rtol in enumerate(TRAIN_LOSS_RTOL):
        if loss_err[step].max() > rtol:
            raise AssertionError(f"train golden: step {step + 1} losses {losses[step]} against "
                                 f"{g['losses'][step]} (rtol {rtol})")
    tol = {"norm_rtol": TRAIN_NORM_RTOL, "norm_atol": TRAIN_NORM_ATOL, "stats": TRAIN_STATS_RTOL}
    errs = check_leaf_summary(train_leaf_summary(before, leaves(trainer.model)), g, "", tol,
                              "train golden")
    return {"loss_rel_err": loss_err.max(axis=1).tolist(), **errs}


def _train_step_ms(trainer, batch, lr: float, steps: int = 3) -> list[float]:
    """ms a step by CUDA events: three blocks of `steps` steps after a
    warm-up of WARMUP_S."""
    _warm(lambda: trainer.train_step(*batch, lr))
    return [_cuda_ms(lambda: trainer.train_step(*batch, lr), steps) for _ in range(3)]


def _peak_gb(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def _train_split(trainer, batch, lr: float, iters: int = 3) -> dict:
    """One train step by torch.profiler: device ms of its kernels by
    TRAIN_PARTS (the rest "elementwise"), the idle share of the wall time,
    and the device ms of the kernels launched inside the two MultiBox losses'
    forward (matching, the mining sorts, the loss math; a record_function
    range, part of the name classes above; their backward runs on autograd's
    thread and counts by name only)."""
    import re

    from torch.profiler import ProfilerActivity, profile, record_function

    import fdt_torch.train.loops as loops
    loss_fn = loops.multibox_loss

    def ranged_loss(*a, **k):
        with record_function("train.loss"):
            return loss_fn(*a, **k)

    trainer.train_step(*batch, lr)
    torch.cuda.synchronize()
    loops.multibox_loss = ranged_loss
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                trainer.train_step(*batch, lr)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / iters * 1e3
    finally:
        loops.multibox_loss = loss_fn
    parts, kernels = {}, {}
    events = prof.events()
    for evt in events:
        # the range's own annotation on the device's timeline is no kernel
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.name == "train.loss":
            continue
        ms = evt.time_range.elapsed_us() / iters / 1e3
        p = next((p for p, rx in TRAIN_PARTS if re.search(rx, evt.name)), "elementwise")
        parts[p] = parts.get(p, 0.0) + ms
        kernels[evt.name] = kernels.get(evt.name, 0.0) + ms

    def subtree_us(evt) -> float:
        return (sum(k.duration for k in evt.kernels)
                + sum(subtree_us(ch) for ch in evt.cpu_children))

    loss_ms = sum(subtree_us(e) for e in events if e.name == "train.loss") / iters / 1e3
    device_ms = sum(parts.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms, "parts": parts, "loss_fwd_ms": loss_ms,
            "idle_pct": 100 * (1 - device_ms / wall_ms) if parts else None,
            "top": sorted(kernels.items(), key=lambda kv: -kv[1])[:6]}


def write_train_set(directory: pathlib.Path, n: int = 8) -> pathlib.Path:
    """n seeded photo_like 480×640 images, JPEG and PNG in turns, 2-3 faces
    each (30-120 px), and their anno file; returns its path."""
    from PIL import Image
    rng = np.random.RandomState(7)
    lines = []
    for i in range(n):
        img = photo_like(480, 640, 40 + i)
        path = directory / f"train_{i}.{'jpg' if i % 2 else 'png'}"
        Image.fromarray(np.ascontiguousarray(img[:, :, ::-1])).save(path)
        faces = []
        for _ in range(2 + i % 2):
            side = int(rng.randint(30, 121))
            x, y = int(rng.randint(0, 640 - side)), int(rng.randint(0, 480 - side))
            faces += [x, y, side, int(side * 1.2) if y + side * 1.2 < 480 else side]
        lines.append(f"{path} {len(faces) // 4} " + " ".join(map(str, faces)))
    anno = directory / "anno.txt"
    anno.write_text("\n".join(lines) + "\n")
    return anno


def _cli_train(argv) -> dict:
    """python -m fdt_torch.cli.train_pyramid in this process: its output
    kept, its closing [train] line returned."""
    import io

    from fdt_torch.cli import train_pyramid
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_pyramid.main(argv)
    line = next(ln for ln in reversed(out.getvalue().splitlines()) if ln.startswith("[train] "))
    return json.loads(line[len("[train] "):])


def phase_train(device) -> int:
    """PyramidBox training on the card (fdt_torch.train): the flagship's
    steps held to fdt's golden; full-width steps timed (repo at 640², batch
    7: float32 with TF32, bf16, remat), remat's step against the plain one;
    the step's device split; a step of every mobile variant; the CLI driver
    over seeded image files, resumed from its checkpoint, and a detect of the
    trained weights.  Returns K1's launches on that detect."""
    import tempfile

    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models import PyramidBox, build_pyramidbox, load_pyramidbox
    from fdt_torch.models.loader import flat_variables, to_jax_variables
    from fdt_torch.ops import nms as nms_op
    from fdt_torch.train.loops import PyramidTrainer, xavier_init

    t0 = time.perf_counter()
    g = np.load(TRAIN_GOLDEN)
    weights = load_pyramidbox(str(WEIGHTS)).state_dict()

    def flagship(remat: bool = False):
        model = PyramidBox(remat=remat)
        model.load_state_dict(weights)
        return model

    with _tf32(True):  # the global flags on: precision="highest" turns TF32 off itself
        golden = check_train_golden(PyramidTrainer(flagship(), "repo", precision="highest",
                                                   device=device), g)
    _phase("train_golden", t0, steps=int(g["steps"]), batch=int(g["batch"]),
           loss_rel_err=[f"{e:.3g}" for e in golden["loss_rel_err"]],
           norm_err_of_scale=f"{golden['norm_err_of_scale']:.3g}",
           norm_rel_err_max=f"{golden['norm_rel_err_max']:.3g}",
           stats_rel_err=f"{golden['stats_rel_err']:.3g}")

    t0 = time.perf_counter()
    batch = train_batch(TRAIN_SEED + 1, TRAIN_BATCH)
    lr, results, first = TRAIN_LR, {}, {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                        ("remat", torch.float32)):
        trainer = PyramidTrainer(flagship(remat=name == "remat"), "repo", dtype=dtype,
                                 device=device)
        gb = _peak_gb(lambda: first.setdefault(name, (trainer.train_step(*batch, lr),
                                                      to_jax_variables(trainer.model))))
        ms = _train_step_ms(trainer, batch, lr)
        results[name] = {"ms": min(ms), "ms_blocks": [round(m, 3) for m in ms],
                         "images_per_s": TRAIN_BATCH / min(ms) * 1e3, "peak_gb": gb}
        if name == "f32":
            split = _train_split(trainer, batch, lr)
        if name == "bf16" and any(p.dtype != torch.float32 for p in trainer.model.parameters()):
            raise AssertionError("train bf16: a parameter is no longer float32")
        del trainer
        torch.cuda.empty_cache()
    f32_loss = float(first["f32"][0]["loss"])
    bf16_diff = abs(float(first["bf16"][0]["loss"]) - f32_loss) / f32_loss
    if not np.isfinite(f32_loss) or bf16_diff > TRAIN_BF16_RTOL:
        raise AssertionError(f"train bf16: first loss {float(first['bf16'][0]['loss'])} "
                             f"against float32 {f32_loss}")
    remat_err = {}
    for key in ("loss", "face_loc", "face_conf", "head_loc", "head_conf"):
        a, b = float(first["remat"][0][key]), float(first["f32"][0][key])
        if abs(a - b) > 1e-6 * abs(b) + 1e-7:
            raise AssertionError(f"train remat: {key} {a} against the plain step's {b}")
    remat_vars, plain_vars = (flat_variables(first[k][1]) for k in ("remat", "f32"))
    for col, rtol, atol in (("params", 1e-2, 1e-4), ("batch_stats", 1e-3, 1e-5)):
        remat_err[col] = 0.0
        for k, y in plain_vars.items():
            if k.startswith(col + "/"):
                d = np.abs(remat_vars[k] - y)
                if (d > atol + rtol * np.abs(y)).any():
                    raise AssertionError(f"train remat: {k} off the plain step's")
                remat_err[col] = max(remat_err[col], float(d.max()))
    for name, r in results.items():
        print(f"[train] step {name} batch={TRAIN_BATCH} size={SIZE} ms={r['ms']:.3f} "
              f"blocks={r['ms_blocks']} images_per_s={r['images_per_s']:.2f} "
              f"peak_gb={r['peak_gb']:.3f}", flush=True)
    print("[train] split f32 " + json.dumps({
        "wall_ms": round(split["wall_ms"], 3), "device_ms": round(split["device_ms"], 3),
        "idle_pct": None if split["idle_pct"] is None else round(split["idle_pct"], 2),
        "parts": {k: round(v, 3) for k, v in sorted(split["parts"].items())},
        "loss_fwd_ms": round(split["loss_fwd_ms"], 3),
        "top": [[n[:60], round(v, 3)] for n, v in split["top"]]}), flush=True)
    _phase("train_steps", t0, batch=TRAIN_BATCH, f32_ms=f"{results['f32']['ms']:.3f}",
           bf16_ms=f"{results['bf16']['ms']:.3f}", remat_ms=f"{results['remat']['ms']:.3f}",
           f32_peak_gb=f"{results['f32']['peak_gb']:.3f}",
           remat_peak_gb=f"{results['remat']['peak_gb']:.3f}",
           bf16_first_loss_rel_diff=f"{bf16_diff:.3g}",
           remat_params_max_abs=f"{remat_err['params']:.3g}",
           remat_stats_max_abs=f"{remat_err['batch_stats']:.3g}")

    t0 = time.perf_counter()
    small = train_batch(TRAIN_SEED + 2, 2)
    variant_ms = {}
    for variant in ("try1", "try2", "try3", "try4", "try5"):
        trainer = PyramidTrainer(xavier_init(build_pyramidbox(variant), 0), variant,
                                 device=device)
        trainer.train_step(*small, lr)  # first use of the shapes
        ms = _cuda_ms(lambda: trainer.train_step(*small, lr), 3)
        m = trainer.train_step(*small, lr)
        if not all(np.isfinite(float(v)) for v in m.values()):
            raise AssertionError(f"train {variant}: losses {m}")
        variant_ms[variant] = round(ms, 3)
    del trainer
    _phase("train_variants", t0, batch=2, size=SIZE, ms=variant_ms)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        anno = write_train_set(tmp)
        common = ["--net", "repo", "--batch_size", "2", "--lr", "1e-4", "--save_point", "5",
                  "--eval_freq", "5", "--annoPath", str(anno), "--evalAnnoPath", str(anno),
                  "--save_folder", str(tmp / "out"), "--max_gt", "4"]
        first_run = _cli_train(common + ["--iter", "5"])
        resumed = _cli_train(common + ["--iter", "10", "--start_iter", "5",
                                       "--resume", str(tmp / "out" / "repo_pyramid_5")])
        if (first_run["step"], resumed["iterations"], resumed["step"]) != (5, 5, 10):
            raise AssertionError(f"train cli: steps {first_run} then {resumed}")
        for f in ("repo_pyramid_loss_5.npy", "repo_pyramid_eval_loss_10.npy",
                  "repo_pyramid_10/variables.npz", "repo_pyramid_10/opt_state.npz"):
            if not (tmp / "out" / f).exists():
                raise AssertionError(f"train cli: {f} was not written")
        det = PyramidBoxDetector(load_pyramidbox(str(tmp / "out" / "repo_pyramid_10" /
                                                     "variables.npz")), device=device)
        frame = photo_like(480, 640, 40)[None]
        det.detect_tensor(frame, conf_thresh=0.01, nms_thresh=0.35)  # first use of the shape
        before = graph_counts()
        nms_op.launches.reset()
        out = det.detect_tensor(frame, conf_thresh=0.01, nms_thresh=0.35)  # the main path
        k1 = nms_op.launches.count
    if ((k1, 1) != k1_through_graphs(before) or not np.isfinite(out).all()
            or out.shape != (1, 2, 750, 5)):
        raise AssertionError(f"train cli: the trained detector gave {out.shape}, {k1} K1 calls")
    _phase("train_cli", t0, iterations=first_run["iterations"] + resumed["iterations"],
           batch=2, augment_images_per_s=resumed["augment_images_per_s"],
           wait_share=resumed["wait_share"], images_per_s=resumed["images_per_s"],
           first_wait_share=first_run["wait_share"], k1_launches=k1,
           detections=int((out[0, 1, :, 0] > 0).sum()))
    return k1


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi failed: {smi.stderr.strip()}"


def drawn_faces(n: int, seed: int, h: int = 240, w: int = 320) -> list:
    """n seeded h×w photo_like BGR images, each with 1-2 drawn faces (a skin
    block of 48-90 px with dark eyes and a mouth), and their boxes as
    inclusive corners (x1, y1, x2, y2)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        img = photo_like(h, w, seed + i).astype(np.int32)
        boxes = []
        for j in range(1 + i % 2):
            side = int(rng.randint(48, 91))
            x = int(rng.randint(0, w - side)) if j == 0 else (x + side + 8) % (w - side)
            y = int(rng.randint(0, h - side))
            face = img[y:y + side, x:x + side]
            face[:] = np.array([110, 150, 205]) + rng.randint(-8, 9, face.shape)
            e, r = side // 4, max(side // 10, 2)
            for ex in (e, side - e):
                face[side * 2 // 5 - r:side * 2 // 5 + r, ex - r:ex + r] = 30
            face[side * 3 // 4 - r // 2:side * 3 // 4 + r // 2 + 1, side // 3:side * 2 // 3] = 60
            boxes.append((x, y, x + side - 1, y + side - 1))
        out.append((np.clip(img, 0, 255).astype(np.uint8), boxes))
    return out


def write_mtcnn_set(directory: pathlib.Path, n: int = 8, seed: int = 11) -> pathlib.Path:
    """The drawn_faces images as PNGs and their anno file in the MTCNN
    factory's format (`<path> x1 y1 x2 y2 ...`, inclusive corners); returns
    its path."""
    from fdt_torch.data.image_io import imwrite
    lines = []
    for i, (img, boxes) in enumerate(drawn_faces(n, seed)):
        path = directory / f"mtcnn_{i}.png"
        imwrite(str(path), img)
        lines.append(f"{path} " + " ".join(f"{v}" for b in boxes for v in b))
    anno = directory / "mtcnn_anno.txt"
    anno.write_text("\n".join(lines) + "\n")
    return anno


def write_face_val_set(directory: pathlib.Path, n: int = 6, seed: int = 21) -> pathlib.Path:
    """The drawn_faces images as PNGs and their anno file in gen_anno_file's
    format (`<path> <N> x y w h ...`): a val set for select_checkpoint."""
    from fdt_torch.data.image_io import imwrite
    lines = []
    for i, (img, boxes) in enumerate(drawn_faces(n, seed)):
        path = directory / f"val_{i}.png"
        imwrite(str(path), img)
        cells = [v for x1, y1, x2, y2 in boxes for v in (x1, y1, x2 - x1 + 1, y2 - y1 + 1)]
        lines.append(f"{path} {len(boxes)} " + " ".join(map(str, cells)))
    anno = directory / "gen_anno_file_val"
    anno.write_text("\n".join(lines) + "\n")
    return anno


def mtcnn_chain(directory: pathlib.Path, anno: pathlib.Path, device: str,
                batch_size: int = 16) -> dict:
    """The MTCNN training chain through the CLIs, each run's main in this
    process: gen_mtcnn_data pnet, assemble, train_mtcnn pnet (one epoch),
    gen_mtcnn_data rnet with that PNet, assemble, train_mtcnn rnet (one
    epoch).  Returns the patch counts by stage and the two checkpoints."""
    import importlib

    def run(module, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            importlib.import_module(f"fdt_torch.cli.{module}").main(argv)
        return out.getvalue()

    out: dict = {}
    ckpt = {}
    for stage, size in (("pnet", 12), ("rnet", 24)):
        data = directory / f"data_{size}"
        gen = [stage, "--anno", str(anno), "--out", str(data), "--device", device]
        if stage == "rnet":
            gen += ["--pnet_ckpt", ckpt["pnet"]]
        counts = run("gen_mtcnn_data", gen).strip().splitlines()[-1]
        out[stage] = dict(zip(("pos", "neg", "part"), map(int, counts.split()[1::2])))
        lists = [str(data / "anno_store" / f"{k}_{size}.txt") for k in ("pos", "neg", "part")]
        imglist = directory / f"imglist_{size}.txt"
        run("gen_mtcnn_data", ["assemble", "--out", str(imglist), "--files", *lists])
        store = directory / "store"
        run("train_mtcnn", [stage, "--anno", str(imglist), "--epochs", "1",
                            "--batch_size", str(batch_size), "--store", str(store),
                            "--device", device])
        ckpt[stage] = str(store / f"{stage}_epoch_1")
        if not (pathlib.Path(ckpt[stage]) / "variables.npz").exists():
            raise AssertionError(f"mtcnn chain: {ckpt[stage]} was not written")
    out["checkpoints"] = ckpt
    return out


def _step_times(fn, steps: int = 7) -> list[float]:
    """ms of single steps by CUDA events after a warm-up of 1 s, sorted."""
    _warm(fn, 1.0)
    return sorted(_cuda_ms(fn, 1) for _ in range(steps))


def _timed_step(name: str, fn, batch: int, size: int, card: str) -> dict:
    """A family's full-width step: peak memory of its first call, the median
    of single steps, images/s, and a torch.profiler split (device ms, idle
    share of the wall time); one [train_families] line."""
    gb = _peak_gb(fn)
    ms = _step_times(fn)
    split = _time_split(fn, iters=3)
    med = float(np.median(ms))
    out = {"ms_median": med, "ms_min": ms[0], "ms_max": ms[-1],
           "images_per_s": batch / med * 1e3, "peak_gb": gb,
           "device_ms": split["device_ms"], "wall_ms": split["wall_ms"],
           "idle_pct": split["idle_pct"]}
    print(f"[train_families] step {name} batch={batch} size={size} "
          f"ms_median={med:.3f} ms={[round(m, 3) for m in ms]} "
          f"images_per_s={out['images_per_s']:.2f} peak_gb={gb:.3f} "
          f"profiled_wall_ms={split['wall_ms']:.3f} device_ms={split['device_ms']:.3f} "
          f"idle_pct={None if split['idle_pct'] is None else round(split['idle_pct'], 2)} "
          f"card=\"{card}\"", flush=True)
    return out


def phase_train_families(device) -> int:
    """FaceBoxes, net2net and MTCNN training on the card: each family's steps
    held to fdt's golden (net2net every mode, MTCNN every stage); the timed
    full-width steps (FaceBoxes 1024² batch 16, net2net intermedia 640²
    batch 8, each MTCNN stage batch 512: median ms by CUDA events, images/s,
    peak memory, device ms and idle share); the CLIs on seeded image files:
    train_facebox, resumed, and a FaceBoxes detect of its weights (K1);
    train_net2net; the MTCNN chain (mtcnn_chain), then the device cascade on
    the trained nets (K1).  Returns K1's launches on those two detects."""
    import dataclasses as dc
    import tempfile

    from fdt_torch.config import FACEBOX
    from fdt_torch.infer import FaceBoxDetector, MTCNNDeviceCascade
    from fdt_torch.models import FaceBox, ONet, PNet, RNet, build_pyramidbox, load_pyramidbox
    from fdt_torch.models import from_jax_variables
    from fdt_torch.ops import nms as nms_op
    from fdt_torch.train.checkpoint import load_model_weights
    from fdt_torch.train.facebox_train import FaceBoxTrainer
    from fdt_torch.train.loops import xavier_init
    from fdt_torch.train.mtcnn_train import MTCNNStageTrainer, lecun_init
    from fdt_torch.train.net2net import Net2NetTrainer

    card = card_line()
    t0 = time.perf_counter()
    errs = {}

    def report(key, e):
        errs[key] = e
        print(f"[train_families] golden {key} " + json.dumps(
            {k: ([x if isinstance(x, str) else float(f"{x:.3g}") for x in v]
                 if isinstance(v, list) else float(f"{v:.3g}")) for k, v in e.items()}),
            flush=True)

    with _tf32(True):  # the global flags on: precision="highest" turns TF32 off itself
        g = dict(np.load(FACEBOX_TRAIN_GOLDEN))
        model = FaceBox()
        model.load_state_dict(from_jax_variables(seeded_variables(model, FACEBOX_WEIGHTS_SEED)))
        report("facebox", check_family_golden(
            "facebox", "", FaceBoxTrainer(model, precision="highest", device=device), g))
        g = dict(np.load(NET2NET_TRAIN_GOLDEN))
        teacher = load_pyramidbox(str(WEIGHTS))
        for mode in NET2NET_MODES:
            student = load_pyramidbox(str(NET2NET_STUDENT), "try1")
            report(mode, check_family_golden("net2net", mode, Net2NetTrainer(
                student, teacher, mode, precision="highest", device=device), g))
        g = dict(np.load(MTCNN_TRAIN_GOLDEN))
        for stage, net in zip(MTCNN_STAGES, (PNet, RNet, ONet)):
            model = net()
            model.load_state_dict(from_jax_variables(
                seeded_variables(model, MTCNN_TRAIN_WEIGHTS_SEED), model.flatten_chw))
            report(stage, check_family_golden("mtcnn", stage, MTCNNStageTrainer(
                stage, MTCNN_TRAIN_LR, "highest", model=model, device=device), g))
    _phase("train_families_golden", t0, checks=len(errs),
           loss_rel_err_max=f"{max(max(e['loss_rel_err']) for e in errs.values()):.3g}")

    t0 = time.perf_counter()
    timed = {}
    fb = FaceBoxTrainer(xavier_init(FaceBox(), 0), device=device)  # "default": TF32, the CLI's
    batch = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in
             facebox_train_batch(FACEBOX_TRAIN_SEED + 1, FACEBOX_TRAIN_BATCH)]
    timed["facebox"] = _timed_step("facebox", lambda: fb.train_step(*batch, FACEBOX_TRAIN_LR),
                                   FACEBOX_TRAIN_BATCH, FACEBOX.input_size, card)
    del fb, batch
    n2n = Net2NetTrainer(xavier_init(build_pyramidbox("try1"), 0), teacher, "intermedia",
                         device=device)
    images = torch.from_numpy(net2net_batch(NET2NET_TRAIN_SEED + 1, NET2NET_TRAIN_BATCH)[0]
                              ).to(device)
    lr = NET2NET_TRAIN_LR["intermedia"]
    timed["net2net"] = _timed_step("net2net_intermedia", lambda: n2n.train_step(images, lr),
                                   NET2NET_TRAIN_BATCH, SIZE, card)
    del n2n, images, teacher
    for stage in MTCNN_STAGES:
        trainer = MTCNNStageTrainer(stage, device=device)
        staged = [torch.from_numpy(a).to(device) for a in
                  mtcnn_train_batch(stage, MTCNN_TRAIN_SEED + 1, MTCNN_TRAIN_BATCH)]
        timed[stage] = _timed_step(f"mtcnn_{stage}", lambda: trainer.train_step(*staged),
                                   MTCNN_TRAIN_BATCH, trainer.size, card)
    torch.cuda.empty_cache()
    _phase("train_families_steps", t0, **{f"{k}_ms": f"{v['ms_median']:.3f}"
                                          for k, v in timed.items()})

    t0 = time.perf_counter()
    dev = f"cuda:{device.index or 0}"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        anno = write_train_set(tmp)
        from fdt_torch.cli import train_facebox, train_net2net
        fb_out = tmp / "facebox"
        common = ["--batch_size", "2", "--save_point", "2", "--annoPath", str(anno),
                  "--save_folder", str(fb_out), "--device", dev]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_facebox.main(common + ["--iter", "4"])
            train_facebox.main(common + ["--iter", "6", "--resume"])
        if f"resumed from {fb_out / 'facebox_4'}" not in buf.getvalue():
            raise AssertionError(f"train_facebox: no resume from facebox_4: {buf.getvalue()}")
        with np.load(fb_out / "facebox_6" / "opt_state.npz") as z:
            if int(z["step"]) != 6:
                raise AssertionError(f"train_facebox: step {int(z['step'])} after the resume")
        det = FaceBoxDetector(load_model_weights(str(fb_out / "facebox_6"), FaceBox()),
                              cfg=dc.replace(FACEBOX, conf_thresh=0.01), device=device)
        frame = torch.from_numpy(photo_like(1024, 1024, 41)[None]).to(device)
        det.detect_device(frame)  # first use of the shape
        nms_op.launches.reset()
        boxes, scores, count = det.detect_device(frame)  # the trained weights' detect
        torch.cuda.synchronize()
        fb_k1 = nms_op.launches.count
        if fb_k1 != 1 or not torch.isfinite(boxes).all():
            raise AssertionError(f"train_facebox: the trained detector made {fb_k1} K1 calls")
        n2n_out = tmp / "net2net"
        with contextlib.redirect_stdout(io.StringIO()):
            train_net2net.main(["--iter", "3", "--batch_size", "2", "--save_point", "2",
                                "--annoPath", str(anno), "--save_folder", str(n2n_out),
                                "--teacher_weights", str(WEIGHTS), "--device", dev])
        for f in ("intermedia_net_2/variables.npz", "intermedia_loss_2.npy",
                  "intermedia_net_final_3/opt_state.npz"):
            if not (n2n_out / f).exists():
                raise AssertionError(f"train_net2net: {f} was not written")
        losses = np.load(n2n_out / "intermedia_loss_2.npy")
        if not (np.isfinite(losses).all() and (losses[:2] > 0).all()):
            raise AssertionError(f"train_net2net: losses {losses[:3]}")
        t_fb = time.perf_counter() - t0

        t1 = time.perf_counter()
        mtcnn_anno = write_mtcnn_set(tmp)
        chain = mtcnn_chain(tmp / "mtcnn", mtcnn_anno, dev)
        if not chain["rnet"]["neg"] + chain["rnet"]["pos"] + chain["rnet"]["part"]:
            raise AssertionError(f"mtcnn chain: the trained PNet mined nothing: {chain}")
        nets = (load_model_weights(chain["checkpoints"]["pnet"], PNet()),
                load_model_weights(chain["checkpoints"]["rnet"], RNet()), lecun_init(ONet()))
        cascade = MTCNNDeviceCascade(*nets, device=device)
        from fdt_torch.data.image_io import imread
        frames = np.stack([imread(ln.split()[0]) for ln in
                           mtcnn_anno.read_text().splitlines()[:4]])
        cascade.detect_batch(frames)  # first use of the shapes
        nms_op.launches.reset()
        _, _, mt_count, _ = cascade.detect_batch(frames)  # the trained nets' cascade
        mt_k1 = nms_op.launches.count
        if not mt_k1:
            raise AssertionError("mtcnn chain: the device cascade launched no K1")
    _phase("train_families_cli", t0, facebox_net2net_s=f"{t_fb:.3f}",
           mtcnn_chain_s=f"{time.perf_counter() - t1:.3f}", facebox_k1=fb_k1,
           facebox_detections=int(count[0]), mtcnn_patches=json.dumps(
               {k: v for k, v in chain.items() if k != "checkpoints"}).replace(" ", ""),
           mtcnn_k1=mt_k1, mtcnn_tier=cascade.last_tier, mtcnn_faces=mt_count.tolist())
    return fb_k1 + mt_k1


# ---- weight interop, checkpoint tooling and Inception-ResNet-v2 ----
TRY3_WEIGHTS = REPO / "net_weight" / "try3_mini.npz"
# train_chained's journal run: try3's journal scaled so that its two phases
# end at 4 and 6 (round(18000·s), round(24000·s)); chunks of 2 iterations from
# iteration 2 make two chunk processes, one a phase, at 640², batch 2
CHAIN_SCALE, CHAIN_START, CHAIN_CHUNK, CHAIN_BATCH = 2.4e-4, 2, 2, 2
# the chunks' checkpoint directories (not the loss files training writes
# beside them, try3_pyramid_loss_<it>.npy)
CHECKPOINTS = "try3_pyramid_[0-9]*"
SELECT_VAL_IMAGES = 6
SELECT_AP_TOL = 1e-3  # the card's APs against the CPU's, same files
INCEPTION_SEED, INCEPTION_SIZE, INCEPTION_BATCH, INCEPTION_CPU_BATCH = 0, 299, 8, 2
# the card's float32 ("highest", TF32 off) logits against the CPU's, as a
# share of the logits' largest magnitude: 39 residual blocks of float32 sums
# in cuDNN's and the CPU's orders (my CPU float32 forward is ~1e-6 of scale
# from a float64 one on the reduced towers)
INCEPTION_TOL = 1e-3
# the logits of two images must differ by this share of the scale: an
# untrained net whose BatchNorm statistics are not its data's washes the
# image out (fdt's test's random statistics: 3.7e-5 of the scale apart)
INCEPTION_SPREAD_MIN = 1e-2


def seeded_inception(repeats=(10, 20, 9), seed: int = INCEPTION_SEED) -> torch.nn.Module:
    """Inception-ResNet-v2 in eval mode on the CPU: torch's initialisation
    under `seed`, the BatchNorm affine parameters randomised as fdt's test
    does (tests/test_inception_resnet_v2.py:17-30), and the running
    statistics those of a seeded calibration batch of two 299² images (one
    train-mode forward at momentum 1; the model's own momentum 0 restored)."""
    from fdt_torch.models import InceptionResnetV2
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        model = InceptionResnetV2(repeats=repeats)
    g = torch.Generator().manual_seed(seed)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for m in bns:
            m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
            m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
            m.momentum = 1.0
        model.train()(torch.rand(2, 3, INCEPTION_SIZE, INCEPTION_SIZE, generator=g))
    for m in bns:
        m.momentum = 0.0
    return model.eval()


def inception_images(n: int, seed: int = INCEPTION_SEED + 1) -> torch.Tensor:
    """n seeded [3, 299, 299] float32 images in [0, 1)."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, 3, INCEPTION_SIZE, INCEPTION_SIZE, generator=g)


def inception_spread(logits: torch.Tensor) -> float:
    """The largest difference of two images' logits over the logits' scale."""
    scale = float(logits.abs().max())
    return float((logits[1:] - logits[:1]).abs().max()) / scale if scale else 0.0


def check_inception(got: torch.Tensor, want: torch.Tensor) -> dict:
    """`got` (the card's) against `want` (the CPU's) on the same images:
    finite, not washed out, within INCEPTION_TOL of the scale."""
    got, want = got.float().cpu(), want.float().cpu()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("inception: logits are not finite")
    spread = inception_spread(want)
    if spread < INCEPTION_SPREAD_MIN:
        raise AssertionError(f"inception: the logits hardly depend on the image "
                             f"(spread {spread:.3g} of scale)")
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    if err > INCEPTION_TOL:
        raise AssertionError(f"inception: {err:.3g} of scale from the CPU's logits")
    return {"rel_err": err, "scale": scale, "spread": spread}


def same_state(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    """Every parameter and running statistic of the two models equal (on the
    CPU); num_batches_tracked, which no weight file carries, aside."""
    sa, sb = ({k: v for k, v in m.state_dict().items() if not k.endswith("num_batches_tracked")}
              for m in (a, b))
    return sa.keys() == sb.keys() and all(torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa)


def _k1_during(fn):
    """(fn()'s result, K1's launches during it), the card synchronised."""
    from fdt_torch.ops import nms as nms_op
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    nms_op.launches.reset()
    out = fn()
    sync()
    return out, nms_op.launches.count


def phase_interop(device) -> int:
    """Reference `.pth`/`.pt` weights on the card, each against its npz:
    the flagship (repo_mini.npz through save_variables_pth's tree path,
    fdt's flax_to_torch rules) at 640², batch 8, float32 "highest";
    FaceBoxes (seeded, strict) at 1024², batch 2; the device cascade from
    three .pt files of the sparse setting's seeded nets on the MTCNN
    golden's frames.  Every output bit-equal; then a .pth the port writes
    from the card model reloads bit-equal.  Returns K1's launches."""
    import tempfile

    from fdt_torch.config import FACEBOX
    from fdt_torch.infer import FAST_BUDGETS, MID_BUDGETS
    from fdt_torch.models import (FaceBox, ONet, PNet, RNet, from_jax_variables,
                                  load_facebox_detector, load_mtcnn_cascade, load_npz,
                                  load_pyramidbox, load_pyramidbox_detector,
                                  load_weights_file, save_variables_pth)
    from fdt_torch.models.loader import save_variables_npz, to_jax_variables

    t0 = time.perf_counter()
    launches = 0
    with tempfile.TemporaryDirectory() as tmp, _tf32(True):
        tmp = pathlib.Path(tmp)
        pth = str(tmp / "repo.pth")
        save_variables_pth(load_npz(str(WEIGHTS)), pth)
        frames = torch.from_numpy(flagship_batch()).to(device)
        dets = [load_pyramidbox_detector("repo", w, device=device) for w in (str(WEIGHTS), pth)]
        for det in dets:
            det.detect_device(frames, conf_thresh=0.05)  # first use of the shape
        outs = []
        for det in dets:
            out, k1 = _k1_during(lambda d=det: d.detect_device(frames, conf_thresh=0.05))
            outs.append(out)
            launches += k1
        if not torch.equal(outs[0], outs[1]) or not (outs[0][:, 1, :, 0] > 0.05).any():
            raise AssertionError("interop: the .pth flagship's rows are not the npz's")
        flagship_rows = int((outs[0][:, 1, :, 0] > 0.05).sum())
        again = str(tmp / "again.pth")
        save_variables_pth(dets[1].model, again)  # written from the card model
        if not same_state(load_pyramidbox(again), dets[1].model):
            raise AssertionError("interop: the card model's .pth does not reload bit-equal")
        del dets, outs

        fb = FaceBox()
        fb.load_state_dict(from_jax_variables(seeded_variables(fb, FACEBOX_WEIGHTS_SEED)))
        fb_npz, fb_pth = str(tmp / "facebox.npz"), str(tmp / "facebox.pth")
        save_variables_npz(to_jax_variables(fb), fb_npz)
        save_variables_pth(load_weights_file(FaceBox(), fb_npz), fb_pth)
        fb_frames = torch.from_numpy(np.random.RandomState(2).randint(
            0, 256, (2, FACEBOX.input_size, FACEBOX.input_size, 3), np.uint8)).to(device)
        fb_out = []
        for w in (fb_npz, fb_pth):
            det = load_facebox_detector(w, device=device)
            det.detect_device(fb_frames)
            out, k1 = _k1_during(lambda d=det: d.detect_device(fb_frames))
            fb_out.append(out)
            launches += k1
        if not all(torch.equal(a, b) for a, b in zip(*fb_out)):
            raise AssertionError("interop: the .pth FaceBoxes detects differ from the npz's")

        npz_paths, pt_paths = [], []
        for name, net, variables in zip(("pnet", "rnet", "onet"), (PNet, RNet, ONet),
                                        mtcnn_variables("sparse")):
            npz_paths.append(str(tmp / f"{name}.npz"))
            pt_paths.append(str(tmp / f"{name}_epoch.pt"))
            save_variables_npz(variables, npz_paths[-1])
            save_variables_pth(load_weights_file(net(), npz_paths[-1]), pt_paths[-1])
        g = np.load(MTCNN_GOLDEN)
        images = np.stack([golden_frame(int(s), int(g["height"]), int(g["width"]))
                           for s in g["frame_seeds"]])
        mt_out = []
        for paths in (npz_paths, pt_paths):
            cascade = load_mtcnn_cascade(*paths, device=device,
                                         fast_budgets=(FAST_BUDGETS, MID_BUDGETS))
            cascade.detect_batch(images)
            out, k1 = _k1_during(lambda c=cascade: c.detect_batch(images))
            mt_out.append(out)
            launches += k1
        if not all(np.array_equal(a, b) for a, b in zip(*mt_out)) or not mt_out[0][2].any():
            raise AssertionError("interop: the .pt cascade's detections differ from the npz's")
    _phase("interop", t0, flagship_rows=flagship_rows, facebox_boxes=int(fb_out[0][2].sum()),
           mtcnn_counts=mt_out[0][2].tolist(), k1=launches)
    return launches


def _timed_chunks(argv, device: str) -> list:
    """train_chained.main(argv) with each chunk process timed: [(wall s,
    the chunk's own [train] line)], the chunks' output kept off this
    script's (its tail printed if a chunk fails)."""
    from fdt_torch.cli import train_chained
    chunks = []

    def call(cmd):
        t0 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        train = [ln for ln in run.stdout.splitlines() if ln.startswith("[train] ")]
        if run.returncode or not train:
            print(run.stdout[-4000:], run.stderr[-4000:], sep="\n", file=sys.stderr)
            raise AssertionError(f"train_chained: a chunk exited {run.returncode}")
        chunks.append((time.perf_counter() - t0, json.loads(train[-1][len("[train] "):])))
        return run.returncode

    real = train_chained.run_chunk
    train_chained.run_chunk = lambda cmd, retries, label="", resume=None: real(
        cmd, retries, label, resume, call=call)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = train_chained.main(argv)
    finally:
        train_chained.run_chunk = real
    if rc:
        raise AssertionError(f"train_chained exited {rc}")
    return chunks


def phase_tooling(device) -> int:
    """The checkpoint tools on the card: train_chained replays try3's
    journal (scaled: two phases, two chunk processes of 2 iterations at
    640², batch 2, from net_weight/try3_mini.npz), every chunk's checkpoint
    written; select_checkpoint over them on SELECT_VAL_IMAGES seeded
    drawn-face images, one K1 launch a checkpoint-image, each AP within
    SELECT_AP_TOL of the same CLI on the CPU; export_weights --check of the
    last checkpoint to .pth and to .npz.  Returns K1's launches."""
    import tempfile

    from fdt_torch.cli import export_weights, select_checkpoint

    dev = str(device)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        anno = write_train_set(tmp)
        ck = tmp / "ck"
        chunks = _timed_chunks(
            ["--net", "try3", "--journal", "try3", "--journal-scale", str(CHAIN_SCALE),
             "--chunk", str(CHAIN_CHUNK), "--start_iter", str(CHAIN_START),
             "--resume", str(TRY3_WEIGHTS), "--stall-retries", "0", "--save_folder", str(ck),
             "--device", dev, "--input_size", str(SIZE), "--batch_size", str(CHAIN_BATCH),
             "--annoPath", str(anno)], dev)
        names, steps = [], []  # the first chunk starts from an npz: its step from 0
        for p in sorted(ck.glob(CHECKPOINTS)):
            names.append(p.name)
            with np.load(p / "opt_state.npz") as z:
                steps.append(int(z["step"]))
        if len(chunks) < 2 or names != ["try3_pyramid_4", "try3_pyramid_6"] or steps != [2, 4]:
            raise AssertionError(f"train_chained: {len(chunks)} chunks, checkpoints {names}, "
                                 f"steps {steps}")
        _phase("tooling_chained", t0, chunks=len(chunks),
               chunk_s=[round(s, 3) for s, _ in chunks],
               loop_s=[c["wall_s"] for _, c in chunks],
               startup_s=[round(s - c["wall_s"], 3) for s, c in chunks])

        t0 = time.perf_counter()
        val = write_face_val_set(tmp, SELECT_VAL_IMAGES)
        argv = ["--net", "try3", "--checkpoints", str(ck / CHECKPOINTS), "--val", str(val)]
        aps = {}
        for where in (dev, "cpu"):
            buf = io.StringIO()
            before = graph_counts()
            with contextlib.redirect_stdout(buf):
                _, k1 = _k1_during(lambda w=where: select_checkpoint.main(argv + ["--device", w]))
            aps[where] = json.loads(buf.getvalue().splitlines()[-1])
            if where == dev:
                select_k1, (graph_k1, graph_calls) = k1, k1_through_graphs(before)
        if select_k1 != len(steps) * SELECT_VAL_IMAGES - graph_calls + graph_k1:
            raise AssertionError(f"select_checkpoint: {select_k1} K1 launches")
        diff = {k: abs(v - aps["cpu"]["aps"][k]) for k, v in aps[dev]["aps"].items()}
        if (aps[dev]["aps"].keys() != aps["cpu"]["aps"].keys()
                or max(diff.values()) > SELECT_AP_TOL):
            raise AssertionError(f"select_checkpoint: card {aps[dev]} against CPU {aps['cpu']}")
        _phase("tooling_select", t0, aps=json.dumps(aps[dev]["aps"]).replace(" ", ""),
               cpu_aps=json.dumps(aps["cpu"]["aps"]).replace(" ", ""),
               max_ap_diff=f"{max(diff.values()):.3g}", best=aps[dev]["best"], k1=select_k1)

        t0 = time.perf_counter()
        last = str(sorted(ck.glob(CHECKPOINTS))[-1])
        export_k1, lines = 0, []
        for out in (tmp / "try3.pth", tmp / "try3.npz"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _, k1 = _k1_during(lambda o=out: export_weights.main(
                    ["--checkpoint", last, "--out", str(o), "--net", "try3", "--check",
                     "--device", dev]))
            export_k1 += k1
            lines.append(buf.getvalue().strip().splitlines()[-1])
            if not out.exists() or not lines[-1].startswith("check:") or k1 != 1:
                raise AssertionError(f"export_weights: {buf.getvalue()!r}, {k1} K1 launches")
        _phase("tooling_export", t0, checks=json.dumps(lines), k1=export_k1)
    return select_k1 + export_k1


def phase_inception(device) -> dict:
    """Inception-ResNet-v2 at full depth on the card: seeded_inception at
    299², batch 8, float32 "highest" (TF32 off), held to the CPU's forward
    of the first 2 images (check_inception); then ms a batch by CUDA events,
    images/s, and one profiled batch's device ms by part and idle share."""
    from fdt_torch.infer.pyramidbox import tf32_for

    t0 = time.perf_counter()
    model = seeded_inception()
    images = inception_images(INCEPTION_BATCH)
    with torch.no_grad():
        want = model(images[:INCEPTION_CPU_BATCH])
        model = model.to(device)
        x = images.to(device)
        with _tf32(True), tf32_for("highest"):
            got = model(x)
            check = check_inception(got[:INCEPTION_CPU_BATCH], want)
            end = time.perf_counter() + WARMUP_S
            while time.perf_counter() < end:
                model(x)
            ms = min(_cuda_ms(lambda: model(x), 5) for _ in range(3))
            split = _time_split(lambda: model(x))
    card = card_line()
    print("[inception] " + json.dumps({
        "batch": INCEPTION_BATCH, "size": INCEPTION_SIZE, "precision": "highest",
        "ms_a_batch": round(ms, 3), "images_per_s": round(INCEPTION_BATCH * 1e3 / ms, 2),
        "profiled_wall_ms": round(split["wall_ms"], 3),
        "device_ms": round(split["device_ms"], 3),
        "idle_pct": None if split["idle_pct"] is None else round(split["idle_pct"], 1),
        "parts_ms": {k: round(v, 3) for k, v in split["parts"].items()},
        "top": [[name[:60], round(v, 3)] for name, v in split["top"][:4]],
        "card": card}), flush=True)
    _phase("inception", t0, rel_err=f"{check['rel_err']:.3g}", spread=f"{check['spread']:.3g}",
           ms=f"{ms:.3f}")
    del model, x
    torch.cuda.empty_cache()
    return {"ms": ms, **check}


DIST_BATCH, DIST_STEPS = 2, 2  # leg (a): the flagship's DP step at 640², float32
DIST_GLOO_BATCH = 4  # leg (b): the global batch of two gloo ranks on one card
DIST_IMAGES = 9  # leg (c): 9 images on a 2-slot mesh, so the last shard is padded
DIST_ROW_TOL = 1.2e-3  # fdt's DP tolerance (rtol 1e-3, atol 2e-4) on values up to 1
DIST_CONF = 0.05
DIST_TIMEOUT_S = 180.0  # leg (b)'s shared deadline


def dist_flagship(device, weights, size: int):
    """The flagship trainer at size², float32 "highest", from repo_mini.npz."""
    from fdt_torch.models import PyramidBox
    from fdt_torch.train.loops import PyramidTrainer
    model = PyramidBox()
    model.load_state_dict(weights)
    return PyramidTrainer(model, "repo", input_size=size, precision="highest", device=device)


def dist_steps(trainer, batch, steps: int = DIST_STEPS) -> tuple[np.ndarray, dict]:
    """(the steps' metrics [steps, 5], the variables after them)."""
    from fdt_torch.models.loader import flat_variables, to_jax_variables
    metrics = [[float(v) for v in trainer.train_step(*batch, TRAIN_LR).values()]
               for _ in range(steps)]
    return np.array(metrics), flat_variables(to_jax_variables(trainer.model))


def check_dist_step(got, want, before: dict, what: str) -> dict:
    """A DP step's (metrics, variables) against the one-device step's: losses
    by TRAIN_LOSS_RTOL, each parameter's change within TRAIN_NORM_RTOL of the
    largest change, the running statistics within TRAIN_STATS_RTOL of each
    leaf's largest value.  Returns the errors; raises past a tolerance."""
    (gm, gv), (wm, wv) = got, want
    loss_err = (np.abs(gm - wm) / np.abs(wm)).max(axis=1)
    for step, err in enumerate(loss_err):
        if err > TRAIN_LOSS_RTOL[step]:
            raise AssertionError(f"{what}: step {step + 1} losses {gm[step]} against {wm[step]}")
    scale = max(np.abs(wv[k] - before[k]).max() for k in wv if k.startswith("params/"))
    change = max(np.abs((gv[k] - before[k]) - (wv[k] - before[k])).max()
                 for k in wv if k.startswith("params/")) / scale
    stats = max(np.abs(gv[k] - wv[k]).max() / np.abs(wv[k]).max()
                for k in wv if not k.startswith("params/"))
    if change > TRAIN_NORM_RTOL or stats > TRAIN_STATS_RTOL:
        raise AssertionError(f"{what}: parameter change {change} (of the largest), "
                             f"running statistics {stats}")
    return {"loss_rel_err": [float(e) for e in loss_err], "change_err_of_scale": float(change),
            "stats_rel_err": float(stats)}


def dist_rank_main(argv) -> int:
    """One rank of a DP train job: `spec.json rank`.  spec: "coordinator",
    "world", "out", "size", "batch" (the global batch), "backend" ("gloo"
    or "nccl"), "devices" (one a rank), "timed" (default true), and for the
    2-D mesh "space" (the space size s: a (world/s) x s make_mesh_2d, the
    rank's rows and band of the batch), "seed" (the batch's, default
    TRAIN_SEED + 3), "go" (a file to wait for before the trainer is built)
    and "save_state" (rank 0 writes its state dict).  The flagship on the
    rank's device, its part of the global batch, DIST_STEPS steps, then,
    timed and on a card, the ms of 3 more by CUDA events and the peak memory
    of trainer and steps; writes rank<r>.npz."""
    from fdt_torch.dist import make_mesh_2d, multihost, shard_train_batch
    from fdt_torch.models.loader import load_pyramidbox
    spec = json.loads(pathlib.Path(argv[0]).read_text())
    rank = int(argv[1])
    device, size = torch.device(spec["devices"][rank]), spec["size"]
    multihost.initialize(spec["coordinator"], spec["world"], rank, device=device,
                         backend=spec["backend"], timeout_s=DIST_TIMEOUT_S)
    try:
        n_space = spec.get("space", 1)
        batch = train_batch(spec.get("seed", TRAIN_SEED + 3), spec["batch"], size)
        if n_space > 1:
            mesh = make_mesh_2d(spec["world"] // n_space, n_space, devices=spec["devices"])
            batch = shard_train_batch(mesh, batch)
        else:
            lo, hi = multihost.process_batch_bounds(spec["batch"])
            batch = tuple(x[lo:hi] for x in batch)
        weights = load_pyramidbox(str(WEIGHTS)).state_dict()
        if spec.get("go"):
            _wait_for(pathlib.Path(spec["go"]))
        base = 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        trainer = dist_flagship(device, weights, size)
        t0 = time.perf_counter()
        metrics, variables = dist_steps(trainer, batch)
        step_ms, peak = 0.0, 0
        if device.type == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device) - base
        seconds = time.perf_counter() - t0
        if device.type == "cuda" and spec.get("timed", True):
            step_ms = _cuda_ms(lambda: trainer.train_step(*batch, TRAIN_LR), 3)
        if spec.get("save_state") and rank == 0:
            torch.save({k: v.cpu() for k, v in trainer.model.state_dict().items()},
                       pathlib.Path(spec["out"]) / "state.pt")
        np.savez(pathlib.Path(spec["out"]) / f"rank{rank}.npz", metrics=metrics,
                 seconds=seconds, step_ms=step_ms, peak_bytes=peak,
                 **{f"v/{k}": v for k, v in variables.items()})
    finally:
        multihost.shutdown()
    return 0


def _wait_for(path: pathlib.Path) -> None:
    """Until `path` exists (DIST_TIMEOUT_S at most)."""
    end = time.monotonic() + DIST_TIMEOUT_S
    while not path.exists():
        if time.monotonic() > end:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.1)


def run_dist_ranks(spec: dict, out: str | None = None) -> list:
    """dist_rank_main as spec["world"] processes under one shared deadline;
    [(metrics, variables, seconds, step_ms, peak_bytes)] by rank (their files
    in `out`, a temporary directory when None).  Raises unless the ranks'
    metrics and variables are bit-equal."""
    import tempfile

    from fdt_torch.dist import procutil
    with tempfile.TemporaryDirectory() as tmp:
        out = out or tmp
        path = pathlib.Path(tmp) / "spec.json"
        path.write_text(json.dumps({**spec, "out": out}))
        prog = "import sys, chip_smoke; sys.exit(chip_smoke.dist_rank_main(sys.argv[1:]))"
        procutil.python_workers([["-c", prog, str(path), str(r)] for r in range(spec["world"])],
                                DIST_TIMEOUT_S, env=procutil.child_env(2),
                                cwd=str(REPO))
        ranks = []
        for r in range(spec["world"]):
            with np.load(pathlib.Path(out) / f"rank{r}.npz") as z:
                ranks.append((z["metrics"], {k[2:]: z[k] for k in z.files if k.startswith("v/")},
                              float(z["seconds"]), float(z["step_ms"]), int(z["peak_bytes"])))
    m0, v0 = ranks[0][:2]
    for m, v, *_ in ranks[1:]:
        if not (np.array_equal(m0, m) and v0.keys() == v.keys()
                and all(np.array_equal(v0[k], v[k]) for k in v0)):
            raise AssertionError("dist: the ranks differ")
    return ranks


def check_dp_detections(got: np.ndarray, want: np.ndarray) -> float:
    """Two [B, 2, top_k, 5] detection tensors of one batch agree at fdt's DP
    tolerance: per image the same count of face rows, each within
    DIST_ROW_TOL (match_rows: a near-tied neighbour may swap).  Returns the
    largest difference."""
    err = 0.0
    for i in range(len(want)):
        n = int((want[i, 1, :, 0] > 0).sum())
        if int((got[i, 1, :, 0] > 0).sum()) != n:
            raise AssertionError(f"image {i}: {int((got[i, 1, :, 0] > 0).sum())} rows "
                                 f"against {n}")
        if n:
            err = max(err, match_rows(got[i, 1], want[i, 1], n, DIST_ROW_TOL))
    return err


def phase_dist(device) -> dict:
    """Data parallelism on the one card (fdt_torch.dist), four legs, each
    with its [dist] line:
      (a) the flagship's DP train step at 640², batch 2, float32 "highest",
          through NCCL at world size 1, against the one-device step (the DP
          arithmetic: BatchNorm's and the loss's sums, the gradient
          all-reduce), and each one's ms a step;
      (b) two gloo ranks on cuda:0 (run_dist_ranks: procutil.python_workers
          of dist_rank_main) on a global batch of 4: ranks bit-equal after 2
          steps, and both against the one-rank step on the same 4 rows;
      (c) DP inference on a 2-slot mesh of cuda:0: the flagship at 640², 9
          images (the last shard padded), float32 against the unsharded
          detector (check_dp_detections) and int8 against the unsharded
          int8 detector on each shard's rows (an activation's int8 scale is
          its shard's amax), K1, K4 and K5 launches counted;
      (d) the data x space mesh: two gloo ranks on cuda:0 as a 1 x 2 mesh
          (make_mesh_2d: each rank the upper or lower band of every map's
          rows, halos exchanged) take (a)'s step on (a)'s 2 images: ranks
          bit-equal after 2 steps and both against (a)'s one-device step,
          each rank's peak memory and ms a step against the one-device
          step's, then rank 0's weights detect one 640² batch through K1.
    (b)'s ranks start first, on a thread, and (b)'s reference and (c) run
    while they start up; (d)'s ranks start up while (a), which is timed,
    runs, and wait for it to end before they build their trainers.  Returns
    the launches of (c) and (d) and the errors."""
    import tempfile

    from fdt_torch.dist import procutil
    from fdt_torch.models.loader import load_pyramidbox

    weights = load_pyramidbox(str(WEIGHTS)).state_dict()
    card = card_line()

    t0 = time.perf_counter()
    job: dict = {}

    def ranks(key: str, spec: dict, out: str | None = None):
        try:
            job[key] = run_dist_ranks(spec, out)
        except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
            job["error"] = e

    thread = threading.Thread(target=ranks, args=("gloo", {
        "coordinator": f"127.0.0.1:{procutil.free_port()}", "world": 2, "size": SIZE,
        "batch": DIST_GLOO_BATCH, "backend": "gloo", "devices": [str(device)] * 2,
        "timed": False}))
    thread.start()
    try:
        want, before = dist_reference(device, weights, DIST_GLOO_BATCH)
        infer = _dist_infer_2slot(device, weights, card)
    finally:
        thread.join()
    if "error" in job:
        raise job["error"]
    gloo = check_dist_step(job["gloo"][0][:2], want, before, "dist gloo 2 ranks")
    print("[dist] train_gloo_2ranks " + json.dumps({
        "global_batch": DIST_GLOO_BATCH, "size": SIZE, "steps": DIST_STEPS,
        "ranks_bit_equal": True, **gloo,
        "rank_seconds_for_steps": [round(r[2], 3) for r in job["gloo"]], "card": card}),
        flush=True)
    _phase("dist_train_gloo_and_infer", t0,
           loss_rel_err=[f"{e:.3g}" for e in gloo["loss_rel_err"]])

    with tempfile.TemporaryDirectory() as tmp:
        go = pathlib.Path(tmp) / "go"
        thread = threading.Thread(target=ranks, args=("space", {
            "coordinator": f"127.0.0.1:{procutil.free_port()}", "world": 2, "space": 2,
            "size": SIZE, "batch": DIST_BATCH, "seed": TRAIN_SEED + 2, "backend": "gloo",
            "devices": [str(device)] * 2, "go": str(go), "save_state": True}, tmp))
        thread.start()
        try:
            t0 = time.perf_counter()
            nccl, one = _dist_train_nccl1(device, weights, card)
            _phase("dist_train_nccl", t0,
                   loss_rel_err=[f"{e:.3g}" for e in nccl["loss_rel_err"]])
            t0 = time.perf_counter()
        finally:
            go.touch()
            thread.join()
        if "error" in job:
            raise job["error"]
        infer["launches"]["k1"] += _dist_space_leg(device, job["space"], one, tmp, card)
    _phase("dist_train_space", t0)
    return infer


def _dist_space_leg(device, ranks: list, one: dict, tmp: str, card: str) -> int:
    """Leg (d) of phase_dist, after its ranks: their steps against (a)'s
    one-device step, and a detect of rank 0's weights; returns its K1
    launches."""
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models import PyramidBox
    from fdt_torch.ops import nms as nms_op

    space = check_dist_step(ranks[0][:2], one["steps"], one["before"], "dist space 1x2")
    model = PyramidBox()
    model.load_state_dict(torch.load(pathlib.Path(tmp) / "state.pt", weights_only=True))
    det = PyramidBoxDetector(model, device=device)
    frames = torch.from_numpy(flagship_batch()).to(device)
    det.detect_tensor(frames, DIST_CONF)  # the first call at this shape plans cuDNN's convs
    torch.cuda.synchronize()
    nms_op.launches.reset()
    rows = det.detect_tensor(frames, DIST_CONF)
    torch.cuda.synchronize()
    k1 = nms_op.launches.count
    if rows.shape != (len(frames), 2, 750, 5) or not np.isfinite(rows).all() or not k1:
        raise AssertionError(f"dist space: the trained weights' detect gave {rows.shape}, "
                             f"{k1} K1 launches")
    print("[dist] train_space_1x2 " + json.dumps({
        "mesh": {"data": 1, "space": 2}, "backend": "gloo", "batch": DIST_BATCH, "size": SIZE,
        "steps": DIST_STEPS, "ranks_bit_equal": True, **space,
        "rank_peak_mib": [round(r[4] / 2 ** 20, 1) for r in ranks],
        "one_device_peak_mib": round(one["peak_bytes"] / 2 ** 20, 1),
        "rank_peak_share": [round(r[4] / one["peak_bytes"], 4) for r in ranks],
        "rank_step_ms": [round(r[3], 3) for r in ranks],
        "one_device_step_ms": round(one["ms"], 3),
        "rank_seconds_for_steps": [round(r[2], 3) for r in ranks],
        "detect": {"images": len(frames), "k1_launches": k1,
                   "faces": int((rows[:, 1, :, 0] > 0).sum())},
        "note": "both ranks share the one card", "card": card}), flush=True)
    del det, model
    torch.cuda.empty_cache()
    return k1


def dist_reference(device, weights, batch: int) -> tuple:
    """The one-device flagship's DIST_STEPS steps on the DP legs' global
    batch: ((metrics, variables), the variables before)."""
    from fdt_torch.models.loader import flat_variables, to_jax_variables
    one = dist_flagship(device, weights, SIZE)
    before = flat_variables(to_jax_variables(one.model))
    return dist_steps(one, train_batch(TRAIN_SEED + 3, batch, SIZE)), before


def _dist_train_nccl1(device, weights, card: str) -> tuple[dict, dict]:
    """Leg (a) of phase_dist: (its errors, the one-device step's "steps"
    (metrics, variables), "before" variables, "ms" and "peak_bytes", the
    peak memory its trainer and steps took)."""
    from fdt_torch.dist import multihost, procutil
    from fdt_torch.models.loader import flat_variables, to_jax_variables

    batch = train_batch(TRAIN_SEED + 2, DIST_BATCH, SIZE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    one = dist_flagship(device, weights, SIZE)
    before = flat_variables(to_jax_variables(one.model))
    want = dist_steps(one, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    one_ms = _cuda_ms(lambda: one.train_step(*batch, TRAIN_LR), 3)
    del one
    multihost.initialize(f"127.0.0.1:{procutil.free_port()}", 1, 0, device=device)
    try:
        dp = dist_flagship(device, weights, SIZE)
        got = dist_steps(dp, batch)
        dp_ms = _cuda_ms(lambda: dp.train_step(*batch, TRAIN_LR), 3)
        backend = torch.distributed.get_backend()
    finally:
        multihost.shutdown()
    del dp
    torch.cuda.empty_cache()
    nccl = check_dist_step(got, want, before, "dist nccl world 1")
    print("[dist] train_nccl_world1 " + json.dumps({
        "backend": backend, "batch": DIST_BATCH, "size": SIZE, "steps": DIST_STEPS, **nccl,
        "dp_step_ms": round(dp_ms, 3), "one_device_step_ms": round(one_ms, 3),
        "one_device_peak_mib": round(peak / 2 ** 20, 1), "card": card}), flush=True)
    return nccl, {"steps": want, "before": before, "ms": one_ms, "peak_bytes": peak}


def _dist_infer_2slot(device, weights, card: str) -> dict:
    """Leg (c) of phase_dist: returns the launches and the float32 error."""
    from fdt_torch.dist import make_mesh
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models import PyramidBox

    def flagship():
        model = PyramidBox()
        model.load_state_dict(weights)
        return model

    mesh = make_mesh(devices=[device] * 2)
    frames = torch.from_numpy(flagship_batch()).to(device)
    frames = torch.cat([frames, frames.flip(2)])[:DIST_IMAGES]
    out, launches = {}, {"k1": 0, "k4_wgmma": 0, "k4_mma_sync": 0, "k5": 0}
    for name, quant_mode in (("f32", None), ("int8", "int8")):
        det = PyramidBoxDetector(flagship(), device=device, quant=quant_mode)
        det_dp = PyramidBoxDetector(flagship(), quant=quant_mode, mesh=mesh)
        whole = det.detect_tensor(frames, DIST_CONF)
        torch.cuda.synchronize()
        _reset_counts()
        got = det_dp.detect_tensor(frames, DIST_CONF)
        torch.cuda.synchronize()
        k4, k5, k1 = _int8_counts()
        by_variant = _k4_counts()
        launches["k1"] += k1
        launches["k4_wgmma"] += by_variant["wgmma"]
        launches["k4_mma_sync"] += by_variant["mma_sync"]
        launches["k5"] += k5
        if got.shape != whole.shape or whole.shape != (DIST_IMAGES, 2, 750, 5):
            raise AssertionError(f"dist {name}: shapes {got.shape} and {whole.shape}")
        if name == "f32":
            out["f32"] = {"max_err": check_dp_detections(got, whole), "k1": k1}
        else:
            half = (DIST_IMAGES + 1) // 2
            padded = torch.cat([frames, frames[-1:]])
            shards = np.concatenate([det.detect_tensor(padded[:half], DIST_CONF),
                                     det.detect_tensor(padded[half:], DIST_CONF)])[:DIST_IMAGES]
            if not np.array_equal(got, shards):
                raise AssertionError("dist int8: the meshed detector differs from the "
                                     f"unsharded one on its shards by {np.abs(got - shards).max()}")
            out["int8"] = {"bit_equal_to_shards": True, "k1": k1, "k4": k4, "k5": k5,
                           "max_abs_diff_to_whole_batch": float(np.abs(got - whole).max())}
        del det, det_dp
    torch.cuda.empty_cache()
    print("[dist] infer_2slot " + json.dumps({"images": DIST_IMAGES, "size": SIZE,
                                             "conf": DIST_CONF, **out, **launches,
                                             "card": card}), flush=True)
    return {"launches": launches, "f32_err": out["f32"]["max_err"]}


@contextlib.contextmanager
def k1_checked(record: dict):
    """Every K1 call of the body also run by its plain version on the same
    device and inputs: record[device] = [calls, largest mask error]."""
    from fdt_torch.geometry.nms import nms_keep_mask
    from fdt_torch.ops import nms as nms_op

    kernel = nms_op.nms_keep_tiled

    def checked(boxes, valid, iou_thresh, mode="union", seg_id=None, out_k=None):
        keep = kernel(boxes, valid, iou_thresh, mode=mode, seg_id=seg_id, out_k=out_k)
        plain = nms_keep_mask(boxes, valid, iou_thresh, mode=mode, seg_id=seg_id)
        entry = record.setdefault(str(boxes.device), [0, 0.0])
        entry[0] += 1
        entry[1] = max(entry[1], _mask_err(keep, plain, out_k))
        return keep

    nms_op.nms_keep_tiled = checked
    try:
        yield record
    finally:
        nms_op.nms_keep_tiled = kernel


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _host_ms(fn, iters: int = 5) -> float:
    """Best of 3 blocks of `iters` calls by the host clock, every card
    synchronised, after a warm-up of WARMUP_S."""
    _warm(fn)
    best = float("inf")
    for _ in range(3):
        _sync_all()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync_all()
        best = min(best, (time.perf_counter() - t) * 1e3 / iters)
    return best


def phase_dist_cards(cards: int) -> dict:
    """Data parallelism over `cards` cards of one host (a several-card
    machine; not part of the one-card main path), each result on its [dist_cards]
    line beside the cards' names and power limits:
      * the [device] facts;
      * DP inference on make_mesh(cards) against the unsharded detector on
        cuda:0, the flagship at 640², 9 images: float32 (check_dp_detections)
        and int8 (bit-equal to the unsharded int8 detector on each shard's
        rows); K1 on every card against its plain version on the path's own
        boxes (k1_checked), K4 and K5 on every card's int8 convs against
        theirs (check_int8_model on each replica); the bf16 flagship's
        images/s at 8 images a card against one card at batch 8 and at the
        mesh's whole batch (_host_ms);
      * `cards` NCCL ranks (run_dist_ranks) of the flagship's DP step at
        640², 2 rows a rank, against the one-card step on the global batch,
        ranks bit-equal; each rank's ms a step against the one card's at
        batch 2 and at the global batch;
      * the data x space mesh: `cards` NCCL ranks as a (cards/2) x 2 mesh
        (make_mesh_2d) of the flagship's step at 640², 1 image a data index,
        against the one-card step on the same images, ranks bit-equal; each
        rank's ms a step and peak memory against the one card's;
      * python -m fdt_torch.cli.train_pyramid --dp_devices `cards`, then
        --dp_devices cards/2 --sp_devices 2, for 3 iterations of the flagship
        at 640², 2 images a data index, on seeded images of
        data/mini/gen_anno_file_mini_train.
    """
    from fdt_torch.dist import make_mesh, procutil
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models.loader import flat_variables, load_pyramidbox, to_jax_variables
    from fdt_torch.ops import nms as nms_op

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()
    out = {"cards": card, "facts": device_facts()}
    print("[dist_cards] facts " + json.dumps(out), flush=True)
    mesh = make_mesh(cards)
    home = mesh.devices[0]

    t0 = time.perf_counter()
    frames = torch.from_numpy(flagship_batch())
    frames = torch.cat([frames, frames.flip(2)])[:DIST_IMAGES].to(home)
    infer = {}
    for name, quant_mode in (("f32", None), ("int8", "int8")):
        det = PyramidBoxDetector(load_pyramidbox(str(WEIGHTS)), device=home, quant=quant_mode)
        det_dp = PyramidBoxDetector(load_pyramidbox(str(WEIGHTS)), quant=quant_mode, mesh=mesh)
        whole = det.detect_tensor(frames, DIST_CONF)
        k1 = {}
        _sync_all()
        nms_op.launches.reset()
        with k1_checked(k1):
            if quant_mode:
                checks = {}

                def run_checked(devices):
                    """One meshed detect, every replica's int8 convs hooked."""
                    if not devices:
                        return det_dp.detect_tensor(frames, DIST_CONF)
                    res = {}
                    checks[str(devices[0])] = check_int8_model(
                        det_dp._models[devices[0]],
                        lambda: res.setdefault("got", run_checked(devices[1:])))
                    return res["got"]

                got = run_checked(list(mesh.distinct))
            else:
                got = det_dp.detect_tensor(frames, DIST_CONF)
        _sync_all()
        entry = {"k1": k1, "k1_launches": nms_op.launches.count}
        if quant_mode:
            per = -(-DIST_IMAGES // cards)
            padded = torch.cat([frames, frames[-1:].expand(per * cards - DIST_IMAGES, -1, -1, -1)])
            shards = np.concatenate([det.detect_tensor(padded[i * per:(i + 1) * per], DIST_CONF)
                                     for i in range(cards)])[:DIST_IMAGES]
            entry.update(bit_equal_to_shards=bool(np.array_equal(got, shards)),
                         max_abs_diff_to_shards=float(np.abs(got - shards).max()),
                         int8_checks=checks)
        else:
            entry["max_err"] = check_dp_detections(got, whole)
        for dev, (calls, err) in k1.items():
            if err:
                raise AssertionError(f"dist_cards: K1 on {dev} differs from its plain version")
        bad = {d: c for d, c in entry.get("int8_checks", {}).items()
               if c["k5_err"] or c["k4_err"] or not c["convs"]}
        if bad or len(k1) != len(mesh.distinct):
            raise AssertionError(f"dist_cards: K4/K5 off their plain versions on {bad}, or K1 "
                                 f"ran on {sorted(k1)} only")
        infer[name] = entry
        del det, det_dp
    print("[dist_cards] infer " + json.dumps({"images": DIST_IMAGES, "size": SIZE, **infer,
                                              "card": card}), flush=True)
    if not infer["int8"]["bit_equal_to_shards"]:
        raise AssertionError("dist_cards: the int8 mesh differs from its shards' unsharded rows")

    det16 = PyramidBoxDetector(load_pyramidbox(str(WEIGHTS)), dtype=torch.bfloat16, device=home)
    det16_dp = PyramidBoxDetector(load_pyramidbox(str(WEIGHTS)), dtype=torch.bfloat16, mesh=mesh)
    big = torch.from_numpy(np.concatenate([flagship_batch()] * cards)).to(home)
    rates = {"mesh_batch": len(big),
             "mesh_ms": _host_ms(lambda: det16_dp.detect_device(big, 0.35, 0.35)),
             "one_card_batch8_ms": _host_ms(lambda: det16.detect_device(big[:BATCH], 0.35, 0.35)),
             "one_card_whole_batch_ms": _host_ms(lambda: det16.detect_device(big, 0.35, 0.35))}
    rates.update(mesh_images_per_s=len(big) * 1e3 / rates["mesh_ms"],
                 one_card_images_per_s=BATCH * 1e3 / rates["one_card_batch8_ms"])
    print("[dist_cards] infer_rate " + json.dumps({**{k: round(v, 3) for k, v in rates.items()},
                                                   "dtype": "bf16", "card": card}), flush=True)
    del det16, det16_dp, big
    torch.cuda.empty_cache()
    _phase("dist_cards_infer", t0)

    t0 = time.perf_counter()
    weights = load_pyramidbox(str(WEIGHTS)).state_dict()
    batch = train_batch(TRAIN_SEED + 3, 2 * cards, SIZE)
    one = dist_flagship(home, weights, SIZE)
    before = flat_variables(to_jax_variables(one.model))
    want = dist_steps(one, batch)
    one_ms = {"global_batch": _cuda_ms(lambda: one.train_step(*batch, TRAIN_LR), 3)}
    batch2 = tuple(x[:2] for x in batch)
    one.train_step(*batch2, TRAIN_LR)  # the first call at a shape plans cuDNN's convolutions
    one_ms["batch2"] = _cuda_ms(lambda: one.train_step(*batch2, TRAIN_LR), 3)
    del one
    torch.cuda.empty_cache()
    ranks = run_dist_ranks({"coordinator": f"127.0.0.1:{procutil.free_port()}", "world": cards,
                            "size": SIZE, "batch": 2 * cards, "backend": "nccl",
                            "devices": [f"cuda:{i}" for i in range(cards)]})
    nccl = check_dist_step(ranks[0][:2], want, before, f"dist_cards nccl {cards} ranks")
    print("[dist_cards] train_nccl " + json.dumps({
        "ranks": cards, "global_batch": 2 * cards, "size": SIZE, "ranks_bit_equal": True, **nccl,
        "rank_step_ms": [round(r[3], 3) for r in ranks],
        "one_card_step_ms": {k: round(v, 3) for k, v in one_ms.items()}, "card": card}),
        flush=True)
    _phase("dist_cards_train", t0)

    t0 = time.perf_counter()
    n_data = cards // 2
    batch = train_batch(TRAIN_SEED + 3, n_data, SIZE)
    torch.cuda.reset_peak_memory_stats(home)
    base = torch.cuda.memory_allocated(home)
    one = dist_flagship(home, weights, SIZE)
    before = flat_variables(to_jax_variables(one.model))
    want = dist_steps(one, batch)
    torch.cuda.synchronize(home)
    one_peak = torch.cuda.max_memory_allocated(home) - base
    one_ms = _cuda_ms(lambda: one.train_step(*batch, TRAIN_LR), 3)
    del one
    torch.cuda.empty_cache()
    ranks = run_dist_ranks({"coordinator": f"127.0.0.1:{procutil.free_port()}", "world": cards,
                            "space": 2, "size": SIZE, "batch": n_data, "backend": "nccl",
                            "devices": [f"cuda:{i}" for i in range(cards)]})
    space = check_dist_step(ranks[0][:2], want, before, f"dist_cards nccl {n_data}x2")
    print("[dist_cards] train_space " + json.dumps({
        "mesh": {"data": n_data, "space": 2}, "global_batch": n_data, "size": SIZE,
        "ranks_bit_equal": True, **space,
        "rank_step_ms": [round(r[3], 3) for r in ranks],
        "one_card_step_ms": round(one_ms, 3),
        "rank_peak_mib": [round(r[4] / 2 ** 20, 1) for r in ranks],
        "one_card_peak_mib": round(one_peak / 2 ** 20, 1),
        "rank_peak_share": [round(r[4] / one_peak, 4) for r in ranks], "card": card}),
        flush=True)
    _phase("dist_cards_space", t0)

    for dp, sp in ((cards, 1), (n_data, 2)):
        _dist_cards_cli(dp, sp, home, card)
    return out


def _dist_cards_cli(dp: int, sp: int, home, card) -> None:
    """python -m fdt_torch.cli.train_pyramid --dp_devices dp [--sp_devices sp]
    for 3 iterations of the flagship at 640², 2 images a data index, on
    seeded images of data/mini/gen_anno_file_mini_train."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        anno = write_mini_train(pathlib.Path(tmp))
        flags = ["--dp_devices", str(dp)] + (["--sp_devices", str(sp)] if sp > 1 else [])
        argv = ["--net", "repo", "--batch_size", str(2 * dp), "--iter", "3",
                "--save_point", "3", *flags, "--annoPath", str(anno),
                "--save_folder", tmp + "/", *(["--device", "cpu"] if home.type == "cpu" else [])]
        r = subprocess.run([sys.executable, "-m", "fdt_torch.cli.train_pyramid", *argv],
                           capture_output=True, text=True, timeout=DIST_TIMEOUT_S, cwd=REPO)
        if r.returncode:
            raise AssertionError(f"dist_cards: train_pyramid {' '.join(flags)} exited "
                                 f"{r.returncode}:\n{r.stderr[-3000:]}")
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("[train] ")][-1]
        saved = sorted(p.name for p in pathlib.Path(tmp).iterdir() if p.name.startswith("repo_"))
    print("[dist_cards] train_cli " + json.dumps({
        "flags": " ".join(flags), "train": json.loads(line[len("[train] "):]), "saved": saved,
        "wall_s": round(time.perf_counter() - t0, 3), "card": card}), flush=True)
    _phase("dist_cards_cli", t0, flags=" ".join(flags))


def write_mini_train(directory: pathlib.Path) -> pathlib.Path:
    """data/mini/gen_anno_file_mini_train with each image a seeded
    photo-like PNG large enough for its boxes (the images are not in the
    repo); returns the new anno file."""
    from PIL import Image
    lines = []
    src = REPO / "data" / "mini" / "gen_anno_file_mini_train"
    for k, line in enumerate(src.read_text().splitlines()):
        cells = line.split()
        n = int(cells[1])
        b = np.array(cells[2:2 + 4 * n], float).reshape(n, 4)
        h, w = int((b[:, 1] + b[:, 3]).max()) + 8, int((b[:, 0] + b[:, 2]).max()) + 8
        path = directory / (pathlib.Path(cells[0]).stem + ".png")
        Image.fromarray(photo_like(h, w, k)[:, :, ::-1]).save(path)
        lines.append(" ".join([str(path)] + cells[1:]))
    anno = directory / src.name
    anno.write_text("\n".join(lines) + "\n")
    return anno


def device_facts() -> dict:
    """What the distribution slice needs to know of this machine: torch's
    and nvidia-smi's card counts, NCCL's presence and version."""
    smi = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60)
    nccl = None
    try:
        nccl = ".".join(map(str, torch.cuda.nccl.version()))
    except (AttributeError, RuntimeError) as e:
        nccl = f"unavailable: {e}"
    return {"torch_device_count": torch.cuda.device_count(),
            "nvidia_smi_gpus": sum(ln.startswith("GPU ") for ln in smi.stdout.splitlines()),
            "nccl_available": torch.distributed.is_available()
            and torch.distributed.is_nccl_available(),
            "nccl_version": nccl}


@contextlib.contextmanager
def warnings_kept():
    """Collect the warnings of the body (the cascade's saturation notes)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        yield caught


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
    det32, det16, launches, boxes_err = phase_flagship(device)
    facebox_det, k2_launches = phase_facebox(device)
    phase_variants(device)
    phase_fused(device)
    int8_launches, int8_timed, int8_sums, int8_err = phase_int8(device, det16)
    mtcnn_launches, mtcnn_err = phase_mtcnn(device)
    track_k1_launches, track_k1_err, k3, k3_global = phase_tracking(device)
    phase_serving(det32, facebox_det)
    http_launches = phase_http(det16)
    eval_launches = phase_eval(det32, facebox_det, device)
    host_launches = phase_mtcnn_host(device)
    frames, tracks, video_det, floor, video_k1, video_k3, video_k1_err = phase_video(device)
    phase_video_render(frames, tracks)
    demo_launches = phase_video_demo(video_det, floor, facebox_det, device, frames)
    train_launches = phase_train(device)
    families_launches = phase_train_families(device)
    interop_launches = phase_interop(device)
    tooling_launches = phase_tooling(device)
    phase_inception(device)
    dist = phase_dist(device)
    print("[device] " + json.dumps(device_facts()), flush=True)

    # PyTorch has no NMS call (and torchvision is not installed) and no
    # greedy-association call: no library_ms.  K4's wgmma variant and K5 at
    # the flagship's heaviest int8 conv, K4's mma_sync variant at its stem;
    # batch_bound_ms: the sum of the bounds over the convs of a batch that
    # the row's kernel runs (chip_smoke.int8_timings)
    k4_rows = []
    for variant, row_name in (("wgmma", "conv_int8_wgmma (K4, wgmma)"),
                              ("mma_sync", "conv_int8 (K4, mma_sync)")):
        t = next(t for t in int8_timed if t["variant"] == variant)
        library = None if str(t["int_mm_ms"]).startswith("refused") else float(t["int_mm_ms"])
        k4_rows.append({
            "name": row_name, "route": "cuda", "source": "fdt_torch/csrc/conv_int8.cu",
            "replaces": "fdt/ops/quant.py:123",
            "launches": int8_launches[f"k4_{variant}"] + dist["launches"][f"k4_{variant}"],
            "max_abs_err": int8_err["k4"],
            "ms": t["k4_ms"], "plain_ms": t["k4_plain_ms"], "bound_ms": t["k4_bound_ms"],
            "bound_by": t["k4_bound_by"], "shape": t["shape"], "mnk": t["mnk"],
            "batch_bound_ms": int8_sums["k4_bound_ms"].get(variant, 0.0),
            # torch._int_mm (cuBLASLt) on the same (M, N, K) GEMM, its im2col
            # not counted; cuDNN's bf16 conv of the same shape beside it as context
            "library_ms": library, "library": "torch._int_mm, im2col excluded",
            "library_error": None if library is not None else t["int_mm_ms"],
            "cudnn_bf16_ms": t["cudnn_bf16_ms"]})
    k5 = int8_timed[0]
    print(json.dumps({"kernels": [{
        "name": "nms_tiled (K1)", "route": "cuda",
        "source": "fdt_torch/csrc/nms_tiled.cu",
        "replaces": "fdt/ops/pallas_nms.py:69",
        "launches": (launches + int8_launches["k1"] + mtcnn_launches + track_k1_launches
                     + http_launches + eval_launches + host_launches + video_k1
                     + demo_launches + train_launches + families_launches
                     + interop_launches + tooling_launches + dist["launches"]["k1"]),
        "max_abs_err": max(k1["max_abs_err"], boxes_err, mtcnn_err, track_k1_err,
                           video_k1_err),
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
        "launches": k3["launches"] + video_k3["smem"],
        "max_abs_err": 0.0,  # bit-equal, or the phase raised
        "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": None,
        "device_ms": k3["device_ms"], "host_ms": k3["host_ms"]}, {
        "name": "track_assoc_global (K3, device memory)", "route": "cuda",
        "source": "fdt_torch/csrc/track_assoc.cu",
        "replaces": "fdt/track/device_tracker.py:93",
        "launches": k3_global["launches"] + video_k3["global"], "max_abs_err": 0.0,
        "ms": k3_global["ms"], "plain_ms": k3_global["plain_ms"],
        "bound_ms": k3_global["bound_ms"], "bound_by": k3_global["bound_by"],
        "library_ms": None, "device_ms": k3_global["device_ms"],
        "host_ms": k3_global["host_ms"]}, {
        **k4_rows[0]}, {**k4_rows[1]}, {
        "name": "quantize_int8 (K5)", "route": "cuda", "source": "fdt_torch/csrc/quantize_int8.cu",
        "replaces": "fdt/ops/quant.py:69",
        "launches": int8_launches["k5"] + dist["launches"]["k5"],
        "max_abs_err": int8_err["k5"],
        "ms": k5["k5_ms"], "plain_ms": k5["k5_plain_ms"], "bound_ms": k5["k5_bound_ms"],
        "bound_by": k5["k5_bound_by"], "shape": k5["shape"],
        "batch_bound_ms": int8_sums["k5_bound_ms"],
        "library_ms": None}]}))  # no one PyTorch call computes amax and the quantization
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
