#!/usr/bin/env python3
"""Time the greedy-NMS kernels K1 (nms_keep_tiled) or K2 (nms_keep_greedy),
the tracker's association kernel K3 (associate_chunk), or the int8 path's
kernels K4 (conv_int8) and K5 (quantize_int8), of fdt_torch on one CUDA card.

    python3 profile_nms.py [--kernel k1|k2|k3|k4|k5] [--tree DIR ...] [--out FILE]

Each --tree is the root of a checkout whose fdt_torch is built (into its own
fdt_torch/_build) and timed, in the order given, so that two versions of a
kernel are compared inside one run (for example old, new, new, old); the
default is this checkout.  Each tree runs in a process of its own.  For every
case of chip_smoke.K1_TIMED (k1, the default) or chip_smoke.K2_TIMED (k2) it
prints one JSON line: the time a call by CUDA events, the wrapper's host time
a call, each kernel's device time from torch.profiler, the pair tests the
greedy walk needs and the bound they give.  For K2 it then prints, for this
checkout's kernel, one more line a case: its cluster size, the clusters the
card runs at once, the pair tests it computes, and the device time of its
prelude (the staging of its words, then also their hit words, each run
alone by a launch of nms_greedy.cu's own code) beside the whole kernel's.
For K3 a line a case of chip_smoke.K3_TIMED (events, device and host ms a
chunk, the dependent slot steps and ns a step, the bound, the registers and
spills ptxas reports for the tree's K3 kernels), then for this checkout
three lines a case: the device time of the walk alone (track_assoc.cu's
walk() on rows of keys already in shared memory, launched alone), ns a
dependent step and the chain floor (the case's steps at that time); the
kernel's clock cycles a frame by phase (a copy built with FDT_K3_TRACE);
and the device time of the shared-memory variant's own code with its slot
state and lists in device memory instead (checked bit for bit against the
plain version first) beside the variant's, also at t-over-smem, where the
device-memory variant runs.
For K4 and K5 a line for every int8 conv that one detect of the bf16 int8
flagship runs (batch 8, 640², chip_smoke.flagship_batch(), in forward
order), on the conv's own input: its class (wide kxk, 1x1, head, stem),
M/N/K, the K4 variant it takes, K4's ms by CUDA events and its device ms by
torch.profiler, its bound and what bounds it, torch._int_mm on the same
GEMM (k4 only), K5's ms (the same two) and bound, the host ms a call of
both wrappers and of the conv's forward, both kernels checked bit for bit
against their plain versions first; then one line of
sums over the batch (by K4 variant too) and the registers, spills and shared
memory that ptxas reports for the tree's K4 and K5 kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent

# K2's prelude alone: nms_greedy.cu's staging and last-word reduction
# (nms_greedy_stage_kernel), or those and the hit words
# (nms_greedy_prelude_kernel), launched as the kernel is
PRELUDE_CU = r"""
#include "nms_greedy.cu"

namespace {

template <bool kHits>
__device__ void prelude(const float4* boxes, const uint8_t* valid, uint8_t* keep, int n,
                        float thresh, int minimum_mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x % kCluster;
  const size_t base = static_cast<size_t>(blockIdx.x / kCluster) * n;
  const int words = (n + kTile - 1) / kTile;
  const int mine = own_words(words, r);
  const Shared s(smem, (words + kCluster - 1) / kCluster);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int last = stage(s, boxes + base, valid + base, n, r, mine, warp, lane);
  const int walked = own_words_upto(last, r, mine);
  if (kHits) hit_words(s, walked, thresh, minimum_mode, warp, lane);
  __syncthreads();
  if (threadIdx.x == 0 && r < n) {  // keeps what was computed alive
    keep[base + r] = static_cast<uint8_t>(
        last + (walked ? s.diag[0] ^ s.diag[walked * kTile - 1] ^ s.removed[0] : 0));
  }
  cluster_arrive();
  cluster_wait();
}

__global__ void __launch_bounds__(kThreads, 2)
nms_greedy_stage_kernel(const float4* boxes, const uint8_t* valid, uint8_t* keep, int n,
                        float thresh, int minimum_mode) {
  prelude<false>(boxes, valid, keep, n, thresh, minimum_mode);
}

__global__ void __launch_bounds__(kThreads, 2)
nms_greedy_prelude_kernel(const float4* boxes, const uint8_t* valid, uint8_t* keep, int n,
                          float thresh, int minimum_mode) {
  prelude<true>(boxes, valid, keep, n, thresh, minimum_mode);
}

}  // namespace

extern "C" int profile_k2_prelude(int hits, const void* boxes, const void* valid, void* keep,
                                  int p, int n, float thresh, int minimum_mode, void* stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, n, stream, &attr);
  const float4* b = static_cast<const float4*>(boxes);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* k = static_cast<uint8_t*>(keep);
  const cudaError_t err =
      hits ? cudaLaunchKernelEx(&cfg, nms_greedy_prelude_kernel, b, v, k, n, thresh, minimum_mode)
           : cudaLaunchKernelEx(&cfg, nms_greedy_stage_kernel, b, v, k, n, thresh, minimum_mode);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
"""


# K3's walk alone: track_assoc.cu's walk() (phase B) on `rows` rows of keys
# copied into shared memory, `reps` times, by warp 0, as the kernel walks
WALK_CU = r"""
#include "track_assoc.cu"

namespace {

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
k3_walk_kernel(const uint32_t* keys, const int* visit, int* res, int rows, int n, int reps,
               uint32_t thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem);
  int* order = reinterpret_cast<int*>(tile + rows * 32 * K);
  int* out = order + rows;
  for (int e = threadIdx.x; e < rows * 32 * K; e += kThreads) tile[e] = keys[e];
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    order[i] = visit[i];
    out[i] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  uint32_t acc = 0u;
  if (threadIdx.x < 32) {
    uint32_t all = 0u;
    for (int k = 0; k < K; ++k) all |= (lane * K + k < n ? 1u : 0u) << k;
    for (int rep = 0; rep < reps; ++rep) acc ^= walk<K>(tile, order, out, 0, rows, all, thr, lane);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += kThreads) res[i] = out[i];
  if (threadIdx.x < 32) res[rows + lane] = static_cast<int>(acc);  // keeps the walks alive
}

template <int K>
cudaError_t launch_walk(const uint32_t* keys, const int* visit, int* res, int rows, int n,
                        int reps, uint32_t thr, cudaStream_t stream) {
  const size_t bytes = (static_cast<size_t>(rows) * 32 * K + 2 * rows) * 4;
  cudaError_t err = cudaFuncSetAttribute(k3_walk_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  k3_walk_kernel<K><<<1, kThreads, bytes, stream>>>(keys, visit, res, rows, n, reps, thr);
  return cudaGetLastError();
}

// The shared-memory variant's code with the T-sized part of its layout
// (slot state and lists) in device memory at `state` and only the frame's
// part in shared memory
template <int K>
__global__ void __launch_bounds__(kThreads, 1)
k3_state_global_kernel(const Args a, unsigned char* state) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared s;
  carve_state(state, a.t, &s);
  carve_frame(smem, a.n, a.rows, &s);
  associate<K>(a, s);
}

template <int K>
cudaError_t launch_state_global(const Args& a, unsigned char* state, cudaStream_t stream) {
  Shared s;
  const size_t bytes = carve_frame(nullptr, a.n, a.rows, &s);
  cudaError_t err = cudaFuncSetAttribute(k3_state_global_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  k3_state_global_kernel<K><<<1, kThreads, bytes, stream>>>(a, state);
  return cudaGetLastError();
}

}  // namespace

extern "C" int profile_k3_lane_dets(int n) { return lane_dets(n); }

extern "C" long long profile_k3_state_bytes(int t) {
  Shared s;
  return static_cast<long long>(carve_state(nullptr, t, &s));
}

// ptrs: fdt_track_associate's 19 pointers; state: profile_k3_state_bytes(t)
// bytes; rows a tile as many as fit beside the frame's part, at most T
extern "C" int profile_k3_state_global(const void* const* ptrs, void* state, int t, int f,
                                       int n, float sigma_iou, float sigma_dis, float sigma_h,
                                       int t_min, int use_iou, void* stream, int* rows_out) {
  if (t < 1 || n < 1 || n > kMaxN || f < 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  Shared s;
  const long long fixed = static_cast<long long>(carve_frame(nullptr, n, 0, &s));
  const long long row = static_cast<long long>(carve_frame(nullptr, n, 1, &s)) - fixed;
  const int rows = static_cast<int>(std::min<long long>(t, (optin - fixed) / row));
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  *rows_out = rows;
  const Args a = make_args(*reinterpret_cast<const void* const (*)[19]>(ptrs), t, f, n, rows,
                           sigma_iou, sigma_dis, sigma_h, t_min, use_iou);
  unsigned char* st = static_cast<unsigned char*>(state);
  const cudaStream_t sm = static_cast<cudaStream_t>(stream);
  switch (lane_dets(n)) {
    case 1: return static_cast<int>(launch_state_global<1>(a, st, sm));
    case 2: return static_cast<int>(launch_state_global<2>(a, st, sm));
    case 4: return static_cast<int>(launch_state_global<4>(a, st, sm));
    case 8: return static_cast<int>(launch_state_global<8>(a, st, sm));
    case 16: return static_cast<int>(launch_state_global<16>(a, st, sm));
    default: return static_cast<int>(launch_state_global<32>(a, st, sm));
  }
}

extern "C" int profile_k3_walk(const void* keys, const void* visit, void* res, int rows, int n,
                               int reps, unsigned thr, void* stream) {
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const int* v = static_cast<const int*>(visit);
  int* r = static_cast<int*>(res);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lane_dets(n)) {
    case 1: return static_cast<int>(launch_walk<1>(k, v, r, rows, n, reps, thr, st));
    case 2: return static_cast<int>(launch_walk<2>(k, v, r, rows, n, reps, thr, st));
    case 4: return static_cast<int>(launch_walk<4>(k, v, r, rows, n, reps, thr, st));
    case 8: return static_cast<int>(launch_walk<8>(k, v, r, rows, n, reps, thr, st));
    case 16: return static_cast<int>(launch_walk<16>(k, v, r, rows, n, reps, thr, st));
    default: return static_cast<int>(launch_walk<32>(k, v, r, rows, n, reps, thr, st));
  }
}
"""
# K3 with its phase clocks (FDT_K3_TRACE): the library's own sources, one TU
TRACE_CU = r"""
#include "track_assoc.cu"
"""
TRACE_PHASES = ("stage_wait", "live_rank", "first_tile", "walk", "apply_count", "free",
                "spawn")
WALK_REPS = 64
WALK_SMEM = 200 * 1024  # the most shared memory a walk-alone launch takes


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def _build_tree(tree: pathlib.Path):
    """Build the tree's kernels; (its _build module, nvcc's output)."""
    sys.path.insert(0, str(tree))
    from fdt_torch.ops import _build

    if pathlib.Path(_build.__file__).resolve().parents[2] != tree:
        raise RuntimeError(f"imported {_build.__file__}, not the tree {tree}")
    log = _build.build(fresh=True)
    _build.library()
    return _build, log


def ptxas_lines(log: str,
                pattern: str = r"(track_assoc_(?:smem_|global_)?kernel)(?:ILi(\d+)E)?") -> dict:
    """Registers, spills and static shared memory that `nvcc -Xptxas -v`
    reports for each kernel whose (mangled) name matches pattern."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            found = re.search(pattern, entry.group(1))
            name = (found.group(1) + (f"<{found.group(2)}>" if found.group(2) else "")
                    if found else None)
        elif name and "spill" in line:
            out.setdefault(name, {})["spills"] = line.strip()
        elif name and "registers" in line:
            used = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(name, {}).update(registers=int(used.group(1)) if used else None,
                                            static_smem=int(smem.group(1)) if smem else 0)
    return out


def k3_lines(tree: pathlib.Path, log: str) -> list[dict]:
    """chip_smoke.k3_timings on each case of chip_smoke.K3_TIMED with the
    tree's kernels (the plain version only at bench density, where it is
    checked bit for bit first), with the dependent steps' ns and ptxas'
    report."""
    import torch

    chip_smoke = _chip_smoke()
    device = torch.device("cuda", 0)
    ptxas = ptxas_lines(log)
    lines = []
    for case in chip_smoke.K3_TIMED:
        k3 = chip_smoke.k3_timings(device, *chip_smoke.k3_timed_case(case),
                                   plain=case == "bench-16x32-t256")
        device_ns = None if k3["device_ms"] is None else k3["device_ms"] * 1e6
        lines.append({"tree": str(tree), "card": torch.cuda.get_device_name(0), "kernel": "k3",
                      "case": case, **k3,
                      "device_ns_per_step": device_ns and device_ns / k3["steps_per_chunk"],
                      "ptxas": ptxas})
    return lines


# the int8 path's kernels in a tree's ptxas report: K4 (either variant) and
# K5 (the one-launch kernel, or the two of a checkout from before it)
INT8_KERNELS = (r"(conv_int8_(?:wgmma_)?kernel|amax_kernel|quantize_\w*?kernel)"
                r"(?:I(.*?)EEv)?")


def int8_lines(tree: pathlib.Path, log: str, kernel: str) -> list[dict]:
    """The per-conv sweep of K4 and K5 (kernel "k4") or K5 alone ("k5") over
    one detect of the bf16 int8 flagship at batch 8, 640², with the tree's
    kernels; then the batch's sums and ptxas' report."""
    import torch

    from fdt_torch.ops import _build

    chip_smoke = _chip_smoke()
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models import load_pyramidbox

    device = torch.device("cuda", 0)
    det = PyramidBoxDetector(load_pyramidbox(str(chip_smoke.WEIGHTS)), dtype=torch.bfloat16,
                             device=device, quant="int8")
    staged = torch.from_numpy(chip_smoke.flagship_batch()).to(device)
    det.detect_device(staged, 0.35, 0.35)
    timed, sums = chip_smoke.int8_timings(det, staged, select=list, plain=False, cudnn=False)
    card = torch.cuda.get_device_name(0)
    lines = []
    for i, t in enumerate(timed):
        if kernel == "k5":
            t = {k: v for k, v in t.items()
                 if k.startswith(("k5", "forward")) or k in ("shape", "class")}
        lines.append({"tree": str(tree), "card": card, "kernel": kernel, "conv": i, **t})

    def device_sum(key, rows):  # the convs whose kernel the profiler caught
        return sum(t[key] for t in rows if t[key] is not None)

    classes = sorted({t["class"] for t in timed})
    total = {"tree": str(tree), "card": card, "kernel": kernel, "convs": len(timed),
             "k5_ms": sum(t["k5_ms"] for t in timed),
             "k5_host_ms": sum(t["k5_host_ms"] for t in timed),
             "forward_host_ms": sum(t["forward_host_ms"] for t in timed),
             "k5_device_ms": device_sum("k5_device_ms", timed),
             "k5_device_missed": sum(t["k5_device_ms"] is None for t in timed),
             "k5_bound_ms": sums["k5_bound_ms"]}
    if kernel == "k4":
        refused = [t for t in timed if str(t["int_mm_ms"]).startswith("refused")]
        total.update(
            k4_ms=sum(t["k4_ms"] for t in timed),
            k4_host_ms=sum(t["k4_host_ms"] for t in timed),
            k4_device_ms=device_sum("k4_device_ms", timed),
            k4_device_missed=sum(t["k4_device_ms"] is None for t in timed),
            k4_device_ms_by_variant={
                v: device_sum("k4_device_ms", [t for t in timed if t["variant"] == v])
                for v in sums["k4_bound_ms"]},
            k4_device_ms_by_class={
                c: device_sum("k4_device_ms", [t for t in timed if t["class"] == c])
                for c in classes},
            k4_ms_by_variant={v: sum(t["k4_ms"] for t in timed if t["variant"] == v)
                              for v in sums["k4_bound_ms"]},
            k4_ms_by_class={c: sum(t["k4_ms"] for t in timed if t["class"] == c)
                            for c in classes},
            k4_bound_ms=sum(sums["k4_bound_ms"].values()),
            k4_bound_ms_by_variant=sums["k4_bound_ms"], convs_by_variant=sums["convs"],
            k4_ops_bound_ms=sums["k4_ops_bound_ms"],
            int_mm_ms=sum(float(t["int_mm_ms"]) for t in timed if t not in refused),
            int_mm_refused=len(refused),
            k4_ms_where_int_mm=sum(t["k4_ms"] for t in timed if t not in refused))
    # dynamic shared memory, which ptxas does not report (a tree with the
    # wgmma variant only)
    lib = _build.library()
    if hasattr(lib, "fdt_conv_int8_wgmma_smem"):
        total["wgmma_dynamic_smem"] = {t: lib.fdt_conv_int8_wgmma_smem(t) for t in (8, 64, 128, 256)}
    lines.append({**total, "ptxas": ptxas_lines(log, INT8_KERNELS)})
    return lines


def run_tree(tree: pathlib.Path, kernel: str) -> list[dict]:
    """Build the tree's kernels and time one of them (in this process)."""
    import torch

    _, log = _build_tree(tree)
    if kernel == "k3":
        return k3_lines(tree, log)
    if kernel in ("k4", "k5"):
        return int8_lines(tree, log, kernel)
    chip_smoke = _chip_smoke()
    timings = chip_smoke.k1_timings() if kernel == "k1" else chip_smoke.k2_timings()
    name = torch.cuda.get_device_name(0)
    return [{"tree": str(tree), "card": name, "kernel": kernel, "case": case, **result}
            for case, result in timings.items()]


def _walk_keys(rows: int, n: int, k: int, seed: int):
    """Rows of IoU keys as the kernel lays them out (detection j at lane
    j // K, word j % K; padding 0): a third of the detections overlap the
    slot (0.3 to 1), the rest do not (0), so that some steps match."""
    import numpy as np

    rng = np.random.RandomState(seed)
    iou = np.where(rng.rand(rows, n) < 1 / 3, rng.uniform(0.3, 1.0, (rows, n)), 0.0)
    keys = np.zeros((rows, 32 * k), np.uint32)
    keys[:, :n] = iou.astype(np.float32).view(np.uint32) | np.uint32(0x80000000)
    laid = keys.reshape(rows, 32, k).transpose(0, 2, 1).reshape(rows, 32 * k)
    return laid, np.float32(0.4).view(np.uint32) | np.uint32(0x80000000)


def k3_trace_lines(_build) -> list[dict]:
    """This checkout's K3 built with FDT_K3_TRACE, run through the wrapper
    on each case of chip_smoke.K3_TIMED: clock64 cycles a frame by phase
    (thread 0's view, after each phase's barrier; the first frame's stage
    and wait also hold the launch's state load)."""
    import torch

    chip_smoke = _chip_smoke()
    src = _build.BUILD_DIR / "k3_trace.cu"
    lib_path = _build.BUILD_DIR / "libk3_trace.so"
    src.write_text(TRACE_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DFDT_K3_TRACE", "-I",
                    str(_build.CSRC_DIR), "-shared", "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, timeout=_build.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(str(lib_path))
    lib.fdt_track_associate.argtypes = _build.SIGNATURES["fdt_track_associate"]
    lib.fdt_track_trace.argtypes = [ctypes.c_void_p]
    from fdt_torch.geometry.track import init_slots
    from fdt_torch.ops import track as track_op

    device = torch.device("cuda", 0)
    built, _build._lib = _build._lib, lib
    lines = []
    try:
        for case in chip_smoke.K3_TIMED:
            cfg, t_max, chunks = chip_smoke.k3_timed_case(case)
            tensors = [[torch.from_numpy(a).to(device) for a in c] for c in chunks]
            cycles = (ctypes.c_ulonglong * 8)()
            runs = 5
            for rep in range(runs + 1):
                if rep == 1:  # the first run warms up
                    torch.cuda.synchronize()
                    lib.fdt_track_trace(cycles)
                slots = init_slots(t_max, device)
                for c in tensors:
                    slots, *_ = track_op.associate_chunk(slots, *c, cfg)
            torch.cuda.synchronize()
            if lib.fdt_track_trace(cycles):
                raise RuntimeError("fdt_track_trace failed")
            frames = runs * sum(c[2].shape[0] for c in chunks)
            per_frame = {p: cycles[i] / frames for i, p in enumerate(TRACE_PHASES)}
            lines.append({"tree": str(REPO), "card": torch.cuda.get_device_name(0),
                          "kernel": "k3", "case": case, "trace_frames": frames,
                          "cycles_per_frame": per_frame,
                          "cycles_per_frame_total": sum(per_frame.values())})
    finally:
        _build._lib = built
    return lines


def k3_state_lines(lib) -> list[dict]:
    """This checkout's shared-memory variant with its slot state and lists
    in device memory (profile_k3_state_global) on each case of
    chip_smoke.K3_TIMED and at t-over-smem: bit-equal to the plain version
    in records and state after every chunk, then its device ms a chunk
    beside that of the kernel the wrapper launches (torch.profiler)."""
    import torch

    from fdt_torch.geometry.track import _Slots, associate_chunk_plain, init_slots
    from fdt_torch.ops import track as track_op

    chip_smoke = _chip_smoke()
    device = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream

    def associate(slots, boxes, scores, valid, cfg):
        (f, n), t = valid.shape, slots.alive.shape[0]
        new = _Slots(**{k: torch.empty_like(v) for k, v in vars(slots).items()})
        out = [torch.empty((f, t), dtype=torch.int32, device=device),
               torch.empty((f, t), dtype=torch.bool, device=device),
               torch.empty((f, n), dtype=torch.int32, device=device),
               torch.empty((f,), dtype=torch.int32, device=device)]
        state = torch.empty(lib.profile_k3_state_bytes(t), dtype=torch.uint8, device=device)
        ptrs = (ctypes.c_void_p * 19)(*[x.data_ptr() for x in (
            *vars(slots).values(), boxes, scores, valid, *vars(new).values(), *out)])
        rows = ctypes.c_int(0)
        err = lib.profile_k3_state_global(ptrs, state.data_ptr(), t, f, n, cfg.sigma_iou,
                                          cfg.sigma_dis, cfg.sigma_h, cfg.t_min,
                                          int(cfg.use_iou), stream, ctypes.byref(rows))
        if err:
            raise RuntimeError(f"profile_k3_state_global: CUDA error {err}")
        return new, *out

    cases = [(case, chip_smoke.k3_timed_case(case)) for case in chip_smoke.K3_TIMED]
    cases.append(("t-over-smem", chip_smoke.track_edge_case("t-over-smem")))
    lines = []
    for case, (cfg, t_max, chunks) in cases:
        tensors = [[torch.from_numpy(a).to(device) for a in c] for c in chunks]
        got, want = init_slots(t_max, device), init_slots(t_max, device)
        for c in tensors:
            got, *records = associate(got, *c, cfg)
            want, *expect = associate_chunk_plain(want, *c, cfg)
            if not all(torch.equal(g, w) for g, w in zip(
                    [*records, *vars(got).values()], [*expect, *vars(want).values()])):
                raise AssertionError(f"state in device memory != plain at {case}")

        def device_ms(fn, pattern):
            def run():
                slots = init_slots(t_max, device)
                for c in tensors:
                    slots, *_ = fn(slots, *c, cfg)
            split, _ = chip_smoke._device_split(run, pattern=pattern)
            return sum(s["us"] for s in split.values()) / 1e3 / len(chunks) if split else None

        lines.append({"tree": str(REPO), "card": torch.cuda.get_device_name(0), "kernel": "k3",
                      "case": case, "t": t_max, "n": chunks[0][2].shape[1],
                      "state_bytes": lib.profile_k3_state_bytes(t_max),
                      "wrapper_rows": chip_smoke.k3_rows(t_max, chunks[0][2].shape[1]),
                      "wrapper_device_ms": device_ms(track_op.associate_chunk,
                                                     chip_smoke.K3_KERNELS),
                      "state_in_device_memory_ms": device_ms(associate,
                                                             r"k3_state_global_kernel")})
    return lines


def k3_walk_lines() -> list[dict]:
    """This checkout's K3 walk alone on each case of chip_smoke.K3_TIMED:
    rows of keys at the case's N (its mean live slots a frame, as many as
    WALK_SMEM holds), walked WALK_REPS times; ns a dependent step = (device
    time of that launch - that of a launch that walks 0 times) / (reps ×
    rows); the chain floor = the case's steps a chunk at that time.  Then
    k3_trace_lines and k3_state_lines."""
    import torch

    _build, _ = _build_tree(REPO)

    chip_smoke = _chip_smoke()
    src = _build.BUILD_DIR / "k3_walk.cu"
    lib_path = _build.BUILD_DIR / "libk3_walk.so"
    src.write_text(WALK_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-shared",
                    "-o", str(lib_path), str(src)], check=True, capture_output=True,
                   timeout=_build.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(str(lib_path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.profile_k3_walk.argtypes = [P, P, P, I, I, I, ctypes.c_uint, P]
    lib.profile_k3_lane_dets.argtypes = [I]
    lib.profile_k3_state_bytes.argtypes = [I]
    lib.profile_k3_state_bytes.restype = ctypes.c_longlong
    lib.profile_k3_state_global.argtypes = [P, P, I, I, I, F, F, F, I, I, P, P]
    device = torch.device("cuda", 0)
    lines = []
    for case in chip_smoke.K3_TIMED:
        cfg, t_max, chunks = chip_smoke.k3_timed_case(case)
        n = chunks[0][2].shape[1]
        k = lib.profile_k3_lane_dets(n)
        work = chip_smoke.k3_work(cfg, t_max, chunks)
        frames = sum(c[2].shape[0] for c in chunks)
        rows = max(1, min(round(work["steps"] / frames), WALK_SMEM // (4 * (32 * k + 2))))
        keys, thr = _walk_keys(rows, n, k, seed=rows)
        keys = torch.from_numpy(keys).to(device)
        visit = torch.randperm(rows, generator=torch.Generator().manual_seed(0)).int().to(device)
        res = torch.empty(rows + 32, dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream().cuda_stream

        def walked(reps):
            def call():
                err = lib.profile_k3_walk(keys.data_ptr(), visit.data_ptr(), res.data_ptr(),
                                          rows, n, reps, int(thr), stream)
                if err:
                    raise RuntimeError(f"profile_k3_walk: CUDA error {err}")
            split, _ = chip_smoke._device_split(call, pattern=r"k3_walk_kernel")
            return sum(s["us"] for s in split.values()) if split else None

        base, full = walked(0), walked(WALK_REPS)
        ns = None if base is None or full is None else (full - base) * 1e3 / (WALK_REPS * rows)
        steps = work["steps"] / len(chunks)
        smem_rows = chip_smoke.k3_rows(t_max, n)
        lines.append({"tree": str(REPO), "card": torch.cuda.get_device_name(0), "kernel": "k3",
                      "case": case, "walk_rows": rows, "walk_reps": WALK_REPS, "n": n,
                      "lane_dets": k, "walk_us_0_reps": base, "walk_us": full,
                      "walk_ns_per_step": ns, "steps_per_chunk": steps,
                      "chain_floor_ms": ns and ns * steps / 1e6,
                      "smem_rows": smem_rows,
                      "smem_bytes": _build.library().fdt_track_smem_bytes(t_max, n,
                                                                          smem_rows)})
    return lines + k3_trace_lines(_build) + k3_state_lines(lib)


def k2_design_lines() -> list[dict]:
    """This checkout's K2: chip_smoke.k2_design and its prelude's device
    time, staging alone and with the hit words, beside the whole kernel's
    (torch.profiler, µs a call)."""
    import torch

    _build, _ = _build_tree(REPO)
    chip_smoke = _chip_smoke()
    src = _build.BUILD_DIR / "k2_prelude.cu"
    lib_path = _build.BUILD_DIR / "libk2_prelude.so"
    src.write_text(PRELUDE_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-shared",
                    "-o", str(lib_path), str(src)], check=True, capture_output=True,
                   timeout=_build.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(str(lib_path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.profile_k2_prelude.argtypes = [I, P, P, P, I, I, F, I, P]
    from fdt_torch.ops import nms as nms_op

    design = chip_smoke.k2_design()
    lines = []
    for case, (seed, p, n, spread, mode, thresh) in chip_smoke.K2_TIMED.items():
        boxes, valid, _ = chip_smoke._nms_case(seed, p, n, spread, False)
        keep = torch.empty(valid.shape, dtype=torch.uint8, device=boxes.device)
        stream = torch.cuda.current_stream().cuda_stream

        def part(hits):
            def call():
                err = lib.profile_k2_prelude(hits, boxes.data_ptr(), valid.data_ptr(),
                                             keep.data_ptr(), p, n, thresh,
                                             nms_op._MODES[mode], stream)
                if err:
                    raise RuntimeError(f"profile_k2_prelude: CUDA error {err}")
            split, _ = chip_smoke._device_split(call)
            return sum(s["us"] for s in split.values()) if split else None

        whole, _ = chip_smoke._device_split(
            lambda: nms_op.nms_keep_greedy(boxes, valid, thresh, mode=mode))
        lines.append({"tree": str(REPO), "card": torch.cuda.get_device_name(0), "kernel": "k2",
                      "case": case, **design[case], "stage_us": part(0),
                      "stage_and_hit_words_us": part(1),
                      "kernel_us": sum(s["us"] for s in whole.values()) if whole else None})
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("k1", "k2", "k3", "k4", "k5"), default="k1")
    ap.add_argument("--tree", action="append", type=pathlib.Path,
                    help="checkout root whose fdt_torch is timed (repeatable)")
    ap.add_argument("--one", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--design", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", type=pathlib.Path, help="also write the lines here")
    args = ap.parse_args()
    if args.one or args.design:  # a child process: one tree, or this checkout's design
        if args.design:
            lines = k2_design_lines() if args.kernel == "k2" else k3_walk_lines()
        else:
            lines = run_tree(args.one.resolve(), args.kernel)
        for line in lines:
            print(json.dumps(line), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profile_nms: CUDA is not available", file=sys.stderr)
        return 2
    children = [["--one", str(tree), "--kernel", args.kernel] for tree in args.tree or [REPO]]
    if args.kernel in ("k2", "k3"):
        children.append(["--design", "--kernel", args.kernel])
    lines = []
    for child in children:
        proc = subprocess.run([sys.executable, __file__, *child], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        lines += [line for line in proc.stdout.splitlines() if line.startswith("{")]
    for line in lines:
        print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
