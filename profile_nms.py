#!/usr/bin/env python3
"""Time the greedy-NMS kernels K1 (nms_keep_tiled) or K2 (nms_keep_greedy)
of fdt_torch on one CUDA card.

    python3 profile_nms.py [--kernel k1|k2] [--tree DIR ...] [--out FILE]

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


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def _build_tree(tree: pathlib.Path):
    sys.path.insert(0, str(tree))
    from fdt_torch.ops import _build

    if pathlib.Path(_build.__file__).resolve().parents[2] != tree:
        raise RuntimeError(f"imported {_build.__file__}, not the tree {tree}")
    _build.build(fresh=True)
    _build.library()
    return _build


def run_tree(tree: pathlib.Path, kernel: str) -> list[dict]:
    """Build the tree's kernels and time one of them (in this process)."""
    import torch

    _build_tree(tree)
    chip_smoke = _chip_smoke()
    timings = chip_smoke.k1_timings() if kernel == "k1" else chip_smoke.k2_timings()
    name = torch.cuda.get_device_name(0)
    return [{"tree": str(tree), "card": name, "kernel": kernel, "case": case, **result}
            for case, result in timings.items()]


def k2_design_lines() -> list[dict]:
    """This checkout's K2: chip_smoke.k2_design and its prelude's device
    time, staging alone and with the hit words, beside the whole kernel's
    (torch.profiler, µs a call)."""
    import torch

    _build = _build_tree(REPO)
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
    ap.add_argument("--kernel", choices=("k1", "k2"), default="k1")
    ap.add_argument("--tree", action="append", type=pathlib.Path,
                    help="checkout root whose fdt_torch is timed (repeatable)")
    ap.add_argument("--one", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--design", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", type=pathlib.Path, help="also write the lines here")
    args = ap.parse_args()
    if args.one or args.design:  # a child process: one tree, or K2's design
        lines = k2_design_lines() if args.design else run_tree(args.one.resolve(), args.kernel)
        for line in lines:
            print(json.dumps(line), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profile_nms: CUDA is not available", file=sys.stderr)
        return 2
    children = [["--one", str(tree), "--kernel", args.kernel] for tree in args.tree or [REPO]]
    if args.kernel == "k2":
        children.append(["--design"])
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
