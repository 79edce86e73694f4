"""Build the port's CUDA sources into one shared library and load it.

`nvcc` compiles every `.cu` file under fdt_torch/csrc for sm_90a, one
process per source, all started together, and links the objects into
`fdt_torch/_build/libfdt_kernels.so`, a library with a plain C interface that
ctypes loads.  PyTorch's headers are not included, so a build takes seconds.
The build runs at first use, under a time limit, and is skipped when the
library is newer than every source and header.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
import time

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_PATH = BUILD_DIR / "libfdt_kernels.so"
BUILD_TIMEOUT_S = 300

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C functions of the library: name → argument types (every one returns int:
# a CUDA error code, or the count its name says)
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_B = ctypes.c_char_p  # a bytes object, passed without a copy
SIGNATURES = {
    # boxes, valid, seg, scratch, keep, p, n, thresh, minimum_mode, out_k, stream
    "fdt_nms_tiled": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    # n → int64 words of scratch a problem of n boxes needs
    "fdt_nms_tiled_scratch_words": [_I],
    # chunk start word, words → the chunk's end word
    "fdt_nms_tiled_chunk_end": [_I, _I],
    # chunk start word → row words of earlier chunks a mask block walks
    "fdt_nms_tiled_cross_words": [_I],
    # boxes, valid, keep, p, n, thresh, minimum_mode, stream
    "fdt_nms_greedy": [_P, _P, _P, _I, _I, _F, _I, _P],
    # → blocks a problem (the cluster size)
    "fdt_nms_greedy_cluster": [],
    # n → clusters the card runs at once for problems of n boxes (< 0: CUDA error)
    "fdt_nms_greedy_max_clusters": [_I],
    # slot state in (last_box, max_score, length, order, alive, next_key),
    # boxes, scores, valid, slot state out (the same six), assign, finish,
    # spawn, overflow, scratch; t, f, n, sigma_iou, sigma_dis, sigma_h,
    # t_min, use_iou, stream, int* rows a tile it took (0: device-memory variant)
    "fdt_track_associate": [_P] * 20 + [_I, _I, _I, _F, _F, _F, _I, _I, _P, _P],
    # t, n → rows a tile fdt_track_associate takes (0: the device-memory
    # variant; < 0: CUDA error)
    "fdt_track_rows": [_I, _I],
    # K5 and K4: one buffer of packed 64-bit fields (quant.py's _QUANT_ARGS,
    # _CONV_ARGS; the QuantArgs and ConvArgs structs of the sources)
    "fdt_quantize_int8": [_B],
    "fdt_conv_int8": [_B],
    "fdt_conv_int8_wgmma": [_B],
    # elements, is_bf16 → blocks of a fdt_quantize_int8 call (< 0: CUDA error)
    "fdt_quantize_int8_grid": [_I, _I],
    # tile_n → bytes of dynamic shared memory a block of the wgmma variant takes
    "fdt_conv_int8_wgmma_smem": [_I],
}
# C functions that return another type than int
RESTYPES = {
    # t, n, rows → bytes of shared memory fdt_track_associate takes
    "fdt_track_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _run_all(cmds: list[list[str]], deadline: float) -> str:
    """Run the commands at once; return their joined output.  Raises
    RuntimeError when one fails or the deadline passes, after killing and
    reaping every process still running."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 0.0))[0]
                for p in procs]
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc exceeded {BUILD_TIMEOUT_S}s: {' '.join(e.cmd)}") from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{log}")
    return "".join(logs)


def build(fresh: bool = False) -> str:
    """Compile the kernels if needed; return nvcc's output ('' if up to date).

    fresh=True removes the build directory first.  Raises RuntimeError when
    nvcc fails or the build exceeds BUILD_TIMEOUT_S seconds.
    """
    if fresh:
        shutil.rmtree(BUILD_DIR, ignore_errors=True)
    sources = _sources()
    inputs = sources + sorted(CSRC_DIR.glob("*.cuh"))
    if LIB_PATH.exists() and all(LIB_PATH.stat().st_mtime >= s.stat().st_mtime
                                 for s in inputs):
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    deadline = time.monotonic() + BUILD_TIMEOUT_S
    tag = os.getpid()
    objects = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
    tmp = BUILD_DIR / f"{LIB_PATH.name}.{tag}.tmp"
    nvcc = _nvcc()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(sources, objects)], deadline)
        log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objects)]],
                        deadline)
        tmp.replace(LIB_PATH)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for o in objects:
            o.unlink(missing_ok=True)
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, (argtypes, restype) in RESTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib
