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

# C functions of the library: name → argument types (every one returns int,
# a CUDA error code)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # boxes, valid, seg, mask, keep, p, n, thresh, minimum_mode, out_k, stream
    "fdt_nms_tiled": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    # boxes, valid, keep, p, n, thresh, minimum_mode, stream
    "fdt_nms_greedy": [_P, _P, _P, _I, _I, _F, _I, _P],
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
            _lib = lib
        return _lib
