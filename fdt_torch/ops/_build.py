"""Build the port's CUDA sources into one shared library and load it.

`nvcc` compiles every `.cu` file under fdt_torch/csrc for sm_90a into
`fdt_torch/_build/libfdt_kernels.so`, a library with a plain C interface that
ctypes loads.  PyTorch's headers are not included, so a build takes seconds.
The build runs at first use, under a subprocess timeout, and is skipped when
the library is newer than every source.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_PATH = BUILD_DIR / "libfdt_kernels.so"
BUILD_TIMEOUT_S = 300

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def build(fresh: bool = False) -> str:
    """Compile the kernels if needed; return nvcc's output ('' if up to date).

    fresh=True removes the build directory first.  Raises RuntimeError when
    nvcc fails or exceeds BUILD_TIMEOUT_S seconds.
    """
    if fresh:
        shutil.rmtree(BUILD_DIR, ignore_errors=True)
    sources = _sources()
    if LIB_PATH.exists() and all(LIB_PATH.stat().st_mtime >= s.stat().st_mtime
                                 for s in sources):
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_PATH.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc exceeded {BUILD_TIMEOUT_S}s: {' '.join(cmd)}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    tmp.replace(LIB_PATH)  # atomic: a concurrent loader never sees half a file
    return proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            fn = lib.fdt_nms_tiled
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_float, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib

