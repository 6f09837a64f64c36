"""Build and load the CUDA kernels of csrc/ (nvcc -> shared library -> ctypes).

At first use, nvcc compiles every ``csrc/*.cu`` into
``yaha_tpu_torch/_build/libyaha_sw.so`` for sm_90a; the library is rebuilt
when a source is newer.  The sources have a plain C interface, so no
PyTorch header is compiled and a build takes seconds.  A missing nvcc or a
failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes as ct
import functools
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libyaha_sw.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()

_vp = ct.c_void_p
_i64 = ct.c_int64
_i32 = ct.c_int32


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "yaha_tpu_torch need the CUDA toolkit to build")


def build():
    """Compile the library if it is missing or older than a source.
    Returns the seconds spent compiling (0.0 when it was current)."""
    with _lock:
        srcs = _sources()
        if (os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >=
                max(os.path.getmtime(s) for s in srcs)):
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ([_nvcc()] + NVCC_FLAGS + ["-o", tmp] +
               [s for s in srcs if s.endswith(".cu")])
        t0 = time.perf_counter()
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("nvcc failed (%d): %s\n%s" % (
                    res.returncode, " ".join(cmd), res.stderr[-4000:]))
            os.replace(tmp, LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return time.perf_counter() - t0


@functools.cache
def load():
    """The kernel library with its C signatures declared (built first)."""
    build()
    lib = ct.CDLL(LIB_PATH)
    lib.yt_ext_forward.restype = ct.c_int
    lib.yt_ext_forward.argtypes = (
        [_vp] * 4 + [_i64] * 3 + [_i32] * 8 + [_vp] * 6)
    lib.yt_anch_full.restype = ct.c_int
    lib.yt_anch_full.argtypes = (
        [_vp] * 6 + [_i64] * 3 + [_i32] * 6 + [_vp] * 4)
    lib.yt_anch_banded.restype = ct.c_int
    lib.yt_anch_banded.argtypes = (
        [_vp] * 6 + [_i64] * 3 + [_i32] * 7 + [_vp] * 4)
    return lib
