"""Build and load the CUDA kernels of csrc/ (nvcc -> shared library -> ctypes).

At first use, nvcc compiles every ``csrc/*.cu`` for sm_90a, one process
per source, all started together, and links the objects into
``yaha_tpu_torch/_build/libyaha_sw.so``; the library is rebuilt when a
source is newer.  The sources have a plain C interface, so no PyTorch
header is compiled and a build takes seconds.  A missing nvcc or a failed
build raises: there is no fallback.  ptxas reports every kernel's
registers, stack frame and spills (``-Xptxas -v``) into
``_build/ptxas.log``; ptxas_report() reads them.
"""
from __future__ import annotations

import ctypes as ct
import functools
import glob
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libyaha_sw.so")
PTXAS_LOG = os.path.join(BUILD_DIR, "ptxas.log")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

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
        nvcc = _nvcc()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            cus = [s for s in srcs if s.endswith(".cu")]
            objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                    for s in cus]
            cmds = [[nvcc] + NVCC_FLAGS + ["-Xptxas", "-v", "-c", "-o",
                                           obj, src]
                    for obj, src in zip(objs, cus)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for cmd in cmds]
            # Wait for every compile before reporting the first failure.
            results = [(cmd, p.communicate()[0], p.returncode)
                       for cmd, p in zip(cmds, procs)]
            lib = os.path.join(tmp, "lib.so")
            link = [nvcc] + NVCC_FLAGS + ["-shared", "-o", lib] + objs
            for cmd, err, rc in results:
                _check(cmd, rc, err)
            res = subprocess.run(link, capture_output=True, text=True)
            _check(link, res.returncode, res.stderr)
            with open(PTXAS_LOG, "w") as f:
                f.write("".join(out for _, out, _ in results))
            os.replace(lib, LIB_PATH)
        return time.perf_counter() - t0


def _check(cmd, rc, err):
    if rc != 0:
        raise RuntimeError("nvcc failed (%d): %s\n%s" % (
            rc, " ".join(cmd), err[-4000:]))


def ptxas_report(log=None):
    """{kernel (mangled name): {"registers", "stack", "spill_stores",
    "spill_loads"}} from ptxas's -v lines of the last build (or `log`)."""
    if log is None:
        with open(PTXAS_LOG) as f:
            log = f.read()
    out = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


@functools.cache
def load():
    """The kernel library with its C signatures declared (built first)."""
    build()
    lib = ct.CDLL(LIB_PATH)
    lib.yt_ext_forward_wide.restype = ct.c_int
    lib.yt_ext_forward_wide.argtypes = (
        [_vp] * 4 + [_i64] * 3 + [_i32] * 8 + [_vp] * 5)
    lib.yt_ext_forward_block.restype = ct.c_int
    lib.yt_ext_forward_block.argtypes = (
        [_vp] * 4 + [_i64] * 3 + [_i32] * 8 + [_vp] * 5)
    lib.yt_ext_forward_reg.restype = ct.c_int
    lib.yt_ext_forward_reg.argtypes = (
        [_vp] * 4 + [_i64] * 3 + [_i32] * 8 + [_vp] * 4 + [_i32, _vp])
    lib.yt_anch_full.restype = ct.c_int
    lib.yt_anch_full.argtypes = (
        [_vp] * 6 + [_i64] * 3 + [_i32] * 6 + [_vp] * 3)
    lib.yt_anch_banded.restype = ct.c_int
    lib.yt_anch_banded.argtypes = (
        [_vp] * 6 + [_i64] * 3 + [_i32] * 7 + [_vp] * 3)
    lib.yt_gather_problems.restype = ct.c_int
    lib.yt_gather_problems.argtypes = (
        [_vp, _i64, _i64, _vp, _i64, _vp] + [_i64] * 3 + [_i32] + [_vp] * 3)
    lib.yt_rle_walk.restype = ct.c_int
    lib.yt_rle_walk.argtypes = (
        [_vp] + [_i64] * 3 + [_vp] * 3 + [_i64, _i32] + [_vp] * 2 +
        [_i32, _i64, _vp])
    lib.yt_seed_hashes.restype = ct.c_int
    lib.yt_seed_hashes.argtypes = [_vp, _i64, _i64, _vp, _i32, _vp, _vp,
                                   _vp]
    lib.yt_expand_sort.restype = ct.c_int
    lib.yt_expand_sort.argtypes = (
        [_vp, _vp, _i64, _i64, _vp, _vp, _i32, _i32, _i64, _i64] +
        [_vp] * 7)
    lib.yt_merge_runs.restype = ct.c_int
    lib.yt_merge_runs.argtypes = [_vp, _vp, _i32, _i64, _i64] + [_vp] * 5
    lib.yt_chain_dp_cuda.restype = ct.c_int
    lib.yt_chain_dp_cuda.argtypes = [_vp] * 5 + [_i64] * 2 + [_i32] * 5 + \
        [_vp] * 5
    lib.yt_hits_clump.restype = ct.c_int
    lib.yt_hits_clump.argtypes = ([_vp, _vp, _i64, _i64, _vp, _vp] +
                                  [_i64] * 10 + [_i32, _vp, _i64, _vp, _vp])
    return lib
