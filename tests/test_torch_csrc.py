"""The CUDA extension kernels' per-problem bodies, built as C++ on the CPU.

The bodies in yaha_tpu_torch/csrc are __host__ __device__: without
__CUDACC__ they compile with g++.  A small C loop over problems (C_LOOP
below) is built with them into a shared library under the test's
temporary directory and called through ctypes, and its outputs are held to
the plain PyTorch version sw_cuda.extension_forward_reference, with
tolerance zero (integer arrays, the whole backtrack plane included):

  * ext_problem_reg<W>, the register-band body of csrc/ext_kernels.cu, for
    W in {13, 21, 33} (-BW 3, 5, 8), run row by row as a lone problem and
    with every row on its predicated path, as a lane does when another lane
    of its warp needs that path;
  * ext_problem, the global-scratch body of csrc/sw_kernels.cu;

on the EXT_SWEEP inputs of tests/torch_dp_cases.py, the int32-wrap inputs
(KW_WRAP) and references shorter than qlen + 2*bw2 (the rows whose band
ends before the last column).  The test skips only where g++ is missing.
"""
import ctypes as ct
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from torch_dp_cases import EXT_SWEEP, EXT_SWEEP_IDS, KW, KW_WRAP, \
    extension_inputs
from yaha_tpu_torch.ops import sw_cuda

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "yaha_tpu_torch", "csrc")

C_LOOP = r"""
#include "sw_kernels.cu"
#include "ext_kernels.cu"

// variant 0: ext_problem (scratch [3][W+2][N]); 1: ext_problem_reg<W>;
// 2: ext_problem_reg<W> with every row predicated.
extern "C" int run_ext(int variant, const uint8_t* q, const uint8_t* r,
                       const int32_t* qlens, const int32_t* rlens,
                       int64_t n, int64_t ql, int64_t rl, int32_t bw2,
                       const int32_t* kw, int8_t* bt, int32_t* score,
                       int32_t* maxi, int32_t* maxj, int32_t* scratch) {
    ytsw::Scoring s;
    s.go = kw[0];
    s.ge = kw[1];
    s.rc = kw[2];
    s.ms = kw[3];
    s.max_gap = kw[4];
    s.max_intron = kw[5];
    const int32_t xc = kw[6];
    for (int64_t p = 0; p < n; p++) {
        if (variant == 0) {
            ytsw::ext_problem(p, n, q, ql, r, rl, qlens, rlens, bw2, s, xc,
                              bt, score, maxi, maxj, scratch);
            continue;
        }
        const bool pred = variant == 2;
        switch (2 * bw2 + 1) {
        case 13:
            ytsw::ext_problem_reg<13>(p, q, ql, r, rl, qlens, rlens, s, xc,
                                      bt, score, maxi, maxj, pred);
            break;
        case 21:
            ytsw::ext_problem_reg<21>(p, q, ql, r, rl, qlens, rlens, s, xc,
                                      bt, score, maxi, maxj, pred);
            break;
        case 33:
            ytsw::ext_problem_reg<33>(p, q, ql, r, rl, qlens, rlens, s, xc,
                                      bt, score, maxi, maxj, pred);
            break;
        default:
            return 1;
        }
    }
    return 0;
}
"""

REG_WIDTHS = (13, 21, 33)
# (band_width, x_cutoff, max_gap, max_intron, err, scoring, short
# references); the register-body test sets band_width from W.
CASES = [sweep + (KW, False) for sweep in EXT_SWEEP] + [
    (5, 25, 50, 50, 0.15, KW_WRAP, False), (5, 25, 50, 50, 0.15, KW, True)]
CASE_IDS = EXT_SWEEP_IDS + ["wrap", "short_r"]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("csrc")
    src = d / "ext_loop.cpp"
    src.write_text(C_LOOP)
    so = d / "libext_loop.so"
    res = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                          "-I", CSRC, "-o", str(so), str(src)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    out = ct.CDLL(str(so))
    out.run_ext.restype = ct.c_int
    out.run_ext.argtypes = ([ct.c_int] + [ct.c_void_p] * 4 +
                            [ct.c_int64] * 3 + [ct.c_int32] +
                            [ct.c_void_p] * 6)
    return out


def _inputs(bw, err, short, seed):
    q, qlens, r, rlens = extension_inputs(seed, 300, 24, bw, err)
    if short:
        rng = np.random.default_rng(seed + 1)
        rlens = rng.integers(1, rlens + 1)
    return q, qlens.astype(np.int32), r, rlens.astype(np.int32)


def _run(lib, variant, bw, kw, q, qlens, r, rlens):
    n, ql = q.shape
    w = 4 * bw + 1
    out = {"bt": np.zeros((n, ql + 1, w), np.int8),
           "score": np.zeros(n, np.int32), "maxi": np.zeros(n, np.int32),
           "maxj": np.zeros(n, np.int32)}
    scratch = np.zeros((3, w + 2, n), np.int32)
    params = np.array([kw["go"], kw["ge"], kw["rc"], kw["ms"], kw["max_gap"],
                       kw["max_intron"], kw["x_cutoff"]], np.int32)
    arrays = [np.ascontiguousarray(a) for a in (q, r, qlens, rlens)]
    rc = lib.run_ext(variant, *(a.ctypes.data for a in arrays), n, ql,
                     r.shape[1], 2 * bw, params.ctypes.data,
                     *(out[k].ctypes.data for k in ("bt", "score", "maxi",
                                                    "maxj")),
                     scratch.ctypes.data)
    assert rc == 0
    return out


def _check(lib, variants, bw, case, seed):
    _, xc, mg, mi, err, scoring, short = case
    kw = dict(scoring, band_width=bw, x_cutoff=xc, max_gap=mg,
              max_intron=mi)
    q, qlens, r, rlens = _inputs(bw, err, short, seed)
    want = sw_cuda.extension_forward_reference(
        *(torch.from_numpy(a) for a in (q, qlens, r, rlens)), **kw)
    for variant in variants:
        got = _run(lib, variant, bw, kw, q, qlens, r, rlens)
        for key in ("score", "maxi", "maxj", "bt"):
            np.testing.assert_array_equal(
                got[key], want[key].numpy(),
                err_msg="variant %d %s" % (variant, key))
    return qlens, want


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("w", REG_WIDTHS)
def test_register_body_matches_plain(lib, w, case):
    bw = (w - 1) // 4
    qlens, want = _check(lib, (1, 2), bw, case, seed=w * 100 + case[1])
    if case[1] < 10:
        # The X-drop point exits early: most problems stop short of their
        # last query row.
        assert (want["maxi"].numpy() < qlens).mean() > 0.5


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_scratch_body_matches_plain(lib, case):
    _check(lib, (0,), case[0], case, seed=7 + case[1])


def test_ptxas_report_reads_registers_and_spills():
    """The build's ptxas -v lines, as chip_smoke.py reads them to refuse a
    register kernel that spills or uses a stack frame."""
    from yaha_tpu_torch.ops import _build
    name = "_ZN12_GLOBAL__N_114ext_reg_kernelILi21EEEvlPKhl"
    log = ("ptxas info    : 0 bytes gmem\n"
           "ptxas info    : Compiling entry function '%s' for 'sm_90a'\n"
           "ptxas info    : Function properties for %s\n"
           "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill "
           "loads\n"
           "ptxas info    : Used 168 registers, used 0 barriers, 440 bytes "
           "cmem[0]\n" % (name, name))
    assert _build.ptxas_report(log) == {name: {
        "stack": 8, "spill_stores": 4, "spill_loads": 12,
        "registers": 168}}
