"""The device seeder's fragments-to-clumps stage (csrc/clump_kernels.cu,
ops/clumps.py), built as C++ on the CPU.

clump_row, the kernel's body, is __host__ __device__ over an emulated
32-lane warp (`Lanes`: a loop over the lanes in place of the lane, the
ballots and shuffles over the loop's values): g++ builds it with a C loop
over rows (every row's shared memory filled with garbage first), and its
records are held to ops/clumps.hits_clumps_reference, which runs the
native yt_hits_to_clumps on each row, with tolerance zero: the record
length (meta) of every row, and every record's clumps, fragments and
skipped-region count.  The rows:

  * the golden L11 index's seed rows (tests/torch_dp_cases.seed_rows:
    readsC's 1 kb reads, sampled reads, wrapped windows) expanded and
    sorted by the plain seed phase, at tiers 1,024 and 8,192, as the
    seeder serves them (rows past the tier, or with wrapped windows, are
    not served);
  * 1 kb reads against a random reference at diagonals near 2^32: with
    substitutions, with indels, split in two, across copies of a repeat
    unit (many regions), with spurious hits, and reads whose region holds
    more fragments than the kernel's rounds take (flagged, -1);
  * dense regions of short overlapping fragments (equal scores at every
    step of the tie cascade when gap costs are 0, chops that persist into
    later rounds, clean-up erasures, regions exactly max_gap apart);
  * the edges: no hits, one hit, a fragment of min_match - 1 and
    min_match bases, diagonal steps of max_gap and max_gap + 1, qo steps
    of word_len and word_len + 1, diagonal 0xFFFFFFFF, n_hits below the
    row's hits, and a region past --max-region-frags (the valve's count);
  * 40 kb reads, whose stored scores wrap to int16 (the sequential fold)
    and, with max_query_length above 32,000, do not (the warp argmax);
  * records too long for their slot (flagged).

The plain version on the CPU is the seeder's clump path in
tests/test_torch_seeds.py and tests/test_torch_staged.py; the kernel on
the card is held to it in tests/test_torch_cuda.py.  The test skips only
where g++ is missing.
"""
import ctypes as ct
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from torch_dp_cases import (CLUMP_PARAMS, clump_dense_rows, clump_edge_rows,
                            clump_read_rows, clump_wrap_rows, golden_index,
                            parse_clump_record, seed_rows)
from yaha_tpu_torch.ops import clumps, seeds

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "yaha_tpu_torch", "csrc")

C_LOOP = r"""
#include "clump_kernels.cu"

#include <string.h>

#include <vector>

extern "C" {

// clump_row over every row, a fresh emulated warp's shared memory each,
// filled with garbage.
void run_hits_clump(const int32_t* diag, const int32_t* qo, int64_t rows,
                    int64_t width, const int32_t* n_hits,
                    const int32_t* q_len, const int64_t* ip, int32_t wide,
                    int32_t* rec, int64_t rec_width, int32_t* meta) {
    const ytsw::ClumpParams p = {ip[0], ip[1], ip[2], ip[3], ip[4], ip[5],
                                 ip[6], ip[7], ip[8], ip[9], wide};
    std::vector<unsigned char> buf(sizeof(ytsw::ClumpSmem));
    for (int64_t r = 0; r < rows; r++) {
        memset(buf.data(), 0xA5 ^ (int)(r & 0x7F), buf.size());
        ytsw::ClumpSmem& s = *(ytsw::ClumpSmem*)buf.data();
        meta[r] = (int32_t)ytsw::clump_row(
            (const uint32_t*)diag + r * width, qo + r * width, n_hits[r],
            q_len[r], p, s, rec + r * rec_width, rec_width);
    }
}

void clump_consts(int64_t* out) {
    out[0] = ytsw::kClumpRegion;
    out[1] = ytsw::kClumpCover;
    out[2] = ytsw::kClumpHead;
}

}  // extern "C"
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("clump_csrc")
    src = d / "clump_loop.cpp"
    src.write_text(C_LOOP)
    so = d / "libclump_loop.so"
    res = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                          "-I", CSRC, "-o", str(so), str(src)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    out = ct.CDLL(str(so))
    out.run_hits_clump.restype = None
    out.run_hits_clump.argtypes = ([ct.c_void_p] * 2 + [ct.c_int64] * 2 +
                                   [ct.c_void_p] * 3 + [ct.c_int32] +
                                   [ct.c_void_p, ct.c_int64, ct.c_void_p])
    out.clump_consts.restype = None
    out.clump_consts.argtypes = [ct.c_void_p]
    return out


def _aa(over=None, **kw):
    from yaha_tpu_torch import host
    aa = host.AlignmentArgs()
    for k, v in dict(CLUMP_PARAMS[over or "default"], **kw).items():
        setattr(aa, k, v)
    aa.post_process(True)
    return aa


def _body(lib, diag, qo, n_hits, q_len, aa, width):
    diag = np.ascontiguousarray(diag, np.uint32)
    qo = np.ascontiguousarray(qo, np.int32)
    n_hits = np.ascontiguousarray(n_hits, np.int32)
    q_len = np.ascontiguousarray(q_len, np.int32)
    ints, wide = clumps.clump_params(aa)
    ip = np.asarray(ints, np.int64)
    b, c = qo.shape
    rec = np.full((b, width), -0x5A5A5A5B, np.int32)
    meta = np.full(b, -7, np.int32)
    lib.run_hits_clump(diag.ctypes.data, qo.ctypes.data, b, c,
                       n_hits.ctypes.data, q_len.ctypes.data, ip.ctypes.data,
                       wide, rec.ctypes.data, width, meta.ctypes.data)
    return rec, meta


def _check(lib, diag, qo, n_hits, q_len, aa, width=4096):
    """Kernel body = plain version, row for row; returns (meta, records)."""
    got_rec, got_meta = _body(lib, diag, qo, n_hits, q_len, aa, width)
    want_rec, want_meta = clumps.hits_clumps_reference(
        torch.from_numpy(np.ascontiguousarray(diag, np.uint32).view(
            np.int32)), torch.from_numpy(np.ascontiguousarray(qo, np.int32)),
        torch.from_numpy(np.asarray(n_hits, np.int32)),
        torch.from_numpy(np.asarray(q_len, np.int32)), aa, width)
    want_rec, want_meta = want_rec.numpy(), want_meta.numpy()
    np.testing.assert_array_equal(got_meta, want_meta)
    recs = []
    for r, m in enumerate(want_meta):
        if m > 0:
            np.testing.assert_array_equal(got_rec[r, :m], want_rec[r, :m],
                                          err_msg="row %d" % r)
            recs.append(parse_clump_record(want_rec[r, :m]))
    return want_meta, recs


def test_consts_match_python_copy(lib):
    out = np.zeros(3, np.int64)
    lib.clump_consts(out.ctypes.data)
    assert tuple(out) == (clumps.REGION, clumps.COVER, clumps.HEAD)


@pytest.mark.parametrize("capacity", [1024, 8192])
def test_golden_seed_rows(lib, capacity):
    """The golden index's seed rows, served as the seeder serves a tier."""
    wl, _, so, roa = golden_index()
    codes, lens = seed_rows(5)
    aa = _aa("params1kb", word_len=wl)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    hashes, clean = seeds.seed_hashes_reference(
        torch.from_numpy(codes), torch.from_numpy(lens), word_len=wl)
    out = seeds.expand_sort_hits_reference(hashes, clean, t(so), t(roa),
                                           max_hits=650, capacity=capacity)
    serve = ~out["overflow"] & ~out["allwrapped"]
    n_hits = torch.where(serve, out["total"], -1).numpy()
    assert (n_hits > 0).sum() > 10
    meta, recs = _check(lib, out["diag"].numpy().view(np.uint32),
                        out["qo"].numpy(), n_hits, lens, aa)
    assert sum(len(c) for _, c in recs) > 10


@pytest.mark.parametrize("over", ["default", "params1kb", "ties"])
@pytest.mark.parametrize("seed", [0, 1])
def test_read_rows(lib, seed, over):
    """1 kb substitution, indel, split and repeat-copy reads; the rows whose
    region outgrows the kernel's rounds come back flagged."""
    diag, qo, n_hits, q_len = clump_read_rows(seed)
    meta, recs = _check(lib, diag, qo, n_hits, q_len, _aa(over))
    assert (meta == -1).sum() >= 1 and (meta > 0).sum() >= 40
    assert max(len(c) for _, c in recs) >= 2        # split reads
    assert max(len(f) for _, c in recs for _, f in c) >= 8   # indel reads


@pytest.mark.parametrize("over", ["default", "ties", "chops", "valve"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_rows(lib, seed, over):
    """Dense regions: ties, persisting chops, clean-up, the valve."""
    diag, qo, n_hits, q_len = clump_dense_rows(seed)
    meta, recs = _check(lib, diag, qo, n_hits, q_len, _aa(over))
    assert (meta > 0).all()
    if over == "valve":
        assert sum(s for s, _ in recs) > 0
    else:
        assert sum(s for s, _ in recs) == 0
        assert sum(len(c) for _, c in recs) > len(recs)


def test_edge_rows(lib):
    diag, qo, n_hits, q_len = clump_edge_rows()
    meta, recs = _check(lib, diag, qo, n_hits, q_len, _aa())
    assert (meta > 0).all()
    n_clumps = [len(c) for _, c in recs]
    # no hits, one hit, 24 bases: none; 25 bases: one clump of one frag.
    assert n_clumps[:4] == [0, 0, 0, 1]
    # max_gap apart: one region (two rounds); max_gap + 1: two regions.
    regions = [len(clumps.regions(diag[r, :n_hits[r]], qo[r, :n_hits[r]],
                                   15, 50)[1]) for r in range(len(meta))]
    assert regions[4:6] == [1, 2] and n_clumps[4:6] == [2, 2]
    # a qo step of word_len: one fragment; word_len + 1: two.
    assert [len(recs[r][1][0][1]) for r in (6, 7)] == [1, 2]


def test_not_served_and_too_long(lib):
    """n_hits -1 writes nothing (meta 0); a record longer than its slot is
    flagged (meta -1), as are rows given a slot shorter than the header."""
    diag, qo, n_hits, q_len = clump_read_rows(3, n=12)
    n_hits = n_hits.copy()
    n_hits[::3] = -1
    meta, _ = _check(lib, diag, qo, n_hits, q_len, _aa())
    assert (meta[::3] == 0).all()
    full, _ = _check(lib, diag, qo, n_hits, q_len, _aa())
    short = int(np.median(full[full > 0]))
    meta, _ = _check(lib, diag, qo, n_hits, q_len, _aa(), width=short)
    assert (((full > short) | (full == -1)) == (meta == -1)).all()
    assert (full > short).any()
    meta, _ = _check(lib, diag, qo, n_hits, q_len, _aa(), width=2)
    assert ((meta == -1) == (n_hits >= 0)).all()


@pytest.mark.parametrize("wide", [False, True], ids=["wrap16", "wide"])
def test_long_reads_score_wrap(lib, wide):
    """40 kb reads: int16 wraps (the sequential fold) or wide scores."""
    diag, qo, n_hits, q_len = clump_wrap_rows()
    aa = _aa(max_query_length=50000 if wide else 32000)
    meta, recs = _check(lib, diag, qo, n_hits, q_len, aa)
    assert (meta > 0).all() and all(len(c) >= 1 for _, c in recs)
