"""ctypes bindings of the port's native host library (libyaha_host.so).

The library is the native C++ staged pipeline of the JAX package, copied
unchanged into this directory (yaha_host.cpp, yaha_pipe.cpp,
yaha_index.cpp), so the port writes the same SAM bytes.  At first use g++
builds it into yaha_tpu_torch/_build/libyaha_host.so with the flags of the
JAX package's own build: under a lock file, into a temporary file that is
renamed into place, so that parallel processes never load a partial
library.  It is rebuilt when a source is newer.  A missing g++ or a failed
build raises: nothing falls back to another library or to Python code.

Counterpart of yaha_tpu/native/host.py, trimmed to what the port calls:
the loader, the query parser, the per-read native engine
(align_batch_native, the engine the port is held to, and --engine
native), compression and the index build, the signatures of the staged
yt_batch_* entries (yaha_tpu/models/staged.py _sig), and the batched host
DPs: extension_forward and anchored_forward (the eo/idc planes of
ops/sw_batch.py, run by StagedAligner(backend="native"), and the DPs the
oracle engine delegates, core/sw.py) and chain_dp (the fragment-chain DP
that ops/chain.py is held to, and the oracle's), the oracle's fused front
end (seed_to_clumps, frags_to_clumps, and the --max-region-frags valve's
take_skipped_regions), and a staged batch's phase-1 stage sums
(profile_counters).
"""
from __future__ import annotations

import ctypes as ct
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_HERE, f)
           for f in ("yaha_host.cpp", "yaha_pipe.cpp", "yaha_index.cpp")]
HEADERS = [os.path.join(_HERE, "yaha_prof.h")]
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libyaha_host.so")
GXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-Wall", "-shared",
             "-fPIC", "-pthread"]

_u8p = ct.POINTER(ct.c_uint8)
_i32p = ct.POINTER(ct.c_int32)
_i64p = ct.POINTER(ct.c_int64)
_u32p = ct.POINTER(ct.c_uint32)

_lib = None
_load_lock = threading.Lock()


def _stale():
    return (not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) <
            max(os.path.getmtime(s) for s in SOURCES + HEADERS))


def build():
    """Compile the library if it is missing or older than a source.
    Returns the seconds spent compiling (0.0 when it was current)."""
    import time
    if not _stale():
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libyaha_host.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return 0.0
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found on PATH: the native host "
                               "library of yaha_tpu_torch needs it to build")
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(prefix=".libyaha_host.", suffix=".so",
                                   dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [gxx] + GXX_FLAGS + ["-o", tmp] + SOURCES
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("g++ failed (%d): %s\n%s" % (
                    res.returncode, " ".join(cmd), res.stderr[-4000:]))
            os.replace(tmp, LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return time.perf_counter() - t0


def _declare(lib):
    lib.yt_compress_fasta_file.argtypes = [ct.c_char_p, ct.c_char_p]
    lib.yt_unpack_nib2.argtypes = [_u8p, ct.c_int64, _u8p]
    lib.yt_parse_queries.argtypes = [
        _u8p, ct.c_int64, ct.c_int, ct.c_int64, ct.c_int64,
        ct.POINTER(_u8p), ct.POINTER(_i64p), ct.POINTER(_u8p),
        ct.POINTER(_i64p), ct.POINTER(_u8p), _i64p, _i64p]
    lib.yt_free.argtypes = [ct.c_void_p]
    lib.yt_align_batch.argtypes = [
        _u8p, _i64p, _u8p, _i64p, _u8p, ct.c_int64,
        _u8p, ct.c_int64, ct.c_int64,
        _i64p, _i64p, ct.c_int64, _u8p, _i64p,
        _u32p, _u32p, ct.c_int64,
        _i64p, ct.POINTER(ct.c_double),
        ct.POINTER(ct.c_void_p), _i64p,
        ct.POINTER(ct.c_void_p), _i64p, _i64p, _i64p, _i64p]
    lib.yt_build_index.argtypes = [
        _u8p, ct.c_int64, _i64p, _i64p, ct.c_int64,
        ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int64,
        ct.POINTER(_u32p), ct.POINTER(_u32p), _i64p]
    # The staged pipeline (yt_batch_*), driven by models/staged.py.
    lib.yt_batch_begin.restype = ct.c_void_p
    lib.yt_batch_begin.argtypes = [
        _u8p, _i64p, _u8p, _i64p, _u8p, ct.c_int64,
        _u8p, ct.c_int64, ct.c_int64, _i64p, _i64p, ct.c_int64,
        _u8p, _i64p, _u32p, _u32p, ct.c_int64,
        _i64p, ct.POINTER(ct.c_double), ct.c_int64,
        _u32p, _i32p, _i64p, _i64p, _i32p, _i64p, ct.c_int64]
    lib.yt_batch_prof.restype = ct.c_int64
    lib.yt_batch_prof.argtypes = [ct.c_void_p, ct.POINTER(ct.c_double),
                                  _i64p]
    lib.yt_batch_gap_count.restype = ct.c_int64
    lib.yt_batch_gap_count.argtypes = [ct.c_void_p]
    lib.yt_batch_gap_meta.argtypes = [ct.c_void_p, _i32p, _i32p, _i32p,
                                      _i32p]
    lib.yt_batch_gap_meta2.argtypes = [ct.c_void_p, _i32p, _i32p, _i32p,
                                       _i64p, _i32p]
    lib.yt_batch_ext_meta2.argtypes = [ct.c_void_p, _i32p, _i32p, _i32p,
                                       _i64p, _i32p]
    lib.yt_batch_gap_fetch.argtypes = [ct.c_void_p, ct.c_int64, _i64p,
                                       _u8p, ct.c_int64, _u8p, ct.c_int64]
    lib.yt_batch_gap_apply.argtypes = [
        ct.c_void_p, ct.c_int64, ct.c_int64, _i64p, ct.c_void_p, _i32p,
        ct.c_int64, ct.c_int64, _i32p]
    lib.yt_batch_phase2.argtypes = [ct.c_void_p]
    lib.yt_batch_ext_count.restype = ct.c_int64
    lib.yt_batch_ext_count.argtypes = [ct.c_void_p]
    lib.yt_batch_ext_meta.argtypes = [ct.c_void_p, _i32p, _i32p, _u8p]
    lib.yt_batch_ext_fetch.argtypes = [ct.c_void_p, ct.c_int64, _i64p,
                                       _u8p, ct.c_int64, _u8p, ct.c_int64]
    lib.yt_batch_ext_apply.argtypes = [
        ct.c_void_p, ct.c_int64, ct.c_int64, _i64p, ct.c_void_p, _i32p,
        ct.c_int64, ct.c_int64, _i32p, _i32p, _i32p]
    lib.yt_batch_finish.argtypes = [
        ct.c_void_p, ct.POINTER(ct.c_void_p), _i64p, _i64p, _i64p, _i64p]
    lib.yt_batch_query_stats.argtypes = [ct.c_void_p, _i64p, _i64p, _i64p,
                                         _i64p]
    lib.yt_batch_free.argtypes = [ct.c_void_p]
    # The batched host DPs (yaha_host.cpp).
    lib.yt_extension_forward.argtypes = [
        _u8p, _i32p, _u8p, _i32p, ct.c_int64, ct.c_int64, ct.c_int64] + \
        [ct.c_int] * 8 + [ct.POINTER(ct.c_int8), _i32p, _i32p, _i32p,
                          _i32p]
    lib.yt_anchored_forward.argtypes = [
        _u8p, _i32p, _u8p, _i32p, _i32p, _i32p, ct.c_int64, ct.c_int64,
        ct.c_int64] + [ct.c_int] * 6 + [ct.POINTER(ct.c_int8), _i32p,
                                        _i32p]
    lib.yt_chain_dp.restype = ct.c_int64
    lib.yt_chain_dp.argtypes = [ct.c_int64] + [_i64p] * 4 + \
        [ct.c_int64] * 5 + [_i64p] * 4
    # The oracle engine's fused front end (yaha_host.cpp).
    lib.yt_set_max_region_frags.argtypes = [ct.c_int64]
    lib.yt_set_max_region_frags.restype = None
    lib.yt_take_skipped_regions.argtypes = []
    lib.yt_take_skipped_regions.restype = ct.c_int64
    lib.yt_frags_to_clumps.argtypes = [_i64p] * 3 + [ct.c_int64] * 11 + \
        [_i64p] * 5 + [ct.c_int64] * 2
    lib.yt_frags_to_clumps.restype = ct.c_int64
    lib.yt_seed_to_clumps.argtypes = [
        _u8p, ct.c_int64, ct.c_int64, _u32p, _u32p, ct.c_int64,
        ct.c_int64] + [ct.c_int64] * 8 + [_i64p] * 5 + \
        [ct.c_int64] * 2 + [_i64p]
    lib.yt_seed_to_clumps.restype = ct.c_int64
    lib.yt_hits_to_clumps.argtypes = [_u32p, _i32p] + [ct.c_int64] * 11 + \
        [_i64p] * 5 + [ct.c_int64] * 2
    lib.yt_hits_to_clumps.restype = ct.c_int64
    lib.yt_set_wide_scores.argtypes = [ct.c_int64]
    lib.yt_set_wide_scores.restype = None


def _load():
    """The library with its C signatures declared, built first if needed."""
    global _lib
    with _load_lock:
        if _lib is None:
            build()
            lib = ct.CDLL(LIB_PATH)
            _declare(lib)
            _lib = lib
        return _lib


# A staged batch's phase-1 stage sums over its native threads
# (yaha_prof.h Prof, through yt_batch_prof): thread-seconds of the host
# seed scan's rolling hash, SO lookups and ROA gathers, the hit sort, the
# fragments-to-clumps stage, the device-fed strands' coalesce and
# fragments-to-clumps, and the clumps' stage-1 alignment; and the hit,
# fragment and clump counts.  They accumulate only in a batch begun with
# the profiling flag (models/staged.py, while the recorder is on).
PROFILE_SECONDS = ("scan_hash", "scan_so", "scan_roa", "sort", "f2c",
                   "hits_f2c", "stage1")
PROFILE_COUNTS = ("hits", "frags", "clumps")


def profile_counters(ctx):
    """{name: value} of PROFILE_SECONDS (float) and PROFILE_COUNTS (int)
    of the staged batch `ctx` (yt_batch_begin's handle, before
    yt_batch_free)."""
    secs = (ct.c_double * len(PROFILE_SECONDS))()
    counts = (ct.c_int64 * len(PROFILE_COUNTS))()
    _load().yt_batch_prof(ctx, secs, counts)
    out = dict(zip(PROFILE_SECONDS, secs))
    out.update(zip(PROFILE_COUNTS, counts))
    return out


def available() -> bool:
    """True once the library is built and loaded (a failed build raises)."""
    return _load() is not None


class ParsedReads:
    """Zero-copy holder of yt_parse_queries output (malloc'd flat arrays);
    frees them on destruction."""

    __slots__ = ("ids", "id_offs", "seqs", "seq_offs", "quals", "n",
                 "stopped", "_lib")

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is None:
            return
        for name in ("ids", "id_offs", "seqs", "seq_offs", "quals"):
            p = getattr(self, name, None)
            if p:
                lib.yt_free(p)


def parse_queries_native(data: bytes, fastq: bool, max_query_len: int,
                         word_len: int) -> ParsedReads:
    """Parse a FASTA/FASTQ chunk; returns a ParsedReads owning the native
    arrays."""
    lib = _load()
    pr = ParsedReads()
    pr._lib = lib
    pr.ids = _u8p()
    pr.id_offs = _i64p()
    pr.seqs = _u8p()
    pr.seq_offs = _i64p()
    pr.quals = _u8p()
    n_reads = ct.c_int64()
    stopped = ct.c_int64()
    rc = lib.yt_parse_queries(
        ct.cast(ct.c_char_p(data), _u8p), len(data), int(fastq),
        max_query_len, word_len,
        ct.byref(pr.ids), ct.byref(pr.id_offs), ct.byref(pr.seqs),
        ct.byref(pr.seq_offs), ct.byref(pr.quals), ct.byref(n_reads),
        ct.byref(stopped))
    assert rc == 0
    pr.n = int(n_reads.value)
    pr.stopped = bool(stopped.value)
    return pr


def _pack_params_ct(aa, n_threads):
    ip = (ct.c_int64 * 27)(
        aa.word_len, aa.max_hits, aa.max_gap, aa.max_intron, aa.min_match,
        aa.max_desert, aa.min_raw_score, aa.min_non_overlap,
        aa.oqc_min_non_overlap, aa.band_width, aa.m_score, aa.r_cost,
        aa.go_cost, aa.ge_cost, aa.x_cutoff, aa.min_ext_length, aa.bp_cost,
        aa.max_bp_log, int(aa.oqc), int(aa.fbs), int(aa.output_sam),
        int(aa.output_blast8), int(aa.hard_clip), int(aa.fastq),
        int(n_threads), int(aa.max_query_length),
        int(getattr(aa, "max_region_frags", 0)))
    fp = (ct.c_double * 3)(aa.min_identity, aa.fbs_ps_length,
                           aa.fbs_ps_score)
    return ip, fp


def off64(p, k):
    """int64 pointer `p` advanced by k elements."""
    return ct.cast(ct.cast(p, ct.c_void_p).value + 8 * k, _i64p)


def align_batch_native(pr: ParsedReads, lo: int, hi: int, genome, index,
                       aa, n_threads=1, want_stats=False, dist=None):
    """Full native per-read pipeline (yt_align_batch) over reads [lo, hi)
    of a ParsedReads, with the handles of io/native_loader.py.

    Returns (sam_bytes, stats_bytes|None, total_seed_matches,
    total_records); stats rows are the QUERYSTATS TSV fields.  `dist`, if
    given, is a ctypes (c_int64 * 11) array filled with the per-batch
    STATS distributions."""
    lib = _load()
    ip, fp = _pack_params_ct(aa, n_threads)
    out_text = ct.c_void_p()
    out_len = ct.c_int64()
    stats_text = ct.c_void_p()
    stats_len = ct.c_int64()
    seed_total = ct.c_int64()
    rec_total = ct.c_int64()
    rc = lib.yt_align_batch(
        pr.seqs, off64(pr.seq_offs, lo), pr.ids, off64(pr.id_offs, lo),
        pr.quals if aa.fastq else None, hi - lo,
        ct.cast(genome.codes_buf, _u8p), genome.codes_len, genome.max_roff,
        ct.cast(genome._starts_arr, _i64p), ct.cast(genome._lens_arr, _i64p),
        genome.n_seqs, ct.cast(genome._names_blob, _u8p),
        ct.cast(genome._name_offs, _i64p),
        index.so_ptr, index.roa_ptr, index.roa_len,
        ct.cast(ip, _i64p), ct.cast(fp, ct.POINTER(ct.c_double)),
        ct.byref(out_text), ct.byref(out_len),
        ct.byref(stats_text) if want_stats else None,
        ct.byref(stats_len) if want_stats else None,
        ct.byref(seed_total), ct.byref(rec_total),
        ct.cast(dist, _i64p) if dist is not None else None)
    assert rc == 0
    try:
        text = ct.string_at(out_text, out_len.value)
    finally:
        lib.yt_free(out_text)
    stats = None
    if want_stats:
        try:
            stats = ct.string_at(stats_text, stats_len.value)
        finally:
            lib.yt_free(stats_text)
    return text, stats, int(seed_total.value), int(rec_total.value)


def compress_fasta_file(in_path: str, out_path: str) -> None:
    """FASTA -> nib2, file to file (mmap in, one write out)."""
    rc = _load().yt_compress_fasta_file(os.fsencode(in_path),
                                        os.fsencode(out_path))
    assert rc == 0, "yt_compress_fasta_file failed on %s" % in_path


def build_index(genome, word_len, skip_dist, max_hits, n_threads=4):
    """Threaded native index build (yt_build_index) of an io/nib2 Genome.
    Returns (so uint32, roa uint32, total)."""
    lib = _load()
    codes = np.ascontiguousarray(genome.codes, np.uint8)
    starts = np.ascontiguousarray(genome.starting_offsets, np.int64)
    lens = np.ascontiguousarray(genome.lengths, np.int64)
    so_p = _u32p()
    roa_p = _u32p()
    total = ct.c_int64()
    rc = lib.yt_build_index(
        codes.ctypes.data_as(_u8p), len(codes), starts.ctypes.data_as(_i64p),
        lens.ctypes.data_as(_i64p), genome.n_seqs, word_len, skip_dist,
        max_hits, n_threads, ct.byref(so_p), ct.byref(roa_p),
        ct.byref(total))
    assert rc == 0
    try:
        so = np.ctypeslib.as_array(so_p, shape=((1 << (2 * word_len)) + 1,))
        roa = np.ctypeslib.as_array(
            roa_p, shape=(max(int(total.value), 1),))[:int(total.value)]
        return so.copy(), roa.copy(), int(total.value)
    finally:
        lib.yt_free(so_p)
        lib.yt_free(roa_p)


def _ptr(a, t):
    return a.ctypes.data_as(ct.POINTER(t))


def _i64_ptr(a):
    return a.ctypes.data_as(_i64p)


def extension_forward(q, qlens, r, rlens, *, band_width, go, ge, rc, ms,
                      max_gap, max_intron, x_cutoff):
    """Batched extension forward on the host (yt_extension_forward); the
    contract of ops/sw_batch.batched_extension_forward on numpy arrays:
    q [N, QL], r [N, RL] u8 (RL >= QL + 4*band_width), qlens/rlens [N].
    Returns score/maxi/maxj [N] int32, eo [N, QL+1, W] int8 and idc [N,
    QL+1, W] int32, W = 4*band_width + 1."""
    lib = _load()
    n, qlmax = q.shape
    w = 4 * band_width + 1
    q = np.ascontiguousarray(q, np.uint8)
    r = np.ascontiguousarray(r, np.uint8)
    qlens32 = np.ascontiguousarray(qlens, np.int32)
    rlens32 = np.ascontiguousarray(rlens, np.int32)
    eo = np.zeros((n, qlmax + 1, w), np.int8)
    idc = np.zeros((n, qlmax + 1, w), np.int32)
    score, maxi, maxj = np.zeros((3, n), np.int32)
    rcode = lib.yt_extension_forward(
        _ptr(q, ct.c_uint8), _ptr(qlens32, ct.c_int32), _ptr(r, ct.c_uint8),
        _ptr(rlens32, ct.c_int32), n, qlmax, r.shape[1], band_width, go, ge,
        rc, ms, max_gap, max_intron, x_cutoff, _ptr(eo, ct.c_int8),
        _ptr(idc, ct.c_int32), _ptr(score, ct.c_int32),
        _ptr(maxi, ct.c_int32), _ptr(maxj, ct.c_int32))
    if rcode != 0:
        raise RuntimeError("yt_extension_forward failed (%d)" % rcode)
    return {"score": score, "maxi": maxi, "maxj": maxj, "eo": eo,
            "idc": idc}


def anchored_forward(q, qlens, r, rlens, left_bw, right_bw, *, go, ge, rc,
                     ms, max_gap, max_intron):
    """Batched anchored (gap-fill) forward on the host
    (yt_anchored_forward); the contract of
    ops/sw_batch.batched_anchored_forward on numpy arrays.  Returns score
    [N] int32, eo [N, QL+1, RL+1] int8 and idc [N, QL+1, RL+1] int32."""
    lib = _load()
    n, qlmax = q.shape
    rlmax = r.shape[1]
    q = np.ascontiguousarray(q, np.uint8)
    r = np.ascontiguousarray(r, np.uint8)
    lens = [np.ascontiguousarray(a, np.int32)
            for a in (qlens, rlens, left_bw, right_bw)]
    eo = np.zeros((n, qlmax + 1, rlmax + 1), np.int8)
    idc = np.zeros((n, qlmax + 1, rlmax + 1), np.int32)
    score = np.full(n, -0x7FFFFF00, np.int32)
    rcode = lib.yt_anchored_forward(
        _ptr(q, ct.c_uint8), _ptr(lens[0], ct.c_int32), _ptr(r, ct.c_uint8),
        *(_ptr(a, ct.c_int32) for a in lens[1:]), n, qlmax, rlmax, go, ge,
        rc, ms, max_gap, max_intron, _ptr(eo, ct.c_int8),
        _ptr(idc, ct.c_int32), _ptr(score, ct.c_int32))
    if rcode != 0:
        raise RuntimeError("yt_anchored_forward failed (%d)" % rcode)
    return {"score": score, "eo": eo, "idc": idc}


def chain_dp(sqo, eqo, diag, length, *, max_gap, max_desert, m_score,
             go_cost, ge_cost):
    """Fragment-chain DP (buildBestClumpFromFragmentRange,
    GraphPath.cpp:161-270) on the host over one node range sorted by
    (SQO, diag); diag in [0, 2^32), as the native engine keeps it.

    Returns (best_idx, best_score, prev_idx, path_length, path_sqo), the
    arrays int64 [n]; best_idx is -1 for an empty range."""
    lib = _load()
    n = len(sqo)
    ins = [np.ascontiguousarray(a, np.int64)
           for a in (sqo, eqo, diag, length)]
    outs = [np.empty(n, np.int64) for _ in range(4)]
    best = lib.yt_chain_dp(n, *(a.ctypes.data_as(_i64p) for a in ins),
                           max_gap, max_desert, m_score, go_cost, ge_cost,
                           *(a.ctypes.data_as(_i64p) for a in outs))
    return (int(best),) + tuple(outs)


# ---- the oracle engine's fused front end (core/chain.py) ----

def _set_region_cap(lib, aa):
    """Propagate --max-region-frags (0 = off) to the C region loop's
    thread-local cap; oversized regions are then skipped and counted
    (drained by take_skipped_regions)."""
    lib.yt_set_max_region_frags(int(getattr(aa, "max_region_frags", 0)))


def take_skipped_regions():
    """Number of regions skipped by the --max-region-frags valve since
    the last call (this thread)."""
    return int(_load().yt_take_skipped_regions())


def frags_to_clumps(sqo, eqo, sro, query_len, aa):
    """C-speed fragment->clump stage (processFragmentsGapped,
    QueryMatch.c:224-303 + GraphPath.cpp:272-292 + AlignHelpers.c:48-193)
    for one strand.  Returns (clump_offs, out_sqo, out_eqo, out_sro,
    matched) with clumps in emission order, or None on capacity overflow
    (caller falls back to the Python path).
    """
    lib = _load()
    n = len(sqo)
    sqo = np.ascontiguousarray(sqo, np.int64)
    eqo = np.ascontiguousarray(eqo, np.int64)
    sro = np.ascontiguousarray(sro, np.int64)
    cap_frags = 16 * n + 1024
    cap_clumps = 4 * n + 64
    out_sqo = np.empty(cap_frags, np.int64)
    out_eqo = np.empty(cap_frags, np.int64)
    out_sro = np.empty(cap_frags, np.int64)
    clump_offs = np.empty(cap_clumps + 1, np.int64)
    matched = np.empty(cap_clumps, np.int64)
    p = _i64_ptr
    _set_region_cap(lib, aa)
    nc = lib.yt_frags_to_clumps(
        p(sqo), p(eqo), p(sro), n, query_len,
        aa.max_gap, aa.max_desert, aa.min_match, aa.min_non_overlap,
        aa.m_score, aa.go_cost, aa.ge_cost, aa.band_width, aa.word_len,
        p(out_sqo), p(out_eqo), p(out_sro), p(clump_offs), p(matched),
        cap_frags, cap_clumps)
    if nc < 0:
        return None
    used = int(clump_offs[nc])
    return (clump_offs[:nc + 1], out_sqo[:used], out_eqo[:used],
            out_sro[:used], matched[:nc])


def seed_to_clumps(codes, index, aa, *, cap_frags=65536, cap_clumps=8192):
    """Fused seed->fragments->clumps for one strand (yt_seed_to_clumps)
    against an io/index_io.Index (its uint32 SO and ROA, zero-copy).

    Returns (clump_offs, out_sqo, out_eqo, out_sro, matched, total_hits)
    or None when capacity is exceeded (caller falls back to the Python
    stage pipeline).  Capacity grows x8 up to ~4M emitted fragments before
    giving up: highly repetitive long reads (tandem repeats near the 32kb
    cap) legitimately emit huge clump sets, and the unbounded Python
    fallback is ~100x slower there.
    """
    lib = _load()
    codes = np.ascontiguousarray(codes, np.uint8)
    so, roa = index.starting_offs, index.roa
    total = ct.c_int64(0)
    p = _i64_ptr
    _set_region_cap(lib, aa)
    while True:
        out_sqo = np.empty(cap_frags, np.int64)
        out_eqo = np.empty(cap_frags, np.int64)
        out_sro = np.empty(cap_frags, np.int64)
        clump_offs = np.empty(cap_clumps + 1, np.int64)
        matched = np.empty(cap_clumps, np.int64)
        nc = lib.yt_seed_to_clumps(
            codes.ctypes.data_as(_u8p), len(codes), index.word_len,
            so.ctypes.data_as(_u32p), roa.ctypes.data_as(_u32p), len(roa),
            aa.max_hits,
            aa.max_gap, aa.max_desert, aa.min_match, aa.min_non_overlap,
            aa.m_score, aa.go_cost, aa.ge_cost, aa.band_width,
            p(out_sqo), p(out_eqo), p(out_sro), p(clump_offs),
            p(matched), cap_frags, cap_clumps, ct.byref(total))
        if nc >= 0:
            break
        if cap_frags >= (1 << 22):
            return None
        cap_frags *= 8
        cap_clumps *= 8
    used = int(clump_offs[nc])
    return (clump_offs[:nc + 1], out_sqo[:used], out_eqo[:used],
            out_sro[:used], matched[:nc], int(total.value))


def hits_to_clumps(diag, qo, q_len, aa):
    """The device-fed front end for one strand (yt_hits_to_clumps): hits
    sorted by (diag uint32, qo) -> (clump_offs, out_sqo, out_eqo, out_sro,
    matched, skipped), clumps in emission order, with --max-region-frags
    and the score mode of max_query_length as the staged workers set them;
    skipped counts the regions that valve skipped."""
    lib = _load()
    diag = np.ascontiguousarray(diag, np.uint32)
    qo = np.ascontiguousarray(qo, np.int32)
    _set_region_cap(lib, aa)
    lib.yt_set_wide_scores(1 if aa.max_query_length > 32000 else 0)
    lib.yt_take_skipped_regions()
    cap_frags, cap_clumps = 4 * len(qo) + 64, len(qo) + 64
    p = _i64_ptr
    while True:
        out = [np.empty(cap_frags, np.int64) for _ in range(3)]
        clump_offs = np.empty(cap_clumps + 1, np.int64)
        matched = np.empty(cap_clumps, np.int64)
        nc = lib.yt_hits_to_clumps(
            diag.ctypes.data_as(_u32p), qo.ctypes.data_as(_i32p), len(qo),
            q_len, aa.word_len, aa.max_gap, aa.max_desert, aa.min_match,
            aa.min_non_overlap, aa.m_score, aa.go_cost, aa.ge_cost,
            aa.band_width, *(p(a) for a in out), p(clump_offs), p(matched),
            cap_frags, cap_clumps)
        if nc >= 0:
            break
        lib.yt_take_skipped_regions()
        cap_frags *= 4
        cap_clumps *= 4
    lib.yt_set_wide_scores(0)
    used = int(clump_offs[nc])
    return (clump_offs[:nc + 1], out[0][:used], out[1][:used],
            out[2][:used], matched[:nc], int(lib.yt_take_skipped_regions()))
