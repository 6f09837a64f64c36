"""Staged batch engine on PyTorch + CUDA: native host phases + DP on the card.

Counterpart of yaha_tpu/models/staged.py.  The native C++ staged pipeline
(the port's copy, native/host.py) runs every per-read phase (parse, seed,
chain, clumps, score/split, OQC/FBS, SAM); the two batched DP phases run
on the card:

  phase A  anchored gap fills   -> sw_cuda.anchored_forward_banded, or
                                   sw_cuda.anchored_forward for bands
                                   wider than 512 or the whole reference
  phase B  banded X-drop extensions -> sw_cuda.extension_forward

A full-width gap bucket whose plane is wider than the wide route takes
(more than 2,832 columns: RL 4,096 and up) goes, by its shape and before
any launch, to the lockstep twin of ops/sw_batch.py on the same device
with FMT_EOIDC planes, as the reference sends its gap_fallback class to
its XLA twin (stat gap_twin).  Extensions always take the kernels.

The default configuration is the JAX package's default one:

  device_assembly  the genome codes stay on the card for the run, each
                   chunk's read bytes upload once and become strand rows
                   there, and every problem's (q, r) planes are cut on the
                   card from coordinates (ops/gather_dp.py);
  rle              the backtrack planes are walked on the card
                   (ops/decode.py) and only run-length items come back, to
                   the native FMT_RLE apply.

With device_assembly off, problems are fetched on the host
(yt_batch_*_fetch) and upload as u8 planes; with rle off, the packed
planes come back to the native walkers (FMT_PACKED / FMT_PACKED_BAND).
Both off is the A/B configuration (YT_STAGED_DEVRES=0 YT_STAGED_RLE=0).
Nothing switches configuration on an error.  Every configuration is
byte-identical to the per-read native engine.

The DP backend (JAX staged.py's `backend`):

  "cuda"    the kernels above (--engine batch-cuda, the main path);
  "torch"   the lockstep DPs of ops/sw_batch.py in PyTorch ops on the
            device (--engine batch-torch, the twin of the JAX package's
            batch-xla): every gap bucket as the masked full matrix, every
            extension bucket banded, each returning eo int8 and idc int32
            planes (FMT_EOIDC) to the native apply; problems assembled on
            the device as above unless device_assembly is off;
  "native"  the batched host DPs of the native library
            (native/host.extension_forward / anchored_forward) on
            problems fetched on the host, also FMT_EOIDC: the JAX
            package's host staging harness, with no device work.

With a seeder (models/seeder.DeviceSeeder, --seed device) the seed scan
runs on the device too: the chunk's strand rows are hashed and expanded
against the index resident there, and phase 1 takes the sorted hit rows in
place of its host scan (a row the seeder sends back with total -1 still
takes the host scan).

Small problems (<= 24 rows) run inline on the native small-DP fast paths
during the host phases by default (YT_STAGED_INLINE=0 sends every problem
to the DP kernels).

Spans (utils/timing; under the CLI loop's `align` span of the batch):
staged.upload (the chunk's read bytes), the seeder's seeder.seed,
staged.phase1 (yt_batch_begin, with phase 1's native stage sums and
counts while the recorder is on), staged.gap > dispatch.gap (a bucket) >
dispatch.wait (a blocking fetch), staged.phase2, staged.ext >
dispatch.ext > dispatch.wait, staged.finish (yt_batch_finish and the
copy of its text), staged.free (yt_batch_free); staged.gap and staged.ext carry their host_s.  The always-on sums of `stats` take the same clock
reads.
"""
from __future__ import annotations

import ctypes as ct
import os
import threading

import numpy as np
import torch

from ..native import host
from ..ops import decode, sw_batch, sw_cuda
from ..ops.gather_dp import (COORD_BYTES, DeviceCorpus, chunk_strand_rows,
                             code_tables)
from ..utils.timing import RECORDER, span

_u8p = ct.POINTER(ct.c_uint8)
_i32p = ct.POINTER(ct.c_int32)
_i64p = ct.POINTER(ct.c_int64)
_u32p = ct.POINTER(ct.c_uint32)

# Plane formats of the native yt_batch_*_apply entries that the port feeds
# (0, the inline format, is the JAX package's alone): eo int8 + idc int32
# planes, packed full-width and band-relative planes, run-length items.
FMT_EOIDC, FMT_PACKED, FMT_PACKED_BAND, FMT_RLE = 1, 2, 3, 4

BACKENDS = ("cuda", "torch", "native")

# Largest device problem batch per launch: buckets beyond it split into
# slices, so a bucket's backtrack planes stay bounded.
MAX_DEVICE_BATCH = 16384

# Bound on one launch's backtrack plane, DP scratch and item buffer:
# buckets slice further when MAX_DEVICE_BATCH problems would exceed it (a
# 16384-problem extension launch at the 16384-row tier is 5.6 GB of plane).
MAX_LAUNCH_BYTES = 1 << 32

# Widest band the band-relative gap kernel takes (the Pallas dispatch
# rule, yaha_tpu/models/staged.py _run_gap_bucket).
MAX_WBAND = 512


def _pow2(x, lo=32):
    return max(lo, 1 << (int(x) - 1).bit_length())


def _pow2_arr(x, lo=32):
    """Per-element next power of two, floored at `lo` (bucket widths)."""
    x = np.maximum(np.asarray(x, np.int64), 2)
    e = np.ceil(np.log2(x.astype(np.float64))).astype(np.int64)
    return np.maximum(np.int64(lo), np.int64(1) << e)


def _p32(a):
    return a.ctypes.data_as(_i32p)


def _p64(a):
    return a.ctypes.data_as(_i64p)


def _pu8(a):
    return a.ctypes.data_as(_u8p)


def dp_params(aa):
    """Scoring parameters of the two DP phases: (gap kwargs, extension
    kwargs) for the sw_cuda entries."""
    gap = dict(go=aa.go_cost, ge=aa.ge_cost, rc=aa.r_cost, ms=aa.m_score,
               max_gap=aa.max_gap, max_intron=aa.max_intron)
    return gap, dict(gap, band_width=aa.band_width, x_cutoff=aa.x_cutoff)


def gap_dispatch(lbws, rbws, rg):
    """(wband, banded) for a gap bucket: the band-relative kernel takes it
    when the pow2 band is at most MAX_WBAND and narrower than the
    reference tier; otherwise the full-width kernel does."""
    wband = _pow2(int((lbws + rbws).max()) + 1)
    return wband, wband <= MAX_WBAND and wband < rg + 1


def _slices(n, per_problem_bytes):
    """[lo, hi) launch ranges holding at most MAX_LAUNCH_BYTES each."""
    step = max(1, MAX_LAUNCH_BYTES // max(1, per_problem_bytes))
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def _env_on(name):
    return os.environ.get(name, "1") != "0"


class StagedAligner:
    """Batch aligner over ParsedReads with the DP phases on `device`.

    device: a CUDA device runs the hand-written kernels; "cpu" runs their
    plain PyTorch versions (the tests' configuration).
    inline_small: None takes YT_STAGED_INLINE (default on).
    device_assembly, rle: see the module docstring; None takes
    YT_STAGED_DEVRES / YT_STAGED_RLE (default on).
    seeder: a models/seeder.DeviceSeeder runs the seed phase on its
    device (--seed device); None keeps the native host seed scan.
    backend: "cuda", "torch" or "native" (the module docstring); rle
    applies to "cuda" only, and "native" fetches every problem on the
    host (device_assembly off).
    """

    def __init__(self, aa, genome, index, device="cuda", n_threads=1,
                 inline_small=None, device_assembly=None, rle=None,
                 seeder=None, backend="cuda"):
        if backend not in BACKENDS:
            raise ValueError("StagedAligner: backend %r is not one of %s"
                             % (backend, ", ".join(BACKENDS)))
        self.backend = backend
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StagedAligner: device %s requested but no "
                               "CUDA device is available" % self.device)
        self.aa = aa
        self.genome = genome
        self.index = index
        self.n_threads = max(1, int(n_threads))
        self.seeder = seeder
        if inline_small is None:
            inline_small = _env_on("YT_STAGED_INLINE")
        self.inline_small = inline_small
        self.lib = host._load()
        self.gap_kw, self.ext_kw = dp_params(aa)
        self.rle = backend == "cuda" and (
            _env_on("YT_STAGED_RLE") if rle is None else bool(rle))
        if device_assembly is None:
            device_assembly = _env_on("YT_STAGED_DEVRES")
        device_assembly = device_assembly and backend != "native"
        self.corpus = None
        if device_assembly:
            codes = np.ctypeslib.as_array(
                ct.cast(genome.codes_buf, _u8p),
                shape=(int(genome.codes_len),))
            self.corpus = DeviceCorpus(codes, self.device)
        self.tables = (self.corpus.tables if self.corpus is not None
                       else code_tables(self.device))
        # Launch/byte accounting and the host-phase decomposition.
        # gap_banded / gap_full / gap_fallback count the gap problems the
        # band-relative kernel serves, and the full-width kernel serves at
        # rg <= 512 and above it (backend "cuda"); gap_twin the gap
        # problems of the "cuda" backend whose plane is too wide for the
        # wide route's warp (sw_cuda.full_wide_fits), which the lockstep
        # twin of ops/sw_batch.py takes on the device; plane_d2h_bytes is
        # the backtrack-plane part of d2h_bytes (0 when rle is on).
        # Seconds (perf_counter): device_s the DP dispatch (launches,
        # transfers, the upload of the chunk's reads, and the fetches'
        # waits on the card, dispatch_wait_s); begin_s, phase2_s and
        # finish_s the native phases; gap_host_s / ext_host_s each batch's
        # gap / extension phase less its own dispatch.  p1_scan_s,
        # p1_clumps_s and p1_stage1_s accumulate only while the recorder
        # is on: phase 1's thread-seconds of the host seed scan, of the
        # hit sort, coalesce and fragments-to-clumps, and of the clumps'
        # stage-1 alignment (native/host.profile_counters).
        self.stats = {"dp_launches": 0, "h2d_bytes": 0, "d2h_bytes": 0,
                      "plane_d2h_bytes": 0,
                      "gap_problems": 0, "ext_problems": 0,
                      "device_s": 0.0, "dispatch_wait_s": 0.0,
                      "gap_banded": 0, "gap_full": 0, "gap_fallback": 0,
                      "gap_twin": 0,
                      "begin_s": 0.0, "gap_host_s": 0.0, "phase2_s": 0.0,
                      "ext_host_s": 0.0, "finish_s": 0.0,
                      "p1_scan_s": 0.0, "p1_clumps_s": 0.0,
                      "p1_stage1_s": 0.0}
        # align_chunk may run concurrently from the CLI's prefetch
        # pipeline; the accumulator guards the read-modify-write, and each
        # batch's own dispatch seconds are its thread's (_batch.disp_s).
        self._stats_lock = threading.Lock()
        self._batch = threading.local()

    def _acc(self, **kv):
        with self._stats_lock:
            for k, v in kv.items():
                self.stats[k] += v

    def _h2d(self, nbytes):
        self._acc(h2d_bytes=nbytes)
        RECORDER.count(h2d=nbytes)

    def _dispatched(self, seconds):
        """Adds a dispatch span's seconds to device_s and to the batch's."""
        self._acc(device_s=seconds)
        self._batch.disp_s += seconds

    def _up(self, a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        self._h2d(t.numel() * t.element_size())
        return t.to(self.device)

    def _down(self, t, plane=False):
        """A blocking fetch: the dispatch.wait span."""
        with span("dispatch.wait") as sp:
            t0 = sp.start()
            a = t.cpu().numpy()
            wait = sp.stop(t0)
            sp.add(d2h=a.nbytes)
        self._acc(d2h_bytes=a.nbytes, dispatch_wait_s=wait,
                  plane_d2h_bytes=a.nbytes if plane else 0)
        return a

    def _chunk_rows(self, pr, lo, hi):
        """Device strand rows of reads [lo, hi): their sequence bytes
        upload as one contiguous slice of the parser's buffer, with their
        starts and lengths, and become codes on the device
        (gather_dp.chunk_strand_rows).  The reference's version maps and
        pads every base on the host first, which costs more than the
        transfer it halves."""
        offs = np.ctypeslib.as_array(pr.seq_offs, shape=(pr.n + 1,))
        seg0, seg1 = int(offs[lo]), int(offs[hi])
        seqs = np.ctypeslib.as_array(pr.seqs, shape=(max(seg1, 1),))
        lens = np.diff(offs[lo:hi + 1])
        lpad = _pow2(max(int(lens.max()) if hi > lo else 1, 64), 64)
        self._h2d((seg1 - seg0) + 16 * (hi - lo))
        return chunk_strand_rows(seqs[seg0:seg1], offs[lo:hi] - seg0, lens,
                                 lpad, self.tables)

    def _planes(self, dev_gather, n):
        """(q, r) u8 planes of a whole bucket assembled on the device, or
        None when the bucket was fetched on the host."""
        if dev_gather is None:
            return None
        self._h2d(COORD_BYTES * n)
        return dev_gather(n, False)

    def _problem_args(self, planes, qa, ra, lo, hi):
        """(q, r) u8 planes of launch slice [lo, hi): device planes, or
        host planes uploaded as fetched.  Packing them 4-bit on the host
        (pack4_host, for the *_p4 entries) costs more than the halved
        upload saves on the H100 (PERF.md)."""
        if planes is not None:
            return planes[0][lo:hi], planes[1][lo:hi]
        return self._up(qa[lo:hi]), self._up(ra[lo:hi])

    def _rle_items(self, rle, n_ops, scalars, cap):
        """Bring back one launch's walk results: the per-problem scalars
        and n_ops in one transfer, then every problem's items in one flat
        transfer, tier-compacted by item count.  Returns
        [(local_idx, items [g, t], t, n_ops, [scalar arrays])]."""
        host = self._down(torch.stack(list(scalars) + [n_ops]))
        nops = host[-1]
        if nops.min(initial=0) < 0:
            raise RuntimeError("device RLE walk: a walk needs more than "
                               "cap=%d items" % cap)
        n = len(nops)
        # Item-slot tiers: pow2 of the count (at least 8, at most cap); 0
        # for walks with no item (inactive extensions).
        tiers = np.where(nops == 0, 0,
                         np.minimum(_pow2_arr(np.maximum(nops, 1), 8), cap))
        order = np.argsort(tiers, kind="stable")
        t_sorted = tiers[order]
        total = int(t_sorted.sum())
        flat = np.zeros(0, np.int32)
        if total:
            src, t = self._up(np.stack([order, t_sorted]).astype(np.int32))
            flat = self._down(decode.gather_rle_flat(rle, n_ops, src, t,
                                                        total))
        parts = []
        bounds = np.searchsorted(t_sorted, np.unique(t_sorted))
        starts = np.concatenate([[0], np.cumsum(t_sorted)])
        for g0, g1 in zip(bounds, list(bounds[1:]) + [n]):
            lidx = order[g0:g1]
            t = int(t_sorted[g0])
            items = flat[starts[g0]:starts[g1]].reshape(g1 - g0, t)
            parts.append((lidx, np.ascontiguousarray(items), t,
                          np.ascontiguousarray(nops[lidx]),
                          [np.ascontiguousarray(s[lidx])
                           for s in host[:-1]]))
        return parts

    def _eoidc_parts(self, name, fns, kw, arrs, per, planes, qa, ra, keys,
                     backend=None):
        """The "torch" and "native" backends on one bucket (or `backend`,
        the "torch" twin for a bucket of the "cuda" backend), the span
        `name`: fns[backend](q, qlens, r, rlens, *rest, **kw) for arrs =
        [qlens, rlens, *rest], in launch slices of at most
        MAX_LAUNCH_BYTES (`per` bytes a problem), on the device's or the
        host's problem planes; returns [(local_idx, FMT_EOIDC, eo, idc,
        plane_stride, row_stride, *the per-problem outputs of `keys`)]."""
        backend = backend or self.backend
        fn = fns[backend]
        n = len(arrs[0])
        parts = []
        with span(name, problems=n) as sp:
            t0 = sp.start()
            if backend == "torch":
                arrs = list(self._up(np.stack(arrs).astype(np.int32)))
            for lo, hi in _slices(n, per):
                self._acc(dp_launches=1)
                sp.add(launches=1)
                ql, rl, *rest = (a[lo:hi] for a in arrs)
                if backend == "native":
                    out = fn(qa[lo:hi], ql, ra[lo:hi], rl, *rest, **kw)
                    scalars = [out[k] for k in keys]
                    eo, idc = out["eo"], out["idc"]
                else:
                    q, r = self._problem_args(planes, qa, ra, lo, hi)
                    out = fn(q, ql, r, rl, *rest, **kw)
                    scalars = list(self._down(torch.stack([out[k]
                                                           for k in keys])))
                    eo = self._down(out["eo"], plane=True)
                    idc = self._down(out["idc"], plane=True)
                parts.append((np.arange(lo, hi), FMT_EOIDC, eo, idc,
                              eo.shape[1] * eo.shape[2], eo.shape[2],
                              *(np.ascontiguousarray(a, np.int32)
                                for a in scalars)))
            self._dispatched(sp.stop(t0))
        return parts

    def _run_gap_bucket(self, qa, qlens, ra, rlens, lbws, rbws, qg=None,
                        rg=None, dev_gather=None):
        """Returns result parts [(local_idx, fmt, plane, idc, plane_stride,
        row_stride, score)]: FMT_RLE items, or packed planes
        [m, QL+1, row_stride], band-relative (FMT_PACKED_BAND) or
        full-width (FMT_PACKED); FMT_EOIDC planes [m, QL+1, RL+1] for the
        "torch" and "native" backends.  `dev_gather(m, pack)` assembles the
        (q, r) planes on the device (qa/ra are None then)."""
        n = len(qlens)
        if qg is None:
            qg, rg = qa.shape[1], ra.shape[1]
        wband, banded = gap_dispatch(lbws, rbws, rg)
        twin = (self.backend == "cuda" and not banded and
                not sw_cuda.full_wide_fits(rg))
        if self.backend != "cuda" or twin:
            # A plane too wide for the wide route's warp goes to the
            # lockstep twin, as the reference sends its gap_fallback class
            # to its XLA twin.
            self._acc(gap_twin=n if twin else 0)
            return self._eoidc_parts(
                "dispatch.gap",
                {"native": host.anchored_forward,
                 "torch": sw_batch.batched_anchored_forward}, self.gap_kw,
                [qlens, rlens, lbws, rbws],
                5 * (qg + 1) * (rg + 1) + qg + rg + 16,
                self._planes(dev_gather, n), qa, ra, ["score"],
                backend="torch" if twin else None)
        self._acc(**{("gap_banded" if banded else "gap_full"
                      if rg <= MAX_WBAND else "gap_fallback"): n})
        w = wband if banded else rg + 1
        cap = _pow2(2 * qg + w + 2 if banded else qg + rg + 2, 32)
        per = ((qg + 1) * w + 12 * (w + 2) + qg + rg + 16 +
               (4 * cap if self.rle else 0))
        parts = []
        with span("dispatch.gap", problems=n) as sp:
            t0 = sp.start()
            lens = self._up(np.stack([qlens, rlens, lbws, rbws]).astype(
                np.int32))
            planes = self._planes(dev_gather, n)
            for lo, hi in _slices(n, per):
                q, r = self._problem_args(planes, qa, ra, lo, hi)
                ql, rl, lb, rb = lens[:, lo:hi]
                self._acc(dp_launches=1)
                sp.add(launches=1)
                if banded:
                    out = sw_cuda.anchored_forward_banded(
                        q, ql, r, rl, lb, rb, wband=wband, **self.gap_kw)
                    bt = out["bt_b"]
                else:
                    out = sw_cuda.anchored_forward(q, ql, r, rl, lb, rb,
                                                   **self.gap_kw)
                    bt = out["bt"]
                if not self.rle:
                    score = self._down(out["score"])
                    bt = self._down(bt, plane=True)
                    parts.append((np.arange(lo, hi), FMT_PACKED_BAND
                                  if banded else FMT_PACKED, bt, None,
                                  bt.shape[1] * bt.shape[2], bt.shape[2],
                                  score))
                    continue
                # Anchored walks start at the corner (qlen, rlen).
                if banded:
                    items, n_ops = decode.rle_decode_band(
                        bt, ql, rl - ql + lb, torch.ones_like(ql, dtype=bool),
                        cap=cap)
                else:
                    items, n_ops = decode.rle_decode_full(
                        bt, ql, rl, torch.ones_like(ql, dtype=bool), cap=cap)
                for lidx, arr, t, idc, (score,) in self._rle_items(
                        items, n_ops, [out["score"]], cap):
                    parts.append((lo + lidx, FMT_RLE, arr, idc, t, 0, score))
            self._dispatched(sp.stop(t0))
        return parts

    def _run_ext_bucket(self, qa, qlens, ra, rlens, qg=None, rg=None,
                        dev_gather=None):
        """Returns result parts [(local_idx, fmt, plane, idc, plane_stride,
        row_stride, maxi, maxj, score)]: FMT_RLE items, or FMT_PACKED
        planes [m, rows, W] trimmed to pow2 row tiers of maxi + 1 (the
        backtrack walks down from (maxi, maxj)), gathered and sliced on the
        device before one transfer; FMT_EOIDC planes [m, QL+1, W] for the
        "torch" and "native" backends."""
        n = len(qlens)
        if qg is None:
            qg, rg = qa.shape[1], ra.shape[1]
        w = 4 * self.aa.band_width + 1
        if self.backend != "cuda":
            return self._eoidc_parts(
                "dispatch.ext",
                {"native": host.extension_forward,
                 "torch": sw_batch.batched_extension_forward}, self.ext_kw,
                [qlens, rlens], 5 * (qg + 1) * w + qg + rg + 8,
                self._planes(dev_gather, n), qa, ra,
                ["maxi", "maxj", "score"])
        cap = _pow2(2 * qg + w + 2, 32)
        per = ((qg + 1) * w + 12 * (w + 2) + qg + rg + 8 +
               (4 * cap if self.rle else 0))
        parts = []
        with span("dispatch.ext", problems=n) as sp:
            t0 = sp.start()
            lens = self._up(np.stack([qlens, rlens]).astype(np.int32))
            planes = self._planes(dev_gather, n)
            for lo, hi in _slices(n, per):
                q, r = self._problem_args(planes, qa, ra, lo, hi)
                ql, rl = lens[:, lo:hi]
                self._acc(dp_launches=1)
                sp.add(launches=1)
                out = sw_cuda.extension_forward(q, ql, r, rl, **self.ext_kw)
                smm = [out["score"], out["maxi"], out["maxj"]]
                if self.rle:
                    # Walks start at the best cell; score <= 0 emits
                    # nothing.
                    items, n_ops = decode.rle_decode_band(
                        out["bt"], out["maxi"], out["maxj"],
                        out["score"] > 0, cap=cap)
                    for lidx, arr, t, idc, (score, maxi, maxj) in \
                            self._rle_items(items, n_ops, smm, cap):
                        parts.append((lo + lidx, FMT_RLE, arr, idc, t, 0,
                                      maxi, maxj, score))
                    continue
                score, maxi, maxj = self._down(torch.stack(smm))
                bt = out["bt"]
                rows = bt.shape[1]
                tiers = np.minimum(
                    _pow2_arr(np.minimum(maxi.astype(np.int64) + 1, rows),
                              64), rows)
                groups = [(t, np.nonzero(tiers == t)[0])
                          for t in np.unique(tiers)]
                flat = self._down(torch.cat([
                    bt.index_select(0, self._up(lidx))[:, :int(t)].reshape(
                        -1) for t, lidx in groups]), plane=True)
                off = 0
                for t, lidx in groups:
                    size = len(lidx) * int(t) * w
                    btp = flat[off:off + size].reshape(len(lidx), int(t), w)
                    off += size
                    parts.append((lo + lidx, FMT_PACKED, btp, None,
                                  btp.shape[1] * w, w, maxi[lidx],
                                  maxj[lidx], score[lidx]))
            self._dispatched(sp.stop(t0))
        return parts

    # ---- phase loops: pow2 buckets of the native problem lists, every
    # bucket assembled on the device when rows2 is given ----

    def _meta2(self, ctx, n, fn):
        """Fetch the device-assembly coordinates for a phase."""
        q_row = np.empty(n, np.int32)
        q_src = np.empty(n, np.int32)
        q_copy = np.empty(n, np.int32)
        r_src = np.empty(n, np.int64)
        r_copy = np.empty(n, np.int32)
        fn(ctx, _p32(q_row), _p32(q_src), _p32(q_copy), _p64(r_src),
           _p32(r_copy))
        return q_row, q_src, q_copy, r_src, r_copy

    def _mk_gather(self, rows2, meta2, idx, qlen, rlen, rev, rpad,
                   qg, rg):
        """Device plane assembler for one bucket slice: `g(m, pack)` pads
        the coordinate arrays to m problems and gathers on the device."""
        q_row, q_src, q_copy, r_src, r_copy = meta2

        def g(mpad, pack, _i=idx):
            mp = mpad - len(_i)
            pz = lambda a: np.pad(a[_i], (0, mp))
            return self.corpus.gather(
                rows2, pz(q_row), pz(q_src), pz(q_copy), pz(qlen),
                pz(r_src), pz(r_copy), pz(rlen),
                pz(rev) if rev is not None else None,
                qg=qg, rg=rg, rpad=rpad, pack=pack)
        return g

    def _gap_phase(self, ctx, rows2=None):
        lib = self.lib
        n = int(lib.yt_batch_gap_count(ctx))
        self._acc(gap_problems=n)
        if n == 0:
            return
        qlen, rlen, lbw, rbw = (np.empty(n, np.int32) for _ in range(4))
        lib.yt_batch_gap_meta(ctx, _p32(qlen), _p32(rlen), _p32(lbw),
                              _p32(rbw))
        meta2 = None
        if rows2 is not None:
            meta2 = self._meta2(ctx, n, lib.yt_batch_gap_meta2)
        keys = (_pow2_arr(qlen) << 32) | _pow2_arr(rlen)
        for key in np.unique(keys):
            bidx = np.nonzero(keys == key)[0].astype(np.int64)
            qg = int(key >> 32)
            rg = int(key & 0xFFFFFFFF)
            for lo in range(0, len(bidx), MAX_DEVICE_BATCH):
                idx = np.ascontiguousarray(bidx[lo:lo + MAX_DEVICE_BATCH])
                m = len(idx)
                qa = ra = dev_gather = None
                if meta2 is not None:
                    dev_gather = self._mk_gather(rows2, meta2, idx, qlen,
                                                 rlen, None, 0, qg, rg)
                else:
                    qa = np.zeros((m, qg), np.uint8)
                    ra = np.zeros((m, rg), np.uint8)
                    lib.yt_batch_gap_fetch(ctx, m, _p64(idx), _pu8(qa), qg,
                                           _pu8(ra), rg)
                ql_b, rl_b, lb_b, rb_b = (a[idx].astype(np.int64) for a in
                                          (qlen, rlen, lbw, rbw))
                for (lidx, fmt, plane, idc, pstride, rstride,
                     score) in self._run_gap_bucket(
                         qa, ql_b, ra, rl_b, lb_b, rb_b, qg=qg, rg=rg,
                         dev_gather=dev_gather):
                    gidx = np.ascontiguousarray(idx[lidx])
                    lib.yt_batch_gap_apply(
                        ctx, fmt, len(gidx), _p64(gidx),
                        plane.ctypes.data_as(ct.c_void_p),
                        _p32(idc) if idc is not None else None,
                        pstride, rstride, _p32(score))

    def _ext_phase(self, ctx, rows2=None):
        lib = self.lib
        n = int(lib.yt_batch_ext_count(ctx))
        self._acc(ext_problems=n)
        if n == 0:
            return
        qlen = np.empty(n, np.int32)
        rlen = np.empty(n, np.int32)
        rev = np.empty(n, np.uint8)
        lib.yt_batch_ext_meta(ctx, _p32(qlen), _p32(rlen), _pu8(rev))
        meta2 = None
        if rows2 is not None:
            meta2 = self._meta2(ctx, n, lib.yt_batch_ext_meta2)
        bw2 = 2 * self.aa.band_width
        qb = _pow2_arr(qlen)
        for key in np.unique(qb):
            bidx = np.nonzero(qb == key)[0].astype(np.int64)
            qg = int(key)
            rg = qg + 2 * bw2
            for lo in range(0, len(bidx), MAX_DEVICE_BATCH):
                idx = np.ascontiguousarray(bidx[lo:lo + MAX_DEVICE_BATCH])
                m = len(idx)
                qa = ra = dev_gather = None
                if meta2 is not None:
                    dev_gather = self._mk_gather(rows2, meta2, idx, qlen,
                                                 rlen, rev, 255, qg, rg)
                else:
                    qa = np.zeros((m, qg), np.uint8)
                    ra = np.full((m, rg), 255, np.uint8)
                    lib.yt_batch_ext_fetch(ctx, m, _p64(idx), _pu8(qa), qg,
                                           _pu8(ra), rg)
                ql_b = qlen[idx].astype(np.int64)
                rl_b = rlen[idx].astype(np.int64)
                for (lidx, fmt, plane, idc, pstride, rstride, maxi, maxj,
                     score) in self._run_ext_bucket(
                         qa, ql_b, ra, rl_b, qg=qg, rg=rg,
                         dev_gather=dev_gather):
                    gidx = np.ascontiguousarray(idx[lidx])
                    lib.yt_batch_ext_apply(
                        ctx, fmt, len(gidx), _p64(gidx),
                        plane.ctypes.data_as(ct.c_void_p),
                        _p32(idc) if idc is not None else None,
                        pstride, rstride, _p32(maxi), _p32(maxj),
                        _p32(score))

    # ---- batch loop ----

    def align_chunk(self, pr, lo: int, hi: int, dist=None,
                    want_stats=False):
        """Align reads [lo, hi) of a ParsedReads through the staged
        pipeline; returns (sam_bytes, seed_matches, records).  `dist`, if
        given, is a ctypes (c_int64 * 11) array filled with the per-batch
        STATS distributions (as host.align_batch_native).  `want_stats`
        appends a fourth return: the QUERYSTATS TSV rows (-qs), with the
        per-read usec measured inside the native phases (batched device
        time is not per-read attributable and is left out)."""
        lib = self.lib
        aa = self.aa
        genome = self.genome
        index = self.index
        ip, fp = host._pack_params_ct(aa, self.n_threads)
        self._batch.disp_s = 0.0
        rows2 = None
        if self.corpus is not None or self.seeder is not None:
            # The chunk's read bytes upload before the native phase 1, so
            # the copy overlaps the seed/chain/clump host work; the
            # dispatch counts as device time.
            with span("staged.upload", reads=hi - lo) as sp:
                t0 = sp.start()
                rows2 = self._chunk_rows(pr, lo, hi)
                self._dispatched(sp.stop(t0))
        seeds = None
        if self.seeder is not None:
            # Device seed phase: sorted hit rows per (read, strand); rows
            # with total -1 take the host scan inside phase 1.  Its wall is
            # the seeder's seed_device_s, not part of begin_s.
            seeds = self.seeder.seed_chunk(pr, lo, hi, rows2)
        prof = RECORDER.recording()
        with span("staged.phase1", reads=hi - lo) as sp:
            t0 = sp.start()
            ctx = lib.yt_batch_begin(
                pr.seqs, host.off64(pr.seq_offs, lo), pr.ids,
                host.off64(pr.id_offs, lo), pr.quals if aa.fastq else None,
                hi - lo, ct.cast(genome.codes_buf, _u8p), genome.codes_len,
                genome.max_roff, ct.cast(genome._starts_arr, _i64p),
                ct.cast(genome._lens_arr, _i64p), genome.n_seqs,
                ct.cast(genome._names_blob, _u8p),
                ct.cast(genome._name_offs, _i64p),
                index.so_ptr, index.roa_ptr, index.roa_len,
                ct.cast(ip, _i64p), ct.cast(fp, ct.POINTER(ct.c_double)),
                1 if self.inline_small else 0,
                *((seeds[0].ctypes.data_as(_u32p), _p32(seeds[1]),
                   _p64(seeds[2]), _p64(seeds[3])) if seeds
                  else (None,) * 4), 1 if prof else 0)
            begin_s = sp.stop(t0)
            if ctx and prof:
                p1 = host.profile_counters(ctx)
                sp.add(**{k + "_s" if k in host.PROFILE_SECONDS else k: v
                          for k, v in p1.items()})
                self._acc(p1_scan_s=p1["scan_hash"] + p1["scan_so"] +
                          p1["scan_roa"],
                          p1_clumps_s=p1["sort"] + p1["f2c"] +
                          p1["hits_f2c"],
                          p1_stage1_s=p1["stage1"])
        if self.corpus is None:
            rows2 = None     # problems are fetched on the host
        if not ctx:
            raise RuntimeError("yt_batch_begin failed")
        try:
            self._acc(begin_s=begin_s)
            # Each phase's host time is its wall less its own dispatch
            # spans (this batch's, whatever the other batch adds).
            with span("staged.gap") as sp:
                t0 = sp.start()
                d0 = self._batch.disp_s
                self._gap_phase(ctx, rows2)
                gap_host = sp.stop(t0) - (self._batch.disp_s - d0)
                sp.add(host_s=gap_host)
            with span("staged.phase2") as sp:
                t0 = sp.start()
                lib.yt_batch_phase2(ctx)
                phase2 = sp.stop(t0)
            with span("staged.ext") as sp:
                t0 = sp.start()
                d0 = self._batch.disp_s
                self._ext_phase(ctx, rows2)
                ext_host = sp.stop(t0) - (self._batch.disp_s - d0)
                sp.add(host_s=ext_host)
            out_text = ct.c_void_p()
            out_len = ct.c_int64()
            sm = ct.c_int64()
            nr = ct.c_int64()
            with span("staged.finish") as sp:
                t0 = sp.start()
                rc = lib.yt_batch_finish(
                    ctx, ct.byref(out_text), ct.byref(out_len),
                    ct.byref(sm), ct.byref(nr),
                    ct.cast(dist, _i64p) if dist is not None else None)
                assert rc == 0
                try:
                    text = ct.string_at(out_text, out_len.value)
                finally:
                    lib.yt_free(out_text)
                finish = sp.stop(t0)
                sp.add(bytes=len(text))
            self._acc(gap_host_s=gap_host, phase2_s=phase2,
                      ext_host_s=ext_host, finish_s=finish)
            if not want_stats:
                return text, int(sm.value), int(nr.value)
            n = hi - lo
            ql, sd, al, us = (np.empty(n, np.int64) for _ in range(4))
            lib.yt_batch_query_stats(ctx, _p64(ql), _p64(sd), _p64(al),
                                     _p64(us))
            id_offs = np.ctypeslib.as_array(pr.id_offs, shape=(pr.n + 1,))
            blob = np.ctypeslib.as_array(
                pr.ids, shape=(max(int(id_offs[pr.n]), 1),)).tobytes()
            rows = []
            for i in range(n):
                a, b = int(id_offs[lo + i]), int(id_offs[lo + i + 1])
                rows.append(b"%s\t%d\t%d\t%d\t%d\n" % (
                    blob[a:b], ql[i], sd[i], al[i], us[i]))
            return text, int(sm.value), int(nr.value), b"".join(rows)
        finally:
            with span("staged.free"):
                lib.yt_batch_free(ctx)
