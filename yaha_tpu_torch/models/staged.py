"""Staged batch engine on PyTorch + CUDA: native host phases + DP on the card.

Counterpart of yaha_tpu/models/staged.py with backend "cuda".  The native
C++ staged pipeline runs every per-read phase (parse, seed, chain, clumps,
score/split, OQC/FBS, SAM); the two batched DP phases run on the card:

  phase A  anchored gap fills   -> sw_cuda.anchored_forward_banded, or
                                   sw_cuda.anchored_forward for bands
                                   wider than 512 or the whole reference
  phase B  banded X-drop extensions -> sw_cuda.extension_forward

The default configuration is the JAX package's default one:

  device_assembly  the genome codes stay on the card for the run, each
                   chunk's read bytes upload once and become strand rows
                   there, and every problem's (q, r) planes are cut on the
                   card from coordinates (ops/gather_dp.py);
  rle              the backtrack planes are walked on the card
                   (ops/decode.py) and only run-length items come back, to
                   the native FMT_RLE apply.

With device_assembly off, problems are fetched on the host
(yt_batch_*_fetch) and upload as u8 planes; with rle off, the packed planes come back to the native walkers
(FMT_PACKED / FMT_PACKED_BAND).  Both off is the A/B configuration
(YT_STAGED_DEVRES=0 YT_STAGED_RLE=0).  Nothing switches configuration on an
error.  Every configuration is byte-identical to the per-read native
engine.  The batch loop (align_chunk), the stats and the bucketing rules
are inherited.
"""
from __future__ import annotations

import ctypes as ct
import os
import time

import numpy as np
import torch

from yaha_tpu.models import staged as _ref
from yaha_tpu.models.staged import (FMT_PACKED, FMT_PACKED_BAND, FMT_RLE,
                                    MAX_DEVICE_BATCH, _p32, _p64, _pow2,
                                    _pow2_arr, _pu8)
from ..ops import decode, sw_cuda
from ..ops.gather_dp import COORD_BYTES, DeviceCorpus

# Bound on one launch's backtrack plane, DP scratch and item buffer:
# buckets slice further when MAX_DEVICE_BATCH problems would exceed it (a
# 16384-problem extension launch at the 16384-row tier is 5.6 GB of plane).
MAX_LAUNCH_BYTES = 1 << 32

# Widest band the band-relative gap kernel takes (the Pallas dispatch
# rule, yaha_tpu/models/staged.py _run_gap_bucket).
MAX_WBAND = 512


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


class StagedAligner(_ref.StagedAligner):
    """Batch aligner over ParsedReads with the DP phases on `device`.

    device: a CUDA device runs the hand-written kernels; "cpu" runs their
    plain PyTorch versions (the tests' configuration).
    device_assembly, rle: see the module docstring; None takes
    YT_STAGED_DEVRES / YT_STAGED_RLE (default on).
    """

    def __init__(self, aa, genome, index, device="cuda", n_threads=1,
                 inline_small=None, device_assembly=None, rle=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StagedAligner: device %s requested but no "
                               "CUDA device is available" % self.device)
        super().__init__(aa, genome, index, backend="cuda",
                         n_threads=n_threads, inline_small=inline_small)
        self.gap_kw, self.ext_kw = dp_params(aa)
        self.rle = _env_on("YT_STAGED_RLE") if rle is None else bool(rle)
        if device_assembly is None:
            device_assembly = _env_on("YT_STAGED_DEVRES")
        if device_assembly:
            codes = np.ctypeslib.as_array(
                ct.cast(genome.codes_buf, ct.POINTER(ct.c_uint8)),
                shape=(int(genome.codes_len),))
            self.corpus = DeviceCorpus(codes, self.device)
        # Backtrack-plane bytes among d2h_bytes: 0 when rle is on.
        self.stats["plane_d2h_bytes"] = 0

    def _up(self, a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        self._acc(h2d_bytes=t.numel() * t.element_size())
        return t.to(self.device)

    def _down(self, t, plane=False):
        a = t.cpu().numpy()
        self._acc(d2h_bytes=a.nbytes,
                  plane_d2h_bytes=a.nbytes if plane else 0)
        return a

    def _chunk_rows(self, pr, lo, hi):
        """Device strand rows of reads [lo, hi): their sequence bytes
        upload as one contiguous slice of the parser's buffer, with their
        starts and lengths, and become codes on the device
        (DeviceCorpus.read_rows).  The reference's version maps and pads
        every base on the host first, which costs more than the transfer
        it halves."""
        offs = np.ctypeslib.as_array(pr.seq_offs, shape=(pr.n + 1,))
        seg0, seg1 = int(offs[lo]), int(offs[hi])
        seqs = np.ctypeslib.as_array(pr.seqs, shape=(max(seg1, 1),))
        lens = np.diff(offs[lo:hi + 1])
        lpad = _pow2(max(int(lens.max()) if hi > lo else 1, 64), 64)
        self._acc(h2d_bytes=(seg1 - seg0) + 16 * (hi - lo))
        return self.corpus.read_rows(seqs[seg0:seg1], offs[lo:hi] - seg0,
                                     lens, lpad)

    def _planes(self, dev_gather, n):
        """(q, r) u8 planes of a whole bucket assembled on the device, or
        None when the bucket was fetched on the host."""
        if dev_gather is None:
            return None
        self._acc(h2d_bytes=COORD_BYTES * n)
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
            flat = self._down(decode.gather_rle_flat(rle, src, t, total))
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

    def _run_gap_bucket(self, qa, qlens, ra, rlens, lbws, rbws, qg=None,
                        rg=None, dev_gather=None):
        """Returns result parts [(local_idx, fmt, plane, idc, plane_stride,
        row_stride, score)]: FMT_RLE items, or packed planes
        [m, QL+1, row_stride], band-relative (FMT_PACKED_BAND) or
        full-width (FMT_PACKED).  `dev_gather(m, pack)` assembles the (q, r)
        planes on the device (qa/ra are None then)."""
        n = len(qlens)
        if qg is None:
            qg, rg = qa.shape[1], ra.shape[1]
        wband, banded = gap_dispatch(lbws, rbws, rg)
        self._acc(**{("gap_banded" if banded else "gap_full"
                      if rg <= MAX_WBAND else "gap_fallback"): n})
        w = wband if banded else rg + 1
        cap = _pow2(2 * qg + w + 2 if banded else qg + rg + 2, 32)
        per = ((qg + 1) * w + 12 * (w + 2) + qg + rg + 16 +
               (4 * cap if self.rle else 0))
        parts = []
        t0 = time.time()
        lens = self._up(np.stack([qlens, rlens, lbws, rbws]).astype(np.int32))
        planes = self._planes(dev_gather, n)
        for lo, hi in _slices(n, per):
            q, r = self._problem_args(planes, qa, ra, lo, hi)
            ql, rl, lb, rb = lens[:, lo:hi]
            self._acc(dp_launches=1)
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
                parts.append((np.arange(lo, hi), FMT_PACKED_BAND if banded
                              else FMT_PACKED, bt, None,
                              bt.shape[1] * bt.shape[2], bt.shape[2], score))
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
        self._acc(device_s=time.time() - t0)
        return parts

    def _run_ext_bucket(self, qa, qlens, ra, rlens, qg=None, rg=None,
                        dev_gather=None):
        """Returns result parts [(local_idx, fmt, plane, idc, plane_stride,
        row_stride, maxi, maxj, score)]: FMT_RLE items, or FMT_PACKED
        planes [m, rows, W] trimmed to pow2 row tiers of maxi + 1 (the
        backtrack walks down from (maxi, maxj)), gathered and sliced on the
        device before one transfer."""
        n = len(qlens)
        if qg is None:
            qg, rg = qa.shape[1], ra.shape[1]
        w = 4 * self.aa.band_width + 1
        cap = _pow2(2 * qg + w + 2, 32)
        per = ((qg + 1) * w + 12 * (w + 2) + qg + rg + 8 +
               (4 * cap if self.rle else 0))
        parts = []
        t0 = time.time()
        lens = self._up(np.stack([qlens, rlens]).astype(np.int32))
        planes = self._planes(dev_gather, n)
        for lo, hi in _slices(n, per):
            q, r = self._problem_args(planes, qa, ra, lo, hi)
            ql, rl = lens[:, lo:hi]
            self._acc(dp_launches=1)
            out = sw_cuda.extension_forward(q, ql, r, rl, **self.ext_kw)
            smm = [out["score"], out["maxi"], out["maxj"]]
            if self.rle:
                # Walks start at the best cell; score <= 0 emits nothing.
                items, n_ops = decode.rle_decode_band(
                    out["bt"], out["maxi"], out["maxj"], out["score"] > 0,
                    cap=cap)
                for lidx, arr, t, idc, (score, maxi, maxj) in \
                        self._rle_items(items, n_ops, smm, cap):
                    parts.append((lo + lidx, FMT_RLE, arr, idc, t, 0, maxi,
                                  maxj, score))
                continue
            score, maxi, maxj = self._down(torch.stack(smm))
            bt = out["bt"]
            rows = bt.shape[1]
            tiers = np.minimum(
                _pow2_arr(np.minimum(maxi.astype(np.int64) + 1, rows), 64),
                rows)
            groups = [(t, np.nonzero(tiers == t)[0])
                      for t in np.unique(tiers)]
            flat = self._down(torch.cat([
                bt.index_select(0, self._up(lidx))[:, :int(t)].reshape(-1)
                for t, lidx in groups]), plane=True)
            off = 0
            for t, lidx in groups:
                size = len(lidx) * int(t) * w
                btp = flat[off:off + size].reshape(len(lidx), int(t), w)
                off += size
                parts.append((lo + lidx, FMT_PACKED, btp, None,
                              btp.shape[1] * w, w, maxi[lidx], maxj[lidx],
                              score[lidx]))
        self._acc(device_s=time.time() - t0)
        return parts

    # The phase loops follow the reference's, with every bucket assembled
    # on the device when rows2 is given (no paging, so no host-fetch
    # routing): the reference's versions import its jax assembly module.

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
                self._acc(gap_cells=int((np.minimum(
                    lb_b + rb_b + 1, rl_b + 1) * ql_b).sum()))
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
                self._acc(ext_cells=int((ql_b * (2 * bw2 + 1)).sum()))
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
