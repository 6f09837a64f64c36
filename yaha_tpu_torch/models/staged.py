"""Staged batch engine on PyTorch + CUDA: native host phases + DP kernels.

Counterpart of yaha_tpu/models/staged.py with backend "cuda".  The native
C++ staged pipeline runs every per-read phase (parse, seed, chain, clumps,
score/split, OQC/FBS, SAM); the two batched DP phases run on the card:

  phase A  anchored gap fills   -> sw_cuda.anchored_forward_banded, or
                                   sw_cuda.anchored_forward for bands
                                   wider than 512 or the whole reference
  phase B  banded X-drop extensions -> sw_cuda.extension_forward

Problems are fetched on the host (yt_batch_*_fetch), uploaded as u8
planes, and the packed backtrack planes come back to the native walkers
(FMT_PACKED / FMT_PACKED_BAND), so the output is byte-identical to the
per-read native engine.  Only the DP phase methods are overridden; the
driver (align_chunk), the stats and the bucketing rules are inherited.
"""
from __future__ import annotations

import ctypes as ct
import time

import numpy as np
import torch

from yaha_tpu.models import staged as _ref
from yaha_tpu.models.staged import (FMT_PACKED, FMT_PACKED_BAND,
                                    MAX_DEVICE_BATCH, _p32, _p64, _pow2,
                                    _pow2_arr, _pu8)

from ..ops import sw_cuda

# Bound on one launch's backtrack plane plus DP scratch: buckets slice
# further when MAX_DEVICE_BATCH problems would exceed it (a 16384-problem
# extension launch at the 16384-row tier is 5.6 GB of plane).
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


class StagedAligner(_ref.StagedAligner):
    """Batch aligner over ParsedReads with the DP phases on `device`.

    device: a CUDA device runs the hand-written kernels; "cpu" runs their
    plain PyTorch versions (the tests' configuration).
    """

    def __init__(self, aa, genome, index, device="cuda", n_threads=1,
                 inline_small=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StagedAligner: device %s requested but no "
                               "CUDA device is available" % self.device)
        super().__init__(aa, genome, index, backend="cuda",
                         n_threads=n_threads, inline_small=inline_small)
        self.gap_kw, self.ext_kw = dp_params(aa)

    def _up(self, a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        self._acc(h2d_bytes=t.numel() * t.element_size())
        return t.to(self.device)

    def _down(self, t):
        a = t.cpu().numpy()
        self._acc(d2h_bytes=a.nbytes)
        return a

    def _run_gap_bucket(self, qa, qlens, ra, rlens, lbws, rbws):
        """Returns result parts [(local_idx, fmt, plane, score)]: packed
        planes [m, QL+1, row_stride], band-relative (FMT_PACKED_BAND) or
        full-width (FMT_PACKED)."""
        n = len(qlens)
        qg, rg = qa.shape[1], ra.shape[1]
        wband, banded = gap_dispatch(lbws, rbws, rg)
        self._acc(**{("gap_banded" if banded else "gap_full"
                      if rg <= MAX_WBAND else "gap_fallback"): n})
        w = wband if banded else rg + 1
        per = (qg + 1) * w + 12 * (w + 2) + qg + rg + 16
        parts = []
        t0 = time.time()
        for lo, hi in _slices(n, per):
            args = [self._up(a[lo:hi])
                    for a in (qa, qlens, ra, rlens, lbws, rbws)]
            self._acc(dp_launches=1)
            if banded:
                out = sw_cuda.anchored_forward_banded(*args, wband=wband,
                                                      **self.gap_kw)
                bt = out["bt_b"]
            else:
                out = sw_cuda.anchored_forward(*args, **self.gap_kw)
                bt = out["bt"]
            score = self._down(out["score"])
            bt = self._down(bt)
            parts.append((np.arange(lo, hi), FMT_PACKED_BAND if banded
                          else FMT_PACKED, bt, score))
        self._acc(device_s=time.time() - t0)
        return parts

    def _run_ext_bucket(self, qa, qlens, ra, rlens):
        """Returns result parts [(local_idx, plane, maxi, maxj, score)]
        with FMT_PACKED planes [m, rows, W].  Planes come back trimmed to
        pow2 row tiers of maxi + 1 (the backtrack walks down from (maxi,
        maxj)), gathered and sliced on the device before one transfer."""
        n = len(qlens)
        qg, rg = qa.shape[1], ra.shape[1]
        w = 4 * self.aa.band_width + 1
        per = (qg + 1) * w + 12 * (w + 2) + qg + rg + 8
        parts = []
        t0 = time.time()
        for lo, hi in _slices(n, per):
            args = [self._up(a[lo:hi]) for a in (qa, qlens, ra, rlens)]
            self._acc(dp_launches=1)
            out = sw_cuda.extension_forward(*args, **self.ext_kw)
            smm = self._down(torch.stack([out["score"], out["maxi"],
                                          out["maxj"]]))
            score, maxi, maxj = smm
            bt = out["bt"]
            rows = bt.shape[1]
            tiers = np.minimum(
                _pow2_arr(np.minimum(maxi.astype(np.int64) + 1, rows), 64),
                rows)
            groups = [(t, np.nonzero(tiers == t)[0])
                      for t in np.unique(tiers)]
            flat = self._down(torch.cat([
                bt.index_select(0, self._up(lidx))[:, :int(t)].reshape(-1)
                for t, lidx in groups]))
            off = 0
            for t, lidx in groups:
                size = len(lidx) * int(t) * w
                btp = flat[off:off + size].reshape(len(lidx), int(t), w)
                off += size
                parts.append((lo + lidx, btp, maxi[lidx], maxj[lidx],
                              score[lidx]))
        self._acc(device_s=time.time() - t0)
        return parts

    # The phase drivers are the reference's with host fetch only: the
    # reference's versions import its jax device-assembly module.

    def _gap_phase(self, ctx, rows2=None):
        lib = self.lib
        n = int(lib.yt_batch_gap_count(ctx))
        self._acc(gap_problems=n)
        if n == 0:
            return
        qlen, rlen, lbw, rbw = (np.empty(n, np.int32) for _ in range(4))
        lib.yt_batch_gap_meta(ctx, _p32(qlen), _p32(rlen), _p32(lbw),
                              _p32(rbw))
        keys = (_pow2_arr(qlen) << 32) | _pow2_arr(rlen)
        for key in np.unique(keys):
            bidx = np.nonzero(keys == key)[0].astype(np.int64)
            qg = int(key >> 32)
            rg = int(key & 0xFFFFFFFF)
            for lo in range(0, len(bidx), MAX_DEVICE_BATCH):
                idx = np.ascontiguousarray(bidx[lo:lo + MAX_DEVICE_BATCH])
                m = len(idx)
                qa = np.zeros((m, qg), np.uint8)
                ra = np.zeros((m, rg), np.uint8)
                lib.yt_batch_gap_fetch(ctx, m, _p64(idx), _pu8(qa), qg,
                                       _pu8(ra), rg)
                ql_b, rl_b, lb_b, rb_b = (a[idx] for a in (qlen, rlen, lbw,
                                                           rbw))
                self._acc(gap_cells=int((np.minimum(
                    lb_b.astype(np.int64) + rb_b + 1, rl_b + 1) *
                    ql_b.astype(np.int64)).sum()))
                for lidx, fmt, plane, score in self._run_gap_bucket(
                        qa, ql_b, ra, rl_b, lb_b, rb_b):
                    gidx = np.ascontiguousarray(idx[lidx])
                    lib.yt_batch_gap_apply(
                        ctx, fmt, len(gidx), _p64(gidx),
                        plane.ctypes.data_as(ct.c_void_p), None,
                        plane.shape[1] * plane.shape[2], plane.shape[2],
                        _p32(score))

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
        bw2 = 2 * self.aa.band_width
        qb = _pow2_arr(qlen)
        for key in np.unique(qb):
            bidx = np.nonzero(qb == key)[0].astype(np.int64)
            qg = int(key)
            rg = qg + 2 * bw2
            for lo in range(0, len(bidx), MAX_DEVICE_BATCH):
                idx = np.ascontiguousarray(bidx[lo:lo + MAX_DEVICE_BATCH])
                m = len(idx)
                qa = np.zeros((m, qg), np.uint8)
                ra = np.full((m, rg), 255, np.uint8)
                lib.yt_batch_ext_fetch(ctx, m, _p64(idx), _pu8(qa), qg,
                                       _pu8(ra), rg)
                ql_b, rl_b = qlen[idx], rlen[idx]
                self._acc(ext_cells=int(
                    (ql_b.astype(np.int64) * (2 * bw2 + 1)).sum()))
                for lidx, plane, maxi, maxj, score in self._run_ext_bucket(
                        qa, ql_b, ra, rl_b):
                    gidx = np.ascontiguousarray(idx[lidx])
                    lib.yt_batch_ext_apply(
                        ctx, FMT_PACKED, len(gidx), _p64(gidx),
                        plane.ctypes.data_as(ct.c_void_p), None,
                        plane.shape[1] * plane.shape[2], plane.shape[2],
                        _p32(maxi), _p32(maxj), _p32(score))
