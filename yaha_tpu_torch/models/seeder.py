"""Device seed phase for the staged engine (``--seed device``).

Counterpart of yaha_tpu/models/seeder.py.  Each chunk's strand rows (the
engine's own, ops/gather_dp.chunk_strand_rows) are hashed and expanded on
the device against the index's SO and ROA tables, which stay resident
there for the run, and the rows come back as per-(read, strand) hit lists
sorted by (diag, qo), which yt_batch_begin takes in place of its host seed
scan (hits_diag / hits_qo / hit_offs / hit_totals).

With a mesh (parallel/mesh.py, --model-shards) the index is split by hash
range over the grid's `model` columns and the rows over its `data` rows
(parallel/mesh.sharded_expand_sort): a row's hits are M shard buffers of C
slots merged into M C, and it overflows a tier when some shard passes C.
The rows start and end on grid entry (0, 0), the engine's device.
Reference match: Query.c:361-412 (seed loop) + QueryMatch.c:52-121 (heap
merge).

The reference's behaviour at its edges is kept:

  * capacity tiers (1024, 8192): the rows that overflow the first tier
    are expanded again, compacted, at the second; a row that overflows
    the second gets hit_totals = -1 and takes the native host scan for
    that strand (the per-query realloc analog, Query.c:81-100);
  * the phantom-hit quirk (QueryMatch.c:57-69): rows with a window whose
    whole run wraps (ro < qo) get the reference's phantom hits, computed
    on the host from just those rows (their codes and wrapped flags are
    the only rows fetched), merged in sorted position.

Hits leave the device as one masked_select per plane of the rows served,
in row order, plus one small transfer of total / overflow / allwrapped per
tier.  Spans (utils/timing): seeder.seed, a chunk's seed phase, with a
seeder.fetch under it for each blocking fetch (the tiers' totals, the hit
rows, the phantom rows' flags and codes) and a seeder.splice, the hit
rows' splice after seed_device_s stops; setup.seeder_upload, the
tables' upload.  The JAX seeder's pow2 batch padding, its pow2-padded ragged fetch
with the sort / unsort round trip and its ROA < 2^31 refusal have no
counterpart here.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..core.frags import phantom_hits
from ..ops import gather_dp, seeds
from ..utils.timing import RECORDER, span

M32 = 0xFFFFFFFF


class _IndexView:
    """The SO and ROA tables of a NativeIndex (io/native_loader.py) as
    uint32 numpy views of its mmap, zero-copy."""

    def __init__(self, index):
        self.word_len = index.word_len
        self.max_hits = index.max_hits
        ht = 1 << (2 * index.word_len)
        self.starting_offs = np.ctypeslib.as_array(index.so_ptr,
                                                   shape=(ht + 1,))
        self.roa = np.ctypeslib.as_array(
            index.roa_ptr, shape=(max(int(index.roa_len), 1),))


class DeviceSeeder:
    """Seed-phase provider for StagedAligner (its `seeder` argument).

    device: a CUDA device runs the kernels of ops/seeds.py, "cpu" their
    plain versions.  mesh: a parallel/mesh.Mesh shards the index over its
    `model` columns and the rows over its `data` rows, on its devices; the seeder's device is then the
    grid's (0, 0) entry.  None looks up the whole index on `device`.  The
    SO and ROA tables (or every shard's copy) upload once, here; their
    bytes and seconds are in stats["index_upload_bytes"] /
    ["index_upload_s"].
    """

    CAP_TIERS = (1024, 8192)

    def __init__(self, aa, index, device="cuda", mesh=None):
        self.mesh = mesh
        self.device = torch.device(device if mesh is None
                                   else mesh.grid[0][0])
        devices = ([self.device] if mesh is None else
                   [d for row in mesh.grid for d in row])
        if (any(d.type == "cuda" for d in devices) and
                not torch.cuda.is_available()):
            raise RuntimeError("DeviceSeeder: device %s requested but no "
                               "CUDA device is available" % self.device)
        self.aa = aa
        self.word_len = index.word_len
        # The views (and, on the CPU, the tables) share the index's mmap,
        # which the seeder keeps open.
        self.index = index
        self.iview = _IndexView(index)
        self.stats = {"seed_launches": 0, "seed_h2d_bytes": 0,
                      "seed_d2h_bytes": 0, "all_gather_bytes": 0,
                      "phantom_rows": 0, "fallback_rows": 0,
                      "seed_device_s": 0.0, "cap_retries": 0,
                      "index_upload_bytes": 0, "index_upload_s": 0.0}
        # seed_chunk may run concurrently under the CLI's depth-2 prefetch:
        # the stats' read-modify-writes take the lock.
        self._stats_lock = threading.Lock()
        self.tables = gather_dp.code_tables(self.device)
        self.sidx = None
        with span("setup.seeder_upload") as sp:
            t0 = sp.start()
            if mesh is not None:
                from ..parallel.mesh import ShardedIndex
                # Phantom rows read the host views (iview), not the
                # shards' host copies, which go once they are placed.
                self.sidx = ShardedIndex(self.iview,
                                         mesh.shape["model"]).place(mesh)
                nbytes = self.sidx.placed_nbytes()
            else:
                self.so_dev, self.roa_dev = (
                    torch.from_numpy(a.view(np.int32)).to(self.device)
                    for a in (self.iview.starting_offs, self.iview.roa))
                nbytes = (self.iview.starting_offs.nbytes +
                          self.iview.roa.nbytes)
            for d in set(devices):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            self._acc(index_upload_s=sp.stop(t0), index_upload_bytes=nbytes)
            sp.add(h2d=nbytes)

    def _acc(self, **kv):
        with self._stats_lock:
            for k, v in kv.items():
                self.stats[k] += v

    def _up(self, a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        self._acc(seed_h2d_bytes=t.numel() * t.element_size())
        RECORDER.count(h2d=t.numel() * t.element_size())
        return t.to(self.device)

    def _down(self, t):
        """A blocking fetch: the seeder.fetch span."""
        with span("seeder.fetch") as sp:
            a = t.cpu().numpy()
            sp.add(d2h=a.nbytes)
        self._acc(seed_d2h_bytes=a.nbytes)
        return a

    def _expand(self, hashes, clean, capacity):
        """One tier: the kernel, then (total, overflow, allwrapped) of its
        rows in one transfer."""
        self._acc(seed_launches=1)
        kw = dict(max_hits=int(self.aa.max_hits), capacity=capacity)
        if self.sidx is not None:
            from ..parallel.mesh import sharded_expand_sort
            out = sharded_expand_sort(self.mesh, hashes, clean, self.sidx,
                                      **kw)
            # The shards' buffers that the merge gathers: diag and qo.
            self._acc(all_gather_bytes=2 * 4 * self.sidx.n_model *
                      hashes.shape[0] * capacity)
        else:
            out = seeds.expand_sort_hits(hashes, clean, self.so_dev,
                                         self.roa_dev, **kw)
        small = self._down(torch.stack([out["total"],
                                        out["overflow"].to(torch.int32),
                                        out["allwrapped"].to(torch.int32)]))
        return out, small[0].astype(np.int64), small[1] != 0, small[2] != 0

    def _fetch(self, out):
        """The hits of every row that did not overflow the tier, in row
        order: one masked_select per plane."""
        width = out["diag"].shape[1]
        take = torch.where(out["overflow"], 0, out["total"])
        mask = (torch.arange(width, device=self.device)[None, :] <
                take[:, None])
        return (self._down(torch.masked_select(out["diag"], mask)).view(
            np.uint32), self._down(torch.masked_select(out["qo"], mask)))

    def _inject_row(self, codes_row, qlen, wrapped_row, diag, qo):
        """Merge the phantom hits of a row's wrapped windows into its
        sorted (diag, qo)."""
        wl = self.word_len
        offs_w = np.flatnonzero(wrapped_row)
        c = codes_row[:qlen].astype(np.int64)
        h = np.zeros(len(offs_w), np.int64)
        for t in range(wl):
            h = (h << 2) | c[offs_w + t]
        # The two SO entries of each window, widened (the JAX seeder's
        # int64 copy of the whole table would be 8.6 GB at L15).
        so = self.iview.starting_offs
        so_offs = so[h].astype(np.int64)
        counts = so[h + 1].astype(np.int64) - so_offs
        extra_qo, extra_ro = phantom_hits(offs_w, so_offs, counts,
                                          self.iview.roa,
                                          range(len(offs_w)))
        if not extra_qo:
            return diag, qo
        qo2 = np.concatenate([qo.astype(np.int64),
                              np.asarray(extra_qo, np.int64)])
        diag2 = np.concatenate(
            [diag.astype(np.int64),
             (np.asarray(extra_ro, np.int64) -
              np.asarray(extra_qo, np.int64)) & M32])
        order = np.lexsort((qo2, diag2))
        return diag2[order].astype(np.uint32), qo2[order].astype(np.int32)

    def seed_chunk(self, pr, lo, hi, rows2=None):
        """Per-(read, strand) sorted hit rows for reads [lo, hi) of a
        ParsedReads: (diag uint32, qo int32, offs int64[2n+1], totals
        int64[2n]) for yt_batch_begin; totals[r] = -1 sends row r to the
        host scan.  rows2: the chunk's [2n, lpad] strand rows on the
        device (StagedAligner._chunk_rows), or None to build them here.
        stats["seed_device_s"] is its wall up to the hit rows' splice; the
        span seeder.seed is the whole call, seeder.splice under it."""
        with span("seeder.seed", reads=hi - lo) as sp:
            t0 = sp.start()
            return self._seed_rows(pr, lo, hi, rows2, sp, t0)

    def _seed_rows(self, pr, lo, hi, rows2, sp, t0):
        dev = self.device
        offs = np.ctypeslib.as_array(pr.seq_offs, shape=(pr.n + 1,))
        lens = np.diff(offs[lo:hi + 1])
        rows = 2 * (hi - lo)
        if rows == 0:
            return (np.zeros(0, np.uint32), np.zeros(0, np.int32),
                    np.zeros(1, np.int64), np.zeros(0, np.int64))
        if rows2 is None:
            seg0, seg1 = int(offs[lo]), int(offs[hi])
            seqs = np.ctypeslib.as_array(pr.seqs, shape=(max(seg1, 1),))
            lpad = max(64, 1 << (int(lens.max(initial=1)) - 1).bit_length())
            self._acc(seed_h2d_bytes=(seg1 - seg0) + 16 * (hi - lo))
            rows2 = gather_dp.chunk_strand_rows(
                seqs[seg0:seg1], offs[lo:hi] - seg0, lens, lpad, self.tables)
        rows2 = rows2.to(dev)
        lengths = np.repeat(lens, 2).astype(np.int32)
        hashes, clean = seeds.seed_hashes(rows2, self._up(lengths),
                                          word_len=self.word_len)
        out1, tot1, over1, allw1 = self._expand(hashes, clean,
                                                self.CAP_TIERS[0])
        take = np.where(over1, 0, tot1)
        d1, q1 = self._fetch(out1)
        offs1 = np.zeros(rows + 1, np.int64)
        np.cumsum(take, out=offs1[1:])
        totals = tot1.copy()
        # The rows whose hits are not tier 1's as fetched: row -> (diag, qo).
        own = {}
        # Rows with a wrapped window, by tier: (tier output, its rows there,
        # the same rows in the chunk).
        ph1 = np.flatnonzero(allw1 & ~over1)
        phantom = [(out1, ph1, ph1)] if len(ph1) else []
        over_rows = np.flatnonzero(over1)
        if len(over_rows):
            # Compacted retry: only the overflowed rows expand again, at the
            # big tier; the rows that overflow it take the host scan.
            self._acc(cap_retries=1)
            sel = self._up(over_rows)
            out2, tot2, over2, allw2 = self._expand(
                hashes.index_select(0, sel), clean.index_select(0, sel),
                self.CAP_TIERS[1])
            take2 = np.where(over2, 0, tot2)
            d2, q2 = self._fetch(out2)
            offs2 = np.zeros(len(over_rows) + 1, np.int64)
            np.cumsum(take2, out=offs2[1:])
            for k, r in enumerate(over_rows):
                own[r] = (d2[offs2[k]:offs2[k + 1]], q2[offs2[k]:offs2[k + 1]])
            totals[over_rows] = np.where(over2, -1, tot2)
            self._acc(fallback_rows=int(over2.sum()))
            ph2 = np.flatnonzero(allw2 & ~over2)
            if len(ph2):
                phantom.append((out2, ph2, over_rows[ph2]))
        for out, k, chunk_rows in phantom:
            # Only these rows' wrapped flags and codes leave the device.
            flags = self._down(out["wrapped"].index_select(0, self._up(k)))
            codes = self._down(rows2.index_select(0, self._up(chunk_rows)))
            self._acc(phantom_rows=len(k))
            for r, f, c in zip(chunk_rows, flags, codes):
                d, q = own[r] if r in own else (d1[offs1[r]:offs1[r + 1]],
                                                q1[offs1[r]:offs1[r + 1]])
                own[r] = self._inject_row(c, int(lengths[r]), f, d, q)
        if not own:
            self._acc(seed_device_s=sp.lap(t0))
            return d1, q1, offs1, totals
        # Splice the rows of `own` between the spans of tier-1 rows.
        row_len = take.copy()
        parts_d, parts_q = [], []
        prev = 0
        for r in sorted(own):
            d, q = own[r]
            row_len[r] = len(d)
            parts_d += [d1[offs1[prev]:offs1[r]], d]
            parts_q += [q1[offs1[prev]:offs1[r]], q]
            prev = r + 1
        parts_d.append(d1[offs1[prev]:])
        parts_q.append(q1[offs1[prev]:])
        offs = np.zeros(rows + 1, np.int64)
        np.cumsum(row_len, out=offs[1:])
        self._acc(seed_device_s=sp.lap(t0))
        with span("seeder.splice") as sq:
            d, q = np.concatenate(parts_d), np.concatenate(parts_q)
            sq.add(bytes=d.nbytes + q.nbytes)
        return d, q, offs, totals
