"""Local scale-out: a (data x model) grid of devices over one process.

Counterpart of yaha_tpu/parallel/mesh.py.  The reference runs one
controller over a local mesh of devices:

  * `model` shards the k-mer index by hash range: shard m of M holds the
    SO rows of hashes [m per, (m + 1) per), rebased to offsets into its own
    slice of the ROA, so an index too large for one device's memory (a
    human-genome L15 index is 4.3 GB of SO and about 12 GB of ROA) spreads
    over M of them;
  * `data` splits a batch's strand rows for the seed lookup.

Its one device program is the shard_map body of sharded_expand_sort: each
device expands the hits of the windows whose hash lies in its shard's
range, the shards' buffers are all_gathered over `model` and sorted, and
total, overflow and wrapped are summed.  Everything after the seed rows
runs once, on the controller's device.

Here the grid is a [data, model] table of torch.devices and the program a
loop over it: for every entry, ops/seeds.expand_sort_hits on that device
with the shard's range (csrc/seed_kernels.cu expand_sort_kernel, range
masked), then, on each data group's first device, ops/seeds.
merge_sorted_runs (merge_pass_kernel) in place of the all_gather and the
sort; a device-to-device copy is what the collective among one process's
own devices comes to, and none is made where the devices are the same.
Entries may repeat a device, as the reference's tests run their meshes on
virtual devices: one card, or the CPU, then holds every shard.  The
launches on every device are issued before any is waited for.

What has no counterpart: the pow2 batch padding and its rounding to a
multiple of `data` (shard_map's even split; here the rows split into
contiguous groups of any size), and the shards' padding to one ROA length
(each shard's ROA is uploaded at its own length).  The local ROA is
indexed with 64-bit offsets by the kernel and the plain version alike, so
rebase_so has no limit of 2^31 entries a shard.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import seeds

M32 = 0xFFFFFFFF
# SO entries rebased at a time (bounds rebase_so's int64 temporaries).
REBASE_CHUNK = 1 << 24


class Mesh:
    """A [data, model] grid of torch.devices; `shape` is {"data": D,
    "model": M}.  Entries may repeat a device."""

    def __init__(self, grid):
        self.grid = [[torch.device(d) for d in row] for row in grid]
        if not self.grid or not self.grid[0] or any(
                len(row) != len(self.grid[0]) for row in self.grid):
            raise ValueError("Mesh: the grid must be a non-empty "
                             "rectangle, got %r" % (grid,))
        self.shape = {"data": len(self.grid), "model": len(self.grid[0])}


def make_mesh(devices, model_parallel: int = 1) -> Mesh:
    """A (data x model) grid over `devices` (torch.devices or names).  n
    devices at least model_parallel take data = n // model_parallel rows,
    row-major (n must be a multiple); fewer make one row whose shard m
    lives on devices[m % n], so that shards share a device."""
    devices = [torch.device(d) for d in devices]
    n, m = len(devices), int(model_parallel)
    if n < 1 or m < 1:
        raise ValueError("make_mesh: %d devices, model_parallel %d"
                         % (n, m))
    if n < m:
        return Mesh([[devices[k % n] for k in range(m)]])
    if n % m:
        raise ValueError("make_mesh: model_parallel %d does not divide the "
                         "%d devices" % (m, n))
    return Mesh([devices[r * m:(r + 1) * m] for r in range(n // m)])


def rebase_so(so, n_model: int):
    """Hash-range rebasing of the global SO array into n_model shards.

    Shard m owns hashes [m per, (m + 1) per); its rows are rebased to
    offsets into its own ROA slice: so_local[m, i] = so[m per + i] -
    so[m per], the uint32 difference (done in int64 and masked to 32
    bits; exact, since SO does not decrease).  Returns (so_local [M, per
    + 1] uint32, bases int64 [M], lens int64 [M]); so_local[m, per] =
    lens[m].  A slice may hold 2^31 entries or more: the port indexes the
    local ROA with 64-bit offsets (the reference asserts lens < 2^31 for
    its int32 gathers).  Raises ValueError unless n_model >= 1 divides the
    hash table's len(so) - 1 rows."""
    so = np.asarray(so, np.uint32)
    ht = len(so) - 1
    if n_model < 1 or ht % n_model:
        raise ValueError("rebase_so: %d shards do not divide the %d hashes"
                         % (n_model, ht))
    per = ht // n_model
    bounds = so[::per].astype(np.int64)        # [M + 1] global shard bases
    bases = bounds[:-1]
    lens = bounds[1:] - bases
    so_local = np.empty((n_model, per + 1), np.uint32)
    for m in range(n_model):
        for lo in range(0, per + 1, REBASE_CHUNK):
            hi = min(lo + REBASE_CHUNK, per + 1)
            so_local[m, lo:hi] = (so[m * per + lo:m * per + hi].astype(
                np.int64) - bases[m]) & M32
    return so_local, bases, lens


def _on(dev):
    """The device's context for a launch (the CUDA runtime's current
    device must be the stream's)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class ShardedIndex:
    """The SO and ROA split by hash range over `model` (the reference's
    ShardedIndex): shard m holds its SO rows rebased to local offsets and
    exactly the ROA slice they address.  `index` has starting_offs, roa,
    word_len and max_hits (models/seeder._IndexView, or the JAX package's
    Index in the tests); the ROA is read one slice a shard, so an mmap
    stays unmaterialised.

    so_local [M, per + 1] uint32 and roa_parts[m] (the shard's ROA, at
    least one entry) are the host copies until place(); hash_lo[m] = m
    per; so_nbytes / roa_nbytes are the bytes of one copy of every
    shard."""

    def __init__(self, index, n_model: int):
        so = np.asarray(index.starting_offs, np.uint32)
        roa = index.roa
        so_local, bases, lens = rebase_so(so, n_model)
        self.n_model = n_model
        self.per = so_local.shape[1] - 1
        self.word_len = index.word_len
        self.max_hits = index.max_hits
        self.so_local = so_local
        self.roa_parts = [
            np.asarray(roa[int(b):int(b + n)], np.uint32) if n
            else np.zeros(1, np.uint32) for b, n in zip(bases, lens)]
        self.roa_lens = lens
        self.so_nbytes = int(so_local.nbytes)
        self.roa_nbytes = sum(int(p.nbytes) for p in self.roa_parts)
        self.hash_lo = np.arange(n_model, dtype=np.int32) * np.int32(
            self.per)
        self.tables = {}

    def shard_nbytes(self, m):
        """(SO bytes, ROA bytes) of shard m."""
        return 4 * (self.per + 1), 4 * max(int(self.roa_lens[m]), 1)

    def place(self, mesh: Mesh):
        """Upload shard m to every device of grid column m, one copy per
        distinct (device, shard): self.tables[(device, m)] = (SO, ROA)
        int32 tensors of their uint32 bits.  The host copies go afterwards
        (at L15 the SO alone is 4.3 GB)."""
        for row in mesh.grid:
            for m, dev in enumerate(row):
                if (dev, m) not in self.tables:
                    self.tables[(dev, m)] = tuple(
                        torch.from_numpy(a.view(np.int32)).to(dev)
                        for a in (self.so_local[m], self.roa_parts[m]))
        self.so_local = None
        self.roa_parts = None
        return self

    def placed_nbytes(self):
        """Bytes of every placed copy."""
        return sum(s.numel() * 4 + r.numel() * 4
                   for s, r in self.tables.values())


def sharded_expand_sort(mesh: Mesh, hashes, clean, sidx: ShardedIndex, *,
                        max_hits: int, capacity: int):
    """The seed lookup over the sharded index (the reference's
    sharded_expand_sort): hashes/clean [B, N] (from seeds.seed_hashes) are
    split over `data` in contiguous row groups; on grid entry (d, m) group
    d's rows expand against shard m; each group's M [b, C] buffers go to
    the group's first device (the shards on it expand straight into the
    merge's [M, b, C] input) and merge; the groups' rows are concatenated
    on grid entry (0, 0)'s device.  Returns the dict of
    seeds.expand_sort_hits with diag/qo [B, M C] sorted by (diag uint32,
    qo), total summed over shards (int32), overflow = some shard passed C,
    wrapped or-ed over shards (a window is in one shard) and allwrapped."""
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    kw = dict(max_hits=max_hits, capacity=capacity, per=sidx.per)
    groups = list(zip(torch.tensor_split(hashes, n_data),
                      torch.tensor_split(clean, n_data)))
    shard_outs = []
    for d, (h, c) in enumerate(groups):
        # The merge's input [M, b, C] on the group's first device: a shard
        # on that device expands into its slot, any other is copied there.
        with _on(mesh.grid[d][0]):
            runs = torch.empty((2, n_model, h.shape[0], capacity),
                               dtype=torch.int32, device=mesh.grid[d][0])
        outs = []
        for m, dev in enumerate(mesh.grid[d]):
            so_t, roa_t = sidx.tables[(dev, m)]
            with _on(dev):
                outs.append(seeds.expand_sort_hits(
                    h.to(dev, non_blocking=True),
                    c.to(dev, non_blocking=True), so_t, roa_t,
                    hash_lo=int(sidx.hash_lo[m]),
                    out=(runs[0, m], runs[1, m])
                    if dev == mesh.grid[d][0] else None, **kw))
        shard_outs.append((runs, outs))
    merged = []
    for d, (runs, outs) in enumerate(shard_outs):
        dev = mesh.grid[d][0]
        with _on(dev):
            got = [{k: v.to(dev, non_blocking=True) for k, v in o.items()
                    if k not in ("diag", "qo")} for o in outs]
            for m, o in enumerate(outs):
                if o["diag"].device != dev:
                    runs[0, m].copy_(o["diag"], non_blocking=True)
                    runs[1, m].copy_(o["qo"], non_blocking=True)
            if n_model == 1:
                diag, qo = runs[0, 0], runs[1, 0]
            else:
                diag, qo = seeds.merge_sorted_runs(runs[0], runs[1])
            total = got[0]["total"]
            overflow = got[0]["overflow"]
            wrapped = got[0]["wrapped"]
            for g in got[1:]:
                total = total + g["total"]
                overflow = overflow | g["overflow"]
                wrapped = wrapped | g["wrapped"]
        merged.append({"diag": diag, "qo": qo, "total": total,
                       "overflow": overflow, "wrapped": wrapped})
    if n_data == 1:
        out = merged[0]
    else:
        dev = mesh.grid[0][0]
        out = {k: torch.cat([g[k].to(dev, non_blocking=True)
                             for g in merged]) for k in merged[0]}
    out["allwrapped"] = out["wrapped"].any(1)
    return out
