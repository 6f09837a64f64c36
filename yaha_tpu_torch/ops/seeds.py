"""Device seed phase: per-window k-mer hashes, SO/ROA hit expansion and the
(diag, qo) sort of every strand row.

Counterpart of yaha_tpu/ops/seeds_jax.py:

  seed_hashes        batched_seed_hashes       csrc/seed_kernels.cu
                                               seed_hash_kernel
  expand_sort_hits   expand_sort_hits_device   csrc/seed_kernels.cu
                                               expand_sort_kernel
  merge_sorted_runs  the all_gather over `model` csrc/seed_kernels.cu
                     and sort of                merge_pass_kernel
                     parallel/mesh.py:204-213
  seed_counts, strand_hit_totals, fragment_boundaries
                     the functions of the same name: plain PyTorch ops, no
                     kernel (no engine path calls them)

The kernel entries launch their CUDA kernel on a CUDA tensor and run
their plain version (``*_reference``) on a CPU tensor; there is no other
route.  Each returns what its JAX function returns, bit for bit, under the
same dict keys.  uint32 arrays (the SO and ROA tables, ``diag``) are held
in int32 tensors as their bit patterns, since PyTorch has little uint32
support: a caller reads them back with ``.numpy().view(np.uint32)``.  The
plain versions widen them to int64 in [0, 2^32) and sort on one int64 key,
diag << 31 | qo (qo < 2^31), which keeps diag's unsigned order.  The ROA
is gathered with int64 indices, so the JAX package's ROA < 2^31 limit has
no counterpart.
"""
from __future__ import annotations

import torch

from . import sw_cuda

I32 = torch.int32
I64 = torch.int64
M32 = 0xFFFFFFFF
# The (diag, qo) of a slot past a row's total.
DIAG_SENTINEL = M32
QO_SENTINEL = 0x7FFFFFFF
# Largest capacity the kernel takes: C 8-byte keys in one block's shared
# memory.
MAX_CAPACITY = 16384


def _u32(t):
    """int32 bit patterns (or any integers) -> int64 values in [0, 2^32)."""
    return t.to(I64) & M32


def _as_i32(t):
    """int64 values in [0, 2^32) -> int32 tensor of the same bits."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(I32)


# ---- plain versions ----

def seed_hashes_reference(codes, lengths, *, word_len):
    """Plain version of seed_hashes (seeds_jax.batched_seed_hashes)."""
    b, l = codes.shape
    n = l - word_len + 1
    c = codes.to(I32)
    bad = torch.cat([torch.zeros((b, 1), dtype=I32, device=codes.device),
                     torch.cumsum((c > 3).to(I32), 1, dtype=I32)], 1)
    clean = (bad[:, word_len:] - bad[:, :-word_len]) == 0
    h = torch.zeros((b, n), dtype=I32, device=codes.device)
    for i in range(word_len):
        h = (h << 2) | c[:, i:i + n]
    pos = torch.arange(n, device=codes.device)[None, :]
    clean = clean & (pos <= lengths.to(I64)[:, None] - word_len)
    return torch.where(clean, h, 0), clean


def _expand_reference(hashes, clean, so, roa, *, max_hits, capacity,
                      hash_lo=0, per=None):
    """The expansion of expand_sort_hits_reference before its sort: diag
    and qo (int64, the sentinel in invalid slots) in slot order, and the
    per-row and per-window outputs."""
    b, n = hashes.shape
    dev = hashes.device
    per = so.shape[0] - 1 if per is None else per
    h = hashes.to(I64) - hash_lo
    in_rng = clean & (h >= 0) & (h < per)
    h = torch.where(in_rng, h, 0)
    so_lo = _u32(so[h])
    cnt = (_u32(so[h + 1]) - so_lo) & M32
    counts = _as_i32(cnt)
    kept_mask = in_rng & (counts > 0) & (counts <= max_hits)
    kept = torch.where(kept_mask, counts, 0)
    cum = torch.cumsum(kept, 1, dtype=I32).to(I64)
    total = cum[:, -1]
    t = torch.arange(capacity, dtype=I64, device=dev)
    win = torch.searchsorted(cum, t.expand(b, capacity).contiguous(),
                             right=True)
    win = win.clamp(max=n - 1)
    base = torch.where(win > 0, cum.gather(1, (win - 1).clamp(min=0)), 0)
    off = torch.where(kept_mask, so_lo, 0).gather(1, win)
    valid = t[None, :] < total[:, None]
    ro = _u32(roa[torch.where(valid, off + t[None, :] - base, 0)])
    ok = (valid & (ro >= win)).to(I64)
    okc = torch.cat([torch.zeros((b, 1), dtype=I64, device=dev),
                     torch.cumsum(ok, 1)], 1)
    any_ok = (okc.gather(1, cum.clamp(max=capacity)) -
              okc.gather(1, (cum - kept).clamp(max=capacity)))
    wrapped = kept_mask & (any_ok == 0)
    return {"diag": torch.where(valid, (ro - win) & M32, DIAG_SENTINEL),
            "qo": torch.where(valid, win, QO_SENTINEL),
            "total": total.to(I32), "overflow": total > capacity,
            "wrapped": wrapped, "allwrapped": wrapped.any(1)}


def expand_sort_hits_reference(hashes, clean, so, roa, *, max_hits,
                               capacity, hash_lo=0, per=None):
    """Plain version of expand_sort_hits
    (seeds_jax.expand_sort_hits_device; with hash_lo and per, one model
    shard of the shard_map body, parallel/mesh.py:157-202)."""
    out = _expand_reference(hashes, clean, so, roa, max_hits=max_hits,
                            capacity=capacity, hash_lo=hash_lo, per=per)
    key, _ = torch.sort((out.pop("diag") << 31) | out.pop("qo"), dim=1)
    out["diag"] = _as_i32(key >> 31)
    out["qo"] = (key & QO_SENTINEL).to(I32)
    return out


def merge_sorted_runs_reference(diag, qo):
    """Plain version of merge_sorted_runs: torch.sort of the gathered rows'
    keys, diag << 31 | qo as in expand_sort_hits_reference (equal keys are
    equal hits, so the order among them does not show)."""
    m, b, c = diag.shape
    key = ((_u32(diag) << 31) | qo.to(I64)).permute(1, 0, 2).reshape(
        b, m * c)
    key, _ = torch.sort(key, dim=1)
    return _as_i32(key >> 31), (key & QO_SENTINEL).to(I32)


# ---- entries: CUDA kernel on a CUDA tensor, plain version on the CPU ----

def _check(name, dev, arrays):
    """Raise unless every (label, tensor, dtype, dims) is a contiguous
    tensor of that dtype and rank on `dev`."""
    if dev.type != "cuda":
        raise ValueError("%s: tensors on %s are not supported (cpu or "
                         "cuda)" % (name, dev))
    for label, t, dt, dim in arrays:
        if (t.dtype != dt or t.dim() != dim or not t.is_contiguous()
                or t.device != dev):
            raise ValueError("%s: %s must be a contiguous %d-D %s tensor on "
                             "%s" % (name, label, dim, dt, dev))


def seed_hashes(codes, lengths, *, word_len):
    """[B, L] u8 strand rows + [B] lengths -> (hashes [B, N] int32, clean
    [B, N] bool), N = L - word_len + 1: the 2-bit hash of every window, 0
    where the window is not clean (past len - word_len, or holding a code
    above 3)."""
    if codes.device.type == "cpu":
        return seed_hashes_reference(codes, lengths, word_len=word_len)
    name = "seed_hashes"
    lengths = lengths.to(device=codes.device, dtype=I32).contiguous()
    _check(name, codes.device, (("codes", codes, torch.uint8, 2),
                                ("lengths", lengths, I32, 1)))
    b, l = codes.shape
    if not 1 <= word_len <= min(15, l) or lengths.shape[0] != b:
        raise ValueError("%s: word_len %d, codes %s, lengths %s" % (
            name, word_len, tuple(codes.shape), tuple(lengths.shape)))
    n = l - word_len + 1
    hashes = torch.empty((b, n), dtype=I32, device=codes.device)
    clean = torch.empty((b, n), dtype=torch.bool, device=codes.device)
    if b:
        from . import _build
        sw_cuda._launched(name, _build.load().yt_seed_hashes(
            codes.data_ptr(), b, l, lengths.data_ptr(), word_len,
            hashes.data_ptr(), clean.data_ptr(),
            sw_cuda._stream(codes.device)))
    return hashes, clean


def expand_sort_hits(hashes, clean, so, roa, *, max_hits, capacity,
                     hash_lo=0, per=None, out=None):
    """Every strand row's hits in a [B, capacity] buffer, sorted by (diag
    uint32, qo).

    hashes/clean: [B, N] from seed_hashes; so/roa: the index's SO and ROA
    tables (int32 tensors of their uint32 bits), or one model shard's
    (parallel/mesh.ShardedIndex): the shard of hashes [hash_lo, hash_lo +
    per), its SO of per + 1 offsets into its own ROA, keeps only the
    windows in its range.  per defaults to len(so) - 1, with hash_lo 0 the
    whole index.  Returns diag [B, C]
    (int32 tensor of uint32 bits) and qo [B, C] int32, the sentinel
    (0xFFFFFFFF, 0x7FFFFFFF) past each row's total; total [B] int32,
    overflow [B] (total > capacity: the caller retries a larger tier or
    takes the host scan), wrapped [B, N] (a kept window none of whose slots
    below capacity has ro >= qo: the phantom-hit quirk, QueryMatch.c:57-69)
    and allwrapped [B] = any(wrapped).  capacity is a power of two up to
    MAX_CAPACITY.  out: a (diag, qo) pair of [B, C] int32 tensors to write
    the hits into (a shard's slot of the merge's [M, B, C] input), in place
    of new ones."""
    per = so.shape[0] - 1 if per is None else per
    if hashes.device.type == "cpu":
        res = expand_sort_hits_reference(hashes, clean, so, roa,
                                         max_hits=max_hits,
                                         capacity=capacity,
                                         hash_lo=hash_lo, per=per)
        if out is not None:
            for t, k in zip(out, ("diag", "qo")):
                res[k] = t.copy_(res[k])
        return res
    name = "expand_sort_hits"
    dev = hashes.device
    _check(name, dev, (("hashes", hashes, I32, 2),
                       ("clean", clean, torch.bool, 2),
                       ("so", so, I32, 1), ("roa", roa, I32, 1)))
    b, n = hashes.shape
    if (clean.shape != hashes.shape or n < 1 or capacity < 1 or
            capacity > MAX_CAPACITY or capacity & (capacity - 1) or
            not 1 <= per < so.shape[0] or hash_lo < 0):
        raise ValueError("%s: hashes %s, clean %s, capacity %d, SO %d, "
                         "shard [%d, +%d)" % (
                             name, tuple(hashes.shape), tuple(clean.shape),
                             capacity, so.shape[0], hash_lo, per))
    if out is None:
        diag, qo = torch.empty((2, b, capacity), dtype=I32, device=dev)
    else:
        diag, qo = out
        _check(name, dev, (("out diag", diag, I32, 2),
                           ("out qo", qo, I32, 2)))
        if diag.shape != (b, capacity) or qo.shape != (b, capacity):
            raise ValueError("%s: out %s and %s, want [%d, %d]" % (
                name, tuple(diag.shape), tuple(qo.shape), b, capacity))
    total = torch.empty(b, dtype=I32, device=dev)
    overflow, allwrapped = torch.empty((2, b), dtype=torch.bool, device=dev)
    wrapped = torch.empty((b, n), dtype=torch.bool, device=dev)
    if b:
        from . import _build
        sw_cuda._launched(name, _build.load().yt_expand_sort(
            hashes.data_ptr(), clean.data_ptr(), b, n, so.data_ptr(),
            roa.data_ptr(), max_hits, hash_lo, per, capacity, diag.data_ptr(),
            qo.data_ptr(), total.data_ptr(), overflow.data_ptr(),
            wrapped.data_ptr(), allwrapped.data_ptr(),
            sw_cuda._stream(dev)))
    return {"diag": diag, "qo": qo, "total": total, "overflow": overflow,
            "wrapped": wrapped, "allwrapped": allwrapped}


def merge_sorted_runs(diag, qo):
    """The M model shards' hit rows merged: diag/qo [M, B, C] (int32
    tensors; diag of uint32 bits), each [m, row] sorted by (diag uint32,
    qo) as expand_sort_hits leaves it, -> (diag, qo) [B, M C] sorted the
    same way, the sentinels last.  C is a power of two."""
    if diag.device.type == "cpu":
        return merge_sorted_runs_reference(diag, qo)
    name = "merge_sorted_runs"
    dev = diag.device
    _check(name, dev, (("diag", diag, I32, 3), ("qo", qo, I32, 3)))
    m, b, c = diag.shape
    if qo.shape != diag.shape or c < 1 or c & (c - 1):
        raise ValueError("%s: diag %s, qo %s" % (
            name, tuple(diag.shape), tuple(qo.shape)))
    out_d, out_q = torch.empty((2, b, m * c), dtype=I32, device=dev)
    # Past two shards the passes between the first and the last go
    # through a second [B, M C] pair of streams.
    tmp = torch.empty((2, b, m * c), dtype=I32, device=dev) if m > 2 else None
    if b:
        from . import _build
        sw_cuda._launched(name, _build.load().yt_merge_runs(
            diag.data_ptr(), qo.data_ptr(), m, b, c,
            *((None, None) if tmp is None else (tmp[0].data_ptr(),
                                                tmp[1].data_ptr())),
            out_d.data_ptr(), out_q.data_ptr(), sw_cuda._stream(dev)))
    return out_d, out_q


# ---- plain ops with no kernel ----

def seed_counts(hashes, clean, so):
    """(SO count, SO start) of every window, 0 where not clean
    (seeds_jax.seed_counts; Query.c:391-405), as int64."""
    h = hashes.to(I64)
    lo = _u32(so[h])
    counts = _u32(so[h + 1]) - lo
    return torch.where(clean, counts, 0), torch.where(clean, lo, 0)


def strand_hit_totals(hashes, clean, so, max_hits):
    """Per-row kept-hit totals and seed-match totals, int32
    (seeds_jax.strand_hit_totals)."""
    h = hashes.to(I64)
    counts = _as_i32((_u32(so[h + 1]) - _u32(so[h])) & M32)
    kept = torch.where(clean & (counts > 0) & (counts <= max_hits), counts,
                       0)
    return kept.sum(1, dtype=I32), kept.sum(1, dtype=I32)


def fragment_boundaries(diag, qo, valid, *, word_len):
    """New-fragment flags of sorted hit rows: where the diagonal changes or
    the query-offset step exceeds word_len (seeds_jax.fragment_boundaries;
    QueryMatch.c:99-115).  diag is compared as stored (its bits)."""
    change = (diag[:, 1:] != diag[:, :-1]) | (qo[:, 1:] - qo[:, :-1] >
                                              word_len)
    first = torch.ones_like(diag[:, :1], dtype=torch.bool)
    return torch.cat([first, change], 1) & valid
