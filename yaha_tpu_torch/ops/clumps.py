"""The device seeder's fragments-to-clumps stage: a CUDA kernel + its plain
version.

No counterpart in the JAX package, which turns the seeder's hit rows into
clumps on the host (yt_hits_to_clumps inside phase 1).  hits_clumps takes a
tier's sorted hit rows as ops/seeds.expand_sort_hits (or the mesh merge)
leaves them and returns every served row's clumps as a record in its slot
of a [B, W] int32 plane:

  rec[row, 0:3]   clumps, fragments, regions skipped by --max-region-frags
  then per clump  its fragment count, its matched bases, and (sqo, eqo,
                  sro) a fragment, sro the uint32 bits

and meta[row], the record's length: 0 for a row not served (n_hits -1),
-1 for a row past the kernel's capacities (a multi-fragment region of more
than REGION fragments, more than COVER clumps from one region, or a record
longer than W), which the caller sends to the host path.  A record's
clumps are yt_hits_to_clumps' on the row's first n_hits hits, in its
order, byte for byte.

On a CUDA tensor hits_clumps launches hits_clump_kernel
(csrc/clump_kernels.cu, a warp a row); on a CPU tensor it runs
hits_clumps_reference, which calls the native yt_hits_to_clumps on each
row and applies the kernel's capacities to its output.
"""
from __future__ import annotations

import numpy as np
import torch

from ..native import host
from . import sw_cuda

I32 = torch.int32
M32 = 0xFFFFFFFF
# Copies of kClumpRegion, kClumpCover and kClumpHead
# (csrc/clump_kernels.cu), which tests/test_torch_clumps.py holds equal.
REGION = 256
COVER = 64
HEAD = 3


def clump_params(aa):
    """The fragment stage's parameters of an AlignmentArgs, in the kernel's
    argument order, then the score mode."""
    return ([int(aa.word_len), int(aa.max_gap), int(aa.max_desert),
             int(aa.min_match), int(aa.min_non_overlap), int(aa.m_score),
             int(aa.go_cost), int(aa.ge_cost), int(aa.band_width),
             int(getattr(aa, "max_region_frags", 0))],
            1 if aa.max_query_length > 32000 else 0)


def regions(diag, qo, word_len, max_gap):
    """(region start diags, fragments a region) of a sorted hit row."""
    if len(qo) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    d = diag.astype(np.int64)
    q = qo.astype(np.int64)
    fs = np.ones(len(q), bool)
    fs[1:] = (d[1:] != d[:-1]) | (q[1:] - q[:-1] > word_len)
    fd = d[fs]
    rs = np.ones(len(fd), bool)
    rs[1:] = np.abs(fd[1:] - fd[:-1]) > max_gap
    starts = np.flatnonzero(rs)
    return fd[starts], np.diff(np.append(starts, len(fd)))


def _row_record(diag, qo, q_len, aa, width):
    """One row's record (int32 array) as the kernel writes it, or None past
    a capacity: yt_hits_to_clumps' clumps, checked against REGION, COVER
    and `width`."""
    offs, sqo, eqo, sro, matched, skipped = host.hits_to_clumps(
        diag, qo, q_len, aa)
    nc = len(matched)
    mrf = int(getattr(aa, "max_region_frags", 0))
    r_diag, r_num = regions(diag, qo, aa.word_len, aa.max_gap)
    kept = r_num[~((mrf > 0) & (r_num > mrf))]
    if (kept > REGION).any() or HEAD + 2 * nc + 3 * len(sqo) > width:
        return None
    if nc:
        # Coverage spans a region: each clump of a multi-fragment region
        # whose span [sqo, eqo] starts inside the query.
        first, last = offs[:-1], offs[1:] - 1
        c_sqo = sqo[first]
        spans = np.minimum(eqo[last] + 1, q_len) > c_sqo
        reg = np.searchsorted(r_diag, (sro[first] - c_sqo) & M32,
                              side="right") - 1
        multi = r_num[reg] > 1
        if (np.bincount(reg[spans & multi], minlength=len(r_num)) >
                COVER).any():
            return None
    rec = [nc, len(sqo), skipped]
    for k in range(nc):
        a, b = offs[k], offs[k + 1]
        rec += [b - a, matched[k]]
        rec += np.stack([sqo[a:b], eqo[a:b], sro[a:b]], 1).ravel().tolist()
    return np.asarray(rec, np.int64).astype(np.uint32).view(np.int32)


def hits_clumps_reference(diag, qo, n_hits, q_len, aa, width):
    """Plain version of hits_clumps: each served row through the native
    yt_hits_to_clumps."""
    b = diag.shape[0]
    rec = torch.zeros((b, width), dtype=I32)
    meta = torch.zeros(b, dtype=I32)
    d_np = diag.numpy().view(np.uint32)
    q_np = qo.numpy()
    n_np, l_np = n_hits.numpy(), q_len.numpy()
    for row in range(b):
        n = int(n_np[row])
        if n < 0:
            continue
        r = _row_record(d_np[row, :n], q_np[row, :n], int(l_np[row]), aa,
                       width)
        if r is None:
            meta[row] = -1
            continue
        rec[row, :len(r)] = torch.from_numpy(r)
        meta[row] = len(r)
    return rec, meta


def hits_clumps(diag, qo, n_hits, q_len, aa, width):
    """Clumps of the first n_hits[row] hits of every row of a tier's sorted
    hit rows (the module docstring has the record).  diag/qo: [B, C] int32
    (diag of uint32 bits), any C; n_hits, q_len: [B] int32, n_hits -1 for
    a row not served.  Returns (rec [B, width] int32, meta [B] int32); on
    the card a record's slots past its length are not written."""
    n_hits = n_hits.to(device=diag.device, dtype=I32).contiguous()
    q_len = q_len.to(device=diag.device, dtype=I32).contiguous()
    if diag.device.type == "cpu":
        return hits_clumps_reference(diag, qo, n_hits, q_len, aa, width)
    name = "hits_clump"
    dev = diag.device
    if dev.type != "cuda":
        raise ValueError("%s: tensors on %s are not supported (cpu or cuda)"
                         % (name, dev))
    b, c = diag.shape
    for label, t, dim in (("diag", diag, 2), ("qo", qo, 2),
                          ("n_hits", n_hits, 1), ("q_len", q_len, 1)):
        if (t.dtype != I32 or t.dim() != dim or not t.is_contiguous() or
                t.device != dev or t.shape[0] != b):
            raise ValueError("%s: %s must be a contiguous %d-D int32 tensor "
                             "of %d rows on %s" % (name, label, dim, b, dev))
    if qo.shape != diag.shape or width < HEAD:
        raise ValueError("%s: diag %s, qo %s, width %d" % (
            name, tuple(diag.shape), tuple(qo.shape), width))
    rec = torch.empty((b, width), dtype=I32, device=dev)
    meta = torch.empty(b, dtype=I32, device=dev)
    if b:
        from . import _build
        ints, wide = clump_params(aa)
        sw_cuda._launched(name, _build.load().yt_hits_clump(
            diag.data_ptr(), qo.data_ptr(), b, c, n_hits.data_ptr(),
            q_len.data_ptr(), *ints, wide, rec.data_ptr(), width,
            meta.data_ptr(), sw_cuda._stream(dev)))
    return rec, meta

