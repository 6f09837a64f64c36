"""Batched DP kernels of the staged aligner: CUDA kernels + plain versions.

Counterpart of yaha_tpu/ops/sw_pallas.py.  Three public functions keep
the contracts of the Pallas entries and return the same arrays:

  extension_forward        extension_forward_pallas (phase B)
  anchored_forward_banded  anchored_forward_pallas_banded (phase A)
  anchored_forward         anchored_forward_pallas (phase A, wide bands)

and the ``*_p4`` entries take 4-bit packed q/r ([N, G/2] uint8, two codes
per byte, low nibble first: pack4_host), unpack them on their device with
PyTorch ops as sw_pallas._unpack4 does, and call the entries above.  The
staged engine does not feed them: it assembles u8 planes on the device,
and for host-fetched planes the host pack costs more on an H100 than the
halved upload saves, so those upload unpacked.

Each takes its device from the input tensors.  On a CUDA tensor it checks
dtype, shape and contiguity, allocates the outputs, and launches its
hand-written kernel on the current stream, raising if the launch fails:
csrc/ext_kernels.cu (band state in registers, a thread a problem) for
extensions at -BW 1 to 8, csrc/ext_wide_kernels.cu (a warp a problem on a
row wavefront) for the other band widths up to -BW 707 and a block of
warps a problem, a strip a warp, past it, csrc/anch_kernels.cu for both
anchored entries (band state in registers, a width class per warp of 32
problems; a warp a problem on a row wavefront for the warps with a lane
wider than 32 columns).

On a CPU tensor it runs its plain PyTorch version (``*_reference``),
which loops over rows and band columns, vectorised over problems, with
the same tie rules and int32 wrap-around as the kernel.  Unlike the
Pallas entries, N may be any size.

The two wavefront routes (the wide extension, the anchored wide warps)
replace first versions that gave each problem a thread and kept its band
state in global scratch, a load/store round trip a cell on the dependent
chain, with plane bytes stored one at a time a plane apart between the
lanes of a warp; a thread's band state cannot grow past 32 columns in
registers.  What bounds them is each row's dependent chain of cells and
the lanes a strip leaves idle (for widths under 64, width/64 of the steps
busy).  Their rows are spread over a warp's lanes, the row above handed
down by a shuffle, so a lane's state does not grow with the width; the
plane is staged 32 rows at a time and written with 16-byte stores, every
byte of it, into an uninitialised buffer.

Packed backtrack byte: bits 0-2 the op code, bit 3 (BT_CD) "delete run
continues one cell left", bit 4 (BT_CF) "insert run continues up the
chain" (diagonally in the band-relative layouts, straight up in the
full-width anchored layout).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .dp_common import (BT_CD, BT_CF, DP_WORST, OP_DELETE, OP_INSERT,
                        OP_MATCH, OP_REPLACE)

I32 = torch.int32

# Kernel launches per wrapper since the last reset_launches(), for the
# kernels of this module and of gather_dp, decode, seeds, chain and
# clumps: a run can show which kernels its main path went through.  The extension has
# three kernels, counted apart: "extension_forward" (band state in
# registers, csrc/ext_kernels.cu), "extension_forward_wide" (a warp a
# problem, csrc/ext_wide_kernels.cu ext_wide_kernel) and
# "extension_forward_block" (a block of warps a problem, ext_block_kernel).
_launches = {"extension_forward": 0, "extension_forward_wide": 0,
             "extension_forward_block": 0,
             "anchored_forward_banded": 0, "anchored_forward": 0,
             "gather_problems": 0, "rle_walk": 0, "seed_hashes": 0,
             "expand_sort_hits": 0, "merge_sorted_runs": 0, "chain_dp": 0,
             "hits_clump": 0}

# Band widths W = 4*band_width + 1 the register kernel is instantiated for
# (-BW 1 to 8), and the block sizes it takes.
REG_WIDTHS = (5, 9, 13, 17, 21, 25, 29, 33)
REG_BLOCKS = (32, 64, 128)
EXT_BLOCK = 64
# Columns of band state the anchored kernels keep in registers, at most
# (width classes 8, 16 and 32); the problems of a warp with a wider lane
# go to the wide route, a warp a problem.
ANCH_REG_COLS = 32
# Shared memory a block can have, and a wavefront warp's share of it for
# plane rows of w bytes: copies of kWideSmemMax and wide_warp_bytes
# (csrc/wavefront.cuh), which tests/test_torch_csrc.py holds equal.  The
# wide routes refuse a plane whose warp does not fit.
WIDE_SMEM_MAX = 232448
WIDE_LANES = 32
# The block extension's warps a block, and its shared memory besides the
# row: copies of kBlockWarps and ext_block_bytes (csrc/ext_wide_kernels.cu),
# held equal by tests/test_torch_csrc.py.
EXT_BLOCK_WARPS = 8
_launch_lock = threading.Lock()


def wide_warp_bytes(w):
    """Shared memory of one wavefront warp for plane rows of w bytes: the
    row of w + 1 16-byte cells, two strip stages of 32 rows, two strips'
    codes."""
    row = 16 * (w + 1)
    stage = (WIDE_LANES * w + 16 + 15) // 16 * 16
    codes = (2 * WIDE_LANES + w + 15) // 16 * 16
    return row + 2 * stage + 2 * codes


def ext_block_bytes(w):
    """Shared memory of the block extension for plane rows of w bytes
    (csrc/ext_wide_kernels.cu ext_block_bytes): 64 bytes of sync state, a
    16-byte unit a lane, the row of w + 1 16-byte cells."""
    return 64 + EXT_BLOCK_WARPS * WIDE_LANES * 16 + 16 * (w + 1)


def full_wide_fits(rl):
    """Whether anchored_forward takes full-width rows of rl + 1 columns on
    the card: up to ANCH_REG_COLS in registers, wider on the wide route,
    whose warp must fit a block's shared memory.  (A banded plane is at
    most MAX_WBAND wide, far inside the limit.)"""
    w = rl + 1
    return w <= ANCH_REG_COLS or wide_warp_bytes(w) <= WIDE_SMEM_MAX


def ext_wide_fits(band_width):
    """Whether extension_forward takes a band on the card: the register
    kernel's widths, else the wide kernel's warp (up to W 2,829) or past
    it the block kernel's row fits a block's shared memory: up to W
    14,265, -BW 3,566."""
    w = 4 * band_width + 1
    return w in REG_WIDTHS or ext_block_bytes(w) <= WIDE_SMEM_MAX


def reset_launches():
    with _launch_lock:
        for k in _launches:
            _launches[k] = 0


def launches():
    with _launch_lock:
        return dict(_launches)


# ---- plain PyTorch versions (the CPU path, and the card's cross-check) ----

def _cell(diag, qc, rch, pe, pd, pvl, pf_up, pv_up, pi_up, *, go, ge, rc,
          ms, max_gap, max_intron, gap_ties):
    """One cell of the recurrence for every problem (sw_cells.cuh)."""
    neq = (qc != rch).to(I32)
    g = diag + ms - neq * (ms + rc)
    op = OP_MATCH + neq * (OP_REPLACE - OP_MATCH)
    ce = pe - ge
    ne = pvl - (go + ge)
    cont_d = (ce >= ne) & (pd + 1 <= max_intron)
    pe_n = torch.where(cont_d, ce, ne)
    pd_n = torch.where(cont_d, pd + 1, 1)
    take_d = pe_n >= g if gap_ties else pe_n > g
    v1 = torch.where(take_d, pe_n, g)
    op = torch.where(take_d, OP_DELETE, op)
    cf = pf_up - ge
    nf = pv_up - (go + ge)
    cont_f = (cf >= nf) & (pi_up + 1 <= max_gap)
    f = torch.where(cont_f, cf, nf)
    ii = torch.where(cont_f, pi_up + 1, 1)
    take_f = f >= v1 if gap_ties else f > v1
    v = torch.where(take_f, f, v1)
    op = torch.where(take_f, OP_INSERT, op)
    packed = (op + BT_CD * (pd_n > 1).to(I32) + BT_CF * (ii > 1).to(I32))
    return v, pe_n, pd_n, f, ii, packed.to(torch.int8)


def extension_forward_reference(q, qlens, r, rlens, *, band_width, go, ge,
                                rc, ms, max_gap, max_intron, x_cutoff):
    """Plain version of extension_forward (sw_pallas._ext_body)."""
    n, ql = q.shape
    rl = r.shape[1]
    bw2 = 2 * band_width
    w = 2 * bw2 + 1
    dev = q.device
    sc = dict(go=go, ge=ge, rc=rc, ms=ms, max_gap=max_gap,
              max_intron=max_intron)
    qlens = qlens.to(device=dev, dtype=I32)
    rlens = rlens.to(device=dev, dtype=I32)
    q32 = q.to(I32)
    # Padded index s = i - 1 + j reads r[s - bw2]; 255 outside [0, RL).
    r_pad = torch.full((n, max(bw2 + rl, ql + w)), 255, dtype=I32,
                       device=dev)
    r_pad[:, bw2:bw2 + rl] = r.to(I32)

    def full(v):
        return torch.full((n,), v, dtype=I32, device=dev)

    pv = torch.full((w + 1, n), DP_WORST, dtype=I32, device=dev)
    pf = pv.clone()
    pi = torch.zeros((w + 1, n), dtype=I32, device=dev)
    bt = torch.zeros((n, ql + 1, w), dtype=torch.int8, device=dev)
    pv[bw2] = 0
    pf[bw2] = 0
    for j in range(bw2 + 1, w):
        pv[j] = -(go + (j - bw2) * ge)
        bt[:, 0, j] = OP_DELETE + (BT_CD if j - bw2 >= 2 else 0)
    for i in range(1, min(bw2, ql) + 1):
        bt[:, i, bw2 - i] = OP_INSERT + (BT_CF if i > 1 else 0)
    max_score = full(DP_WORST)
    maxi = full(0)
    maxj = full(0)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(1, ql + 1):
        row_active = ~done & (i <= qlens)
        if not bool(row_active.any()):
            break
        start_col = max(bw2 + 1 - i, 0)
        end_col = bw2 + rlens - i
        edge_val = -(go + i * ge)
        if i <= bw2:
            pv[bw2 - i] = edge_val
        qc = q32[:, i - 1]
        pe, pd = full(DP_WORST), full(0)
        pvl = full(edge_val if i <= bw2 else DP_WORST)
        row_max, best_v, best_j = full(DP_WORST), full(DP_WORST), full(0)
        for j in range(start_col, w):
            act = row_active & (j <= end_col)
            v, pe_n, pd_n, f, ii, packed = _cell(
                pv[j], qc, r_pad[:, i - 1 + j], pe, pd, pvl, pf[j + 1],
                pv[j + 1], pi[j + 1], gap_ties=True, **sc)
            pf[j] = torch.where(act, f, pf[j])
            pi[j] = torch.where(act, ii, pi[j])
            pv[j] = torch.where(act, v, pv[j])
            bt[:, i, j] = torch.where(act, packed, bt[:, i, j])
            row_max = torch.where(act, torch.maximum(row_max, v), row_max)
            upd = act & (v > best_v)
            best_v = torch.where(upd, v, best_v)
            best_j = torch.where(upd, j, best_j)
            pe = torch.where(act, pe_n, pe)
            pd = torch.where(act, pd_n, pd)
            pvl = torch.where(act, v, pvl)
        upd = row_active & (best_v > max_score)
        max_score = torch.where(upd, best_v, max_score)
        maxi = torch.where(upd, i, maxi)
        maxj = torch.where(upd, best_j, maxj)
        newly_done = row_active & (row_max < max_score - x_cutoff)
        done = done | newly_done | (i >= qlens)
    return {"score": max_score, "maxi": maxi, "maxj": maxj, "bt": bt}


def anchored_forward_reference(q, qlens, r, rlens, left_bw, right_bw, *,
                               go, ge, rc, ms, max_gap, max_intron):
    """Plain version of anchored_forward (sw_pallas._anch_kernel)."""
    n, ql = q.shape
    rl = r.shape[1]
    dev = q.device
    sc = dict(go=go, ge=ge, rc=rc, ms=ms, max_gap=max_gap,
              max_intron=max_intron)
    qlens = qlens.to(device=dev, dtype=I32)
    rlens = rlens.to(device=dev, dtype=I32)
    lbw = left_bw.to(device=dev, dtype=torch.int64)
    rbw = right_bw.to(device=dev, dtype=torch.int64)
    q32 = q.to(I32)
    r32 = r.to(I32)

    def full(v):
        return torch.full((n,), v, dtype=I32, device=dev)

    pv = torch.full((rl + 1, n), DP_WORST, dtype=I32, device=dev)
    pf = pv.clone()
    pi = torch.zeros((rl + 1, n), dtype=I32, device=dev)
    bt = torch.zeros((n, ql + 1, rl + 1), dtype=torch.int8, device=dev)
    pv[0] = 0
    live_hi = torch.minimum(rbw, rlens.to(torch.int64))
    for j in range(1, rl + 1):
        lv = j <= live_hi
        pv[j] = torch.where(lv, -(go + j * ge), DP_WORST)
        bt[:, 0, j] = torch.where(
            lv, OP_DELETE + (BT_CD if j >= 2 else 0), 0).to(torch.int8)
    score = full(DP_WORST)
    if n == 0:
        return {"score": score, "bt": bt}
    lbw_max, rbw_max = int(lbw.max()), int(rbw.max())
    rlen_max = int(rlens.max())
    for i in range(1, ql + 1):
        row_active = i <= qlens
        if not bool(row_active.any()):
            break
        col0 = row_active & (i <= lbw)
        edge_val = -(go + i * ge)
        prev = pv[0].clone()
        pv[0] = torch.where(col0, edge_val, pv[0])
        bt[:, i, 0] = torch.where(
            col0, OP_INSERT + (BT_CF if i > 1 else 0), 0).to(torch.int8)
        qc = q32[:, i - 1]
        pe, pd = full(DP_WORST), full(0)
        pvl = torch.where(i <= lbw, edge_val, DP_WORST).to(I32)
        # Columns outside every problem's band change nothing.
        jlo = max(1, i - lbw_max)
        jhi = min(rl, i + rbw_max, rlen_max)
        if jlo > 1:
            prev = pv[jlo - 1].clone()
        for j in range(jlo, jhi + 1):
            act = (row_active & (j >= i - lbw) & (j <= i + rbw)
                   & (j <= rlens))
            old = pv[j].clone()
            v, pe_n, pd_n, f, ii, packed = _cell(
                prev, qc, r32[:, j - 1], pe, pd, pvl, pf[j], old, pi[j],
                gap_ties=False, **sc)
            pf[j] = torch.where(act, f, pf[j])
            pi[j] = torch.where(act, ii, pi[j])
            pv[j] = torch.where(act, v, old)
            bt[:, i, j] = torch.where(act, packed, bt[:, i, j])
            score = torch.where(act & (i == qlens) & (j == rlens), v, score)
            pe = torch.where(act, pe_n, pe)
            pd = torch.where(act, pd_n, pd)
            pvl = torch.where(act, v, pvl)
            prev = old
    return {"score": score, "bt": bt}


def anchored_forward_banded_reference(q, qlens, r, rlens, left_bw, right_bw,
                                      *, wband, go, ge, rc, ms, max_gap,
                                      max_intron):
    """Plain version of anchored_forward_banded
    (sw_pallas._anch_banded_kernel)."""
    n, ql = q.shape
    rl = r.shape[1]
    dev = q.device
    sc = dict(go=go, ge=ge, rc=rc, ms=ms, max_gap=max_gap,
              max_intron=max_intron)
    qlens = qlens.to(device=dev, dtype=I32)
    rlens = rlens.to(device=dev, dtype=I32)
    lbw = left_bw.to(device=dev, dtype=I32)
    rbw = right_bw.to(device=dev, dtype=I32)
    bandw = lbw + rbw
    q32 = q.to(I32)
    # Reference column j - 1 with 255 outside [0, RL) (the Pallas entry's
    # pre-shift r2[s] = r[s - lbw] at s = i - 1 + o).
    r_pad = torch.full((n, rl + 2), 255, dtype=I32, device=dev)
    r_pad[:, 1:rl + 1] = r.to(I32)

    def full(v):
        return torch.full((n,), v, dtype=I32, device=dev)

    pv = torch.full((wband + 1, n), DP_WORST, dtype=I32, device=dev)
    pf = pv.clone()
    pi = torch.zeros((wband + 1, n), dtype=I32, device=dev)
    bt = torch.zeros((n, ql + 1, wband), dtype=torch.int8, device=dev)
    live_hi = torch.minimum(rbw, rlens)
    for o in range(wband):
        j0 = o - lbw
        lv = (j0 >= 1) & (j0 <= live_hi)
        pv[o] = torch.where(j0 == 0, 0,
                            torch.where(lv, -(go + j0 * ge), DP_WORST))
        bt[:, 0, o] = torch.where(
            lv, OP_DELETE + BT_CD * (j0 >= 2).to(I32), 0).to(torch.int8)
    score = full(DP_WORST)
    for i in range(1, ql + 1):
        row_active = i <= qlens
        if not bool(row_active.any()):
            break
        edge_val = -(go + i * ge)
        bound_bt = OP_INSERT + (BT_CF if i > 1 else 0)
        qc = q32[:, i - 1]
        pe, pd, pvl = full(DP_WORST), full(0), full(DP_WORST)
        for o in range(wband):
            j = i + o - lbw
            act = row_active & (j >= 1) & (o <= bandw) & (j <= rlens)
            bound = row_active & (j == 0)
            rch = r_pad.gather(1, j.clamp(0, rl + 1).to(torch.int64)[:, None])
            v, pe_n, pd_n, f, ii, packed = _cell(
                pv[o], qc, rch[:, 0], pe, pd, pvl, pf[o + 1], pv[o + 1],
                pi[o + 1], gap_ties=False, **sc)
            bval = torch.where(bound, edge_val, DP_WORST).to(I32)
            pf[o] = torch.where(act, f, DP_WORST)
            pi[o] = torch.where(act, ii, 0)
            pv[o] = torch.where(act, v, bval)
            bt[:, i, o] = torch.where(
                act, packed,
                torch.where(bound, bound_bt, 0).to(torch.int8))
            score = torch.where(act & (i == qlens) & (j == rlens), v, score)
            pe = torch.where(act, pe_n, DP_WORST)
            pd = torch.where(act, pd_n, 0)
            pvl = torch.where(act, v, bval)
    return {"score": score, "bt_b": bt}


# ---- wrappers: CUDA kernel on a CUDA tensor, plain version on the CPU ----

def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check(name, q, r, lens):
    """Validate inputs for a launch; returns int32 copies of `lens` on the
    device of q."""
    if q.device.type != "cuda":
        raise ValueError("%s: tensors on %s are not supported (cpu or "
                         "cuda)" % (name, q.device))
    for label, t in (("q", q), ("r", r)):
        if t.dtype != torch.uint8 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError("%s: %s must be a contiguous 2-D uint8 tensor"
                             % (name, label))
        if t.device != q.device:
            raise ValueError("%s: %s is on %s, q on %s"
                             % (name, label, t.device, q.device))
    if r.shape[0] != q.shape[0]:
        raise ValueError("%s: q has %d problems, r %d"
                         % (name, q.shape[0], r.shape[0]))
    out = []
    for t in lens:
        if t.dim() != 1 or t.shape[0] != q.shape[0]:
            raise ValueError("%s: per-problem arrays must be [N]" % name)
        out.append(t.to(device=q.device, dtype=I32).contiguous())
    return out


def _launched(name, err):
    """Count a launch whose C entry returned cudaGetLastError() == 0."""
    if err != 0:
        raise RuntimeError("%s: CUDA kernel launch failed with error %d"
                           % (name, err))
    with _launch_lock:
        _launches[name] += 1


def _p(t):
    return t.data_ptr()


def ext_variant(band_width):
    """The extension kernel for a band width, chosen by shape before the
    launch: "reg" (band state in registers) for W in REG_WIDTHS, "wide"
    (a warp a problem) for the other widths whose warp fits a block's
    shared memory (W up to 2,829, -BW 707), "block" (a block of warps a
    problem) past them."""
    w = 4 * band_width + 1
    if w in REG_WIDTHS:
        return "reg"
    return "wide" if wide_warp_bytes(w) <= WIDE_SMEM_MAX else "block"


def extension_forward(q, qlens, r, rlens, *, band_width, go, ge, rc, ms,
                      max_gap, max_intron, x_cutoff, variant=None,
                      block=EXT_BLOCK):
    """Banded X-drop forward extension; the contract of
    sw_pallas.extension_forward_pallas for any N.

    q: [N, QL] uint8, r: [N, RL] uint8 (RL >= QL + 4*band_width),
    qlens/rlens: [N].  Returns score/maxi/maxj [N] int32 and the packed
    backtrack plane bt [N, QL+1, 4*band_width+1] int8.  On the card,
    `variant` (default ext_variant(band_width)) picks the kernel: "reg"
    for W in REG_WIDTHS, with `block` threads a block; "wide" (a warp a
    block) for any W whose warp fits a block's shared memory (up to W
    2,829, -BW 707); "block" (a block of EXT_BLOCK_WARPS warps a problem)
    for any W whose row fits (up to W 14,265, -BW 3,566: ext_wide_fits).
    Each C entry refuses a band too wide for its kernel.  All return the
    same arrays.
    """
    kw = dict(band_width=band_width, go=go, ge=ge, rc=rc, ms=ms,
              max_gap=max_gap, max_intron=max_intron, x_cutoff=x_cutoff)
    if q.device.type == "cpu":
        return extension_forward_reference(q, qlens, r, rlens, **kw)
    name = "extension_forward"
    qlens, rlens = _check(name, q, r, (qlens, rlens))
    n, ql = q.shape
    bw2 = 2 * band_width
    w = 2 * bw2 + 1
    variant = variant or ext_variant(band_width)
    if not ((variant == "reg" and w in REG_WIDTHS and block in REG_BLOCKS)
            or (variant in ("wide", "block") and w >= 1)):
        raise ValueError("%s: no %s kernel for W=%d, block=%d"
                         % (name, variant, w, block))
    dev = q.device
    # The register kernel leaves the rows after a problem's exit row
    # unwritten; the wide and block kernels write every byte.
    alloc = torch.zeros if variant == "reg" else torch.empty
    bt = alloc((n, ql + 1, w), dtype=torch.int8, device=dev)
    score, maxi, maxj = torch.empty((3, n), dtype=I32, device=dev)
    if n:
        from . import _build
        lib = _build.load()
        args = (_p(q), _p(r), _p(qlens), _p(rlens), n, ql, r.shape[1], bw2,
                go, ge, rc, ms, max_gap, max_intron, x_cutoff, _p(bt),
                _p(score), _p(maxi), _p(maxj))
        if variant == "reg":
            _launched(name, lib.yt_ext_forward_reg(*args, block,
                                                   _stream(dev)))
        elif variant == "wide":
            _launched(name + "_wide", lib.yt_ext_forward_wide(
                *args, _stream(dev)))
        else:
            _launched(name + "_block", lib.yt_ext_forward_block(
                *args, _stream(dev)))
    return {"score": score, "maxi": maxi, "maxj": maxj, "bt": bt}


def anchored_forward_banded(q, qlens, r, rlens, left_bw, right_bw, *, wband,
                            go, ge, rc, ms, max_gap, max_intron):
    """Anchored gap fill in band-relative columns o = j - i + lbw; the
    contract of sw_pallas.anchored_forward_pallas_banded for any N.

    wband >= max(left_bw + right_bw) + 1.  Returns score [N] int32 and
    bt_b [N, QL+1, wband] int8 (insert chains run diagonally).  On the
    card wband may be at most 2,832 when it is over 32 (the wide route's
    warp must fit a block's shared memory; the C entry refuses a wider
    plane).
    """
    kw = dict(go=go, ge=ge, rc=rc, ms=ms, max_gap=max_gap,
              max_intron=max_intron)
    if q.device.type == "cpu":
        return anchored_forward_banded_reference(
            q, qlens, r, rlens, left_bw, right_bw, wband=wband, **kw)
    name = "anchored_forward_banded"
    qlens, rlens, lbw, rbw = _check(name, q, r,
                                    (qlens, rlens, left_bw, right_bw))
    if wband < 1:
        raise ValueError("%s: wband must be at least 1" % name)
    n, ql = q.shape
    dev = q.device
    # The kernels write every byte of their planes.
    bt = torch.empty((n, ql + 1, wband), dtype=torch.int8, device=dev)
    score = torch.empty(n, dtype=I32, device=dev)
    if n:
        from . import _build
        _launched(name, _build.load().yt_anch_banded(
            _p(q), _p(r), _p(qlens), _p(rlens), _p(lbw), _p(rbw), n, ql,
            r.shape[1], wband, go, ge, rc, ms, max_gap, max_intron, _p(bt),
            _p(score), _stream(dev)))
    return {"score": score, "bt_b": bt}


def anchored_forward(q, qlens, r, rlens, left_bw, right_bw, *, go, ge, rc,
                     ms, max_gap, max_intron):
    """Anchored gap fill over all RL+1 columns; the contract of
    sw_pallas.anchored_forward_pallas for any N and any RL.

    Returns score [N] int32 and bt [N, QL+1, RL+1] int8 (insert chains
    run straight up).  On the card RL may be at most 2,831 when it is over
    32 (full_wide_fits; the C entry refuses a wider plane, as for
    anchored_forward_banded).
    """
    kw = dict(go=go, ge=ge, rc=rc, ms=ms, max_gap=max_gap,
              max_intron=max_intron)
    if q.device.type == "cpu":
        return anchored_forward_reference(q, qlens, r, rlens, left_bw,
                                          right_bw, **kw)
    name = "anchored_forward"
    qlens, rlens, lbw, rbw = _check(name, q, r,
                                    (qlens, rlens, left_bw, right_bw))
    n, ql = q.shape
    rl = r.shape[1]
    dev = q.device
    # The kernels write every byte of their planes.
    bt = torch.empty((n, ql + 1, rl + 1), dtype=torch.int8, device=dev)
    score = torch.empty(n, dtype=I32, device=dev)
    if n:
        from . import _build
        _launched(name, _build.load().yt_anch_full(
            _p(q), _p(r), _p(qlens), _p(rlens), _p(lbw), _p(rbw), n, ql,
            rl, go, ge, rc, ms, max_gap, max_intron, _p(bt), _p(score),
            _stream(dev)))
    return {"score": score, "bt": bt}


# ---- 4-bit packed entries (sw_pallas.py:652-701) ----

def pack4_host(a):
    """Pack [n, g] uint8 codes (<= 15) two per byte, low nibble first, on
    the host; pad bytes 255 stay 255 (sw_pallas.pack4_host)."""
    return (a[:, ::2] | (a[:, 1::2] << 4)).astype(np.uint8)


def unpack4(p):
    """[n, g/2] uint8 -> [n, g] on p's device (sw_pallas._unpack4): byte
    255 unpacks to code 15, which stays a mismatch past the problem."""
    return torch.stack([p & 0xF, p >> 4], dim=-1).reshape(p.shape[0],
                                                          2 * p.shape[1])


def extension_forward_p4(qp, qlens, rp, rlens, **kw):
    """extension_forward with 4-bit packed q/r."""
    return extension_forward(unpack4(qp), qlens, unpack4(rp), rlens, **kw)


def anchored_forward_p4(qp, qlens, rp, rlens, left_bw, right_bw, **kw):
    """anchored_forward with 4-bit packed q/r."""
    return anchored_forward(unpack4(qp), qlens, unpack4(rp), rlens, left_bw,
                            right_bw, **kw)


def anchored_forward_banded_p4(qp, qlens, rp, rlens, left_bw, right_bw,
                               **kw):
    """anchored_forward_banded with 4-bit packed q/r."""
    return anchored_forward_banded(unpack4(qp), qlens, unpack4(rp), rlens,
                                   left_bw, right_bw, **kw)
