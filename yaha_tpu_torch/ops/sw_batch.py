"""Batched banded affine-gap DPs in PyTorch ops: the eo/idc planes.

Counterpart of yaha_tpu/ops/sw_batch.py, the JAX package's XLA lockstep
DPs (findAffineGapScore, SW.cpp:798-1208): N problems walk their rows in
lockstep, each cell the reference's, with the same keyword arguments and
the same outputs:

  batched_extension_forward  (sw_batch.py:36)  banded X-drop extensions:
      score/maxi/maxj [N] int32, eo [N, QL+1, W] int8, idc [N, QL+1, W]
      int32, W = 4*band_width + 1
  batched_anchored_forward   (sw_batch.py:198) gap fills as a masked full
      matrix (full DP, or a band of per-problem left/right widths):
      score [N] int32, eo/idc [N, QL+1, RL+1]

These are the JAX package's jnp programs, not Pallas kernels, and their
counterpart here is PyTorch ops on the inputs' device (StagedAligner
backend="torch", --engine batch-torch; the native engine's FMT_EOIDC
apply decodes the planes).  Nothing on the main path (--engine
batch-cuda) calls them.

What is kept from the lockstep: the row-0 delete init and the
anti-diagonal (extension) or first-column (anchored) insert init; the
per-cell order, delete checked before insert, each capped by its run
limit; ties to the gap with >= in extensions and strict > in gap fills;
the X-drop `done` mask, the row loop ending when every problem is done
(extensions); int32 arithmetic wrapping as in JAX.  What differs is only
the order of evaluation: within a row every term that reads the row above
(the diagonal value, the insert run) is computed for all band columns at
once, and only the delete run, which carries along the row, steps column
by column; columns and rows outside every problem's band, which change
nothing, are skipped.  The batch dimension is not padded (the JAX
package pads it to a power of two for its compiled shapes).
"""
from __future__ import annotations

import torch

from .dp_common import (DP_WORST, OP_DELETE, OP_INSERT, OP_MATCH,
                        OP_REPLACE, OP_UNKNOWN)

I32 = torch.int32
I8 = torch.int8


def _delete_chain(g, f, active, pv_col, *, go, ge, max_intron, gap_ties):
    """The delete run along a row's columns c, vectorised over problems:
    g / f / active [N, C] (diagonal value, insert value, cell in the band),
    pv_col [N] the value left of the first column.  Returns the cells'
    values, delete run lengths and which cells took the delete and the
    insert, [N, C] each."""
    n, ncols = g.shape
    pe = torch.full((n,), DP_WORST, dtype=I32, device=g.device)
    pd = torch.zeros((n,), dtype=I32, device=g.device)
    vs, pds, tds, tfs = [], [], [], []
    for c in range(ncols):
        gc, fc, ac = g[:, c], f[:, c], active[:, c]
        ce = pe - ge
        ne = pv_col - (go + ge)
        cont_d = (ce >= ne) & (pd + 1 <= max_intron)
        pe_n = torch.where(cont_d, ce, ne)
        pd_n = torch.where(cont_d, pd + 1, 1)
        take_d = pe_n >= gc if gap_ties else pe_n > gc
        v1 = torch.where(take_d, pe_n, gc)
        take_f = fc >= v1 if gap_ties else fc > v1
        v2 = torch.where(take_f, fc, v1)
        vs.append(v2)
        pds.append(pd_n)
        tds.append(take_d)
        tfs.append(take_f)
        pe = torch.where(ac, pe_n, pe)
        pd = torch.where(ac, pd_n, pd)
        pv_col = torch.where(ac, v2, pv_col)
    return (torch.stack(vs, 1), torch.stack(pds, 1), torch.stack(tds, 1),
            torch.stack(tfs, 1))


def _insert_run(pf_up, pv_up, pi_up, *, go, ge, max_gap):
    """The insert run of every column from the row above: (value, run
    length)."""
    cf = pf_up - ge
    nf = pv_up - (go + ge)
    cont_f = (cf >= nf) & (pi_up + 1 <= max_gap)
    return torch.where(cont_f, cf, nf), torch.where(cont_f, pi_up + 1, 1)


def batched_extension_forward(q, qlens, r, rlens, *, band_width, go, ge, rc,
                              ms, max_gap, max_intron, x_cutoff):
    """Forward pass of N banded X-drop extensions (sw_batch.py:36).

    q: [N, QL] query codes (row i reads q[:, i-1]), qlens [N], r: [N, RL]
    reference codes (RL >= QL + 4*band_width), rlens [N].  Returns score,
    maxi, maxj [N] int32, eo [N, QL+1, W] int8 and idc [N, QL+1, W] int32.
    """
    n, ql_max = q.shape
    rl = r.shape[1]
    dev = q.device
    bw2 = 2 * band_width
    w = 2 * bw2 + 1
    qlens = qlens.to(device=dev, dtype=I32)
    rlens = rlens.to(device=dev, dtype=I32)
    q32 = q.to(I32)
    # r_pad[:, i-1 + j] is reference index i - bw2 - 1 + j; 255 outside.
    r_pad = torch.full((n, bw2 + rl + w), 255, dtype=I32, device=dev)
    r_pad[:, bw2:bw2 + rl] = r.to(I32)

    # Row-0 initialisation (SW.cpp:899-933).
    j_idx = torch.arange(w, device=dev)
    delete_count = (j_idx - bw2).to(I32)
    pv = torch.full((n, w + 1), DP_WORST, dtype=I32, device=dev)
    pv[:, :w] = torch.where(j_idx > bw2, -(go + delete_count * ge),
                            DP_WORST)
    pv[:, bw2] = 0
    pf = torch.full((n, w + 1), DP_WORST, dtype=I32, device=dev)
    pf[:, bw2] = 0
    pi = torch.zeros((n, w + 1), dtype=I32, device=dev)
    eo = torch.zeros((n, ql_max + 1, w), dtype=I8, device=dev)
    idc = torch.zeros((n, ql_max + 1, w), dtype=I32, device=dev)
    eo[:, 0, :] = torch.where(j_idx > bw2, OP_DELETE, OP_UNKNOWN).to(I8)
    idc[:, 0, :] = torch.where(j_idx > bw2, delete_count, 0)
    # Anti-diagonal insert inits: rows 1..bw2 at j = bw2 - i.
    for i in range(1, min(bw2, ql_max) + 1):
        eo[:, i, bw2 - i] = OP_INSERT
        idc[:, i, bw2 - i] = i

    max_score = torch.full((n,), DP_WORST, dtype=I32, device=dev)
    maxi = torch.zeros((n,), dtype=I32, device=dev)
    maxj = torch.zeros((n,), dtype=I32, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    rl_max = int(rlens.max()) if n else 0
    for i in range(1, ql_max + 1):
        if n == 0 or bool(done.all()):
            break
        start = max(bw2 + 1 - i, 0)
        edge_val = -(go + i * ge)
        if i <= bw2:
            pv[:, bw2 - i] = edge_val
        end_col = torch.clamp(bw2 + rlens - i, max=w - 1)
        row_active = ~done & (i <= qlens)
        # Columns past every problem's end change nothing.
        stop = min(w - 1, bw2 + rl_max - i)
        if stop >= start:
            cols = j_idx[start:stop + 1]
            active = row_active[:, None] & (cols[None, :] <=
                                            end_col[:, None])
            v = pv[:, start:stop + 1]
            is_match = q32[:, i - 1:i] == r_pad[:, i - 1 + start:i + stop]
            g = torch.where(is_match, v + ms, v - rc)
            op_g = torch.where(is_match, OP_MATCH, OP_REPLACE)
            f, ii = _insert_run(pf[:, start + 1:stop + 2],
                                pv[:, start + 1:stop + 2],
                                pi[:, start + 1:stop + 2], go=go, ge=ge,
                                max_gap=max_gap)
            pv_col = torch.full((n,), edge_val if i <= bw2 else DP_WORST,
                                dtype=I32, device=dev)
            v2, pd, take_d, take_f = _delete_chain(
                g, f, active, pv_col, go=go, ge=ge, max_intron=max_intron,
                gap_ties=True)
            opcode = torch.where(take_f, OP_INSERT,
                                 torch.where(take_d, OP_DELETE, op_g))
            eo_row = eo[:, i, start:stop + 1]
            idc_row = idc[:, i, start:stop + 1]
            cell_idc = torch.where(take_f, ii,
                                   torch.where(take_d, pd, idc_row))
            eo[:, i, start:stop + 1] = torch.where(active, opcode.to(I8),
                                                   eo_row)
            idc[:, i, start:stop + 1] = torch.where(active, cell_idc,
                                                    idc_row)
            pf[:, start:stop + 1] = torch.where(active, f,
                                                pf[:, start:stop + 1])
            pi[:, start:stop + 1] = torch.where(active, ii,
                                                pi[:, start:stop + 1])
            pv[:, start:stop + 1] = torch.where(active, v2, v)
            # Row max and the row's first best cell (strict >).
            masked = torch.where(active, v2, DP_WORST)
            row_max, best_c = masked.max(1)
            best_j = torch.where(row_max > DP_WORST, best_c.to(I32) + start,
                                 0)
        else:
            row_max = torch.full((n,), DP_WORST, dtype=I32, device=dev)
            best_j = torch.zeros((n,), dtype=I32, device=dev)
        # Global max (strict >, row-major first occurrence).
        upd = row_active & (row_max > max_score)
        max_score = torch.where(upd, row_max, max_score)
        maxi = torch.where(upd, i, maxi)
        maxj = torch.where(upd, best_j, maxj)
        # X-cutoff row break (SW.cpp:1091) and the natural end of rows.
        newly_done = row_active & (row_max < max_score - x_cutoff)
        done = done | newly_done | (i >= qlens)
    return {"score": max_score, "maxi": maxi, "maxj": maxj, "eo": eo,
            "idc": idc}


def batched_anchored_forward(q, qlens, r, rlens, left_bw, right_bw, *, go,
                             ge, rc, ms, max_gap, max_intron):
    """Forward pass of N anchored gap fills (sw_batch.py:198) as a masked
    full matrix: cells outside a problem's band are never updated and read
    as DP_WORST, so full DP (left_bw = right_bw >= max(qlen, rlen)) and
    the banded DP with asymmetric widths (SW.cpp:855-871) give the
    reference's values, op codes and backtrack.  Ties keep the
    match/replace unless a gap is strictly better.

    Returns score [N] int32 (V at (qlen, rlen)), eo [N, QL+1, RL+1] int8
    and idc [N, QL+1, RL+1] int32.
    """
    n, ql_max = q.shape
    rl_max = r.shape[1]
    dev = q.device
    wid = rl_max + 1
    qlens = qlens.to(device=dev, dtype=I32)
    rlens = rlens.to(device=dev, dtype=I32)
    lbw = left_bw.to(device=dev, dtype=I32)
    rbw = right_bw.to(device=dev, dtype=I32)
    q32 = q.to(I32)
    r32 = r.to(I32)

    rj = torch.arange(wid, device=dev)
    # Row 0: the delete boundary for rj in [1, min(rlen, right_bw)].
    row0_live = ((rj[None, :] >= 1) & (rj[None, :] <= rbw[:, None])
                 & (rj[None, :] <= rlens[:, None]))
    pv = torch.full((n, wid + 1), DP_WORST, dtype=I32, device=dev)
    pv[:, :wid] = torch.where(row0_live, -(go + rj[None, :].to(I32) * ge),
                              DP_WORST)
    pv[:, 0] = 0
    pf = torch.full((n, wid + 1), DP_WORST, dtype=I32, device=dev)
    pi = torch.zeros((n, wid + 1), dtype=I32, device=dev)
    eo = torch.zeros((n, ql_max + 1, wid), dtype=I8, device=dev)
    idc = torch.zeros((n, ql_max + 1, wid), dtype=I32, device=dev)
    eo[:, 0, :] = torch.where(row0_live, OP_DELETE, OP_UNKNOWN).to(I8)
    idc[:, 0, :] = torch.where(row0_live, rj[None, :].to(I32), 0)
    # The first-column insert boundary, rows 1..min(qlen, left_bw).
    i_rows = torch.arange(ql_max + 1, device=dev)
    col0_live = ((i_rows[None, :] >= 1) & (i_rows[None, :] <= lbw[:, None])
                 & (i_rows[None, :] <= qlens[:, None]))
    eo[:, :, 0] = torch.where(col0_live, OP_INSERT, OP_UNKNOWN).to(I8)
    idc[:, :, 0] = torch.where(col0_live, i_rows[None, :].to(I32), 0)

    score = torch.full((n,), DP_WORST, dtype=I32, device=dev)
    if n == 0:
        return {"score": score, "eo": eo, "idc": idc}
    # Rows past every qlen and columns outside every band change nothing.
    ql_top = int(qlens.max())
    lbw_max, rbw_max = int(lbw.max()), int(rbw.max())
    rlen_max = int(rlens.max())
    for i in range(1, min(ql_top, ql_max) + 1):
        row_active = i <= qlens
        edge_val = -(go + i * ge)
        v_new = torch.full((n, wid + 1), DP_WORST, dtype=I32, device=dev)
        v_new[:, 0] = torch.where(row_active & (i <= lbw), edge_val,
                                  pv[:, 0])
        jlo = max(1, i - lbw_max)
        jhi = min(rl_max, i + rbw_max, rlen_max)
        if jhi >= jlo:
            cols = rj[jlo:jhi + 1][None, :]
            in_band = ((cols >= torch.clamp(i - lbw, min=1)[:, None])
                       & (cols <= torch.minimum(i + rbw, rlens)[:, None]))
            active = row_active[:, None] & in_band
            is_match = q32[:, i - 1:i] == r32[:, jlo - 1:jhi]
            v = pv[:, jlo - 1:jhi]
            g = torch.where(is_match, v + ms, v - rc)
            op_g = torch.where(is_match, OP_MATCH, OP_REPLACE)
            f, ii = _insert_run(pf[:, jlo:jhi + 1], pv[:, jlo:jhi + 1],
                                pi[:, jlo:jhi + 1], go=go, ge=ge,
                                max_gap=max_gap)
            # The value left of column jlo (when jlo > 1, every problem
            # is past its insert boundary: DP_WORST).
            pv_col = torch.where(i <= lbw, edge_val, DP_WORST).to(I32)
            v2, pd, take_d, take_f = _delete_chain(
                g, f, active, pv_col, go=go, ge=ge, max_intron=max_intron,
                gap_ties=False)
            opcode = torch.where(take_f, OP_INSERT,
                                 torch.where(take_d, OP_DELETE, op_g))
            cell_idc = torch.where(take_f, ii, torch.where(take_d, pd, 0))
            eo[:, i, jlo:jhi + 1] = torch.where(
                active, opcode.to(I8), eo[:, i, jlo:jhi + 1])
            idc[:, i, jlo:jhi + 1] = torch.where(
                active, cell_idc, idc[:, i, jlo:jhi + 1])
            pf[:, jlo:jhi + 1] = torch.where(active, f, pf[:, jlo:jhi + 1])
            pi[:, jlo:jhi + 1] = torch.where(active, ii, pi[:, jlo:jhi + 1])
            v_new[:, jlo:jhi + 1] = torch.where(active, v2, DP_WORST)
            # V at (qlen, rlen), when this is row qlen and that cell is in
            # the band.
            c = (rlens - jlo).clamp(0, jhi - jlo).to(torch.int64)[:, None]
            hit = ((i == qlens) & (rlens >= jlo) & (rlens <= jhi)
                   & active.gather(1, c)[:, 0])
            score = torch.where(hit, v2.gather(1, c)[:, 0], score)
        pv = torch.where(row_active[:, None], v_new, pv)
    return {"score": score, "eo": eo, "idc": idc}
