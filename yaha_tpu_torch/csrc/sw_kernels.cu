// The anchored gap fill's global-scratch bodies, anch_banded_problem and
// anch_full_problem, which anch_kernels.cu runs for its warps wider than
// 32 columns (its own kernels keep narrower bands in registers).  They
// compute yaha_tpu/ops/sw_pallas.py's _anch_banded_kernel and _anch_kernel
// for one problem and return the same arrays byte for byte.
//
// Layout.  One thread owns one problem; it walks the query rows and, inside
// a row, the band columns in order, like the reference inner loop.  The
// previous row's PV/PF/PI state lives in global scratch laid out
// [3][cols][N], problem-minor, so that a warp's 32 problems touch 32
// consecutive words and the accesses coalesce for any band width.
// Backtrack planes are problem-major [N][QL+1][W] int8, exactly the JAX
// layout, because the native walkers read them with a plane stride and a
// row stride.  The caller zero-fills them: OP_UNKNOWN is 0, and every cell
// the Pallas kernels write as "fill" is 0.
//
// The reference reads replace the Pallas entries' padding passes with
// index arithmetic: out-of-range positions read 255, a guaranteed
// mismatch (codes are 0-14).
//
// What bounds these bodies on the card: the column recurrence is
// sequential within a problem, so time per cell is one dependent chain of
// ~20 integer ops plus a scratch load/store round trip, and the bt stores
// are strided by the plane size between the threads of a warp.  Such warps
// carry next to none of the gap cells (chip_smoke.py phase 5's histogram).
#ifndef YT_SW_KERNELS_CU
#define YT_SW_KERNELS_CU

#include "sw_cells.cuh"

namespace ytsw {

// Scratch slot k (0 = PV, 1 = PF, 2 = PI) of column j for problem p.
YT_HD int64_t sidx(int k, int64_t j, int64_t cols, int64_t n, int64_t p) {
    return ((int64_t)k * cols + j) * n + p;
}

// Anchored gap fill of problem p over full-matrix columns 0..RL
// (sw_pallas._anch_kernel).  Scratch has RL+2 columns.  Cells outside the
// band keep their old state, so a row computes only its live interval;
// the diagonal predecessor is the old PV of the column to the left.
YT_HD void anch_full_problem(int64_t p, int64_t n, const uint8_t* q,
                             int64_t ql, const uint8_t* r, int64_t rl,
                             const int32_t* qlens, const int32_t* rlens,
                             const int32_t* lbws, const int32_t* rbws,
                             Scoring s, int8_t* bt, int32_t* score,
                             int32_t* scr) {
    const int64_t wid = rl + 1;
    const int64_t cols = rl + 2;
    int32_t* pv = scr + sidx(0, 0, cols, n, p);
    int32_t* pf = scr + sidx(1, 0, cols, n, p);
    int32_t* pi = scr + sidx(2, 0, cols, n, p);
    int8_t* btp = bt + p * (ql + 1) * wid;
    const uint8_t* qp = q + p * ql;
    const uint8_t* rp = r + p * rl;
    const int32_t qlen = qlens[p], rlen = rlens[p];
    const int64_t lbw = lbws[p], rbw = rbws[p];

    // Row 0: origin, then the delete boundary for j in [1, min(rbw, rlen)].
    pv[0] = 0;
    pf[0] = DP_WORST;
    pi[0] = 0;
    const int64_t live_hi = rbw < rlen ? rbw : rlen;
    for (int64_t j = 1; j < wid; j++) {
        const bool lv = j <= live_hi;
        pv[j * n] =
            lv ? wsub(0, wadd(s.go, wmul((int32_t)j, s.ge))) : DP_WORST;
        pf[j * n] = DP_WORST;
        pi[j * n] = 0;
        if (lv) btp[j] = (int8_t)(OP_DELETE + (j >= 2 ? BT_CD : 0));
    }

    int32_t sc = DP_WORST;
    const int64_t last = qlen < ql ? qlen : ql;
    for (int64_t i = 1; i <= last; i++) {
        const int32_t edge_val =
            wsub(0, wadd(s.go, wmul((int32_t)i, s.ge)));
        const bool col0 = i <= lbw;
        const int32_t prev0 = pv[0];
        if (col0) {
            // Column-0 insert boundary; its chain runs straight up.
            pv[0] = edge_val;
            btp[i * wid] = (int8_t)(OP_INSERT + (i > 1 ? BT_CF : 0));
        }
        const int32_t qc = qp[i - 1];
        int64_t jlo = i - lbw > 1 ? i - lbw : 1;
        int64_t jhi = i + rbw < rlen ? i + rbw : rlen;
        if (jhi > rl) jhi = rl;
        int32_t pe = DP_WORST, pd = 0, pvl = col0 ? edge_val : DP_WORST;
        int32_t diag = jlo == 1 ? prev0 : pv[(jlo - 1) * n];
        int8_t* brow = btp + i * wid;
        for (int64_t j = jlo; j <= jhi; j++) {
            const int64_t jn = j * n;
            const int32_t old = pv[jn];
            CellOut c = cell<false>(diag, qc, ref_at(rp, rl, j - 1), pe,
                                    pd, pvl, pf[jn], old, pi[jn], s);
            pf[jn] = c.f;
            pi[jn] = c.ii;
            pv[jn] = c.v;
            brow[j] = (int8_t)c.bt;
            if (i == qlen && j == rlen) sc = c.v;
            pe = c.pe;
            pd = c.pd;
            pvl = c.v;
            diag = old;
        }
    }
    score[p] = sc;
}

// Anchored gap fill of problem p in band-relative columns o = j - i + lbw,
// o in [0, wband) (sw_pallas._anch_banded_kernel).  Scratch has wband+1
// columns (index wband is the band-edge sentinel).  Cells outside the
// problem's own band reset to DP_WORST / 0, and the column-0 insert
// boundary slides through the band at o = lbw - i.  The reference is read
// at j - 1 = i - 1 + o - lbw, the Pallas entry's pre-shift r2[s] =
// r[s - lbw] done as index arithmetic.
YT_HD void anch_banded_problem(int64_t p, int64_t n, const uint8_t* q,
                               int64_t ql, const uint8_t* r, int64_t rl,
                               const int32_t* qlens, const int32_t* rlens,
                               const int32_t* lbws, const int32_t* rbws,
                               int32_t wband, Scoring s, int8_t* bt,
                               int32_t* score, int32_t* scr) {
    const int64_t cols = wband + 1;
    int32_t* pv = scr + sidx(0, 0, cols, n, p);
    int32_t* pf = scr + sidx(1, 0, cols, n, p);
    int32_t* pi = scr + sidx(2, 0, cols, n, p);
    int8_t* btp = bt + p * (ql + 1) * wband;
    const uint8_t* qp = q + p * ql;
    const uint8_t* rp = r + p * rl;
    const int32_t qlen = qlens[p], rlen = rlens[p];
    const int64_t lbw = lbws[p], rbw = rbws[p];
    const int64_t bandw = lbw + rbw;

    // Row 0 (j0 = o - lbw): origin at j0 == 0, delete boundary for
    // 1 <= j0 <= min(rbw, rlen), DP_WORST elsewhere.
    const int64_t live_hi = rbw < rlen ? rbw : rlen;
    for (int32_t o = 0; o < wband; o++) {
        const int64_t j0 = o - lbw;
        const bool lv = j0 >= 1 && j0 <= live_hi;
        int32_t v = DP_WORST;
        if (j0 == 0) v = 0;
        if (lv) {
            v = wsub(0, wadd(s.go, wmul((int32_t)j0, s.ge)));
            btp[o] = (int8_t)(OP_DELETE + (j0 >= 2 ? BT_CD : 0));
        }
        pv[(int64_t)o * n] = v;
        pf[(int64_t)o * n] = DP_WORST;
        pi[(int64_t)o * n] = 0;
    }
    pv[(int64_t)wband * n] = DP_WORST;
    pf[(int64_t)wband * n] = DP_WORST;
    pi[(int64_t)wband * n] = 0;

    int32_t sc = DP_WORST;
    const int64_t last = qlen < ql ? qlen : ql;
    for (int64_t i = 1; i <= last; i++) {
        const int32_t edge_val =
            wsub(0, wadd(s.go, wmul((int32_t)i, s.ge)));
        const int32_t qc = qp[i - 1];
        int32_t pe = DP_WORST, pd = 0, pvl = DP_WORST;
        int8_t* brow = btp + i * wband;
        for (int32_t o = 0; o < wband; o++) {
            const int64_t on = (int64_t)o * n;
            const int64_t j = i + o - lbw;
            if (j >= 1 && o <= bandw && j <= rlen) {
                CellOut c = cell<false>(pv[on], qc, ref_at(rp, rl, j - 1),
                                        pe, pd, pvl, pf[on + n],
                                        pv[on + n], pi[on + n], s);
                pf[on] = c.f;
                pi[on] = c.ii;
                pv[on] = c.v;
                brow[o] = (int8_t)c.bt;
                if (i == qlen && j == rlen) sc = c.v;
                pe = c.pe;
                pd = c.pd;
                pvl = c.v;
            } else {
                const bool bound = j == 0;
                if (bound)
                    brow[o] = (int8_t)(OP_INSERT + (i > 1 ? BT_CF : 0));
                pf[on] = DP_WORST;
                pi[on] = 0;
                pv[on] = bound ? edge_val : DP_WORST;
                pe = DP_WORST;
                pd = 0;
                pvl = bound ? edge_val : DP_WORST;
            }
        }
    }
    score[p] = sc;
}

}  // namespace ytsw

#endif  // YT_SW_KERNELS_CU
