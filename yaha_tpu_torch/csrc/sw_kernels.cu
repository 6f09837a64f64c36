// Hopper (sm_90a) kernels for the staged aligner's batched DP phases.
//
// Each kernel replaces one Pallas TPU kernel of yaha_tpu/ops/sw_pallas.py
// and returns the same arrays byte for byte:
//
//   yt_ext_forward       extension_forward_pallas (_ext_kernel,
//                        _ext_kernel_win -> _ext_body): banded X-drop
//                        forward extension, phase B, for bands wider than
//                        -BW 8 (ext_kernels.cu keeps narrower bands in
//                        registers)
//
// and holds the two anchored gap-fill bodies, anch_banded_problem and
// anch_full_problem, which anch_kernels.cu runs for its warps wider than
// 32 columns (its own kernels keep narrower bands in registers).
//
// Layout.  One thread owns one problem (grid-stride loop over N); it walks
// the query rows and, inside a row, the band columns in order, like the
// reference inner loop.  This takes the place of the TPU's 8x128 problem
// lanes and its sequential grid over rows.  The previous row's
// PV/PF/PI state lives in global scratch laid out [3][cols][N], problem-
// minor, so that a warp's 32 problems touch 32 consecutive words and the
// accesses coalesce for any band width.  Backtrack planes are
// problem-major [N][QL+1][W] int8, exactly the JAX layout, because the
// native walkers read them with a plane stride and a row stride.  The
// caller zero-fills them: OP_UNKNOWN is 0, and every cell the Pallas
// kernels write as "fill" is 0 apart from the extension's anti-diagonal
// insert cells of rows 1..bw2, which are written here up front.  So a
// thread stops at its own X-drop exit (or its last query row) and the
// plane still equals the Pallas plane.
//
// The reference reads replace the Pallas entries' padding passes with
// index arithmetic: out-of-range positions read 255, a guaranteed
// mismatch (codes are 0-14).
//
// What bounds these kernels on the card: the column recurrence is
// sequential within a problem, so time per cell is one dependent chain
// of ~20 integer ops plus a scratch load/store round trip; and the bt
// stores are strided by the plane size between the threads of a warp,
// so each byte store is its own memory transaction.  ext_kernels.cu
// shows the repair for the extension: band state in registers with the
// width as a template constant, plane rows staged in shared memory.
#ifndef YT_SW_KERNELS_CU
#define YT_SW_KERNELS_CU

#include "sw_cells.cuh"

namespace ytsw {

// Scratch slot k (0 = PV, 1 = PF, 2 = PI) of column j for problem p.
YT_HD int64_t sidx(int k, int64_t j, int64_t cols, int64_t n, int64_t p) {
    return ((int64_t)k * cols + j) * n + p;
}

// Banded X-drop extension of problem p (sw_pallas._ext_body).  W = 2*bw2+1
// band columns; scratch has W+2 columns (index W is the band-edge
// sentinel).  The reference row is read at s - bw2 for the padded index
// s = i - 1 + j.
YT_HD void ext_problem(int64_t p, int64_t n, const uint8_t* q, int64_t ql,
                       const uint8_t* r, int64_t rl, const int32_t* qlens,
                       const int32_t* rlens, int32_t bw2, Scoring s,
                       int32_t x_cutoff, int8_t* bt, int32_t* score,
                       int32_t* maxi, int32_t* maxj, int32_t* scr) {
    const int32_t w = 2 * bw2 + 1;
    const int64_t cols = w + 2;
    int32_t* pv = scr + sidx(0, 0, cols, n, p);
    int32_t* pf = scr + sidx(1, 0, cols, n, p);
    int32_t* pi = scr + sidx(2, 0, cols, n, p);
    int8_t* btp = bt + p * (ql + 1) * w;
    const uint8_t* qp = q + p * ql;
    const uint8_t* rp = r + p * rl;
    const int32_t qlen = qlens[p];
    const int32_t rlen = rlens[p];

    // Row 0 (SW.cpp:899-933) and the band-edge sentinel at index w.
    for (int32_t j = 0; j <= w; j++) {
        int32_t v = DP_WORST, f = DP_WORST;
        if (j == bw2) {
            v = 0;
            f = 0;
        } else if (j > bw2 && j < w) {
            v = wsub(0, wadd(s.go, wmul(j - bw2, s.ge)));
            btp[j] = (int8_t)(OP_DELETE + (j - bw2 >= 2 ? BT_CD : 0));
        }
        pv[j * n] = v;
        pf[j * n] = f;
        pi[j * n] = 0;
    }
    // Anti-diagonal insert init cells (i, bw2 - i): below startCol, so
    // never computed, but written on every row of the plane.
    for (int32_t i = 1; i <= bw2 && i <= ql; i++)
        btp[(int64_t)i * w + (bw2 - i)] =
            (int8_t)(OP_INSERT + (i > 1 ? BT_CF : 0));

    int32_t max_score = DP_WORST, mi = 0, mj = 0;
    const int64_t last = qlen < ql ? qlen : ql;
    for (int32_t i = 1; i <= last; i++) {
        const int32_t start_col = bw2 + 1 - i > 0 ? bw2 + 1 - i : 0;
        const int32_t end_col =
            bw2 + rlen - i < w - 1 ? bw2 + rlen - i : w - 1;
        const bool edge = i <= bw2;
        const int32_t edge_val = wsub(0, wadd(s.go, wmul(i, s.ge)));
        if (edge) pv[(int64_t)(bw2 - i) * n] = edge_val;
        const int32_t qc = qp[i - 1];
        int32_t pe = DP_WORST, pd = 0, pvl = edge ? edge_val : DP_WORST;
        int32_t row_max = DP_WORST, best_v = DP_WORST, best_j = 0;
        int8_t* brow = btp + (int64_t)i * w;
        for (int32_t j = start_col; j <= end_col; j++) {
            const int64_t jn = (int64_t)j * n;
            CellOut c = cell<true>(
                pv[jn], qc, ref_at(rp, rl, (int64_t)i - 1 + j - bw2), pe,
                pd, pvl, pf[jn + n], pv[jn + n], pi[jn + n], s);
            pf[jn] = c.f;
            pi[jn] = c.ii;
            pv[jn] = c.v;
            brow[j] = (int8_t)c.bt;
            if (c.v > row_max) row_max = c.v;
            if (c.v > best_v) {
                best_v = c.v;
                best_j = j;
            }
            pe = c.pe;
            pd = c.pd;
            pvl = c.v;
        }
        if (best_v > max_score) {
            max_score = best_v;
            mi = i;
            mj = best_j;
        }
        if (row_max < wsub(max_score, x_cutoff)) break;
    }
    score[p] = max_score;
    maxi[p] = mi;
    maxj[p] = mj;
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

// anch_kernels.cu includes this file for the two anchored bodies alone.
#if defined(__CUDACC__) && !defined(YT_SW_BODIES_ONLY)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

int grid_for(int64_t n) {
    int64_t b = (n + kThreads - 1) / kThreads;
    return (int)(b < 65535 ? b : 65535);
}

__global__ void ext_kernel(int64_t n, const uint8_t* q, int64_t ql,
                           const uint8_t* r, int64_t rl,
                           const int32_t* qlens, const int32_t* rlens,
                           int32_t bw2, ytsw::Scoring s, int32_t x_cutoff,
                           int8_t* bt, int32_t* score, int32_t* maxi,
                           int32_t* maxj, int32_t* scr) {
    for (int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; p < n;
         p += (int64_t)gridDim.x * blockDim.x)
        ytsw::ext_problem(p, n, q, ql, r, rl, qlens, rlens, bw2, s,
                          x_cutoff, bt, score, maxi, maxj, scr);
}

ytsw::Scoring scoring(int32_t go, int32_t ge, int32_t rc, int32_t ms,
                      int32_t max_gap, int32_t max_intron) {
    ytsw::Scoring s;
    s.go = go;
    s.ge = ge;
    s.rc = rc;
    s.ms = ms;
    s.max_gap = max_gap;
    s.max_intron = max_intron;
    return s;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every function launches on the
// given stream, allocates nothing and does not synchronise; it returns
// cudaGetLastError() so that a refused launch is reported at once.
extern "C" {

int yt_ext_forward(const uint8_t* q, const uint8_t* r, const int32_t* qlens,
                   const int32_t* rlens, int64_t n, int64_t ql, int64_t rl,
                   int32_t bw2, int32_t go, int32_t ge, int32_t rc,
                   int32_t ms, int32_t max_gap, int32_t max_intron,
                   int32_t x_cutoff, int8_t* bt, int32_t* score,
                   int32_t* maxi, int32_t* maxj, int32_t* scratch,
                   void* stream) {
    ext_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        n, q, ql, r, rl, qlens, rlens, bw2,
        scoring(go, ge, rc, ms, max_gap, max_intron), x_cutoff, bt, score,
        maxi, maxj, scratch);
    return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__

#endif  // YT_SW_KERNELS_CU
