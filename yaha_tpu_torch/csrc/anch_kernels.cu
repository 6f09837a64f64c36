// Anchored gap fill with the band state in registers (sm_90a).
//
// Replaces the two anchored Pallas kernels of yaha_tpu/ops/sw_pallas.py and
// returns the same arrays byte for byte (whole planes, zeros included):
//
//   yt_anch_banded  anchored_forward_pallas_banded (_anch_banded_kernel):
//                   score [N], bt_b [N][QL+1][wband], band-relative
//                   columns o = j - i + lbw
//   yt_anch_full    anchored_forward_pallas (_anch_kernel): score [N],
//                   bt [N][QL+1][RL+1], full-matrix columns
//
// What bounds them on an H100: one thread owns one problem, whose cells are
// one dependent chain of integer compares, selects and adds; the bytes the
// launch must move (q, r and the plane) take a few microseconds.  So the
// time is the longest problem of each warp times the cost of a cell.  The
// first kernels, which ran the bodies anch_banded_problem /
// anch_full_problem of sw_kernels.cu for every problem, also waited on L2
// for every cell (band state in global scratch [3][cols][N]), stored each
// plane byte on its own (neighbouring lanes' planes 2 KB apart: 32
// transactions per warp store), read the reference one byte per cell from
// device memory, stepped over all wband columns of every row, and ran one
// block of 128 problems per SM, leaving 54 of 132 SMs idle at the 1 kb
// batch's banded bucket.  Here, following ext_kernels.cu:
//
//   * Width classes.  Each warp takes the smallest K in {8, 16, 32} that
//     covers every lane's live width (__reduce_max_sync, so the choice is
//     warp-uniform) and keeps K columns of PV, PF and PI in registers; every
//     column step is a template on its column J, expanded by a fold over
//     std::integer_sequence, so every index is a constant.  Columns past the
//     live width change no byte:
//       - banded, live width min(lbw+rbw+1, wband): a column o > lbw+rbw is
//         reset to DP_WORST / DP_WORST / 0 on every row (and in row 0, where
//         j0 = o - lbw > rbw), its bytes are 0, and the column-0 insert
//         boundary sits at o = lbw - i <= lbw; so column K, the first one
//         not kept, is the constant DP_WORST / DP_WORST / 0, and columns
//         live..K-1 are reset on every row;
//       - full, live width min(rlen, RL): an active cell reads its own
//         column and the one to its left, never one to its right, and no
//         cell right of rlen is ever active; column 0 is one register.
//   * Predicates only on rows that need them.  Banded: a row runs without
//     any when every lane has i > lbw and its band reaches column K-1;
//     with the right edge only (o <= min(live-1, rlen-i+lbw)) when every
//     lane has i > lbw; with both edges and the sliding boundary cell
//     otherwise.  Full: without when every lane's window [jlo, jhi] covers
//     columns 1..K, else with it.
//   * Reference codes in registers: banded, a window that slides one code
//     per row, loaded a row ahead; full, the codes of columns 1..K, which
//     every row shares, four to a register.
//   * A row's bytes go to shared memory; every R rows (R = 1408 / K: a
//     1 kb gap bucket's rows in one or two rounds) the warp copies each
//     lane's rows, contiguous in its plane, to device memory together (a
//     word a lane, 128 consecutive bytes a store), with zeros past the
//     staged columns, and after its last row each lane's rows up to QL as
//     zeros.  So the kernel writes every byte of its planes and the
//     wrapper allocates them with torch.empty.
//   * The warp runs its rows in step until its longest problem ends;
//     anchored problems run to qlen, with no early exit.
//   * Blocks of 64 threads (two warps), so that a bucket of 10,000 problems
//     reaches every SM; 32 and 128 timed the same on the H100.
//
// Warps with a lane wider than 32 columns run sw_kernels.cu's bodies, one
// problem a lane, with the state in global scratch [3][cols][N], after
// zeroing their planes.  The route is chosen by shape, warp by warp.
//
// The per-problem bodies (AnchBand<K>, AnchFull<K>, anch_reg_problem) are
// __host__ __device__: without __CUDACC__ they compile with g++, and the CPU
// tests hold them to the plain PyTorch versions.
#include <utility>

#include "sw_cells.cuh"
#include "sw_kernels.cu"

namespace ytsw {

YT_HD int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }
YT_HD int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }

// Bytes a lane stages between copies, and its stride: an odd number of
// words, so that the lanes' byte stores of one column fall in distinct
// banks.  Each copy costs a fixed warp-wide loop over the 32 lanes, so the
// stage holds a 1 kb gap bucket's rows in one or two copies: 44 rows of
// the widest class.  A warp stages 45,184 bytes, five warps an SM.
constexpr int kAnchStageBytes = 1408;
constexpr int kAnchStageStride = (((kAnchStageBytes + 3) / 4) | 1) * 4;
// Threads a block.
constexpr int kAnchBlock = 64;

// The smallest width class covering a live width, 0 above 32.
YT_HD int anch_class(int32_t live) {
    return live <= 8 ? 8 : live <= 16 ? 16 : live <= 32 ? 32 : 0;
}

// Live width of a banded problem: band-relative columns 0..live-1 can
// hold a cell or the insert boundary.
YT_HD int32_t band_live(int32_t lbw, int32_t rbw, int32_t wband) {
    const int64_t w = (int64_t)lbw + rbw + 1;
    return (int32_t)(w < 0 ? 0 : w < wband ? w : wband);
}

// Live width of a full-width problem: columns 1..live can hold a cell.
YT_HD int32_t full_live(int32_t rlen, int64_t rl) {
    return (int32_t)(rlen < 0 ? 0 : rlen < rl ? rlen : rl);
}

struct AnchArgs {
    const uint8_t* q;
    const uint8_t* r;
    const int32_t* qlens;
    const int32_t* rlens;
    const int32_t* lbws;
    const int32_t* rbws;
    int64_t ql, rl;
    int32_t wband;  // banded: plane width; full: unused
    Scoring s;
};

struct AnchCarry {
    int32_t pe, pd, pvl;
};

// One banded problem, K band columns in registers.  row<kMode>(i, out)
// computes row i and writes its K plane bytes to out; kMode 0: no
// predicates, 1: the right edge, 2: both edges and the boundary cell.
template <int K>
struct AnchBand {
    static constexpr int kCols = K;
    static constexpr int SW = K;   // staged bytes per row
    template <int N>
    using Cols = std::make_integer_sequence<int, N>;

    int32_t pv[K], pf[K], pi[K];   // column K: DP_WORST / DP_WORST / 0
    // Reference codes of the row's columns, four a word (byte J % 4 of word
    // J / 4): 24 registers fewer at K = 32, which keeps the widest instance
    // clear of spills, and a row's slide is K/4 byte_perms.
    uint32_t rww[K / 4];
    const uint8_t* qp;
    const uint8_t* rp;
    int32_t ql, rl;
    int32_t qlen, rlen, lbw, rbw, live, last;
    int32_t qc, q_next, r_next;
    int32_t sc;
    bool alive;
    Scoring s;

    YT_HD int32_t ref(int64_t idx) const {
        return (idx >= 0 && idx < rl) ? ld_u8(rp + idx) : 255;
    }

    // Row 0 (j0 = o - lbw): origin at j0 == 0, delete boundary for
    // 1 <= j0 <= min(rbw, rlen), DP_WORST elsewhere and past the live width.
    template <int J>
    YT_HD void init_col(int32_t live_hi, uint8_t* out) {
        const int32_t j0 = J - lbw;
        const bool in = J < live;
        const bool lv = in && j0 >= 1 && j0 <= live_hi;
        pv[J] = (in && j0 == 0) ? 0
                : lv            ? wsub(0, wadd(s.go, wmul(j0, s.ge)))
                                : DP_WORST;
        pf[J] = DP_WORST;
        pi[J] = 0;
        rww[J / 4] = (J % 4 ? rww[J / 4] : 0u) |
                     (uint32_t)ref((int64_t)J - lbw) << (8 * (J % 4));
        out[J] = lv ? (uint8_t)(OP_DELETE + (j0 >= 2 ? BT_CD : 0)) : 0;
    }
    template <int... J>
    YT_HD void init_cols(int32_t live_hi, uint8_t* out,
                         std::integer_sequence<int, J...>) {
        (init_col<J>(live_hi, out), ...);
    }

    // Problem p; `valid` false makes an idle lane (problem 0's inputs are
    // read, nothing is written).  Row 0's bytes go to out.
    YT_HD void init(int64_t p, bool valid, const AnchArgs& a, uint8_t* out) {
        const int64_t pp = valid ? p : 0;
        qp = a.q + pp * a.ql;
        rp = a.r + pp * a.rl;
        ql = (int32_t)a.ql;
        rl = (int32_t)a.rl;
        s = a.s;
        qlen = a.qlens[pp];
        rlen = a.rlens[pp];
        lbw = a.lbws[pp];
        rbw = a.rbws[pp];
        live = band_live(lbw, rbw, a.wband);
        last = imin(qlen, ql);
        alive = valid && last >= 1;
        sc = DP_WORST;
        init_cols(imin(rbw, rlen), out, Cols<K>());
        qc = 0;
        q_next = ql > 0 ? ld_u8(qp) : 0;
        r_next = ref((int64_t)K - lbw);
    }

    // The row mode this lane needs at row i.
    YT_HD int need(int32_t i) const {
        if (!alive) return 0;
        if (i <= lbw) return 2;
        return (live < K || rlen - i + lbw < K - 1) ? 1 : 0;
    }

    template <int kMode, int J>
    YT_HD void cell_col(AnchCarry& c, int32_t lo, int32_t hi, int32_t bcol,
                        int32_t edge_val, int32_t bound_bt, uint8_t* out) {
        int32_t upf = DP_WORST, upv = DP_WORST, upi = 0;
        if constexpr (J + 1 < K) {
            upf = pf[J + 1];
            upv = pv[J + 1];
            upi = pi[J + 1];
        }
        const int32_t rch =
            (int32_t)byte_perm(rww[J / 4], 0, 0x4440u + J % 4);
        const CellOut o = cell<false>(pv[J], qc, rch, c.pe, c.pd, c.pvl,
                                      upf, upv, upi, s);
        if constexpr (kMode == 0) {
            pf[J] = o.f;
            pi[J] = o.ii;
            pv[J] = o.v;
            c = {o.pe, o.pd, o.v};
            out[J] = (uint8_t)o.bt;
        } else {
            // Outside [lo, hi] the scratch body resets the cell (the carry
            // past hi is never read again; before lo it is set at the
            // boundary cell).
            const bool act = (kMode == 1 || J >= lo) && J <= hi;
            const bool bound = kMode == 2 && J == bcol;
            int32_t b = 0;
            if (act) {
                pf[J] = o.f;
                pi[J] = o.ii;
                pv[J] = o.v;
                c = {o.pe, o.pd, o.v};
                b = o.bt;
            } else {
                pf[J] = DP_WORST;
                pi[J] = 0;
                pv[J] = bound ? edge_val : DP_WORST;
                if (bound) {
                    c = {DP_WORST, 0, edge_val};
                    b = bound_bt;
                }
            }
            out[J] = (uint8_t)b;
        }
    }
    template <int kMode, int... J>
    YT_HD void cells(AnchCarry& c, int32_t lo, int32_t hi, int32_t bcol,
                     int32_t edge_val, int32_t bound_bt, uint8_t* out,
                     std::integer_sequence<int, J...>) {
        (cell_col<kMode, J>(c, lo, hi, bcol, edge_val, bound_bt, out), ...);
    }

    // The next row's window: every code one column left, r_next in last
    // (words in ascending order, each taking the next one's first code).
    template <int W>
    YT_HD uint32_t next_word() const {
        if constexpr (W + 1 < K / 4)
            return rww[W + 1];
        else
            return (uint32_t)r_next;
    }
    template <int... W>
    YT_HD void shift_words(std::integer_sequence<int, W...>) {
        ((rww[W] = byte_perm(rww[W], next_word<W>(), 0x4321u)), ...);
    }

    // The score: the cell (qlen, rlen) at o = rlen - qlen + lbw, if active.
    template <int... J>
    YT_HD void capture(int32_t o, std::integer_sequence<int, J...>) {
        ((J == o ? (void)(sc = pv[J]) : (void)0), ...);
    }

    template <int kMode>
    YT_HD void row(int32_t i, uint8_t* out) {
        qc = q_next;
        q_next = i < ql ? ld_u8(qp + i) : 0;
        const int32_t edge_val = wsub(0, wadd(s.go, wmul(i, s.ge)));
        const int32_t lo = imax(0, lbw - i + 1);
        const int32_t hi = imin(live - 1, rlen - i + lbw);
        const int32_t bcol = lbw - i >= 0 && lbw - i < live ? lbw - i : -1;
        AnchCarry c = {DP_WORST, 0, DP_WORST};
        cells<kMode>(c, lo, hi, bcol, edge_val,
                     OP_INSERT + (i > 1 ? BT_CF : 0), out, Cols<K>());
        shift_words(Cols<K / 4>());
        r_next = ref((int64_t)i + K - lbw);
        if (alive) {
            const int32_t o = rlen - i + lbw;
            if (i == qlen && o >= lo && o <= hi) capture(o, Cols<K>());
            if (i >= last) alive = false;
        }
    }
};

template <int K>
struct AnchFull {
    static constexpr int kCols = K;
    static constexpr int SW = K + 1;
    template <int N>
    using Cols = std::make_integer_sequence<int, N>;

    int32_t pv[K], pf[K], pi[K];   // column j = J + 1
    // r[j - 1], the same in every row, four codes a word (byte J % 4 of
    // word J / 4): 24 registers fewer at K = 32, which keeps the widest
    // instance clear of spills.
    uint32_t rcw[K / 4];
    int32_t pv0;
    const uint8_t* qp;
    int32_t ql;
    int32_t qlen, rlen, lbw, rbw, live, last;
    int32_t qc, q_next;
    int32_t sc;
    bool alive;
    Scoring s;

    // Row 0: origin, then the delete boundary for j in [1, min(rbw, rlen)].
    template <int J>
    YT_HD void init_col(int32_t live_hi, const uint8_t* rp, int64_t rl,
                        uint8_t* out) {
        const int32_t j = J + 1;
        const bool lv = j <= live_hi;
        pv[J] = lv ? wsub(0, wadd(s.go, wmul(j, s.ge))) : DP_WORST;
        pf[J] = DP_WORST;
        pi[J] = 0;
        const uint32_t code = J < rl ? (uint32_t)ld_u8(rp + J) : 255u;
        rcw[J / 4] = (J % 4 ? rcw[J / 4] : 0u) | code << (8 * (J % 4));
        out[j] = lv ? (uint8_t)(OP_DELETE + (j >= 2 ? BT_CD : 0)) : 0;
    }
    template <int... J>
    YT_HD void init_cols(int32_t live_hi, const uint8_t* rp, int64_t rl,
                         uint8_t* out, std::integer_sequence<int, J...>) {
        (init_col<J>(live_hi, rp, rl, out), ...);
    }

    YT_HD void init(int64_t p, bool valid, const AnchArgs& a, uint8_t* out) {
        const int64_t pp = valid ? p : 0;
        qp = a.q + pp * a.ql;
        ql = (int32_t)a.ql;
        s = a.s;
        qlen = a.qlens[pp];
        rlen = a.rlens[pp];
        lbw = a.lbws[pp];
        rbw = a.rbws[pp];
        live = full_live(rlen, a.rl);
        last = imin(qlen, ql);
        alive = valid && last >= 1;
        sc = DP_WORST;
        pv0 = 0;
        out[0] = 0;
        init_cols(imin(rbw, rlen), a.r + pp * a.rl, a.rl, out, Cols<K>());
        qc = 0;
        q_next = ql > 0 ? ld_u8(qp) : 0;
    }

    // The row's window [jlo, jhi] of active columns.
    YT_HD int32_t jlo(int32_t i) const { return imax(1, i - lbw); }
    YT_HD int32_t jhi(int32_t i) const {
        const int64_t h = (int64_t)i + rbw;
        return (int32_t)(h < live ? h : live);
    }

    YT_HD int need(int32_t i) const {
        return alive && (jlo(i) > 1 || jhi(i) < K) ? 1 : 0;
    }

    // Cell (i, J+1); out of the window the state is kept and the byte is 0.
    // The diagonal predecessor d is the old PV of the column to the left.
    template <bool kPred, int J>
    YT_HD void cell_col(AnchCarry& c, int32_t& d, int32_t lo, int32_t hi,
                        uint8_t* out) {
        const int32_t old = pv[J];
        const int32_t rch =
            (int32_t)byte_perm(rcw[J / 4], 0, 0x4440u + J % 4);
        const CellOut o = cell<false>(d, qc, rch, c.pe, c.pd, c.pvl, pf[J],
                                      old, pi[J], s);
        const bool act = !kPred || (J + 1 >= lo && J + 1 <= hi);
        int32_t b = 0;
        if (act) {
            pf[J] = o.f;
            pi[J] = o.ii;
            pv[J] = o.v;
            c = {o.pe, o.pd, o.v};
            b = o.bt;
        }
        out[J + 1] = (uint8_t)b;
        d = old;
    }
    template <bool kPred, int... J>
    YT_HD void cells(AnchCarry& c, int32_t& d, int32_t lo, int32_t hi,
                     uint8_t* out, std::integer_sequence<int, J...>) {
        (cell_col<kPred, J>(c, d, lo, hi, out), ...);
    }

    template <int... J>
    YT_HD void capture(int32_t j, std::integer_sequence<int, J...>) {
        ((J + 1 == j ? (void)(sc = pv[J]) : (void)0), ...);
    }

    template <int kMode>
    YT_HD void row(int32_t i, uint8_t* out) {
        qc = q_next;
        q_next = i < ql ? ld_u8(qp + i) : 0;
        const int32_t edge_val = wsub(0, wadd(s.go, wmul(i, s.ge)));
        const bool col0 = i <= lbw;
        // Column-0 insert boundary; its chain runs straight up.
        int32_t d = pv0;
        if (col0) pv0 = edge_val;
        out[0] = col0 ? (uint8_t)(OP_INSERT + (i > 1 ? BT_CF : 0)) : 0;
        const int32_t lo = jlo(i), hi = jhi(i);
        AnchCarry c = {DP_WORST, 0, col0 ? edge_val : DP_WORST};
        cells<kMode != 0>(c, d, lo, hi, out, Cols<K>());
        if (alive) {
            if (i == qlen && rlen >= lo && rlen <= hi)
                capture(rlen, Cols<K>());
            if (i >= last) alive = false;
        }
    }
};

template <class B>
YT_HD void anch_row(B& st, int mode, int32_t i, uint8_t* out) {
    if (mode == 0)
        st.template row<0>(i, out);
    else if (mode == 1)
        st.template row<1>(i, out);
    else
        st.template row<2>(i, out);
}

// Rows [0, nr) of w plane units from the stage (sw units a row, zeros past
// them).  The lanes of a team of `lanes` write consecutive units.
template <typename U>
YT_HD void anch_copy_units(U* dst, const U* src, int32_t sw, int32_t w,
                           int32_t nr, int32_t lane, int32_t lanes) {
    const int32_t cw = sw < w ? sw : w;
    int32_t r = 0, c = lane, step_r = 0, step_c = lanes;
    while (c >= w) {
        c -= w;
        r++;
    }
    while (step_c >= w) {
        step_c -= w;
        step_r++;
    }
    const int32_t len = nr * w;
    for (int32_t b = lane; b < len; b += lanes) {
        dst[b] = c < cw ? src[r * sw + c] : (U)0;
        r += step_r;
        c += step_c;
        if (c >= w) {
            c -= w;
            r++;
        }
    }
}

// len bytes from src to dst, the team's lanes together: single bytes up to
// dst's first 4-byte boundary and after its last, whole words between,
// each built from the two aligned source words that hold its bytes
// (byte_perm), so that src and dst may differ in alignment.
YT_HD void anch_copy_bytes(uint8_t* dst, const uint8_t* src, int32_t len,
                           int32_t lane, int32_t lanes) {
    int32_t head = (int32_t)((4 - ((uintptr_t)dst & 3)) & 3);
    if (head > len) head = len;
    for (int32_t b = lane; b < head; b += lanes) dst[b] = src[b];
    const int32_t nw = (len - head) / 4;
    const uint32_t sh = (uint32_t)((uintptr_t)(src + head) & 3);
    const uint32_t* sw = (const uint32_t*)(src + head - sh);
    uint32_t* dw = (uint32_t*)(dst + head);
    const uint32_t sel = sh | (sh + 1) << 4 | (sh + 2) << 8 | (sh + 3) << 12;
    for (int32_t k = lane; k < nw; k += lanes)
        dw[k] = sh ? byte_perm(sw[k], sw[k + 1], sel) : sw[k];
    for (int32_t b = head + 4 * nw + lane; b < len; b += lanes)
        dst[b] = src[b];
}

// len zero bytes at dst, four at a time between the unaligned ends (N:
// int32_t for a lane's rows, int64_t for a warp's planes).
template <typename N>
YT_HD void anch_zero(uint8_t* dst, N len, int32_t lane, int32_t lanes) {
    N head = (N)((4 - ((uintptr_t)dst & 3)) & 3);
    if (head > len) head = len;
    for (N b = lane; b < head; b += lanes) dst[b] = 0;
    const N nw = (len - head) / 4;
    uint32_t* dw = (uint32_t*)(dst + head);
    for (N k = lane; k < nw; k += lanes) dw[k] = 0;
    for (N b = head + 4 * nw + lane; b < len; b += lanes) dst[b] = 0;
}

// Rows [0, nr) of a lane's plane (w bytes a row): rows below vrows from its
// stage (sw bytes a row, zeros past them), the rest zeros.  Where the
// stage's rows are as wide as the plane's, the valid rows are one
// contiguous copy; else rows go four bytes at a time where both rows and
// both ends allow.
YT_HD void anch_copy_rows(uint8_t* dst, const uint8_t* src, int32_t sw,
                          int32_t w, int32_t nr, int32_t vrows, int32_t lane,
                          int32_t lanes) {
    if (sw == w)
        anch_copy_bytes(dst, src, vrows * w, lane, lanes);
    else if (((w | sw) & 3) == 0 &&
             (((uintptr_t)dst | (uintptr_t)src) & 3) == 0)
        anch_copy_units((uint32_t*)dst, (const uint32_t*)src, sw / 4, w / 4,
                        vrows, lane, lanes);
    else
        anch_copy_units(dst, src, sw, w, vrows, lane, lanes);
    anch_zero(dst + vrows * w, (nr - vrows) * w, lane, lanes);
}

// Problem p on its own (the host build's loop; the card runs the warp-wide
// loop of anch_reg_kernel).  The whole plane is written.  `mode` raises
// every row to at least that mode, as a lane runs when another lane of its
// warp needs it.  Returns false if the class K is narrower than the
// problem's live width.
template <class B>
YT_HD bool anch_reg_problem(int64_t p, const AnchArgs& a, int64_t w,
                            int mode, int8_t* bt, int32_t* score) {
    B st;
    // The row starts p % 4 bytes past a word, as a lane's staged rows may.
    alignas(4) uint8_t buf[B::SW + 3];
    uint8_t* row = buf + p % 4;
    st.init(p, true, a, row);
    if (anch_class(st.live) == 0 || anch_class(st.live) > B::kCols)
        return false;
    uint8_t* btp = (uint8_t*)bt + p * (a.ql + 1) * w;
    anch_copy_rows(btp, row, B::SW, (int32_t)w, 1, 1, 0, 1);
    int32_t i = 1;
    for (; st.alive; i++) {
        const int need = st.need(i);
        anch_row(st, need > mode ? need : mode, i, row);
        anch_copy_rows(btp + i * w, row, B::SW, (int32_t)w, 1, 1, 0, 1);
    }
    anch_zero(btp + i * w, (int32_t)((a.ql + 1 - i) * w), 0, 1);
    score[p] = st.sc;
    return true;
}

}  // namespace ytsw

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// A register-class warp: rows in step, staged, copied out lane by lane.
template <class B>
__device__ void reg_warp(const ytsw::AnchArgs& a, int64_t p, bool valid,
                         int lane, uint8_t* warp_stage, int64_t w,
                         int8_t* bt, int32_t* score) {
    constexpr int SW = B::SW;
    constexpr int kRows = ytsw::kAnchStageBytes / SW;
    constexpr int kStride = ytsw::kAnchStageStride;
    uint8_t* mine = warp_stage + lane * kStride;
    B st;
    st.init(p, valid, a, mine);
    int32_t i0 = 0, nr = 1;   // row 0 is staged
    bool more = __any_sync(kFull, st.alive);
    for (;;) {
        while (more && nr < kRows) {
            const int32_t i = i0 + nr;
            const int mode = __reduce_max_sync(kFull, st.need(i));
            ytsw::anch_row(st, mode, i, mine + nr * SW);
            nr++;
            more = __any_sync(kFull, st.alive);
        }
        // Rows i0 .. i0+nr-1 of every valid lane, lane t's contiguous in
        // its plane, the lanes writing consecutive words; after the warp's
        // last row, every lane's rows up to QL (zeros past its last).
        const int32_t rows = more ? nr : (int32_t)a.ql + 1 - i0;
        int32_t vrows = (st.last > 0 ? st.last : 0) - i0 + 1;
        vrows = !valid ? -1 : vrows < 0 ? 0 : vrows > nr ? nr : vrows;
        uint8_t* dst = (uint8_t*)bt + ((p - lane) * (a.ql + 1) + i0) * w;
        __syncwarp();
        for (int t = 0; t < 32; t++, dst += (a.ql + 1) * w) {
            const int32_t vr = __shfl_sync(kFull, vrows, t);
            if (vr >= 0)
                ytsw::anch_copy_rows(dst, warp_stage + t * kStride, SW,
                                     (int32_t)w, rows, vr, lane, 32);
        }
        __syncwarp();
        i0 += nr;
        nr = 0;
        if (!more) break;
    }
    if (valid) score[p] = st.sc;
}

template <bool kFullLayout>
__global__ void __launch_bounds__(ytsw::kAnchBlock)
anch_reg_kernel(ytsw::AnchArgs a, int64_t n, int8_t* bt, int32_t* score,
                int32_t* scratch) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int lane = threadIdx.x & 31;
    uint8_t* wsm = smem + (threadIdx.x >> 5) * (32 * ytsw::kAnchStageStride);
    const int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    const bool valid = p < n;
    const int64_t w = kFullLayout ? a.rl + 1 : a.wband;
    int32_t live = 0;
    if (valid)
        live = kFullLayout ? ytsw::full_live(a.rlens[p], a.rl)
                           : ytsw::band_live(a.lbws[p], a.rbws[p], a.wband);
    const int k = ytsw::anch_class(__reduce_max_sync(kFull, live));
#define YT_ANCH_K(kk)                                                        \
    if (k == kk) {                                                           \
        if constexpr (kFullLayout)                                           \
            reg_warp<ytsw::AnchFull<kk>>(a, p, valid, lane, wsm, w, bt,      \
                                         score);                             \
        else                                                                 \
            reg_warp<ytsw::AnchBand<kk>>(a, p, valid, lane, wsm, w, bt,      \
                                         score);                             \
        return;                                                              \
    }
    YT_ANCH_K(8)
    YT_ANCH_K(16)
    YT_ANCH_K(32)
#undef YT_ANCH_K
    // A wide warp: sw_kernels.cu's body, one problem a lane, on zeroed
    // planes, the state in global scratch.
    const int64_t p0 = p - lane;
    const int64_t cnt = n - p0 < 32 ? n - p0 : 32;
    ytsw::anch_zero((uint8_t*)bt + p0 * (a.ql + 1) * w,
                    cnt * (a.ql + 1) * w, lane, 32);
    __syncwarp();
    if (!valid) return;
    if constexpr (kFullLayout)
        ytsw::anch_full_problem(p, n, a.q, a.ql, a.r, a.rl, a.qlens, a.rlens,
                                a.lbws, a.rbws, a.s, bt, score, scratch);
    else
        ytsw::anch_banded_problem(p, n, a.q, a.ql, a.r, a.rl, a.qlens,
                                  a.rlens, a.lbws, a.rbws, a.wband, a.s, bt,
                                  score, scratch);
}

// wide: a lane may be wider than 32 columns, and then scratch must be
// given.  Each warp stages its rows in its own part of shared memory.
template <bool kFullLayout>
int launch(const ytsw::AnchArgs& a, int64_t n, bool wide, int8_t* bt,
           int32_t* score, int32_t* scratch, cudaStream_t stream) {
    if (wide && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)ytsw::kAnchBlock * ytsw::kAnchStageStride;
    const cudaError_t e = cudaFuncSetAttribute(
        anch_reg_kernel<kFullLayout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int64_t grid = (n + ytsw::kAnchBlock - 1) / ytsw::kAnchBlock;
    anch_reg_kernel<kFullLayout>
        <<<(unsigned)grid, ytsw::kAnchBlock, smem, stream>>>(a, n, bt, score,
                                                            scratch);
    return (int)cudaGetLastError();
}

ytsw::AnchArgs args(const uint8_t* q, const uint8_t* r, const int32_t* qlens,
                    const int32_t* rlens, const int32_t* lbws,
                    const int32_t* rbws, int64_t ql, int64_t rl,
                    int32_t wband, int32_t go, int32_t ge, int32_t rc,
                    int32_t ms, int32_t max_gap, int32_t max_intron) {
    ytsw::AnchArgs a;
    a.q = q;
    a.r = r;
    a.qlens = qlens;
    a.rlens = rlens;
    a.lbws = lbws;
    a.rbws = rbws;
    a.ql = ql;
    a.rl = rl;
    a.wband = wband;
    a.s.go = go;
    a.s.ge = ge;
    a.s.rc = rc;
    a.s.ms = ms;
    a.s.max_gap = max_gap;
    a.s.max_intron = max_intron;
    return a;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each launches on the given
// stream, allocates nothing and does not synchronise; it returns
// cudaGetLastError(), or cudaErrorInvalidValue for a missing scratch.
// `scratch` ([3][cols][N] int32, cols = wband + 1 or RL + 2) is read only
// by a warp wider than 32 columns; it may be null where none can be
// (wband <= 32, RL <= 32).
extern "C" {

int yt_anch_banded(const uint8_t* q, const uint8_t* r, const int32_t* qlens,
                   const int32_t* rlens, const int32_t* lbws,
                   const int32_t* rbws, int64_t n, int64_t ql, int64_t rl,
                   int32_t wband, int32_t go, int32_t ge, int32_t rc,
                   int32_t ms, int32_t max_gap, int32_t max_intron,
                   int8_t* bt, int32_t* score, int32_t* scratch,
                   void* stream) {
    return launch<false>(
        args(q, r, qlens, rlens, lbws, rbws, ql, rl, wband, go, ge, rc, ms,
             max_gap, max_intron),
        n, wband > 32, bt, score, scratch, (cudaStream_t)stream);
}

int yt_anch_full(const uint8_t* q, const uint8_t* r, const int32_t* qlens,
                 const int32_t* rlens, const int32_t* lbws,
                 const int32_t* rbws, int64_t n, int64_t ql, int64_t rl,
                 int32_t go, int32_t ge, int32_t rc, int32_t ms,
                 int32_t max_gap, int32_t max_intron, int8_t* bt,
                 int32_t* score, int32_t* scratch, void* stream) {
    return launch<true>(
        args(q, r, qlens, rlens, lbws, rbws, ql, rl, 0, go, ge, rc, ms,
             max_gap, max_intron),
        n, rl > 32, bt, score, scratch, (cudaStream_t)stream);
}

}  // extern "C"

#endif  // __CUDACC__
