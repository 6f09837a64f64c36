// Anchored gap fill on Hopper (sm_90a): band state in registers, and a
// warp per problem for the bands wider than 32 columns.
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
// Each entry launches two kernels on its stream, both over the whole
// bucket: anch_reg_kernel, which takes the warps of 32 consecutive
// problems whose lanes are all at most 32 columns wide, and, when the
// plane is wider than 32 columns (wband > 32, RL > 32), anch_wide_kernel,
// which takes the other warps' problems, a warp each.  A problem's route
// is its warp's, by shape (band_live / full_live): the narrow lanes of a
// wide warp go to the wide route too.
//
// What bounds them on an H100: a problem's cells are one dependent chain
// of integer compares, selects and adds a row (the delete run's cap makes
// the horizontal carry a recurrence that is not a scan); the bytes the
// launch must move (q, r and the plane) take a few microseconds.
//
// anch_reg_kernel, one thread a problem (following ext_kernels.cu):
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
//     A warp with a lane wider than 32 columns leaves at once.
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
//     zeros.
//   * The warp runs its rows in step until its longest problem ends;
//     anchored problems run to qlen, with no early exit.
//   * Blocks of 64 threads (two warps), so that a bucket of 10,000 problems
//     reaches every SM; 32 and 128 timed the same on the H100.
//
// anch_wide_kernel, a warp per problem on a row wavefront (the design of
// ext_wide_kernels.cu, whose strip staging, shared row and 16-byte copy it
// shares through wavefront.cuh).  The first kernels ran the port's first
// bodies here, one thread a problem with the band state in global scratch
// [3][cols][N]: a load/store round trip on every cell's chain, plane bytes
// stored one at a time a plane apart between lanes, and a warp as slow as
// its widest lane's rows times columns.  Here lane k computes the rows
// 32 s + k + 1 of strip s and reaches column c of its row at step s P +
// 2 k + c, with P = max(live + 1, 64) and c in [0, ncols):
//
//   * banded (ncols = live): cell (i, o) reads the row above at o + 1
//     ("up") and o ("diag"), which lane k - 1 handed down one and two
//     steps earlier; lane 0 reads them from the shared row, whose column
//     live is the band-edge sentinel DP_WORST / DP_WORST / 0.  A cell
//     outside j >= 1, j <= rlen (j = i + o - lbw) resets to DP_WORST /
//     DP_WORST / 0 and ends the horizontal carry, except the column-0
//     insert boundary at o = lbw - i;
//   * full (ncols = live + 1, column 0 included): cell (i, j) reads (i-1,
//     j) and (i-1, j-1), which lane k - 1 handed down two and three steps
//     earlier (a lane offset of one step would put the lanes' byte stores
//     into the staged rows, RL apart for a power-of-two RL, in one or two
//     banks); a cell outside [max(1, i - lbw), min(i + rbw, live)] keeps
//     the row above's state and writes 0; column 0 takes the insert
//     boundary for i <= lbw and otherwise keeps its state;
//   * a lane's state is O(1) registers whatever the width; the codes of
//     strip s + 2 are staged in shared memory when strip s is copied out
//     (query codes, and banded the reference window 32 s - lbw .. that the
//     strip's rows read; full the reference row, which every row shares);
//   * each strip's rows are staged as bytes (the stages zeroed first, so
//     the columns past ncols read 0) and copied out, contiguous in the
//     problem's plane, as 16-byte stores once the strip's last row (lane
//     31's, or the problem's last) is done; row 0 and the rows past
//     min(qlen, QL) are written by the same copy from a generator.  The
//     kernel writes every byte of its planes, so the wrapper allocates
//     them with torch.empty.  The score is the cell (qlen, rlen), taken
//     from the lane that computed it (a ballot).
//
// The wide route is launched over every problem of a plane wider than 32
// columns, kAnchWideWarps warps a block (fewer when a warp's shared memory,
// wide_warp_bytes of the plane width, would not fit four times): each warp
// reads its 32-problem group's live widths and leaves at once unless one
// is over 32 columns.  Its cost on a bucket without a wide warp is that
// launch, N / 4 blocks that read 32 lengths a warp and leave; the register
// kernel's wide warps, likewise, leave after their class test.  A plane
// whose warp would need more shared memory than a block has (wband or
// RL + 1 above 2,829 bytes) is refused with cudaErrorInvalidValue before
// either launch.
//
// The per-problem bodies (AnchBand<K>, AnchFull<K>, anch_reg_problem) and
// the wide route's lane step and schedule (AnchWideProblem, AnchWideLane,
// AnchWideSched) are __host__ __device__: without __CUDACC__ they compile
// with g++, and the CPU tests hold them, the wide route over an emulated
// 32-lane warp, to the plain PyTorch versions.
#include <utility>

#include "wavefront.cuh"

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
            // Outside [lo, hi] the plain version resets the cell (the carry
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

// ---- The wide route: a warp per problem on a row wavefront ----

// Warps a block of anch_wide_kernel, at most.
constexpr int kAnchWideWarps = 4;

// One problem of the wide route, layout kFullLayout (false: band-relative
// columns o, plane rows of wband bytes; true: columns 0..RL, rows of RL + 1).
template <bool kFullLayout>
struct AnchWideProblem {
    const uint8_t* qp;
    const uint8_t* rp;
    int64_t ql, rl;
    int32_t qlen, rlen, lbw, rbw, live, last;
    int32_t w;       // plane row bytes
    int32_t ncols;   // columns a row steps over: banded live, full live + 1
    int32_t period;  // steps between a lane's two strips
    int32_t base;    // row 0's origin column: banded lbw, full 0
    int32_t hi0;     // row 0's delete boundary ends at base + hi0
    Scoring s;

    YT_HD void init(int64_t p, const AnchArgs& a) {
        qp = a.q + p * a.ql;
        rp = a.r + p * a.rl;
        ql = a.ql;
        rl = a.rl;
        s = a.s;
        qlen = a.qlens[p];
        rlen = a.rlens[p];
        lbw = a.lbws[p];
        rbw = a.rbws[p];
        w = (int32_t)(kFullLayout ? a.rl + 1 : a.wband);
        live = kFullLayout ? full_live(rlen, a.rl)
                           : band_live(lbw, rbw, a.wband);
        last = imin(qlen, (int32_t)a.ql);
        ncols = kFullLayout ? live + 1 : live;
        period = imax(live + 1, 2 * kWideLanes);
        base = kFullLayout ? 0 : lbw;
        hi0 = imin(rbw, rlen);
    }

    // Strip `strip`'s codes: its rows' query codes, then the reference
    // codes its cells read: banded r[32 strip - lbw ..] (lane k, column o
    // reads index k + o), full r[0 ..] (column j reads index j - 1).
    YT_HD void stage_codes(int lane, int32_t strip, uint8_t* codes) const {
        const int64_t i0 = (int64_t)strip * kWideLanes;
        stage_strip_codes(lane, i0, qp, ql, rp, rl, kFullLayout ? 0 : i0 - lbw,
                          ncols + kWideLanes - 1, codes);
    }

    // Row 0's state at column c (j0 = c - base): the origin at j0 = 0, the
    // delete boundary for 1 <= j0 <= min(rbw, rlen), DP_WORST elsewhere
    // and at c = ncols (banded: the band-edge sentinel).
    YT_HD Band3 row0(int32_t c) const {
        const int32_t j0 = c - base;
        const int32_t v =
            c >= ncols           ? DP_WORST
            : j0 == 0            ? 0
            : j0 >= 1 && j0 <= hi0 ? wsub(0, wadd(s.go, wmul(j0, s.ge)))
                                 : DP_WORST;
        return band3(v, DP_WORST, 0);
    }
};

// The plane bytes the wavefront does not compute, from plane offset x0 on:
// row 0's delete cells (j0 = column - base in [1, hi0]), 0 in every later
// row (the rows past min(qlen, QL)).
struct AnchFillSrc {
    int64_t x0;
    int32_t w, base, hi0;
    YT_HD uint8_t byte(int64_t o) const {
        const int64_t x = x0 + o;
        if (x >= w) return 0;
        const int64_t j0 = x - base;
        return (uint8_t)(j0 >= 1 && j0 <= hi0
                             ? OP_DELETE + (j0 >= 2 ? BT_CD : 0)
                             : 0);
    }
    YT_HD void words(int64_t o, uint32_t (&out)[4]) const {
        for (int m = 0; m < 4; m++) out[m] = 0;
        if (x0 + o >= w) return;   // past row 0: zeros
        for (int b = 0; b < 16; b++)
            out[b >> 2] |= (uint32_t)byte(o + b) << 8 * (b & 3);
    }
};

// One lane of the wavefront.  h1, h2 and h3 are the cells lane k - 1 (for
// lane 0 the shared row) handed down one, two and three steps ago: banded
// up = h1 (column o + 1) and diag = h2 (column o); full up = h2 (column j)
// and diag = h3 (column j - 1).
template <bool kFullLayout>
struct AnchWideLane {
    int32_t k;              // lane
    int32_t i, j;           // row of the current strip; column this step
    int32_t qc, edge_val;   // the row's query code and boundary value
    int32_t pe, pd, pvl;    // horizontal carry
    int32_t sc;             // the score, if this lane computed it
    bool got;
    Band3 h1, h2;
    int32_t h3;

    YT_HD void init(int lane) {
        k = lane;
        i = lane + 1;
        j = -2 * lane;
        qc = edge_val = pe = pd = pvl = 0;
        sc = DP_WORST;
        got = false;
        h1 = h2 = band3(DP_WORST, DP_WORST, 0);
        h3 = DP_WORST;
    }

    // Lane 0's cells of the row above, from the shared row.
    YT_HD void take_row(const Band3* row,
                        const AnchWideProblem<kFullLayout>& P) {
        if (j < 0 || j >= P.ncols) return;
        if (kFullLayout) {
            h2 = row[j];
        } else {
            if (j == 0) h2 = row[0];
            h1 = row[j + 1];
        }
    }

    // Cell (i, j) if j is one of the row's columns, from the strip's staged
    // codes: writes its plane byte to stage_row[j] and returns what the row
    // below reads at this column (outside the columns, the sentinel).
    YT_HD Band3 step(const AnchWideProblem<kFullLayout>& P,
                     const uint8_t* codes, uint8_t* stage_row) {
        if (j == 0) {
            qc = codes[k];
            edge_val = wsub(0, wadd(P.s.go, wmul(i, P.s.ge)));
            pe = DP_WORST;
            pd = 0;
            pvl = kFullLayout && i <= P.lbw ? edge_val : DP_WORST;
        }
        if (j < 0 || j >= P.ncols) return band3(DP_WORST, DP_WORST, 0);
        const Band3 up = kFullLayout ? h2 : h1;
        Band3 out = up;
        int32_t b = 0;
        if (kFullLayout && j == 0) {
            // Column 0: the insert boundary for i <= lbw (its chain runs
            // straight up), else the state above.
            if (i <= P.lbw) {
                out.v = edge_val;
                b = OP_INSERT + (i > 1 ? BT_CF : 0);
            }
        } else {
            const int32_t rch = codes[kWideLanes + (kFullLayout ? j - 1
                                                                : k + j)];
            const CellOut o = cell<false>(kFullLayout ? h3 : h2.v, qc, rch,
                                          pe, pd, pvl, up.f, up.v, up.ii,
                                          P.s);
            // The cell's reference column; banded o <= lbw + rbw holds for
            // every column below live.
            const int32_t rj = kFullLayout ? j : i + j - P.lbw;
            const bool act =
                kFullLayout
                    ? (int64_t)j >= (int64_t)i - P.lbw &&
                          (int64_t)j <= (int64_t)i + P.rbw && j <= P.live
                    : rj >= 1 && rj <= P.rlen;
            if (act) {
                out = band3(o.v, o.f, o.ii);
                pe = o.pe;
                pd = o.pd;
                pvl = o.v;
                b = o.bt;
                if (i == P.qlen && i <= P.last && rj == P.rlen) {
                    sc = o.v;
                    got = true;
                }
            } else if (!kFullLayout) {
                // Reset, and the column-0 insert boundary at o = lbw - i.
                const bool bound = rj == 0;
                out = band3(bound ? edge_val : DP_WORST, DP_WORST, 0);
                pe = DP_WORST;
                pd = 0;
                pvl = out.v;
                b = bound ? OP_INSERT + (i > 1 ? BT_CF : 0) : 0;
            }
        }
        stage_row[j] = (uint8_t)b;
        return out;
    }

    // To the next step, with the cell lane k - 1 handed down this step.
    YT_HD void advance(const Band3& handed,
                       const AnchWideProblem<kFullLayout>& P) {
        h3 = h2.v;
        h2 = h1;
        h1 = handed;
        if (++j == P.period) {
            j = 0;
            i += kWideLanes;
        }
    }
};

// When the warp copies a strip out: at the step at which the strip's last
// row (lane 31's, or in the last strip the problem's last) has done its
// last column.
struct AnchWideSched {
    int32_t strip, last_strip, rows, copy_at;

    template <class P>
    YT_HD void init(const P& pr) {
        strip = 0;
        last_strip = (pr.last - 1) / kWideLanes;
        set(pr);
    }
    template <class P>
    YT_HD void set(const P& pr) {
        rows = strip == last_strip ? pr.last - kWideLanes * strip
                                   : kWideLanes;
        copy_at = strip * pr.period + 2 * (rows - 1) +
                  (pr.ncols > 1 ? pr.ncols - 1 : 0);
    }
    YT_HD bool last() const { return strip == last_strip; }
    template <class P>
    YT_HD void next(const P& pr) {
        strip++;
        set(pr);
    }
};

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
anch_reg_kernel(ytsw::AnchArgs a, int64_t n, int8_t* bt, int32_t* score) {
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
    // A warp with a lane wider than 32 columns: anch_wide_kernel takes
    // its problems.
}

// The wide route: warp `warp` of block b takes problem b * warps + warp
// when its group of 32 problems (the register kernel's warp) has a lane
// wider than 32 columns; its shared memory is wide_warp_bytes(w).
template <bool kFullLayout>
__global__ void __launch_bounds__(ytsw::kAnchWideWarps * 32)
anch_wide_kernel(ytsw::AnchArgs a, int64_t n, int8_t* bt, int32_t* score) {
    using namespace ytsw;
    extern __shared__ __align__(16) uint8_t smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t p = blockIdx.x * (int64_t)(blockDim.x >> 5) + warp;
    if (p >= n) return;   // the whole warp
    const int64_t g = (p & ~(int64_t)31) + lane;
    int32_t glive = 0;
    if (g < n)
        glive = kFullLayout ? full_live(a.rlens[g], a.rl)
                            : band_live(a.lbws[g], a.rbws[g], a.wband);
    if (__reduce_max_sync(kFull, glive) <= 32) return;   // a register warp
    AnchWideProblem<kFullLayout> P;
    P.init(p, a);
    const int64_t w = P.w;
    uint8_t* wsm = smem + warp * wide_warp_bytes(w);
    Band3* row = (Band3*)wsm;
    uint8_t* stage = wsm + wide_row_bytes(w);
    const int64_t sb = wide_stage_bytes(w);
    uint8_t* codes = stage + 2 * sb;
    const int64_t cb = wide_code_bytes(w);
    uint8_t* plane = (uint8_t*)bt + p * (a.ql + 1) * w;

    // Columns past ncols of a staged row must read 0.
    anch_zero(stage, (int32_t)(2 * sb), lane, kWideLanes);
    for (int32_t c = lane; c <= P.ncols; c += kWideLanes) row[c] = P.row0(c);
    copy_share(lane, plane, w, AnchFillSrc{0, P.w, P.base, P.hi0});
    AnchWideLane<kFullLayout> L;
    L.init(lane);
    if (P.last >= 1) {
        P.stage_codes(lane, 0, codes);
        P.stage_codes(lane, 1, codes + cb);
        __syncwarp();
        AnchWideSched S;
        S.init(P);
        for (int32_t t = 0;; t++) {
            if (lane == 0) L.take_row(row, P);
            const int32_t par = ((L.i - 1) / kWideLanes) & 1;
            const Band3 out =
                L.step(P, codes + par * cb, stage + par * sb + lane * w);
            if (lane == kWideLanes - 1 && L.j >= 0 && L.j < P.ncols)
                row[L.j] = out;
            L.advance(shfl_up3(out), P);
            __syncwarp();
            if (t != S.copy_at) continue;
            copy_share(lane, plane + ((int64_t)S.strip * kWideLanes + 1) * w,
                       (int64_t)S.rows * w,
                       StageSrc{stage + (S.strip & 1) * sb});
            if (S.last()) break;
            // No lane has reached strip + 2: its codes take this strip's
            // buffers, and its rows this strip's stage once copied.
            if (S.strip + 2 <= S.last_strip)
                P.stage_codes(lane, S.strip + 2, codes + (S.strip & 1) * cb);
            __syncwarp();
            S.next(P);
        }
    }
    const int64_t x0 = ((int64_t)(P.last > 0 ? P.last : 0) + 1) * w;
    copy_share(lane, plane + x0, (a.ql + 1) * w - x0,
               AnchFillSrc{x0, P.w, P.base, P.hi0});
    const unsigned got = __ballot_sync(kFull, L.got);
    const int32_t sc = __shfl_sync(kFull, L.sc, got ? __ffs(got) - 1 : 0);
    if (lane == 0) score[p] = got ? sc : DP_WORST;
}

// The register kernel over every problem, then, for a plane wider than 32
// columns, the wide route.  Each register warp stages its rows in its own
// part of shared memory; each wide warp has wide_warp_bytes(w).
template <bool kFullLayout>
int launch(const ytsw::AnchArgs& a, int64_t n, int8_t* bt, int32_t* score,
           cudaStream_t stream) {
    const int64_t w = kFullLayout ? a.rl + 1 : a.wband;
    const bool wide = kFullLayout ? a.rl > 32 : a.wband > 32;
    const int64_t wbytes = ytsw::wide_warp_bytes(w);
    if (wide && wbytes > ytsw::kWideSmemMax)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)ytsw::kAnchBlock * ytsw::kAnchStageStride;
    cudaError_t e = cudaFuncSetAttribute(
        anch_reg_kernel<kFullLayout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int64_t grid = (n + ytsw::kAnchBlock - 1) / ytsw::kAnchBlock;
    anch_reg_kernel<kFullLayout>
        <<<(unsigned)grid, ytsw::kAnchBlock, smem, stream>>>(a, n, bt, score);
    e = cudaGetLastError();
    if (e != cudaSuccess || !wide) return (int)e;
    int warps = ytsw::kAnchWideWarps;
    while (warps > 1 && warps * wbytes > ytsw::kWideSmemMax) warps >>= 1;
    const size_t wsmem = (size_t)(warps * wbytes);
    e = cudaFuncSetAttribute(anch_wide_kernel<kFullLayout>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wsmem);
    if (e != cudaSuccess) return (int)e;
    anch_wide_kernel<kFullLayout>
        <<<(unsigned)((n + warps - 1) / warps), 32 * warps, wsmem, stream>>>(
            a, n, bt, score);
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
// stream (the register kernel, then for a plane wider than 32 columns the
// wide route), allocates nothing and does not synchronise; it returns
// cudaGetLastError(), or cudaErrorInvalidValue, launching nothing, for a
// plane wider than 32 columns whose wide warp would not fit a block's
// shared memory (wband or RL + 1 above 2,829).
extern "C" {

int yt_anch_banded(const uint8_t* q, const uint8_t* r, const int32_t* qlens,
                   const int32_t* rlens, const int32_t* lbws,
                   const int32_t* rbws, int64_t n, int64_t ql, int64_t rl,
                   int32_t wband, int32_t go, int32_t ge, int32_t rc,
                   int32_t ms, int32_t max_gap, int32_t max_intron,
                   int8_t* bt, int32_t* score, void* stream) {
    return launch<false>(
        args(q, r, qlens, rlens, lbws, rbws, ql, rl, wband, go, ge, rc, ms,
             max_gap, max_intron),
        n, bt, score, (cudaStream_t)stream);
}

int yt_anch_full(const uint8_t* q, const uint8_t* r, const int32_t* qlens,
                 const int32_t* rlens, const int32_t* lbws,
                 const int32_t* rbws, int64_t n, int64_t ql, int64_t rl,
                 int32_t go, int32_t ge, int32_t rc, int32_t ms,
                 int32_t max_gap, int32_t max_intron, int8_t* bt,
                 int32_t* score, void* stream) {
    return launch<true>(
        args(q, r, qlens, rlens, lbws, rbws, ql, rl, 0, go, ge, rc, ms,
             max_gap, max_intron),
        n, bt, score, (cudaStream_t)stream);
}

}  // extern "C"

#endif  // __CUDACC__
