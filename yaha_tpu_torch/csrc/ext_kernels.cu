// Banded X-drop extension with the band state in registers (sm_90a).
//
// Replaces yaha_tpu/ops/sw_pallas.py extension_forward_pallas (_ext_kernel,
// _ext_kernel_win -> _ext_body), as ext_wide_kernels.cu does, and returns
// the same arrays byte for byte: the backtrack plane bt [N][QL+1][W] int8
// (W = 4*bw + 1), score, maxi and maxj, with the same X-drop exit row and
// the same first-maximum ties.  sw_cuda.py dispatches by shape: this kernel
// for W = 5 .. 33 (-BW 1 to 8), ext_wide_kernels.cu for the other widths.
//
// What bounds it on an H100: one thread owns one problem, whose cells are
// one chain of integer compares, selects and adds, most of them on the
// 16-lane INT32 pipe, and X-drop exits end most problems within a few
// dozen rows while a few run all QL rows.  So the launch takes about as
// long as its longest problem, far above the bytes it must move (the
// plane) and the integer work of the cells it computes; chip_smoke.py
// phase 5 prints both.  The first version also waited on L2 for every cell
// (its band state lived in global scratch) and stored its plane bytes one
// at a time, each thread 21 bytes of plane apart from its neighbour, so
// that every byte store of a warp was 32 memory transactions.  Here:
//
//   * W is a template constant and the column loop is unrolled, so the
//     band state (W+1 columns of PV, PF, PI, the band-edge sentinel
//     included) and the W reference codes of the row live in registers.
//     start_col / end_col become per-column predicates, only on the rows
//     that need them (the first 2*bw rows and the last ones before rlen);
//     every other row runs without them.  The reference window slides one
//     code per row, loaded a row ahead, as is the next query code.
//   * A row's plane bytes go to shared memory.  Every R rows the warp
//     copies each lane's R rows, which are contiguous in that lane's plane,
//     to device memory together: 32 consecutive bytes per store.
//   * The warp runs its rows in step until its last problem ends (a lane
//     whose problem has ended computes rows it never copies out), so the
//     copy and the predicate choice are warp-wide.
//   * Blocks of 32, 64 or 128 threads: a bucket of a few thousand problems
//     still reaches every SM.
//
// The per-problem body (ExtReg, ext_problem_reg) is __host__ __device__:
// without __CUDACC__ it compiles with g++, so the CPU tests hold it to the
// plain PyTorch version.
#include <utility>

#include "sw_cells.cuh"

namespace ytsw {

// One problem's extension state, the band in registers.  Rows are computed
// by row<kPred>(i, out), which writes the row's W plane bytes to `out`.
// Every per-column step is a template on its column J, expanded by a fold
// over std::integer_sequence, so every array index is a constant in the
// source: a column loop that the compiler unrolls only late leaves the
// state in local memory.
template <int W>
struct ExtReg {
    static constexpr int BW2 = (W - 1) / 2;
    template <int N>
    using Cols = std::make_integer_sequence<int, N>;

    int32_t pv[W + 1], pf[W + 1], pi[W + 1];  // index W: band-edge sentinel
    int32_t rwin[W];   // reference codes of the current row's W columns
    const uint8_t* qp;
    const uint8_t* rp;
    int64_t ql, rl;
    int32_t qlen, rlen, last;
    int32_t qc, q_next, r_next;
    int32_t max_score, mi, mj;
    int32_t rows;      // last row computed (0: none)
    bool alive;        // rows remain to compute
    Scoring s;
    int32_t x_cutoff;

    // The horizontal carry of a row and its best cell.
    struct Carry {
        int32_t pe, pd, pvl, best_v, best_j;
    };

    YT_HD int32_t ref(int64_t idx) const {
        return (idx >= 0 && idx < rl) ? ld_u8(rp + idx) : 255;
    }

    // Row 0 (SW.cpp:899-933), the sentinel, and row 1's reference window.
    template <int J>
    YT_HD void init_col() {
        pv[J] = J == BW2 ? 0
                : (J > BW2 && J < W) ? wsub(0, wadd(s.go, wmul(J - BW2, s.ge)))
                                     : DP_WORST;
        pf[J] = J == BW2 ? 0 : DP_WORST;
        pi[J] = 0;
        if constexpr (J < W) rwin[J] = ref(J - BW2);
    }
    template <int... J>
    YT_HD void init_cols(std::integer_sequence<int, J...>) {
        (init_col<J>(), ...);
    }

    // Problem p of the batch; `valid` false makes an idle lane (problem
    // 0's rows are read, nothing is written).  Writes row 0 of the plane
    // and the anti-diagonal insert cells of rows 1..bw2.
    YT_HD void init(int64_t p, bool valid, const uint8_t* q, int64_t ql_,
                    const uint8_t* r, int64_t rl_, const int32_t* qlens,
                    const int32_t* rlens, Scoring s_, int32_t xc,
                    int8_t* bt) {
        const int64_t pp = valid ? p : 0;
        qp = q + pp * ql_;
        rp = r + pp * rl_;
        ql = ql_;
        rl = rl_;
        s = s_;
        x_cutoff = xc;
        qlen = qlens[pp];
        rlen = rlens[pp];
        last = (int32_t)(qlen < ql ? qlen : ql);
        alive = valid && last >= 1;
        rows = 0;
        max_score = DP_WORST;
        mi = 0;
        mj = 0;
        init_cols(Cols<W + 1>());
        qc = 0;
        q_next = ql > 0 ? ld_u8(qp) : 0;
        r_next = ref(1 + BW2);
        if (!valid) return;
        int8_t* btp = bt + p * (ql + 1) * W;
        for (int j = BW2 + 1; j < W; j++)
            btp[j] = (int8_t)(OP_DELETE + (j - BW2 >= 2 ? BT_CD : 0));
        for (int32_t i = 1; i <= BW2 && i <= ql; i++)
            btp[(int64_t)i * W + (BW2 - i)] =
                (int8_t)(OP_INSERT + (i > 1 ? BT_CF : 0));
    }

    // Whether row i computes every band column (no predicates needed).
    YT_HD bool full_row(int32_t i) const {
        return i > BW2 && i <= rlen - BW2;
    }

    // The band edge of rows 1..bw2 (column bw2 - i, below start_col).
    template <int... J>
    YT_HD void edge_cols(int32_t i, int32_t edge_val,
                         std::integer_sequence<int, J...>) {
        ((J == BW2 - i ? (void)(pv[J] = edge_val) : (void)0), ...);
    }

    // Cell (i, J); with kPred, only where start_col <= J <= end_col (else
    // the state is kept and the plane byte is 0, or the anti-diagonal
    // insert cell).
    template <bool kPred, int J>
    YT_HD void cell_col(Carry& c, int32_t i, int32_t start_col,
                        int32_t end_col, int32_t insert_bt, uint8_t* out) {
        const CellOut o = cell<true>(pv[J], qc, rwin[J], c.pe, c.pd, c.pvl,
                                     pf[J + 1], pv[J + 1], pi[J + 1], s);
        const bool act = !kPred || (J >= start_col && J <= end_col);
        int32_t b = 0;
        if (act) {
            pf[J] = o.f;
            pi[J] = o.ii;
            pv[J] = o.v;
            if (o.v > c.best_v) {
                c.best_v = o.v;
                c.best_j = J;
            }
            c.pe = o.pe;
            c.pd = o.pd;
            c.pvl = o.v;
            b = o.bt;
        } else if (J == BW2 - i) {
            b = insert_bt;
        }
        out[J] = (uint8_t)b;
    }
    template <bool kPred, int... J>
    YT_HD void cells(Carry& c, int32_t i, int32_t start_col, int32_t end_col,
                     int32_t insert_bt, uint8_t* out,
                     std::integer_sequence<int, J...>) {
        (cell_col<kPred, J>(c, i, start_col, end_col, insert_bt, out), ...);
    }

    // The next row's reference window: one code in, loaded a row ahead.
    template <int... J>
    YT_HD void shift_cols(std::integer_sequence<int, J...>) {
        ((rwin[J] = rwin[J + 1]), ...);
    }

    template <bool kPred>
    YT_HD void row(int32_t i, uint8_t* out) {
        qc = q_next;
        q_next = i < ql ? ld_u8(qp + i) : 0;
        const int32_t start_col = BW2 + 1 - i > 0 ? BW2 + 1 - i : 0;
        const int32_t end_col = BW2 + rlen - i < W - 1 ? BW2 + rlen - i
                                                       : W - 1;
        const int32_t edge_val = wsub(0, wadd(s.go, wmul(i, s.ge)));
        Carry c = {DP_WORST, 0, DP_WORST, DP_WORST, 0};
        if (kPred) {
            edge_cols(i, edge_val, Cols<BW2>());
            if (i <= BW2) c.pvl = edge_val;
        }
        cells<kPred>(c, i, start_col, end_col,
                     OP_INSERT + (i > 1 ? BT_CF : 0), out, Cols<W>());
        shift_cols(Cols<W - 1>());
        rwin[W - 1] = r_next;
        r_next = ref((int64_t)i + 1 + BW2);
        if (alive) {
            rows = i;
            // The row's maximum is best_v: both are the maximum over the
            // row's cells.
            if (c.best_v > max_score) {
                max_score = c.best_v;
                mi = i;
                mj = c.best_j;
            }
            if (c.best_v < wsub(max_score, x_cutoff) || i >= last)
                alive = false;
        }
    }

    YT_HD void finish(int64_t p, int32_t* score, int32_t* maxi,
                      int32_t* maxj) const {
        score[p] = max_score;
        maxi[p] = mi;
        maxj[p] = mj;
    }
};

// Problem p on its own (the host build's loop; the card runs the warp-wide
// loop of ext_reg_kernel).  force_pred runs every row with predicates, as
// a lane does when another lane of its warp needs them.
template <int W>
YT_HD void ext_problem_reg(int64_t p, const uint8_t* q, int64_t ql,
                           const uint8_t* r, int64_t rl,
                           const int32_t* qlens, const int32_t* rlens,
                           Scoring s, int32_t x_cutoff, int8_t* bt,
                           int32_t* score, int32_t* maxi, int32_t* maxj,
                           bool force_pred) {
    ExtReg<W> st;
    st.init(p, true, q, ql, r, rl, qlens, rlens, s, x_cutoff, bt);
    uint8_t* btp = (uint8_t*)bt + p * (ql + 1) * W;
    for (int32_t i = 1; st.alive; i++) {
        if (force_pred || !st.full_row(i))
            st.template row<true>(i, btp + (int64_t)i * W);
        else
            st.template row<false>(i, btp + (int64_t)i * W);
    }
    st.finish(p, score, maxi, maxj);
}

// Rows a lane stages in shared memory between copies, and its stage
// stride: about 720 bytes, an odd number of words so that the lanes' row
// stores fall in distinct banks.  Each copy costs a fixed warp-wide loop
// over the 32 lanes, so fewer, longer copies are cheaper.  A block of 128
// threads stages up to 92 KB.
template <int W>
struct ExtStage {
    static constexpr int kRows = 720 / W;
    static constexpr int kStride = (((kRows * W + 3) / 4) | 1) * 4;
};

}  // namespace ytsw

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int W>
__global__ void __launch_bounds__(128)
ext_reg_kernel(int64_t n, const uint8_t* q, int64_t ql, const uint8_t* r,
               int64_t rl, const int32_t* qlens, const int32_t* rlens,
               ytsw::Scoring s, int32_t x_cutoff, int8_t* bt, int32_t* score,
               int32_t* maxi, int32_t* maxj) {
    using Stage = ytsw::ExtStage<W>;
    extern __shared__ uint8_t stage[];
    const int lane = threadIdx.x & 31;
    uint8_t* warp_stage = stage + (threadIdx.x - lane) * Stage::kStride;
    uint8_t* mine = warp_stage + lane * Stage::kStride;
    const int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    const bool valid = p < n;
    ytsw::ExtReg<W> st;
    st.init(p, valid, q, ql, r, rl, qlens, rlens, s, x_cutoff, bt);
    int32_t i0 = 1;
    while (__any_sync(kFull, st.alive)) {
        int32_t nr = 0;
        while (nr < Stage::kRows) {
            const int32_t i = i0 + nr;
            const bool pred = st.alive && !st.full_row(i);
            if (__any_sync(kFull, pred))
                st.template row<true>(i, mine + nr * W);
            else
                st.template row<false>(i, mine + nr * W);
            nr++;
            if (!__any_sync(kFull, st.alive)) break;
        }
        // Copy rows i0 .. i0+nr-1 of every lane that computed them: lane
        // t's are contiguous in its plane, 32 consecutive bytes a store.
        __syncwarp();
        for (int t = 0; t < 32; t++) {
            const int32_t rows_t = __shfl_sync(kFull, st.rows, t);
            const int32_t cnt =
                (rows_t < i0 + nr - 1 ? rows_t : i0 + nr - 1) - i0 + 1;
            if (cnt <= 0) continue;
            const int64_t p_t = p - lane + t;
            const uint8_t* src = warp_stage + t * Stage::kStride;
            uint8_t* dst = (uint8_t*)bt + (p_t * (ql + 1) + i0) * W;
            for (int32_t b = lane; b < cnt * W; b += 32) dst[b] = src[b];
        }
        __syncwarp();
        i0 += nr;
    }
    if (valid) st.finish(p, score, maxi, maxj);
}

template <int W>
int launch(int64_t n, const uint8_t* q, int64_t ql, const uint8_t* r,
           int64_t rl, const int32_t* qlens, const int32_t* rlens,
           ytsw::Scoring s, int32_t x_cutoff, int8_t* bt, int32_t* score,
           int32_t* maxi, int32_t* maxj, int block, cudaStream_t stream) {
    const int64_t grid = (n + block - 1) / block;
    const size_t smem = (size_t)block * ytsw::ExtStage<W>::kStride;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            ext_reg_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    ext_reg_kernel<W><<<(unsigned)grid, block, smem, stream>>>(
        n, q, ql, r, rl, qlens, rlens, s, x_cutoff, bt, score, maxi, maxj);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Register-band extension for W = 2*bw2 + 1 in {5, 9, ..., 33}, in blocks
// of `block` threads (32, 64 or 128).  Launches on the given stream,
// allocates nothing, does not synchronise; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a width or block size it does not take.
int yt_ext_forward_reg(const uint8_t* q, const uint8_t* r,
                       const int32_t* qlens, const int32_t* rlens, int64_t n,
                       int64_t ql, int64_t rl, int32_t bw2, int32_t go,
                       int32_t ge, int32_t rc, int32_t ms, int32_t max_gap,
                       int32_t max_intron, int32_t x_cutoff, int8_t* bt,
                       int32_t* score, int32_t* maxi, int32_t* maxj,
                       int32_t block, void* stream) {
    if (block != 32 && block != 64 && block != 128)
        return (int)cudaErrorInvalidValue;
    ytsw::Scoring s;
    s.go = go;
    s.ge = ge;
    s.rc = rc;
    s.ms = ms;
    s.max_gap = max_gap;
    s.max_intron = max_intron;
    cudaStream_t st = (cudaStream_t)stream;
#define YT_EXT_W(w)                                                       \
    case w:                                                               \
        return launch<w>(n, q, ql, r, rl, qlens, rlens, s, x_cutoff, bt, \
                         score, maxi, maxj, block, st);
    switch (2 * bw2 + 1) {
        YT_EXT_W(5)
        YT_EXT_W(9)
        YT_EXT_W(13)
        YT_EXT_W(17)
        YT_EXT_W(21)
        YT_EXT_W(25)
        YT_EXT_W(29)
        YT_EXT_W(33)
    }
#undef YT_EXT_W
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"

#endif  // __CUDACC__
