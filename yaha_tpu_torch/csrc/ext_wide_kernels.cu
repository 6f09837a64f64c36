// Banded X-drop extension for any band width, a warp per problem (sm_90a).
//
// Replaces yaha_tpu/ops/sw_pallas.py extension_forward_pallas (_ext_kernel,
// _ext_kernel_win -> _ext_body) for the widths that ext_kernels.cu does not
// keep in registers: sw_cuda.py sends every W = 4*bw + 1 outside W 5 .. 33
// here, that is -BW 0 and -BW 9 and wider.  It returns the same arrays
// byte for byte: the backtrack plane bt [N][QL+1][W] int8, score, maxi and
// maxj, with the same X-drop exit row, the same first-maximum ties and
// the same int32 wraps.  It writes every byte of its plane (zeros after
// the exit row included), so the caller allocates it uninitialised.
//
// What bounds it on an H100: a row's cells are one dependent chain (the
// delete run's test `pd + 1 <= max_intron` makes the horizontal carry a
// recurrence that is not associative, so it cannot be a scan), and most
// problems end at their X-drop row within a few dozen rows while a few
// run all QL rows.  The plane's bytes (the bound at 1 kb: W bytes a row,
// every row written) and the cells' integer work come next.  The first
// version gave a problem to a thread, walked its band state through global
// scratch on every cell, and stored its plane one byte at a time, each
// thread a plane apart from the next, so every byte a warp stored was 32
// transactions; its state per thread grows with W, so the register kernel
// of ext_kernels.cu cannot take these widths either.
//
// Design: a warp per problem on a row wavefront.  Lane k computes the rows
// i = 32 s + k + 1 of strip s; it reaches band column J of its row at step
// s*P + 2k + J, with P = max(W + 1, 64), so that
//
//   * the row above's cells (i-1, J+1) ("up") and (i-1, J) ("diag") were
//     computed by lane k-1 one and two steps earlier: one __shfl_up_sync
//     a step hands them down, and each lane keeps last step's as its
//     diagonal;
//   * lane 0 reads row 32 s from a shared-memory row of W+1 columns that
//     lane 31 writes a step at a time (row 0 and the band-edge sentinel,
//     column W, to start with).  A period of at least 64 steps leaves
//     lane 31 two steps ahead of the next strip's lane 0;
//   * a lane's state is O(1) registers whatever W is: the carry of its
//     row, its best cell, and two cells of the row above;
//   * no global load is on the chain of steps: a strip's 32 query codes
//     and the W + 31 reference codes its rows read are staged in shared
//     memory two strips ahead, at the fold (two buffers), and at each
//     step the 32 lanes read 32 neighbouring codes there;
//   * cells outside [start_col, end_col] keep the row above's state, and
//     rows i <= bw2 set column bw2 - i to the column-0 insert boundary,
//     as the reference does.
//
// When lane 31 has finished strip s, the warp folds the strip's 32 rows
// in row order (a max-scan with strict >, so the earliest row wins) into
// the running maximum and finds the X-drop exit row; rows past it are
// thrown away.  Each strip's 32 rows of plane bytes are staged in shared
// memory (two buffers: the next strip starts before this one ends) and
// copied out, contiguous in the problem's plane, as 16-byte stores; the
// bytes before the first 16-byte boundary and after the last go one at a
// time.  Row 0, the anti-diagonal insert cells of rows past the exit and
// the zero tail are written by the same copy from a generator.
//
// Past W 2,829 (-BW 707) the two strip stages no longer fit a block's
// shared memory beside the row and the codes.  The direct variant
// (ext_wide_kernel<true>, up to W 12,905, -BW 3,226) has no stages: each
// lane stores its plane bytes straight into its row of the problem's
// plane, a byte a step (32 rows apart across the warp, so 32 transactions
// a step where the staged copy makes 16-byte stores), and skips rows past
// QL.  The rows after the exit row that its lanes wrote are overwritten by
// the zero tail's copy, which __syncwarp orders after them.  For W < 64
// lanes wait for the previous strip's lane 31, so they are busy W/64 of
// the steps; chip_smoke.py phase 5 prints the share.  A block is one warp:
// X-drop ends problems at very different rows, and a block frees its slot
// only when its last problem ends.
//
// The lane step, the fold's pieces and the copy are __host__ __device__:
// without __CUDACC__ they compile with g++, and tests/test_torch_csrc.py
// runs them over an emulated 32-lane warp against the plain PyTorch
// version.
#include "wavefront.cuh"

namespace ytsw {

// Steps between two strips of a lane: W + 1, so that a lane hands the
// band-edge sentinel to the next lane after its last column, and at least
// 64, so that lane 31 (62 steps behind lane 0) has written row 32 s's
// column J+1 before the next strip's lane 0 reads it.
YT_HD int32_t wide_period(int32_t w) {
    return w + 1 > 2 * kWideLanes ? w + 1 : 2 * kWideLanes;
}

// Row 0 (SW.cpp:899-933) at band column c, and the sentinel at c = W.
YT_HD Band3 wide_row0(int32_t c, int32_t bw2, int32_t w, const Scoring& s) {
    const int32_t v =
        c == bw2 ? 0
        : (c > bw2 && c < w) ? wsub(0, wadd(s.go, wmul(c - bw2, s.ge)))
                             : DP_WORST;
    return band3(v, c == bw2 ? 0 : DP_WORST, 0);
}

// A plane byte the wavefront does not compute, at offset x of a problem's
// plane: row 0's delete cells, the anti-diagonal insert cells (i, bw2 - i)
// of rows 1..bw2, 0 elsewhere (every row after the exit row).
YT_HD uint8_t wide_fill_byte(int64_t x, int32_t w, int32_t bw2) {
    const int64_t row = x / w;
    const int64_t col = x - row * w;
    if (row == 0)
        return (uint8_t)(col > bw2 ? OP_DELETE + (col - bw2 >= 2 ? BT_CD : 0)
                                   : 0);
    return (uint8_t)(row <= bw2 && col == bw2 - row
                         ? OP_INSERT + (row > 1 ? BT_CF : 0)
                         : 0);
}

// One problem's inputs.
struct WideProblem {
    const uint8_t* qp;
    const uint8_t* rp;
    int64_t ql, rl;
    int32_t qlen, rlen, last, bw2, w, period, x_cutoff;
    Scoring s;

    // Lane `lane`'s share of staging strip `strip`'s codes: the query
    // codes of its rows (0 past QL), then the reference codes 32 strip -
    // bw2 + x for x in [0, W + 31) (255 outside the reference).
    YT_HD void stage_codes(int lane, int32_t strip, uint8_t* codes) const {
        const int64_t i0 = (int64_t)strip * kWideLanes;
        stage_strip_codes(lane, i0, qp, ql, rp, rl, i0 - bw2, w + 31, codes);
    }

    YT_HD void init(int64_t p, const uint8_t* q, int64_t ql_,
                    const uint8_t* r, int64_t rl_, const int32_t* qlens,
                    const int32_t* rlens, int32_t bw2_, Scoring s_,
                    int32_t xc) {
        qp = q + p * ql_;
        rp = r + p * rl_;
        ql = ql_;
        rl = rl_;
        qlen = qlens[p];
        rlen = rlens[p];
        last = (int32_t)(qlen < ql ? qlen : ql);
        bw2 = bw2_;
        w = 2 * bw2 + 1;
        period = wide_period(w);
        x_cutoff = xc;
        s = s_;
    }
};

// One lane of the wavefront.
struct WideLane {
    int32_t k;                // lane
    int32_t i, j;             // row of the current strip; column this step
    int32_t qc, edge_val;     // the row's query code and boundary value
    int32_t pe, pd, pvl;      // horizontal carry
    int32_t best_v, best_j;   // the row's first maximum so far
    int32_t done_v, done_j;   // the last finished row's, for the fold
    Band3 diag, up;           // cells (i-1, j) and (i-1, j+1)

    YT_HD void init(int lane) {
        k = lane;
        i = lane + 1;
        j = -2 * lane;
        qc = edge_val = pe = pd = pvl = 0;
        best_v = done_v = DP_WORST;
        best_j = done_j = 0;
        diag = up = band3(DP_WORST, DP_WORST, 0);
    }

    // Lane 0's cells of the row above, from the shared row: column j + 1
    // (the sentinel past the band), and at a row's first column also the
    // diagonal, column 0.
    YT_HD void take_row(const Band3* row, const WideProblem& P) {
        if (j == 0) diag = row[0];
        up = row[j + 1 < P.w ? j + 1 : P.w];
    }

    // Cell (i, j) if j is a band column, from the strip's staged codes:
    // writes its plane byte to stage_row[j] (unless stage_row is null: a
    // row past QL) and returns what the row below reads at this column.
    // Outside the band it hands down the sentinel.
    YT_HD Band3 step(const WideProblem& P, const uint8_t* codes,
                     uint8_t* stage_row) {
        if (j == 0) {
            qc = codes[k];
            edge_val = wsub(0, wadd(P.s.go, wmul(i, P.s.ge)));
            pe = DP_WORST;
            pd = 0;
            pvl = i <= P.bw2 ? edge_val : DP_WORST;
            best_v = DP_WORST;
            best_j = 0;
        }
        if (j < 0 || j >= P.w) return band3(DP_WORST, DP_WORST, 0);
        const int32_t start_col = P.bw2 + 1 - i > 0 ? P.bw2 + 1 - i : 0;
        const int32_t end_col =
            P.bw2 + P.rlen - i < P.w - 1 ? P.bw2 + P.rlen - i : P.w - 1;
        const int32_t rch = codes[kWideLanes + k + j];
        const CellOut o = cell<true>(diag.v, qc, rch, pe, pd, pvl, up.f,
                                     up.v, up.ii, P.s);
        Band3 out = diag;
        int32_t b = 0;
        if (j >= start_col && j <= end_col) {
            out = band3(o.v, o.f, o.ii);
            pe = o.pe;
            pd = o.pd;
            pvl = o.v;
            if (o.v > best_v) {
                best_v = o.v;
                best_j = j;
            }
            b = o.bt;
        } else if (j == P.bw2 - i) {
            out.v = edge_val;
            b = OP_INSERT + (i > 1 ? BT_CF : 0);
        }
        if (stage_row) stage_row[j] = (uint8_t)b;
        if (j == P.w - 1) {
            done_v = best_v;
            done_j = best_j;
        }
        return out;
    }

    // To the next step: the row above's cell handed down this step becomes
    // `up`, the old `up` the diagonal.
    YT_HD void advance(const Band3& handed, const WideProblem& P) {
        diag = up;
        up = handed;
        if (++j == P.period) {
            j = 0;
            i += kWideLanes;
        }
    }
};

// Shared memory of the direct variant: the row and two strips' codes (its
// plane bytes go straight to the plane).
YT_HD int64_t ext_direct_warp_bytes(int64_t w) {
    return wide_row_bytes(w) + 2 * wide_code_bytes(w);
}

// Where lane step writes row i's plane bytes: the strip stage (staged), or
// the row itself in the problem's plane, none past QL (direct).
YT_HD uint8_t* wide_row_dst(bool direct, uint8_t* stage, int64_t sb,
                            int lane, int32_t i, uint8_t* plane,
                            int64_t ql, int32_t w) {
    if (direct) return i <= ql ? plane + (int64_t)i * w : nullptr;
    return stage + (((i - 1) / kWideLanes) & 1) * sb + (int64_t)lane * w;
}

// The running first maximum: value, row, column.  Rows fold in order and a
// later row replaces an earlier one only when strictly greater.
struct WideBest {
    int32_t v, i, j;
};

YT_HD WideBest best_after(const WideBest& earlier, const WideBest& later) {
    return later.v > earlier.v ? later : earlier;
}

// Whether row i, whose best cell is row_best and after which the running
// maximum is run_max, is the X-drop exit row (or the last row).
YT_HD bool wide_exits(int32_t row_best, int32_t run_max, int32_t i,
                      const WideProblem& P) {
    return row_best < wsub(run_max, P.x_cutoff) || i >= P.last;
}

// Bytes the wavefront does not compute, from plane offset x0 on.
struct FillSrc {
    int64_t x0;
    int32_t w, bw2;
    YT_HD uint8_t byte(int64_t o) const {
        return wide_fill_byte(x0 + o, w, bw2);
    }
    YT_HD void words(int64_t o, uint32_t (&out)[4]) const {
        for (int m = 0; m < 4; m++) out[m] = 0;
        if (x0 + o >= ((int64_t)bw2 + 1) * w) return;   // past row bw2: 0
        for (int b = 0; b < 16; b++)
            out[b >> 2] |= (uint32_t)byte(o + b) << 8 * (b & 3);
    }
};

}  // namespace ytsw

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ ytsw::WideBest shfl_best(const ytsw::WideBest& b,
                                                    int src, bool up) {
    ytsw::WideBest o;
    o.v = up ? __shfl_up_sync(kFull, b.v, src) : __shfl_sync(kFull, b.v, src);
    o.i = up ? __shfl_up_sync(kFull, b.i, src) : __shfl_sync(kFull, b.i, src);
    o.j = up ? __shfl_up_sync(kFull, b.j, src) : __shfl_sync(kFull, b.j, src);
    return o;
}

template <bool kDirect>
__global__ void __launch_bounds__(ytsw::kWideLanes)
ext_wide_kernel(const uint8_t* q, int64_t ql, const uint8_t* r, int64_t rl,
                const int32_t* qlens, const int32_t* rlens, int32_t bw2,
                ytsw::Scoring s, int32_t x_cutoff, int8_t* bt, int32_t* score,
                int32_t* maxi, int32_t* maxj) {
    using namespace ytsw;
    extern __shared__ __align__(16) uint8_t smem[];
    const int lane = threadIdx.x;
    const int64_t p = blockIdx.x;   // a block is a warp is a problem
    WideProblem P;
    P.init(p, q, ql, r, rl, qlens, rlens, bw2, s, x_cutoff);
    const int32_t w = P.w;
    Band3* row = (Band3*)smem;
    uint8_t* stage = smem + wide_row_bytes(w);
    const int64_t sb = kDirect ? 0 : wide_stage_bytes(w);
    uint8_t* codes = stage + 2 * sb;
    const int64_t cb = wide_code_bytes(w);
    uint8_t* plane = (uint8_t*)bt + p * (ql + 1) * w;

    for (int32_t c = lane; c <= w; c += kWideLanes)
        row[c] = wide_row0(c, bw2, w, s);
    copy_share(lane, plane, w, FillSrc{0, w, bw2});
    WideBest run = {DP_WORST, 0, 0};
    int32_t exit_row = 0;
    if (P.last >= 1) {
        P.stage_codes(lane, 0, codes);
        P.stage_codes(lane, 1, codes + cb);
        __syncwarp();
        WideLane L;
        L.init(lane);
        int32_t strip = 0;
        int32_t fold_at = 2 * (kWideLanes - 1) + w - 1;
        for (int32_t t = 0;; t++) {
            if (lane == 0) L.take_row(row, P);
            const int32_t par = ((L.i - 1) / kWideLanes) & 1;
            const Band3 out =
                L.step(P, codes + par * cb,
                       wide_row_dst(kDirect, stage, sb, lane, L.i, plane,
                                    ql, w));
            if (lane == kWideLanes - 1 && L.j >= 0 && L.j < w) row[L.j] = out;
            L.advance(shfl_up3(out), P);
            __syncwarp();
            if (t != fold_at) continue;
            // Lane 31 has finished strip `strip`: fold its rows in order.
            const int32_t i_f = strip * kWideLanes + lane + 1;
            WideBest e = {L.done_v, i_f, L.done_j};
            if (lane == 0) e = best_after(run, e);
            for (int d = 1; d < kWideLanes; d <<= 1) {
                const WideBest o = shfl_best(e, d, true);
                if (lane >= d) e = best_after(o, e);
            }
            const unsigned ex =
                __ballot_sync(kFull, wide_exits(L.done_v, e.v, i_f, P));
            const int el = ex ? __ffs(ex) - 1 : kWideLanes - 1;
            run = shfl_best(e, el, false);
            if (!kDirect)
                copy_share(lane,
                           plane + ((int64_t)strip * kWideLanes + 1) * w,
                           (int64_t)(el + 1) * w,
                           StageSrc{stage + (strip & 1) * sb});
            if (ex) {
                exit_row = strip * kWideLanes + el + 1;
                break;
            }
            // Every lane is past this strip and none has reached strip +
            // 2: its codes take this strip's buffers.
            P.stage_codes(lane, strip + 2, codes + (strip & 1) * cb);
            __syncwarp();
            strip++;
            fold_at += P.period;
        }
    }
    const int64_t x0 = ((int64_t)exit_row + 1) * w;
    copy_share(lane, plane + x0, (ql + 1) * w - x0, FillSrc{x0, w, bw2});
    if (lane == 0) {
        score[p] = run.v;
        maxi[p] = run.i;
        maxj[p] = run.j;
    }
}

}  // namespace

extern "C" {

// The extension for any W = 2*bw2 + 1, a warp (a block) a problem: the
// staged kernel while its warp fits a block's shared memory, the direct
// one past that.  Launches on the given stream, allocates nothing, does
// not synchronise; returns cudaGetLastError(), or cudaErrorInvalidValue
// for a band too wide for the direct kernel too.
int yt_ext_forward_wide(const uint8_t* q, const uint8_t* r,
                        const int32_t* qlens, const int32_t* rlens,
                        int64_t n, int64_t ql, int64_t rl, int32_t bw2,
                        int32_t go, int32_t ge, int32_t rc, int32_t ms,
                        int32_t max_gap, int32_t max_intron, int32_t x_cutoff,
                        int8_t* bt, int32_t* score, int32_t* maxi,
                        int32_t* maxj, void* stream) {
    const int64_t w = 2 * (int64_t)bw2 + 1;
    const bool direct = ytsw::wide_warp_bytes(w) > ytsw::kWideSmemMax;
    const int64_t smem = direct ? ytsw::ext_direct_warp_bytes(w)
                                : ytsw::wide_warp_bytes(w);
    if (bw2 < 0 || smem > ytsw::kWideSmemMax)
        return (int)cudaErrorInvalidValue;
    auto kernel = direct ? ext_wide_kernel<true> : ext_wide_kernel<false>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    ytsw::Scoring s;
    s.go = go;
    s.ge = ge;
    s.rc = rc;
    s.ms = ms;
    s.max_gap = max_gap;
    s.max_intron = max_intron;
    kernel<<<(unsigned)n, ytsw::kWideLanes, (size_t)smem,
             (cudaStream_t)stream>>>(q, ql, r, rl, qlens, rlens, bw2, s,
                                     x_cutoff, bt, score, maxi, maxj);
    return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
