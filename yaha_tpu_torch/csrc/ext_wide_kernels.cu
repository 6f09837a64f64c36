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
// For W < 64 lanes wait for the previous strip's lane 31, so they are busy
// W/64 of the steps; chip_smoke.py phase 5 prints the share.  A block is
// one warp: X-drop ends problems at very different rows, and a block frees
// its slot only when its last problem ends.
//
// Past W 2,829 (-BW 707) the two strip stages no longer fit a block's
// shared memory beside the row and the codes, and ext_block_kernel takes
// the band: a block of K warps a problem.  Warp w takes strips w, w + K,
// w + 2K, ..., each as the warp above does, so K strips of a problem are
// in flight at once where one warp ran them one after another (its
// first-version direct variant stored each lane's plane byte a step, 32
// rows apart, and reached 1 % of its bound at W 2,833):
//   * the row between two strips is one shared row of W + 1 Band3 for the
//     whole block: lane 31 of strip s writes row 32 (s + 1) into it, lane
//     0 of strip s + 1 (the next warp) reads it.  Every column is written
//     and read in strip order (write s, read s + 1, write s + 1, ...), so
//     no strip overwrites a column the next one has not read, and the
//     only wait is a read's: each warp publishes how far its lane 31 has
//     written (a counter a warp, stored every kBlockChunk columns and at a
//     strip's end), and the next strip's warp waits for the column its
//     lane 0 reads.  A warp looks at the sync state once a run of up to
//     kBlockChunk steps (BlockWarp::free_steps), not once a step: with 16
//     warps an SM the step is bound by instruction throughput.  A ring
//     shorter than the row cannot hold what is in flight: a warp starts
//     strip s + K only P steps after strip s, and the K strips between
//     them hold nearly a row's worth of columns;
//   * a lane steps once a period P = max(W + 1, K (64 + kBlockChunk)):
//     strip s + K's lane 0 reads what strip s's lane 31 (the same warp)
//     must have written K hops earlier, which a shorter period would wait
//     on for ever;
//   * the codes come straight from device memory (read-only cache, each
//     loaded a step ahead of use), so shared memory grows with W only
//     through the row (W up to 14,267: ext_block_bytes);
//   * each lane stages its plane bytes in a 16-byte unit of shared memory
//     and stores the unit with one 16-byte store when its last byte is
//     written (a unit a lane every 16 steps, two a warp-step); the bytes
//     of a row's first and last unit, which it shares with the rows beside
//     it, go one at a time;
//   * the fold of strip s needs the running maximum after strip s - 1:
//     it waits for the count of strips folded, reads the maximum from
//     shared memory and leaves its own there.  The first strip whose fold
//     exits leaves the exit row; warps on later strips stop at their next
//     check (every kBlockChunk steps, and while they wait), and so does a
//     warp whose strips all lie past the last row.  After a barrier the
//     block writes the zero tail past the exit row, over whatever a warp
//     had written there.
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
    int32_t rl32;   // rl, at most INT32_MAX (a reference index is int32)
    int32_t qlen, rlen, last, bw2, w, period, x_cutoff;
    Scoring s;

    // Lane `lane`'s share of staging strip `strip`'s codes: the query
    // codes of its rows (0 past QL), then the reference codes 32 strip -
    // bw2 + x for x in [0, W + 31) (255 outside the reference).
    YT_HD void stage_codes(int lane, int32_t strip, uint8_t* codes) const {
        const int64_t i0 = (int64_t)strip * kWideLanes;
        stage_strip_codes(lane, i0, qp, ql, rp, rl, i0 - bw2, w + 31, codes);
    }

    // The codes a lane at row i reads, straight from the inputs (the block
    // kernel stages none): row i's query code (0 past QL), and at column j
    // the reference code i - 1 + j - bw2 (255 outside the reference, and
    // outside the band).
    YT_HD int32_t query_code(int32_t i) const {
        return i - 1 < ql ? ld_u8(qp + (i - 1)) : 0;
    }
    YT_HD int32_t ref_code(int32_t i, int32_t j) const {
        const int32_t ri = i - 1 + j - bw2;
        return j >= 0 && j < w && ri >= 0 && ri < rl32 ? ld_u8(rp + ri)
                                                       : 255;
    }

    YT_HD void init(int64_t p, const uint8_t* q, int64_t ql_,
                    const uint8_t* r, int64_t rl_, const int32_t* qlens,
                    const int32_t* rlens, int32_t bw2_, Scoring s_,
                    int32_t xc) {
        qp = q + p * ql_;
        rp = r + p * rl_;
        ql = ql_;
        rl = rl_;
        rl32 = (int32_t)(rl < 0x7FFFFFFF ? rl : 0x7FFFFFFF);
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

    // Cell (i, j) if j is a band column, with the row's query code q_code
    // (read at j = 0) and the reference code r_code: sets its plane byte
    // b and returns what the row below reads at this column.  Outside the
    // band it hands down the sentinel (b = 0).
    YT_HD Band3 cell_step(const WideProblem& P, int32_t q_code,
                          int32_t r_code, int32_t& b) {
        b = 0;
        if (j == 0) {
            qc = q_code;
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
        const CellOut o = cell<true>(diag.v, qc, r_code, pe, pd, pvl, up.f,
                                     up.v, up.ii, P.s);
        Band3 out = diag;
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
        if (j == P.w - 1) {
            done_v = best_v;
            done_j = best_j;
        }
        return out;
    }

    // cell_step with the codes from the strip's staged codes, the plane
    // byte to stage_row[j] (unless stage_row is null: a row past QL).
    YT_HD Band3 step(const WideProblem& P, const uint8_t* codes,
                     uint8_t* stage_row) {
        const bool in = j >= 0 && j < P.w;
        int32_t b;
        const Band3 out = cell_step(P, j == 0 ? codes[k] : 0,
                                    in ? codes[kWideLanes + k + j] : 255, b);
        if (in && stage_row) stage_row[j] = (uint8_t)b;
        return out;
    }

    // To the next step: the row above's cell handed down this step becomes
    // `up`, the old `up` the diagonal; after the period's last step, the
    // lane's row `rows` further down (the next strip's).
    YT_HD void advance(const Band3& handed, const WideProblem& P,
                       int32_t rows = kWideLanes) {
        diag = up;
        up = handed;
        if (++j == P.period) {
            j = 0;
            i += rows;
        }
    }
};

// Where lane step writes row i's plane bytes in the staged kernel: its
// strip's stage (two, by strip parity), the lane's row of it.
YT_HD uint8_t* wide_row_dst(uint8_t* stage, int64_t sb, int lane, int32_t i,
                            int32_t w) {
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

// ---- ext_block_kernel: a block of K warps a problem ----

constexpr int kBlockWarps = 8;        // K, chosen by measurement (PERF.md)
constexpr int kBlockMaxWarps = 8;
constexpr int32_t kBlockChunk = 32;   // columns between progress stores
constexpr int32_t kNoExit = 0x7FFFFFFF;

// The block's shared state beside the row: each warp's published progress
// (its lane 31's columns of the row over its strips: column x of its
// r-th strip is r W + x + 1), the strips folded, the exit strip and row,
// and the running first maximum after the strips folded.
struct alignas(16) BlockSync {
    int32_t prog[kBlockMaxWarps];
    int32_t folded, exit_strip, exit_row;
    int32_t run_v, run_i, run_j;
};
constexpr int64_t kBlockSyncBytes = 64;
static_assert(sizeof(BlockSync) <= kBlockSyncBytes, "BlockSync");

// Shared memory of a block of `warps` warps for plane rows of w bytes:
// the sync state, a 16-byte unit a lane, the row of w + 1 Band3.
YT_HD int64_t ext_block_bytes(int64_t w, int warps = kBlockWarps) {
    return kBlockSyncBytes + (int64_t)warps * kWideLanes * 16 + 16 * (w + 1);
}

YT_HD int32_t block_period(int32_t w, int warps) {
    const int32_t lo = warps * (2 * kWideLanes + kBlockChunk);
    return w + 1 > lo ? w + 1 : lo;
}

YT_HD void fence_block() {
#if defined(__CUDA_ARCH__)
    __threadfence_block();
#endif
}

// A read of the sync state that every lane of a warp agrees on (on the
// card lane 0's read, handed to the others: lanes that read a word another
// warp is writing could see two values).
YT_HD int32_t warp_load(const int32_t* p) {
#if defined(__CUDA_ARCH__)
    const int32_t v = *(const volatile int32_t*)p;
    return __shfl_sync(0xffffffffu, v, 0);
#else
    return *p;
#endif
}

YT_HD void store_sync(int32_t* p, int32_t v) {
#if defined(__CUDA_ARCH__)
    *(volatile int32_t*)p = v;
#else
    *p = v;
#endif
}

// What a warp does next.
enum BlockAct { kBlockStep, kBlockWait, kBlockFold, kBlockStop };

// A warp's own schedule, the same in every lane: lane 0's strip and
// column this step, lane 31's, the producer's progress as last read, and
// whether lane 31 has just finished a strip (its fold is due).  need0 and
// base31 hold the progress lane 0's strip waits for and lane 31's strip
// publishes at their column 0 (a strip's round times W), so that a step
// divides by nothing.
struct BlockWarp {
    int32_t warps, prod, last_strip;
    int32_t s0, j0, s31, j31;
    int32_t need0, base31;
    int32_t avail;
    bool fold;

    YT_HD void init(int warp, int nwarps, const WideProblem& P) {
        warps = nwarps;
        prod = (warp + nwarps - 1) % nwarps;
        last_strip = (P.last - 1) / kWideLanes;   // the last row's strip
        s0 = s31 = warp;
        j0 = 0;
        j31 = -2 * (kWideLanes - 1);
        need0 = warp > 0 ? 0 : -P.w;   // strip -1 is no strip: no wait
        base31 = 0;
        avail = 0;
        fold = false;
    }

    YT_HD int32_t exit_strip(const BlockSync* sh) const {
        return warp_load(&sh->exit_strip);
    }

    YT_HD int next(const BlockSync* sh, const WideProblem& P) {
        // The warp's oldest strip not yet folded: lane 31's, or once its
        // fold is done, lane 0's.  Past the last row, the exit lies in an
        // earlier strip, and past the exit strip there is nothing to do.
        const int32_t cur = j31 >= P.w && !fold ? s31 + warps : s31;
        if (cur > last_strip) return kBlockStop;
        if (fold) {
            // The strip before has folded, unless the exit came first.
            if (s31 > 0 && warp_load(&sh->folded) < s31)
                return exit_strip(sh) < s31 ? kBlockStop : kBlockWait;
            fence_block();
            return exit_strip(sh) < s31 ? kBlockStop : kBlockFold;
        }
        if (j0 % kBlockChunk == 0 && exit_strip(sh) < cur) return kBlockStop;
        // Lane 0 reads column j0 + 1 of the row (and column 0 at j0 = 0)
        // from strip s0 - 1, unless there is none (s0 = 0) or it lies past
        // the last row.
        const int32_t need = j0 + 1 < P.w ? j0 + 1 : (j0 == 0 ? 0 : -1);
        if (need < 0 || need0 < 0 || s0 - 1 > last_strip) return kBlockStep;
        const int32_t target = need0 + need + 1;
        if (avail < target) {
            avail = warp_load(&sh->prog[prod]);
            if (avail < target)
                return exit_strip(sh) < cur ? kBlockStop : kBlockWait;
            fence_block();
        }
        return kBlockStep;
    }

    // After next() gave a step: how many steps from this one on it would
    // give without a look at the sync state, at least 1.  The run ends at
    // lane 0's next multiple of kBlockChunk (the exit check), at either
    // lane's strip end, after lane 31's last column (the fold), and before
    // lane 0 reads a column past the producer's progress as last read.
    YT_HD int32_t free_steps(const WideProblem& P) const {
        int32_t n = kBlockChunk - j0 % kBlockChunk;
        if (P.period - j0 < n) n = P.period - j0;
        const int32_t to31 = j31 < P.w ? P.w - j31 : P.period - j31;
        if (to31 < n) n = to31;
        // Step k reads column j0 + k + 1 while that is below W.
        if (need0 >= 0 && s0 - 1 <= last_strip && j0 + 1 < P.w) {
            const int32_t ok = avail - need0 - j0 - 1;   // steps read ready
            if (ok < n && j0 + ok + 1 < P.w) n = ok;
        }
        return n;
    }

    // Lane 31 wrote column j31 of its strip this step: whether the warp
    // publishes its progress now, and the value.
    YT_HD bool publishes(const WideProblem& P) const {
        return j31 >= 0 && j31 < P.w &&
               ((j31 + 1) % kBlockChunk == 0 || j31 == P.w - 1);
    }
    YT_HD int32_t progress() const { return base31 + j31 + 1; }

    YT_HD void advance(const WideProblem& P) {
        fold = j31 == P.w - 1;
        if (++j0 == P.period) {
            j0 = 0;
            s0 += warps;
            need0 = (s0 - 1) / warps * P.w;
        }
        if (++j31 == P.period) {
            j31 = 0;
            s31 += warps;
            base31 += P.w;
        }
    }
};

YT_HD void copy16(uint8_t* dst, const uint8_t* src) {
#if defined(__CUDA_ARCH__)
    *(uint4*)dst = *(const uint4*)src;
#else
    for (int b = 0; b < 16; b++) dst[b] = src[b];
#endif
}

// Where a lane's plane bytes of row i go: the row (null past QL), and the
// 16-byte units wholly inside it, [lo, hi).
struct BlockRow {
    uint8_t* row;
    uint8_t* lo;
    uint8_t* hi;
};

YT_HD BlockRow block_row(uint8_t* plane, int64_t ql, int32_t w, int32_t i) {
    if (i > ql) return BlockRow{nullptr, nullptr, nullptr};
    uint8_t* row = plane + (int64_t)i * w;
    return BlockRow{row, (uint8_t*)(((uintptr_t)row + 15) & ~(uintptr_t)15),
                    (uint8_t*)((uintptr_t)(row + w) & ~(uintptr_t)15)};
}

// Lane's plane byte b of its row's column j (none outside the band's
// columns): staged in the lane's 16-byte unit and stored with it when the
// unit's last byte comes, or stored alone when its unit reaches into the
// row before or after.
YT_HD void block_store(const BlockRow& R, int32_t w, int32_t j, int32_t b,
                       uint8_t* unit) {
    if (!R.row || j < 0 || j >= w) return;
    uint8_t* a = R.row + j;
    if (a < R.lo || a >= R.hi) {
        *a = (uint8_t)b;
        return;
    }
    const int o = (int)((uintptr_t)a & 15);
    unit[o] = (uint8_t)b;
    if (o == 15) copy16(a - 15, unit);
}

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

// The fold of the strip whose rows i_f (one a lane) have best cells done_v
// at done_j, after the running maximum run: the new running maximum, and
// the first lane whose row exits (-1 for none).
__device__ __forceinline__ ytsw::WideBest fold_strip(
        const ytsw::WideBest& run, int32_t done_v, int32_t done_j,
        int32_t i_f, const ytsw::WideProblem& P, int lane, int& el) {
    using namespace ytsw;
    WideBest e = {done_v, i_f, done_j};
    if (lane == 0) e = best_after(run, e);
    for (int d = 1; d < kWideLanes; d <<= 1) {
        const WideBest o = shfl_best(e, d, true);
        if (lane >= d) e = best_after(o, e);
    }
    const unsigned ex = __ballot_sync(kFull, wide_exits(done_v, e.v, i_f, P));
    el = ex ? __ffs(ex) - 1 : -1;
    return shfl_best(e, ex ? el : kWideLanes - 1, false);
}

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
    const int64_t sb = wide_stage_bytes(w);
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
                       wide_row_dst(stage, sb, lane, L.i, w));
            if (lane == kWideLanes - 1 && L.j >= 0 && L.j < w) row[L.j] = out;
            L.advance(shfl_up3(out), P);
            __syncwarp();
            if (t != fold_at) continue;
            // Lane 31 has finished strip `strip`: fold its rows in order.
            int el;
            run = fold_strip(run, L.done_v, L.done_j,
                             strip * kWideLanes + lane + 1, P, lane, el);
            copy_share(lane, plane + ((int64_t)strip * kWideLanes + 1) * w,
                       (int64_t)(el < 0 ? kWideLanes : el + 1) * w,
                       StageSrc{stage + (strip & 1) * sb});
            if (el >= 0) {
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

// A block of blockDim.x / 32 warps a problem (see the top of the file).
__global__ void __launch_bounds__(ytsw::kWideLanes * ytsw::kBlockMaxWarps)
ext_block_kernel(const uint8_t* q, int64_t ql, const uint8_t* r, int64_t rl,
                 const int32_t* qlens, const int32_t* rlens, int32_t bw2,
                 ytsw::Scoring s, int32_t x_cutoff, int8_t* bt,
                 int32_t* score, int32_t* maxi, int32_t* maxj) {
    using namespace ytsw;
    extern __shared__ __align__(16) uint8_t smem[];
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int warps = nt / kWideLanes;
    const int lane = tid % kWideLanes;
    const int warp = tid / kWideLanes;
    const int64_t p = blockIdx.x;
    WideProblem P;
    P.init(p, q, ql, r, rl, qlens, rlens, bw2, s, x_cutoff);
    P.period = block_period(P.w, warps);
    const int32_t w = P.w;
    BlockSync* sh = (BlockSync*)smem;
    uint8_t* unit = smem + kBlockSyncBytes + (int64_t)tid * 16;
    Band3* row = (Band3*)(smem + kBlockSyncBytes +
                          (int64_t)warps * kWideLanes * 16);
    uint8_t* plane = (uint8_t*)bt + p * (ql + 1) * w;

    for (int32_t c = tid; c <= w; c += nt) row[c] = wide_row0(c, bw2, w, s);
    if (tid < kBlockMaxWarps) sh->prog[tid] = 0;
    if (tid == 0) {
        sh->folded = 0;
        sh->exit_strip = kNoExit;
        sh->exit_row = 0;
        sh->run_v = DP_WORST;
        sh->run_i = sh->run_j = 0;
    }
    copy_share(tid, plane, w, FillSrc{0, w, bw2}, nt);
    __syncthreads();
    if (P.last >= 1) {
        BlockWarp B;
        B.init(warp, warps, P);
        WideLane L;
        L.init(lane);
        L.i += warp * kWideLanes;
        BlockRow R = {nullptr, nullptr, nullptr};
        // The codes of the lane's next cell, loaded a step ahead.
        int32_t qn = L.j == 0 ? P.query_code(L.i) : 0;
        int32_t rn = P.ref_code(L.i, L.j);
        for (;;) {
            const int act = B.next(sh, P);
            if (act == kBlockStop) break;
            if (act == kBlockWait) continue;
            if (act == kBlockFold) {
                const WideBest prev =
                    B.s31 == 0 ? WideBest{DP_WORST, 0, 0}
                               : WideBest{warp_load(&sh->run_v),
                                          warp_load(&sh->run_i),
                                          warp_load(&sh->run_j)};
                int el;
                const WideBest run = fold_strip(
                    prev, L.done_v, L.done_j,
                    B.s31 * kWideLanes + lane + 1, P, lane, el);
                if (lane == 0) {
                    sh->run_v = run.v;
                    sh->run_i = run.i;
                    sh->run_j = run.j;
                    if (el >= 0) {
                        sh->exit_row = B.s31 * kWideLanes + el + 1;
                        sh->exit_strip = B.s31;
                    }
                    __threadfence_block();
                    store_sync(&sh->folded, B.s31 + 1);
                }
                __syncwarp();
                if (el >= 0) break;
                B.fold = false;
                continue;
            }
            // The steps that need no look at the sync state, in one run.
            const int32_t run = B.free_steps(P);
            for (int32_t k = 0; k < run; k++) {
                const int32_t qc = qn, rc = rn;
                {   // the next cell's codes
                    const bool wrap = L.j + 1 == P.period;
                    const int32_t ni = wrap ? L.i + warps * kWideLanes : L.i;
                    const int32_t nj = wrap ? 0 : L.j + 1;
                    qn = nj == 0 ? P.query_code(ni) : 0;
                    rn = P.ref_code(ni, nj);
                }
                if (lane == 0) L.take_row(row, P);
                int32_t b;
                const Band3 out = L.cell_step(P, qc, rc, b);
                if (L.j == 0) R = block_row(plane, ql, w, L.i);
                block_store(R, w, L.j, b, unit);
                if (lane == kWideLanes - 1 && L.j >= 0 && L.j < w) {
                    row[L.j] = out;
                    if (B.publishes(P)) {
                        __threadfence_block();
                        store_sync(&sh->prog[warp], B.progress());
                    }
                }
                L.advance(shfl_up3(out), P, warps * kWideLanes);
                B.advance(P);
                __syncwarp();
            }
        }
    }
    __syncthreads();
    const int32_t exit_row = sh->exit_row;
    const int64_t x0 = ((int64_t)exit_row + 1) * w;
    copy_share(tid, plane + x0, (ql + 1) * w - x0, FillSrc{x0, w, bw2}, nt);
    if (tid == 0) {
        score[p] = sh->run_v;
        maxi[p] = sh->run_i;
        maxj[p] = sh->run_j;
    }
}

cudaError_t set_smem(const void* kernel, int64_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// The extension for W = 2*bw2 + 1 whose warp fits a block's shared memory
// (up to W 2,829, -BW 707), a warp (a block) a problem; yt_ext_forward_block
// for the extension by a block of warps a problem, at any W whose row fits
// (up to W 14,267, -BW 3,566).  Each launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError(),
// or cudaErrorInvalidValue for a band too wide for its kernel.
int yt_ext_forward_wide(const uint8_t* q, const uint8_t* r,
                        const int32_t* qlens, const int32_t* rlens,
                        int64_t n, int64_t ql, int64_t rl, int32_t bw2,
                        int32_t go, int32_t ge, int32_t rc, int32_t ms,
                        int32_t max_gap, int32_t max_intron, int32_t x_cutoff,
                        int8_t* bt, int32_t* score, int32_t* maxi,
                        int32_t* maxj, void* stream) {
    const int64_t w = 2 * (int64_t)bw2 + 1;
    const int64_t smem = ytsw::wide_warp_bytes(w);
    if (bw2 < 0 || smem > ytsw::kWideSmemMax)
        return (int)cudaErrorInvalidValue;
    const cudaError_t e = set_smem((const void*)ext_wide_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    ytsw::Scoring s;
    s.go = go;
    s.ge = ge;
    s.rc = rc;
    s.ms = ms;
    s.max_gap = max_gap;
    s.max_intron = max_intron;
    ext_wide_kernel<<<(unsigned)n, ytsw::kWideLanes, (size_t)smem,
                      (cudaStream_t)stream>>>(q, ql, r, rl, qlens, rlens, bw2,
                                              s, x_cutoff, bt, score, maxi,
                                              maxj);
    return (int)cudaGetLastError();
}

int yt_ext_forward_block(const uint8_t* q, const uint8_t* r,
                         const int32_t* qlens, const int32_t* rlens,
                         int64_t n, int64_t ql, int64_t rl, int32_t bw2,
                         int32_t go, int32_t ge, int32_t rc, int32_t ms,
                         int32_t max_gap, int32_t max_intron,
                         int32_t x_cutoff, int8_t* bt, int32_t* score,
                         int32_t* maxi, int32_t* maxj, void* stream) {
    const int warps = ytsw::kBlockWarps;
    const int64_t w = 2 * (int64_t)bw2 + 1;
    const int64_t smem = ytsw::ext_block_bytes(w, warps);
    if (bw2 < 0 || smem > ytsw::kWideSmemMax)
        return (int)cudaErrorInvalidValue;
    const cudaError_t e = set_smem((const void*)ext_block_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    ytsw::Scoring s;
    s.go = go;
    s.ge = ge;
    s.rc = rc;
    s.ms = ms;
    s.max_gap = max_gap;
    s.max_intron = max_intron;
    ext_block_kernel<<<(unsigned)n, warps * ytsw::kWideLanes, (size_t)smem,
                       (cudaStream_t)stream>>>(q, ql, r, rl, qlens, rlens,
                                               bw2, s, x_cutoff, bt, score,
                                               maxi, maxj);
    return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
