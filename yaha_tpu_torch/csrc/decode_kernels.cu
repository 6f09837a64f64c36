// Hopper (sm_90a) kernel of the staged engine's device backtrack walk.
//
// yt_rle_walk replaces decode_jax.rle_decode_band and rle_decode_full
// (yaha_tpu/ops/decode_jax.py:208, :222): it walks each problem's packed
// backtrack plane (anch_kernels.cu, ext_kernels.cu, ext_wide_kernels.cu)
// on the device and writes only the run-length items, int32 op << 28 |
// len, so the planes never leave the card.  The walk is the native packed-plane walker's
// (ops/dp_common.py traceback_*_packed, SW.cpp:1137-1195):
//
//   band layout (extension and band-relative gap planes):
//     match/replace (y-1, x), delete run (y, x-L), insert run (y-L, x+L);
//   full layout (full-width gap planes):
//     match/replace (y-1, x-1), delete run (y, x-L), insert run (y-L, x);
//
// a delete run chases BT_CD left along the row and an insert run chases
// BT_CF up its chain, so every run is consumed whole whatever its length;
// consecutive equal ops merge.  Items go out in walk order (from the start
// cell backwards), unreversed, to rle[p][0, cap); the native FMT_RLE apply
// reverses them where the plane walkers do.  Contracts the host relies on:
// an inactive walk, or one whose start cell is OP_UNKNOWN, emits nothing
// (n_ops = 0); a walk that needs more than `cap` items writes its first
// cap items and n_ops = -1; slots past min(n_ops, cap) are not written (the
// wrapper does not clear them).  A cell outside the plane reads as
// OP_UNKNOWN, so a walk always ends: every step lowers y * (w + 1) + x.
//
// The TPU version's jump plane (capped at 255 cells), time-major emission
// buffer with sort compaction and slice plan exist because the TPU
// vectorises over problems; here a team of lanes owns one problem.
//
// What bounds it on an H100: the longest walk's chain of dependent plane
// reads (about a thousand rows at the 1 kb bucket, a few dozen on
// average), not bytes: a walk reads one byte per cell.  Read straight from
// device memory, as the first version (one thread per problem) did, each
// step waits a device-memory round trip, since a bucket's planes (352 MB
// at the 1 kb bucket) are far larger than L2.  This kernel uses the walk's
// order instead: every in-plane read lies at a lower address than the one
// before it, so the bytes below the current cell are all the walk can need
// next.  A team of T lanes (8, 16 or 32) owns a problem:
//
//   * it copies S bytes of the plane that end at the current cell into
//     shared memory (16 bytes a lane, cp.async), and the window below is
//     already in flight (double buffering), so a round trip is paid about
//     once per S / row-width rows, not once per step;
//   * every lane follows the same walk, and a run (a match or replace run
//     up its column or diagonal, a delete run along its row, an insert run
//     up its chain) is scanned T cells at a time, a cell a lane, with one
//     ballot for where it ends: the dependent chain is one step per run of
//     up to T cells, not one per cell;
//   * item k is held by lane k % T in a register, and the team stores T
//     items at a time.
//
// The walk (rle_walk_cells), the window reader with its refill arithmetic
// and run scan, and the item store are __host__ __device__: without
// __CUDACC__ they compile with g++, a plain copy in place of cp.async and
// a loop over the team's lanes in place of the ballot, so the CPU tests
// hold them to the plain version.
#include <string.h>

#include "sw_cells.cuh"

namespace ytsw {

YT_HD int32_t rle_item(int32_t op, int64_t run) {
    return (int32_t)(((uint32_t)op << 28) | ((uint32_t)run & 0x0FFFFFFFu));
}

// The walk from (y, x) over the cells of reader rd: rd.at(y, x) reads a
// cell, rd.scan(y, x, dy, dx, mask, want, k) counts the cells (y, x),
// (y + dy, x + dx), ... that hold (cell & mask) == want before the first
// that does not (the first k known to).  A match or replace run of one
// code is one item whatever its length, so it is taken whole, as the
// delete and insert runs are.  Item k goes to em.put(k, item) for
// k < cap, and em.finish(min(count, cap)) ends it.  Returns the item count
// (which may exceed cap).
template <bool kFull, class Reader, class Emit>
YT_HD int64_t rle_walk_cells(Reader& rd, int64_t y, int64_t x, bool live,
                             int64_t cap, Emit& em) {
    int64_t cnt = 0, run = 0;
    int32_t prev = OP_UNKNOWN;
    while (live) {
        const int32_t code = rd.at(y, x) & 7;
        if (code == OP_UNKNOWN) break;
        int64_t len;
        if (code == OP_DELETE) {
            len = 1 + rd.scan(y, x, 0, -1, BT_CD, BT_CD, 0);
            x -= len;
        } else if (code == OP_INSERT) {
            len = 1 + rd.scan(y, x, -1, kFull ? 0 : 1, BT_CF, BT_CF, 0);
            y -= len;
            if (!kFull) x += len;
        } else {
            len = rd.scan(y, x, -1, kFull ? -1 : 0, 7, code, 1);
            y -= len;
            if (kFull) x -= len;
        }
        if (code == prev) {
            run += len;
            continue;
        }
        if (prev != OP_UNKNOWN) {
            if (cnt < cap) em.put(cnt, rle_item(prev, run));
            cnt++;
        }
        prev = code;
        run = len;
    }
    if (prev != OP_UNKNOWN) {
        if (cnt < cap) em.put(cnt, rle_item(prev, run));
        cnt++;
    }
    em.finish(cnt < cap ? cnt : cap);
    return cnt;
}

YT_HD int ctz32(uint32_t v) {  // v != 0
#if defined(__CUDA_ARCH__)
    return __ffs(v) - 1;
#else
    return __builtin_ctz(v);
#endif
}

// Reads cells from windows of the plane in shared memory, for a team of T
// lanes.  A window is S bytes (a power of two, at least 16) at an
// S-aligned address; `cur` holds the window at address lo, `nxt` the one
// below it (lo - S) when `ahead`.  Only bytes of the problem's own plane
// [plo, phi) are copied: a 16-byte chunk inside it whole goes as one copy
// (Copy::copy16: cp.async on the card), a chunk that straddles its edge
// byte by byte, and the rest of the window is never read.  The walk reads
// ever lower addresses, so a read below the current window moves to the
// window below it (already fetched) or, after a jump past it, refills the
// current window and waits for it; either way the window below the new one
// is then fetched ahead.  Every lane of the team makes the same calls.
template <class Copy, int T>
struct WindowReader {
    int64_t h, w;
    uintptr_t plo, phi, S, lo;
    uint8_t* cur;
    uint8_t* nxt;
    bool ahead;
    Copy cp;

    YT_HD void init(const int8_t* pl_, int64_t h_, int64_t w_, uint8_t* smem,
                    int64_t s_, Copy cp_) {
        h = h_;
        w = w_;
        plo = (uintptr_t)pl_;
        phi = plo + (uintptr_t)(h_ * w_);
        S = (uintptr_t)s_;
        lo = ~(uintptr_t)0;  // no window yet: the first read fills one
        cur = smem;
        nxt = smem + s_;
        ahead = false;
        cp = cp_;
    }

    // Copy the plane's bytes of the window at address wa into dst.
    YT_HD void fill(uint8_t* dst, uintptr_t wa) {
        for (uintptr_t c = (uintptr_t)cp.lane * 16; c < S;
             c += (uintptr_t)cp.lanes * 16) {
            const uintptr_t a = wa + c;
            if (a >= plo && a + 16 <= phi) {
                cp.copy16(dst + c, (const uint8_t*)a);
            } else if (a + 16 > plo && a < phi) {
                for (uintptr_t b = 0; b < 16; b++)
                    if (a + b >= plo && a + b < phi)
                        dst[c + b] = *(const uint8_t*)(a + b);
            }
        }
    }

    YT_HD void advance(uintptr_t a) {
        const uintptr_t wa = a & ~(S - 1);
        cp.wait();
        if (ahead && wa == lo - S) {
            uint8_t* t = cur;
            cur = nxt;
            nxt = t;
        } else {
            fill(cur, wa);
            cp.wait();
        }
        lo = wa;
        ahead = wa > plo;
        if (ahead) fill(nxt, wa - S);
    }

    YT_HD bool inside(int64_t y, int64_t x) const {
        return y >= 0 && y < h && x >= 0 && x < w;
    }

    YT_HD uintptr_t addr(int64_t y, int64_t x) const {
        return plo + (uintptr_t)(y * w + x);
    }

    YT_HD int32_t at(int64_t y, int64_t x) {
        if (!inside(y, x)) return OP_UNKNOWN;
        const uintptr_t a = addr(y, x);
        if (a < lo) advance(a);
        return (int32_t)cur[a - lo];
    }

    // A scan at cell (y, x): 0 where it goes on, 1 where it stops (outside
    // the plane, or (cell & mask) != want), 3 where the cell lies below the
    // window, so that it is not known yet.
    YT_HD int stop_at(int64_t y, int64_t x, int32_t mask, int32_t want) const {
        if (!inside(y, x)) return 1;
        const uintptr_t a = addr(y, x);
        if (a < lo) return 3;
        return ((int32_t)cur[a - lo] & mask) == want ? 0 : 1;
    }

    // The cells (y, x) + i (dy, dx), i = 0, 1, ..., that hold
    // (cell & mask) == want before the first that does not, the first k
    // known to: T cells a round, lane i testing cell k + i (lanes of the
    // host build in a loop), and the first stop ends it unless it only
    // lies below the window, which the next round moves to.
    YT_HD int64_t scan(int64_t y, int64_t x, int64_t dy, int64_t dx,
                       int32_t mask, int32_t want, int64_t k) {
        for (;;) {
            const int64_t yk = y + k * dy, xk = x + k * dx;
            if (inside(yk, xk) && addr(yk, xk) < lo) advance(addr(yk, xk));
            uint32_t stop = 0, below = 0;
#if defined(__CUDA_ARCH__)
            const int s = stop_at(yk + cp.lane * dy, xk + cp.lane * dx, mask,
                                  want);
            stop = cp.ballot(s & 1);
            below = cp.ballot(s >> 1);
#else
            for (int i = 0; i < T; i++) {
                const int s = stop_at(yk + i * dy, xk + i * dx, mask, want);
                stop |= (uint32_t)(s & 1) << i;
                below |= (uint32_t)(s >> 1) << i;
            }
#endif
            if (!stop) {
                k += T;
                continue;
            }
            const int f = ctz32(stop);
            k += f;
            if (!((below >> f) & 1)) return k;
        }
    }
};

// Items of a team of T lanes: item k is held by lane k % T (in a register
// on the card) and every T items the team stores them together.
template <int T>
struct TeamEmit {
    int32_t* out;
    int lane;
#if defined(__CUDA_ARCH__)
    int32_t mine;
#else
    int32_t buf[T];
#endif

    YT_HD void keep(int64_t k, int32_t item) {
#if defined(__CUDA_ARCH__)
        if ((int)(k & (T - 1)) == lane) mine = item;
#else
        buf[k & (T - 1)] = item;
#endif
    }

    // Store the held items of slots [k0, k0 + cnt).
    YT_HD void store(int64_t k0, int cnt) {
#if defined(__CUDA_ARCH__)
        if (lane < cnt) out[k0 + lane] = mine;
#else
        for (int l = 0; l < cnt; l++) out[k0 + l] = buf[l];
#endif
    }

    YT_HD void put(int64_t k, int32_t item) {
        keep(k, item);
        if ((k & (T - 1)) == T - 1) store(k - (T - 1), T);
    }

    YT_HD void finish(int64_t stored) {
        const int r = (int)(stored & (T - 1));
        if (r) store(stored - r, r);
    }
};

// Problem p walked by a team of T lanes from windows of S bytes in `smem`
// (2 * S bytes, 16-byte aligned); cp.lane is the caller's lane in the team.
template <bool kFull, int T, class Copy>
YT_HD void rle_walk_window(int64_t p, const int8_t* bt, int64_t h, int64_t w,
                           const int32_t* y0, const int32_t* x0,
                           const uint8_t* active, int64_t cap, int32_t* rle,
                           int32_t* n_ops, uint8_t* smem, int64_t S,
                           Copy cp) {
    WindowReader<Copy, T> rd;
    rd.init(bt + p * h * w, h, w, smem, S, cp);
    TeamEmit<T> em;
    em.out = rle + p * cap;
    em.lane = cp.lane;
    const int64_t cnt = rle_walk_cells<kFull>(rd, y0[p], x0[p],
                                              active[p] != 0, cap, em);
    rd.cp.wait();  // no copy into the window may outlive the walk
    if (cp.lane == 0) n_ops[p] = cnt > cap ? -1 : (int32_t)cnt;
}

// The copy of a host build: one lane copies, plainly, and nothing waits.
struct HostCopy {
    int lane, lanes;
    YT_HD void copy16(uint8_t* dst, const uint8_t* src) {
        memcpy(dst, src, 16);
    }
    YT_HD void wait() {}
};

}  // namespace ytsw

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

constexpr int kTeamsPerBlock = 4;

// The team of lanes [base, base + lanes) of a warp (mask): copies 16-byte
// chunks with cp.async (global -> shared, bypassing L1); wait() waits for
// this lane's copies and then for the team, so every lane sees every
// lane's bytes; ballot() is the team's bits of a warp ballot.
struct TeamCopy {
    int lane, lanes, base;
    unsigned mask;
    YT_HD void copy16(uint8_t* dst, const uint8_t* src) {
#if defined(__CUDA_ARCH__)
        const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                     "l"(src)
                     : "memory");
#endif
    }
    YT_HD void wait() {
#if defined(__CUDA_ARCH__)
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp(mask);
#endif
    }
    YT_HD uint32_t ballot(int pred) const {
#if defined(__CUDA_ARCH__)
        const uint32_t b = __ballot_sync(mask, pred) >> base;
        return lanes == 32 ? b : b & ((1u << lanes) - 1u);
#else
        return 0;
#endif
    }
};

// With no minimum of blocks per SM ptxas kept the team-16 and team-32
// instances at 48 registers and spilled the walk's state; naming one block
// lets them take the 52-64 they need.
template <bool kFull, int T>
__global__ void __launch_bounds__(kTeamsPerBlock * T, 1)
rle_win_kernel(int64_t n, const int8_t* bt, int64_t h, int64_t w,
               const int32_t* y0, const int32_t* x0, const uint8_t* active,
               int64_t cap, int32_t* rle, int32_t* n_ops, int64_t S) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int team = threadIdx.x / T;
    const int lane = threadIdx.x % T;
    const int64_t p = blockIdx.x * (int64_t)kTeamsPerBlock + team;
    if (p >= n) return;  // the whole team leaves together
    TeamCopy cp;
    cp.lane = lane;
    cp.lanes = T;
    cp.base = (threadIdx.x & 31) & ~(T - 1);
    cp.mask = T == 32 ? 0xffffffffu : ((1u << T) - 1u) << cp.base;
    ytsw::rle_walk_window<kFull, T>(p, bt, h, w, y0, x0, active, cap, rle,
                                    n_ops, smem + team * 2 * S, S, cp);
}

template <bool kFull, int T>
int launch_win(int64_t n, const int8_t* bt, int64_t h, int64_t w,
               const int32_t* y0, const int32_t* x0, const uint8_t* active,
               int64_t cap, int32_t* rle, int32_t* n_ops, int64_t S,
               cudaStream_t st) {
    const size_t smem = (size_t)kTeamsPerBlock * 2 * S;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            rle_win_kernel<kFull, T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int64_t grid = (n + kTeamsPerBlock - 1) / kTeamsPerBlock;
    rle_win_kernel<kFull, T><<<(unsigned)grid, kTeamsPerBlock * T, smem,
                               st>>>(n, bt, h, w, y0, x0, active, cap, rle,
                                     n_ops, S);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// full != 0 walks full-layout planes, else band-layout ones, by teams of
// `team` lanes (8, 16 or 32) with windows of `window` bytes (a power of
// two, 16 to 16384).  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError(), or cudaErrorInvalidValue for a
// team or window it does not take.
int yt_rle_walk(const int8_t* bt, int64_t n, int64_t h, int64_t w,
                const int32_t* y0, const int32_t* x0, const uint8_t* active,
                int64_t cap, int32_t full, int32_t* rle, int32_t* n_ops,
                int32_t team, int64_t window, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (window < 16 || window > 16384 || (window & (window - 1)))
        return (int)cudaErrorInvalidValue;
#define YT_WALK_TEAM(t)                                                    \
    case t:                                                                \
        return full ? launch_win<true, t>(n, bt, h, w, y0, x0, active, cap, \
                                          rle, n_ops, window, st)          \
                    : launch_win<false, t>(n, bt, h, w, y0, x0, active,    \
                                           cap, rle, n_ops, window, st);
    switch (team) {
        YT_WALK_TEAM(8)
        YT_WALK_TEAM(16)
        YT_WALK_TEAM(32)
    }
#undef YT_WALK_TEAM
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"

#endif  // __CUDACC__
