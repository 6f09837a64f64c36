// Hopper (sm_90a) kernels of the device seed phase (--seed device).
//
// seed_hash_kernel<WL> replaces seeds_jax.batched_seed_hashes
// (yaha_tpu/ops/seeds_jax.py:30): for every window p < L - wl + 1 of a
// [B, L] u8 strand-row batch, the 2-bit rolling k-mer hash (int32, wl <= 15)
// and a clean flag (p <= len - wl and no code above 3 in the window); the
// hash is 0 where the window is not clean.  What bounds it on an H100:
// bytes (the rows in, five bytes a window out); it is one elementwise pass.
// Each thread takes a run of 16 consecutive windows of the flat [B * N]
// output (seed_hash_run): it reads the 16 + wl - 1 codes of the run as
// aligned 16-byte loads, lines them up in registers with byte_perm, rolls
// the hash and a shift register of bad codes over them (the word length is
// a template parameter, so every byte's register and every output's step
// are known at compile time), and stores the 16 hashes as four 16-byte
// stores and the 16 flags as one.  A run that crosses a row's end (N need
// not be a multiple of 16) rolls a second time from the next row's first
// window; runs at the batch's end, or in rows of fewer than 16 windows,
// take one window at a time (seed_hash_window).  The first design read
// every code wl times with single-byte loads and stored five bytes a
// thread.
//
// expand_sort_kernel replaces seeds_jax.expand_sort_hits_device
// (:63): per strand row, the SO run of every clean window (so[h],
// so[h+1] - so[h] as uint32), kept when 0 < count <= max_hits; the row's
// kept counts summed in window order (the int32 wrap of the JAX cumsum);
// hit slot t < C of the row belongs to the window whose run covers it (the
// searchsorted-right of the JAX program) and holds (diag, qo) = (ro - w as
// uint32, w) with ro = roa[so_lo + rank]; slots past the row's total hold
// the sentinel (0xFFFFFFFF, 0x7FFFFFFF); the C slots sorted by (diag
// uint32, qo); total, overflow = total > C, the wrapped flag of each window
// (kept, and no slot of its run below C has ro >= w: the prefix-sum formula
// of the JAX program, clipped to C, so windows whose run starts at or past
// C read as wrapped) and allwrapped = any(wrapped).
//
// One block of kSeedThreads threads a row; what bounds it on an H100 is
// bytes (the [B, C] output planes, the hashes, the gathered SO and ROA
// words), and the SO words are random reads of a 4 GB table at L15, so
// what the design is about is latency.  The first design (a chunk of 256
// windows at a time, a thread expanding its window's whole run, a bitonic
// sort in shared memory with a barrier a step) paid each of these in turn;
// this one:
//   * reads the windows in batches of kBatch (1,024, the whole row at
//     N <= 1,024): each thread loads the hashes and the SO pairs of its
//     four consecutive windows together, so all of a batch's SO reads are
//     in flight at once, and one block scan of the per-thread sums gives
//     every window's start (one scan a batch, not one a 256 windows);
//   * expands the batch's slots below C evenly: the inclusive starts and
//     the run starts go to shared memory, and the threads walk the slots
//     in stride, each finding its window by a binary search
//     (slot_window), so every thread writes the same number of keys and
//     neighbouring threads read neighbouring ROA words of a run (the
//     first design waited on the row's longest run, up to 650 ROA reads
//     in a row by one thread).  The ROA reads of a thread's four slots
//     are issued before any key is formed.  A slot with ro >= w sets its
//     window's bit in shared memory; a kept window without its bit is
//     wrapped;
//   * sorts only what the row needs: P = max(pow2(min(total, C)), 256)
//     keys in shared memory (none below 2 hits), the rest the sentinel,
//     by one bitonic network whose strides below 256 run in registers and
//     lane shuffles, 8 keys a thread over the first P / 8 threads (a warp
//     holds 256 neighbouring keys), and only the strides of 256 and more
//     step through shared memory, a barrier each: 7 barriers at P = 1,024
//     and 22 at 8,192, where the first design had 55 and 91, and a row of
//     up to 256 keys is sorted by one warp with no barrier between stages.
// What each costs (chip_smoke phase 6's breakdown, PERF.md section 6): at
// C = 1,024 the random SO reads take most of the time, and the expansion
// and sort, nearly as long on their own, run largely in their shadow; at
// C = 8,192 (a few hundred rows) the expansion and sort are nearly all of
// it.  A thread's 8 keys lie 64 bytes from its neighbour's, so the sort's
// register passes load them with bank conflicts; a layout free of them
// cost 17 registers a thread, and so a block an SM at C = 1,024, more
// than it saved there.
// The unsigned 64-bit keys diag << 32 | qo keep the uint32 order of diag
// (hits with ro < qo have diag >= 2^31) and put a valid hit with diag =
// 0xFFFFFFFF before the sentinel by its qo.  Shared memory holds max(C,
// 256) keys (64 KB at C = 8,192, as dynamic shared memory past 48 KB).
//
// Over a hash-range sharded index (yaha_tpu_torch/parallel/mesh.py) the
// same kernel runs once a model shard: it takes the shard's range
// [hash_lo, hash_lo + per) and its SO rebased to offsets into its own ROA
// slice, and keeps only the windows whose hash lies in the range (the
// range mask of yaha_tpu/parallel/mesh.py:157-169).  The whole index is
// hash_lo = 0, per = 4^wl, which keeps every clean window as before.
//
// merge_runs_kernel replaces the all_gather over `model` and the sort of
// the gathered buffers (yaha_tpu/parallel/mesh.py:204-213): the M shards'
// [b, C] rows, each sorted, become one sorted [b, M C] row.  A block a
// row; each element's slot is its index plus, for every other shard, the
// number of that shard's keys that sort before it (a binary search of
// log2(C) + 1 probes; ties go to the lower shard), so every element costs
// the same and nothing is sorted again.  What bounds it on an H100 is bytes
// (the shards' rows in, the merged rows out); the probes read the row's
// other runs, which stay in L1.
//
// The per-run and per-window bodies (seed_hash_run, seed_hash_window,
// window_run, slot_window, slot_key, merge_element) and the sort's
// compare-exchange math (bitonic_keeps_min, bitonic_low, reg_steps,
// smem_step, keep, sort_span)
// are __host__ __device__, so the CPU tests build them with g++ and, with
// a sequential scan and the shuffles emulated, hold them to the plain
// versions.
#include <string.h>

#include "sw_cells.cuh"

namespace ytsw {

constexpr uint64_t kSeedSentinel = (0xFFFFFFFFull << 32) | 0x7FFFFFFFull;
// Windows a thread hashes; windows of a row an expansion batch takes.
constexpr int kHashRun = 16;
constexpr int kSeedThreads = 256;
constexpr int kWinPerThread = 4;
constexpr int kBatch = kSeedThreads * kWinPerThread;
// Keys a thread of the sort holds in registers, and a warp's share.
constexpr int kRegKeys = 8;
constexpr int64_t kWarpKeys = 32 * kRegKeys;

// The hash and clean flag of window p of a strand row of length len.
YT_HD void seed_hash_window(const uint8_t* row, int64_t len, int32_t wl,
                            int64_t p, int32_t* hash, uint8_t* clean) {
    uint32_t h = 0;
    bool ok = p <= len - wl;
    for (int32_t i = 0; i < wl; i++) {
        const uint32_t c = (uint32_t)ld_u8(row + p + i);
        ok = ok && c <= 3;
        h = (h << 2) | c;
    }
    *hash = ok ? (int32_t)h : 0;
    *clean = ok ? 1 : 0;
}

// The 16 bytes at the 16-byte aligned address p, as four words.
YT_HD void ld_chunk(const uint8_t* p, uint32_t out[4]) {
#if defined(__CUDA_ARCH__)
    const uint4 v = __ldg((const uint4*)p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
#else
    memcpy(out, p, 16);
#endif
}

// Roll 16 windows of WL codes over the 16 + WL - 1 codes at abs (an
// offset from the 16-byte aligned base; abs + 16 + WL - 2 is the last code
// needed, and only the aligned chunks that hold a needed code are read).
// Window j's hash goes to h[j] (before the clean test) and its bad-code
// test to bit j of the returned mask.
template <int WL>
YT_HD uint32_t roll16(const uint8_t* base, int64_t abs, uint32_t h[16]) {
    constexpr int kBytes = kHashRun + WL - 1;           // <= 30
    const int64_t c0 = abs & ~(int64_t)15;
    const int64_t last = abs + kBytes - 1;
    uint32_t w[12];
#pragma unroll
    for (int c = 0; c < 3; c++) {
        if (c0 + 16 * c <= last) {
            ld_chunk(base + c0 + 16 * c, w + 4 * c);
        } else {
            w[4 * c] = w[4 * c + 1] = w[4 * c + 2] = w[4 * c + 3] = 0;
        }
    }
    // Line the codes up: a[k] holds codes 4k .. 4k+3 of the run.
    const int sh = (int)(abs & 15);
    const int q = sh >> 2;
    const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)(sh & 3);
    uint32_t a[8];
#pragma unroll
    for (int k = 0; k < 8; k++) {
        const uint32_t x = q == 0 ? w[k] : q == 1 ? w[k + 1]
                         : q == 2 ? w[k + 2] : w[k + 3];
        const uint32_t y = q == 0 ? w[k + 1] : q == 1 ? w[k + 2]
                         : q == 2 ? w[k + 3] : w[k + 4];
        a[k] = byte_perm(x, y, sel);
    }
    constexpr uint32_t kMask = (uint32_t)((1ull << (2 * WL)) - 1);
    constexpr uint32_t kWin = (1u << WL) - 1;
    uint32_t hv = 0, bad = 0, badmask = 0;
#pragma unroll
    for (int i = 0; i < kBytes; i++) {
        const uint32_t c = (a[i >> 2] >> (8 * (i & 3))) & 0xFF;
        hv = ((hv << 2) | (c & 3)) & kMask;
        bad = (bad << 1) | (c > 3 ? 1u : 0u);
        if (i >= WL - 1) {
            h[i - (WL - 1)] = hv;
            if (bad & kWin) badmask |= 1u << (i - (WL - 1));
        }
    }
    return badmask;
}

// Flat windows k0 .. k0+15 of a [b, n] output (n = l - WL + 1) over the
// [b, l] rows at codes: hashes and clean flags.  hashes + k0 and clean +
// k0 are 16-byte aligned (k0 a multiple of 16, the arrays aligned).
template <int WL>
YT_HD void seed_hash_run(const uint8_t* codes, int64_t b, int64_t l,
                         const int32_t* lengths, int64_t k0,
                         int32_t* hashes, uint8_t* clean) {
    const int64_t n = l - WL + 1;
    const int64_t total = b * n;
    if (k0 >= total) return;
    const int64_t row0 = k0 / n;
    const int64_t p0 = k0 - row0 * n;
    if (k0 + kHashRun > total || n < kHashRun) {
        const int64_t end = k0 + kHashRun < total ? k0 + kHashRun : total;
        for (int64_t k = k0; k < end; k++) {
            const int64_t row = k / n;
            seed_hash_window(codes + row * l, lengths[row], WL, k - row * n,
                             hashes + k, clean + k);
        }
        return;
    }
    // At most one row end inside the run: windows j >= jb lie in row0 + 1,
    // and window j starts at s0 + j + WL - 1 there.
    const uint8_t* base = (const uint8_t*)((uintptr_t)codes &
                                           ~(uintptr_t)15);
    const int64_t s0 = (int64_t)(codes - base) + row0 * l + p0;
    const int64_t jb = n - p0;
    uint32_t h[16];
    uint32_t bad = roll16<WL>(base, s0, h);
    const int64_t len0 = lengths[row0];
    uint32_t hv[16];
    uint8_t cl[16];
    if (jb < kHashRun) {
        uint32_t h2[16];
        const uint32_t bad2 = roll16<WL>(base, s0 + WL - 1, h2);
        const int64_t len1 = lengths[row0 + 1];
#pragma unroll
        for (int j = 0; j < kHashRun; j++) {
            const bool next = j >= jb;
            const bool ok = !((next ? bad2 : bad) >> j & 1) &&
                            (next ? j - jb <= len1 - WL
                                  : p0 + j <= len0 - WL);
            hv[j] = ok ? (next ? h2[j] : h[j]) : 0;
            cl[j] = ok ? 1 : 0;
        }
    } else {
#pragma unroll
        for (int j = 0; j < kHashRun; j++) {
            const bool ok = !(bad >> j & 1) && p0 + j <= len0 - WL;
            hv[j] = ok ? h[j] : 0;
            cl[j] = ok ? 1 : 0;
        }
    }
#if defined(__CUDA_ARCH__)
    uint4* ho = (uint4*)(hashes + k0);
#pragma unroll
    for (int v = 0; v < 4; v++)
        ho[v] = make_uint4(hv[4 * v], hv[4 * v + 1], hv[4 * v + 2],
                           hv[4 * v + 3]);
    uint32_t cw[4];
#pragma unroll
    for (int v = 0; v < 4; v++)
        cw[v] = (uint32_t)cl[4 * v] | (uint32_t)cl[4 * v + 1] << 8 |
                (uint32_t)cl[4 * v + 2] << 16 | (uint32_t)cl[4 * v + 3] << 24;
    *(uint4*)(clean + k0) = make_uint4(cw[0], cw[1], cw[2], cw[3]);
#else
    memcpy(hashes + k0, hv, sizeof(hv));
    memcpy(clean + k0, cl, sizeof(cl));
#endif
}

// A window's SO run in the shard that owns hashes [hash_lo, hash_lo +
// per), whose SO (so[0 .. per]) holds offsets into its own ROA: its kept
// count (0 unless clean, in the shard's range and 0 < count <= max_hits;
// the count is the uint32 difference read as int32) and start.  The whole
// index is the shard hash_lo = 0, per = 4^wl.  Both SO words are read
// whether or not the window is kept (so[0] and so[1] for one outside the
// shard or not clean), so a thread's reads carry no branch and go out
// together.
struct WindowRun {
    int32_t kept;
    uint32_t so_lo;
};

YT_HD WindowRun window_run(int32_t hash, bool clean, const uint32_t* so,
                           int32_t max_hits, int32_t hash_lo, int64_t per) {
    const int64_t local = (int64_t)hash - hash_lo;
    clean = clean && local >= 0 && local < per;
    const uint32_t h = clean ? (uint32_t)local : 0u;
#if defined(__CUDA_ARCH__)
    const uint32_t lo = __ldg(so + h);
    const uint32_t hi = __ldg(so + h + 1);
#else
    const uint32_t lo = so[h];
    const uint32_t hi = so[h + 1];
#endif
    const int32_t cnt = (int32_t)(hi - lo);
    const bool kept = clean && cnt > 0 && cnt <= max_hits;
    WindowRun run = {kept ? cnt : 0, kept ? lo : 0u};
    return run;
}

// The window of a batch's slot t: the first of its kBatch windows whose
// inclusive kept-count sum (cum, rising) exceeds t, the searchsorted-right
// of the JAX program; ten halvings, no branch.
YT_HD int slot_window(const uint32_t* cum, int64_t t) {
    int i = 0;
    for (int step = kBatch / 2; step > 0; step >>= 1)
        if ((int64_t)cum[i + step - 1] <= t) i += step;
    return i;
}

// The key of a hit of window w at ROA value ro.
YT_HD uint64_t slot_key(uint32_t ro, int64_t w) {
    return ((uint64_t)(ro - (uint32_t)w) << 32) | (uint32_t)w;
}

// Bitonic network over P keys, stage (k, j): element i keeps the smaller
// of itself and element i ^ j when this is true, else the larger.
YT_HD bool bitonic_keeps_min(int64_t i, int64_t j, int64_t k) {
    return ((i & j) == 0) == ((i & k) == 0);
}

// The lower element of the q-th pair of stride j.
YT_HD int64_t bitonic_low(int64_t q, int64_t j) {
    return ((q & ~(j - 1)) << 1) | (q & (j - 1));
}

YT_HD uint64_t keep(uint64_t mine, uint64_t other, bool keep_min) {
    return keep_min ? (mine < other ? mine : other)
                    : (mine < other ? other : mine);
}

// Stage k's strides below kRegKeys, inside a thread holding elements i0 ..
// i0 + kRegKeys - 1 in v.
YT_HD void reg_steps(uint64_t (&v)[kRegKeys], int64_t i0, int64_t k) {
#pragma unroll
    for (int j = kRegKeys / 2; j > 0; j >>= 1) {
        if (j >= k) continue;
#pragma unroll
        for (int e = 0; e < kRegKeys; e++) {
            if (e & j) continue;
            const uint64_t a = v[e], c = v[e | j];
            const bool up = ((i0 + e) & k) == 0;
            const bool sw = (a > c) == up;
            v[e] = sw ? c : a;
            v[e | j] = sw ? a : c;
        }
    }
}

// Pair q of stage (k, j) in shared memory.
YT_HD void smem_step(uint64_t* keys, int64_t q, int64_t j, int64_t k) {
    const int64_t i = bitonic_low(q, j);
    const uint64_t a = keys[i], c = keys[i + j];
    if ((a > c) == ((i & k) == 0)) {
        keys[i] = c;
        keys[i + j] = a;
    }
}

// The merge of a row's M sorted runs of cap keys each (one a model shard,
// keys diag << 32 | qo as in the expansion) into one sorted row of M cap
// keys: element i of run m goes to slot i plus, for every other run, the
// number of its keys that sort before it (those <= the key in a run before
// m, those < the key in a run after it, so that equal keys keep the order
// of their runs).  Each count is a binary search of log2(cap) + 1 probes
// (cap a power of two), the same for every element.  diag and qo are
// [M, b, cap]; the row's keys of run m start at (m b + row) cap.
YT_HD uint64_t run_key(const uint32_t* diag, const int32_t* qo, int64_t at) {
#if defined(__CUDA_ARCH__)
    return ((uint64_t)__ldg(diag + at) << 32) | (uint32_t)__ldg(qo + at);
#else
    return ((uint64_t)diag[at] << 32) | (uint32_t)qo[at];
#endif
}

// Keys of the sorted run at `at` (cap of them) below `key`, or at most
// `key` when `upper`.
YT_HD int64_t run_rank(const uint32_t* diag, const int32_t* qo, int64_t at,
                       int64_t cap, uint64_t key, bool upper) {
    int64_t c = 0;
    for (int64_t step = cap >> 1; step > 0; step >>= 1) {
        const uint64_t k = run_key(diag, qo, at + c + step - 1);
        if (upper ? k <= key : k < key) c += step;
    }
    const uint64_t k = run_key(diag, qo, at + c);
    return c + ((upper ? k <= key : k < key) ? 1 : 0);
}

// Element e (run e / cap, index e % cap) of row `row`: its slot in the
// merged row [row, M cap] of out_diag / out_qo, where it is written.
YT_HD void merge_element(const uint32_t* diag, const int32_t* qo, int32_t m,
                         int64_t b, int64_t cap, int64_t row, int64_t e,
                         uint32_t* out_diag, int32_t* out_qo) {
    const int32_t mine = (int32_t)(e / cap);
    const int64_t i = e - (int64_t)mine * cap;
    const uint64_t key = run_key(diag, qo, ((int64_t)mine * b + row) * cap +
                                               i);
    int64_t slot = i;
    for (int32_t o = 0; o < m; o++) {
        if (o == mine) continue;
        slot += run_rank(diag, qo, ((int64_t)o * b + row) * cap, cap, key,
                         o < mine);
    }
    const int64_t at = row * (int64_t)m * cap + slot;
    out_diag[at] = (uint32_t)(key >> 32);
    out_qo[at] = (int32_t)(uint32_t)key;
}

// Keys the sort of a row with `valid` keys runs over: pow2(valid), and
// at least a warp's share; none for a row of one key or none.
YT_HD int64_t sort_span(int64_t valid) {
    if (valid <= 1) return valid;
    int64_t p = kWarpKeys;
    while (p < valid) p <<= 1;
    return p;
}

}  // namespace ytsw

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

using ytsw::kBatch;
using ytsw::kSeedSentinel;
using ytsw::kSeedThreads;
using ytsw::kWinPerThread;
constexpr int kHashThreads = 256;
constexpr int kSeedWarps = kSeedThreads / 32;
// Largest capacity: C keys of 8 bytes in one block's shared memory.
constexpr int64_t kMaxCap = 16384;
constexpr int kMergeThreads = 256;

template <int WL>
__global__ void __launch_bounds__(kHashThreads)
seed_hash_kernel(const uint8_t* codes, int64_t b, int64_t l,
                 const int32_t* lengths, int32_t* hashes, uint8_t* clean) {
    const int64_t k0 = ((int64_t)blockIdx.x * kHashThreads + threadIdx.x) *
                       ytsw::kHashRun;
    ytsw::seed_hash_run<WL>(codes, b, l, lengths, k0, hashes, clean);
}

// Stage k's strides below kWarpKeys for the elements i0 .. i0 + kRegKeys
// - 1 that lane holds: lane strides m (element stride m kRegKeys) by
// shuffles, then the register strides.
__device__ __forceinline__ void lane_steps(uint64_t (&v)[ytsw::kRegKeys],
                                           int64_t i0, int64_t k) {
    constexpr int R = ytsw::kRegKeys;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
        if ((int64_t)m * R >= k) continue;
#pragma unroll
        for (int e = 0; e < R; e++) {
            const uint64_t o = __shfl_xor_sync(0xffffffffu, v[e], m);
            v[e] = ytsw::keep(v[e], o, ytsw::bitonic_keeps_min(
                                           i0 + e, (int64_t)m * R, k));
        }
    }
    ytsw::reg_steps(v, i0, k);
}

// Sort keys[0, p) in shared memory, keys[valid, p) taken as the sentinel
// (p = sort_span(valid)).  Each stage's strides of kWarpKeys and more are
// pairs stepped through shared memory, a barrier each; its shorter ones
// run in registers, kRegKeys neighbouring keys a thread (thread t holds
// elements t kRegKeys on, then every kSeedThreads kRegKeys), so only
// whole warps of the first p / kRegKeys threads take part.  The stages up
// to kWarpKeys run in one pass.  Every thread of the block calls it.
__device__ void sort_row(uint64_t* keys, int64_t valid, int64_t p) {
    constexpr int R = ytsw::kRegKeys;
    constexpr int64_t W = ytsw::kWarpKeys;
    const int tid = threadIdx.x;
    for (int64_t i = valid + tid; i < p; i += kSeedThreads)
        keys[i] = kSeedSentinel;
    __syncthreads();
    for (int64_t k = W; k <= p; k <<= 1) {
        for (int64_t j = k >> 1; k > W && j >= W; j >>= 1) {
            for (int64_t q = tid; q < p / 2; q += kSeedThreads)
                ytsw::smem_step(keys, q, j, k);
            __syncthreads();
        }
        for (int64_t i0 = (int64_t)tid * R; i0 < p;
             i0 += (int64_t)kSeedThreads * R) {
            uint64_t v[R];
#pragma unroll
            for (int e = 0; e < R; e++) v[e] = keys[i0 + e];
            for (int64_t s = k == W ? 2 : k; s <= k; s <<= 1)
                lane_steps(v, i0, s);
#pragma unroll
            for (int e = 0; e < R; e++) keys[i0 + e] = v[e];
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kSeedThreads)
expand_sort_kernel(const int32_t* hashes, const uint8_t* clean, int64_t n,
                   const uint32_t* so, const uint32_t* roa, int32_t max_hits,
                   int32_t hash_lo, int64_t per, int64_t cap, uint32_t* diag,
                   int32_t* qo, int32_t* total, uint8_t* overflow,
                   uint8_t* wrapped, uint8_t* allwrapped) {
    extern __shared__ uint64_t keys[];
    __shared__ uint32_t cum[kBatch];    // inclusive kept-count sums
    __shared__ uint32_t so_lo[kBatch];  // run starts in the ROA
    __shared__ uint32_t ok_bits[kBatch / 32];
    __shared__ uint32_t warp_sums[kSeedWarps];
    const int64_t row = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int32_t* hrow = hashes + row * n;
    const uint8_t* crow = clean + row * n;
    uint8_t* wrow = wrapped + row * n;
    diag += row * cap;
    qo += row * cap;
    // The row's kept count so far, wrapping as the JAX int32 cumsum does.
    uint32_t carry = 0;
    int any_wrapped = 0;
    for (int64_t w0 = 0; w0 < n; w0 += kBatch) {
        const int64_t wt = w0 + (int64_t)kWinPerThread * tid;
        int32_t h[kWinPerThread];
        bool c[kWinPerThread];
#pragma unroll
        for (int r = 0; r < kWinPerThread; r++) {
            const bool in = wt + r < n;
            h[r] = in ? __ldg(hrow + wt + r) : 0;
            c[r] = in && __ldg(crow + wt + r) != 0;
        }
        ytsw::WindowRun run[kWinPerThread];
        uint32_t s = 0;
#pragma unroll
        for (int r = 0; r < kWinPerThread; r++) {
            run[r] = ytsw::window_run(h[r], c[r], so, max_hits, hash_lo,
                                      per);
            s += (uint32_t)run[r].kept;
        }
        uint32_t incl = s;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t u = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += u;
        }
        if (lane == 31) warp_sums[warp] = incl;
        __syncthreads();
        uint32_t before = 0, batch = 0;
#pragma unroll
        for (int k = 0; k < kSeedWarps; k++) {
            const uint32_t x = warp_sums[k];
            before += k < warp ? x : 0;
            batch += x;
        }
        if (tid < kBatch / 32) ok_bits[tid] = 0;
        uint32_t at = carry + before + incl - s;
#pragma unroll
        for (int r = 0; r < kWinPerThread; r++) {
            at += (uint32_t)run[r].kept;
            cum[kWinPerThread * tid + r] = at;
            so_lo[kWinPerThread * tid + r] = run[r].so_lo;
        }
        __syncthreads();
        // The batch's slots below cap, kSeedThreads * 4 a round: the four
        // windows found, then the four ROA reads, then the keys.
        const int64_t t_lo = carry;
        const int64_t t_hi = t_lo + batch < cap ? t_lo + batch : cap;
        for (int64_t t0 = t_lo; t0 < t_hi;
             t0 += (int64_t)kSeedThreads * kWinPerThread) {
            int win[kWinPerThread];
            uint32_t ro[kWinPerThread];
#pragma unroll
            for (int r = 0; r < kWinPerThread; r++) {
                const int64_t t = t0 + r * kSeedThreads + tid;
                win[r] = t < t_hi ? ytsw::slot_window(cum, t) : 0;
            }
#pragma unroll
            for (int r = 0; r < kWinPerThread; r++) {
                const int64_t t = t0 + r * kSeedThreads + tid;
                const uint32_t base = win[r] > 0 ? cum[win[r] - 1] : carry;
                ro[r] = t < t_hi ? __ldg(roa + (uint64_t)so_lo[win[r]] +
                                         (uint32_t)(t - base))
                                 : 0u;
            }
#pragma unroll
            for (int r = 0; r < kWinPerThread; r++) {
                const int64_t t = t0 + r * kSeedThreads + tid;
                if (t >= t_hi) continue;
                const int64_t w = w0 + win[r];
                keys[t] = ytsw::slot_key(ro[r], w);
                if (ro[r] >= (uint32_t)w)
                    atomicOr(ok_bits + (win[r] >> 5), 1u << (win[r] & 31));
            }
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kWinPerThread; r++) {
            const int lw = kWinPerThread * tid + r;
            if (wt + r >= n) continue;
            const bool wr = run[r].kept > 0 &&
                            !((ok_bits[lw >> 5] >> (lw & 31)) & 1);
            wrow[wt + r] = wr ? 1 : 0;
            any_wrapped |= wr ? 1 : 0;
        }
        carry += batch;
    }
    // Every key below cap was written before the last batch's barrier.
    const int32_t tot = (int32_t)carry;
    const int64_t valid = tot <= 0 ? 0 : (tot < cap ? tot : cap);
    const int64_t p = ytsw::sort_span(valid);
    sort_row(keys, valid, p);
    // Slots past the sorted ones hold the sentinel.
    for (int64_t t = tid; t < cap; t += kSeedThreads) {
        const uint64_t key = t < p ? keys[t] : kSeedSentinel;
        diag[t] = (uint32_t)(key >> 32);
        qo[t] = (int32_t)(uint32_t)key;
    }
    any_wrapped = __syncthreads_or(any_wrapped);
    if (tid == 0) {
        total[row] = tot;
        overflow[row] = tot > cap ? 1 : 0;
        allwrapped[row] = any_wrapped ? 1 : 0;
    }
}

template <int WL>
int launch_hashes(const uint8_t* codes, int64_t b, int64_t l,
                  const int32_t* lengths, int32_t* hashes, uint8_t* clean,
                  cudaStream_t stream) {
    const int64_t runs = (b * (l - WL + 1) + ytsw::kHashRun - 1) /
                         ytsw::kHashRun;
    const int64_t grid = (runs + kHashThreads - 1) / kHashThreads;
    if (grid > 0)
        seed_hash_kernel<WL><<<(unsigned)grid, kHashThreads, 0, stream>>>(
            codes, b, l, lengths, hashes, clean);
    return (int)cudaGetLastError();
}

int launch_expand(const int32_t* hashes, const uint8_t* clean, int64_t b,
                  int64_t n, const uint32_t* so, const uint32_t* roa,
                  int32_t max_hits, int32_t hash_lo, int64_t per,
                  int64_t cap, uint32_t* diag, int32_t* qo, int32_t* total,
                  uint8_t* overflow, uint8_t* wrapped, uint8_t* allwrapped,
                  cudaStream_t stream) {
    const int64_t slots = cap > kSeedThreads ? cap : kSeedThreads;
    const int smem = (int)(slots * sizeof(uint64_t));
    cudaError_t err = cudaFuncSetAttribute(
        expand_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (b > 0)
        expand_sort_kernel<<<(unsigned)b, kSeedThreads, smem, stream>>>(
            hashes, clean, n, so, roa, max_hits, hash_lo, per, cap, diag, qo,
            total, overflow, wrapped, allwrapped);
    return (int)cudaGetLastError();
}

// A block a row; its threads take the row's M cap elements in stride.
__global__ void __launch_bounds__(kMergeThreads)
merge_runs_kernel(const uint32_t* diag, const int32_t* qo, int32_t m,
                  int64_t b, int64_t cap, uint32_t* out_diag,
                  int32_t* out_qo) {
    const int64_t row = blockIdx.x;
    for (int64_t e = threadIdx.x; e < (int64_t)m * cap; e += kMergeThreads)
        ytsw::merge_element(diag, qo, m, b, cap, row, e, out_diag, out_qo);
}

}  // namespace

extern "C" {

// Each entry launches on `stream`, allocates nothing, does not synchronise,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a shape or
// an output alignment it does not take).

int yt_seed_hashes(const uint8_t* codes, int64_t b, int64_t l,
                   const int32_t* lengths, int32_t wl, int32_t* hashes,
                   uint8_t* clean, void* stream) {
    if (wl < 1 || wl > 15 || l < wl || ((uintptr_t)hashes & 15) ||
        ((uintptr_t)clean & 15))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (wl) {
    case 1: return launch_hashes<1>(codes, b, l, lengths, hashes, clean, s);
    case 2: return launch_hashes<2>(codes, b, l, lengths, hashes, clean, s);
    case 3: return launch_hashes<3>(codes, b, l, lengths, hashes, clean, s);
    case 4: return launch_hashes<4>(codes, b, l, lengths, hashes, clean, s);
    case 5: return launch_hashes<5>(codes, b, l, lengths, hashes, clean, s);
    case 6: return launch_hashes<6>(codes, b, l, lengths, hashes, clean, s);
    case 7: return launch_hashes<7>(codes, b, l, lengths, hashes, clean, s);
    case 8: return launch_hashes<8>(codes, b, l, lengths, hashes, clean, s);
    case 9: return launch_hashes<9>(codes, b, l, lengths, hashes, clean, s);
    case 10: return launch_hashes<10>(codes, b, l, lengths, hashes, clean, s);
    case 11: return launch_hashes<11>(codes, b, l, lengths, hashes, clean, s);
    case 12: return launch_hashes<12>(codes, b, l, lengths, hashes, clean, s);
    case 13: return launch_hashes<13>(codes, b, l, lengths, hashes, clean, s);
    case 14: return launch_hashes<14>(codes, b, l, lengths, hashes, clean, s);
    default: return launch_hashes<15>(codes, b, l, lengths, hashes, clean, s);
    }
}

// so holds per + 1 words: the shard of hashes [hash_lo, hash_lo + per).
int yt_expand_sort(const int32_t* hashes, const uint8_t* clean, int64_t b,
                   int64_t n, const uint32_t* so, const uint32_t* roa,
                   int32_t max_hits, int32_t hash_lo, int64_t per,
                   int64_t cap, uint32_t* diag, int32_t* qo, int32_t* total,
                   uint8_t* overflow, uint8_t* wrapped, uint8_t* allwrapped,
                   void* stream) {
    if (cap < 1 || cap > kMaxCap || (cap & (cap - 1)) || b > 0x7FFFFFFF ||
        per < 1 || hash_lo < 0)
        return (int)cudaErrorInvalidValue;
    return launch_expand(hashes, clean, b, n, so, roa, max_hits, hash_lo,
                         per, cap, diag, qo, total, overflow, wrapped,
                         allwrapped, (cudaStream_t)stream);
}

// diag / qo [m, b, cap], each row of each run sorted -> out [b, m cap].
int yt_merge_runs(const uint32_t* diag, const int32_t* qo, int32_t m,
                  int64_t b, int64_t cap, uint32_t* out_diag,
                  int32_t* out_qo, void* stream) {
    if (m < 1 || cap < 1 || (cap & (cap - 1)) || b > 0x7FFFFFFF)
        return (int)cudaErrorInvalidValue;
    if (b > 0)
        merge_runs_kernel<<<(unsigned)b, kMergeThreads, 0,
                            (cudaStream_t)stream>>>(diag, qo, m, b, cap,
                                                    out_diag, out_qo);
    return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
