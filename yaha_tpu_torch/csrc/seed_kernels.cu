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
// merge_pass_kernel replaces the all_gather over `model` and the sort of
// the gathered buffers (yaha_tpu/parallel/mesh.py:204-213): the M shards'
// [b, C] rows, each sorted, become one sorted [b, M C] row, ties to the
// lower shard.  What bounds it on an H100 is bytes: every key in once and
// out once.  It is a tiled merge path: a pass merges pairs of adjacent
// runs (one pass at M <= 2, else ceil(log2 M), a launch each), a
// block a tile of T = 2,048 outputs of a pair.  Two warps find where the
// tile starts and ends in the two runs (the merge path's cross-diagonal,
// by ballots over 32 probes a round: two dependent rounds at C = 1,024),
// the block loads the two spans into shared memory with 16-byte loads of
// each stream (8-byte keys in slots padded so that strided threads spread
// over the banks), each thread finds its 8 outputs' start by a binary
// search in shared memory and merges them in registers, and the tile is
// written back as 16-byte stores of each stream.  At tier 1 (M 2, C
// 1,024) a tile is a whole row and the splits cost nothing.  The first
// design gave each element a thread that binary-searched the other runs
// in device memory: 11 dependent load pairs a key at C = 1,024, a quarter
// of the card's memory rate.
//
// The per-run and per-window bodies (seed_hash_run, seed_hash_window,
// window_run, slot_window, slot_key; the merge's splits, loads, stores and
// merge_thread) and the sort's
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

// The merge of the M model shards' sorted runs of a row (keys diag << 32 |
// qo as in the expansion) into one sorted row of n = M C keys, by passes
// that merge pairs of adjacent runs: runs of C keys into runs of 2 C, then
// 4 C, up to one run of n (ceil(log2 M) passes, and one at M = 1).  Pair k
// of a pass merges run 2k (A) with run 2k + 1 (B: shorter, or empty, past
// the row's end), A's key first where two are equal, so equal keys keep
// the order of their shards.  The first pass reads the [M, b, C] input
// (run j of row r at (j b + r) C), the others a [b, n] row-major buffer
// (run j of row r at r n + j L, L the pass's run length); each writes a
// [b, n] buffer, the last one the output.
constexpr int kMergeThreads = 256;
constexpr int kMergeKeys = 8;   // outputs a thread merges (E)
constexpr int64_t kMergeTile = (int64_t)kMergeThreads * kMergeKeys;  // T
// A tile's keys in shared memory, a slot of padding after every 16, so
// that a half-warp's 8-byte accesses 4 or 8 keys apart (the quads, the
// threads' outputs) fall in 16 different bank pairs.  Positions in a tile
// are int32.
constexpr int32_t kMergeSlots = (int32_t)(kMergeTile + kMergeTile / 16);

YT_HD int32_t merge_slot(int32_t x) { return x + (x >> 4); }

YT_HD uint64_t run_key(const uint32_t* diag, const int32_t* qo, int64_t at) {
#if defined(__CUDA_ARCH__)
    return ((uint64_t)__ldg(diag + at) << 32) | (uint32_t)__ldg(qo + at);
#else
    return ((uint64_t)diag[at] << 32) | (uint32_t)qo[at];
#endif
}

// Keys at .. at + 3 (diag and qo 16-byte aligned at `at`): two 16-byte
// loads.
YT_HD void run_keys4(const uint32_t* diag, const int32_t* qo, int64_t at,
                     uint64_t (&k)[4]) {
#if defined(__CUDA_ARCH__)
    const uint4 d = __ldg((const uint4*)(diag + at));
    const int4 q = __ldg((const int4*)(qo + at));
    k[0] = ((uint64_t)d.x << 32) | (uint32_t)q.x;
    k[1] = ((uint64_t)d.y << 32) | (uint32_t)q.y;
    k[2] = ((uint64_t)d.z << 32) | (uint32_t)q.z;
    k[3] = ((uint64_t)d.w << 32) | (uint32_t)q.w;
#else
    for (int e = 0; e < 4; e++) k[e] = run_key(diag, qo, at + e);
#endif
}

// One pass: its input and output, the keys of a row and the run length.
struct MergePass {
    const uint32_t* diag;
    const int32_t* qo;
    int64_t row_stride, run_stride;  // input run j of row r at r rs + j js
    int64_t n, len;
    int64_t pairs, tiles;            // pairs of runs a row; tiles a pair
    uint32_t* out_diag;              // [b, n]
    int32_t* out_qo;
};

YT_HD int merge_passes(int64_t m) {
    int np = 1;
    while (((int64_t)1 << np) < m) np++;
    return np;
}

// Pass p of np over [m, b, cap] runs: it reads the input (p = 0) or pass p
// - 1's output, and writes the output when np - 1 - p is even, else tmp
// (so that the last pass writes the output).
YT_HD MergePass merge_pass(int p, int np, const uint32_t* diag,
                           const int32_t* qo, int64_t m, int64_t b,
                           int64_t cap, uint32_t* tmp_d, int32_t* tmp_q,
                           uint32_t* out_d, int32_t* out_q) {
    MergePass P;
    P.n = m * cap;
    P.len = cap << p;
    const bool to_out = ((np - 1 - p) & 1) == 0;
    if (p == 0) {
        P.diag = diag;
        P.qo = qo;
        P.row_stride = cap;
        P.run_stride = b * cap;
    } else {
        P.diag = to_out ? tmp_d : out_d;
        P.qo = to_out ? tmp_q : out_q;
        P.row_stride = P.n;
        P.run_stride = P.len;
    }
    P.out_diag = to_out ? out_d : tmp_d;
    P.out_qo = to_out ? out_q : tmp_q;
    P.pairs = ((P.n + P.len - 1) / P.len + 1) / 2;
    const int64_t span = 2 * P.len < P.n ? 2 * P.len : P.n;
    P.tiles = (span + kMergeTile - 1) / kMergeTile;
    return P;
}

// Block `blk` of a pass: output tile `tile` of pair `pair` of row `row`,
// the pair's outputs [d0, d1) of la + lb; A and B start at a_at and b_at
// in the input, the pair's outputs at out_at.
struct MergeTile {
    int64_t a_at, b_at, out_at;
    int64_t la, lb, d0, d1;

    // False for a tile past its pair's outputs.
    YT_HD bool init(const MergePass& P, int64_t blk) {
        const int64_t tile = blk % P.tiles;
        const int64_t pair = blk / P.tiles % P.pairs;
        const int64_t row = blk / P.tiles / P.pairs;
        const int64_t x = 2 * pair * P.len;
        la = P.n - x < P.len ? P.n - x : P.len;
        lb = P.n - x - la < P.len ? P.n - x - la : P.len;
        a_at = row * P.row_stride + 2 * pair * P.run_stride;
        b_at = a_at + P.run_stride;
        out_at = row * P.n + x;
        d0 = tile * kMergeTile;
        d1 = d0 + kMergeTile < la + lb ? d0 + kMergeTile : la + lb;
        return d0 < la + lb;
    }
};

// The merge path's split of a pair's first d outputs: the number of A's
// keys among them, the least i in [max(0, d - lb), min(d, la)] with not
// A[i] <= B[d - 1 - i] (min(d, la) if there is none).  A warp finds it in
// rounds: lane l probes i = lo + (l + 1) s - 1, s = ceil((hi - lo) / 32)
// (false at i >= hi); the probes that hold are the first c lanes', and
// the split lies in [lo + c s, min(hi, lo + (c + 1) s - 1)].  Two rounds
// at 1,024 keys a run, three at 32,768.
YT_HD int64_t split_lo(int64_t d, int64_t lb) { return d > lb ? d - lb : 0; }
YT_HD int64_t split_hi(int64_t d, int64_t la) { return d < la ? d : la; }

YT_HD bool split_probe(const MergePass& P, const MergeTile& T, int64_t d,
                       int64_t lo, int64_t hi, int lane) {
    const int64_t s = (hi - lo + 31) / 32;
    const int64_t i = lo + (lane + 1) * s - 1;
    return i < hi && run_key(P.diag, P.qo, T.a_at + i) <=
                         run_key(P.diag, P.qo, T.b_at + (d - 1 - i));
}

YT_HD void split_narrow(int64_t& lo, int64_t& hi, int c) {
    const int64_t s = (hi - lo + 31) / 32;
    const int64_t nhi = lo + (c + 1) * s - 1;
    lo = lo + c * s < hi ? lo + c * s : hi;
    if (nhi < hi) hi = nhi;
}

// Where a span of cnt keys from `at` on has its quads: the keys before
// the first 4-aligned one (all of them when the two streams are not
// 16-byte aligned there) and the quads after them.
YT_HD int32_t span_head(const void* d, const void* q, int64_t at,
                        int32_t cnt) {
    const int32_t head = (int32_t)((4 - (at & 3)) & 3);
    const uintptr_t a = (uintptr_t)((const uint32_t*)d + (at + head)) |
                        (uintptr_t)((const uint32_t*)q + (at + head));
    return (a & 15) || head > cnt ? cnt : head;
}

// Thread `tid` of `nt`'s share of loading keys [at, at + cnt) of the
// input into slots merge_slot(o + x): 16-byte loads of the quads, single
// keys before and after them.
YT_HD void load_keys(int tid, int nt, const MergePass& P, int64_t at,
                     int32_t cnt, uint64_t* keys, int32_t o) {
    const int32_t head = span_head(P.diag, P.qo, at, cnt);
    const int32_t quads = (cnt - head) >> 2;
    const int32_t tail = head + 4 * quads;
    for (int32_t x = tid; x < head; x += nt)
        keys[merge_slot(o + x)] = run_key(P.diag, P.qo, at + x);
    for (int32_t x = tail + tid; x < cnt; x += nt)
        keys[merge_slot(o + x)] = run_key(P.diag, P.qo, at + x);
    for (int32_t c = tid; c < quads; c += nt) {
        uint64_t k[4];
        run_keys4(P.diag, P.qo, at + head + 4 * c, k);
        for (int e = 0; e < 4; e++)
            keys[merge_slot(o + head + 4 * c + e)] = k[e];
    }
}

// The same for storing keys 0 .. cnt - 1 of the slots to the output from
// `at` on, as the two int32 streams.
YT_HD void store_keys(int tid, int nt, const uint64_t* keys, int32_t cnt,
                      const MergePass& P, int64_t at) {
    const int32_t head = span_head(P.out_diag, P.out_qo, at, cnt);
    const int32_t quads = (cnt - head) >> 2;
    for (int32_t x = tid; x < cnt - 4 * quads; x += nt) {
        const int32_t y = x < head ? x : x + 4 * quads;
        const uint64_t k = keys[merge_slot(y)];
        P.out_diag[at + y] = (uint32_t)(k >> 32);
        P.out_qo[at + y] = (int32_t)(uint32_t)k;
    }
    for (int32_t c = tid; c < quads; c += nt) {
        uint32_t d[4], q[4];
        for (int e = 0; e < 4; e++) {
            const uint64_t k = keys[merge_slot(head + 4 * c + e)];
            d[e] = (uint32_t)(k >> 32);
            q[e] = (uint32_t)k;
        }
        const int64_t y = at + head + 4 * c;
#if defined(__CUDA_ARCH__)
        *(uint4*)(P.out_diag + y) = make_uint4(d[0], d[1], d[2], d[3]);
        *(uint4*)(P.out_qo + y) = make_uint4(q[0], q[1], q[2], q[3]);
#else
        for (int e = 0; e < 4; e++) {
            P.out_diag[y + e] = d[e];
            P.out_qo[y + e] = (int32_t)q[e];
        }
#endif
    }
}

// Thread t's outputs of a tile whose A span (na keys) and B span (nb) sit
// in slots 0 .. na - 1 and na .. na + nb - 1: outputs t E .. t E + E - 1
// (those below na + nb), found by a binary search of the merge path in
// shared memory and merged in registers, A first on equal keys: the next
// key of each span stays in a register, and only the span that gave a key
// loads its next.
YT_HD void merge_thread(int t, const uint64_t* keys, int32_t na, int32_t nb,
                        uint64_t (&v)[kMergeKeys]) {
    const int32_t d = t * kMergeKeys;
    int32_t lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
    while (lo < hi) {
        const int32_t mid = (lo + hi) >> 1;
        if (keys[merge_slot(mid)] <= keys[merge_slot(na + d - 1 - mid)])
            lo = mid + 1;
        else
            hi = mid;
    }
    int32_t ia = lo, ib = d - lo;
    uint64_t ka = ia < na ? keys[merge_slot(ia)] : 0;
    uint64_t kb = ib < nb ? keys[merge_slot(na + ib)] : 0;
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
    for (int e = 0; e < kMergeKeys; e++) {
        const bool take_a = ib >= nb || (ia < na && ka <= kb);
        v[e] = take_a ? ka : kb;
        if (take_a) {
            ia++;
            ka = ia < na ? keys[merge_slot(ia)] : 0;
        } else {
            ib++;
            kb = ib < nb ? keys[merge_slot(na + ib)] : 0;
        }
    }
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
using ytsw::kMergeKeys;
using ytsw::kMergeThreads;

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

// A block a tile of kMergeTile outputs of a pair of runs of a row: warps
// 0 and 1 find where the tile starts and ends in A and B, every thread
// loads its share of the two spans into shared memory, merges its E
// outputs in registers, and the tile goes out through shared memory again.
__global__ void __launch_bounds__(kMergeThreads)
merge_pass_kernel(ytsw::MergePass P) {
    __shared__ uint64_t keys[ytsw::kMergeSlots];
    __shared__ int64_t split[2];
    ytsw::MergeTile T;
    if (!T.init(P, blockIdx.x)) return;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (warp < 2) {
        const int64_t d = warp ? T.d1 : T.d0;
        int64_t lo = ytsw::split_lo(d, T.lb), hi = ytsw::split_hi(d, T.la);
        while (lo < hi) {
            const unsigned c = __ballot_sync(
                0xffffffffu, ytsw::split_probe(P, T, d, lo, hi, lane));
            ytsw::split_narrow(lo, hi, __popc(c));
        }
        if (lane == 0) split[warp] = lo;
    }
    __syncthreads();
    const int64_t a0 = split[0];
    const int32_t na = (int32_t)(split[1] - a0);
    const int32_t n = (int32_t)(T.d1 - T.d0);
    ytsw::load_keys(tid, kMergeThreads, P, T.a_at + a0, na, keys, 0);
    ytsw::load_keys(tid, kMergeThreads, P, T.b_at + (T.d0 - a0), n - na,
                    keys, na);
    __syncthreads();
    uint64_t v[kMergeKeys];
    ytsw::merge_thread(tid, keys, na, n - na, v);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kMergeKeys; e++) {
        const int32_t x = tid * kMergeKeys + e;
        if (x < n) keys[ytsw::merge_slot(x)] = v[e];
    }
    __syncthreads();
    ytsw::store_keys(tid, kMergeThreads, keys, n, P, T.out_at + T.d0);
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

// diag / qo [m, b, cap], each row of each run sorted -> out [b, m cap]:
// ceil(log2 m) passes (one at m = 1), a launch each; tmp ([b, m cap] a
// stream) takes the passes between, and may be null for m <= 2.
int yt_merge_runs(const uint32_t* diag, const int32_t* qo, int32_t m,
                  int64_t b, int64_t cap, uint32_t* tmp_d, int32_t* tmp_q,
                  uint32_t* out_d, int32_t* out_q, void* stream) {
    if (m < 1 || cap < 1 || (cap & (cap - 1)) || b < 0 ||
        (m > 2 && (!tmp_d || !tmp_q)))
        return (int)cudaErrorInvalidValue;
    const int np = ytsw::merge_passes(m);
    for (int p = 0; p < np; p++) {
        const ytsw::MergePass P = ytsw::merge_pass(p, np, diag, qo, m, b, cap,
                                                   tmp_d, tmp_q, out_d,
                                                   out_q);
        const int64_t grid = b * P.pairs * P.tiles;
        if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
        if (grid > 0)
            merge_pass_kernel<<<(unsigned)grid, kMergeThreads, 0,
                                (cudaStream_t)stream>>>(P);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

}  // extern "C"

#endif  // __CUDACC__
