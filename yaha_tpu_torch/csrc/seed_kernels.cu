// Hopper (sm_90a) kernels of the device seed phase (--seed device).
//
// seed_hash_kernel replaces seeds_jax.batched_seed_hashes
// (yaha_tpu/ops/seeds_jax.py:30): for every window p < L - wl + 1 of a
// [B, L] u8 strand-row batch, the 2-bit rolling k-mer hash (int32, wl <= 15)
// and a clean flag (p <= len - wl and no code above 3 in the window); the
// hash is 0 where the window is not clean.  One thread a window, reading
// its wl codes.  What bounds it on an H100: bytes (the rows in, five bytes a
// window out); it is one elementwise pass.
//
// expand_sort_kernel replaces seeds_jax.expand_sort_hits_device (:63):
// per strand row, the SO run of every clean window (so[h], so[h+1] - so[h]
// as uint32), kept when 0 < count <= max_hits; the row's kept counts
// summed in window order (int32, as the JAX cumsum); hit slot t < C of the
// row belongs to the window whose run covers it and holds (diag, qo) =
// (ro - w as uint32, w) with ro = roa[so_lo + rank]; slots past the row's
// total hold the sentinel (0xFFFFFFFF, 0x7FFFFFFF); the C slots sorted by
// (diag uint32, qo); total, overflow = total > C, the wrapped flag of each
// window (kept, and no slot of its run below C has ro >= w: the
// prefix-sum formula of the JAX program, clipped to C, so windows whose
// run starts past C read as wrapped) and allwrapped = any(wrapped).
//
// One block of kSeedThreads threads a row.  The windows go through in
// chunks of kSeedThreads: each thread reads its window's SO run, a
// block-wide exclusive scan of the kept counts (warp shuffles, then the
// warp sums through shared memory), carried from chunk to chunk, gives the
// window's first slot, and the thread writes its run's slots below C as
// 64-bit keys diag << 32 | qo into a shared-memory array prefilled with the
// sentinel (8 KB at C = 1,024; 64 KB at C = 8,192, as dynamic shared memory
// past 48 KB), computing its wrapped flag from the same ROA values.  A
// bitonic sort of the first pow2(min(total, C)) keys follows (the keys past
// the total are the sentinel, the largest key, already in place); the
// block then writes the C slots out.  The unsigned 64-bit keys keep the
// uint32 order of diag (hits with ro < qo have diag >= 2^31) and put a
// valid hit with diag = 0xFFFFFFFF before the sentinel by its qo.  What
// bounds it on an H100: bytes (the [B, C] output planes, the hashes, the
// gathered SO and ROA words); the SO gathers are random reads of a 4 GB
// table at L15, the sort's compare-exchanges run in shared memory.
//
// The per-window bodies (seed_hash_window, window_run, expand_window) are
// __host__ __device__, so the CPU tests build them with g++ and hold them,
// with a sequential scan and sort in place of the block's, to the plain
// versions.
#include "sw_cells.cuh"

namespace ytsw {

constexpr uint64_t kSeedSentinel = (0xFFFFFFFFull << 32) | 0x7FFFFFFFull;

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

// A window's SO run: its kept count (0 unless clean and 0 < count <=
// max_hits; the count is the uint32 difference read as int32) and start.
struct WindowRun {
    int32_t kept;
    uint32_t so_lo;
};

YT_HD WindowRun window_run(int32_t hash, bool clean, const uint32_t* so,
                           int32_t max_hits) {
    WindowRun run = {0, 0};
    if (!clean) return run;
    const uint32_t lo = so[(uint32_t)hash];
    const int32_t cnt = (int32_t)(so[(uint32_t)hash + 1] - lo);
    if (cnt > 0 && cnt <= max_hits) {
        run.kept = cnt;
        run.so_lo = lo;
    }
    return run;
}

// Window w's slots [start, start + kept) below cap, as keys
// (ro - w) << 32 | w with ro = roa[so_lo + t - start]; returns the wrapped
// flag: a kept run none of whose slots below cap has ro >= w.
YT_HD bool expand_window(int64_t w, WindowRun run, int64_t start,
                         const uint32_t* roa, int64_t cap, uint64_t* keys) {
    if (run.kept <= 0) return false;
    bool any_ok = false;
    const int64_t end = start + run.kept < cap ? start + run.kept : cap;
    for (int64_t t = start > 0 ? start : 0; t < end; t++) {
#if defined(__CUDA_ARCH__)
        const uint32_t ro = __ldg(roa + (uint64_t)run.so_lo + (t - start));
#else
        const uint32_t ro = roa[(uint64_t)run.so_lo + (t - start)];
#endif
        any_ok = any_ok || ro >= (uint32_t)w;
        keys[t] = ((uint64_t)(ro - (uint32_t)w) << 32) | (uint32_t)w;
    }
    return !any_ok;
}

}  // namespace ytsw

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

constexpr int kHashThreads = 256;
constexpr int kSeedThreads = 256;
constexpr int kSeedWarps = kSeedThreads / 32;
// Largest capacity: C keys of 8 bytes in one block's shared memory.
constexpr int64_t kMaxCap = 16384;

__global__ void __launch_bounds__(kHashThreads)
seed_hash_kernel(const uint8_t* codes, int64_t b, int64_t l,
                 const int32_t* lengths, int32_t wl, int32_t* hashes,
                 uint8_t* clean) {
    const int64_t n = l - wl + 1;
    const int64_t k = blockIdx.x * (int64_t)kHashThreads + threadIdx.x;
    if (k >= b * n) return;
    const int64_t row = k / n;
    ytsw::seed_hash_window(codes + row * l, lengths[row], wl, k - row * n,
                           hashes + k, clean + k);
}

__global__ void __launch_bounds__(kSeedThreads)
expand_sort_kernel(const int32_t* hashes, const uint8_t* clean, int64_t n,
                   const uint32_t* so, const uint32_t* roa, int32_t max_hits,
                   int64_t cap, uint32_t* diag, int32_t* qo, int32_t* total,
                   uint8_t* overflow, uint8_t* wrapped,
                   uint8_t* allwrapped) {
    extern __shared__ uint64_t keys[];
    __shared__ uint32_t warp_sums[kSeedWarps];
    const int64_t row = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int64_t t = tid; t < cap; t += kSeedThreads)
        keys[t] = ytsw::kSeedSentinel;
    __syncthreads();
    // The row's kept count so far, wrapping as the JAX int32 cumsum does.
    uint32_t carry = 0;
    int any_wrapped = 0;
    for (int64_t w0 = 0; w0 < n; w0 += kSeedThreads) {
        const int64_t w = w0 + tid;
        ytsw::WindowRun run = {0, 0};
        if (w < n)
            run = ytsw::window_run(hashes[row * n + w],
                                   clean[row * n + w] != 0, so, max_hits);
        const uint32_t v = (uint32_t)run.kept;
        uint32_t incl = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t u = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += u;
        }
        if (lane == 31) warp_sums[warp] = incl;
        __syncthreads();
        uint32_t before = 0, chunk = 0;
#pragma unroll
        for (int k = 0; k < kSeedWarps; k++) {
            const uint32_t s = warp_sums[k];
            before += k < warp ? s : 0;
            chunk += s;
        }
        __syncthreads();  // warp_sums is rewritten by the next chunk
        const int32_t start = (int32_t)(carry + before + incl - v);
        carry += chunk;
        if (w < n) {
            const bool wr = ytsw::expand_window(w, run, start, roa, cap, keys);
            wrapped[row * n + w] = wr ? 1 : 0;
            any_wrapped |= wr ? 1 : 0;
        }
    }
    __syncthreads();
    const int32_t tot = (int32_t)carry;
    const int64_t valid = tot <= 0 ? 0 : (tot < cap ? tot : cap);
    int64_t p = 1;
    while (p < valid) p <<= 1;
    // Bitonic sort of keys[0, p), ascending: p / 2 compare-exchanges a step.
    for (int64_t k = 2; k <= p; k <<= 1) {
        for (int64_t j = k >> 1; j > 0; j >>= 1) {
            for (int64_t q = tid; q < p / 2; q += kSeedThreads) {
                const int64_t i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
                const uint64_t a = keys[i];
                const uint64_t c = keys[i + j];
                if ((a > c) == ((i & k) == 0)) {
                    keys[i] = c;
                    keys[i + j] = a;
                }
            }
            __syncthreads();
        }
    }
    for (int64_t t = tid; t < cap; t += kSeedThreads) {
        const uint64_t key = keys[t];
        diag[row * cap + t] = (uint32_t)(key >> 32);
        qo[row * cap + t] = (int32_t)(uint32_t)key;
    }
    any_wrapped = __syncthreads_or(any_wrapped);
    if (tid == 0) {
        total[row] = tot;
        overflow[row] = tot > cap ? 1 : 0;
        allwrapped[row] = any_wrapped ? 1 : 0;
    }
}

}  // namespace

extern "C" {

// Each entry launches on `stream`, allocates nothing, does not synchronise,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it
// does not take).

int yt_seed_hashes(const uint8_t* codes, int64_t b, int64_t l,
                   const int32_t* lengths, int32_t wl, int32_t* hashes,
                   uint8_t* clean, void* stream) {
    if (wl < 1 || wl > 15 || l < wl) return (int)cudaErrorInvalidValue;
    const int64_t windows = b * (l - wl + 1);
    const int64_t grid = (windows + kHashThreads - 1) / kHashThreads;
    if (grid > 0)
        seed_hash_kernel<<<(unsigned)grid, kHashThreads, 0,
                           (cudaStream_t)stream>>>(codes, b, l, lengths, wl,
                                                   hashes, clean);
    return (int)cudaGetLastError();
}

int yt_expand_sort(const int32_t* hashes, const uint8_t* clean, int64_t b,
                   int64_t n, const uint32_t* so, const uint32_t* roa,
                   int32_t max_hits, int64_t cap, uint32_t* diag,
                   int32_t* qo, int32_t* total, uint8_t* overflow,
                   uint8_t* wrapped, uint8_t* allwrapped, void* stream) {
    if (cap < 1 || cap > kMaxCap || (cap & (cap - 1)) || b > 0x7FFFFFFF)
        return (int)cudaErrorInvalidValue;
    const int smem = (int)(cap * sizeof(uint64_t));
    cudaError_t err = cudaFuncSetAttribute(
        expand_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    if (b > 0)
        expand_sort_kernel<<<(unsigned)b, kSeedThreads, smem,
                             (cudaStream_t)stream>>>(
            hashes, clean, n, so, roa, max_hits, cap, diag, qo, total,
            overflow, wrapped, allwrapped);
    return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
