// Hopper (sm_90a) kernel of the staged engine's device problem assembly.
//
// yt_gather_problems replaces gather_dp._gather
// (yaha_tpu/ops/gather_dp.py:61), the jnp program that cuts every DP
// problem's (q, r) code slices out of data resident on the device: the
// chunk's strand rows (forward and reverse-complement code rows,
// [rows][lpad] u8) and the whole genome's codes (one flat u8 array,
// indexed in int64, so the JAX package's 2^28 paging has no counterpart
// here).  Per problem k the coordinates are coords[c * m + k] (int64, rows
// in the order of the C_* names below), as the native yt_batch_{gap,ext}_
// meta2 export them.
//
// Element j of a problem reads source position pos = len-1-j when the
// problem is reversed (leftward extensions reverse the whole zero-filled
// buffer) and j otherwise; positions at or past the copy count are the
// zero fill; q columns past qlen are 0, r columns past rlen take `rpad`
// (255 for extension references, 0 for gap references), exactly the host
// fetch buffers (yt_batch_*_fetch).  Source indices are clamped into their
// arrays as the JAX gather clamps them.
//
// What bounds it on an H100: bytes.  It writes m * (qg + rg) bytes and
// reads about as many (a problem's source bytes are consecutive, or
// consecutive backwards), which at the main path's shapes is tens of
// microseconds at the memory rate.  The first version gave each output
// byte a thread that re-read up to five int64 coordinates and stored one
// byte, about 6 % of that rate.  Here one warp assembles one problem: the
// eight coordinates are read once, by eight lanes, and broadcast with
// __shfl_sync; the problem's q and r rows are cut into the 16-byte chunks
// of the output's address space, and each lane builds whole chunks.  A
// chunk whose bytes all come from inside the copy, with no clamp, reads its
// 16 source bytes as four or five aligned 4-byte words and aligns them with
// __byte_perm (reversing their order for reversed problems); any other
// chunk (the copy limit, len, the pad, a clamp) is built byte by byte.  A
// chunk inside the row goes out as one 16-byte store; the first and last
// chunk of a row that does not start or end on 16 bytes (rg = 1,044 at the
// 1 kb bucket) store only the row's bytes, one at a time.
//
// The per-chunk body (gather_chunk) is __host__ __device__, with a host
// version of __byte_perm in sw_cells.cuh, so the CPU tests rehearse the
// alignment and reversal logic against the plain version.
#include <string.h>

#include "sw_cells.cuh"

namespace ytsw {

enum { C_QROW, C_QSRC, C_QCOPY, C_QLEN, C_RSRC, C_RCOPY, C_RLEN, C_REV };

YT_HD int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// One output row of a problem: its source (base[clamp(src + pos, 0,
// lim - 1)]), copy count, length, direction and pad value.
struct GatherRow {
    const uint8_t* base;
    int64_t src, lim, copy, len;
    bool rev;
    uint8_t pad;
};

// The q row (is_q) or r row of the problem with coordinates c[8].
YT_HD GatherRow gather_row(const int64_t* c, bool is_q, const uint8_t* rows2,
                           int64_t nrows, int64_t lpad, const uint8_t* codes,
                           int64_t ncodes, int32_t rpad) {
    GatherRow g;
    g.rev = c[C_REV] != 0;
    if (is_q) {
        g.base = rows2 + clamp64(c[C_QROW], 0, nrows - 1) * lpad;
        g.src = c[C_QSRC];
        g.lim = lpad;
        g.copy = c[C_QCOPY];
        g.len = c[C_QLEN];
        g.pad = 0;
    } else {
        g.base = codes;
        g.src = c[C_RSRC];
        g.lim = ncodes;
        g.copy = c[C_RCOPY];
        g.len = c[C_RLEN];
        g.pad = (uint8_t)rpad;
    }
    return g;
}

// Byte j of a row.
YT_HD uint8_t gather_at(const GatherRow& g, int64_t j) {
    if (j >= g.len) return g.pad;
    const int64_t pos = g.rev ? g.len - 1 - j : j;
    if (pos >= g.copy) return 0;
    return g.base[clamp64(g.src + pos, 0, g.lim - 1)];
}

YT_HD uint32_t ld_word(const uint8_t* p) {  // p 4-byte aligned
#if defined(__CUDA_ARCH__)
    return __ldg((const unsigned int*)p);
#else
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
#endif
}

// The 16 bytes at p (any alignment) as four little-endian words, from the
// aligned words that hold them: five when p is not 4-byte aligned, else
// four, so no word is read that holds none of the 16 bytes.
YT_HD void load16(const uint8_t* p, uint32_t out[4]) {
    const uintptr_t a = (uintptr_t)p;
    const uint8_t* w = (const uint8_t*)(a & ~(uintptr_t)3);
    const uint32_t sh = (uint32_t)(a & 3);
    uint32_t v[5];
    for (int i = 0; i < 4; i++) v[i] = ld_word(w + 4 * i);
    v[4] = sh ? ld_word(w + 16) : 0;
    const uint32_t sel = 0x3210u + 0x1111u * sh;
    for (int i = 0; i < 4; i++) out[i] = byte_perm(v[i], v[i + 1], sel);
}

// Bytes j0 .. j0+15 of a row, as four words.
YT_HD void gather_chunk(const GatherRow& g, int64_t j0, uint32_t out[4]) {
    const int64_t j1 = j0 + 16;  // one past the chunk
    if (!g.rev && j1 <= g.len && j1 <= g.copy && g.src + j0 >= 0 &&
        g.src + j1 <= g.lim) {
        load16(g.base + g.src + j0, out);
        return;
    }
    // Reversed: bytes j0 .. j0+15 are positions len-1-j0 down to len-j1.
    if (g.rev && j0 >= 0 && j1 <= g.len && g.len - 1 - j0 < g.copy &&
        g.src + g.len - j1 >= 0 && g.src + g.len - j0 <= g.lim) {
        uint32_t f[4];
        load16(g.base + g.src + g.len - j1, f);
        for (int i = 0; i < 4; i++) out[i] = byte_perm(f[3 - i], 0, 0x0123u);
        return;
    }
    for (int i = 0; i < 4; i++) {
        uint32_t v = 0;
        for (int b = 0; b < 4; b++)
            v |= (uint32_t)gather_at(g, j0 + 4 * i + b) << (8 * b);
        out[i] = v;
    }
}

// Chunk c of a row stored at dst (len bytes): the 16 bytes at the aligned
// address base + 16 c, with base = dst rounded down to 16.
YT_HD void gather_store(const GatherRow& g, uint8_t* dst, int64_t len,
                        int64_t c) {
    uint8_t* base = (uint8_t*)((uintptr_t)dst & ~(uintptr_t)15);
    uint8_t* at = base + 16 * c;
    const int64_t j0 = at - dst;
    uint32_t v[4];
    gather_chunk(g, j0, v);
    if (j0 >= 0 && j0 + 16 <= len) {
#if defined(__CUDA_ARCH__)
        *(uint4*)at = make_uint4(v[0], v[1], v[2], v[3]);
#else
        memcpy(at, v, 16);
#endif
        return;
    }
    for (int b = 0; b < 16; b++)
        if (j0 + b >= 0 && j0 + b < len)
            at[b] = (uint8_t)(v[b >> 2] >> (8 * (b & 3)));
}

// 16-byte chunks of a row of len bytes at dst.
YT_HD int64_t gather_chunks(const uint8_t* dst, int64_t len) {
    return len ? (int64_t)(((uintptr_t)dst & 15) + len + 15) / 16 : 0;
}

// Problem k whole, on one thread (the host build's loop; the card runs
// gather_kernel).
YT_HD void gather_problem(int64_t k, int64_t m, const uint8_t* rows2,
                          int64_t nrows, int64_t lpad, const uint8_t* codes,
                          int64_t ncodes, const int64_t* coords, int64_t qg,
                          int64_t rg, int32_t rpad, uint8_t* q, uint8_t* r) {
    int64_t c[8];
    for (int i = 0; i < 8; i++) c[i] = coords[i * m + k];
    for (int is_q = 1; is_q >= 0; is_q--) {
        const GatherRow g = gather_row(c, is_q, rows2, nrows, lpad, codes,
                                       ncodes, rpad);
        const int64_t len = is_q ? qg : rg;
        uint8_t* dst = is_q ? q + k * qg : r + k * rg;
        for (int64_t ch = 0; ch < gather_chunks(dst, len); ch++)
            gather_store(g, dst, len, ch);
    }
}

}  // namespace ytsw

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

constexpr int kGatherWarps = 4;  // problems per block

__global__ void __launch_bounds__(32 * kGatherWarps)
gather_kernel(int64_t m, const uint8_t* rows2, int64_t nrows, int64_t lpad,
              const uint8_t* codes, int64_t ncodes, const int64_t* coords,
              int64_t qg, int64_t rg, int32_t rpad, uint8_t* q, uint8_t* r) {
    const int lane = threadIdx.x & 31;
    const int64_t k = blockIdx.x * (int64_t)kGatherWarps + threadIdx.x / 32;
    if (k >= m) return;  // the whole warp leaves together
    const int64_t mine = lane < 8 ? coords[lane * m + k] : 0;
    int64_t c[8];
#pragma unroll
    for (int i = 0; i < 8; i++) c[i] = __shfl_sync(0xffffffffu, mine, i);
    const ytsw::GatherRow gq =
        ytsw::gather_row(c, true, rows2, nrows, lpad, codes, ncodes, rpad);
    const ytsw::GatherRow gr =
        ytsw::gather_row(c, false, rows2, nrows, lpad, codes, ncodes, rpad);
    uint8_t* dq = q + k * qg;
    uint8_t* dr = r + k * rg;
    const int64_t nq = ytsw::gather_chunks(dq, qg);
    const int64_t nc = nq + ytsw::gather_chunks(dr, rg);
    for (int64_t ch = lane; ch < nc; ch += 32) {
        if (ch < nq)
            ytsw::gather_store(gq, dq, qg, ch);
        else
            ytsw::gather_store(gr, dr, rg, ch - nq);
    }
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
int yt_gather_problems(const uint8_t* rows2, int64_t nrows, int64_t lpad,
                       const uint8_t* codes, int64_t ncodes,
                       const int64_t* coords, int64_t m, int64_t qg,
                       int64_t rg, int32_t rpad, uint8_t* q, uint8_t* r,
                       void* stream) {
    const int64_t grid = (m + kGatherWarps - 1) / kGatherWarps;
    gather_kernel<<<(unsigned)grid, 32 * kGatherWarps, 0,
                    (cudaStream_t)stream>>>(m, rows2, nrows, lpad, codes,
                                            ncodes, coords, qg, rg, rpad, q,
                                            r);
    return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
