// Hopper (sm_90a) kernel of the staged engine's device problem assembly.
//
// yt_gather_problems replaces gather_dp._gather
// (yaha_tpu/ops/gather_dp.py:61), the jnp program that cuts every DP
// problem's (q, r) code slices out of data resident on the device: the
// chunk's strand rows (forward and
// reverse-complement code rows, [rows][lpad] u8) and the whole genome's
// codes (one flat u8 array, indexed in int64, so the JAX package's 2^28
// paging has no counterpart here).  Per problem k the coordinates are
// coords[c * m + k] (int64, rows in the order of the C_* names below), as
// the native yt_batch_{gap,ext}_meta2 export them.
//
// Element j of a problem reads source position pos = len-1-j when the
// problem is reversed (leftward extensions reverse the whole zero-filled
// buffer) and j otherwise; positions at or past the copy count are the
// zero fill; q columns past qlen are 0, r columns past rlen take `rpad`
// (255 for extension references, 0 for gap references), exactly the host
// fetch buffers (yt_batch_*_fetch).  Source indices are clamped into their
// arrays as the JAX gather clamps them.
//
// Layout: one thread per output byte.  blockIdx.y walks the problems and
// the x dimension the qg + rg bytes of one problem (q first, then r), so a
// warp writes 32 consecutive bytes of one row and reads the problem's
// coordinates once from cache.  What bounds it: the reads of the strand
// row and the genome are gathers, but a problem's bytes are consecutive
// in the source too (or reversed), so they coalesce; the kernel moves
// m * (qg + rg) bytes once each way, which is microseconds at the main
// path's shapes.
#include "sw_cells.cuh"

namespace ytsw {

enum { C_QROW, C_QSRC, C_QCOPY, C_QLEN, C_RSRC, C_RCOPY, C_RLEN, C_REV };

YT_HD int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Byte j (0 <= j < qg + rg) of problem k's assembled (q, r) pair.
YT_HD uint8_t gather_byte(int64_t k, int64_t j, int64_t m,
                          const uint8_t* rows2, int64_t nrows, int64_t lpad,
                          const uint8_t* codes, int64_t ncodes,
                          const int64_t* coords, int64_t qg, int32_t rpad) {
    const bool is_q = j < qg;
    const int64_t jj = is_q ? j : j - qg;
    const int64_t len = coords[(is_q ? C_QLEN : C_RLEN) * m + k];
    if (jj >= len) return is_q ? 0 : (uint8_t)rpad;
    const int64_t pos = coords[C_REV * m + k] ? len - 1 - jj : jj;
    if (pos >= coords[(is_q ? C_QCOPY : C_RCOPY) * m + k]) return 0;
    if (is_q) {
        const int64_t row = clamp64(coords[C_QROW * m + k], 0, nrows - 1);
        const int64_t col =
            clamp64(coords[C_QSRC * m + k] + pos, 0, lpad - 1);
        return rows2[row * lpad + col];
    }
    return codes[clamp64(coords[C_RSRC * m + k] + pos, 0, ncodes - 1)];
}

}  // namespace ytsw

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

constexpr int kGatherThreads = 256;

__global__ void gather_kernel(int64_t m, const uint8_t* rows2, int64_t nrows,
                              int64_t lpad, const uint8_t* codes,
                              int64_t ncodes, const int64_t* coords,
                              int64_t qg, int64_t rg, int32_t rpad,
                              uint8_t* q, uint8_t* r) {
    const int64_t g = qg + rg;
    for (int64_t k = blockIdx.y; k < m; k += gridDim.y)
        for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
             j < g; j += (int64_t)gridDim.x * blockDim.x) {
            const uint8_t v = ytsw::gather_byte(k, j, m, rows2, nrows, lpad,
                                                codes, ncodes, coords, qg,
                                                rpad);
            if (j < qg)
                q[k * qg + j] = v;
            else
                r[k * rg + (j - qg)] = v;
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
    const int64_t bx = (qg + rg + kGatherThreads - 1) / kGatherThreads;
    dim3 grid((unsigned)(bx < 1024 ? bx : 1024),
              (unsigned)(m < 65535 ? m : 65535));
    gather_kernel<<<grid, kGatherThreads, 0, (cudaStream_t)stream>>>(
        m, rows2, nrows, lpad, codes, ncodes, coords, qg, rg, rpad, q, r);
    return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
