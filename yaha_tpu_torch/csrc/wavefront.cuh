// What the two warp-per-problem wavefront kernels share (sm_90a):
// ext_wide_kernels.cu (the extension at -BW 0 and 9+) and the wide route
// of anch_kernels.cu (anchored gap fills wider than 32 columns).
//
// In both, lane k of a warp computes the rows 32 s + k + 1 of strip s, two
// steps behind lane k - 1, which hands it the row above's cells by a
// shuffle; lane 0 reads row 32 s from a shared-memory row (Band3 a column)
// that lane 31 writes.  A strip's codes are staged in shared memory ahead
// of use (stage_strip_codes), its plane rows are staged as bytes and
// copied out, contiguous in the problem's plane, as 16-byte stores
// (copy_share).  A warp's shared memory is the row of W + 1 Band3, two
// strip stages of 32 rows of W plane bytes and two strips' codes
// (wide_warp_bytes), W being the plane's row width.
//
// Everything here is __host__ __device__: without __CUDACC__ it compiles
// with g++, and tests/test_torch_csrc.py runs it over an emulated warp.
#pragma once

#include "sw_cells.cuh"

namespace ytsw {

constexpr int kWideLanes = 32;
constexpr int64_t kWideSmemMax = 232448;  // shared memory a block can have

// What a row hands to the row below at one column: the cell value and the
// insert run's value and length.  16 bytes, so that the shared row moves
// with one vector load or store.
struct alignas(16) Band3 {
    int32_t v, f, ii, pad;
};

YT_HD Band3 band3(int32_t v, int32_t f, int32_t ii) {
    Band3 b;
    b.v = v;
    b.f = f;
    b.ii = ii;
    b.pad = 0;
    return b;
}

// A warp's shared memory for plane rows of w bytes: the row of w + 1
// Band3, then two strip stages of 32 rows of w bytes (16 bytes of slack:
// the copy reads whole words past a strip's last byte), then two strips'
// codes: 32 query codes and w + 31 reference codes.
YT_HD int64_t wide_row_bytes(int64_t w) { return 16 * (w + 1); }
YT_HD int64_t wide_stage_bytes(int64_t w) {
    return (kWideLanes * w + 16 + 15) / 16 * 16;
}
YT_HD int64_t wide_code_bytes(int64_t w) {
    return (2 * kWideLanes + w + 15) / 16 * 16;
}
YT_HD int64_t wide_warp_bytes(int64_t w) {
    return wide_row_bytes(w) + 2 * wide_stage_bytes(w) +
           2 * wide_code_bytes(w);
}

// Lane `lane`'s share of staging a strip's codes: the query codes of rows
// i0 + 1 .. i0 + 32 (0 past ql), then nr reference codes from r0 on (255
// outside the reference).
YT_HD void stage_strip_codes(int lane, int64_t i0, const uint8_t* qp,
                             int64_t ql, const uint8_t* rp, int64_t rl,
                             int64_t r0, int32_t nr, uint8_t* codes) {
    for (int32_t x = lane; x < kWideLanes + nr; x += kWideLanes) {
        if (x < kWideLanes) {
            codes[x] = (uint8_t)(i0 + x < ql ? ld_u8(qp + i0 + x) : 0);
        } else {
            const int64_t ri = r0 + x - kWideLanes;
            codes[x] = (uint8_t)(ri >= 0 && ri < rl ? ld_u8(rp + ri) : 255);
        }
    }
}

YT_HD uint32_t funnel_r(uint32_t lo, uint32_t hi, int sh) {
#if defined(__CUDA_ARCH__)
    return __funnelshift_r(lo, hi, sh);
#else
    return sh ? (lo >> sh) | (hi << (32 - sh)) : lo;
#endif
}

YT_HD void store16(uint8_t* dst, const uint32_t (&w)[4]) {
#if defined(__CUDA_ARCH__)
    *(uint4*)dst = make_uint4(w[0], w[1], w[2], w[3]);
#else
    for (int m = 0; m < 4; m++)
        for (int b = 0; b < 4; b++) dst[4 * m + b] = (uint8_t)(w[m] >> 8 * b);
#endif
}

// Bytes from a staged strip (4-byte aligned, 16 bytes of slack).
struct StageSrc {
    const uint8_t* st;
    YT_HD uint8_t byte(int64_t o) const { return st[o]; }
    YT_HD void words(int64_t o, uint32_t (&out)[4]) const {
        const uint32_t* a = (const uint32_t*)(st + (o & ~(int64_t)3));
        const int sh = (int)(o & 3) * 8;
        uint32_t v[5];
        for (int m = 0; m < 5; m++) v[m] = a[m];
        for (int m = 0; m < 4; m++) out[m] = funnel_r(v[m], v[m + 1], sh);
    }
};

// Thread `lane` of `nt`'s share of writing len bytes from src to dst: the
// 16-byte aligned chunks, 16 bytes a store, thread-strided; the bytes
// before the first chunk and after the last, one a thread.
template <class Src>
YT_HD void copy_share(int lane, uint8_t* dst, int64_t len, const Src& src,
                      int nt = kWideLanes) {
    int64_t head = (int64_t)((16 - ((uintptr_t)dst & 15)) & 15);
    if (head > len) head = len;
    const int64_t chunks = (len - head) >> 4;
    const int64_t tail = head + 16 * chunks;
    for (int64_t o = lane; o < head; o += nt) dst[o] = src.byte(o);
    for (int64_t o = tail + lane; o < len; o += nt) dst[o] = src.byte(o);
    for (int64_t c = lane; c < chunks; c += nt) {
        uint32_t w[4];
        src.words(head + 16 * c, w);
        store16(dst + head + 16 * c, w);
    }
}

}  // namespace ytsw

#if defined(__CUDACC__)

namespace {

__device__ __forceinline__ ytsw::Band3 shfl_up3(const ytsw::Band3& b) {
    return ytsw::band3(__shfl_up_sync(0xffffffffu, b.v, 1),
                       __shfl_up_sync(0xffffffffu, b.f, 1),
                       __shfl_up_sync(0xffffffffu, b.ii, 1));
}

}  // namespace

#endif  // __CUDACC__
