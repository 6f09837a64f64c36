// Hopper (sm_90a) kernel of the staged engine's device backtrack walk.
//
// yt_rle_walk replaces decode_jax.rle_decode_band and rle_decode_full
// (yaha_tpu/ops/decode_jax.py:208, :222): it walks each problem's packed
// backtrack plane (sw_kernels.cu) on the device and writes only the
// run-length items, int32 op << 28 | len, so the planes never leave the
// card.  The walk is the native packed-plane walker's
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
// cap items and n_ops = -1.  A cell outside the plane reads as OP_UNKNOWN,
// so a walk always ends: every step lowers y * (w + 1) + x.
//
// The TPU version's jump plane (capped at 255 cells), time-major emission
// buffer with sort compaction and slice plan exist because the TPU
// vectorises over problems; here one thread owns one problem and writes
// its items straight into its row.  What bounds it: each step is one
// dependent byte load from that problem's plane (latency, not bandwidth);
// with one walk per thread, thousands of walks keep the loads in flight.
#include "sw_cells.cuh"

namespace ytsw {

YT_HD int32_t plane_at(const int8_t* pl, int64_t h, int64_t w, int64_t y,
                       int64_t x) {
    if (y < 0 || y >= h || x < 0 || x >= w) return OP_UNKNOWN;
    return (int32_t)(uint8_t)pl[y * w + x];
}

template <bool kFull>
YT_HD void rle_walk_problem(int64_t p, const int8_t* bt, int64_t h,
                            int64_t w, const int32_t* y0, const int32_t* x0,
                            const uint8_t* active, int64_t cap,
                            int32_t* rle, int32_t* n_ops) {
    const int8_t* pl = bt + p * h * w;
    int32_t* out = rle + p * cap;
    int64_t y = y0[p], x = x0[p];
    int64_t cnt = 0, run = 0;
    int32_t prev = OP_UNKNOWN;
    for (bool live = active[p] != 0; live;) {
        const int32_t code = plane_at(pl, h, w, y, x) & 7;
        if (code == OP_UNKNOWN) break;
        int64_t len = 1;
        if (code == OP_DELETE) {
            for (int64_t xx = x; plane_at(pl, h, w, y, xx) & BT_CD; xx--)
                len++;
            x -= len;
        } else if (code == OP_INSERT) {
            for (int64_t yy = y, xx = x; plane_at(pl, h, w, yy, xx) & BT_CF;
                 yy--, xx += kFull ? 0 : 1)
                len++;
            y -= len;
            if (!kFull) x += len;
        } else {
            y -= 1;
            if (kFull) x -= 1;
        }
        if (code == prev) {
            run += len;
            continue;
        }
        if (prev != OP_UNKNOWN) {
            if (cnt < cap)
                out[cnt] = (int32_t)(((uint32_t)prev << 28) |
                                     ((uint32_t)run & 0x0FFFFFFFu));
            cnt++;
        }
        prev = code;
        run = len;
    }
    if (prev != OP_UNKNOWN) {
        if (cnt < cap)
            out[cnt] = (int32_t)(((uint32_t)prev << 28) |
                                 ((uint32_t)run & 0x0FFFFFFFu));
        cnt++;
    }
    n_ops[p] = cnt > cap ? -1 : (int32_t)cnt;
}

}  // namespace ytsw

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

constexpr int kWalkThreads = 128;

template <bool kFull>
__global__ void rle_walk_kernel(int64_t n, const int8_t* bt, int64_t h,
                                int64_t w, const int32_t* y0,
                                const int32_t* x0, const uint8_t* active,
                                int64_t cap, int32_t* rle, int32_t* n_ops) {
    for (int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; p < n;
         p += (int64_t)gridDim.x * blockDim.x)
        ytsw::rle_walk_problem<kFull>(p, bt, h, w, y0, x0, active, cap, rle,
                                      n_ops);
}

}  // namespace

extern "C" {

// full != 0 walks full-layout planes, else band-layout ones.  Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
int yt_rle_walk(const int8_t* bt, int64_t n, int64_t h, int64_t w,
                const int32_t* y0, const int32_t* x0, const uint8_t* active,
                int64_t cap, int32_t full, int32_t* rle, int32_t* n_ops,
                void* stream) {
    const int64_t b = (n + kWalkThreads - 1) / kWalkThreads;
    const unsigned grid = (unsigned)(b < 65535 ? b : 65535);
    cudaStream_t st = (cudaStream_t)stream;
    if (full)
        rle_walk_kernel<true><<<grid, kWalkThreads, 0, st>>>(
            n, bt, h, w, y0, x0, active, cap, rle, n_ops);
    else
        rle_walk_kernel<false><<<grid, kWalkThreads, 0, st>>>(
            n, bt, h, w, y0, x0, active, cap, rle, n_ops);
    return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
