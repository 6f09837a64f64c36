// Hopper (sm_90a) kernel of the batched fragment-chain DP.
//
// yt_chain_dp_cuda replaces chain_jax.batched_chain_dp
// (yaha_tpu/ops/chain_jax.py:38), the jnp program of
// buildBestClumpFromFragmentRange (GraphPath.cpp:161-270) over B ranges of
// N nodes: for each left node i in turn, every right node j > i is relaxed
// by i, and at the end the best node is folded in ascending order.  The
// contract (re-based diagonals, (SQO, diag) order, valid pads, int16
// score wraps, the tie cascade, the fold's order) is ops/chain.py's.
//
// What bounds it on an H100: its inputs and outputs, 33 bytes a node, or
// its int32 operations: each of the B * N^2 / 2 pairs of valid nodes takes
// a few tests (most pairs fail the diagonal gap), and the about 32 of a
// full relaxation only where the SQO, diagonal and SRO tests all pass.
// The dependency is the outer loop: node i's score is final
// once every earlier node has relaxed it, so the steps are sequential and
// each needs node i's final state.  So one team of threads takes one
// problem: a warp for N <= 64 (four problems a block), a block of 256 or
// 512 threads above.  Thread t owns the nodes j = t + T k (k < K): their
// inputs and their state (score, prev, pathSQO) stay in its registers for
// the whole DP.  At step i every thread reads node i from a two-slot record
// in shared memory, relaxes its own nodes j > i, and the owner of node
// i + 1 (final now) writes that node's record into the other slot; one
// barrier (__syncwarp or __syncthreads) ends the step.  The steps stop at
// the problem's last valid node.  The tie cascade compares with the stored
// edge's diagonal and query gaps; they are recomputed from the stored
// predecessor's diag and EQO, read from global memory only on an equal
// score, instead of carried in registers.  The fold keeps each thread's
// best in ascending order, then merges by shuffles (and across the warps
// of a block through shared memory) under the fold's total order: higher
// score, lower EQO, greater pathSQO, lower index, which gives the
// sequential fold's node.
//
// The per-thread body (ChainLane: load, relax, publish, fold, store) and
// the merge are __host__ __device__, so the CPU tests rehearse them with
// g++, a C loop over the threads of a team in place of the barrier.
#include "sw_cells.cuh"

namespace ytsw {

constexpr int32_t CHAIN_NO_SCORE = -0x7FFFFF00;

struct ChainParams {
    int32_t max_gap, max_desert, m_score, go_cost, ge_cost;
};

// Node i as every thread reads it at step i.
struct ChainNode {
    int32_t sqo, eqo, diag, score, psqo, valid;
};

// The fold's running best: node index (-1: none), score, EQO, pathSQO.
struct ChainBest {
    int32_t idx, score, eqo, psqo;
};

YT_HD int32_t wrap_i16(int32_t x) {
    return (int32_t)((uint32_t)wadd(x, 0x8000) & 0xFFFFu) - 0x8000;
}

YT_HD int32_t abs_w(int32_t x) { return x < 0 ? wsub(0, x) : x; }
YT_HD int32_t max_i(int32_t a, int32_t b) { return a > b ? a : b; }
YT_HD int32_t min_i(int32_t a, int32_t b) { return a < b ? a : b; }

YT_HD int32_t ld_i32(const int32_t* p) {
#if defined(__CUDA_ARCH__)
    return __ldg(p);
#else
    return *p;
#endif
}

// Node j (its sqo, eqo, diag, int16 length lw and state score / prev /
// psqo) relaxed by node i at step i (chain_jax relax; the caller checks
// that j > i and that both are valid).  eqo_of / diag_of are the problem's
// rows, read for the stored predecessor on an equal score only.
YT_HD void chain_relax(const ChainNode& ni, int32_t i, int32_t sqo,
                       int32_t diag, int32_t lw, int32_t& score,
                       int32_t& prev, int32_t& psqo, const int32_t* eqo_of,
                       const int32_t* diag_of, const ChainParams& p) {
    if (sqo <= ni.sqo) return;
    const int32_t dg = abs_w(wsub(diag, ni.diag));
    if (dg > p.max_gap) return;
    const int32_t sro = wadd(diag, sqo);
    if (sro <= wadd(ni.diag, ni.sqo)) return;
    const int32_t ero_i = wadd(ni.diag, ni.eqo);
    const int32_t q_gap = max_i(wsub(wsub(sqo, ni.eqo), 1), 0);
    const int32_t r_gap = max_i(wsub(wsub(sro, ero_i), 1), 0);
    if (min_i(q_gap, r_gap) > p.max_desert) return;
    const int32_t q_ov = max_i(wadd(wsub(ni.eqo, sqo), 1), 0);
    const int32_t r_ov = max_i(wadd(wsub(ero_i, sro), 1), 0);
    const int32_t nb = wsub(lw, max_i(q_ov, r_ov));
    if (nb < 1) return;
    const int32_t gap =
        dg > 0 ? wsub(0, wadd(p.go_cost, wmul(dg, p.ge_cost))) : 0;
    // `int newScore` (GraphPath.cpp:230): compared unwrapped.
    const int32_t ns = wadd(wadd(ni.score, wmul(nb, p.m_score)), gap);
    if (ns < score) return;
    if (ns == score) {
        // Tie cascade against the stored edge prev -> j
        // (GraphPath.cpp:239-251); psqo is that edge's pathSQO.
        if (prev < 0) return;
        const int32_t dcmp =
            wsub(dg, abs_w(wsub(diag, ld_i32(diag_of + prev))));
        if (dcmp > 0) return;
        if (dcmp == 0) {
            const int32_t pq =
                max_i(wsub(wsub(sqo, ld_i32(eqo_of + prev)), 1), 0);
            const int32_t gcmp = wsub(q_gap, pq);
            if (gcmp > 0) return;
            if (gcmp == 0 && ni.psqo <= psqo) return;
        }
    }
    score = wrap_i16(ns);
    prev = i;
    psqo = ni.psqo;
}

// True when c comes before b in the fold's order (b may be empty).
YT_HD bool chain_before(const ChainBest& c, const ChainBest& b) {
    if (c.idx < 0) return false;
    if (b.idx < 0) return true;
    if (c.score != b.score) return c.score > b.score;
    if (c.eqo != b.eqo) return c.eqo < b.eqo;
    if (c.psqo != b.psqo) return c.psqo > b.psqo;
    return c.idx < b.idx;
}

YT_HD ChainBest chain_merge(const ChainBest& a, const ChainBest& b) {
    return chain_before(b, a) ? b : a;
}

// One thread's nodes j = t + T k (k < K) of a team of T threads: inputs and
// state in registers (every index a compile-time constant after
// unrolling).
template <int K>
struct ChainLane {
    int32_t sqo[K], eqo[K], diag[K], lw[K], score[K], prev[K], psqo[K];
    uint32_t valid;  // bit k: node t + T k is below n and valid

    YT_HD void load(const int32_t* sqo_p, const int32_t* eqo_p,
                    const int32_t* diag_p, const int32_t* len_p,
                    const uint8_t* valid_p, int32_t n, int t, int T,
                    const ChainParams& p) {
        valid = 0;
#pragma unroll
        for (int k = 0; k < K; k++) {
            const int32_t j = t + T * k;
            const bool in = j < n;
            sqo[k] = in ? sqo_p[j] : 0;
            eqo[k] = in ? eqo_p[j] : 0;
            diag[k] = in ? diag_p[j] : 0;
            lw[k] = wrap_i16(in ? len_p[j] : 0);
            score[k] = wrap_i16(wmul(lw[k], p.m_score));
            prev[k] = -1;
            psqo[k] = sqo[k];
            if (in && valid_p[j]) valid |= 1u << k;
        }
    }

    // The thread's last valid node, or -1.
    YT_HD int32_t last_valid(int t, int T) const {
        int32_t last = -1;
#pragma unroll
        for (int k = 0; k < K; k++)
            if ((valid >> k) & 1u) last = t + T * k;
        return last;
    }

    YT_HD void relax(const ChainNode& ni, int32_t i, int t, int T,
                     const int32_t* eqo_of, const int32_t* diag_of,
                     const ChainParams& p) {
#pragma unroll
        for (int k = 0; k < K; k++)
            if (t + T * k > i && ((valid >> k) & 1u))
                chain_relax(ni, i, sqo[k], diag[k], lw[k], score[k],
                            prev[k], psqo[k], eqo_of, diag_of, p);
    }

    // Node o's record into *out when this thread owns it.
    YT_HD void publish(int32_t o, int t, int T, ChainNode* out) const {
        if (o % T != t) return;
        const int ko = o / T;
#pragma unroll
        for (int k = 0; k < K; k++)
            if (k == ko) {
                out->sqo = sqo[k];
                out->eqo = eqo[k];
                out->diag = diag[k];
                out->score = score[k];
                out->psqo = psqo[k];
                out->valid = (int32_t)((valid >> k) & 1u);
            }
    }

    // The best of the thread's valid nodes, in ascending order.
    YT_HD ChainBest fold(int t, int T) const {
        ChainBest b = {-1, CHAIN_NO_SCORE, 0, 0};
#pragma unroll
        for (int k = 0; k < K; k++)
            if ((valid >> k) & 1u) {
                const ChainBest c = {t + T * k, score[k], eqo[k], psqo[k]};
                b = chain_merge(b, c);
            }
        return b;
    }

    YT_HD void store(int32_t* prev_p, int32_t* psqo_p, int32_t n, int t,
                     int T) const {
#pragma unroll
        for (int k = 0; k < K; k++) {
            const int32_t j = t + T * k;
            if (j < n) {
                prev_p[j] = prev[k];
                psqo_p[j] = psqo[k];
            }
        }
    }
};

// The team for N nodes: (K nodes a thread, T threads); T = 0 when N is
// beyond the kernel (more than 4,096 nodes).
YT_HD void chain_team(int64_t n, int* K, int* T) {
    const int64_t cfg[][3] = {{32, 1, 32},    {64, 2, 32},   {256, 1, 256},
                              {512, 2, 256},  {1024, 4, 256},
                              {2048, 8, 256}, {4096, 8, 512}};
    *K = 0;
    *T = 0;
    for (const auto& c : cfg)
        if (n <= c[0]) {
            *K = (int)c[1];
            *T = (int)c[2];
            return;
        }
}

}  // namespace ytsw

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

constexpr int kChainWarps = 4;  // problems a block when a warp takes one

template <int T>
__device__ __forceinline__ void team_sync() {
    if (T == 32)
        __syncwarp();
    else
        __syncthreads();
}

__device__ __forceinline__ ytsw::ChainBest shfl_best(ytsw::ChainBest b,
                                                     int off) {
    ytsw::ChainBest o;
    o.idx = __shfl_down_sync(0xffffffffu, b.idx, off);
    o.score = __shfl_down_sync(0xffffffffu, b.score, off);
    o.eqo = __shfl_down_sync(0xffffffffu, b.eqo, off);
    o.psqo = __shfl_down_sync(0xffffffffu, b.psqo, off);
    return o;
}

__device__ __forceinline__ ytsw::ChainBest warp_best(ytsw::ChainBest b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        b = ytsw::chain_merge(b, shfl_best(b, off));
    return b;
}

// One problem a team of T threads (T = 32: kChainWarps problems a block,
// a warp each; else one problem a block).
template <int K, int T>
__global__ void __launch_bounds__(T == 32 ? 32 * kChainWarps : T)
chain_dp_kernel(const int32_t* sqo, const int32_t* eqo, const int32_t* diag,
                const int32_t* len, const uint8_t* valid, int64_t b,
                int32_t n, ytsw::ChainParams p, int32_t* best,
                int32_t* best_score, int32_t* prev, int32_t* path_sqo) {
    constexpr int G = T == 32 ? kChainWarps : 1;
    __shared__ ytsw::ChainNode rec[G][2];
    __shared__ int32_t last_sh;
    __shared__ ytsw::ChainBest warp_sh[T / 32];
    const int g = threadIdx.x / T;
    const int t = threadIdx.x % T;
    const int64_t prob = blockIdx.x * (int64_t)G + g;
    if (prob >= b) return;  // a whole warp (T = 32) or block leaves
    const int64_t base = prob * n;
    ytsw::ChainLane<K> lane;
    lane.load(sqo + base, eqo + base, diag + base, len + base, valid + base,
              n, t, T, p);
    int32_t last = lane.last_valid(t, T);
    if (T == 32) {
        last = __reduce_max_sync(0xffffffffu, last);
    } else {
        if (t == 0) last_sh = -1;
        __syncthreads();
        atomicMax(&last_sh, last);
        __syncthreads();
        last = last_sh;
    }
    lane.publish(0, t, T, &rec[g][0]);
    team_sync<T>();
    for (int32_t i = 0; i < last; i++) {
        const ytsw::ChainNode ni = rec[g][i & 1];
        if (ni.valid)
            lane.relax(ni, i, t, T, eqo + base, diag + base, p);
        lane.publish(i + 1, t, T, &rec[g][(i + 1) & 1]);
        team_sync<T>();
    }
    lane.store(prev + base, path_sqo + base, n, t, T);
    ytsw::ChainBest bb = warp_best(lane.fold(t, T));
    if (T > 32) {
        if ((t & 31) == 0) warp_sh[t / 32] = bb;
        __syncthreads();
        if (t >= 32) return;
        bb = t < T / 32 ? warp_sh[t] : ytsw::ChainBest{-1, 0, 0, 0};
        bb = warp_best(bb);
    }
    if (t == 0) {
        best[prob] = bb.idx;
        best_score[prob] = bb.idx < 0 ? ytsw::CHAIN_NO_SCORE : bb.score;
    }
}

template <int K, int T>
void launch_chain(const int32_t* sqo, const int32_t* eqo,
                  const int32_t* diag, const int32_t* len,
                  const uint8_t* valid, int64_t b, int32_t n,
                  const ytsw::ChainParams& p, int32_t* best,
                  int32_t* best_score, int32_t* prev, int32_t* path_sqo,
                  cudaStream_t stream) {
    constexpr int G = T == 32 ? kChainWarps : 1;
    chain_dp_kernel<K, T><<<(unsigned)((b + G - 1) / G), T * G, 0,
                            stream>>>(sqo, eqo, diag, len, valid, b, n, p,
                                      best, best_score, prev, path_sqo);
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue (launching nothing) for N
// beyond the kernel's teams.
int yt_chain_dp_cuda(const int32_t* sqo, const int32_t* eqo,
                     const int32_t* diag, const int32_t* len,
                     const uint8_t* valid, int64_t b, int64_t n,
                     int32_t max_gap, int32_t max_desert, int32_t m_score,
                     int32_t go_cost, int32_t ge_cost, int32_t* best,
                     int32_t* best_score, int32_t* prev, int32_t* path_sqo,
                     void* stream) {
    const ytsw::ChainParams p = {max_gap, max_desert, m_score, go_cost,
                                 ge_cost};
    int K, T;
    ytsw::chain_team(n, &K, &T);
    const cudaStream_t s = (cudaStream_t)stream;
#define YT_CHAIN(kk, tt)                                                   \
    if (K == kk && T == tt) {                                              \
        launch_chain<kk, tt>(sqo, eqo, diag, len, valid, b, (int32_t)n, p, \
                             best, best_score, prev, path_sqo, s);         \
        return (int)cudaGetLastError();                                    \
    }
    YT_CHAIN(1, 32)
    YT_CHAIN(2, 32)
    YT_CHAIN(1, 256)
    YT_CHAIN(2, 256)
    YT_CHAIN(4, 256)
    YT_CHAIN(8, 256)
    YT_CHAIN(8, 512)
#undef YT_CHAIN
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"

#endif  // __CUDACC__
