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
// The dependency is the relaxation's order: node i's score is final once
// every earlier node has relaxed it, and a node's relaxations must come in
// ascending i (the int16 wrap of the stored score and the tie cascade make
// them order-dependent).  But whether i can relax j at all (valid, SQO,
// diagonal gap, SRO, desert, new bases: chain_pair) reads only the two
// nodes' inputs, never the DP state; on the ranges chip_smoke.py draws
// 74-91 % of the nodes have no candidate successor, and the candidates of
// a node lie a few nodes after it in SQO order.  So:
//
//   * one team of threads takes one range: a warp for N <= 64 (four ranges
//     a block), a block of 256 or 512 threads above; thread t owns the
//     nodes j = t + T k (k < K), whose inputs and state (score, prev,
//     pathSQO) stay in its registers;
//   * the pair tests first, off the serial chain: the range's inputs go to
//     shared memory (16 bytes a node), and every thread scans, for each
//     of its nodes i, the nodes j > i up to the range's last valid one;
//     a candidate sets bit i of a shared bitmask ("i has a candidate
//     successor"); one barrier.  Where the range allows it (chain_small:
//     no int32 wrap is possible, and SQO never falls from one valid node
//     to the next, as the contract's order has it), the scan stops at the
//     first valid j with sqo_j - eqo_i - 1 > max_desert + max_gap: that j
//     and every later one fail the desert test.  So the pairs tested are
//     about n times the nodes in that SQO window (some 6 at N = 2,048 on
//     chip_smoke.py's ranges) instead of n^2 / 2, and that j is kept as
//     i's window end; a range that does not allow it is scanned to i's
//     first candidate, on the card all the same;
//   * then the steps, only at the set bits, in ascending i: every thread
//     reads node i's score and pathSQO from a two-slot record, relaxes its
//     own nodes j between i and i's window end (chain_relax, which repeats
//     the pair test; a warp with no node there leaves the step at once),
//     and the owner of the next set bit (final now: only steps before it
//     changed it) writes that node's record into the other slot; one
//     barrier (__syncwarp or __syncthreads) ends the step.  The steps
//     number the nodes with a candidate successor instead of N;
//   * the tie cascade compares with the stored edge's diagonal and query
//     gaps, recomputed from the stored predecessor's inputs in shared
//     memory on an equal score;
//   * the fold keeps each thread's best in ascending order, then merges by
//     shuffles (and across the warps of a block through shared memory)
//     under the fold's total order: higher score, lower EQO, greater
//     pathSQO, lower index, which gives the sequential fold's node.
//
// The first version of this kernel ran a step, and a barrier, for every
// node up to the last valid one, and tested every pair inside it.  On the
// H100, taking the steps alone off the chain (every pair still tested
// before them) gained 10 % at N = 2,048 and lost 13 % at N = 64: the pair
// tests set its time.  The SQO window and the warps' skip then took N =
// 2,048 from 1.74 to 0.27 ms, nine tenths of it in the steps; a warp a
// range with the state in shared memory (no block barrier) was slower,
// 0.31 ms, as 64 KB a range leaves three warps an SM.  Every range fits
// the layout (shared memory grows with N: 80 KB at N = 4,096).
//
// The per-thread body (ChainLane: load, window_ok, mark, relax, publish,
// fold, store) and the merge are __host__ __device__, so the CPU tests
// rehearse them with g++, a C loop over the threads of a team in place of
// the barrier.
#include "sw_cells.cuh"

namespace ytsw {

constexpr int32_t CHAIN_NO_SCORE = -0x7FFFFF00;

struct ChainParams {
    int32_t max_gap, max_desert, m_score, go_cost, ge_cost;
};

// A node's inputs as the team keeps them in shared memory: lv holds its
// int16 length (wrapped) times 2, plus 1 if the node is valid.
struct alignas(16) ChainStatic {
    int32_t sqo, eqo, diag, lv;
    YT_HD bool valid() const { return lv & 1; }
    YT_HD int32_t lw() const { return lv >> 1; }
};

// Node i's state as every thread reads it at step i.
struct ChainState {
    int32_t score, psqo;
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

// Whether node i can relax node j (sqo, diag, int16 length lw), from the
// two nodes' inputs alone (chain_jax's candidate test; the caller checks
// j > i and both valid), with the diagonal and query gaps and the new
// bases the relaxation goes on with.
struct ChainPair {
    bool ok;
    int32_t dg, q_gap, nb;
};

YT_HD ChainPair chain_pair(const ChainStatic& ni, int32_t sqo, int32_t diag,
                           int32_t lw, const ChainParams& p) {
    ChainPair c = {false, 0, 0, 0};
    if (sqo <= ni.sqo) return c;
    c.dg = abs_w(wsub(diag, ni.diag));
    if (c.dg > p.max_gap) return c;
    const int32_t sro = wadd(diag, sqo);
    if (sro <= wadd(ni.diag, ni.sqo)) return c;
    const int32_t ero_i = wadd(ni.diag, ni.eqo);
    c.q_gap = max_i(wsub(wsub(sqo, ni.eqo), 1), 0);
    const int32_t r_gap = max_i(wsub(wsub(sro, ero_i), 1), 0);
    if (min_i(c.q_gap, r_gap) > p.max_desert) return c;
    const int32_t q_ov = max_i(wadd(wsub(ni.eqo, sqo), 1), 0);
    const int32_t r_ov = max_i(wadd(wsub(ero_i, sro), 1), 0);
    c.nb = wsub(lw, max_i(q_ov, r_ov));
    c.ok = c.nb >= 1;
    return c;
}

// Node j (its sqo, diag, int16 length lw and state score / prev / psqo)
// relaxed by node i, whose inputs are st[i] and final state si (chain_jax
// relax; the caller checks that j > i and that both are valid).  st holds
// the range's inputs, read for the stored predecessor on an equal score.
YT_HD void chain_relax(const ChainStatic* st, int32_t i, const ChainState& si,
                       int32_t sqo, int32_t diag, int32_t lw, int32_t& score,
                       int32_t& prev, int32_t& psqo, const ChainParams& p) {
    const ChainPair c = chain_pair(st[i], sqo, diag, lw, p);
    if (!c.ok) return;
    const int32_t gap =
        c.dg > 0 ? wsub(0, wadd(p.go_cost, wmul(c.dg, p.ge_cost))) : 0;
    // `int newScore` (GraphPath.cpp:230): compared unwrapped.
    const int32_t ns = wadd(wadd(si.score, wmul(c.nb, p.m_score)), gap);
    if (ns < score) return;
    if (ns == score) {
        // Tie cascade against the stored edge prev -> j
        // (GraphPath.cpp:239-251); psqo is that edge's pathSQO.
        if (prev < 0) return;
        const int32_t dcmp = wsub(c.dg, abs_w(wsub(diag, st[prev].diag)));
        if (dcmp > 0) return;
        if (dcmp == 0) {
            const int32_t pq =
                max_i(wsub(wsub(sqo, st[prev].eqo), 1), 0);
            const int32_t gcmp = wsub(c.q_gap, pq);
            if (gcmp > 0) return;
            if (gcmp == 0 && si.psqo <= psqo) return;
        }
    }
    score = wrap_i16(ns);
    prev = i;
    psqo = si.psqo;
}

// Bit i of a team's candidate bitmask.
YT_HD void chain_set_bit(uint32_t* bits, int32_t i) {
#if defined(__CUDA_ARCH__)
    atomicOr(bits + (i >> 5), 1u << (i & 31));
#else
    bits[i >> 5] |= 1u << (i & 31);
#endif
}

// The first set bit at or after `from`, or n.
YT_HD int32_t chain_next_bit(const uint32_t* bits, int32_t from, int32_t n) {
    if (from >= n) return n;
    int32_t wi = from >> 5;
    uint32_t w = bits[wi] & (~0u << (from & 31));
    const int32_t nw = (n + 31) >> 5;
    while (w == 0) {
        if (++wi >= nw) return n;
        w = bits[wi];
    }
#if defined(__CUDA_ARCH__)
    const int32_t b = __ffs(w) - 1;
#else
    const int32_t b = __builtin_ctz(w);
#endif
    const int32_t i = (wi << 5) + b;
    return i < n ? i : n;
}

// The SQO window.  Where no int32 expression of the pair test can wrap
// (every valid node's sqo, eqo and diag within +-2^28, max_gap and
// max_desert in [0, 2^28)) and the valid nodes' SQO never falls from one
// valid node to the next, a valid j with sqo_j - eqo_i - 1 > max_desert +
// max_gap fails the test against i, and so does every later valid j: its
// query gap is past max_desert + max_gap, and a diagonal gap within
// max_gap leaves the reference gap past max_desert.  So i's scan for a
// candidate successor stops there.
constexpr int32_t kChainSmall = 1 << 28;

YT_HD bool chain_small(int32_t x) {
    return x > -kChainSmall && x < kChainSmall;
}

YT_HD bool chain_window_params(const ChainParams& p) {
    return p.max_gap >= 0 && p.max_gap < kChainSmall && p.max_desert >= 0 &&
           p.max_desert < kChainSmall;
}

// A team's shared memory for N nodes: the inputs (16 bytes a node), each
// node's window end (4 bytes), then the bitmask; a multiple of 16 bytes,
// so that the next team's inputs stay 16-byte aligned.
YT_HD int64_t chain_team_bytes(int64_t n) {
    return (20 * n + (n + 31) / 32 * 4 + 15) / 16 * 16;
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
    int32_t sqo[K], diag[K], lw[K], score[K], prev[K], psqo[K];
    uint32_t valid;  // bit k: node t + T k is below n and valid

    // The thread's nodes from device memory, their inputs also into the
    // team's st.
    YT_HD void load(const int32_t* sqo_p, const int32_t* eqo_p,
                    const int32_t* diag_p, const int32_t* len_p,
                    const uint8_t* valid_p, int32_t n, int t, int T,
                    const ChainParams& p, ChainStatic* st) {
        valid = 0;
#pragma unroll
        for (int k = 0; k < K; k++) {
            const int32_t j = t + T * k;
            const bool in = j < n;
            sqo[k] = in ? sqo_p[j] : 0;
            diag[k] = in ? diag_p[j] : 0;
            lw[k] = wrap_i16(in ? len_p[j] : 0);
            score[k] = wrap_i16(wmul(lw[k], p.m_score));
            prev[k] = -1;
            psqo[k] = sqo[k];
            if (in && valid_p[j]) valid |= 1u << k;
            if (in)
                st[j] = ChainStatic{
                    sqo[k], eqo_p[j], diag[k],
                    (int32_t)((uint32_t)lw[k] << 1 | ((valid >> k) & 1u))};
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

    // Whether the thread's valid nodes allow the SQO window: small
    // values, and no fall in SQO from the previous valid node (st, every
    // node's inputs, is complete).
    YT_HD bool window_ok(const ChainStatic* st, int t, int T) const {
        bool ok = true;
#pragma unroll
        for (int k = 0; k < K; k++) {
            if (!((valid >> k) & 1u)) continue;
            const int32_t j = t + T * k;
            const ChainStatic& me = st[j];
            ok = ok && chain_small(me.sqo) && chain_small(me.eqo) &&
                 chain_small(me.diag);
            int32_t q = j - 1;
            while (q >= 0 && !st[q].valid()) q--;
            if (q >= 0) ok = ok && st[q].sqo <= me.sqo;
        }
        return ok;
    }

    // The pair tests, off the serial chain: bit i of `bits` for each of
    // the thread's valid nodes i that can relax some valid j > i, and
    // jend[i], past which no node is a candidate: with `windowed`, the
    // first valid j past the SQO window (the scan stops there), else the
    // scan stops at i's first candidate and jend[i] is last + 1 (last: the
    // range's last valid node).
    YT_HD void mark(const ChainStatic* st, int32_t* jend, uint32_t* bits,
                    int32_t last, bool windowed, int t, int T,
                    const ChainParams& p) const {
        const int64_t lim = (int64_t)p.max_desert + p.max_gap;
#pragma unroll
        for (int k = 0; k < K; k++) {
            if (!((valid >> k) & 1u)) continue;
            const int32_t i = t + T * k;
            const ChainStatic ni = st[i];
            int32_t end = last + 1;
            bool hit = false;
            for (int32_t j = i + 1; j <= last; j++) {
                const ChainStatic nj = st[j];
                if (!nj.valid()) continue;
                if (windowed && (int64_t)nj.sqo - ni.eqo - 1 > lim) {
                    end = j;
                    break;
                }
                if (!hit && chain_pair(ni, nj.sqo, nj.diag, nj.lw(), p).ok) {
                    hit = true;
                    if (!windowed) break;
                }
            }
            if (hit) chain_set_bit(bits, i);
            jend[i] = end;
        }
    }

    // Step i: the thread's valid nodes j in (i, end) relaxed by node i
    // (end = jend[i]; no node from end on is a candidate).  A warp none of
    // whose nodes falls in that span leaves at once (the span is a few
    // nodes, owned by one or two warps); a node past max_gap of i's
    // diagonal fails the pair test, so a first pass finds the nodes left.
    YT_HD void relax(const ChainStatic* st, int32_t i, int32_t end,
                     const ChainState& si, int t, int T,
                     const ChainParams& p) {
        if (end - i - 1 < T) {
            // Residues mod T of the span [i + 1, end - 1] against the
            // warp's lanes (warp-uniform).
            const int32_t a = (i + 1) % T, z = (end - 1 + T) % T;
            const int32_t w0 = t & ~31, w1 = w0 + 31;
            const bool mine = end - i - 1 <= 0 ? false
                              : a <= z ? z >= w0 && a <= w1
                                       : a <= w1 || z >= w0;
            if (!mine) return;
        }
        const ChainStatic ni = st[i];
        uint32_t left = 0;
#pragma unroll
        for (int k = 0; k < K; k++) {
            const int32_t j = t + T * k;
            const bool c = j > i && j < end && ((valid >> k) & 1u) &&
                           abs_w(wsub(diag[k], ni.diag)) <= p.max_gap;
            left |= (uint32_t)c << k;
        }
        if (!left) return;
#pragma unroll
        for (int k = 0; k < K; k++)
            if ((left >> k) & 1u)
                chain_relax(st, i, si, sqo[k], diag[k], lw[k], score[k],
                            prev[k], psqo[k], p);
    }

    // Node o's state into *out when this thread owns it.
    YT_HD void publish(int32_t o, int t, int T, ChainState* out) const {
        if (o % T != t) return;
        const int ko = o / T;
#pragma unroll
        for (int k = 0; k < K; k++)
            if (k == ko) *out = ChainState{score[k], psqo[k]};
    }

    // The best of the thread's valid nodes, in ascending order.
    YT_HD ChainBest fold(const ChainStatic* st, int t, int T) const {
        ChainBest b = {-1, CHAIN_NO_SCORE, 0, 0};
#pragma unroll
        for (int k = 0; k < K; k++)
            if ((valid >> k) & 1u) {
                const int32_t j = t + T * k;
                const ChainBest c = {j, score[k], st[j].eqo, psqo[k]};
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

// Whether x holds on every thread of the team (a barrier as well).
template <int T>
__device__ __forceinline__ bool team_all(bool x) {
    if (T == 32) return __all_sync(0xffffffffu, x);
    return __syncthreads_and(x);
}

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

// One range a team of T threads (T = 32: kChainWarps ranges a block, a
// warp each; else one range a block); each team's shared memory is
// chain_team_bytes(n): the range's inputs, then its candidate bitmask.
template <int K, int T>
__global__ void __launch_bounds__(T == 32 ? 32 * kChainWarps : T)
chain_dp_kernel(const int32_t* sqo, const int32_t* eqo, const int32_t* diag,
                const int32_t* len, const uint8_t* valid, int64_t b,
                int32_t n, ytsw::ChainParams p, int32_t* best,
                int32_t* best_score, int32_t* prev, int32_t* path_sqo) {
    constexpr int G = T == 32 ? kChainWarps : 1;
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ ytsw::ChainState rec[G][2];
    __shared__ int32_t last_sh;
    __shared__ ytsw::ChainBest warp_sh[T / 32];
    const int g = threadIdx.x / T;
    const int t = threadIdx.x % T;
    const int64_t prob = blockIdx.x * (int64_t)G + g;
    if (prob >= b) return;  // a whole warp (T = 32) or block leaves
    uint8_t* team = smem + g * ytsw::chain_team_bytes(n);
    ytsw::ChainStatic* st = (ytsw::ChainStatic*)team;
    int32_t* jend = (int32_t*)(team + 16 * (int64_t)n);
    uint32_t* bits = (uint32_t*)(team + 20 * (int64_t)n);
    const int64_t base = prob * n;
    if (T > 32 && t == 0) last_sh = -1;
    for (int32_t x = t; x < (n + 31) / 32; x += T) bits[x] = 0;
    ytsw::ChainLane<K> lane;
    lane.load(sqo + base, eqo + base, diag + base, len + base, valid + base,
              n, t, T, p, st);
    int32_t last = lane.last_valid(t, T);
    if (T == 32) {
        last = __reduce_max_sync(0xffffffffu, last);
    } else {
        __syncthreads();
        atomicMax(&last_sh, last);
    }
    team_sync<T>();
    if (T > 32) last = last_sh;
    const bool windowed =
        team_all<T>(lane.window_ok(st, t, T)) && ytsw::chain_window_params(p);
    lane.mark(st, jend, bits, last, windowed, t, T, p);
    team_sync<T>();
    int32_t i = ytsw::chain_next_bit(bits, 0, n);
    if (i < n) lane.publish(i, t, T, &rec[g][0]);
    team_sync<T>();
    for (int slot = 0; i < n; slot ^= 1) {
        const ytsw::ChainState si = rec[g][slot];
        lane.relax(st, i, jend[i], si, t, T, p);
        const int32_t nx = ytsw::chain_next_bit(bits, i + 1, n);
        if (nx < n) lane.publish(nx, t, T, &rec[g][slot ^ 1]);
        team_sync<T>();
        i = nx;
    }
    lane.store(prev + base, path_sqo + base, n, t, T);
    ytsw::ChainBest bb = warp_best(lane.fold(st, t, T));
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
int launch_chain(const int32_t* sqo, const int32_t* eqo, const int32_t* diag,
                 const int32_t* len, const uint8_t* valid, int64_t b,
                 int32_t n, const ytsw::ChainParams& p, int32_t* best,
                 int32_t* best_score, int32_t* prev, int32_t* path_sqo,
                 cudaStream_t stream) {
    constexpr int G = T == 32 ? kChainWarps : 1;
    const size_t smem = (size_t)(G * ytsw::chain_team_bytes(n));
    const cudaError_t e = cudaFuncSetAttribute(
        chain_dp_kernel<K, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    chain_dp_kernel<K, T><<<(unsigned)((b + G - 1) / G), T * G, smem,
                            stream>>>(sqo, eqo, diag, len, valid, b, n, p,
                                      best, best_score, prev, path_sqo);
    return (int)cudaGetLastError();
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
    if (K == kk && T == tt)                                                \
        return launch_chain<kk, tt>(sqo, eqo, diag, len, valid, b,         \
                                    (int32_t)n, p, best, best_score, prev, \
                                    path_sqo, s);
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
