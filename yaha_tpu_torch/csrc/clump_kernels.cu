// Hopper (sm_90a) kernel of the device seeder's fragments-to-clumps stage.
//
// hits_clump_kernel turns each strand row of the seeder's sorted hits
// (expand_sort_kernel's or the mesh merge's [rows, C] (diag, qo) buffers)
// into that row's clumps: the coalesce (a qo step above word_len on a
// diagonal starts a fragment), the region split (a diagonal step above
// max_gap), and per region the extraction rounds of the host's
// yt_frags_to_clumps (native/yaha_host.cpp): unused fragments stable-sorted
// by (SQO, diag), the chain DP of yt_chain_dp, the prepend insert whose
// f1.eqo chop persists across rounds, clean_up_clump, coverage and
// elimination, and the stop when a clump matches fewer than min_match
// bases.  Its contract is yt_hits_to_clumps on the same row, byte for byte
// (ops/clumps.py has the plain version, which runs that function).
//
// No TPU kernel is replaced: the JAX package leaves this stage on the host.
// It was added because with the device seeder the host's
// fragments-to-clumps led phase 1, and every row's hits (about 540 a
// strand row at 1 kb) crossed to the host to become a few clumps there.
// What bounds it on an H100: the hit rows it reads, 8 bytes a hit, and the
// clumps it writes; its work is a pass over the hits with warp ballots and
// a chain DP over each multi-fragment region, about 25 fragments for a
// 1 kb read, and single-fragment regions (the random hits) cost a ballot
// and are dropped in bulk.  So:
//
//   * a warp takes a row (kClumpWarps rows a block); each lane reads one
//     hit of a chunk of 32 and its two neighbours, and four ballots give
//     the fragment and region starts and ends of the chunk;
//   * a region that ends in its chunk with one fragment shorter than
//     min_match makes no clump and is skipped with no further work; the
//     other regions' fragments go to the warp's shared memory (at most
//     kClumpRegion), where the rounds run;
//   * the chain DP pulls node j from the nodes i < j, a lane each: where no
//     stored score can wrap to int16 (q_len * m_score <= 32,767, or the
//     wide scores of reads past 32 kb) the lanes' candidates reduce by a
//     warp argmax in the tie cascade's order (score, smaller diagonal gap,
//     smaller query gap, greater pathSQO, earlier node), which picks the
//     node the sequential relaxation keeps; otherwise lane after lane in
//     ascending i, the sequential fold itself;
//   * the path walk, the insert with its chops and clean_up_clump run on
//     lane 0 (a path holds a few fragments); the elimination and the
//     clump's copy out run across the lanes; coverage is kept as the
//     region's clump spans (at most kClumpCover), not as a bitmap of q_len;
//   * each row's clumps go to its slot of a [rows, W] int32 plane as a
//     record: clumps, fragments, skipped regions, then per clump its
//     fragment count, its matched bases and (sqo, eqo, sro) a fragment.
//     meta[row] is the record's length, 0 for a row not served, -1 for a
//     row past a capacity (a region of more than kClumpRegion fragments, a
//     record longer than W, a region of more than kClumpCover clumps),
//     which the seeder sends to the host path.
//
// The body (clump_row) is __host__ __device__ over `Lanes`, a lane's
// value on the card and the 32 lanes' values in a loop on the host, so the
// CPU tests run it with g++ over an emulated warp.
#include "sw_cells.cuh"

namespace ytsw {

constexpr int kClumpRegion = 256;  // fragments of a region in the rounds
constexpr int kClumpCover = 64;    // clumps of one region
constexpr int kClumpWarps = 4;     // rows a block, a warp each
constexpr int kClumpHead = 3;      // record header: clumps, frags, skipped
constexpr uint32_t kFull = 0xffffffffu;

struct ClumpParams {
    int64_t word_len, max_gap, max_desert, min_match, min_non_overlap,
        m_score, go_cost, ge_cost, band_width, max_region_frags;
    int32_t wide;  // stored scores never wrap (max_query_length > 32000)
};

// ---- the emulated warp ----

#if defined(__CUDA_ARCH__)
template <class T>
struct Lanes {
    T v;
    __device__ __forceinline__ T& operator[](int) { return v; }
    __device__ __forceinline__ const T& operator[](int) const { return v; }
};
#define YT_LANES(l) \
    for (int l = (int)(threadIdx.x & 31), l##_k = 0; l##_k < 1; l##_k++)
#define YT_LANE0 if ((threadIdx.x & 31) == 0)
#else
template <class T>
struct Lanes {
    T v[32];
    T& operator[](int l) { return v[l]; }
    const T& operator[](int l) const { return v[l]; }
};
#define YT_LANES(l) for (int l = 0; l < 32; l++)
#define YT_LANE0 if (true)
#endif

YT_HD uint32_t lanes_ballot(const Lanes<bool>& p) {
#if defined(__CUDA_ARCH__)
    return __ballot_sync(kFull, p.v);
#else
    uint32_t m = 0;
    for (int l = 0; l < 32; l++) m |= (uint32_t)p.v[l] << l;
    return m;
#endif
}

// Lane `src`'s value on every lane.
template <class T>
YT_HD T lanes_get(const Lanes<T>& x, int src) {
#if defined(__CUDA_ARCH__)
    return __shfl_sync(kFull, x.v, src);
#else
    return x.v[src];
#endif
}

// Each lane reads lane src[l]'s value.
template <class T>
YT_HD Lanes<T> lanes_from(const Lanes<T>& x, const Lanes<int>& src) {
    Lanes<T> o;
#if defined(__CUDA_ARCH__)
    o.v = __shfl_sync(kFull, x.v, src.v);
#else
    for (int l = 0; l < 32; l++) o.v[l] = x.v[src.v[l] & 31];
#endif
    return o;
}

YT_HD void lanes_sync() {
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
}

YT_HD int popc32(uint32_t m) {
#if defined(__CUDA_ARCH__)
    return __popc(m);
#else
    return __builtin_popcount(m);
#endif
}

// Index of the lowest set bit, or -1.
YT_HD int low_bit(uint32_t m) {
#if defined(__CUDA_ARCH__)
    return __ffs(m) - 1;
#else
    return m ? __builtin_ctz(m) : -1;
#endif
}

// Index of the highest set bit of m != 0.
YT_HD int high_bit(uint32_t m) {
#if defined(__CUDA_ARCH__)
    return 31 - __clz(m);
#else
    return 31 - __builtin_clz(m);
#endif
}

YT_HD uint32_t bits_from(int l) { return l >= 32 ? 0u : kFull << l; }
YT_HD uint32_t bits_below(int l) { return l >= 32 ? kFull : (1u << l) - 1; }

// ---- the host function's arithmetic (yt_frags_to_clumps, yt_chain_dp) ----

YT_HD int64_t c_adiff(int64_t a, int64_t b) { return a >= b ? a - b : b - a; }
YT_HD int64_t c_gap(int64_t a, int64_t b) { return b > a ? b - a - 1 : 0; }
YT_HD int64_t c_cover(int64_t low, int64_t high) {
    return low >= high ? low - high + 1 : 0;
}
YT_HD int64_t c_wrap16(int64_t x, bool wide) {
    return wide ? x : (((x + 0x8000) & 0xFFFF) - 0x8000);
}
// (a + b) mod 2^32 as a value in [0, 2^32).
YT_HD int64_t c_u32(int64_t a, int64_t b) {
    return (int64_t)(uint32_t)((uint32_t)a + (uint32_t)b);
}

// A copied fragment of a clump.
struct CFragD {
    int64_t sqo, eqo, sro;
    YT_HD int64_t len() const { return eqo - sqo + 1; }
    YT_HD int64_t ero() const { return c_u32(sro, len() - 1); }
    YT_HD int64_t diag() const { return c_u32(sro, -sqo); }
};

// A warp's shared memory: the region's fragments (hit order), their
// (SQO, diag) order, the round's nodes and DP state, the clump being
// built, the used flags, the coverage spans, and lane 0's results.
struct ClumpSmem {
    int32_t sqo[kClumpRegion], eqo[kClumpRegion];
    uint32_t diag[kClumpRegion];
    int32_t score[kClumpRegion], psqo[kClumpRegion];
    int16_t order[kClumpRegion], node[kClumpRegion], prev[kClumpRegion];
    int32_t c_sqo[kClumpRegion], c_eqo[kClumpRegion];
    uint32_t c_sro[kClumpRegion];
    uint32_t used[kClumpRegion / 32];
    int32_t cov_lo[kClumpCover], cov_hi[kClumpCover];
    int32_t n_clump, matched, over, span;
};

// The row's output record and its state (warp-uniform).
struct ClumpOut {
    int32_t* rec;
    int64_t cap, pos;
    int32_t nc, nf, skipped;
    bool over;
};

// A candidate edge i -> j of the chain DP (ok false: none).
struct ClumpCand {
    int32_t ok, i, psqo;
    int64_t ns, dgap, qgap;
};

// Whether a is kept over b by the sequential relaxation when both reach the
// same node (no int16 wrap): higher score, smaller diagonal gap, smaller
// query gap, greater pathSQO, earlier node.
YT_HD bool cand_before(const ClumpCand& a, const ClumpCand& b) {
    if (!a.ok) return false;
    if (!b.ok) return true;
    if (a.ns != b.ns) return a.ns > b.ns;
    if (a.dgap != b.dgap) return a.dgap < b.dgap;
    if (a.qgap != b.qgap) return a.qgap < b.qgap;
    if (a.psqo != b.psqo) return a.psqo > b.psqo;
    return a.i < b.i;
}

YT_HD ClumpCand warp_best_cand(const Lanes<ClumpCand>& c) {
#if defined(__CUDA_ARCH__)
    ClumpCand b = c.v;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        ClumpCand o;
        o.ok = __shfl_xor_sync(kFull, b.ok, off);
        o.i = __shfl_xor_sync(kFull, b.i, off);
        o.psqo = __shfl_xor_sync(kFull, b.psqo, off);
        o.ns = __shfl_xor_sync(kFull, b.ns, off);
        o.dgap = __shfl_xor_sync(kFull, b.dgap, off);
        o.qgap = __shfl_xor_sync(kFull, b.qgap, off);
        if (cand_before(o, b)) b = o;
    }
    return b;
#else
    ClumpCand b = c.v[0];
    for (int l = 1; l < 32; l++)
        if (cand_before(c.v[l], b)) b = c.v[l];
    return b;
#endif
}

// The best end node of the fold: higher stored score, lower EQO, greater
// pathSQO, earlier node (yt_chain_dp's fold).
struct ClumpFold {
    int32_t idx, score, eqo, psqo;
};

YT_HD bool fold_before(const ClumpFold& a, const ClumpFold& b) {
    if (a.idx < 0) return false;
    if (b.idx < 0) return true;
    if (a.score != b.score) return a.score > b.score;
    if (a.eqo != b.eqo) return a.eqo < b.eqo;
    if (a.psqo != b.psqo) return a.psqo > b.psqo;
    return a.idx < b.idx;
}

YT_HD ClumpFold warp_best_fold(const Lanes<ClumpFold>& c) {
#if defined(__CUDA_ARCH__)
    ClumpFold b = c.v;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        ClumpFold o;
        o.idx = __shfl_xor_sync(kFull, b.idx, off);
        o.score = __shfl_xor_sync(kFull, b.score, off);
        o.eqo = __shfl_xor_sync(kFull, b.eqo, off);
        o.psqo = __shfl_xor_sync(kFull, b.psqo, off);
        if (fold_before(o, b)) b = o;
    }
    return b;
#else
    ClumpFold b = c.v[0];
    for (int l = 1; l < 32; l++)
        if (fold_before(c.v[l], b)) b = c.v[l];
    return b;
#endif
}

// Edge i -> j of the round's nodes (yt_chain_dp's tests and newScore).
YT_HD ClumpCand clump_cand(const ClumpSmem& s, int i, int64_t sqo_j,
                           int64_t diag_j, int64_t sro_j, int64_t lw_j,
                           const ClumpParams& p) {
    ClumpCand c = {0, i, 0, 0, 0, 0};
    const int fi = s.node[i];
    const int64_t sqo_i = s.sqo[fi], eqo_i = s.eqo[fi];
    const int64_t diag_i = s.diag[fi];
    if (sqo_j == sqo_i) return c;
    const int64_t dgap = c_adiff(diag_j, diag_i);
    if (dgap > p.max_gap) return c;
    const int64_t sro_i = c_u32(diag_i, sqo_i);
    if (sro_j <= sro_i) return c;
    const int64_t ero_i = c_u32(diag_i, eqo_i);
    const int64_t q_gap = sqo_j > eqo_i ? sqo_j - eqo_i - 1 : 0;
    const int64_t r_gap = sro_j > ero_i ? sro_j - ero_i - 1 : 0;
    if ((q_gap < r_gap ? q_gap : r_gap) > p.max_desert) return c;
    const int64_t q_ov = eqo_i >= sqo_j ? eqo_i - sqo_j + 1 : 0;
    const int64_t r_ov = ero_i >= sro_j ? ero_i - sro_j + 1 : 0;
    const int64_t nb = lw_j - (q_ov > r_ov ? q_ov : r_ov);
    if (nb < 1) return c;
    const int64_t gap_cost = dgap > 0 ? -(p.go_cost + dgap * p.ge_cost) : 0;
    c.ok = 1;
    c.psqo = s.psqo[i];
    c.ns = (int64_t)s.score[i] + nb * p.m_score + gap_cost;
    c.dgap = dgap;
    c.qgap = q_gap;
    return c;
}

// The chain DP over the round's cnt nodes (yt_chain_dp): score, prev and
// pathSQO of every node, then the fold's best node.  Returns -1 when a
// stored score leaves the range the fast path assumes (the row overflows).
YT_HD int clump_chain(ClumpSmem& s, int cnt, bool fast, const ClumpParams& p) {
    const bool wide = p.wide != 0;
    for (int j = 0; j < cnt; j++) {
        const int fj = s.node[j];
        const int64_t sqo_j = s.sqo[fj], eqo_j = s.eqo[fj];
        const int64_t diag_j = s.diag[fj];
        const int64_t sro_j = c_u32(diag_j, sqo_j);
        const int64_t lw_j = c_wrap16(eqo_j - sqo_j + 1, wide);
        int64_t sc = c_wrap16(lw_j * p.m_score, wide);
        int32_t prev = -1, ps = (int32_t)sqo_j;
        if (fast) {
            Lanes<ClumpCand> c;
            YT_LANES(l) {
                ClumpCand b = {0, 0, 0, 0, 0, 0};
                for (int i = l; i < j; i += 32) {
                    const ClumpCand x = clump_cand(s, i, sqo_j, diag_j,
                                                   sro_j, lw_j, p);
                    if (cand_before(x, b)) b = x;
                }
                c[l] = b;
            }
            const ClumpCand b = warp_best_cand(c);
            if (b.ok && b.ns > sc) {
                sc = b.ns;
                prev = b.i;
                ps = b.psqo;
            }
            if (wide ? (sc < -0x7FFFFFFFll || sc > 0x7FFFFFFFll)
                     : (sc < -0x8000 || sc > 0x7FFF))
                return -1;
        } else {
            // The sequential relaxation, candidates a chunk of 32 at once.
            int64_t pdd = 0, pgap = 0;
            int32_t ppsqo = 0;
            for (int c0 = 0; c0 < j; c0 += 32) {
                Lanes<ClumpCand> c;
                YT_LANES(l) {
                    c[l] = c0 + l < j ? clump_cand(s, c0 + l, sqo_j, diag_j,
                                                   sro_j, lw_j, p)
                                      : ClumpCand{0, 0, 0, 0, 0, 0};
                }
                const int top = j - c0 < 32 ? j - c0 : 32;
                for (int k = 0; k < top; k++) {
#if defined(__CUDA_ARCH__)
                    ClumpCand x;
                    x.ok = __shfl_sync(kFull, c.v.ok, k);
                    x.psqo = __shfl_sync(kFull, c.v.psqo, k);
                    x.ns = __shfl_sync(kFull, c.v.ns, k);
                    x.dgap = __shfl_sync(kFull, c.v.dgap, k);
                    x.qgap = __shfl_sync(kFull, c.v.qgap, k);
#else
                    const ClumpCand x = c.v[k];
#endif
                    if (!x.ok || sc > x.ns) continue;
                    if (sc == x.ns) {
                        if (prev < 0) continue;
                        const int64_t dc = x.dgap - pdd;
                        if (dc > 0) continue;
                        if (dc == 0) {
                            const int64_t gc = x.qgap - pgap;
                            if (gc > 0) continue;
                            if (gc == 0 && x.psqo <= ppsqo) continue;
                        }
                    }
                    sc = c_wrap16(x.ns, wide);
                    prev = c0 + k;
                    ps = x.psqo;
                    pdd = x.dgap;
                    pgap = x.qgap;
                    ppsqo = x.psqo;
                }
            }
            if (sc < -0x7FFFFFFFll || sc > 0x7FFFFFFFll) return -1;
        }
        YT_LANE0 {
            s.score[j] = (int32_t)sc;
            s.prev[j] = (int16_t)prev;
            s.psqo[j] = ps;
        }
        lanes_sync();
    }
    Lanes<ClumpFold> f;
    YT_LANES(l) {
        ClumpFold b = {-1, 0, 0, 0};
        for (int j = l; j < cnt; j += 32) {
            const ClumpFold x = {j, s.score[j], s.eqo[s.node[j]], s.psqo[j]};
            if (fold_before(x, b)) b = x;
        }
        f[l] = b;
    }
    return warp_best_fold(f).idx;
}

YT_HD void cv_set(ClumpSmem& s, int k, const CFragD& f) {
    s.c_sqo[k] = (int32_t)f.sqo;
    s.c_eqo[k] = (int32_t)f.eqo;
    s.c_sro[k] = (uint32_t)f.sro;
}

YT_HD CFragD cv_get(const ClumpSmem& s, int k) {
    return CFragD{s.c_sqo[k], s.c_eqo[k], (int64_t)s.c_sro[k]};
}

YT_HD void cv_erase(ClumpSmem& s, int& n, int j) {
    for (int x = j; x + 1 < n; x++) cv_set(s, x, cv_get(s, x + 1));
    n--;
}

// processBestFragmentPath with insertFragment's chops (lane 0): the clump
// from node `best` back along prev, into c_*[0, n) in clump order, the
// f1.eqo chops written to the region's fragments.  Returns n; *matched.
YT_HD int clump_path(ClumpSmem& s, int best, int64_t* matched) {
    int n = 0;
    int64_t m = 0;
    CFragD front = {0, 0, 0};
    for (int k = best;;) {
        const int fi = s.node[k];
        CFragD f1 = {s.sqo[fi], s.eqo[fi], c_u32(s.diag[fi], s.sqo[fi])};
        if (n > 0) {
            int64_t mo = c_cover(f1.eqo, front.sqo);
            const int64_t mo2 = c_cover(f1.ero(), front.sro);
            if (mo2 > mo) mo = mo2;
            if (mo > 0) {
                const int64_t l1 = f1.len(), l2 = front.len();
                const bool chop1 = l1 != l2 ? l1 < l2 : n == 1;
                if (chop1) {
                    f1.eqo -= mo;
                    s.eqo[fi] = (int32_t)f1.eqo;
                } else {
                    front.sqo += mo;
                    front.sro = c_u32(front.sro, mo);
                    cv_set(s, n - 1, front);
                }
            }
        }
        m += f1.len();
        cv_set(s, n++, f1);
        front = f1;
        if (s.prev[k] < 0) break;
        k = s.prev[k];
    }
    for (int a = 0, b = n - 1; a < b; a++, b--) {
        const CFragD t = cv_get(s, a);
        cv_set(s, a, cv_get(s, b));
        cv_set(s, b, t);
    }
    *matched = m;
    return n;
}

// cleanUpClump (yt_frags_to_clumps' clean_up_clump) on c_*[0, n) (lane 0).
YT_HD int clump_clean(ClumpSmem& s, int n, const ClumpParams& p) {
    const int64_t wl = p.word_len, bw = p.band_width;
    int p1 = 0, p2 = n > 1 ? 1 : -1, p3 = n > 2 ? 2 : -1;
    while (p2 >= 0 && p3 >= 0) {
        if (cv_get(s, p2).len() < wl) {
            int ai = p3;
            while (cv_get(s, ai).len() < wl && ai + 1 < n) ai++;
            const int64_t f1_diag = cv_get(s, p1).diag();
            const int64_t anchor_diag = cv_get(s, ai).diag();
            if (c_adiff(f1_diag, anchor_diag) <= p.max_gap) {
                int j = p2;
                while (j != ai) {
                    const int64_t dd = cv_get(s, j).diag();
                    const bool mid = !((dd < f1_diag && dd < anchor_diag) ||
                                       (dd > f1_diag && dd > anchor_diag));
                    if (mid || (c_adiff(f1_diag, dd) <= bw ||
                                c_adiff(dd, anchor_diag) <= bw)) {
                        cv_erase(s, n, j);
                        ai--;
                    } else {
                        j++;
                    }
                }
            }
            p1 = ai;
            p2 = ai + 1 < n ? ai + 1 : -1;
        } else {
            p1 = p2;
            p2 = p3;
        }
        if (p2 >= 0) p3 = p2 + 1 < n ? p2 + 1 : -1;
    }
    if (n >= 2 && cv_get(s, 0).len() < wl) {
        const CFragD a = cv_get(s, 0), b = cv_get(s, 1);
        const int64_t q_gap = c_gap(a.eqo, b.sqo);
        const int64_t r_gap = c_gap(a.ero(), b.sro);
        if ((q_gap == 0 && r_gap <= 2 * bw) || (r_gap == 0 && q_gap <= 2 * bw))
            cv_erase(s, n, 0);
    }
    if (n >= 2 && cv_get(s, n - 1).len() < wl) {
        const CFragD a = cv_get(s, n - 2), b = cv_get(s, n - 1);
        const int64_t q_gap = c_gap(a.eqo, b.sqo);
        const int64_t r_gap = c_gap(a.ero(), b.sro);
        if ((q_gap == 0 && r_gap <= 2 * bw) || (r_gap == 0 && q_gap <= 2 * bw))
            n--;
    }
    return n;
}

// Whether the coverage spans hold any position of [a, b].
YT_HD bool cov_any(const ClumpSmem& s, int ncov, int64_t a, int64_t b) {
    for (int k = 0; k < ncov; k++)
        if (s.cov_lo[k] <= b && s.cov_hi[k] >= a && a <= b) return true;
    return false;
}

// The clump c_*[0, n) with its matched bases, appended to the record.
YT_HD void clump_emit(ClumpSmem& s, ClumpOut& o, int n, int64_t matched) {
    if (o.pos + 2 + 3 * (int64_t)n > o.cap) {
        o.over = true;
        return;
    }
    int32_t* r = o.rec + o.pos;
    YT_LANE0 {
        r[0] = n;
        r[1] = (int32_t)matched;
    }
    YT_LANES(l) {
        for (int k = l; k < n; k += 32) {
            r[2 + 3 * k] = s.c_sqo[k];
            r[3 + 3 * k] = s.c_eqo[k];
            r[4 + 3 * k] = (int32_t)s.c_sro[k];
        }
    }
    o.pos += 2 + 3 * (int64_t)n;
    o.nc++;
    o.nf += n;
}

// The rounds of one region of m >= 2 fragments (processFragmentRangeUsing
// Graph and its caller's loop in yt_frags_to_clumps).
YT_HD void clump_region(ClumpSmem& s, ClumpOut& o, int m, int64_t q_len,
                        const ClumpParams& p) {
    // Stable (SQO, diag) order of the region's fragments: SQO and diag do
    // not change over the rounds (a chop moves EQO alone).
    YT_LANES(l) {
        for (int i = l; i < m; i += 32) {
            const int32_t a = s.sqo[i];
            const uint32_t d = s.diag[i];
            int r = 0;
            for (int k = 0; k < m; k++) {
                const int32_t b = s.sqo[k];
                r += b < a || (b == a && (s.diag[k] < d ||
                                          (s.diag[k] == d && k < i)));
            }
            s.order[r] = (int16_t)i;
        }
        for (int w = l; w < kClumpRegion / 32; w += 32) s.used[w] = 0;
    }
    lanes_sync();
    const bool fast = p.wide != 0 ||
        (p.m_score >= 0 && p.m_score <= 0x7FFF && p.go_cost >= 0 &&
         p.ge_cost >= 0 && q_len * p.m_score <= 0x7FFF);
    const int64_t ml = p.min_non_overlap - 1;
    int ncov = 0;
    for (;;) {
        int cnt = 0;
        for (int c0 = 0; c0 < m; c0 += 32) {
            Lanes<bool> u;
            Lanes<int> fi;
            YT_LANES(l) {
                const int k = c0 + l;
                fi[l] = k < m ? s.order[k] : 0;
                u[l] = k < m && !((s.used[fi[l] >> 5] >> (fi[l] & 31)) & 1);
            }
            const uint32_t bm = lanes_ballot(u);
            YT_LANES(l) {
                if (u[l])
                    s.node[cnt + popc32(bm & bits_below(l))] =
                        (int16_t)fi[l];
            }
            cnt += popc32(bm);
        }
        lanes_sync();
        if (cnt == 0) break;
        const int best = clump_chain(s, cnt, fast, p);
        if (best < 0) {
            o.over = true;
            return;
        }
        YT_LANE0 {
            int64_t matched = 0;
            const int n = clump_path(s, best, &matched);
            s.matched = matched < p.min_match ? -1 : (int32_t)matched;
            s.n_clump = matched < p.min_match ? 0 : clump_clean(s, n, p);
            // The clump's span [sqo, eqo] within the query: coverage.
            s.over = s.span = 0;
            if (s.matched >= 0) {
                const int64_t c_sqo = s.c_sqo[0];
                const int64_t end = s.c_eqo[s.n_clump - 1] + 1 < q_len
                                        ? s.c_eqo[s.n_clump - 1] + 1
                                        : q_len;
                if (end > c_sqo && ncov == kClumpCover) {
                    s.over = 1;
                } else if (end > c_sqo) {
                    s.cov_lo[ncov] = (int32_t)c_sqo;
                    s.cov_hi[ncov] = (int32_t)(end - 1);
                    s.span = 1;
                }
            }
        }
        lanes_sync();
        const int32_t matched = s.matched;
        const int n = s.n_clump;
        if (matched < 0) break;  // a clump below min_match: region done
        if (s.over) {
            o.over = true;
            return;
        }
        ncov += s.span;
        // eliminateFragments over the region's unused fragments.
        for (int c0 = 0; c0 < m; c0 += 32) {
            Lanes<bool> drop;
            YT_LANES(l) {
                const int i = c0 + l;
                drop[l] = false;
                if (i < m && !((s.used[i >> 5] >> (i & 31)) & 1)) {
                    const int64_t a = s.sqo[i], e = s.eqo[i];
                    bool keep = false;
                    if (e - a >= ml) {
                        if (!cov_any(s, ncov, a, a + ml)) keep = true;
                        if (!keep && !cov_any(s, ncov, e - ml, e)) keep = true;
                    }
                    drop[l] = !keep;
                }
            }
            const uint32_t bm = lanes_ballot(drop);
            lanes_sync();
            YT_LANE0 { s.used[c0 >> 5] |= bm; }
        }
        lanes_sync();
        clump_emit(s, o, n, matched);
        lanes_sync();
        if (o.over) return;
    }
}

// One region's end: fragments [0, num) in shared memory (the first
// kClumpRegion of them).
YT_HD void clump_finish(ClumpSmem& s, ClumpOut& o, int64_t num, int64_t q_len,
                        const ClumpParams& p) {
    if (p.max_region_frags > 0 && num > p.max_region_frags) {
        o.skipped++;
    } else if (num == 1) {
        const int64_t len = (int64_t)s.eqo[0] - s.sqo[0] + 1;
        if (len >= p.min_match) {
            YT_LANE0 {
                s.c_sqo[0] = s.sqo[0];
                s.c_eqo[0] = s.eqo[0];
                s.c_sro[0] = s.diag[0] + (uint32_t)s.sqo[0];
            }
            lanes_sync();
            clump_emit(s, o, 1, len);
            lanes_sync();
        }
    } else if (num > kClumpRegion) {
        o.over = true;
    } else {
        clump_region(s, o, (int)num, q_len, p);
    }
}

// One strand row: hits (diag, qo)[0, n) sorted by (diag, qo), a query of
// q_len; its record into rec[0, cap).  Returns the record's length, 0 for
// n < 0 (a row the kernel does not serve), -1 past a capacity.
YT_HD int64_t clump_row(const uint32_t* D, const int32_t* Q, int64_t n,
                        int64_t q_len, const ClumpParams& p, ClumpSmem& s,
                        int32_t* rec, int64_t cap) {
    if (n < 0) return 0;
    if (cap < kClumpHead) return -1;
    ClumpOut o = {rec, cap, kClumpHead, 0, 0, 0, false};
    const int64_t wl = p.word_len;
    bool reg_open = false, frag_open = false;
    int64_t reg_num = 0;
    for (int64_t base = 0; base < n && !o.over; base += 32) {
        const int nvalid = n - base < 32 ? (int)(n - base) : 32;
        Lanes<uint32_t> d;
        Lanes<int32_t> q;
        Lanes<bool> fs, rs, fe, re;
        YT_LANES(l) {
            const int64_t t = base + l;
            fs[l] = rs[l] = fe[l] = re[l] = false;
            d[l] = 0;
            q[l] = 0;
            if (t < n) {
                const uint32_t dt = D[t];
                const int32_t qt = Q[t];
                d[l] = dt;
                q[l] = qt;
                if (t == 0) {
                    fs[l] = rs[l] = true;
                } else {
                    const uint32_t dp = D[t - 1];
                    fs[l] = dt != dp || (int64_t)qt - Q[t - 1] > wl;
                    rs[l] = fs[l] && c_adiff(dt, dp) > p.max_gap;
                }
                if (t + 1 >= n) {
                    fe[l] = re[l] = true;
                } else {
                    const uint32_t dn = D[t + 1];
                    fe[l] = dn != dt || (int64_t)Q[t + 1] - qt > wl;
                    re[l] = fe[l] && c_adiff(dn, dt) > p.max_gap;
                }
            }
        }
        const uint32_t fsm = lanes_ballot(fs), rsm = lanes_ballot(rs);
        const uint32_t fem = lanes_ballot(fe), rem = lanes_ballot(re);
        // Each lane: its fragment's end lane and its region's end lane (the
        // first at or after it in the chunk), and their qo.
        Lanes<int> fend, rend;
        YT_LANES(l) {
            const int f = low_bit(fem & bits_from(l));
            const int r = low_bit(rem & bits_from(l));
            fend[l] = f < 0 ? l : f;
            rend[l] = r < 0 ? l : r;
        }
        const Lanes<int32_t> qf = lanes_from(q, fend);
        const Lanes<int32_t> qr = lanes_from(q, rend);
        // Regions that start and end in the chunk with one fragment too
        // short for a clump: nothing to do.
        Lanes<bool> dull;
        YT_LANES(l) {
            const bool whole = ((rem & bits_from(l)) != 0) &&
                               low_bit(fem & bits_from(l)) ==
                                   low_bit(rem & bits_from(l));
            dull[l] = rs[l] && whole &&
                      (int64_t)qr[l] - q[l] + wl < p.min_match;
        }
        const uint32_t live = rsm & ~lanes_ballot(dull);
        // Appends the fragments starting in lanes [lo, hi] to the open
        // region, ending first the open fragment.
        auto append = [&](int lo, int hi) {
            const uint32_t range = bits_from(lo) & bits_below(hi + 1);
            if (frag_open) {
                const int e = low_bit(fem & range);
                if (e >= 0) {
                    const int32_t qe = lanes_get(q, e);
                    if (reg_num - 1 < kClumpRegion) {
                        YT_LANE0 {
                            s.eqo[reg_num - 1] = (int32_t)(qe + wl - 1);
                        }
                    }
                    frag_open = false;
                }
            }
            const uint32_t fm = fsm & range;
            YT_LANES(l) {
                if ((fm >> l) & 1) {
                    const int64_t slot = reg_num + popc32(fm & bits_below(l));
                    if (slot < kClumpRegion) {
                        s.sqo[slot] = q[l];
                        s.diag[slot] = d[l];
                        if ((fem & bits_from(l)) != 0)
                            s.eqo[slot] = (int32_t)(qf[l] + wl - 1);
                    }
                }
            }
            if (fm) frag_open = (fem & bits_from(high_bit(fm))) == 0;
            reg_num += popc32(fm);
            lanes_sync();
        };
        if (reg_open) {
            const int first = low_bit(rsm);
            const int hi = first < 0 ? nvalid - 1 : first - 1;
            if (hi >= 0) append(0, hi);
            if (hi < 0 || (rem & bits_below(hi + 1)) != 0) {
                clump_finish(s, o, reg_num, q_len, p);
                reg_open = false;
            }
        }
        for (uint32_t m = live; m && !o.over; m &= m - 1) {
            const int lo = low_bit(m);
            const int e = low_bit(rem & bits_from(lo));
            reg_open = true;
            frag_open = false;
            reg_num = 0;
            append(lo, e < 0 ? nvalid - 1 : e);
            if (e >= 0) {
                clump_finish(s, o, reg_num, q_len, p);
                reg_open = false;
            }
        }
    }
    if (o.over) return -1;
    YT_LANE0 {
        rec[0] = o.nc;
        rec[1] = o.nf;
        rec[2] = o.skipped;
    }
    return o.pos;
}

}  // namespace ytsw

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

// A warp a row, kClumpWarps rows a block; meta[row] = clump_row's length.
__global__ void __launch_bounds__(32 * ytsw::kClumpWarps)
hits_clump_kernel(const uint32_t* diag, const int32_t* qo, int64_t rows,
                  int64_t width, const int32_t* n_hits, const int32_t* q_len,
                  ytsw::ClumpParams p, int32_t* rec, int64_t rec_width,
                  int32_t* meta) {
    __shared__ ytsw::ClumpSmem sm[ytsw::kClumpWarps];
    const int w = threadIdx.x >> 5;
    const int64_t row = blockIdx.x * (int64_t)ytsw::kClumpWarps + w;
    if (row >= rows) return;  // a whole warp leaves
    const int64_t len = ytsw::clump_row(
        diag + row * width, qo + row * width, n_hits[row], q_len[row], p,
        sm[w], rec + row * rec_width, rec_width);
    if ((threadIdx.x & 31) == 0) meta[row] = (int32_t)len;
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
int yt_hits_clump(const int32_t* diag, const int32_t* qo, int64_t rows,
                  int64_t width, const int32_t* n_hits, const int32_t* q_len,
                  int64_t word_len, int64_t max_gap, int64_t max_desert,
                  int64_t min_match, int64_t min_non_overlap, int64_t m_score,
                  int64_t go_cost, int64_t ge_cost, int64_t band_width,
                  int64_t max_region_frags, int32_t wide, int32_t* rec,
                  int64_t rec_width, int32_t* meta, void* stream) {
    const ytsw::ClumpParams p = {word_len, max_gap, max_desert, min_match,
                                 min_non_overlap, m_score, go_cost, ge_cost,
                                 band_width, max_region_frags, wide};
    const unsigned blocks =
        (unsigned)((rows + ytsw::kClumpWarps - 1) / ytsw::kClumpWarps);
    hits_clump_kernel<<<blocks, 32 * ytsw::kClumpWarps, 0,
                        (cudaStream_t)stream>>>(
        (const uint32_t*)diag, qo, rows, width, n_hits, q_len, p, rec,
        rec_width, meta);
    return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
