// Cell update of the affine-gap DP kernels (ext_kernels.cu,
// ext_wide_kernels.cu, anch_kernels.cu).
//
// One cell of the reference recurrence (SW.cpp:1007-1084): delete is
// checked first, then insert, each capped by its run-length limit, and
// the packed backtrack byte carries the op in bits 0-2 plus the gap-run
// continue bits BT_CD (delete run continues one cell left) and BT_CF
// (insert run continues up the chain).  The extension kernel breaks
// ties towards the gap (>=); both anchored kernels keep the match/replace
// unless the gap is strictly better (>).
//
// int32 arithmetic wraps here exactly as it does in JAX: DP_WORST is only
// 256 above INT32_MIN, so sentinel - cost can wrap for large costs, and
// signed overflow is undefined in C++.  Every add/sub/mul that can touch
// a sentinel goes through uint32_t.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define YT_HD __host__ __device__ __forceinline__
#else
#define YT_HD inline
#endif

namespace ytsw {

constexpr int32_t DP_WORST = -0x7FFFFF00;
constexpr int32_t OP_UNKNOWN = 0;
constexpr int32_t OP_MATCH = 1;
constexpr int32_t OP_REPLACE = 2;
constexpr int32_t OP_INSERT = 3;
constexpr int32_t OP_DELETE = 4;
constexpr int32_t BT_CD = 8;
constexpr int32_t BT_CF = 16;

YT_HD int32_t wadd(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}

YT_HD int32_t wsub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

YT_HD int32_t wmul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
}

// __byte_perm(x, y, s): byte n of the result is byte (s >> 4n) & 7 of the
// eight bytes y:x (x the low four).  The host build has no __byte_perm, so
// it gets this version of it.
YT_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#if defined(__CUDA_ARCH__)
    return __byte_perm(x, y, s);
#else
    const uint64_t v = ((uint64_t)y << 32) | x;
    uint32_t out = 0;
    for (int n = 0; n < 4; n++)
        out |= (uint32_t)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xFF)
               << (8 * n);
    return out;
#endif
}

// A code byte through the read-only data cache.
YT_HD int32_t ld_u8(const uint8_t* p) {
#if defined(__CUDA_ARCH__)
    return (int32_t)__ldg(p);
#else
    return (int32_t)*p;
#endif
}

struct Scoring {
    int32_t go, ge, rc, ms, max_gap, max_intron;
};

struct CellOut {
    int32_t v;       // cell value
    int32_t pe, pd;  // delete run value / length (horizontal carry)
    int32_t f, ii;   // insert run value / length (stored for the row below)
    int32_t bt;      // packed backtrack byte
};

// diag: value of the diagonal predecessor; pe/pd/pv_left: the horizontal
// carry; pf/pv/pi_up: the vertical predecessor's insert state and value.
template <bool kGapTies>
YT_HD CellOut cell(int32_t diag, int32_t qc, int32_t rch, int32_t pe_left,
                   int32_t pd_left, int32_t pv_left, int32_t pf_up,
                   int32_t pv_up, int32_t pi_up, const Scoring& s) {
    int32_t d = qc - rch;
    int32_t neq = d != 0 ? 1 : 0;  // min(|q - r|, 1)
    int32_t g = wsub(wadd(diag, s.ms), wmul(neq, wadd(s.ms, s.rc)));
    int32_t op = OP_MATCH + neq * (OP_REPLACE - OP_MATCH);
    int32_t goe = wadd(s.go, s.ge);

    int32_t ce = wsub(pe_left, s.ge);
    int32_t ne = wsub(pv_left, goe);
    bool cont_d = (ce >= ne) && (pd_left + 1 <= s.max_intron);
    CellOut o;
    o.pe = cont_d ? ce : ne;
    o.pd = cont_d ? pd_left + 1 : 1;
    bool take_d = kGapTies ? (o.pe >= g) : (o.pe > g);
    int32_t v1 = take_d ? o.pe : g;
    if (take_d) op = OP_DELETE;

    int32_t cf = wsub(pf_up, s.ge);
    int32_t nf = wsub(pv_up, goe);
    bool cont_f = (cf >= nf) && (pi_up + 1 <= s.max_gap);
    o.f = cont_f ? cf : nf;
    o.ii = cont_f ? pi_up + 1 : 1;
    bool take_f = kGapTies ? (o.f >= v1) : (o.f > v1);
    o.v = take_f ? o.f : v1;
    if (take_f) op = OP_INSERT;

    o.bt = op + (o.pd > 1 ? BT_CD : 0) + (o.ii > 1 ? BT_CF : 0);
    return o;
}

}  // namespace ytsw
