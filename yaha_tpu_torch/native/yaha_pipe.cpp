// yaha_tpu native full per-read pipeline.
//
// The complete per-read alignment path (seed scan -> fragments ->
// chaining -> clump alignment -> scoring/splitting -> OQC/FBS ->
// SAM/Blast8 rendering) in C++, the counterpart of the reference's
// processQueries loop (Query.c:255-497).  Semantics are a
// transliteration of this repo's Python oracle modules (core/align.py,
// core/sw.py, core/oqc.py, io/sam.py, core/pipeline.py), which are
// byte-parity-validated against the reference binary; every quirk
// (int16 wraps, RNG streams, degenerate-chop emulation) is preserved.
// Threading: std::thread over reads with deterministic input-ordered
// output (the pthread analog of Query.c:642-691 without the output
// interleaving).
//
// Compiled into libyaha_host.so together with yaha_host.cpp
// (tools/build_native.sh); consumed via ctypes (native/host.py).
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <string>
#include <vector>
#include <deque>
#include <algorithm>
#include <thread>
#include <atomic>
#include <cstdarg>
#include <chrono>

#include "yaha_prof.h"

thread_local Prof* g_prof = nullptr;

// ---- functions from yaha_host.cpp (same shared object) ----
extern "C" {
int64_t yt_seed_to_clumps(
    const uint8_t* codes, int64_t q_len, int64_t word_len,
    const uint32_t* so, const uint32_t* roa, int64_t roa_len,
    int64_t max_hits, int64_t max_gap, int64_t max_desert,
    int64_t min_match, int64_t min_non_overlap, int64_t m_score,
    int64_t go_cost, int64_t ge_cost, int64_t band_width,
    int64_t* out_sqo, int64_t* out_eqo, int64_t* out_sro,
    int64_t* clump_offs, int64_t* clump_matched,
    int64_t cap_frags, int64_t cap_clumps, int64_t* total_hits_out);
int64_t yt_hits_to_clumps(
    const uint32_t* hits_diag, const int32_t* hits_qo, int64_t n_hits,
    int64_t q_len, int64_t word_len,
    int64_t max_gap, int64_t max_desert, int64_t min_match,
    int64_t min_non_overlap, int64_t m_score, int64_t go_cost,
    int64_t ge_cost, int64_t band_width,
    int64_t* out_sqo, int64_t* out_eqo, int64_t* out_sro,
    int64_t* clump_offs, int64_t* clump_matched,
    int64_t cap_frags, int64_t cap_clumps);
int yt_extension_forward(const uint8_t* q, const int32_t* qlens,
                         const uint8_t* r, const int32_t* rlens,
                         int64_t n, int64_t qlmax, int64_t rlmax,
                         int band_width, int go, int ge, int rc, int ms,
                         int max_gap, int max_intron, int x_cutoff,
                         int8_t* eo, int32_t* idc, int32_t* score,
                         int32_t* maxi_out, int32_t* maxj_out);
int yt_anchored_forward(const uint8_t* q, const int32_t* qlens,
                        const uint8_t* r, const int32_t* rlens,
                        const int32_t* lbws, const int32_t* rbws,
                        int64_t n, int64_t qlmax, int64_t rlmax,
                        int go, int ge, int rc, int ms,
                        int max_gap, int max_intron,
                        int8_t* eo, int32_t* idc, int32_t* score);
extern thread_local int64_t yt_wide_scores;
extern thread_local int64_t yt_max_region_frags;
extern thread_local int64_t yt_skipped_regions;
}

namespace yp {

static const int64_t M32 = 0xFFFFFFFFll;

// 4-bit code tables (Math.c:141-231 values).
static const char kChars[17] = "TCAGNBDHKMRSVWXY";
static uint8_t kCodes[256];
static const uint8_t kComp[16] = {2, 3, 0, 1, 4, 12, 7, 6,
                                  9, 8, 15, 11, 5, 13, 14, 10};

static void init_tables() {
    static bool done = false;
    if (done) return;
    for (int i = 0; i < 256; i++) kCodes[i] = 14;
    const char* bases = "ABCDGHKMNRSTUVWY";
    const uint8_t codes[] = {2, 5, 1, 6, 3, 7, 8, 9, 4, 10, 11, 0, 0, 12,
                             13, 15};
    for (int i = 0; bases[i]; i++) {
        kCodes[(uint8_t)bases[i]] = codes[i];
        kCodes[(uint8_t)(bases[i] + 32)] = codes[i];
    }
    done = true;
}

// ---- config (AlignmentArgs_t analog; see host.py param packing) ----
struct Params {
    int64_t word_len, max_hits, max_gap, max_intron, min_match, max_desert,
        min_raw_score, min_non_overlap, oqc_min_non_overlap, band_width,
        m_score, r_cost, go_cost, ge_cost, x_cutoff, min_ext_length,
        bp_cost, max_bp_log, max_query_length, max_region_frags;
    bool oqc, fbs, output_sam, output_blast8, hard_clip, fastq;
    double min_identity, fbs_ps_length, fbs_ps_score;
};

enum IP {
    IP_WORD_LEN = 0, IP_MAX_HITS, IP_MAX_GAP, IP_MAX_INTRON, IP_MIN_MATCH,
    IP_MAX_DESERT, IP_MIN_RAW_SCORE, IP_MIN_NON_OVERLAP,
    IP_OQC_MIN_NON_OVERLAP, IP_BAND_WIDTH, IP_M_SCORE, IP_R_COST,
    IP_GO_COST, IP_GE_COST, IP_X_CUTOFF, IP_MIN_EXT_LENGTH, IP_BP_COST,
    IP_MAX_BP_LOG, IP_OQC, IP_FBS, IP_OUTPUT_SAM, IP_OUTPUT_BLAST8,
    IP_HARD_CLIP, IP_FASTQ, IP_N_THREADS, IP_MAX_QUERY_LEN,
    IP_MAX_REGION_FRAGS, IP_COUNT
};

// ---- int wrap helpers (core/cints.py) ----
// Identity in wide-score mode (reads beyond the reference's 32 kb input
// domain, where the int16 parity quirks would corrupt real scores).
static inline int64_t wrap_i16(int64_t x) {
    return yt_wide_scores ? x : (((x + 0x8000) & 0xFFFF) - 0x8000);
}
static inline int64_t wrap_u16(int64_t x) {
    return yt_wide_scores ? x : (x & 0xFFFF);
}

// ---- RNG (utils/rng.py; Math.c:251-343) ----
struct Rng {
    uint32_t s[5];
    uint32_t bits() {
        uint32_t t = s[0] ^ (s[0] >> 7);
        s[0] = s[1]; s[1] = s[2]; s[2] = s[3]; s[3] = s[4];
        s[4] = (uint32_t)((s[4] ^ (s[4] << 6)) ^ (t ^ (t << 13)));
        return (uint32_t)((s[1] + s[1] + 1) * s[4]);
    }
};

// Per-query seed from the read's codes (QueryState.c:171-187).
static void query_seed(const uint8_t* codes, int64_t q_len, uint32_t* out) {
    int64_t qoffset = 0;
    for (int w = 0; w < 5; w++) {
        uint32_t word = 0;
        for (int k = 0; k < 16; k++) {
            word = (word << 2) | (uint32_t)(codes[qoffset] & 0x3);
            if (++qoffset >= q_len) qoffset = 0;
        }
        out[w] = word;
    }
}

// Per-run query/hit/alignment distributions — the reference's STATS
// compile-switch counters (Query.c:275-289, 416-418, 470-477), printed
// under -v.  Accumulated per worker thread, merged at batch end.
struct RunStats {
    int64_t queries = 0, qlen_tot = 0;
    int64_t qlen_min = INT64_MAX, qlen_max = 0;
    int64_t cnt_tot = 0, cnt_min = INT64_MAX, cnt_max = 0;
    int64_t nonaligned = 0, clumps_tot = 0;
    int64_t clumps_min = INT64_MAX, clumps_max = -1;
};
static bool prof_enabled() {
    // Magic-static init: thread-safe (TSAN-clean under -t).
    static const bool v = [] {
        const char* e = getenv("YT_PROFILE");
        return e && *e && *e != '0';
    }();
    return v;
}
static inline double now_s() {
    return (double)std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now().time_since_epoch()).count() * 1e-9;
}


// ---- EditOpList (core/editops.py; SW.cpp:151-283) ----
//
// Run-length edit ops are tiny (typically 1-6 runs between merges), so
// the list is a small-inline vector: 8 entries live in the object and
// only pathological lists touch the heap.  EO is packed to 8 bytes
// (lengths are bounded by the read length < 2^31).
struct EO { char op; int32_t len; };

template <class T, size_t N>
class SmallVec {
    T* p_;
    uint32_t size_ = 0;
    uint32_t cap_ = N;
    alignas(T) unsigned char inline_[N * sizeof(T)];
    T* inl() { return reinterpret_cast<T*>(inline_); }
    const T* inl() const { return reinterpret_cast<const T*>(inline_); }
    void grow(uint32_t want) {
        uint32_t nc = cap_;
        while (nc < want) nc *= 2;
        T* np = (T*)malloc((size_t)nc * sizeof(T));
        memcpy(np, p_, (size_t)size_ * sizeof(T));
        if (p_ != inl()) free(p_);
        p_ = np;
        cap_ = nc;
    }

 public:
    SmallVec() : p_(inl()) {}
    SmallVec(const SmallVec& o) : p_(inl()) { assign(o.begin(), o.end()); }
    SmallVec(SmallVec&& o) noexcept : p_(inl()) {
        *this = std::move(o);
    }
    SmallVec(const T* a, const T* b) : p_(inl()) { assign(a, b); }
    SmallVec& operator=(const SmallVec& o) {
        if (this != &o) assign(o.begin(), o.end());
        return *this;
    }
    SmallVec& operator=(SmallVec&& o) noexcept {
        if (this == &o) return *this;
        if (o.p_ != o.inl()) {
            if (p_ != inl()) free(p_);
            p_ = o.p_;
            size_ = o.size_;
            cap_ = o.cap_;
            o.p_ = o.inl();
            o.size_ = 0;
            o.cap_ = N;
        } else {
            assign(o.begin(), o.end());
            o.size_ = 0;
        }
        return *this;
    }
    ~SmallVec() { if (p_ != inl()) free(p_); }

    T* begin() { return p_; }
    T* end() { return p_ + size_; }
    const T* begin() const { return p_; }
    const T* end() const { return p_ + size_; }
    size_t size() const { return size_; }
    bool empty() const { return size_ == 0; }
    T& operator[](size_t i) { return p_[i]; }
    const T& operator[](size_t i) const { return p_[i]; }
    T& front() { return p_[0]; }
    T& back() { return p_[size_ - 1]; }
    void clear() { size_ = 0; }
    void reserve(size_t n) { if (n > cap_) grow((uint32_t)n); }
    void push_back(const T& v) {
        if (size_ == cap_) grow(size_ + 1);
        p_[size_++] = v;
    }
    void resize(size_t n) {
        if (n > cap_) grow((uint32_t)n);
        for (size_t i = size_; i < n; i++) p_[i] = T{};
        size_ = (uint32_t)n;
    }
    void assign(const T* a, const T* b) {
        size_t n = (size_t)(b - a);
        if (n > cap_) grow((uint32_t)n);
        memmove(p_, a, n * sizeof(T));
        size_ = (uint32_t)n;
    }
    void insert(T* pos, const T& v) {
        size_t at = (size_t)(pos - p_);
        if (size_ == cap_) grow(size_ + 1);
        memmove(p_ + at + 1, p_ + at, (size_ - at) * sizeof(T));
        p_[at] = v;
        size_++;
    }
    void insert(T* pos, const T* a, const T* b) {
        size_t at = (size_t)(pos - p_);
        size_t n = (size_t)(b - a);
        if (size_ + n > cap_) grow((uint32_t)(size_ + n));
        memmove(p_ + at + n, p_ + at, (size_ - at) * sizeof(T));
        memmove(p_ + at, a, n * sizeof(T));
        size_ += (uint32_t)n;
    }
    void erase(T* pos) {
        size_t at = (size_t)(pos - p_);
        memmove(p_ + at, p_ + at + 1, (size_ - at - 1) * sizeof(T));
        size_--;
    }
};

using EOL = SmallVec<EO, 8>;

static void eol_merge_back(EOL& a, EOL& b) {
    if (b.empty()) return;
    size_t start = 0;
    if (!a.empty() && a.back().op == b.front().op) {
        a.back().len += b.front().len;
        start = 1;
    }
    a.insert(a.end(), b.begin() + start, b.end());
    b.clear();
}

static void eol_merge_front(EOL& a, EOL& b) {
    if (b.empty()) return;
    if (!a.empty() && b.back().op == a.front().op) {
        b.back().len += a.front().len;
        a.erase(a.begin());
    }
    a.insert(a.begin(), b.begin(), b.end());
    b.clear();
}

static bool eol_max_match_at_least(const EOL& l, int64_t minimum) {
    for (const EO& e : l)
        if (e.op == 'M' && e.len >= minimum) return true;
    return false;
}

// ---- fragment (core/frags.py) ----
struct Frag {
    int64_t sqo = 0, eqo = 0, sro = 0, ref_len = 0;
    int64_t qlen() const { return 1 + eqo - sqo; }
    int64_t ero() const { return (sro + ref_len - 1) & M32; }
    void set_ero(int64_t ro) { ref_len = 1 + ro - sro; }
    void add_q_front(int64_t n) { sqo -= n; }
    void add_r_front(int64_t n) { sro = (sro - n) & M32; ref_len += n; }
    void add_front(int64_t n) { add_q_front(n); add_r_front(n); }
    void add_q_back(int64_t n) { eqo += n; }
    void add_r_back(int64_t n) { ref_len += n; }
    void add_back(int64_t n) { add_q_back(n); add_r_back(n); }
};

static inline int64_t calc_gap(int64_t low, int64_t high) {
    return high > low ? high - low - 1 : 0;
}
static inline int64_t calc_gap_cost(int64_t length, const Params& aa) {
    return length > 0 ? -(aa.go_cost + length * aa.ge_cost) : 0;
}

struct SFrag {
    Frag frag;
    int64_t score = 0;
    EOL eol;
};

// ---- clump (core/clumps.py; Math.h:469-547) ----
enum { ST_REVERSED = 0x01, ST_ALIGNED = 0x04, ST_SCORED = 0x08,
       ST_SPLIT = 0x10, ST_PRIMARY = 0x20 };

struct Clump {
    EOL eol;
    std::vector<SFrag> sfrags;
    int64_t tot_score = 0, tot_length = 0, matched_bases = 0,
        mismatched_bases = 0, gap_bases = 0;
    int64_t num_secondaries = 0, matched_primary = 0;
    int status = 0;
    int64_t map_quality = 255;

    bool get(int bit) const { return (status & bit) != 0; }
    void set(int bit, bool v) { if (v) status |= bit; else status &= ~bit; }
    bool reversed() const { return get(ST_REVERSED); }
    bool scored() const { return get(ST_SCORED); }
    bool aligned() const { return get(ST_ALIGNED); }
    Frag& first_frag() { return sfrags.front().frag; }
    Frag& last_frag() { return sfrags.back().frag; }
    int64_t sqo() { return first_frag().sqo; }
    int64_t eqo() { return last_frag().eqo; }
    int64_t sro() { return first_frag().sro; }
    int64_t ero() { return last_frag().ero(); }
    int64_t plus_sqo(int64_t query_len) {
        return reversed() ? (query_len - 1) - eqo() : sqo();
    }
    int64_t plus_eqo(int64_t query_len) {
        return reversed() ? (query_len - 1) - sqo() : eqo();
    }
    int64_t query_len() { return 1 + eqo() - sqo(); }
};

// ---- genome view ----
struct GenomeView {
    const uint8_t* codes;
    int64_t codes_len;   // includes the mmap zero-page pad (io/nib2.py)
    int64_t max_roff;
    const int64_t* starts;
    const int64_t* lens;
    int64_t n_seqs;
    std::vector<std::string> names;

    int64_t find_seq_num(int64_t off) const {
        // findBaseSequenceNum (BaseSeq.c:81-90) via binary search.
        const int64_t* hi = std::upper_bound(starts, starts + n_seqs, off);
        int64_t i = (hi - starts) - 1;
        if (i < 0) return -1;
        if (off < starts[i] + lens[i]) return i;
        return -1;
    }
};

// ---- per-thread pipeline state (QueryState_t analog) ----
struct State {
    const Params* aa = nullptr;
    const GenomeView* genome = nullptr;
    const uint32_t* so = nullptr;
    const uint32_t* roa = nullptr;
    int64_t roa_len = 0;

    // Current read.
    int64_t q_len = 0;
    const uint8_t* fwd_chars = nullptr;
    const uint8_t* qual = nullptr;
    std::string query_id;
    std::vector<uint8_t> fwd_codes, rev_codes, rev_chars;
    Rng rng;

    // Clump storage: deque gives stable pointers; slots are REUSED
    // across reads (high-water reset) so clump-level vector capacities
    // persist instead of re-mallocing per clump.
    std::deque<Clump> arena;
    size_t arena_used = 0;
    std::vector<Clump*> clumps;
    int64_t primary_count = 0;

    // DP scratch (grown on demand).
    std::vector<int8_t> dp_eo;
    std::vector<int32_t> dp_idc;
    std::vector<uint8_t> buf_q, buf_r;

    Clump* new_clump() {
        if (arena_used < arena.size()) {
            Clump* c = &arena[arena_used++];
            c->eol.clear();
            c->sfrags.clear();
            c->tot_score = c->tot_length = c->matched_bases = 0;
            c->mismatched_bases = c->gap_bases = 0;
            c->num_secondaries = c->matched_primary = 0;
            c->status = 0;
            c->map_quality = 255;
            return c;
        }
        arena.emplace_back();
        arena_used = arena.size();
        return &arena.back();
    }
    void add_clump(Clump* c, bool rev) {
        // addClump (QueryState.c:156-161): stamp strand, prepend.
        c->set(ST_REVERSED, rev);
        clumps.insert(clumps.begin(), c);
    }
    const uint8_t* qcodes(const Clump& c) const {
        return c.get(ST_REVERSED) ? rev_codes.data() : fwd_codes.data();
    }
    const uint8_t* qchars(const Clump& c) const {
        return c.get(ST_REVERSED) ? rev_chars.data() : fwd_chars;
    }
};

// py_slice's clamping as coordinates: the (start, n_copy) such that
// py_slice == src[start : start + n_copy] zero-padded to count.  Used by
// the *_meta2 exports so the device problem gather reproduces the arena
// slices bit-exactly without the bytes ever crossing the link.
static void py_range(int64_t src_len, int64_t start, int64_t count,
                     int64_t* out_start, int32_t* out_copy) {
    int64_t stop = start + count;
    if (start < 0) { start += src_len; if (start < 0) start = 0; }
    if (stop < 0) { stop += src_len; if (stop < 0) stop = 0; }
    if (start > src_len) start = src_len;
    if (stop > src_len) stop = src_len;
    *out_start = start;
    *out_copy = (int32_t)std::max<int64_t>(stop - start, 0);
}

// Python-slice-semantics copy: src[start:start+count] with negative-index
// wrapping and clamping, zero-padded to count.  Only degenerate chop
// offsets (reference UB emulation, NOTES.md) ever leave the normal range.
static void py_slice(std::vector<uint8_t>& dst, const uint8_t* src,
                     int64_t src_len, int64_t start, int64_t count) {
    dst.assign((size_t)std::max<int64_t>(count, 0), 0);
    if (count <= 0) return;
    int64_t stop = start + count;
    if (start < 0) { start += src_len; if (start < 0) start = 0; }
    if (stop < 0) { stop += src_len; if (stop < 0) stop = 0; }
    if (start > src_len) start = src_len;
    if (stop > src_len) stop = src_len;
    for (int64_t i = start, k = 0; i < stop; i++, k++)
        dst[(size_t)k] = src[i];
}

// ---- perfect extensions (core/align.py:18-66; AlignExtFrag.cpp:30-48) ----

static int64_t ext_fwd_perfect(Frag& f, const uint8_t* genome,
                               int64_t glen, const uint8_t* q,
                               int64_t qlen, int64_t length) {
    if (length <= 0) return 0;
    int64_t q_off = f.eqo + 1;
    int64_t r_off = f.ero() + 1;
    int64_t count = 0;
    // Word-compare fast path over the fully-in-bounds prefix (8 codes
    // per XOR; the scalar tail keeps the negative-index emulation and
    // bounds-break semantics bit-exact for the degenerate-chop cases).
    if (q_off >= 0 && r_off >= 0) {
        int64_t limit = std::min({length, qlen - q_off, glen - r_off});
        while (count + 8 <= limit) {
            uint64_t a, b;
            memcpy(&a, q + q_off + count, 8);
            memcpy(&b, genome + r_off + count, 8);
            uint64_t x = a ^ b;
            if (x) {
                count += __builtin_ctzll(x) >> 3;
                if (count > 0) f.add_back(count);
                return count;
            }
            count += 8;
        }
    }
    while (count < length) {
        int64_t qi = q_off + count;
        if (qi < 0) qi += qlen;        // Python negative-index emulation
        int64_t ri = r_off + count;
        if (ri < 0) ri += glen;
        if (qi < 0 || qi >= qlen || ri < 0 || ri >= glen) break;
        if (q[qi] != genome[ri]) break;
        count++;
    }
    if (count > 0) f.add_back(count);
    return count;
}

static int64_t ext_back_perfect(Frag& f, const uint8_t* genome,
                                int64_t glen, const uint8_t* q,
                                int64_t qlen, int64_t length) {
    if (length <= 0) return 0;
    int64_t q_off = f.sqo - 1;
    int64_t r_off = f.sro - 1;
    int64_t count = 0;
    // Backward word-compare fast path (see ext_fwd_perfect); the
    // highest differing byte of the XOR is the first mismatch walking
    // down from (q_off, r_off).
    if (q_off < qlen && r_off < glen) {
        int64_t limit = std::min({length, q_off + 1, r_off + 1});
        while (count + 8 <= limit) {
            uint64_t a, b;
            memcpy(&a, q + q_off - count - 7, 8);
            memcpy(&b, genome + r_off - count - 7, 8);
            uint64_t x = a ^ b;
            if (x) {
                count += __builtin_clzll(x) >> 3;
                if (count > 0) f.add_front(count);
                return count;
            }
            count += 8;
        }
    }
    while (count < length) {
        int64_t qi = q_off - count;
        if (qi < 0) qi += qlen;
        int64_t ri = r_off - count;
        if (ri < 0) ri += glen;
        if (qi < 0 || qi >= qlen || ri < 0 || ri >= glen) break;
        if (q[qi] != genome[ri]) break;
        count++;
    }
    if (count > 0) f.add_front(count);
    return count;
}

// ---- single-problem DP wrappers over the batched forwards ----

enum { OP_U = 0, OP_M = 1, OP_R = 2, OP_I = 3, OP_D = 4 };
static const char kOpChars[5] = {'U', 'M', 'R', 'I', 'D'};

// Small-extension DP on stack arrays (bit-exact twin of
// yt_extension_forward + banded traceback for qlen <= 24, bw <= 8).
// Extensions at short read lengths average ~14 rows; the generic path's
// scratch machinery costs as much as the DP itself.
static int64_t ext_dp_small(const Params& aa, const uint8_t* q,
                            int64_t qlen, const uint8_t* r, int64_t rlen,
                            bool reverse, EOL& items, int64_t* aq,
                            int64_t* ar) {
    const int32_t WORST = -(0x7FFFFF00);
    const int32_t bw2 = (int32_t)(2 * aa.band_width);
    const int32_t w = 2 * bw2 + 1;
    constexpr int64_t QN = 25, WN = 33;
    int8_t eo[QN * WN];
    int8_t idc[QN * WN];
    int32_t pvb[WN + 2], pfb[WN + 2], pib[WN + 2];
    const int32_t go = (int32_t)aa.go_cost, ge = (int32_t)aa.ge_cost;
    const int32_t rc = (int32_t)aa.r_cost, ms = (int32_t)aa.m_score;
    const int64_t max_gap = aa.max_gap, max_intron = aa.max_intron;
    const int32_t x_cutoff = (int32_t)aa.x_cutoff;
    for (int32_t j = 0; j < w; j++) {
        if (j > bw2) {
            pvb[j] = -(go + (j - bw2) * ge);
            eo[j] = OP_D;
            idc[j] = (int8_t)(j - bw2);
        } else {
            pvb[j] = (j == bw2) ? 0 : WORST;
            eo[j] = OP_U;
            idc[j] = 0;
        }
        pfb[j] = (j == bw2) ? 0 : WORST;
        pib[j] = 0;
    }
    pvb[w] = WORST; pfb[w] = WORST; pib[w] = 0;
    for (int32_t i = 1; i <= bw2 && i <= qlen; i++) {
        eo[i * w + (bw2 - i)] = OP_I;
        idc[i * w + (bw2 - i)] = (int8_t)i;
    }
    int32_t max_score = WORST, maxi = 0, maxj = 0;
    for (int32_t i = 1; i <= qlen; i++) {
        int32_t start_col = bw2 + 1 - i;
        int32_t pv_col;
        if (start_col <= 0) { start_col = 0; pv_col = WORST; }
        else { pv_col = -(go + i * ge); pvb[start_col - 1] = pv_col; }
        int32_t end_col = bw2 + (int32_t)rlen - i;
        if (end_col > w - 1) end_col = w - 1;
        int32_t pe_col = WORST, pd_col = 0;
        int32_t row_max = WORST;
        int q_char = q[i - 1];
        int8_t* __restrict__ eor = eo + i * w;
        int8_t* __restrict__ idr = idc + i * w;
        const uint8_t* __restrict__ rrow = r + i - bw2 - 1;
        for (int32_t j = start_col; j <= end_col; j++) {
            int32_t v = pvb[j];
            int r_char = rrow[j];
            int8_t opcode = (q_char == r_char) ? OP_M : OP_R;
            int32_t g = (q_char == r_char) ? v + ms : v - rc;
            int32_t cell_idc = 0;
            int32_t ce = pe_col - ge;
            int32_t ne = pv_col - (go + ge);
            if (ce >= ne && pd_col + 1 <= max_intron) {
                pe_col = ce; pd_col += 1;
            } else { pe_col = ne; pd_col = 1; }
            int32_t v1;
            if (pe_col >= g) { v1 = pe_col; opcode = OP_D;
                               cell_idc = pd_col; }
            else v1 = g;
            int32_t cf = pfb[j + 1] - ge;
            int32_t nf = pvb[j + 1] - (go + ge);
            int32_t f, ii;
            if (cf >= nf && pib[j + 1] + 1 <= max_gap) {
                f = cf; ii = pib[j + 1] + 1;
            } else { f = nf; ii = 1; }
            int32_t v2;
            if (f >= v1) { v2 = f; opcode = OP_I; cell_idc = ii; }
            else v2 = v1;
            pfb[j] = f;
            pib[j] = ii;
            eor[j] = opcode;
            if (opcode >= OP_I) idr[j] = (int8_t)cell_idc;
            if (v2 > row_max) row_max = v2;
            if (v2 > max_score) { max_score = v2; maxi = i; maxj = j; }
            pvb[j] = v2;
            pv_col = v2;
        }
        if (row_max < max_score - x_cutoff) break;
    }
    items.clear();
    if (max_score <= 0) { *aq = 0; *ar = 0; return max_score; }
    int64_t x = maxj, y = maxi;
    int prev = eo[y * w + x];
    int64_t op_len = 0;
    for (;;) {
        int code = eo[y * w + x];
        if (code == OP_U) break;
        int64_t length = idc[y * w + x];
        if (code == OP_D) x -= length;
        else if (code == OP_I) { x += length; y -= length; }
        else { y -= 1; length = 1; }
        if (prev != code) {
            items.push_back({kOpChars[prev], (int32_t)op_len});
            prev = code;
            op_len = length;
        } else {
            op_len += length;
        }
    }
    items.push_back({kOpChars[prev], (int32_t)op_len});
    if (!reverse) std::reverse(items.begin(), items.end());
    *aq = maxi;
    *ar = maxi + (maxj - bw2);
    return max_score;
}

// Banded X-dropoff extension (findAGSExtension DP arm) + run-length
// backtrack (ops/dp_common.py traceback_extension).
static int64_t ext_dp(State& st, const uint8_t* q, int64_t qlen,
                      const uint8_t* r, int64_t rlen, bool reverse,
                      EOL& items, int64_t* aq, int64_t* ar) {
    const Params& aa = *st.aa;
    if (qlen <= 24 && aa.band_width <= 8) {
        double ts = g_prof ? now_s() : 0;
        int64_t rv =
            ext_dp_small(aa, q, qlen, r, rlen, reverse, items, aq, ar);
        if (g_prof) { g_prof->dps += now_s() - ts; g_prof->dps_calls++; }
        return rv;
    }
    const int64_t bw2 = 2 * aa.band_width;
    const int64_t w = 2 * bw2 + 1;
    size_t need = (size_t)((qlen + 1) * w);
    if (st.dp_eo.size() < need) st.dp_eo.resize(need);
    if (st.dp_idc.size() < need) st.dp_idc.resize(need);
    // No full-plane zeroing here (unlike the batch API, whose A/B plane
    // compares need it): every cell the backtrack can reach is written
    // by this call — rows <= the X-drop exit row are fully computed,
    // row 0 and the leading OP_I column are primed by the wrapper, and
    // partially-computed rows past the exit are re-zeroed in-kernel.
    // An extension walks a ~(exit row x band) region of a plane sized
    // for qlen, so the memset dominated short-extension calls.
    int32_t ql32 = (int32_t)qlen, rl32 = (int32_t)rlen;
    int32_t score = 0, maxi = 0, maxj = 0;
    double ts = g_prof ? now_s() : 0;
    yt_extension_forward(q, &ql32, r, &rl32, 1, qlen, rlen,
                         (int)aa.band_width, (int)aa.go_cost,
                         (int)aa.ge_cost, (int)aa.r_cost, (int)aa.m_score,
                         (int)aa.max_gap, (int)aa.max_intron,
                         (int)aa.x_cutoff,
                         st.dp_eo.data(), st.dp_idc.data(), &score, &maxi,
                         &maxj);
    if (g_prof) { g_prof->dp += now_s() - ts; g_prof->dp_calls++; }
    items.clear();
    if (score <= 0) { *aq = 0; *ar = 0; return score; }
    // Walk from (maxi, maxj); banded moves (SW.cpp:1137-1168).
    int64_t x = maxj, y = maxi;
    const int8_t* e = st.dp_eo.data();
    const int32_t* d = st.dp_idc.data();
    int prev = e[y * w + x];
    int64_t op_len = 0;
    for (;;) {
        int code = e[y * w + x];
        if (code == OP_U) break;
        int64_t length = d[y * w + x];
        if (code == OP_D) x -= length;
        else if (code == OP_I) { x += length; y -= length; }
        else { y -= 1; length = 1; }
        if (prev != code) {
            items.push_back({kOpChars[prev], (int32_t)op_len});
            prev = code;
            op_len = length;
        } else {
            op_len += length;
        }
    }
    items.push_back({kOpChars[prev], (int32_t)op_len});
    if (!reverse) std::reverse(items.begin(), items.end());
    *aq = maxi;
    *ar = maxi + (maxj - bw2);
    return score;
}

// Small-problem anchored DP on stack arrays (bit-exact twin of
// yt_anchored_forward + traceback for qlen,rlen <= 24).  Gap-fill
// problems are dominated by scattered 1-10bp substitution/indel gaps;
// the generic path's scratch machinery costs more than the DP itself.
static int64_t anchored_dp_small(const Params& aa, const uint8_t* q,
                                 int64_t qlen, const uint8_t* r,
                                 int64_t rlen, int64_t lbw, int64_t rbw,
                                 EOL& items) {
    constexpr int64_t N = 25;
    const int64_t wid = rlen + 1;
    int8_t eo[N * N];
    int8_t idc[N * N];
    int32_t pvb[N + 1], pfb[N + 1], pib[N + 1], vnb[N + 1];
    const int32_t WORST = -(0x7FFFFF00);
    const int32_t go = (int32_t)aa.go_cost, ge = (int32_t)aa.ge_cost;
    const int32_t rc = (int32_t)aa.r_cost, ms = (int32_t)aa.m_score;
    const int64_t max_gap = aa.max_gap, max_intron = aa.max_intron;
    int32_t score = 0;
    for (int64_t j = 0; j <= wid; j++) {
        if (j >= 1 && j <= rbw && j <= rlen && j < wid) {
            pvb[j] = -(go + (int32_t)j * ge);
            eo[j] = OP_D;
            idc[j] = (int8_t)j;
        } else {
            pvb[j] = (j == 0) ? 0 : WORST;
            if (j < wid) { eo[j] = OP_U; idc[j] = 0; }
        }
        pfb[j] = WORST;
        pib[j] = 0;
    }
    int32_t* pvp = pvb;
    int32_t* vnp = vnb;
    for (int64_t i = 1; i <= qlen; i++) {
        int8_t* eorow = eo + i * wid;
        int8_t* idrow = idc + i * wid;
        if (i <= lbw) { eorow[0] = OP_I; idrow[0] = (int8_t)i; }
        else { eorow[0] = OP_U; idrow[0] = 0; }
        int64_t jlo = i - lbw; if (jlo < 1) jlo = 1;
        int64_t jhi = i + rbw; if (jhi > rlen) jhi = rlen;
        for (int64_t j = 1; j < jlo && j < wid; j++) eorow[j] = OP_U;
        for (int64_t j = jhi + 1; j < wid; j++) eorow[j] = OP_U;
        int q_char = q[i - 1];
        int32_t pe_col = WORST, pd_col = 0;
        int32_t pv_col = (i <= lbw) ? -(go + (int32_t)i * ge) : WORST;
        vnp[0] = (i <= lbw) ? -(go + (int32_t)i * ge) : pvp[0];
        if (jlo - 1 >= 1) vnp[jlo - 1] = WORST;
        if (jhi + 1 <= wid) vnp[jhi + 1] = WORST;
        for (int64_t j = jlo; j <= jhi; j++) {
            int32_t v = pvp[j - 1];
            int r_char = r[j - 1];
            int8_t opcode = (q_char == r_char) ? OP_M : OP_R;
            int32_t g = (q_char == r_char) ? v + ms : v - rc;
            int32_t cell_idc = 0;
            int32_t ce = pe_col - ge;
            int32_t ne = pv_col - (go + ge);
            if (ce >= ne && pd_col + 1 <= max_intron) {
                pe_col = ce; pd_col += 1;
            } else { pe_col = ne; pd_col = 1; }
            int32_t v1;
            if (pe_col > g) { v1 = pe_col; opcode = OP_D;
                              cell_idc = pd_col; }
            else v1 = g;
            int32_t cf = pfb[j] - ge;
            int32_t nf = pvp[j] - (go + ge);
            int32_t f, ii;
            if (cf >= nf && pib[j] + 1 <= max_gap) {
                f = cf; ii = pib[j] + 1;
            } else { f = nf; ii = 1; }
            int32_t v2;
            if (f > v1) { v2 = f; opcode = OP_I; cell_idc = (int32_t)ii; }
            else v2 = v1;
            pfb[j] = f;
            pib[j] = ii;
            eorow[j] = opcode;
            if (opcode >= OP_I) idrow[j] = (int8_t)cell_idc;
            vnp[j] = v2;
            pv_col = v2;
        }
        if (i == qlen && rlen >= jlo && rlen <= jhi) score = vnp[rlen];
        std::swap(pvp, vnp);
    }
    // Backtrack (traceback_anchored, full coordinates).
    int64_t x = rlen, y = qlen;
    items.clear();
    int prev = eo[y * wid + x];
    int64_t op_len = 0;
    for (;;) {
        int code = eo[y * wid + x];
        if (code == OP_U) break;
        int64_t length = idc[y * wid + x];
        if (code == OP_D) x -= length;
        else if (code == OP_I) y -= length;
        else { x -= 1; y -= 1; length = 1; }
        if (prev != code) {
            items.push_back({kOpChars[prev], (int32_t)op_len});
            prev = code;
            op_len = length;
        } else {
            op_len += length;
        }
    }
    items.push_back({kOpChars[prev], (int32_t)op_len});
    std::reverse(items.begin(), items.end());
    return score;
}

// Anchored (gap-fill) DP + backtrack (traceback_anchored).
static int64_t anchored_dp(State& st, const uint8_t* q, int64_t qlen,
                           const uint8_t* r, int64_t rlen, int64_t lbw,
                           int64_t rbw, EOL& items) {
    const Params& aa = *st.aa;
    if (qlen <= 24 && rlen <= 24)
        return anchored_dp_small(aa, q, qlen, r, rlen, lbw, rbw, items);
    size_t need = (size_t)((qlen + 1) * (rlen + 1));
    if (st.dp_eo.size() < need) st.dp_eo.resize(need);
    if (st.dp_idc.size() < need) st.dp_idc.resize(need);
    int32_t ql32 = (int32_t)qlen, rl32 = (int32_t)rlen;
    int32_t lb32 = (int32_t)lbw, rb32 = (int32_t)rbw;
    int32_t score = 0;
    double ts = g_prof ? now_s() : 0;
    yt_anchored_forward(q, &ql32, r, &rl32, &lb32, &rb32, 1, qlen, rlen,
                        (int)aa.go_cost, (int)aa.ge_cost, (int)aa.r_cost,
                        (int)aa.m_score, (int)aa.max_gap,
                        (int)aa.max_intron,
                        st.dp_eo.data(), st.dp_idc.data(), &score);
    if (g_prof) { g_prof->dpa += now_s() - ts; g_prof->dpa_calls++; }
    const int64_t wid = rlen + 1;
    int64_t x = rlen, y = qlen;
    const int8_t* e = st.dp_eo.data();
    const int32_t* d = st.dp_idc.data();
    items.clear();
    int prev = e[y * wid + x];
    int64_t op_len = 0;
    for (;;) {
        int code = e[y * wid + x];
        if (code == OP_U) break;
        int64_t length = d[y * wid + x];
        if (code == OP_D) x -= length;
        else if (code == OP_I) y -= length;
        else { x -= 1; y -= 1; length = 1; }
        if (prev != code) {
            items.push_back({kOpChars[prev], (int32_t)op_len});
            prev = code;
            op_len = length;
        } else {
            op_len += length;
        }
    }
    items.push_back({kOpChars[prev], (int32_t)op_len});
    std::reverse(items.begin(), items.end());
    return score;
}

// findAGSAlignment[Banded] (core/sw.py:268-295).
static int64_t find_ags_alignment(State& st, int64_t r_off, int64_t r_len,
                                  const uint8_t* q_codes, int64_t q_off,
                                  int64_t q_len, EOL& out, bool banded) {
    const Params& aa = *st.aa;
    int64_t lbw, rbw;
    if (banded) {
        if (r_len > q_len) {
            lbw = aa.band_width;
            rbw = aa.band_width + (r_len - q_len);
        } else {
            lbw = aa.band_width + (q_len - r_len);
            rbw = aa.band_width;
        }
    } else {
        lbw = rbw = std::max(q_len, r_len) + 1;
    }
    const GenomeView& g = *st.genome;
    const uint8_t* q;
    const uint8_t* r;
    if (q_off >= 0 && q_off + q_len <= st.q_len) {
        q = q_codes + q_off;
    } else {
        py_slice(st.buf_q, q_codes, st.q_len, q_off, q_len);
        q = st.buf_q.data();
    }
    if (r_off >= 0 && r_off + r_len <= g.codes_len) {
        r = g.codes + r_off;
    } else {
        py_slice(st.buf_r, g.codes, g.codes_len, r_off, r_len);
        r = st.buf_r.data();
    }
    return anchored_dp(st, q, q_len, r, r_len, lbw, rbw, out);
}

// findAGSExtension<reverse> (core/sw.py:298-369; SW.cpp:479-533).
// Returns score; merges the extension ops into out_list when score > 0.
static int64_t find_ags_extension(State& st, int64_t r_off,
                                  const uint8_t* q_codes, int64_t q_off,
                                  int64_t q_len, EOL& out_list,
                                  bool reverse, int64_t* aq_out,
                                  int64_t* ar_out) {
    const Params& aa = *st.aa;
    const GenomeView& g = *st.genome;
    *aq_out = 0;
    *ar_out = 0;
    if (q_len <= 0) return 0;
    const int64_t bandwidth = 2 * aa.band_width;
    int64_t r_len = q_len + bandwidth;
    const uint8_t* q;
    const uint8_t* r;
    if (reverse) {
        if (r_len > r_off) {
            r_len = r_off + 1;
            q_len = r_len - bandwidth;
            if (q_len <= 0) return 0;
        }
        // Reversed slices genome[r_off-r_len+1 : r_off+1][::-1] and
        // q_codes[q_off-q_len+1 : q_off+1][::-1].
        py_slice(st.buf_r, g.codes, g.codes_len, r_off - r_len + 1, r_len);
        std::reverse(st.buf_r.begin(), st.buf_r.end());
        r = st.buf_r.data();
        py_slice(st.buf_q, q_codes, st.q_len, q_off - q_len + 1, q_len);
        std::reverse(st.buf_q.begin(), st.buf_q.end());
        q = st.buf_q.data();
    } else {
        if (r_off + r_len > g.max_roff) {
            r_len = g.max_roff - r_off;
            q_len = r_len - bandwidth;
            if (q_len <= 0) return 0;
        }
        if (r_off >= 0 && r_off + r_len <= g.codes_len) {
            r = g.codes + r_off;
        } else {
            py_slice(st.buf_r, g.codes, g.codes_len, r_off, r_len);
            r = st.buf_r.data();
        }
        if (q_off >= 0 && q_off + q_len <= st.q_len) {
            q = q_codes + q_off;
        } else {
            py_slice(st.buf_q, q_codes, st.q_len, q_off, q_len);
            q = st.buf_q.data();
        }
    }
    static thread_local EOL items;
    int64_t aq, ar;
    int64_t score = ext_dp(st, q, q_len, r, r_len, reverse, items, &aq,
                           &ar);
    if (score <= 0) return 0;
    if (reverse) eol_merge_front(out_list, items);
    else eol_merge_back(out_list, items);
    *aq_out = aq;
    *ar_out = ar;
    return score;
}

// findAGSForwardExtensionCarefully (core/sw.py:405-446; SW.cpp:553-669).
static int64_t fwd_ext_carefully(State& st, int64_t r_off,
                                 const uint8_t* q_codes, int64_t q_off,
                                 int64_t q_len, EOL& out_list,
                                 int64_t score, int64_t* aq_out,
                                 int64_t* ar_out) {
    const Params& aa = *st.aa;
    *aq_out = 0;
    *ar_out = 0;
    EOL tmp;
    int64_t added_q, added_r;
    int64_t init_ags = find_ags_extension(st, r_off, q_codes, q_off, q_len,
                                          tmp, false, &added_q, &added_r);
    if (init_ags <= 0) return 0;
    int64_t ql = 0, rl = 0;
    int64_t ags = score;
    int64_t max_ags = score;
    int64_t max_idx = -1;
    int64_t max_ql = 0, max_rl = 0;
    for (size_t idx = 0; idx < tmp.size(); idx++) {
        char op = tmp[idx].op;
        int64_t length = tmp[idx].len;
        if (op == 'M') { ql += length; rl += length;
                         ags += aa.m_score * length; }
        else if (op == 'R') { ql += length; rl += length;
                              ags -= aa.r_cost * length; }
        else if (op == 'I') { ql += length;
                              ags -= aa.go_cost + aa.ge_cost * length; }
        else { rl += length; ags -= aa.go_cost + aa.ge_cost * length; }
        if (ags > max_ags) {
            max_ags = ags;
            max_ql = ql; max_rl = rl;
            max_idx = (int64_t)idx;
        } else if (ags <= 0) {
            if (max_ags <= score) return 0;
            tmp.resize((size_t)(max_idx + 1));  // split_after: drop tail
            added_q = max_ql;
            added_r = max_rl;
            init_ags = max_ags - score;
            break;
        }
    }
    eol_merge_back(out_list, tmp);
    *aq_out = added_q;
    *ar_out = added_r;
    return init_ags;
}

// findAGSBackwardExtensionCarefully (core/sw.py:449-491; SW.cpp:671-788).
static int64_t back_ext_carefully(State& st, int64_t r_off,
                                  const uint8_t* q_codes, int64_t q_off,
                                  int64_t q_len, EOL& out_list,
                                  int64_t score, int64_t* aq_out,
                                  int64_t* ar_out) {
    const Params& aa = *st.aa;
    *aq_out = 0;
    *ar_out = 0;
    EOL tmp;
    int64_t added_q, added_r;
    int64_t init_ags = find_ags_extension(st, r_off, q_codes, q_off, q_len,
                                          tmp, true, &added_q, &added_r);
    if (init_ags <= 0) return 0;
    int64_t ql = 0, rl = 0;
    int64_t ags = 0;
    int64_t max_ags = 0;
    int64_t start_idx = -1;
    for (size_t idx = 0; idx < tmp.size(); idx++) {
        char op = tmp[idx].op;
        int64_t length = tmp[idx].len;
        if (op == 'M') { ql += length; rl += length;
                         ags += aa.m_score * length; }
        else if (op == 'R') { ql += length; rl += length;
                              ags -= aa.r_cost * length; }
        else if (op == 'I') { ql += length;
                              ags -= aa.go_cost + aa.ge_cost * length; }
        else { rl += length; ags -= aa.go_cost + aa.ge_cost * length; }
        if (ags <= 0) {
            ags = 0;
            max_ags = 0;
            ql = rl = 0;
            start_idx = (int64_t)idx;
        }
        if (ags > max_ags) max_ags = ags;
    }
    if (ags <= 0 || max_ags >= ags + score) return 0;
    if (start_idx >= 0) {
        // wanted = tmp.split_after(start_idx); merge wanted (the tail).
        EOL wanted(tmp.begin() + (size_t)(start_idx + 1), tmp.end());
        eol_merge_front(out_list, wanted);
    } else {
        eol_merge_front(out_list, tmp);
    }
    *aq_out = ql;
    *ar_out = rl;
    return ags;
}

// ---- clump alignment (core/align.py) ----

// makeAndAlignSFragmentToFillGap (core/align.py:69-100).  Returns false
// if no gap (nothing inserted); fills new_sf otherwise.
static bool make_and_align_gap(State& st, SFrag& sf1, SFrag& sf2,
                               const uint8_t* q_codes, SFrag& new_sf) {
    const Params& aa = *st.aa;
    Frag& frag1 = sf1.frag;
    Frag& frag2 = sf2.frag;
    int64_t q_gap = calc_gap(frag1.eqo, frag2.sqo);
    int64_t r_gap = calc_gap(frag1.ero(), frag2.sro);
    if (q_gap == 0 && r_gap == 0) return false;
    Frag& nf = new_sf.frag;
    nf.sqo = frag1.eqo + 1;
    nf.eqo = frag2.sqo - 1;
    nf.sro = (frag1.ero() + 1) & M32;
    nf.set_ero(frag2.sro - 1);
    EOL& lst = new_sf.eol;
    if (q_gap == 0) {
        lst.push_back({'D', (int32_t)r_gap});
        new_sf.score = calc_gap_cost(r_gap, aa);
    } else if (r_gap == 0) {
        lst.push_back({'I', (int32_t)q_gap});
        new_sf.score = calc_gap_cost(q_gap, aa);
    } else if (r_gap == 1 && q_gap == 1) {
        lst.push_back({'R', 1});
        new_sf.score = -aa.r_cost;
    } else {
        int64_t len_diff = std::abs(q_gap - r_gap);
        bool banded = len_diff + aa.band_width * 2 + 1 < r_gap;
        new_sf.score = find_ags_alignment(st, nf.sro, r_gap, q_codes,
                                          nf.sqo, q_gap, lst, banded);
    }
    return true;
}

// collapseSFragments (core/align.py:103-115).
static void collapse_sfragments(Clump& clump) {
    EOL& lst = clump.eol;
    int64_t total = 0;
    for (SFrag& sf : clump.sfrags) {
        total += sf.score;
        eol_merge_back(lst, sf.eol);
    }
    SFrag& sf0 = clump.sfrags.front();
    SFrag& sfn = clump.sfrags.back();
    sf0.frag.eqo = sfn.frag.eqo;
    sf0.frag.set_ero(sfn.frag.ero());
    sf0.score = total;
    clump.sfrags.resize(1);
}

// extendClumpForwardReverseTemplated (core/align.py:118-176).
static void extend_clump_fr(State& st, Clump& clump, bool go_back,
                            bool go_forw, bool carefully) {
    const Params& aa = *st.aa;
    SFrag& sf = clump.sfrags.front();
    Frag& frag = sf.frag;
    EOL& lst = clump.eol;
    const GenomeView& g = *st.genome;
    const uint8_t* q_codes = st.qcodes(clump);
    int64_t score = sf.score;

    int64_t back_len = 0, forw_len = 0;
    if (go_back) {
        back_len = std::min(frag.sqo, frag.sro);
        if (back_len > 0) {
            int64_t nm = ext_back_perfect(frag, g.codes, g.codes_len,
                                          q_codes, st.q_len, back_len);
            if (nm > 0) {
                lst.front().len += nm;
                score += nm * aa.m_score;
                back_len -= nm;
            }
        }
    }
    if (go_forw) {
        int64_t qlen = (st.q_len - 1) - frag.eqo;
        int64_t rlen = g.max_roff - frag.ero();
        forw_len = std::min(qlen, rlen);
        if (forw_len > 0) {
            int64_t nm = ext_fwd_perfect(frag, g.codes, g.codes_len,
                                         q_codes, st.q_len, forw_len);
            if (nm > 0) {
                lst.back().len += nm;
                score += nm * aa.m_score;
                forw_len -= nm;
            }
        }
    }

    if (go_back && back_len >= aa.min_ext_length) {
        int64_t new_score, aq, ar;
        if (carefully)
            new_score = back_ext_carefully(st, frag.sro - 1, q_codes,
                                           frag.sqo - 1, back_len, lst,
                                           score, &aq, &ar);
        else
            new_score = find_ags_extension(st, frag.sro - 1, q_codes,
                                           frag.sqo - 1, back_len, lst,
                                           true, &aq, &ar);
        if (new_score > 0) {
            score += new_score;
            frag.add_q_front(aq);
            frag.add_r_front(ar);
        }
    }
    if (go_forw && forw_len >= aa.min_ext_length) {
        int64_t new_score, aq, ar;
        if (carefully)
            new_score = fwd_ext_carefully(st, frag.ero() + 1, q_codes,
                                          frag.eqo + 1, forw_len, lst,
                                          score, &aq, &ar);
        else
            new_score = find_ags_extension(st, frag.ero() + 1, q_codes,
                                           frag.eqo + 1, forw_len, lst,
                                           false, &aq, &ar);
        if (new_score > 0) {
            score += new_score;
            frag.add_q_back(aq);
            frag.add_r_back(ar);
        }
    }
    sf.score = score;
}

// alignClump (core/align.py:179-213; AlignHelpers.c:205-272).
static void align_clump(State& st, Clump& clump) {
    if (clump.aligned()) return;
    const Params& aa = *st.aa;
    const GenomeView& g = *st.genome;
    const uint8_t* q_codes = st.qcodes(clump);
    std::vector<SFrag>& sfrags = clump.sfrags;

    // Perfect extensions of fragments toward each other.
    for (size_t k = 0; k + 1 < sfrags.size(); k++) {
        Frag& frag1 = sfrags[k].frag;
        Frag& frag2 = sfrags[k + 1].frag;
        int64_t gap = std::min(calc_gap(frag1.eqo, frag2.sqo),
                               calc_gap(frag1.ero(), frag2.sro));
        gap -= ext_back_perfect(frag2, g.codes, g.codes_len, q_codes,
                                st.q_len, gap);
        gap -= ext_fwd_perfect(frag1, g.codes, g.codes_len, q_codes,
                               st.q_len, gap);
    }

    // Per-fragment Match edit op + score.
    for (SFrag& sf : sfrags) {
        int64_t q_len = sf.frag.qlen();
        sf.eol.insert(sf.eol.begin(), {'M', (int32_t)q_len});
        sf.score = aa.m_score * q_len;
    }

    // Gap-fill SFragments (inserted after current; the inserted one is
    // visited next and yields zero gaps).
    double tg = g_prof ? now_s() : 0;
    // Gap SFragments span exactly [frag1.eqo+1, frag2.sqo-1], so a gap
    // never opens between an inserted SFragment and its right neighbor;
    // building the interleaved list in one pass is equivalent to the
    // reference's insert-after-current walk (AlignExtFrag.cpp:164-234)
    // without the O(n^2) mid-vector moves.
    if (sfrags.size() > 1) {
        static thread_local std::vector<SFrag> merged;
        merged.clear();
        merged.reserve(sfrags.size() * 2 - 1);
        merged.push_back(std::move(sfrags[0]));
        for (size_t i = 0; i + 1 < sfrags.size(); i++) {
            SFrag new_sf;
            if (make_and_align_gap(st, merged.back(), sfrags[i + 1],
                                   q_codes, new_sf))
                merged.push_back(std::move(new_sf));
            merged.push_back(std::move(sfrags[i + 1]));
        }
        sfrags.swap(merged);
    }
    double tc = g_prof ? now_s() : 0;
    collapse_sfragments(clump);
    extend_clump_fr(st, clump, true, true, false);
    if (g_prof) {
        double te = now_s();
        g_prof->gapc += tc - tg;
        g_prof->extfr += te - tc;
    }
    clump.set(ST_ALIGNED, true);
}

// ---- scoring & splitting (core/align.py:216-396) ----

static int64_t score_clump(State& st, Clump& clump);

// splitClumpHelper (core/align.py:264-390; AlignHelpers.c:374-557).
static int64_t split_clump_helper(State& st, Clump& clump, int64_t w_sqo,
                                  int64_t w_eqo) {
    const Params& aa = *st.aa;
    SFrag& cur_sf = clump.sfrags.front();
    Frag& cur_frag = cur_sf.frag;
    EOL& lst = cur_sf.eol;
    eol_merge_front(lst, clump.eol);

    // Forward pass: find max-scoring end point.
    int64_t s_qo = 0, e_qo = 0, s_ro = 0, e_ro = 0;
    int64_t matches = 0, mismatches = 0, inserts = 0, deletes = 0;
    int64_t ags = 0;
    int64_t max_ags = -10000;
    int64_t max_idx = -1;
    for (size_t idx = 0; idx < lst.size(); idx++) {
        char op = lst[idx].op;
        int64_t length = lst[idx].len;
        int64_t new_score;
        if (op == 'M') { matches += length; new_score = aa.m_score * length; }
        else if (op == 'R') { mismatches += length;
                              new_score = -(aa.r_cost * length); }
        else if (op == 'I') { inserts += length;
                              new_score = -(aa.go_cost +
                                            aa.ge_cost * length); }
        else { deletes += length;
               new_score = -(aa.go_cost + aa.ge_cost * length); }
        ags += new_score;
        if (ags < 0) ags = 0;
        if (ags > max_ags) {
            max_ags = ags;
            max_idx = (int64_t)idx;
            e_qo = cur_frag.sqo + matches + mismatches + inserts - 1;
            e_ro = cur_frag.sro + matches + mismatches + deletes - 1;
        }
    }

    // Backward pass from the max: find the first zero.
    ags = max_ags;
    matches = mismatches = inserts = deletes = 0;
    int64_t max_match = 0;
    int64_t min_idx = -1;
    for (int64_t idx = max_idx; idx >= 0; idx--) {
        char op = lst[(size_t)idx].op;
        int64_t length = lst[(size_t)idx].len;
        if (op == 'M') {
            matches += length;
            ags -= aa.m_score * length;
            if (length > max_match) max_match = length;
        } else if (op == 'R') {
            mismatches += length;
            ags += aa.r_cost * length;
        } else if (op == 'I') {
            inserts += length;
            ags += aa.go_cost + aa.ge_cost * length;
        } else {
            deletes += length;
            ags += aa.go_cost + aa.ge_cost * length;
        }
        if (ags <= 0) {
            min_idx = idx;
            s_qo = e_qo - (matches + mismatches + inserts - 1);
            s_ro = e_ro - (matches + mismatches + deletes - 1);
            break;
        }
    }
    if (max_match < aa.word_len) return 0;

    int64_t retval = 0;
    // Head piece.
    if (min_idx != 0) {
        Clump* new_clump = st.new_clump();
        new_clump->set(ST_REVERSED, clump.reversed());
        new_clump->sfrags.emplace_back();
        SFrag& new_sf = new_clump->sfrags.front();
        EOL& new_eol = new_sf.eol;
        eol_merge_front(new_eol, lst);           // new_eol takes all items
        // Split so new_eol keeps [:min_idx], lst gets [min_idx:].
        lst.assign(new_eol.begin() + (size_t)min_idx, new_eol.end());
        new_eol.resize((size_t)min_idx);
        max_idx -= min_idx;   // maxItem pointer survives the split
        if (eol_max_match_at_least(new_eol, aa.word_len)) {
            Frag& nf = new_sf.frag;
            nf.sqo = cur_frag.sqo;
            nf.eqo = s_qo - 1;
            nf.sro = cur_frag.sro;
            nf.set_ero(s_ro - 1);
            retval += split_clump_helper(st, *new_clump, w_sqo, w_eqo);
        }
        if (new_clump->scored()) {
            new_clump->set(ST_SPLIT, true);
            new_clump->set(ST_ALIGNED, true);
            st.add_clump(new_clump, clump.reversed());
        }
    }
    // Tail piece.
    if (max_idx != (int64_t)lst.size() - 1) {
        Clump* new_clump = st.new_clump();
        new_clump->set(ST_REVERSED, clump.reversed());
        new_clump->sfrags.emplace_back();
        SFrag& new_sf = new_clump->sfrags.front();
        EOL& new_eol = new_sf.eol;
        new_eol.assign(lst.begin() + (size_t)(max_idx + 1), lst.end());
        lst.resize((size_t)(max_idx + 1));
        if (eol_max_match_at_least(new_eol, aa.word_len)) {
            Frag& nf = new_sf.frag;
            nf.sqo = e_qo + 1;
            nf.eqo = cur_frag.eqo;
            nf.sro = (e_ro + 1) & M32;
            nf.set_ero(cur_frag.ero());
            retval += split_clump_helper(st, *new_clump, w_sqo, w_eqo);
        }
        if (new_clump->scored()) {
            new_clump->set(ST_SPLIT, true);
            new_clump->set(ST_ALIGNED, true);
            st.add_clump(new_clump, clump.reversed());
        }
    }

    // The surviving core.
    cur_frag.sqo = s_qo;
    cur_frag.eqo = e_qo;
    cur_frag.sro = s_ro & M32;
    cur_frag.set_ero(e_ro);
    cur_sf.score = max_ags;
    eol_merge_front(clump.eol, lst);

    bool go_back = s_qo != w_sqo;
    bool go_forw = e_qo != w_eqo;
    extend_clump_fr(st, clump, go_back, go_forw, true);
    clump.set(ST_SPLIT, true);
    retval += score_clump(st, clump);
    return retval;
}

// splitClump (core/align.py:393-396).
static int64_t split_clump(State& st, Clump& clump) {
    Frag& cur_frag = clump.sfrags.front().frag;
    return split_clump_helper(st, clump, cur_frag.sqo, cur_frag.eqo);
}

// scoreClump (core/align.py:216-261; AlignHelpers.c:302-366).
static int64_t score_clump(State& st, Clump& clump) {
    if (clump.scored()) return 1;
    const Params& aa = *st.aa;
    int64_t ags = 0;
    int64_t max_ags = 0;
    int64_t matches = 0, mismatches = 0, inserts = 0, deletes = 0;
    const EOL& items = clump.eol;
    int64_t aligned_score = clump.sfrags.front().score;
    int64_t last_idx = (int64_t)items.size() - 1;
    for (int64_t idx = 0; idx <= last_idx; idx++) {
        char op = items[(size_t)idx].op;
        int64_t length = items[(size_t)idx].len;
        if (op == 'M') { matches += length; ags += aa.m_score * length; }
        else if (op == 'R') { mismatches += length;
                              ags -= aa.r_cost * length; }
        else if (op == 'I') { inserts += length;
                              ags -= aa.go_cost + aa.ge_cost * length; }
        else if (op == 'D') { deletes += length;
                              ags -= aa.go_cost + aa.ge_cost * length; }
        if (ags <= 0 || (ags >= aligned_score && idx != last_idx))
            return split_clump(st, clump);
        if (ags > max_ags) max_ags = ags;
    }
    if (matches >= aa.min_raw_score && max_ags > ags)
        return split_clump(st, clump);
    if (matches < aa.min_raw_score) return 0;

    // Clump counters are QOFF = uint16 in the reference (Math.h:517-521).
    clump.matched_bases = wrap_u16(matches);
    clump.mismatched_bases = wrap_u16(mismatches);
    clump.gap_bases = wrap_u16(inserts + deletes);
    clump.tot_length = wrap_u16(matches + mismatches + inserts + deletes);
    clump.tot_score = wrap_u16(ags);

    double percent = (double)clump.matched_bases / (double)clump.tot_length;
    if (percent < aa.min_identity) return 0;
    clump.set(ST_SCORED, true);
    return 1;
}

// ---- OQC / FBS / dup removal (core/oqc.py; GraphPath.cpp clump half) ----

static const int64_t WORST_SCORE = -0x7FFFFF00ll;

struct CNode {
    CNode* best_prev = nullptr;
    Clump* clump = nullptr;
    int64_t best_score = 0, path_length = 1;
    int64_t sro = 0, ero = 0, sqo = 0, eqo = 0;
    int64_t node_length = 0, node_score = 0, q_len_in_oqc = 0;
    bool reversed = false, dead = false;
    int64_t seq_num = 0;
};

static void init_cnode(State& st, CNode& n, Clump* c) {
    // initcGraphNode (GraphPath.cpp:342-363); int16 wraps are
    // parity-critical (core/oqc.py:25-43).
    n.best_prev = nullptr;
    n.path_length = 1;
    n.clump = c;
    n.best_score = n.node_score = wrap_i16(c->tot_score);
    n.node_length = wrap_i16(c->tot_length);
    n.sqo = c->plus_sqo(st.q_len);
    n.eqo = c->plus_eqo(st.q_len);
    n.sro = c->sro();
    n.ero = c->ero();
    n.reversed = c->reversed();
    n.q_len_in_oqc = c->query_len();
    n.seq_num = st.genome->find_seq_num(n.sro) & 0xFF;
    n.dead = false;
}

static inline uint64_t compare_key(const CNode& n) {
    // getCompareKey (GraphPath.cpp:377-380).
    return ((((uint64_t)n.sqo << 16) + (uint64_t)((-n.eqo) & 0xFFFF))
            << 16) + (uint64_t)((-n.node_score) & 0xFFFF);
}

static bool node_less_than(const CNode* n1, const CNode* n2, Rng& rng) {
    if (yt_wide_scores) {
        // Same (SQO asc, EQO desc, score desc) order without the 16-bit
        // key packing, which wide scores/offsets would overflow.
        if (n1->sqo != n2->sqo) return n1->sqo < n2->sqo;
        if (n1->eqo != n2->eqo) return n1->eqo > n2->eqo;
        if (n1->node_score != n2->node_score)
            return n1->node_score > n2->node_score;
        return (rng.bits() & 0x1) != 0;
    }
    uint64_t k1 = compare_key(*n1);
    uint64_t k2 = compare_key(*n2);
    if (k1 == k2) return (rng.bits() & 0x1) != 0;
    return k1 < k2;
}

// myQuickSort (GraphPath.cpp:427-459), transliterated so the RNG is
// consumed in the same comparison order as the reference.
static void quick_sort(std::vector<CNode*>& nodes, Rng& rng, int64_t left,
                       int64_t right) {
    if (left >= right) return;
    int64_t pivot_index = (left + right) / 2;
    std::swap(nodes[(size_t)pivot_index], nodes[(size_t)right]);
    CNode* pivot = nodes[(size_t)right];
    int64_t store = left;
    for (int64_t i = left; i < right; i++) {
        if (node_less_than(nodes[(size_t)i], pivot, rng)) {
            std::swap(nodes[(size_t)i], nodes[(size_t)store]);
            store++;
        }
    }
    std::swap(nodes[(size_t)store], nodes[(size_t)right]);
    quick_sort(nodes, rng, left, store - 1);
    quick_sort(nodes, rng, store + 1, right);
}

// deleteSubsumedDups (GraphPath.cpp:488-517).
static std::vector<CNode*> delete_subsumed_dups(std::vector<CNode*>& nodes) {
    std::vector<CNode*> out;
    int64_t n = (int64_t)nodes.size();
    for (int64_t i = 0; i < n; i++) {
        CNode* cur = nodes[(size_t)i];
        if (cur->dead) continue;
        out.push_back(cur);
        int64_t threshold = cur->node_score / 8;  // C trunc-toward-zero
        for (int64_t j = i + 1; j < n; j++) {
            CNode* nxt = nodes[(size_t)j];
            if (nxt->dead) continue;
            if (nxt->eqo > cur->eqo) break;
            bool subsumed = (cur->eqo > nxt->eqo &&
                             nxt->node_score < threshold);
            bool dups = (cur->sro == nxt->sro && cur->ero == nxt->ero &&
                         cur->reversed == nxt->reversed &&
                         cur->sqo == nxt->sqo && cur->eqo == nxt->eqo);
            if (subsumed || dups) nxt->dead = true;
        }
    }
    return out;
}

// calcScoreForLength<forward> (GraphPath.cpp:705-732).
static int64_t calc_score_for_length(const EOL& items, int64_t length,
                                     const Params& aa, bool forward) {
    int64_t q_len = 0;
    int64_t ags = 0;
    int64_t n = (int64_t)items.size();
    for (int64_t t = 0; t < n; t++) {
        const EO& e = items[(size_t)(forward ? t : n - 1 - t)];
        if (q_len >= length) break;
        int64_t ln = e.len;
        if (e.op == 'D') {
            ags -= aa.go_cost + aa.ge_cost * ln;
        } else {
            if (q_len + ln > length) ln = length - q_len;
            q_len += ln;
            if (e.op == 'M') ags += aa.m_score * ln;
            else if (e.op == 'R') ags -= aa.r_cost * ln;
            else if (e.op == 'I') ags -= aa.go_cost + aa.ge_cost * ln;
        }
    }
    return ags;
}

// calcAccurateOverlapScore (GraphPath.cpp:744-800).
static int64_t calc_accurate_overlap_score(const CNode* left,
                                           const CNode* right,
                                           int64_t overlap,
                                           const Params& aa,
                                           bool* right_best) {
    const EOL& right_items = right->clump->eol;
    int64_t right_overlap_score = calc_score_for_length(
        right_items, overlap, aa, !right->reversed);
    int64_t path_overlap_score = 0;
    int64_t remaining = overlap;
    const CNode* cur = left;
    for (;;) {
        const EOL& cur_items = cur->clump->eol;
        int64_t cur_rev_qlen = std::min(remaining, cur->q_len_in_oqc);
        remaining -= cur_rev_qlen;
        path_overlap_score += calc_score_for_length(
            cur_items, cur_rev_qlen, aa, cur->reversed);
        if (remaining <= 0) break;
        cur = cur->best_prev;
    }
    if (path_overlap_score > right_overlap_score) {
        *right_best = false;
        return right_overlap_score;
    }
    *right_best = true;
    return path_overlap_score;
}

// cacehQlenInOQCPathReverse (GraphPath.cpp:802-826).
static void cache_qlen_reverse(CNode* left, CNode* right, int64_t overlap,
                               bool right_best) {
    if (right_best) {
        right->q_len_in_oqc = 1 + right->eqo - right->sqo;
        int64_t remaining = overlap;
        CNode* cur = left;
        for (;;) {
            int64_t cur_rev = std::min(remaining, cur->q_len_in_oqc);
            cur->q_len_in_oqc -= cur_rev;
            remaining -= cur_rev;
            if (remaining <= 0) break;
            cur = cur->best_prev;
        }
    } else {
        right->q_len_in_oqc = (1 + right->eqo - right->sqo) - overlap;
    }
}

// cacheQlenInOQCPath (GraphPath.cpp:841-867), recursive re-cache.
static CNode* cache_qlen_path(CNode* right, const Params& aa) {
    int64_t q_len = 1 + right->eqo - right->sqo;
    if (right->best_prev == nullptr) {
        right->q_len_in_oqc = q_len;
        return right;
    }
    CNode* left = cache_qlen_path(right->best_prev, aa);
    int64_t overlap = left->eqo >= right->sqo
        ? std::max<int64_t>(left->eqo - right->sqo + 1, 0) : 0;
    if (overlap > 0) {
        bool right_best;
        calc_accurate_overlap_score(left, right, overlap, aa, &right_best);
        cache_qlen_reverse(left, right, overlap, right_best);
    } else {
        right->q_len_in_oqc = q_len;
    }
    return right;
}

// cacheQlenInRightNode (GraphPath.cpp:873-878).
static void cache_qlen_right(CNode* right, int64_t overlap,
                             bool right_best) {
    int64_t q_len = 1 + right->eqo - right->sqo;
    right->q_len_in_oqc = right_best ? q_len : q_len - overlap;
}

struct PrimaryAttrs {
    int64_t aligned_query_length = 0;
    int64_t num_output_secondaries = 0;
    int64_t second_score = 0, third_score = 0;
};

// filterBySimilarity (GraphPath.cpp:571-692).
static void filter_by_similarity(State& st, std::vector<CNode*>& nodes,
                                 CNode* best_node) {
    const Params& aa = *st.aa;
    std::vector<Clump*> primaries_clumps;       // path order ascending
    int64_t prime_count = best_node->path_length;
    std::vector<CNode*> primaries((size_t)prime_count, nullptr);
    std::vector<PrimaryAttrs> pa_array((size_t)prime_count);
    int64_t idx = prime_count - 1;
    CNode* path_node = best_node;
    while (path_node != nullptr) {
        primaries[(size_t)idx] = path_node;
        pa_array[(size_t)idx].aligned_query_length =
            1 + path_node->eqo - path_node->sqo;
        Clump* clump = path_node->clump;
        clump->set(ST_PRIMARY, true);
        clump->matched_primary = idx + 1;
        primaries_clumps.insert(primaries_clumps.begin(), clump);
        CNode* prev = path_node->best_prev;
        path_node->dead = true;
        path_node = prev;
        idx--;
    }

    std::vector<Clump*> secondaries;  // iteration order; prepended later
    double target_overlap = aa.fbs_ps_length;
    for (CNode* cur : nodes) {
        if (cur->dead) continue;
        Clump* clump = cur->clump;
        int64_t cur_sqo = cur->sqo, cur_eqo = cur->eqo;
        int64_t cur_qlen = 1 + cur_eqo - cur_sqo;
        int64_t max_overlap = 0;
        int64_t max_index = 0;
        for (int64_t i = 0; i < prime_count; i++) {
            CNode* p = primaries[(size_t)i];
            int64_t overlap = 1 + std::min(cur_eqo, p->eqo)
                - std::max(cur_sqo, p->sqo);
            if (overlap > max_overlap) {
                max_overlap = overlap;
                max_index = i;
            }
        }
        if (max_overlap > 0) {
            PrimaryAttrs& pas = pa_array[(size_t)max_index];
            // memoPAsFromOverlappingNode (GraphPath.cpp:545-557).
            if (cur->node_score > pas.second_score) {
                pas.third_score = pas.second_score;
                pas.second_score = cur->node_score;
            } else if (cur->node_score > pas.third_score) {
                pas.third_score = cur->node_score;
            }
            CNode* p = primaries[(size_t)max_index];
            // C double division: inf/nan instead of raising on zero.
            double ratio = (double)cur->node_score / (double)p->node_score;
            if (ratio >= aa.fbs_ps_score) {
                int64_t overlap = 1 + std::min(cur_eqo, p->eqo)
                    - std::max(cur_sqo, p->sqo);
                int64_t path_qlen = pas.aligned_query_length;
                if ((double)overlap / (double)cur_qlen >= target_overlap &&
                    (double)overlap / (double)path_qlen >= target_overlap) {
                    pas.num_output_secondaries++;
                    if (aa.fbs) {
                        clump->matched_primary = max_index + 1;
                        secondaries.push_back(clump);
                        continue;
                    }
                }
            }
        }
        // Secondary not output; drop it.
    }

    st.clumps.clear();
    for (auto it = secondaries.rbegin(); it != secondaries.rend(); ++it)
        st.clumps.push_back(*it);
    st.clumps.insert(st.clumps.end(), primaries_clumps.begin(),
                     primaries_clumps.end());
    st.primary_count = prime_count;

    // calcMQfromPAs (GraphPath.cpp:559-569).
    for (int64_t i = 0; i < prime_count; i++) {
        Clump* clump = primaries[(size_t)i]->clump;
        PrimaryAttrs& pas = pa_array[(size_t)i];
        if (pas.second_score == 0) {
            clump->map_quality = 250;
        } else if (clump->tot_score == 0) {
            clump->map_quality = 0;
        } else {
            double ts = (double)clump->tot_score;
            double ratio = std::max(ts - (double)pas.second_score, 0.0) / ts;
            ratio = ratio * (1.0 + std::max(ts - (double)pas.third_score,
                                            0.0) / ts) / 2.0;
            clump->map_quality = (int64_t)(250.0 * ratio + 0.5) & 0xFF;
        }
        clump->num_secondaries = pas.num_output_secondaries;
    }
}

// postFilterBySimilarity (core/oqc.py:304-395; GraphPath.cpp:897-1086).
static void post_filter_by_similarity(State& st) {
    const Params& aa = *st.aa;
    int64_t node_count = (int64_t)st.clumps.size();
    if (node_count < 1) return;
    if (node_count == 1) {
        Clump* clump = st.clumps.front();
        clump->set(ST_PRIMARY, true);
        clump->map_quality = 250;
        clump->num_secondaries = 0;
        clump->matched_primary = 1;
        st.primary_count = 1;
        return;
    }

    std::deque<CNode> storage;
    std::vector<CNode*> nodes;
    nodes.reserve((size_t)node_count);
    for (Clump* c : st.clumps) {
        storage.emplace_back();
        init_cnode(st, storage.back(), c);
        nodes.push_back(&storage.back());
    }
    quick_sort(nodes, st.rng, 0, (int64_t)nodes.size() - 1);
    nodes = delete_subsumed_dups(nodes);

    int64_t best_score = WORST_SCORE;
    CNode* best_node = nullptr;
    int64_t min_non_overlap = aa.oqc_min_non_overlap;
    int64_t bp_cost = aa.bp_cost;
    int64_t mbpl = aa.max_bp_log;
    int64_t n = (int64_t)nodes.size();
    int64_t startj = 1;
    for (int64_t i = 0; i < n; i++) {
        CNode* left = nodes[(size_t)i];
        cache_qlen_path(left, aa);
        int64_t left_sqo = left->sqo;
        int64_t left_eqo = left->eqo;
        bool found_startj = false;
        for (int64_t j = startj; j < n; j++) {
            CNode* right = nodes[(size_t)j];
            int64_t right_sqo = right->sqo;
            if ((right_sqo - left_sqo) >= min_non_overlap) {
                if (!found_startj) {
                    startj = j;
                    found_startj = true;
                }
                int64_t right_eqo = right->eqo;
                if ((right_eqo - left_eqo) >= min_non_overlap) {
                    // SINT newScore (GraphPath.cpp:1004): int16 wrap.
                    int64_t new_score = wrap_i16(left->best_score +
                                                 right->node_score);
                    if (right->best_score > new_score) continue;
                    // Breakpoint penalty (GraphPath.cpp:1006-1025).
                    int64_t bpp;
                    if (left->seq_num == right->seq_num) {
                        int64_t distance;
                        if (left->sro > right->ero)
                            distance = left->sro - right->ero;
                        else if (right->sro > left->ero)
                            distance = right->sro - left->ero;
                        else
                            distance = 0;
                        if (distance <= 10) {
                            bpp = bp_cost;
                        } else {
                            double lg = log10((double)distance);
                            if (lg > (double)mbpl) lg = (double)mbpl;
                            bpp = (int64_t)(lg * (double)bp_cost + 0.5);
                        }
                    } else {
                        bpp = mbpl * bp_cost;
                    }
                    new_score = wrap_i16(new_score - bpp);
                    if (right->best_score > new_score) continue;
                    int64_t overlap = left_eqo >= right_sqo
                        ? left_eqo - right_sqo + 1 : 0;
                    bool right_best = false;
                    if (overlap > 0) {
                        int64_t ov_score = calc_accurate_overlap_score(
                            left, right, overlap, aa, &right_best);
                        new_score = wrap_i16(new_score - ov_score);
                        if (right->best_score > new_score) continue;
                    }
                    if (right->best_score < new_score ||
                        (right->best_prev != nullptr &&
                         left->path_length <
                             right->best_prev->path_length)) {
                        if (overlap > 0)
                            cache_qlen_right(right, overlap, right_best);
                        right->best_score = new_score;
                        right->best_prev = left;
                        right->path_length = left->path_length + 1;
                    }
                }
            }
        }
        if (!found_startj) startj = n;
        if (left->best_score < best_score) continue;
        if (left->best_score > best_score ||
            (best_node != nullptr &&
             left->path_length < best_node->path_length)) {
            best_node = left;
            best_score = left->best_score;
        }
    }

    filter_by_similarity(st, nodes, best_node);
}

// postFilterRemoveDups (core/oqc.py:398-428; GraphPath.cpp:1127-1174).
static void post_filter_remove_dups(State& st) {
    int64_t node_count = (int64_t)st.clumps.size();
    if (node_count < 2) return;
    struct Elem { Clump* c; int64_t sro, score; };
    std::vector<Elem> elems;
    elems.reserve((size_t)node_count);
    for (Clump* c : st.clumps)
        elems.push_back({c, c->sro(), c->tot_score});
    std::stable_sort(elems.begin(), elems.end(),
                     [](const Elem& a, const Elem& b) {
        if (a.sro != b.sro) return a.sro < b.sro;
        return a.score > b.score;
    });

    auto are_dups = [](Clump* c1, Clump* c2) {
        return c1->sro() == c2->sro() && c1->sqo() == c2->sqo() &&
               c1->eqo() == c2->eqo() && c1->ero() == c2->ero() &&
               c1->reversed() == c2->reversed();
    };

    std::vector<Clump*> kept;
    for (int64_t i = 0; i < node_count; i++) {
        Clump* c1 = elems[(size_t)i].c;
        if (c1 == nullptr) continue;
        for (int64_t j = i + 1; j < node_count; j++) {
            if (elems[(size_t)i].sro < elems[(size_t)j].sro) break;
            Clump* c2 = elems[(size_t)j].c;
            if (c2 == nullptr) continue;
            if (are_dups(c1, c2)) elems[(size_t)j].c = nullptr;
        }
        kept.push_back(c1);
    }
    st.clumps.assign(kept.rbegin(), kept.rend());
}

// ---- output (io/sam.py print_clump; AlignOutput.c:115-321) ----

static void append_fmt(std::string& out, const char* fmt, ...)
    __attribute__((format(printf, 2, 3)));
static void append_fmt(std::string& out, const char* fmt, ...) {
    char tmp[64];
    va_list ap;
    va_start(ap, fmt);
    int n = vsnprintf(tmp, sizeof tmp, fmt, ap);
    va_end(ap);
    out.append(tmp, (size_t)n);
}

// Fast unsigned/signed decimal append (the SAM writer is fprintf-bound
// otherwise; AlignOutput.c uses fprintf but the reference pays the same
// cost only once per field through glibc's fast path).
static inline void append_u64(std::string& out, uint64_t v) {
    char tmp[20];
    char* p = tmp + 20;
    do { *--p = (char)('0' + v % 10); v /= 10; } while (v);
    out.append(p, (size_t)(tmp + 20 - p));
}
static inline void append_i64(std::string& out, int64_t v) {
    if (v < 0) { out.push_back('-'); append_u64(out, (uint64_t)(-v)); }
    else append_u64(out, (uint64_t)v);
}

// Python-slice append of chars buf[qstart:qend+1] (optionally reversed).
static void append_chars(std::string& out, const uint8_t* buf, int64_t len,
                         int64_t qstart, int64_t qstop, bool rev) {
    int64_t start = qstart, stop = qstop;
    if (start < 0) { start += len; if (start < 0) start = 0; }
    if (stop < 0) { stop += len; if (stop < 0) stop = 0; }
    if (start > len) start = len;
    if (stop > len) stop = len;
    if (stop <= start) return;
    if (rev)
        for (int64_t i = stop - 1; i >= start; i--)
            out.push_back((char)buf[i]);
    else
        out.append((const char*)buf + start, (size_t)(stop - start));
}

static void print_clump(State& st, Clump& clump, std::string& out) {
    const Params& aa = *st.aa;
    const GenomeView& g = *st.genome;
    Frag& frag0 = clump.first_frag();
    Frag& fragn = clump.last_frag();
    int64_t seq_start = frag0.sro;
    int64_t seq_end = fragn.ero();
    int64_t bs_num = g.find_seq_num(seq_start);
    if (bs_num < 0 ||
        seq_end >= g.starts[bs_num] + g.lens[bs_num])
        return;   // spans base sequences: dropped
    int64_t bs_start = g.starts[bs_num];
    seq_start -= bs_start;
    seq_end -= bs_start;
    const std::string& name = g.names[(size_t)bs_num];
    const uint8_t* query_buf = st.qchars(clump);

    if (aa.output_sam) {
        out.append(st.query_id);
        out.append(clump.reversed() ? "\t16\t" : "\t0\t", 4 - !clump.reversed());
        out.append(name);
        out.push_back('\t');
        append_u64(out, (uint64_t)(seq_start + 1));
        out.push_back('\t');
        append_u64(out, (uint64_t)clump.map_quality);
        out.push_back('\t');
        EOL& lst = clump.eol;
        // Clips appended at print time (AlignOutput.c:165-171).
        int64_t clip = st.q_len - 1 - frag0.eqo;
        if (clip > 0)
            lst.push_back({aa.hard_clip ? 'H' : 'S', (int32_t)clip});
        clip = frag0.sqo;
        if (clip > 0)
            lst.insert(lst.begin(),
                       {aa.hard_clip ? 'H' : 'S', (int32_t)clip});

        // CIGAR: M/R merged.
        int64_t matches = 0;
        for (const EO& e : lst) {
            if (e.op == 'M' || e.op == 'R') {
                matches += e.len;
                continue;
            }
            if (matches > 0) {
                append_i64(out, matches);
                out.push_back('M');
                matches = 0;
            }
            append_i64(out, e.len);
            out.push_back(e.op);
        }
        if (matches > 0) { append_i64(out, matches); out.push_back('M'); }

        out.append("\t*\t0\t0\t");
        int64_t qstart = 0;
        int64_t qend = st.q_len - 1;
        if (aa.hard_clip) {
            qstart = frag0.sqo;
            qend = fragn.eqo;
        }
        append_chars(out, query_buf, st.q_len, qstart, qend + 1, false);
        out.push_back('\t');
        if (aa.fastq) {
            append_chars(out, st.qual, st.q_len, qstart, qend + 1,
                         clump.reversed());
        } else {
            out.push_back('*');
        }
        out.push_back('\t');
        out.append("AS:i:");
        append_i64(out, clump.tot_score);
        out.append("\tNM:i:");
        append_i64(out, clump.gap_bases + clump.mismatched_bases);
        out.push_back('\t');
        out.append("MD:Z:");
        matches = 0;
        char previous = 'U';
        int64_t cur_ref = frag0.sro;
        const uint8_t* gcodes = g.codes;
        for (const EO& e : lst) {
            if (e.op == 'M') {
                matches += e.len;
                cur_ref += e.len;
            } else if (e.op == 'R') {
                if (matches > 0) {
                    append_i64(out, matches);
                    matches = 0;
                }
                if (previous == 'D') out.push_back('0');
                for (int64_t t = 0; t < e.len; t++)
                    out.push_back(kChars[gcodes[cur_ref + t]]);
                cur_ref += e.len;
            } else if (e.op == 'D') {
                if (matches > 0) {
                    append_i64(out, matches);
                    matches = 0;
                }
                out.push_back('^');
                for (int64_t t = 0; t < e.len; t++)
                    out.push_back(kChars[gcodes[cur_ref + t]]);
                cur_ref += e.len;
            }
            previous = e.op;
        }
        if (matches > 0) append_i64(out, matches);
        append_fmt(out, "\tYF:H:%02X", (unsigned)clump.status);
        if (aa.oqc) {
            out.append("\tYI:i:");
            append_i64(out, clump.matched_primary);
            out.append("\tYP:i:");
            append_i64(out, st.primary_count);
            if (clump.get(ST_PRIMARY)) {
                out.append("\tYS:i:");
                append_i64(out, clump.num_secondaries);
            }
        }
        out.push_back('\n');
    }

    if (aa.output_blast8) {
        double percent = 0.8;
        out.append(st.query_id);
        out.push_back('\t');
        out.append(name);
        append_fmt(out, "\t%4.2f\t%lld\t%lld\t%lld", percent * 100,
                   (long long)clump.tot_length,
                   (long long)clump.mismatched_bases,
                   (long long)clump.gap_bases);
        if (clump.reversed()) {
            append_fmt(out, "\t%lld\t%lld\t%lld\t%lld\t%c",
                       (long long)(st.q_len - fragn.eqo),
                       (long long)(st.q_len - frag0.sqo),
                       (long long)(seq_end + 1),
                       (long long)(seq_start + 1), '-');
        } else {
            append_fmt(out, "\t%lld\t%lld\t%lld\t%lld\t%c",
                       (long long)(frag0.sqo + 1),
                       (long long)(fragn.eqo + 1),
                       (long long)(seq_start + 1),
                       (long long)(seq_end + 1), '+');
        }
        append_fmt(out, "\t%lld\t%lld\t%4.2f\n",
                   (long long)clump.tot_score, (long long)st.q_len,
                   ((double)clump.matched_bases / (double)st.q_len) * 100);
    }
}

// ---- per-read driver (core/pipeline.py align_query) ----

// One strand: fused native seed->fragment->clump front end, then clump
// materialization in emission order with addClump prepending.
static int64_t process_strand(State& st, bool rev) {
    const Params& aa = *st.aa;
    const uint8_t* codes = rev ? st.rev_codes.data() : st.fwd_codes.data();
    // Seed-to-clump scratch is per THREAD, not per State: the staged
    // batch pipeline holds one State per read, and per-read copies of
    // these ~1.5 MB buffers turned yt_batch_begin into 30 GB of memset
    // at 20k-read chunks (round-3 profile: 311 s -> the fix below).
    static thread_local std::vector<int64_t> sc_sqo, sc_eqo, sc_sro,
        sc_offs, sc_matched;
    static thread_local int64_t cap_frags = 65536, cap_clumps = 8192;
    for (;;) {
        if ((int64_t)sc_sqo.size() < cap_frags) {
            sc_sqo.resize((size_t)cap_frags);
            sc_eqo.resize((size_t)cap_frags);
            sc_sro.resize((size_t)cap_frags);
        }
        if ((int64_t)sc_offs.size() < cap_clumps + 1) {
            sc_offs.resize((size_t)cap_clumps + 1);
            sc_matched.resize((size_t)cap_clumps);
        }
        int64_t total_hits = 0;
        double ts = g_prof ? now_s() : 0;
        int64_t n_clumps = yt_seed_to_clumps(
            codes, st.q_len, aa.word_len, st.so, st.roa, st.roa_len,
            aa.max_hits, aa.max_gap, aa.max_desert, aa.min_match,
            aa.min_non_overlap, aa.m_score, aa.go_cost, aa.ge_cost,
            aa.band_width,
            sc_sqo.data(), sc_eqo.data(), sc_sro.data(),
            sc_offs.data(), sc_matched.data(),
            cap_frags, cap_clumps, &total_hits);
        if (g_prof) { g_prof->s2c += now_s() - ts;
                      g_prof->clumps += n_clumps > 0 ? n_clumps : 0; }
        if (n_clumps < 0) {
            cap_frags *= 4;
            cap_clumps *= 4;
            continue;
        }
        for (int64_t k = 0; k < n_clumps; k++) {
            Clump* clump = st.new_clump();
            for (int64_t i = sc_offs[(size_t)k];
                 i < sc_offs[(size_t)(k + 1)]; i++) {
                clump->sfrags.emplace_back();
                Frag& f = clump->sfrags.back().frag;
                f.sqo = sc_sqo[(size_t)i];
                f.eqo = sc_eqo[(size_t)i];
                f.sro = sc_sro[(size_t)i];
                f.ref_len = f.eqo - f.sqo + 1;
            }
            clump->matched_bases = sc_matched[(size_t)k];
            st.add_clump(clump, rev);
        }
        return total_hits;
    }
}

// Device-fed twin of process_strand: the seed scan + sort already ran on
// the accelerator (the composed staged x sharded-index path); hits arrive
// sorted by (diag, qo) and only coalesce + fragment->clump run here.
// `total_hits` is the device-counted seed-match total (pre-phantom, the
// same quantity the host scan reports).
static int64_t process_strand_hits(State& st, bool rev,
                                   const uint32_t* hits_diag,
                                   const int32_t* hits_qo, int64_t n_hits,
                                   int64_t total_hits) {
    const Params& aa = *st.aa;
    static thread_local std::vector<int64_t> sc_sqo, sc_eqo, sc_sro,
        sc_offs, sc_matched;
    static thread_local int64_t cap_frags = 65536, cap_clumps = 8192;
    for (;;) {
        if ((int64_t)sc_sqo.size() < cap_frags) {
            sc_sqo.resize((size_t)cap_frags);
            sc_eqo.resize((size_t)cap_frags);
            sc_sro.resize((size_t)cap_frags);
        }
        if ((int64_t)sc_offs.size() < cap_clumps + 1) {
            sc_offs.resize((size_t)cap_clumps + 1);
            sc_matched.resize((size_t)cap_clumps);
        }
        double ts = g_prof ? now_s() : 0;
        int64_t n_clumps = yt_hits_to_clumps(
            hits_diag, hits_qo, n_hits, st.q_len, aa.word_len,
            aa.max_gap, aa.max_desert, aa.min_match,
            aa.min_non_overlap, aa.m_score, aa.go_cost, aa.ge_cost,
            aa.band_width,
            sc_sqo.data(), sc_eqo.data(), sc_sro.data(),
            sc_offs.data(), sc_matched.data(),
            cap_frags, cap_clumps);
        if (g_prof) { g_prof->hits_f2c += now_s() - ts;
                      g_prof->hits += n_hits;
                      g_prof->clumps += n_clumps > 0 ? n_clumps : 0; }
        if (n_clumps < 0) {
            cap_frags *= 4;
            cap_clumps *= 4;
            continue;
        }
        for (int64_t k = 0; k < n_clumps; k++) {
            Clump* clump = st.new_clump();
            for (int64_t i = sc_offs[(size_t)k];
                 i < sc_offs[(size_t)(k + 1)]; i++) {
                clump->sfrags.emplace_back();
                Frag& f = clump->sfrags.back().frag;
                f.sqo = sc_sqo[(size_t)i];
                f.eqo = sc_eqo[(size_t)i];
                f.sro = sc_sro[(size_t)i];
                f.ref_len = f.eqo - f.sqo + 1;
            }
            clump->matched_bases = sc_matched[(size_t)k];
            st.add_clump(clump, rev);
        }
        return total_hits;
    }
}

// A strand whose clumps the card made (the seeder's clump kernel,
// csrc/clump_kernels.cu): its record -- clumps, fragments, skipped
// regions, then per clump its fragment count, matched bases and (sqo,
// eqo, sro) a fragment -- enters by process_strand_hits' tail, as
// yt_hits_to_clumps would have returned it.  `total_hits` is the
// device-counted seed-match total.
static int64_t add_device_clumps(State& st, bool rev, const int32_t* rec,
                                 int64_t total_hits) {
    const int64_t n_clumps = rec[0];
    yt_skipped_regions += rec[2];
    if (g_prof) g_prof->clumps += n_clumps;
    int64_t pos = 3;
    for (int64_t k = 0; k < n_clumps; k++) {
        const int64_t n = rec[pos];
        Clump* clump = st.new_clump();
        for (int64_t i = 0; i < n; i++) {
            const int32_t* f3 = rec + pos + 2 + 3 * i;
            clump->sfrags.emplace_back();
            Frag& f = clump->sfrags.back().frag;
            f.sqo = f3[0];
            f.eqo = f3[1];
            f.sro = (int64_t)(uint32_t)f3[2];
            f.ref_len = f.eqo - f.sqo + 1;
        }
        clump->matched_bases = rec[pos + 1];
        st.add_clump(clump, rev);
        pos += 2 + 3 * n;
    }
    return total_hits;
}

// Returns (seed_matches, alignments_printed) for the QUERYSTATS analog
// (Query.c:480-491; core/pipeline.align_query stats fields).
static std::pair<int64_t, int64_t> align_read(State& st, std::string& out,
                                              Prof* prof,
                                              RunStats* rs = nullptr) {
    // Per-query RNG seed from the read content (QueryState.c:171-187).
    uint32_t seed[5];
    query_seed(st.fwd_codes.data(), st.q_len, seed);
    memcpy(st.rng.s, seed, sizeof seed);
    st.arena_used = 0;
    st.clumps.clear();
    st.primary_count = 0;
    double t0 = prof ? now_s() : 0;

    yt_skipped_regions = 0;
    int64_t fwd_count = process_strand(st, false);
    int64_t rev_count = process_strand(st, true);
    if (yt_skipped_regions > 0)
        fprintf(stderr, "Warning: skipped %lld fragment region(s) with "
                "more than %lld fragments in query %s.\n",
                (long long)yt_skipped_regions,
                (long long)yt_max_region_frags, st.query_id.c_str());
    int64_t seed_matches = fwd_count + rev_count;
    double t1 = prof ? now_s() : 0;

    // postProcessClumps (QueryMatch.c:306-331).
    std::vector<Clump*> old;
    old.swap(st.clumps);
    for (Clump* clump : old) {
        align_clump(st, *clump);
        double tsc = prof ? now_s() : 0;
        score_clump(st, *clump);
        if (prof) prof->sc += now_s() - tsc;
        if (clump->scored())
            st.clumps.insert(st.clumps.begin(), clump);
    }
    double t2 = prof ? now_s() : 0;

    if (st.aa->oqc) post_filter_by_similarity(st);
    else post_filter_remove_dups(st);
    double t3 = prof ? now_s() : 0;

    for (Clump* clump : st.clumps)
        print_clump(st, *clump, out);
    int64_t n_aligns = (int64_t)st.clumps.size();

    if (prof) {
        double t4 = now_s();
        prof->front += t1 - t0;
        prof->align += t2 - t1;
        prof->oqc += t3 - t2;
        prof->print += t4 - t3;
        prof->reads++;
    }
    if (rs) {
        // Query.c:416-418 (per-strand total counts; min over non-zero
        // strands) and 470-477 (per-query lengths / clumps out).
        for (int64_t c : {fwd_count, rev_count}) {
            rs->cnt_tot += c;
            if (c > 0 && c < rs->cnt_min) rs->cnt_min = c;
            if (c > rs->cnt_max) rs->cnt_max = c;
        }
        rs->queries++;
        rs->qlen_tot += st.q_len;
        if (st.q_len < rs->qlen_min) rs->qlen_min = st.q_len;
        if (st.q_len > rs->qlen_max) rs->qlen_max = st.q_len;
        rs->clumps_tot += n_aligns;
        if (n_aligns > rs->clumps_max) rs->clumps_max = n_aligns;
        if (n_aligns > 0 && n_aligns < rs->clumps_min)
            rs->clumps_min = n_aligns;
        if (n_aligns == 0) rs->nonaligned++;
    }
    return {seed_matches, n_aligns};
}

// ---- staged batch pipeline (device-DP offload) ----
//
// The per-read loop above (align_read) factored into batch-callable
// stages whose boundaries are exactly the two DP phases, so the host
// phases stay native C++ while the DP batches run on the TPU:
//
//   yt_batch_begin    reads -> seed/chain/clumps -> align stage 1
//                     (perfect extensions, per-frag Match ops, gap
//                     classification) with gap-fill DP problems deferred
//   yt_batch_gap_*    export gap problems / apply device DP results
//   yt_batch_phase2   collapse + clump-extension perfect stages, with
//                     extension DP problems deferred
//   yt_batch_ext_*    export extension problems / apply results
//   yt_batch_finish   score/split (rare careful re-extensions run on the
//                     native DP) -> OQC/FBS -> SAM text
//
// The stage split follows the phased batch decomposition (byte-
// parity-validated since round 2): all problems within a phase are
// independent in the reference (QueryMatch.c:306-331 processes clumps
// whose gap fills and extensions read only state fixed before any DP
// runs), so batching across reads preserves byte parity.

struct StagedProb {
    Clump* clump;
    int32_t read;        // slot index
    int32_t sfrag_idx;   // gap: index into clump->sfrags; ext: -1
    uint8_t reverse;     // ext only
    uint8_t strand;      // clump strand: 0 = fwd codes, 1 = rev codes
    int32_t qlen, rlen, lbw, rbw;
    int64_t q_off, r_off;    // offsets into the read slot's slice arena
    // Source coordinates for device-resident problem assembly (the
    // *_meta2 exports): the q slice is strand-codes[q_src : q_src +
    // q_copy] (zero-filled to qlen; whole buffer reversed when
    // `reverse`), the r slice is genome-codes[r_src : r_src + r_copy]
    // likewise — the exact py_slice clamping baked in host-side.
    int64_t q_src = 0, r_src = 0;
    int32_t q_copy = 0, r_copy = 0;
};

struct ReadSlot {
    State st;
    std::string out;
    std::vector<StagedProb> gaps, exts;
    std::vector<uint8_t> arena;      // materialized q/r problem slices
    int64_t seed_matches = 0;
    int64_t fwd_count = 0, rev_count = 0;   // per-strand STATS counts
    // Per-read host-pipeline microseconds for -qs (Query.c:480-491):
    // phase1/2/3 run one read per worker call (single writer), DP
    // apply/inline time is attributed per problem after each
    // staged_run (see the dts accounting in the apply functions).
    int64_t usec = 0;
};

struct BatchCtx {
    Params aa;
    GenomeView genome;
    const uint32_t* so = nullptr;
    const uint32_t* roa = nullptr;
    int64_t roa_len = 0;
    const uint8_t* seqs = nullptr;
    const int64_t* seq_offs = nullptr;
    const uint8_t* ids = nullptr;
    const int64_t* id_offs = nullptr;
    const uint8_t* quals = nullptr;
    int64_t n_reads = 0, n_threads = 1;
    bool inline_small = true;
    // Optional device-fed seed hits (the composed staged x sharded-index
    // path): per (read, strand) row 2*i+s, hits sorted by (diag, qo) in
    // hits_diag/hits_qo[hit_offs[row] : hit_offs[row+1]], with
    // hit_totals[row] the device seed-match count; a row total of -1
    // routes that strand through the host scan (top-tier overflow
    // fallback).  NULL = host seed scan for everything.
    const uint32_t* hits_diag = nullptr;
    const int32_t* hits_qo = nullptr;
    const int64_t* hit_offs = nullptr;
    const int64_t* hit_totals = nullptr;
    // Optional clumps made on the card for device-seeded rows: row r's
    // record starts at dev_clumps[dev_offs[r]] (add_device_clumps), or
    // dev_offs[r] = -1 where the row carries hits instead (its hit range
    // then holds them).  NULL = every device-seeded row carries hits.
    const int32_t* dev_clumps = nullptr;
    const int64_t* dev_offs = nullptr;
    std::vector<ReadSlot> slots;
    std::vector<StagedProb*> gap_ptr, ext_ptr;   // global problem order
    int64_t rec_sum = 0;
    // Phase 1's stage accumulators, one slot a worker (yt_batch_begin's
    // profiling flag; empty without it).
    std::vector<Prof> profs;
};

// Runs fn(i) for i in [0, count) on the batch's threads; with `prof`
// (phase 1) and the batch's slots allocated, worker t binds g_prof to
// slot t for the run.
template <class F>
static void staged_run(BatchCtx& c, int64_t count, F fn, bool prof = false) {
    std::atomic<int64_t> next{0};
    const bool bind = prof && !c.profs.empty();
    auto worker = [&](int64_t t) {
        yt_wide_scores = c.aa.max_query_length > 32000 ? 1 : 0;
        yt_max_region_frags = c.aa.max_region_frags;
        if (bind) g_prof = &c.profs[(size_t)t];
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= count) break;
            fn(i);
        }
        if (bind) g_prof = nullptr;
    };
    int64_t nt = c.n_threads;
    if (nt > count) nt = count;
    if (nt <= 1) { worker(0); return; }
    std::vector<std::thread> ts;
    for (int64_t t = 1; t < nt; t++) ts.emplace_back(worker, t);
    worker(0);
    for (auto& th : ts) th.join();
}

// py_slice into an append-only arena; returns the base offset.
static int64_t arena_append(std::vector<uint8_t>& a, const uint8_t* src,
                            int64_t slen, int64_t start, int64_t count) {
    int64_t base = (int64_t)a.size();
    a.resize(a.size() + (size_t)std::max<int64_t>(count, 0), 0);
    if (count > 0) {
        int64_t stop = start + count;
        if (start < 0) { start += slen; if (start < 0) start = 0; }
        if (stop < 0) { stop += slen; if (stop < 0) stop = 0; }
        if (start > slen) start = slen;
        if (stop > slen) stop = slen;
        uint8_t* dst = a.data() + base;
        for (int64_t i = start, k = 0; i < stop; i++, k++) dst[k] = src[i];
    }
    return base;
}

// makeAndAlignSFragmentToFillGap with the DP arm deferred (or, for
// small problems, run inline on anchored_dp_small — every DP backend is
// bit-identical, so the inline/defer split cannot change output).
static bool stage1_make_gap(State& st, SFrag& sf1, SFrag& sf2,
                            const uint8_t* q_codes, SFrag& new_sf,
                            ReadSlot& slot, Clump& clump,
                            int32_t sfrag_idx, bool inline_small,
                            int32_t read) {
    const Params& aa = *st.aa;
    Frag& frag1 = sf1.frag;
    Frag& frag2 = sf2.frag;
    int64_t q_gap = calc_gap(frag1.eqo, frag2.sqo);
    int64_t r_gap = calc_gap(frag1.ero(), frag2.sro);
    if (q_gap == 0 && r_gap == 0) return false;
    Frag& nf = new_sf.frag;
    nf.sqo = frag1.eqo + 1;
    nf.eqo = frag2.sqo - 1;
    nf.sro = (frag1.ero() + 1) & M32;
    nf.set_ero(frag2.sro - 1);
    EOL& lst = new_sf.eol;
    if (q_gap == 0) {
        lst.push_back({'D', (int32_t)r_gap});
        new_sf.score = calc_gap_cost(r_gap, aa);
    } else if (r_gap == 0) {
        lst.push_back({'I', (int32_t)q_gap});
        new_sf.score = calc_gap_cost(q_gap, aa);
    } else if (r_gap == 1 && q_gap == 1) {
        lst.push_back({'R', 1});
        new_sf.score = -aa.r_cost;
    } else {
        // find_ags_alignment's band selection (SW.cpp:849-871).
        int64_t len_diff = std::abs(q_gap - r_gap);
        bool banded = len_diff + aa.band_width * 2 + 1 < r_gap;
        int64_t lbw, rbw;
        if (banded) {
            if (r_gap > q_gap) {
                lbw = aa.band_width;
                rbw = aa.band_width + (r_gap - q_gap);
            } else {
                lbw = aa.band_width + (q_gap - r_gap);
                rbw = aa.band_width;
            }
        } else {
            lbw = rbw = std::max(q_gap, r_gap) + 1;
        }
        const GenomeView& g = *st.genome;
        if (inline_small && q_gap <= 24 && r_gap <= 24) {
            const uint8_t* q;
            const uint8_t* r;
            if (nf.sqo >= 0 && nf.sqo + q_gap <= st.q_len) {
                q = q_codes + nf.sqo;
            } else {
                py_slice(st.buf_q, q_codes, st.q_len, nf.sqo, q_gap);
                q = st.buf_q.data();
            }
            if (nf.sro >= 0 && nf.sro + r_gap <= g.codes_len) {
                r = g.codes + nf.sro;
            } else {
                py_slice(st.buf_r, g.codes, g.codes_len, nf.sro, r_gap);
                r = st.buf_r.data();
            }
            new_sf.score = anchored_dp_small(aa, q, q_gap, r, r_gap, lbw,
                                             rbw, lst);
        } else {
            StagedProb p;
            p.clump = &clump;
            p.read = read;
            p.sfrag_idx = sfrag_idx;
            p.reverse = 0;
            p.strand = clump.get(ST_REVERSED) ? 1 : 0;
            p.qlen = (int32_t)q_gap;
            p.rlen = (int32_t)r_gap;
            p.lbw = (int32_t)lbw;
            p.rbw = (int32_t)rbw;
            py_range(st.q_len, nf.sqo, q_gap, &p.q_src, &p.q_copy);
            py_range(g.codes_len, nf.sro, r_gap, &p.r_src, &p.r_copy);
            p.q_off = arena_append(slot.arena, q_codes, st.q_len, nf.sqo,
                                   q_gap);
            p.r_off = arena_append(slot.arena, g.codes, g.codes_len,
                                   nf.sro, r_gap);
            slot.gaps.push_back(p);
        }
    }
    return true;
}

// alignClump stage 1: everything before the gap-fill DP results are
// needed (AlignHelpers.c:205-262 minus collapse/extend).
static void align_clump_stage1(State& st, Clump& clump, ReadSlot& slot,
                               bool inline_small, int32_t read) {
    if (clump.aligned()) return;
    const Params& aa = *st.aa;
    const GenomeView& g = *st.genome;
    const uint8_t* q_codes = st.qcodes(clump);
    std::vector<SFrag>& sfrags = clump.sfrags;

    for (size_t k = 0; k + 1 < sfrags.size(); k++) {
        Frag& frag1 = sfrags[k].frag;
        Frag& frag2 = sfrags[k + 1].frag;
        int64_t gap = std::min(calc_gap(frag1.eqo, frag2.sqo),
                               calc_gap(frag1.ero(), frag2.sro));
        gap -= ext_back_perfect(frag2, g.codes, g.codes_len, q_codes,
                                st.q_len, gap);
        gap -= ext_fwd_perfect(frag1, g.codes, g.codes_len, q_codes,
                               st.q_len, gap);
    }
    for (SFrag& sf : sfrags) {
        int64_t q_len = sf.frag.qlen();
        sf.eol.insert(sf.eol.begin(), {'M', (int32_t)q_len});
        sf.score = aa.m_score * q_len;
    }
    if (sfrags.size() > 1) {
        std::vector<SFrag> merged;
        merged.reserve(sfrags.size() * 2 - 1);
        merged.push_back(std::move(sfrags[0]));
        for (size_t i = 0; i + 1 < sfrags.size(); i++) {
            SFrag new_sf;
            if (stage1_make_gap(st, merged.back(), sfrags[i + 1], q_codes,
                                new_sf, slot, clump,
                                (int32_t)merged.size(), inline_small,
                                read))
                merged.push_back(std::move(new_sf));
            merged.push_back(std::move(sfrags[i + 1]));
        }
        sfrags.swap(merged);
    }
}

static void staged_phase1(BatchCtx& c, int64_t i) {
    ReadSlot& slot = c.slots[(size_t)i];
    State& st = slot.st;
    st.aa = &c.aa;
    st.genome = &c.genome;
    st.so = c.so;
    st.roa = c.roa;
    st.roa_len = c.roa_len;
    int64_t s0 = c.seq_offs[i], s1 = c.seq_offs[i + 1];
    int64_t qlen = s1 - s0;
    st.q_len = qlen;
    st.fwd_chars = c.seqs + s0;
    st.qual = c.quals != nullptr ? c.quals + s0 : nullptr;
    st.query_id.assign((const char*)c.ids + c.id_offs[i],
                       (size_t)(c.id_offs[i + 1] - c.id_offs[i]));
    st.fwd_codes.resize((size_t)qlen);
    st.rev_codes.resize((size_t)qlen);
    st.rev_chars.resize((size_t)qlen);
    for (int64_t k = 0; k < qlen; k++)
        st.fwd_codes[(size_t)k] = kCodes[st.fwd_chars[k]];
    for (int64_t k = 0; k < qlen; k++) {
        uint8_t rc = kComp[st.fwd_codes[(size_t)(qlen - 1 - k)] & 0xF];
        st.rev_codes[(size_t)k] = rc;
        st.rev_chars[(size_t)k] = (uint8_t)kChars[rc];
    }
    uint32_t seed[5];
    query_seed(st.fwd_codes.data(), qlen, seed);
    memcpy(st.rng.s, seed, sizeof seed);
    st.arena_used = 0;
    st.clumps.clear();
    st.primary_count = 0;
    yt_skipped_regions = 0;
    int64_t counts[2];
    for (int s = 0; s < 2; s++) {
        int64_t row = 2 * i + s;
        if (c.dev_offs != nullptr && c.hit_totals[row] >= 0 &&
            c.dev_offs[row] >= 0) {
            counts[s] = add_device_clumps(st, s != 0,
                                          c.dev_clumps + c.dev_offs[row],
                                          c.hit_totals[row]);
        } else if (c.hit_offs != nullptr && c.hit_totals[row] >= 0) {
            counts[s] = process_strand_hits(
                st, s != 0, c.hits_diag + c.hit_offs[row],
                c.hits_qo + c.hit_offs[row],
                c.hit_offs[row + 1] - c.hit_offs[row],
                c.hit_totals[row]);
        } else {
            counts[s] = process_strand(st, s != 0);
        }
    }
    int64_t fwd = counts[0];
    int64_t rev = counts[1];
    if (yt_skipped_regions > 0)
        fprintf(stderr, "Warning: skipped %lld fragment region(s) with "
                "more than %lld fragments in query %s.\n",
                (long long)yt_skipped_regions,
                (long long)yt_max_region_frags, st.query_id.c_str());
    slot.seed_matches = fwd + rev;
    slot.fwd_count = fwd;
    slot.rev_count = rev;
    double ts = g_prof ? now_s() : 0;
    for (Clump* cl : st.clumps)
        align_clump_stage1(st, *cl, slot, c.inline_small, (int32_t)i);
    if (g_prof) g_prof->stage1 += now_s() - ts;
}

// extendClumpForwardReverse's DP deferral: the trimming half of
// find_ags_extension (SW.cpp:496-507) with the slices materialized.
static void stage2_defer_ext(State& st, ReadSlot& slot, Clump& clump,
                             int64_t r_off, const uint8_t* q_codes,
                             int64_t q_off, int64_t q_len, bool reverse,
                             int32_t read) {
    const Params& aa = *st.aa;
    const GenomeView& g = *st.genome;
    if (q_len <= 0) return;
    const int64_t bandwidth = 2 * aa.band_width;
    int64_t r_len = q_len + bandwidth;
    if (reverse) {
        if (r_len > r_off) {
            r_len = r_off + 1;
            q_len = r_len - bandwidth;
            if (q_len <= 0) return;
        }
    } else {
        if (r_off + r_len > g.max_roff) {
            r_len = g.max_roff - r_off;
            q_len = r_len - bandwidth;
            if (q_len <= 0) return;
        }
    }
    StagedProb p;
    p.clump = &clump;
    p.read = read;
    p.sfrag_idx = -1;
    p.reverse = reverse ? 1 : 0;
    p.strand = clump.get(ST_REVERSED) ? 1 : 0;
    p.qlen = (int32_t)q_len;
    p.rlen = (int32_t)r_len;
    p.lbw = p.rbw = 0;
    py_range(st.q_len, reverse ? q_off - q_len + 1 : q_off, q_len,
             &p.q_src, &p.q_copy);
    py_range(g.codes_len, reverse ? r_off - r_len + 1 : r_off, r_len,
             &p.r_src, &p.r_copy);
    size_t base;
    if (reverse) {
        p.q_off = arena_append(slot.arena, q_codes, st.q_len,
                               q_off - q_len + 1, q_len);
        base = (size_t)p.q_off;
        std::reverse(slot.arena.begin() + base, slot.arena.end());
        p.r_off = arena_append(slot.arena, g.codes, g.codes_len,
                               r_off - r_len + 1, r_len);
        base = (size_t)p.r_off;
        std::reverse(slot.arena.begin() + base, slot.arena.end());
    } else {
        p.q_off = arena_append(slot.arena, q_codes, st.q_len, q_off,
                               q_len);
        p.r_off = arena_append(slot.arena, g.codes, g.codes_len, r_off,
                               r_len);
    }
    slot.exts.push_back(p);
}

// Stage 2 for one clump: collapse + the perfect halves of
// extendClumpForwardReverse, extension DPs deferred (or inlined when
// small — ext_dp_small's domain, bit-identical to every backend).
static void stage2_clump(State& st, Clump& clump, ReadSlot& slot,
                         bool inline_small, int32_t read) {
    const Params& aa = *st.aa;
    collapse_sfragments(clump);
    SFrag& sf = clump.sfrags.front();
    Frag& frag = sf.frag;
    EOL& lst = clump.eol;
    const GenomeView& g = *st.genome;
    const uint8_t* q_codes = st.qcodes(clump);
    int64_t score = sf.score;

    int64_t back_len = std::min(frag.sqo, frag.sro);
    if (back_len > 0) {
        int64_t nm = ext_back_perfect(frag, g.codes, g.codes_len, q_codes,
                                      st.q_len, back_len);
        if (nm > 0) {
            lst.front().len += nm;
            score += nm * aa.m_score;
            back_len -= nm;
        }
    }
    int64_t qlen = (st.q_len - 1) - frag.eqo;
    int64_t rlen = g.max_roff - frag.ero();
    int64_t forw_len = std::min(qlen, rlen);
    if (forw_len > 0) {
        int64_t nm = ext_fwd_perfect(frag, g.codes, g.codes_len, q_codes,
                                     st.q_len, forw_len);
        if (nm > 0) {
            lst.back().len += nm;
            score += nm * aa.m_score;
            forw_len -= nm;
        }
    }
    bool small = inline_small && aa.band_width <= 8;
    if (back_len >= aa.min_ext_length) {
        if (small && back_len <= 24) {
            int64_t aq, ar;
            int64_t ns = find_ags_extension(st, frag.sro - 1, q_codes,
                                            frag.sqo - 1, back_len, lst,
                                            true, &aq, &ar);
            if (ns > 0) {
                score += ns;
                frag.add_q_front(aq);
                frag.add_r_front(ar);
            }
        } else {
            stage2_defer_ext(st, slot, clump, frag.sro - 1, q_codes,
                             frag.sqo - 1, back_len, true, read);
        }
    }
    if (forw_len >= aa.min_ext_length) {
        if (small && forw_len <= 24) {
            int64_t aq, ar;
            int64_t ns = find_ags_extension(st, frag.ero() + 1, q_codes,
                                            frag.eqo + 1, forw_len, lst,
                                            false, &aq, &ar);
            if (ns > 0) {
                score += ns;
                frag.add_q_back(aq);
                frag.add_r_back(ar);
            }
        } else {
            stage2_defer_ext(st, slot, clump, frag.ero() + 1, q_codes,
                             frag.eqo + 1, forw_len, false, read);
        }
    }
    sf.score = score;
    clump.set(ST_ALIGNED, true);
}

static void staged_phase2(BatchCtx& c, int64_t i) {
    ReadSlot& slot = c.slots[(size_t)i];
    State& st = slot.st;
    for (Clump* cl : st.clumps)
        stage2_clump(st, *cl, slot, c.inline_small, (int32_t)i);
}

// Stage 3 = the back half of align_read: score/split -> OQC/FBS ->
// output text (QueryMatch.c:306-344, GraphPath.cpp:897-1086,
// AlignOutput.c:115-321).
static void staged_phase3(BatchCtx& c, int64_t i) {
    ReadSlot& slot = c.slots[(size_t)i];
    State& st = slot.st;
    std::vector<Clump*> old;
    old.swap(st.clumps);
    for (Clump* clump : old) {
        score_clump(st, *clump);
        if (clump->scored())
            st.clumps.insert(st.clumps.begin(), clump);
    }
    if (st.aa->oqc) post_filter_by_similarity(st);
    else post_filter_remove_dups(st);
    for (Clump* clump : st.clumps)
        print_clump(st, *clump, slot.out);
}

// ---- staged-result decode walkers (EOL-producing twins of the
// yt_traceback_* batch walkers / ops/dp_common.py) ----

enum { FMT_NATIVE = 0, FMT_EOIDC = 1, FMT_PACKED = 2, FMT_PACKED_BAND = 3,
       FMT_RLE = 4 };
static const int BT_OP = 7, BT_CD = 8, BT_CF = 16;

// FMT_RLE: the walk already ran on the device (ops/decode_jax.py); each
// problem ships n_ops int32 items packed (op << 28 | len) in walk order
// — the same run sequence the packed-plane walkers below produce before
// their final list reversal.
static void decode_rle_items(const int32_t* rle, int64_t n_ops,
                             EOL& items) {
    items.clear();
    for (int64_t t = 0; t < n_ops; t++) {
        int32_t e = rle[t];
        items.push_back({kOpChars[(e >> 28) & 7],
                         (int32_t)(e & 0x0FFFFFFF)});
    }
}

static void decode_anchored_eoidc(const int8_t* e, const int32_t* d,
                                  int64_t row, int64_t qlen, int64_t rlen,
                                  EOL& items) {
    int64_t x = rlen, y = qlen;
    items.clear();
    int prev = e[y * row + x];
    int64_t op_len = 0;
    for (;;) {
        int code = e[y * row + x];
        if (code == OP_U) break;
        int64_t length = d[y * row + x];
        if (code == OP_D) x -= length;
        else if (code == OP_I) y -= length;
        else { x -= 1; y -= 1; length = 1; }
        if (prev != code) {
            items.push_back({kOpChars[prev], (int32_t)op_len});
            prev = code;
            op_len = length;
        } else {
            op_len += length;
        }
    }
    items.push_back({kOpChars[prev], (int32_t)op_len});
    std::reverse(items.begin(), items.end());
}

static void decode_anchored_packed(const uint8_t* e, int64_t row,
                                   int64_t qlen, int64_t rlen, EOL& items) {
    int64_t x = rlen, y = qlen;
    items.clear();
    int prev = e[y * row + x] & BT_OP;
    int64_t op_len = 0;
    for (;;) {
        int b = e[y * row + x];
        int code = b & BT_OP;
        if (code == OP_U) break;
        int64_t length = 1;
        if (code == OP_D) {
            int64_t xx = x;
            while (e[y * row + xx] & BT_CD) { length++; xx--; }
            x -= length;
        } else if (code == OP_I) {
            int64_t yy = y;
            while (e[yy * row + x] & BT_CF) { length++; yy--; }
            y -= length;
        } else { x -= 1; y -= 1; }
        if (prev != code) {
            items.push_back({kOpChars[prev], (int32_t)op_len});
            prev = code;
            op_len = length;
        } else {
            op_len += length;
        }
    }
    items.push_back({kOpChars[prev], (int32_t)op_len});
    std::reverse(items.begin(), items.end());
}

static void decode_anchored_banded(const uint8_t* e, int64_t row,
                                   int64_t qlen, int64_t rlen, int64_t lbw,
                                   EOL& items) {
    int64_t y = qlen;
    int64_t o = rlen - y + lbw;
    items.clear();
    int prev = e[y * row + o] & BT_OP;
    int64_t op_len = 0;
    for (;;) {
        int b = e[y * row + o];
        int code = b & BT_OP;
        if (code == OP_U) break;
        int64_t length = 1;
        if (code == OP_D) {
            int64_t oo = o;
            while (e[y * row + oo] & BT_CD) { length++; oo--; }
            o -= length;
        } else if (code == OP_I) {
            int64_t yy = y, oo = o;
            while (e[yy * row + oo] & BT_CF) { length++; yy--; oo++; }
            y -= length;
            o += length;
        } else { y -= 1; }
        if (prev != code) {
            items.push_back({kOpChars[prev], (int32_t)op_len});
            prev = code;
            op_len = length;
        } else {
            op_len += length;
        }
    }
    items.push_back({kOpChars[prev], (int32_t)op_len});
    std::reverse(items.begin(), items.end());
}

static void decode_ext_eoidc(const int8_t* e, const int32_t* d,
                             int64_t row, int64_t maxi, int64_t maxj,
                             bool reverse, EOL& items) {
    int64_t x = maxj, y = maxi;
    items.clear();
    int prev = e[y * row + x];
    int64_t op_len = 0;
    for (;;) {
        int code = e[y * row + x];
        if (code == OP_U) break;
        int64_t length = d[y * row + x];
        if (code == OP_D) x -= length;
        else if (code == OP_I) { x += length; y -= length; }
        else { y -= 1; length = 1; }
        if (prev != code) {
            items.push_back({kOpChars[prev], (int32_t)op_len});
            prev = code;
            op_len = length;
        } else {
            op_len += length;
        }
    }
    items.push_back({kOpChars[prev], (int32_t)op_len});
    if (!reverse) std::reverse(items.begin(), items.end());
}

static void decode_ext_packed(const uint8_t* e, int64_t row, int64_t maxi,
                              int64_t maxj, bool reverse, EOL& items) {
    int64_t x = maxj, y = maxi;
    items.clear();
    int prev = e[y * row + x] & BT_OP;
    int64_t op_len = 0;
    for (;;) {
        int b = e[y * row + x];
        int code = b & BT_OP;
        if (code == OP_U) break;
        int64_t length = 1;
        if (code == OP_D) {
            int64_t xx = x;
            while (e[y * row + xx] & BT_CD) { length++; xx--; }
            x -= length;
        } else if (code == OP_I) {
            int64_t yy = y, xx = x;
            while (e[yy * row + xx] & BT_CF) { length++; yy--; xx++; }
            x += length;
            y -= length;
        } else { y -= 1; }
        if (prev != code) {
            items.push_back({kOpChars[prev], (int32_t)op_len});
            prev = code;
            op_len = length;
        } else {
            op_len += length;
        }
    }
    items.push_back({kOpChars[prev], (int32_t)op_len});
    if (!reverse) std::reverse(items.begin(), items.end());
}

static Params params_from(const int64_t* iparams, const double* fparams) {
    Params aa;
    aa.word_len = iparams[IP_WORD_LEN];
    aa.max_hits = iparams[IP_MAX_HITS];
    aa.max_gap = iparams[IP_MAX_GAP];
    aa.max_intron = iparams[IP_MAX_INTRON];
    aa.min_match = iparams[IP_MIN_MATCH];
    aa.max_desert = iparams[IP_MAX_DESERT];
    aa.min_raw_score = iparams[IP_MIN_RAW_SCORE];
    aa.min_non_overlap = iparams[IP_MIN_NON_OVERLAP];
    aa.oqc_min_non_overlap = iparams[IP_OQC_MIN_NON_OVERLAP];
    aa.band_width = iparams[IP_BAND_WIDTH];
    aa.m_score = iparams[IP_M_SCORE];
    aa.r_cost = iparams[IP_R_COST];
    aa.go_cost = iparams[IP_GO_COST];
    aa.ge_cost = iparams[IP_GE_COST];
    aa.x_cutoff = iparams[IP_X_CUTOFF];
    aa.min_ext_length = iparams[IP_MIN_EXT_LENGTH];
    aa.bp_cost = iparams[IP_BP_COST];
    aa.max_bp_log = iparams[IP_MAX_BP_LOG];
    aa.oqc = iparams[IP_OQC] != 0;
    aa.fbs = iparams[IP_FBS] != 0;
    aa.output_sam = iparams[IP_OUTPUT_SAM] != 0;
    aa.output_blast8 = iparams[IP_OUTPUT_BLAST8] != 0;
    aa.hard_clip = iparams[IP_HARD_CLIP] != 0;
    aa.fastq = iparams[IP_FASTQ] != 0;
    aa.min_identity = fparams[0];
    aa.fbs_ps_length = fparams[1];
    aa.fbs_ps_score = fparams[2];
    aa.max_query_length = iparams[IP_MAX_QUERY_LEN];
    aa.max_region_frags = iparams[IP_MAX_REGION_FRAGS];
    return aa;
}

}  // namespace yp

// ---- batch entry point ----

extern "C" {

// Align a batch of parsed reads end-to-end; returns one concatenated
// output text (caller frees with yt_free).  Reads are the flat arrays
// produced by yt_parse_queries; quals may be NULL (FASTA).  n_threads
// workers process reads from an atomic counter; outputs are joined in
// input order (deterministic, unlike the reference's completion order).
int yt_align_batch(
    const uint8_t* seqs, const int64_t* seq_offs,
    const uint8_t* ids, const int64_t* id_offs,
    const uint8_t* quals,
    int64_t n_reads,
    const uint8_t* genome_codes, int64_t genome_len, int64_t max_roff,
    const int64_t* bs_starts, const int64_t* bs_lens, int64_t n_seqs,
    const uint8_t* bs_names, const int64_t* bs_name_offs,
    const uint32_t* so, const uint32_t* roa, int64_t roa_len,
    const int64_t* iparams, const double* fparams,
    char** out_text, int64_t* out_len,
    char** stats_text, int64_t* stats_len,
    int64_t* total_seed_matches, int64_t* total_records,
    int64_t* dist_out) {
    using namespace yp;
    init_tables();

    Params aa;
    aa.word_len = iparams[IP_WORD_LEN];
    aa.max_hits = iparams[IP_MAX_HITS];
    aa.max_gap = iparams[IP_MAX_GAP];
    aa.max_intron = iparams[IP_MAX_INTRON];
    aa.min_match = iparams[IP_MIN_MATCH];
    aa.max_desert = iparams[IP_MAX_DESERT];
    aa.min_raw_score = iparams[IP_MIN_RAW_SCORE];
    aa.min_non_overlap = iparams[IP_MIN_NON_OVERLAP];
    aa.oqc_min_non_overlap = iparams[IP_OQC_MIN_NON_OVERLAP];
    aa.band_width = iparams[IP_BAND_WIDTH];
    aa.m_score = iparams[IP_M_SCORE];
    aa.r_cost = iparams[IP_R_COST];
    aa.go_cost = iparams[IP_GO_COST];
    aa.ge_cost = iparams[IP_GE_COST];
    aa.x_cutoff = iparams[IP_X_CUTOFF];
    aa.min_ext_length = iparams[IP_MIN_EXT_LENGTH];
    aa.bp_cost = iparams[IP_BP_COST];
    aa.max_bp_log = iparams[IP_MAX_BP_LOG];
    aa.oqc = iparams[IP_OQC] != 0;
    aa.fbs = iparams[IP_FBS] != 0;
    aa.output_sam = iparams[IP_OUTPUT_SAM] != 0;
    aa.output_blast8 = iparams[IP_OUTPUT_BLAST8] != 0;
    aa.hard_clip = iparams[IP_HARD_CLIP] != 0;
    aa.fastq = iparams[IP_FASTQ] != 0;
    aa.min_identity = fparams[0];
    aa.fbs_ps_length = fparams[1];
    aa.fbs_ps_score = fparams[2];
    int64_t n_threads = iparams[IP_N_THREADS];
    aa.max_query_length = iparams[IP_MAX_QUERY_LEN];
    aa.max_region_frags = iparams[IP_MAX_REGION_FRAGS];
    if (n_threads < 1) n_threads = 1;
    int64_t hw = (int64_t)std::thread::hardware_concurrency();
    if (hw > 0 && n_threads > hw) n_threads = hw;
    if (n_threads > n_reads) n_threads = n_reads > 0 ? n_reads : 1;

    GenomeView genome;
    genome.codes = genome_codes;
    genome.codes_len = genome_len;
    genome.max_roff = max_roff;
    genome.starts = bs_starts;
    genome.lens = bs_lens;
    genome.n_seqs = n_seqs;
    genome.names.reserve((size_t)n_seqs);
    for (int64_t i = 0; i < n_seqs; i++)
        genome.names.emplace_back(
            (const char*)bs_names + bs_name_offs[i],
            (size_t)(bs_name_offs[i + 1] - bs_name_offs[i]));

    std::vector<std::string> outs((size_t)n_reads);
    const bool want_stats = stats_text != nullptr;
    std::vector<std::string> stats((size_t)(want_stats ? n_reads : 0));
    std::atomic<int64_t> seed_sum{0};
    std::atomic<int64_t> rec_sum{0};
    std::atomic<int64_t> next{0};
    std::vector<Prof> profs((size_t)(n_threads > 0 ? n_threads : 1));
    std::atomic<int> prof_slot{0};
    std::vector<RunStats> rstats((size_t)(n_threads > 0 ? n_threads : 1));
    std::atomic<int> rs_slot{0};

    auto worker = [&]() {
        Prof* prof = prof_enabled()
            ? &profs[(size_t)prof_slot.fetch_add(1)] : nullptr;
        g_prof = prof;   // unbound below: -t 1 runs on the caller's thread
        RunStats* rs = dist_out
            ? &rstats[(size_t)rs_slot.fetch_add(1)] : nullptr;
        yt_wide_scores = aa.max_query_length > 32000 ? 1 : 0;
        yt_max_region_frags = aa.max_region_frags;
        State st;
        st.aa = &aa;
        st.genome = &genome;
        st.so = so;
        st.roa = roa;
        st.roa_len = roa_len;
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n_reads) break;
            int64_t s0 = seq_offs[i], s1 = seq_offs[i + 1];
            int64_t qlen = s1 - s0;
            st.q_len = qlen;
            st.fwd_chars = seqs + s0;
            st.qual = quals != nullptr ? quals + s0 : nullptr;
            st.query_id.assign((const char*)ids + id_offs[i],
                               (size_t)(id_offs[i + 1] - id_offs[i]));
            st.fwd_codes.resize((size_t)qlen);
            st.rev_codes.resize((size_t)qlen);
            st.rev_chars.resize((size_t)qlen);
            for (int64_t k = 0; k < qlen; k++)
                st.fwd_codes[(size_t)k] = kCodes[st.fwd_chars[k]];
            for (int64_t k = 0; k < qlen; k++) {
                uint8_t rc = kComp[st.fwd_codes[(size_t)(qlen - 1 - k)]
                                   & 0xF];
                st.rev_codes[(size_t)k] = rc;
                st.rev_chars[(size_t)k] = (uint8_t)kChars[rc];
            }
            double ts = want_stats ? now_s() : 0;
            auto sm_na = align_read(st, outs[(size_t)i], prof, rs);
            seed_sum.fetch_add(sm_na.first, std::memory_order_relaxed);
            rec_sum.fetch_add(sm_na.second, std::memory_order_relaxed);
            if (want_stats) {
                // QUERYSTATS row: id, len, seedMatches, alignments, usec
                // (core/pipeline.align_query field order).
                char tmp[64];
                std::string& srow = stats[(size_t)i];
                srow.append(st.query_id);
                snprintf(tmp, sizeof tmp, "\t%lld\t%lld\t%lld\t%lld\n",
                         (long long)qlen, (long long)sm_na.first,
                         (long long)sm_na.second,
                         (long long)((now_s() - ts) * 1e6));
                srow.append(tmp);
            }
        }
        g_prof = nullptr;
    };

    if (n_threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        for (int64_t t = 0; t < n_threads; t++)
            threads.emplace_back(worker);
        for (auto& th : threads) th.join();
    }

    if (dist_out) {
        RunStats m;
        for (const RunStats& r : rstats) {
            m.queries += r.queries;
            m.qlen_tot += r.qlen_tot;
            m.qlen_min = std::min(m.qlen_min, r.qlen_min);
            m.qlen_max = std::max(m.qlen_max, r.qlen_max);
            m.cnt_tot += r.cnt_tot;
            m.cnt_min = std::min(m.cnt_min, r.cnt_min);
            m.cnt_max = std::max(m.cnt_max, r.cnt_max);
            m.nonaligned += r.nonaligned;
            m.clumps_tot += r.clumps_tot;
            m.clumps_min = std::min(m.clumps_min, r.clumps_min);
            m.clumps_max = std::max(m.clumps_max, r.clumps_max);
        }
        dist_out[0] = m.queries;     dist_out[1] = m.qlen_tot;
        dist_out[2] = m.qlen_min;    dist_out[3] = m.qlen_max;
        dist_out[4] = m.cnt_tot;     dist_out[5] = m.cnt_min;
        dist_out[6] = m.cnt_max;     dist_out[7] = m.nonaligned;
        dist_out[8] = m.clumps_tot;  dist_out[9] = m.clumps_min;
        dist_out[10] = m.clumps_max;
    }

    if (prof_enabled()) {
        Prof sum;
        for (const Prof& p : profs) sum.add(p);
        fprintf(stderr,
                "[yt_prof] reads=%lld front=%.3fs (s2c=%.3fs) "
                "align=%.3fs (ext=%.3fs calls=%lld anch=%.3fs "
                "acalls=%lld smalldp=%.3fs scalls=%lld score=%.3fs "
                "gapc=%.3fs extfr=%.3fs) "
                "oqc=%.3fs print=%.3fs clumps=%lld\n",
                (long long)sum.reads, sum.front, sum.s2c,
                sum.align, sum.dp, (long long)sum.dp_calls, sum.dpa,
                (long long)sum.dpa_calls, sum.dps,
                (long long)sum.dps_calls, sum.sc, sum.gapc, sum.extfr,
                sum.oqc, sum.print, (long long)sum.clumps);
        fprintf(stderr,
                "[yt_prof2] scan=%.3fs (hash=%.3fs so=%.3fs roa=%.3fs) "
                "sort=%.3fs f2c=%.3fs hits=%lld "
                "frags=%lld\n",
                sum.scan_hash + sum.scan_so + sum.scan_roa, sum.scan_hash,
                sum.scan_so, sum.scan_roa, sum.sort, sum.f2c,
                (long long)sum.hits, (long long)sum.frags);

    }

    size_t total = 0;
    for (const std::string& s : outs) total += s.size();
    char* buf = (char*)malloc(total ? total : 1);
    if (!buf) return -1;
    size_t pos = 0;
    for (const std::string& s : outs) {
        memcpy(buf + pos, s.data(), s.size());
        pos += s.size();
    }
    *out_text = buf;
    *out_len = (int64_t)total;
    if (want_stats) {
        size_t st_total = 0;
        for (const std::string& s : stats) st_total += s.size();
        char* sbuf = (char*)malloc(st_total ? st_total : 1);
        if (!sbuf) return -1;
        size_t sp = 0;
        for (const std::string& s : stats) {
            memcpy(sbuf + sp, s.data(), s.size());
            sp += s.size();
        }
        *stats_text = sbuf;
        *stats_len = (int64_t)st_total;
    }
    if (total_seed_matches) *total_seed_matches = seed_sum.load();
    if (total_records) *total_records = rec_sum.load();
    return 0;
}

// ---- staged batch API (see the staged-pipeline comment block above) ----
//
// Lifetime: all pointer arguments to yt_batch_begin (reads, genome,
// index, params) must stay valid until yt_batch_free — the context
// stores pointers, not copies.

void* yt_batch_begin(
    const uint8_t* seqs, const int64_t* seq_offs,
    const uint8_t* ids, const int64_t* id_offs,
    const uint8_t* quals, int64_t n_reads,
    const uint8_t* genome_codes, int64_t genome_len, int64_t max_roff,
    const int64_t* bs_starts, const int64_t* bs_lens, int64_t n_seqs,
    const uint8_t* bs_names, const int64_t* bs_name_offs,
    const uint32_t* so, const uint32_t* roa, int64_t roa_len,
    const int64_t* iparams, const double* fparams,
    int64_t inline_small,
    const uint32_t* hits_diag, const int32_t* hits_qo,
    const int64_t* hit_offs, const int64_t* hit_totals,
    const int32_t* dev_clumps, const int64_t* dev_offs,
    int64_t profile) {
    using namespace yp;
    init_tables();
    BatchCtx* c = new BatchCtx();
    c->aa = params_from(iparams, fparams);
    c->n_threads = iparams[IP_N_THREADS];
    if (c->n_threads < 1) c->n_threads = 1;
    int64_t hw = (int64_t)std::thread::hardware_concurrency();
    if (hw > 0 && c->n_threads > hw) c->n_threads = hw;
    c->inline_small = inline_small != 0;
    c->genome.codes = genome_codes;
    c->genome.codes_len = genome_len;
    c->genome.max_roff = max_roff;
    c->genome.starts = bs_starts;
    c->genome.lens = bs_lens;
    c->genome.n_seqs = n_seqs;
    c->genome.names.reserve((size_t)n_seqs);
    for (int64_t i = 0; i < n_seqs; i++)
        c->genome.names.emplace_back(
            (const char*)bs_names + bs_name_offs[i],
            (size_t)(bs_name_offs[i + 1] - bs_name_offs[i]));
    c->so = so;
    c->roa = roa;
    c->roa_len = roa_len;
    c->seqs = seqs;
    c->seq_offs = seq_offs;
    c->ids = ids;
    c->id_offs = id_offs;
    c->quals = quals;
    c->n_reads = n_reads;
    c->hits_diag = hits_diag;
    c->hits_qo = hits_qo;
    c->hit_offs = hit_offs;
    c->hit_totals = hit_totals;
    c->dev_clumps = dev_clumps;
    c->dev_offs = dev_offs;
    c->slots.resize((size_t)n_reads);
    if (profile) c->profs.resize((size_t)c->n_threads);
    staged_run(*c, n_reads, [c](int64_t i) {
        double ts = now_s();
        staged_phase1(*c, i);
        c->slots[(size_t)i].usec += (int64_t)((now_s() - ts) * 1e6);
    }, true);
    for (ReadSlot& slot : c->slots)
        for (StagedProb& p : slot.gaps) c->gap_ptr.push_back(&p);
    return c;
}

int64_t yt_batch_gap_count(void* h) {
    return (int64_t)((yp::BatchCtx*)h)->gap_ptr.size();
}

void yt_batch_gap_meta(void* h, int32_t* qlen, int32_t* rlen,
                       int32_t* lbw, int32_t* rbw) {
    yp::BatchCtx& c = *(yp::BatchCtx*)h;
    for (size_t k = 0; k < c.gap_ptr.size(); k++) {
        qlen[k] = c.gap_ptr[k]->qlen;
        rlen[k] = c.gap_ptr[k]->rlen;
        lbw[k] = c.gap_ptr[k]->lbw;
        rbw[k] = c.gap_ptr[k]->rbw;
    }
}

// Source coordinates for device-resident problem assembly: the gap
// problem k's q slice is strand-row q_row[k] of the chunk's code batch
// at [q_src, q_src + q_copy) zero-filled to qlen, its r slice is genome
// codes [r_src, r_src + r_copy) zero-filled to rlen (py_range-clamped
// host-side).  The planes never cross the host<->device link.
void yt_batch_gap_meta2(void* h, int32_t* q_row, int32_t* q_src,
                        int32_t* q_copy, int64_t* r_src,
                        int32_t* r_copy) {
    yp::BatchCtx& c = *(yp::BatchCtx*)h;
    for (size_t k = 0; k < c.gap_ptr.size(); k++) {
        const yp::StagedProb& p = *c.gap_ptr[k];
        q_row[k] = 2 * p.read + p.strand;
        q_src[k] = (int32_t)p.q_src;
        q_copy[k] = p.q_copy;
        r_src[k] = p.r_src;
        r_copy[k] = p.r_copy;
    }
}

void yt_batch_gap_fetch(void* h, int64_t n, const int64_t* idx,
                        uint8_t* q, int64_t qstride,
                        uint8_t* r, int64_t rstride) {
    yp::BatchCtx& c = *(yp::BatchCtx*)h;
    for (int64_t k = 0; k < n; k++) {
        const yp::StagedProb& p = *c.gap_ptr[(size_t)idx[k]];
        const uint8_t* arena = c.slots[(size_t)p.read].arena.data();
        memcpy(q + k * qstride, arena + p.q_off, (size_t)p.qlen);
        memcpy(r + k * rstride, arena + p.r_off, (size_t)p.rlen);
    }
}

// Apply gap-fill DP results.  format: FMT_NATIVE runs every problem on
// the host DP (idx/arrays ignored, n ignored); FMT_EOIDC takes int8 eo +
// int32 idc planes; FMT_PACKED a packed full-coordinate plane;
// FMT_PACKED_BAND a packed band-relative plane (row_stride = wband);
// FMT_RLE device-decoded run-length items (plane = int32 items, idc =
// per-problem item counts, row_stride unused).  plane_stride/row_stride
// are in elements.  Each problem touches only its own SFrag, so
// decode+apply parallelizes over problems.
int yt_batch_gap_apply(void* h, int64_t format, int64_t n,
                       const int64_t* idx, const void* plane,
                       const int32_t* idc, int64_t plane_stride,
                       int64_t row_stride, const int32_t* score) {
    using namespace yp;
    BatchCtx& c = *(BatchCtx*)h;
    if (format == FMT_NATIVE) {
        int64_t total = (int64_t)c.gap_ptr.size();
        std::vector<int64_t> dts((size_t)total);
        staged_run(c, total, [&](int64_t k) {
            static thread_local State scratch;
            scratch.aa = &c.aa;
            double ts = now_s();
            StagedProb& p = *c.gap_ptr[(size_t)k];
            SFrag& sf = p.clump->sfrags[(size_t)p.sfrag_idx];
            const uint8_t* arena = c.slots[(size_t)p.read].arena.data();
            sf.score = anchored_dp(scratch, arena + p.q_off, p.qlen,
                                   arena + p.r_off, p.rlen, p.lbw, p.rbw,
                                   sf.eol);
            dts[(size_t)k] = (int64_t)((now_s() - ts) * 1e6);
        });
        for (int64_t k = 0; k < total; k++)
            c.slots[(size_t)c.gap_ptr[(size_t)k]->read].usec +=
                dts[(size_t)k];
        return 0;
    }
    std::vector<int64_t> dts((size_t)n);
    staged_run(c, n, [&](int64_t k) {
        double ts = now_s();
        StagedProb& p = *c.gap_ptr[(size_t)idx[k]];
        SFrag& sf = p.clump->sfrags[(size_t)p.sfrag_idx];
        if (format == FMT_EOIDC)
            decode_anchored_eoidc((const int8_t*)plane + k * plane_stride,
                                  idc + k * plane_stride, row_stride,
                                  p.qlen, p.rlen, sf.eol);
        else if (format == FMT_PACKED)
            decode_anchored_packed((const uint8_t*)plane + k * plane_stride,
                                   row_stride, p.qlen, p.rlen, sf.eol);
        else if (format == FMT_RLE) {
            decode_rle_items((const int32_t*)plane + k * plane_stride,
                             idc[k], sf.eol);
            std::reverse(sf.eol.begin(), sf.eol.end());
        } else
            decode_anchored_banded((const uint8_t*)plane + k * plane_stride,
                                   row_stride, p.qlen, p.rlen, p.lbw,
                                   sf.eol);
        sf.score = score[k];
        dts[(size_t)k] = (int64_t)((now_s() - ts) * 1e6);
    });
    for (int64_t k = 0; k < n; k++)
        c.slots[(size_t)c.gap_ptr[(size_t)idx[k]]->read].usec +=
            dts[(size_t)k];
    return 0;
}

void yt_batch_phase2(void* h) {
    using namespace yp;
    BatchCtx& c = *(BatchCtx*)h;
    staged_run(c, c.n_reads, [&c](int64_t i) {
        double ts = now_s();
        staged_phase2(c, i);
        c.slots[(size_t)i].usec += (int64_t)((now_s() - ts) * 1e6);
    });
    for (ReadSlot& slot : c.slots)
        for (StagedProb& p : slot.exts) c.ext_ptr.push_back(&p);
}

int64_t yt_batch_ext_count(void* h) {
    return (int64_t)((yp::BatchCtx*)h)->ext_ptr.size();
}

void yt_batch_ext_meta(void* h, int32_t* qlen, int32_t* rlen,
                       uint8_t* rev) {
    yp::BatchCtx& c = *(yp::BatchCtx*)h;
    for (size_t k = 0; k < c.ext_ptr.size(); k++) {
        qlen[k] = c.ext_ptr[k]->qlen;
        rlen[k] = c.ext_ptr[k]->rlen;
        rev[k] = c.ext_ptr[k]->reverse;
    }
}

// Device-assembly coordinates for the extension problems (see
// yt_batch_gap_meta2); `reverse` problems (yt_batch_ext_meta's rev)
// additionally reverse the whole zero-filled buffer, i.e. element j
// reads source position qlen-1-j (resp. rlen-1-j).
void yt_batch_ext_meta2(void* h, int32_t* q_row, int32_t* q_src,
                        int32_t* q_copy, int64_t* r_src,
                        int32_t* r_copy) {
    yp::BatchCtx& c = *(yp::BatchCtx*)h;
    for (size_t k = 0; k < c.ext_ptr.size(); k++) {
        const yp::StagedProb& p = *c.ext_ptr[k];
        q_row[k] = 2 * p.read + p.strand;
        q_src[k] = (int32_t)p.q_src;
        q_copy[k] = p.q_copy;
        r_src[k] = p.r_src;
        r_copy[k] = p.r_copy;
    }
}

void yt_batch_ext_fetch(void* h, int64_t n, const int64_t* idx,
                        uint8_t* q, int64_t qstride,
                        uint8_t* r, int64_t rstride) {
    yp::BatchCtx& c = *(yp::BatchCtx*)h;
    for (int64_t k = 0; k < n; k++) {
        const yp::StagedProb& p = *c.ext_ptr[(size_t)idx[k]];
        const uint8_t* arena = c.slots[(size_t)p.read].arena.data();
        memcpy(q + k * qstride, arena + p.q_off, (size_t)p.qlen);
        memcpy(r + k * rstride, arena + p.r_off, (size_t)p.rlen);
    }
}

// Apply extension DP results.  FMT_NATIVE runs the host DP over all
// problems; FMT_EOIDC / FMT_PACKED decode banded-layout planes from
// (maxi, maxj); FMT_RLE takes device-decoded run-length items (plane =
// int32 items in walk order, idc = per-problem item counts).  Two
// extensions can share a clump (back + forward), so decode runs
// parallel into scratch and the merges apply serially.
int yt_batch_ext_apply(void* h, int64_t format, int64_t n,
                       const int64_t* idx, const void* plane,
                       const int32_t* idc, int64_t plane_stride,
                       int64_t row_stride, const int32_t* maxi,
                       const int32_t* maxj, const int32_t* score) {
    using namespace yp;
    BatchCtx& c = *(BatchCtx*)h;
    const int64_t bw2 = 2 * c.aa.band_width;
    if (format == FMT_NATIVE) {
        int64_t total = (int64_t)c.ext_ptr.size();
        std::vector<EOL> items((size_t)total);
        std::vector<int64_t> sc(total), aq(total), ar(total);
        std::vector<int64_t> dts((size_t)total);
        staged_run(c, total, [&](int64_t k) {
            static thread_local State scratch;
            scratch.aa = &c.aa;
            double ts = now_s();
            StagedProb& p = *c.ext_ptr[(size_t)k];
            const uint8_t* arena = c.slots[(size_t)p.read].arena.data();
            sc[k] = ext_dp(scratch, arena + p.q_off, p.qlen,
                           arena + p.r_off, p.rlen, p.reverse != 0,
                           items[(size_t)k], &aq[k], &ar[k]);
            dts[(size_t)k] = (int64_t)((now_s() - ts) * 1e6);
        });
        for (int64_t k = 0; k < total; k++)
            c.slots[(size_t)c.ext_ptr[(size_t)k]->read].usec +=
                dts[(size_t)k];
        for (int64_t k = 0; k < total; k++) {
            if (sc[k] <= 0) continue;
            StagedProb& p = *c.ext_ptr[(size_t)k];
            SFrag& sf = p.clump->sfrags.front();
            if (p.reverse) {
                eol_merge_front(p.clump->eol, items[(size_t)k]);
                sf.frag.add_q_front(aq[k]);
                sf.frag.add_r_front(ar[k]);
            } else {
                eol_merge_back(p.clump->eol, items[(size_t)k]);
                sf.frag.add_q_back(aq[k]);
                sf.frag.add_r_back(ar[k]);
            }
            sf.score += sc[k];
        }
        return 0;
    }
    std::vector<EOL> items((size_t)n);
    std::vector<int64_t> dts((size_t)n);
    staged_run(c, n, [&](int64_t k) {
        if (score[k] <= 0) return;
        double ts = now_s();
        if (format == FMT_EOIDC)
            decode_ext_eoidc((const int8_t*)plane + k * plane_stride,
                             idc + k * plane_stride, row_stride,
                             maxi[k], maxj[k],
                             c.ext_ptr[(size_t)idx[k]]->reverse != 0,
                             items[(size_t)k]);
        else if (format == FMT_RLE) {
            EOL& it = items[(size_t)k];
            decode_rle_items((const int32_t*)plane + k * plane_stride,
                             idc[k], it);
            if (!c.ext_ptr[(size_t)idx[k]]->reverse)
                std::reverse(it.begin(), it.end());
        } else
            decode_ext_packed((const uint8_t*)plane + k * plane_stride,
                              row_stride, maxi[k], maxj[k],
                              c.ext_ptr[(size_t)idx[k]]->reverse != 0,
                              items[(size_t)k]);
        dts[(size_t)k] = (int64_t)((now_s() - ts) * 1e6);
    });
    for (int64_t k = 0; k < n; k++)
        c.slots[(size_t)c.ext_ptr[(size_t)idx[k]]->read].usec +=
            dts[(size_t)k];
    for (int64_t k = 0; k < n; k++) {
        if (score[k] <= 0) continue;
        StagedProb& p = *c.ext_ptr[(size_t)idx[k]];
        SFrag& sf = p.clump->sfrags.front();
        int64_t aq = maxi[k];
        int64_t ar = maxi[k] + (maxj[k] - bw2);
        if (p.reverse) {
            eol_merge_front(p.clump->eol, items[(size_t)k]);
            sf.frag.add_q_front(aq);
            sf.frag.add_r_front(ar);
        } else {
            eol_merge_back(p.clump->eol, items[(size_t)k]);
            sf.frag.add_q_back(aq);
            sf.frag.add_r_back(ar);
        }
        sf.score += score[k];
    }
    return 0;
}

int yt_batch_finish(void* h, char** out_text, int64_t* out_len,
                    int64_t* seed_matches, int64_t* records,
                    int64_t* dist_out) {
    using namespace yp;
    BatchCtx& c = *(BatchCtx*)h;
    staged_run(c, c.n_reads, [&c](int64_t i) {
        double ts = now_s();
        staged_phase3(c, i);
        c.slots[(size_t)i].usec += (int64_t)((now_s() - ts) * 1e6);
    });
    size_t total = 0;
    int64_t seed_sum = 0, rec_sum = 0;
    RunStats m;
    for (ReadSlot& slot : c.slots) {
        total += slot.out.size();
        seed_sum += slot.seed_matches;
        int64_t n_aligns = (int64_t)slot.st.clumps.size();
        rec_sum += n_aligns;
        if (dist_out) {
            // Same STATS distribution fields as yt_align_batch
            // (Query.c:275-289 report under -v).
            for (int64_t cnt : {slot.fwd_count, slot.rev_count}) {
                m.cnt_tot += cnt;
                if (cnt > 0 && cnt < m.cnt_min) m.cnt_min = cnt;
                if (cnt > m.cnt_max) m.cnt_max = cnt;
            }
            m.queries++;
            m.qlen_tot += slot.st.q_len;
            if (slot.st.q_len < m.qlen_min) m.qlen_min = slot.st.q_len;
            if (slot.st.q_len > m.qlen_max) m.qlen_max = slot.st.q_len;
            m.clumps_tot += n_aligns;
            if (n_aligns > m.clumps_max) m.clumps_max = n_aligns;
            if (n_aligns > 0 && n_aligns < m.clumps_min)
                m.clumps_min = n_aligns;
            if (n_aligns == 0) m.nonaligned++;
        }
    }
    if (dist_out) {
        dist_out[0] = m.queries;     dist_out[1] = m.qlen_tot;
        dist_out[2] = m.qlen_min;    dist_out[3] = m.qlen_max;
        dist_out[4] = m.cnt_tot;     dist_out[5] = m.cnt_min;
        dist_out[6] = m.cnt_max;     dist_out[7] = m.nonaligned;
        dist_out[8] = m.clumps_tot;  dist_out[9] = m.clumps_min;
        dist_out[10] = m.clumps_max;
    }
    char* buf = (char*)malloc(total ? total : 1);
    if (!buf) return -1;
    size_t pos = 0;
    for (ReadSlot& slot : c.slots) {
        memcpy(buf + pos, slot.out.data(), slot.out.size());
        pos += slot.out.size();
    }
    *out_text = buf;
    *out_len = (int64_t)total;
    if (seed_matches) *seed_matches = seed_sum;
    if (records) *records = rec_sum;
    return 0;
}

// Per-read QUERYSTATS fields (Query.c:480-491 analog) for the staged
// engine's -qs: query length, seed matches, alignments printed, and
// per-read host-pipeline microseconds (phase1/2/3 plus each DP
// problem's inline/decode time attributed to its read).  Batched
// DEVICE kernel time and transfers are not per-read attributable and
// are excluded; on the staged native backend (DP inline) the usec
// column therefore carries the per-read engine's semantics.  Call
// after yt_batch_finish and before yt_batch_free.
void yt_batch_query_stats(void* h, int64_t* qlen, int64_t* seeds,
                          int64_t* aligns, int64_t* usec) {
    yp::BatchCtx& c = *(yp::BatchCtx*)h;
    for (int64_t i = 0; i < c.n_reads; i++) {
        yp::ReadSlot& slot = c.slots[(size_t)i];
        qlen[i] = slot.st.q_len;
        seeds[i] = slot.seed_matches;
        aligns[i] = (int64_t)slot.st.clumps.size();
        if (usec) usec[i] = slot.usec;
    }
}

// Phase 1's stage sums over the batch's threads (yt_batch_begin with its
// profiling flag; zeros without it): secs = scan_hash, scan_so, scan_roa,
// sort, f2c, hits_f2c, stage1 (thread-seconds); counts = hits, frags,
// clumps.  Returns the number of thread slots.
int64_t yt_batch_prof(void* h, double* secs, int64_t* counts) {
    yp::BatchCtx& c = *(yp::BatchCtx*)h;
    Prof sum;
    for (const Prof& p : c.profs) sum.add(p);
    const double s[7] = {sum.scan_hash, sum.scan_so, sum.scan_roa, sum.sort,
                         sum.f2c, sum.hits_f2c, sum.stage1};
    const int64_t n[3] = {sum.hits, sum.frags, sum.clumps};
    for (int k = 0; k < 7; k++) secs[k] = s[k];
    for (int k = 0; k < 3; k++) counts[k] = n[k];
    return (int64_t)c.profs.size();
}

void yt_batch_free(void* h) {
    delete (yp::BatchCtx*)h;
}

}  // extern "C"
