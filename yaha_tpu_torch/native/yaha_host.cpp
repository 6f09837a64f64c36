// yaha_tpu native host library: high-throughput I/O path.
//
// TPU-native equivalents of the reference's host-side C components
// (SURVEY.md section 2.3): the nib2 codec (Compress.c), the FASTA/FASTQ
// query parser (Query.c:102-228), and the SAM record serializer fast path
// (AlignOutput.c:115-321).  Batch-oriented, in-memory APIs designed for a
// feeder thread filling device batches, exposed through a C ABI consumed
// via ctypes (yaha_tpu/native/host.py).  Semantics are kept byte-parity
// with the Python implementations (cross-tested in tests/test_native.py).
//
// Build: tools/build_native.sh  ->  yaha_tpu/native/libyaha_host.so
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <ctime>
#include <string>
#include <vector>
#include <algorithm>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include "yaha_prof.h"

#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512VL__)
#include <immintrin.h>
#define YT_HAVE_AVX512 1
#endif

extern "C" {

// ---------- shared ----------

void yt_free(void* p) { free(p); }

// Wide-score mode (set per pipeline thread by yt_align_batch): disables
// the reference's int16 score-storage wraps.  The wraps are byte-parity
// obligations only inside the reference's input domain (reads <= 32 kb,
// AlignArgs.c:82); --max-query-length beyond that would otherwise wrap
// any full-length match score negative and break OQC selection.
thread_local int64_t yt_wide_scores = 0;

// Production safety valve (--max-region-frags, default 0 = off): the
// chain DP is O(n^2) over a region's fragments, and a pathological
// tandem-repeat read under permissive configs can put ~10^5 fragments
// in one region (minutes per read; the reference segfaults on such
// inputs).  When the cap is set, oversized regions are skipped and
// counted so the driver can warn; default keeps byte parity.
thread_local int64_t yt_max_region_frags = 0;
thread_local int64_t yt_skipped_regions = 0;
void yt_set_max_region_frags(int64_t v) { yt_max_region_frags = v; }
int64_t yt_take_skipped_regions() {
    int64_t v = yt_skipped_regions;
    yt_skipped_regions = 0;
    return v;
}
static inline int64_t yt_wrap_i16(int64_t x) {
    return yt_wide_scores ? x : (((x + 0x8000) & 0xFFFF) - 0x8000);
}

// char -> 4-bit code table (Math.c:141-152 values; >=128 maps to X=14).
static uint8_t four_bit_codes[256];
static char four_bit_chars[17] = "TCAGNBDHKMRSVWXY";
static uint8_t four_bit_comp[16] = {2, 3, 0, 1, 4, 12, 7, 6,
                                    9, 8, 15, 11, 5, 13, 14, 10};

static void init_tables() {
    static bool done = false;
    if (done) return;
    for (int i = 0; i < 256; i++) four_bit_codes[i] = 14;
    const char* bases = "ABCDGHKMNRSTUVWY";
    const uint8_t codes[] = {2, 5, 1, 6, 3, 7, 8, 9, 4, 10, 11, 0, 0, 12,
                             13, 15};
    for (int i = 0; bases[i]; i++) {
        four_bit_codes[(uint8_t)bases[i]] = codes[i];
        four_bit_codes[(uint8_t)(bases[i] + 32)] = codes[i];
    }
    done = true;
}

// ---------- nib2 codec ----------

// FASTA -> nib2, matching compressFile (Compress.c:220-329): bytes 0-31
// skipped, names stop at first space, sequences padded with X codes to a
// 4-byte boundary, version-2 header.
int yt_compress_fasta(const uint8_t* in, int64_t n, uint8_t** out,
                      int64_t* out_n) {
    init_tables();
    std::vector<std::string> names;
    std::vector<int64_t> seq_starts, seq_lengths;
    std::vector<uint8_t> bases;  // packed
    bases.reserve((size_t)(n / 2 + 16));
    int64_t i = 0;
    int64_t base_count = 0;
    bool in_seq = false;
    auto finalize = [&]() {
        if (!in_seq) return;
        if (base_count & 1) {
            bases.back() |= 14;  // X pad nibble
        }
        while (bases.size() & 3) bases.push_back(0xEE);
        seq_lengths.push_back(base_count);
        base_count = 0;
    };
    while (i < n) {
        uint8_t c = in[i];
        if (c <= 31) { i++; continue; }
        if (c == '>') {
            finalize();
            int64_t nl = i + 1;
            while (nl < n && in[nl] != '\n') nl++;
            std::string name((const char*)in + i + 1, nl - i - 1);
            size_t sp = name.find(' ');
            if (sp != std::string::npos) name.resize(sp);
            names.push_back(name);
            seq_starts.push_back((int64_t)bases.size());
            in_seq = true;
            i = nl + 1;
            continue;
        }
        uint8_t code = four_bit_codes[c];
        if (base_count & 1) bases.back() |= code;
        else bases.push_back(code << 4);
        base_count++;
        i++;
    }
    finalize();

    int64_t seq_count = (int64_t)names.size();
    int64_t tot_name = 0;
    for (auto& s : names) tot_name += (int64_t)s.size();
    int64_t tot_name_pad = (tot_name + 3) & ~3LL;
    int64_t preamble = 20 + 16 * seq_count + tot_name_pad;
    int64_t total = preamble + (int64_t)bases.size();
    uint8_t* buf = (uint8_t*)malloc(total);
    if (!buf) return -1;
    uint32_t* u = (uint32_t*)buf;
    u[0] = 0x01020304u;
    u[1] = 2;
    u[2] = (uint32_t)preamble;
    u[3] = (uint32_t)seq_count;
    int64_t name_off = 0;
    for (int64_t k = 0; k < seq_count; k++) {
        u[4 + 4 * k + 0] = (uint32_t)seq_starts[k];
        u[4 + 4 * k + 1] = (uint32_t)seq_lengths[k];
        u[4 + 4 * k + 2] = (uint32_t)name_off;
        u[4 + 4 * k + 3] = (uint32_t)names[k].size();
        name_off += (int64_t)names[k].size();
    }
    u[4 + 4 * seq_count] = 0;  // mask block count
    uint8_t* p = buf + 16 + 16 * seq_count + 4;
    for (auto& s : names) { memcpy(p, s.data(), s.size()); p += s.size(); }
    memset(p, 0, tot_name_pad - tot_name);
    p += tot_name_pad - tot_name;
    memcpy(p, bases.data(), bases.size());
    *out = buf;
    *out_n = total;
    return 0;
}

// File-to-file FASTA -> nib2: mmap the input and write the result once.
// The in-memory API above forces ~3 genome-size byte copies through the
// Python layer at hg scale; this path has exactly one output buffer.
int yt_compress_fasta_file(const char* in_path, const char* out_path) {
    int fd = open(in_path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return -1; }
    int64_t n = st.st_size;
    void* m = mmap(nullptr, n ? (size_t)n : 1, PROT_READ, MAP_PRIVATE,
                   fd, 0);
    close(fd);
    if (m == MAP_FAILED) return -1;
    madvise(m, (size_t)n, MADV_SEQUENTIAL);
    uint8_t* buf = nullptr;
    int64_t total = 0;
    int rc = yt_compress_fasta((const uint8_t*)m, n, &buf, &total);
    munmap(m, n ? (size_t)n : 1);
    if (rc != 0) return rc;
    FILE* f = fopen(out_path, "wb");
    if (!f) { free(buf); return -1; }
    size_t w = fwrite(buf, 1, (size_t)total, f);
    free(buf);
    int cl = fclose(f);
    return (cl == 0 && (int64_t)w == total) ? 0 : -1;
}

// nib2 packed bytes -> one 4-bit code per output byte.
int yt_unpack_nib2(const uint8_t* in, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; i++) {
        out[2 * i] = in[i] >> 4;
        out[2 * i + 1] = in[i] & 0xF;
    }
    return 0;
}

// ---------- FASTA/FASTQ query parser ----------

// Parse a whole query file into flat batch arrays, replicating
// readNextQuery semantics (Query.c:102-228): ids (spaces->underscores,
// truncated at 200), sequence bytes with embedded newlines stripped,
// FASTQ quality with the @-after-newline heuristic, skip-with-warning for
// over-length/short/mismatched records, stop at a zero-length record.
//
// Outputs (malloc'd, caller frees with yt_free):
//   ids:     concatenated id bytes;       id_offs:  n_reads+1 int64
//   seqs:    concatenated sequence bytes; seq_offs: n_reads+1 int64
//   quals:   concatenated quality bytes (empty if FASTA)
int yt_parse_queries(const uint8_t* in, int64_t n, int fastq,
                     int64_t max_query_len, int64_t word_len,
                     uint8_t** ids, int64_t** id_offs,
                     uint8_t** seqs, int64_t** seq_offs,
                     uint8_t** quals, int64_t* n_reads,
                     int64_t* stopped) {
    *stopped = 0;
    std::vector<uint8_t> id_buf, seq_buf, qual_buf;
    std::vector<int64_t> id_off{0}, seq_off{0};
    const int MAX_ID = 200;
    int64_t pos = 1;  // first '>'/'@' consumed by format sniff
    int64_t count = 0;
    while (pos <= n && pos < n) {
        // ID line.
        int64_t nl = pos;
        while (nl < n && in[nl] != '\n') nl++;
        int64_t id_len = nl - pos;
        int64_t id_take = id_len > MAX_ID ? MAX_ID : id_len;
        size_t id_base = id_buf.size();
        for (int64_t k = 0; k < id_take; k++) {
            uint8_t c = in[pos + k];
            id_buf.push_back(c == ' ' ? '_' : c);
        }
        pos = nl + 1;
        // Sequence.
        uint8_t brk = fastq ? '+' : '>';
        int64_t seq_end = pos;
        while (seq_end < n && in[seq_end] != brk) seq_end++;
        size_t seq_base = seq_buf.size();
        for (int64_t k = pos; k < seq_end; k++)
            if (in[k] != '\n') seq_buf.push_back(in[k]);
        int64_t seq_len = (int64_t)(seq_buf.size() - seq_base);
        pos = seq_end + 1;
        bool fail = false;
        size_t qual_base = qual_buf.size();
        if (fastq) {
            // Skip rest of '+' line.
            while (pos < n && in[pos] != '\n') pos++;
            pos++;
            int64_t qstart = pos;
            // Quality until '@' preceded by a newline inside the region.
            int64_t at = pos;
            while (at < n) {
                if (in[at] == '@' && at > qstart && in[at - 1] == '\n')
                    break;
                at++;
            }
            for (int64_t k = qstart; k < at && k < n; k++)
                if (in[k] != '\n') qual_buf.push_back(in[k]);
            pos = at < n ? at + 1 : n;
            int64_t qual_len = (int64_t)(qual_buf.size() - qual_base);
            if (seq_len > max_query_len || qual_len > max_query_len)
                fail = true;
            else if (seq_len != qual_len) {
                fprintf(stderr,
                        "Warning.  Query sequence (%lld) and quality score "
                        "sequence (%lld) have different lengths in fastq "
                        "file.  Query will be skipped.\n",
                        (long long)seq_len, (long long)qual_len);
                fail = true;
            }
        } else if (seq_len > max_query_len) {
            fprintf(stderr,
                    "Warning.  Query sequence exceeds maximum length of "
                    "%lld.  Query will be skipped.\n",
                    (long long)max_query_len);
            fail = true;
        }
        if (fail) {
            id_buf.resize(id_base);
            seq_buf.resize(seq_base);
            qual_buf.resize(qual_base);
            continue;
        }
        if (seq_len == 0) {
            // Reference semantics: a zero-length record ends processing
            // (Query.c:306); `stopped` lets a chunked caller stop too.
            id_buf.resize(id_base);
            seq_buf.resize(seq_base);
            qual_buf.resize(qual_base);
            *stopped = 1;
            break;
        }
        if (seq_len < word_len) {
            fprintf(stderr, "Query length must be at least wordlen bases "
                            "long. Query will be skipped.\n");
            id_buf.resize(id_base);
            seq_buf.resize(seq_base);
            qual_buf.resize(qual_base);
            continue;
        }
        id_off.push_back((int64_t)id_buf.size());
        seq_off.push_back((int64_t)seq_buf.size());
        count++;
    }
    auto dup = [](const std::vector<uint8_t>& v) {
        uint8_t* p = (uint8_t*)malloc(v.size() ? v.size() : 1);
        memcpy(p, v.data(), v.size());
        return p;
    };
    auto dup64 = [](const std::vector<int64_t>& v) {
        int64_t* p = (int64_t*)malloc(v.size() * sizeof(int64_t));
        memcpy(p, v.data(), v.size() * sizeof(int64_t));
        return p;
    };
    *ids = dup(id_buf);
    *id_offs = dup64(id_off);
    *seqs = dup(seq_buf);
    *seq_offs = dup64(seq_off);
    *quals = dup(qual_buf);
    *n_reads = count;
    return 0;
}

// ---------- SAM serializer fast path ----------

// Render CIGAR + MD for one alignment from run-length op arrays
// (AlignOutput.c:162-273 semantics: M/R merged in CIGAR; MD with the
// '0'-after-delete hack).  ops are the op chars 'M','R','I','D','H','S';
// genome_codes indexed from ref_off for R/D runs.
int yt_format_cigar_md(const uint8_t* ops, const int32_t* lens, int64_t n,
                       const uint8_t* genome_codes, int64_t ref_off,
                       char** cigar_out, char** md_out) {
    init_tables();
    std::string cigar, md;
    char tmp[32];
    int64_t matches = 0;
    for (int64_t k = 0; k < n; k++) {
        char op = (char)ops[k];
        if (op == 'M' || op == 'R') {
            matches += lens[k];
            continue;
        }
        if (matches > 0) {
            snprintf(tmp, sizeof tmp, "%lldM", (long long)matches);
            cigar += tmp;
            matches = 0;
        }
        snprintf(tmp, sizeof tmp, "%d%c", lens[k], op);
        cigar += tmp;
    }
    if (matches > 0) {
        snprintf(tmp, sizeof tmp, "%lldM", (long long)matches);
        cigar += tmp;
    }

    matches = 0;
    char previous = 'U';
    int64_t cur = ref_off;
    for (int64_t k = 0; k < n; k++) {
        char op = (char)ops[k];
        int32_t len = lens[k];
        if (op == 'M') {
            matches += len;
            cur += len;
        } else if (op == 'R') {
            if (matches > 0) {
                snprintf(tmp, sizeof tmp, "%lld", (long long)matches);
                md += tmp;
                matches = 0;
            }
            if (previous == 'D') md += '0';
            for (int32_t t = 0; t < len; t++)
                md += four_bit_chars[genome_codes[cur + t]];
            cur += len;
        } else if (op == 'D') {
            if (matches > 0) {
                snprintf(tmp, sizeof tmp, "%lld", (long long)matches);
                md += tmp;
                matches = 0;
            }
            md += '^';
            for (int32_t t = 0; t < len; t++)
                md += four_bit_chars[genome_codes[cur + t]];
            cur += len;
        }
        previous = op;
    }
    if (matches > 0) {
        snprintf(tmp, sizeof tmp, "%lld", (long long)matches);
        md += tmp;
    }
    *cigar_out = strdup(cigar.c_str());
    *md_out = strdup(md.c_str());
    return 0;
}

// Reverse-complement chars for a batch of reads (reverse buffers,
// Query.c:158-168 semantics: canonical uppercase complement chars).
int yt_revcomp_codes(const uint8_t* codes, int64_t n, uint8_t* rev_codes,
                     uint8_t* rev_chars) {
    init_tables();
    for (int64_t i = 0; i < n; i++) {
        uint8_t rc = four_bit_comp[codes[n - 1 - i] & 0xF];
        rev_codes[i] = rc;
        rev_chars[i] = (uint8_t)four_bit_chars[rc];
    }
    return 0;
}

int yt_map_codes(const uint8_t* chars, int64_t n, uint8_t* codes) {
    init_tables();
    for (int64_t i = 0; i < n; i++) codes[i] = four_bit_codes[chars[i]];
    return 0;
}

// Fragment-chain DP over one sorted node range
// (buildBestClumpFromFragmentRange, GraphPath.cpp:161-270).  Nodes arrive
// sorted ascending by (SQO, diag); arrays are SoA.  Stored best scores
// wrap to int16 (SINT) while each candidate newScore compares unwrapped
// (`int newScore`, GraphPath.cpp:230).  Returns the best end-node index.
int64_t yt_chain_dp(int64_t n, const int64_t* sqo, const int64_t* eqo,
                    const int64_t* diag, const int64_t* length,
                    int64_t max_gap, int64_t max_desert, int64_t m_score,
                    int64_t go_cost, int64_t ge_cost,
                    int64_t* best_score, int64_t* prev_idx,
                    int64_t* path_length, int64_t* path_sqo) {
    const int64_t M32 = 0xFFFFFFFFll;
    static thread_local std::vector<int64_t> sro, ero, length_w;
    sro.resize((size_t)n); ero.resize((size_t)n);
    length_w.resize((size_t)n);
    for (int64_t i = 0; i < n; i++) {
        sro[i] = (diag[i] + sqo[i]) & M32;
        ero[i] = (diag[i] + eqo[i]) & M32;
        // SINT nodeLength/bestScore stores (int16 wrap), as in _Node.
        int64_t lw = yt_wrap_i16(length[i]);
        length_w[i] = lw;
        best_score[i] = yt_wrap_i16(lw * m_score);
        prev_idx[i] = -1;
        path_length[i] = 1;
        path_sqo[i] = sqo[i];
    }
    for (int64_t i = 0; i + 1 < n; i++) {
        for (int64_t j = i + 1; j < n; j++) {
            if (sqo[j] == sqo[i]) continue;   // same-SQO run: never an edge
            int64_t dgap = diag[j] >= diag[i] ? diag[j] - diag[i]
                                              : diag[i] - diag[j];
            if (dgap > max_gap) continue;
            if (sro[j] <= sro[i]) continue;
            int64_t q_gap = sqo[j] > eqo[i] ? sqo[j] - eqo[i] - 1 : 0;
            int64_t r_gap = sro[j] > ero[i] ? sro[j] - ero[i] - 1 : 0;
            if ((q_gap < r_gap ? q_gap : r_gap) > max_desert) continue;
            int64_t q_ov = eqo[i] >= sqo[j] ? eqo[i] - sqo[j] + 1 : 0;
            int64_t r_ov = ero[i] >= sro[j] ? ero[i] - sro[j] + 1 : 0;
            int64_t newbases = length_w[j] - (q_ov > r_ov ? q_ov : r_ov);
            if (newbases < 1) continue;
            int64_t gap_cost = dgap > 0 ? -(go_cost + dgap * ge_cost) : 0;
            int64_t new_score = best_score[i] + newbases * m_score
                                + gap_cost;
            if (best_score[j] > new_score) continue;
            if (best_score[j] == new_score) {
                int64_t p = prev_idx[j];
                if (p < 0) continue;
                // Tie cascade vs the stored prev (GraphPath.cpp:239-251).
                int64_t pdd = diag[p] >= diag[j] ? diag[p] - diag[j]
                                                 : diag[j] - diag[p];
                int64_t diag_cmp = dgap - pdd;
                if (diag_cmp > 0) continue;
                if (diag_cmp == 0) {
                    int64_t pgap = sqo[j] > eqo[p] ? sqo[j] - eqo[p] - 1
                                                   : 0;
                    int64_t gap_cmp = q_gap - pgap;
                    if (gap_cmp > 0) continue;
                    if (gap_cmp == 0 && path_sqo[i] <= path_sqo[p])
                        continue;
                }
            }
            best_score[j] = yt_wrap_i16(new_score);
            prev_idx[j] = i;
            path_length[j] = path_length[i] + 1;
            path_sqo[j] = path_sqo[i];
        }
    }
    // Best-node fold in ascending order (GraphPath.cpp:259-266).
    int64_t best = -1, best_sc = -(0x7FFFFF00ll);
    for (int64_t i = 0; i < n; i++) {
        if (best_score[i] < best_sc) continue;
        if (best_score[i] > best_sc ||
            (eqo[i] != eqo[best] ? eqo[i] < eqo[best]
                                 : path_sqo[i] > path_sqo[best])) {
            best = i;
            best_sc = best_score[i];
        }
    }
    return best;
}

// ---------- fragment -> clump stage ----------
//
// processFragmentsGapped / processFragmentRangeUsingGraph / insertFragment
// / cleanUpClump / eliminateFragments (QueryMatch.c:146-303,
// GraphPath.cpp:161-292, AlignHelpers.c:48-193) for one strand of one
// read, operating on fragment SoA.  Fragments keep the q_len == ref_len
// invariant during chaining (raw exact-match runs; chops shrink both), so
// one length suffices.  Chop mutations on the incoming fragment persist
// in the shared arrays across extraction rounds, exactly like the
// reference (the chop writes back to the per-strand fragment array).

namespace {

struct CFrag { int64_t sqo, eqo, sro; };

static inline int64_t f_len(const CFrag& f) { return f.eqo - f.sqo + 1; }
static inline int64_t f_ero(const CFrag& f) {
    return (f.sro + f_len(f) - 1) & 0xFFFFFFFFll;
}
static inline int64_t f_diag(const CFrag& f) {
    return (f.sro - f.sqo) & 0xFFFFFFFFll;
}
static inline int64_t adiff(int64_t a, int64_t b) {
    return a >= b ? a - b : b - a;
}
static inline int64_t cgap(int64_t a, int64_t b) {
    return b > a ? b - a - 1 : 0;
}
static inline int64_t cover(int64_t low, int64_t high) {  // calcOverlap
    return low >= high ? low - high + 1 : 0;
}

// cleanUpClump (AlignHelpers.c:92-193) over the clump's copied frags.
static void clean_up_clump(std::vector<CFrag>& v, int64_t wl,
                           int64_t max_gap, int64_t band_width) {
    int64_t p1 = 0, p2 = (int64_t)v.size() > 1 ? 1 : -1,
            p3 = (int64_t)v.size() > 2 ? 2 : -1;
    while (p2 >= 0 && p3 >= 0) {
        if (f_len(v[p2]) < wl) {
            int64_t ai = p3;
            while (f_len(v[ai]) < wl && ai + 1 < (int64_t)v.size()) ai++;
            int64_t f1_diag = f_diag(v[p1]);
            int64_t anchor_diag = f_diag(v[ai]);
            if (adiff(f1_diag, anchor_diag) <= max_gap) {
                int64_t j = p2;
                while (j != ai) {
                    int64_t dd = f_diag(v[j]);
                    bool mid = !((dd < f1_diag && dd < anchor_diag) ||
                                 (dd > f1_diag && dd > anchor_diag));
                    if (mid || (adiff(f1_diag, dd) <= band_width ||
                                adiff(dd, anchor_diag) <= band_width)) {
                        v.erase(v.begin() + j);
                        ai--;
                    } else {
                        j++;
                    }
                }
            }
            p1 = ai;
            p2 = ai + 1 < (int64_t)v.size() ? ai + 1 : -1;
        } else {
            p1 = p2;
            p2 = p3;
        }
        if (p2 >= 0)
            p3 = p2 + 1 < (int64_t)v.size() ? p2 + 1 : -1;
    }
    // First fragment (vs 2x bandwidth adjacency, AlignHelpers.c:160-176).
    if (v.size() >= 2 && f_len(v[0]) < wl) {
        int64_t q_gap = cgap(v[0].eqo, v[1].sqo);
        int64_t r_gap = cgap(f_ero(v[0]), v[1].sro);
        if ((q_gap == 0 && r_gap <= 2 * band_width) ||
            (r_gap == 0 && q_gap <= 2 * band_width))
            v.erase(v.begin());
    }
    // Last fragment (AlignHelpers.c:178-193).
    if (!v.empty() && f_len(v.back()) < wl) {
        if (v.size() < 2) return;
        const CFrag& a = v[v.size() - 2];
        const CFrag& b = v.back();
        int64_t q_gap = cgap(a.eqo, b.sqo);
        int64_t r_gap = cgap(f_ero(a), b.sro);
        if ((q_gap == 0 && r_gap <= 2 * band_width) ||
            (r_gap == 0 && q_gap <= 2 * band_width))
            v.pop_back();
    }
}

}  // namespace

int64_t yt_frags_to_clumps(
        const int64_t* in_sqo, const int64_t* in_eqo, const int64_t* in_sro,
        int64_t n, int64_t query_len,
        int64_t max_gap, int64_t max_desert, int64_t min_match,
        int64_t min_non_overlap, int64_t m_score, int64_t go_cost,
        int64_t ge_cost, int64_t band_width, int64_t word_len,
        int64_t* out_sqo, int64_t* out_eqo, int64_t* out_sro,
        int64_t* clump_offs, int64_t* clump_matched,
        int64_t cap_frags, int64_t cap_clumps) {
    clump_offs[0] = 0;   // `used` slice bound is valid even with 0 clumps
    static thread_local std::vector<CFrag> frags;
    frags.resize((size_t)n);
    for (int64_t i = 0; i < n; i++)
        frags[i] = CFrag{in_sqo[i], in_eqo[i], in_sro[i]};
    static thread_local std::vector<uint8_t> used, coverage;
    used.assign((size_t)n, 0);
    coverage.assign((size_t)query_len, 0);
    int64_t n_clumps = 0, n_out = 0;

    // Scratch for the chain DP over a region's unused nodes.
    static thread_local std::vector<int64_t> ids, nsqo, neqo, ndiag, nlen,
        nsc, nprev, nplen, npsqo;

    auto emit_clump = [&](const std::vector<CFrag>& v,
                          int64_t matched) -> bool {
        if (n_clumps + 1 >= cap_clumps ||
            n_out + (int64_t)v.size() > cap_frags)
            return false;
        clump_offs[n_clumps] = n_out;
        clump_matched[n_clumps] = matched;
        for (const CFrag& f : v) {
            out_sqo[n_out] = f.sqo;
            out_eqo[n_out] = f.eqo;
            out_sro[n_out] = f.sro;
            n_out++;
        }
        n_clumps++;
        clump_offs[n_clumps] = n_out;
        return true;
    };

    int64_t next_frag = 0;
    while (next_frag < n) {
        int64_t start = next_frag;
        // findAlignableFragsForw (QueryMatch.c:146-158).
        int64_t end = start;
        int64_t cur_diag = f_diag(frags[start]);
        for (int64_t i = start; i < n; i++) {
            int64_t d = f_diag(frags[i]);
            if (adiff(cur_diag, d) > max_gap) { end = i - 1; break; }
            cur_diag = d;
            end = i;
        }
        int64_t num = 1 + end - start;
        if (yt_max_region_frags > 0 && num > yt_max_region_frags) {
            yt_skipped_regions++;
            next_frag = end + 1;
            continue;
        }
        if (num == 1) {
            CFrag& f = frags[start];
            if (f_len(f) >= min_match) {
                std::vector<CFrag> one{f};
                if (!emit_clump(one, f_len(f))) return -1;
            }
        } else {
            // processFragmentRangeUsingGraph (GraphPath.cpp:272-292).
            coverage.assign((size_t)query_len, 0);
            for (;;) {
                ids.clear();
                for (int64_t i = start; i <= end; i++)
                    if (!used[i]) ids.push_back(i);
                if (ids.empty()) break;
                // Sort ascending (SQO, diag) (GraphPath.cpp:148-159).
                std::stable_sort(ids.begin(), ids.end(),
                                 [&](int64_t a, int64_t b) {
                    if (frags[a].sqo != frags[b].sqo)
                        return frags[a].sqo < frags[b].sqo;
                    return f_diag(frags[a]) < f_diag(frags[b]);
                });
                int64_t m = (int64_t)ids.size();
                nsqo.resize(m); neqo.resize(m); ndiag.resize(m);
                nlen.resize(m); nsc.resize(m); nprev.resize(m);
                nplen.resize(m); npsqo.resize(m);
                for (int64_t k = 0; k < m; k++) {
                    const CFrag& f = frags[ids[k]];
                    nsqo[k] = f.sqo; neqo[k] = f.eqo;
                    ndiag[k] = f_diag(f); nlen[k] = f_len(f);
                }
                int64_t best = yt_chain_dp(
                    m, nsqo.data(), neqo.data(), ndiag.data(), nlen.data(),
                    max_gap, max_desert, m_score, go_cost, ge_cost,
                    nsc.data(), nprev.data(), nplen.data(), npsqo.data());
                if (best < 0) break;
                // processBestFragmentPath (GraphPath.cpp:134-146):
                // prepend-insert with overlap chopping
                // (insertFragment, AlignHelpers.c:60-90).
                std::vector<CFrag> clump;
                int64_t matched = 0;
                for (int64_t k = best; k >= 0; k = nprev[k]) {
                    CFrag& f1 = frags[ids[k]];   // shared-array entry
                    if (!clump.empty()) {
                        CFrag& f2 = clump.front();
                        int64_t mo = cover(f1.eqo, f2.sqo);
                        int64_t mo2 = cover(f_ero(f1), f2.sro);
                        if (mo2 > mo) mo = mo2;
                        if (mo > 0) {
                            int64_t l1 = f_len(f1), l2 = f_len(f2);
                            bool chop1 = l1 != l2 ? l1 < l2
                                                  : clump.size() == 1;
                            if (chop1) {
                                f1.eqo -= mo;       // subBack: persists
                            } else {
                                f2.sqo += mo;       // subFront on the copy
                                f2.sro = (f2.sro + mo) & 0xFFFFFFFFll;
                            }
                        }
                    }
                    matched += f_len(f1);
                    clump.insert(clump.begin(), f1);   // copy, prepended
                    if (nprev[k] < 0) break;
                }
                if (matched < min_match) break;   // clump reset: region done
                clean_up_clump(clump, word_len, max_gap, band_width);
                // setCoverage + eliminateFragments (QueryMatch.c:161-215).
                int64_t c_sqo = clump.front().sqo;
                int64_t c_len = clump.back().eqo - c_sqo + 1;
                for (int64_t p = c_sqo; p < c_sqo + c_len && p < query_len;
                     p++)
                    coverage[p] = 1;
                int64_t ml = min_non_overlap - 1;
                for (int64_t i = start; i <= end; i++) {
                    if (used[i]) continue;
                    const CFrag& f = frags[i];
                    bool keep = false;
                    if (f.eqo - f.sqo >= ml) {
                        bool any = false;
                        for (int64_t p = f.sqo; p <= f.sqo + ml; p++)
                            if (coverage[p]) { any = true; break; }
                        if (!any) keep = true;
                        if (!keep) {
                            any = false;
                            for (int64_t p = f.eqo - ml; p <= f.eqo; p++)
                                if (coverage[p]) { any = true; break; }
                            if (!any) keep = true;
                        }
                    }
                    if (!keep) used[i] = 1;
                }
                if (!emit_clump(clump, matched)) return -1;
            }
        }
        next_frag = end + 1;
    }
    return n_clumps;
}

// Fused per-strand front end: seed scan (Query.c:361-412) -> hit
// expansion with the heap pre-seeding phantom quirk (QueryMatch.c:57-69)
// -> (diag,QO) sort on the packed heap key (QueryHeap.inl encodeHeapItem)
// -> fragment coalescing (QueryMatch.c:99-115) -> the fragment->clump
// stage above.  One call replaces the per-read numpy pipeline, whose
// per-op overhead dominates at short read lengths.
static double _now_s() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9;
}

int64_t yt_seed_to_clumps(
        const uint8_t* codes, int64_t q_len, int64_t word_len,
        const uint32_t* so, const uint32_t* roa, int64_t roa_len,
        int64_t max_hits,
        int64_t max_gap, int64_t max_desert, int64_t min_match,
        int64_t min_non_overlap, int64_t m_score, int64_t go_cost,
        int64_t ge_cost, int64_t band_width,
        int64_t* out_sqo, int64_t* out_eqo, int64_t* out_sro,
        int64_t* clump_offs, int64_t* clump_matched,
        int64_t cap_frags, int64_t cap_clumps,
        int64_t* total_hits_out) {
    const int64_t M32 = 0xFFFFFFFFll;
    int64_t n_win = q_len - word_len + 1;
    clump_offs[0] = 0;   // `used` slice bound is valid even with 0 clumps
    *total_hits_out = 0;
    if (n_win <= 0) {
        clump_offs[0] = 0;
        return 0;
    }
    // Rolling hash with bad-window skip.  Seed hits cluster on few
    // diagonals (true-alignment diagonals collect ~wordLen hits each), so
    // instead of sorting every hit, hits are grouped on the fly by an
    // open-addressing diag hash and coalesced into fragments as they
    // stream in (scan order guarantees non-decreasing QO per diagonal,
    // making this exactly equivalent to the former sort+coalesce and to
    // the reference's heap merge, QueryMatch.c:52-121).  Only the final
    // handful of fragment records is sorted.
    const int64_t mask = (1ll << (2 * word_len)) - 1;
    struct Run { int64_t diag, sqo, eqo; };
    struct FR { uint64_t key; int64_t eqo; };
    static thread_local std::vector<Run> runs;
    static thread_local std::vector<FR> frs;
    // Slot = epoch<<32 | diag (diag is uint32): one 64-bit compare per
    // probe, no separate validity check.
    static thread_local std::vector<uint64_t> ht_tag;
    static thread_local std::vector<int32_t> ht_val;
    static thread_local uint32_t epoch = 0;
    static thread_local size_t table_sz = 0;
    if (table_sz == 0 || epoch == 0xFFFFFFFFu) {
        table_sz = table_sz ? table_sz : 2048;
        ht_tag.assign(table_sz, 0);
        ht_val.assign(table_sz, 0);
        epoch = 0;
    }
    runs.clear();
    frs.clear();
    epoch++;
    uint64_t etag = (uint64_t)epoch << 32;
    Prof* const prof = g_prof;   // this thread's slot, if bound

    // Short reads (the common case) skip the diag-hash grouper
    // entirely: every hit is emitted as one packed u64
    // (diag:32 at bits 16..47 | qo:16), the hit keys are radix-sorted,
    // and fragments fall out of a linear coalesce over the sorted keys.
    // At hg scale ~75% of hits are singleton spurious fragments, so the
    // per-hit hash probe + Run update (~75 ns) cost far more than a
    // radix pass over the raw hits.  Scan order is non-decreasing qo,
    // so (diag, qo)-sorted order sees each diagonal's hits in the same
    // sequence the streaming grouper did — the coalesce rule
    // (gap > word_len starts a new fragment) produces identical
    // fragments, already in the (diag, sqo) order downstream expects.
    static thread_local std::vector<uint64_t> hitkeys;
    hitkeys.clear();
    const bool pack16 = q_len <= 0xFFFF;
    auto emit_run = [&](const Run& r) {
        frs.push_back({((uint64_t)r.diag << 32) | (uint64_t)r.sqo,
                       r.eqo});
    };
    auto grow_table = [&]() {
        table_sz *= 2;
        ht_tag.assign(table_sz, 0);
        ht_val.assign(table_sz, 0);
        for (size_t k = 0; k < runs.size(); k++) {
            uint64_t tag = etag | (uint64_t)(uint32_t)runs[k].diag;
            uint64_t hh = (uint64_t)runs[k].diag * 0x9E3779B97F4A7C15ull;
            size_t slot = (size_t)(hh & (table_sz - 1));
            while (ht_tag[slot] >> 32 == epoch)
                slot = (slot + 1) & (table_sz - 1);
            ht_tag[slot] = tag;
            ht_val[slot] = (int32_t)k;
        }
    };
    // Single-entry cache: successive windows of the same alignment land
    // on the same diagonal (qo and ro advance together).
    int64_t last_diag = -1;
    int32_t last_val = 0;
    auto push_hit = [&](int64_t diag, int64_t qo) {
        int32_t val;
        if (diag == last_diag) {
            val = last_val;
        } else {
            uint64_t tag = etag | (uint64_t)(uint32_t)diag;
            uint64_t hh = (uint64_t)diag * 0x9E3779B97F4A7C15ull;
            size_t slot = (size_t)(hh & (table_sz - 1));
            uint64_t t;
            while ((t = ht_tag[slot]) != tag && (t >> 32) == epoch)
                slot = (slot + 1) & (table_sz - 1);
            if (t != tag) {
                ht_tag[slot] = tag;
                ht_val[slot] = (int32_t)runs.size();
                last_diag = diag;
                last_val = (int32_t)runs.size();
                runs.push_back({diag, qo, qo});
                if (runs.size() * 2 > table_sz) {
                    grow_table();
                }
                return;
            }
            val = ht_val[slot];
            last_diag = diag;
            last_val = val;
        }
        Run& r = runs[(size_t)val];
        if (qo - r.eqo > word_len) {
            emit_run(r);
            r.sqo = qo;
            r.eqo = qo;
        } else {
            r.eqo = qo;
        }
    };

    double _t0 = prof ? _now_s() : 0;
    // Three passes so the SO and ROA random accesses (the memory-latency
    // wall of the seed phase) are software-prefetched ahead:
    //   A: rolling hash -> per-window hash codes
    //   B: SO lookups (prefetch distance 16) -> (qo, off, cnt) runs
    //   C: ROA gathers (prefetch distance 4 runs) -> fragment grouper
    static thread_local std::vector<int32_t> win_h;
    static thread_local std::vector<int32_t> run_qo;
    static thread_local std::vector<int64_t> run_off;
    static thread_local std::vector<int32_t> run_cnt;
    win_h.assign((size_t)n_win, -1);
    run_qo.clear(); run_off.clear(); run_cnt.clear();
    {
        int64_t h = 0;
        int64_t good = 0;             // clean codes accumulated
        for (int64_t p = 0; p < q_len; p++) {
            uint8_t c = codes[p];
            if (c > 3) { good = 0; h = 0; continue; }
            h = ((h << 2) | c) & mask;
            if (++good < word_len) continue;
            win_h[(size_t)(p - word_len + 1)] = (int32_t)h;
        }
    }
    double _ta = prof ? _now_s() : 0;
    int64_t total_hits = 0;
    {
        const int64_t PD = 64;
        run_qo.reserve((size_t)n_win);
        run_off.reserve((size_t)n_win);
        run_cnt.reserve((size_t)n_win);
        // Warm-up burst: the in-loop prefetch only covers iteration
        // i+PD, so without this the first PD lookups of every read are
        // latency-exposed — at 100 bp (n_win ~ 90) that is most of the
        // read.
        for (int64_t i = 0; i < n_win && i < PD; i++)
            if (win_h[(size_t)i] >= 0)
                __builtin_prefetch(&so[win_h[(size_t)i]]);
        for (int64_t i = 0; i < n_win; i++) {
            if (i + PD < n_win && win_h[(size_t)(i + PD)] >= 0)
                __builtin_prefetch(&so[win_h[(size_t)(i + PD)]]);
            int32_t h = win_h[(size_t)i];
            if (h < 0) continue;
            int64_t cnt = (int64_t)so[h + 1] - (int64_t)so[h];
            if (cnt <= 0 || cnt > max_hits) continue;
            total_hits += cnt;
            run_qo.push_back((int32_t)i);
            run_off.push_back((int64_t)so[h]);
            run_cnt.push_back((int32_t)cnt);
        }
    }
    double _tb = prof ? _now_s() : 0;
    // The hit-sort path materializes every hit (8 B each); a
    // pathological repeat read under a permissive max_hits can pass
    // billions of hits through the scan, which the streaming grouper
    // absorbs in O(#fragments) memory.  Route such reads (and >64 kb
    // reads, whose qo doesn't fit 16 bits) to the grouper; both paths
    // produce identical fragments.
    static const int64_t sort_hits_cap = []() {
        const char* e = getenv("YT_SORT_HITS_CAP");   // test hook
        return e ? atoll(e) : (int64_t)1 << 23;
    }();
    const bool sort_hits = pack16 && total_hits <= sort_hits_cap;
    {
        // Two prefetch depths: a deep one to start the DRAM+TLB access
        // early (each run is a fresh random line in a 3 Gbp-scale ROA,
        // so the page walk dominates) and a shallow second line for
        // runs spilling past one cache line (16 u32 entries).
        const size_t PD = 16, PD2 = 6;
        const size_t n_runs = run_qo.size();
        // Warm-up burst for the first PD runs (see the SO pass above).
        for (size_t t = 0; t < n_runs && t < PD; t++)
            __builtin_prefetch(&roa[run_off[t]]);
        if (sort_hits) {
            // Emit order is irrelevant (the keys are fully sorted next),
            // so main-run hits stream through a restrict pointer into a
            // pre-sized buffer (push_back's end-pointer reload defeats
            // the gather's store pipelining) and the rare all-wrapped
            // continuation hits collect separately and are appended.
            hitkeys.resize((size_t)total_hits);
            uint64_t* __restrict__ hp = hitkeys.data();
            static thread_local std::vector<uint64_t> extra_hits;
            extra_hits.clear();
            const uint32_t* __restrict__ roap = roa;
            for (size_t t = 0; t < n_runs; t++) {
                if (t + PD < n_runs)
                    __builtin_prefetch(&roap[run_off[t + PD]]);
                if (t + PD2 < n_runs && run_cnt[t + PD2] > 16)
                    __builtin_prefetch(&roap[run_off[t + PD2] + 16]);
                uint64_t qo = (uint64_t)run_qo[t];
                int64_t off = run_off[t];
                int64_t cnt = run_cnt[t];
                bool any_ok = false;
                for (int64_t j = off; j < off + cnt; j++) {
                    int64_t ro = roap[j];
                    any_ok |= ro >= (int64_t)qo;
                    *hp++ = ((((uint64_t)ro - qo) & (uint64_t)M32) << 16) | qo;
                }
                if (!any_ok) {
                    // All-wrapped run: the reference heap pre-seed reads
                    // past the run into the next k-mer's ROA until one
                    // entry >= qo.
                    for (int64_t j = off + cnt; j < roa_len; j++) {
                        int64_t ro = roap[j];
                        extra_hits.push_back(
                            ((((uint64_t)ro - qo) & (uint64_t)M32) << 16) |
                            qo);
                        if (ro >= (int64_t)qo) break;
                    }
                }
            }
            hitkeys.insert(hitkeys.end(), extra_hits.begin(),
                           extra_hits.end());
        } else
        for (size_t t = 0; t < n_runs; t++) {
            if (t + PD < n_runs)
                __builtin_prefetch(&roa[run_off[t + PD]]);
            if (t + PD2 < n_runs && run_cnt[t + PD2] > 16)
                __builtin_prefetch(&roa[run_off[t + PD2] + 16]);
            int64_t qo = run_qo[t];
            int64_t off = run_off[t];
            int64_t cnt = run_cnt[t];
            bool any_ok = false;
            for (int64_t j = off; j < off + cnt; j++) {
                int64_t ro = roa[j];
                if (ro >= qo) any_ok = true;
                push_hit((ro - qo) & M32, qo);
            }
            if (!any_ok) {
                // All-wrapped run: the reference heap pre-seed reads past
                // the run into the next k-mer's ROA until one entry >= qo.
                for (int64_t j = off + cnt; j < roa_len; j++) {
                    int64_t ro = roa[j];
                    push_hit((ro - qo) & M32, qo);
                    if (ro >= qo) break;
                }
            }
        }
    }
    *total_hits_out = total_hits;
    double _t1 = prof ? _now_s() : 0;
    if (prof) {
        prof->scan_hash += _ta - _t0;
        prof->scan_so += _tb - _ta;
        prof->scan_roa += _t1 - _tb;
        prof->hits += total_hits;
    }
    if (sort_hits ? hitkeys.empty() : runs.empty()) {
        clump_offs[0] = 0;
        return 0;
    }
    for (const Run& r : runs) emit_run(r);
    static thread_local std::vector<int64_t> fsqo, feqo, fsro;
    fsqo.clear(); feqo.clear(); fsro.clear();
    if (sort_hits) {
        // Sort the raw hit keys (diag:32 at bits 16..47 | qo:16); each
        // genome position occurs once in the ROA, so keys are unique
        // and ascending key order = (diag, qo) lexicographic.
        size_t nh = hitkeys.size();
        const uint64_t* sorted = hitkeys.data();
        if (nh >= 131072) {
            // Huge sets: 3x16-bit LSD passes.  The 3*65536 counter
            // clear + prefix (~400K ops) only pays for itself above
            // ~128K keys.
            static thread_local std::vector<uint64_t> tmp;
            tmp.resize(nh);
            uint64_t* a = hitkeys.data();
            uint64_t* b = tmp.data();
            static thread_local std::vector<uint32_t> cnt;
            cnt.assign(3 * 65536, 0);
            uint32_t* c0 = cnt.data();
            uint32_t* c16 = cnt.data() + 65536;
            uint32_t* c32 = cnt.data() + 2 * 65536;
            for (size_t t = 0; t < nh; t++) {
                uint64_t k = a[t];
                c0[k & 0xFFFF]++;
                c16[(k >> 16) & 0xFFFF]++;
                c32[(k >> 32) & 0xFFFF]++;
            }
            for (int pass = 0; pass < 3; pass++) {
                uint32_t* c = cnt.data() + pass * 65536;
                uint32_t sum = 0;
                for (int v = 0; v < 65536; v++) {
                    uint32_t t = c[v]; c[v] = sum; sum += t;
                }
            }
            int shift[3] = {0, 16, 32};
            for (int pass = 0; pass < 3; pass++) {
                uint32_t* c = cnt.data() + pass * 65536;
                int s = shift[pass];
                for (size_t t = 0; t < nh; t++)
                    b[c[(a[t] >> s) & 0xFFFF]++] = a[t];
                std::swap(a, b);
            }
            sorted = a;   // odd pass count: sorted data sits in tmp
        } else if (nh > 192) {
            // Per-read common case at hg scale (~5-60K hits): 6x8-bit
            // LSD passes keep the counter footprint at 6x256 so the
            // fixed cost per read is ~1.5K ops, not ~400K.  Passes
            // whose digit is constant across all keys (frequent in the
            // high diag bytes and the qo high byte for short reads)
            // are skipped.
            static thread_local std::vector<uint64_t> tmp;
            tmp.resize(nh);
            uint64_t* a = hitkeys.data();
            uint64_t* b = tmp.data();
            uint32_t cnt8[6][256];
            memset(cnt8, 0, sizeof cnt8);
            for (size_t t = 0; t < nh; t++) {
                uint64_t k = a[t];
                cnt8[0][k & 0xFF]++; k >>= 8;
                cnt8[1][k & 0xFF]++; k >>= 8;
                cnt8[2][k & 0xFF]++; k >>= 8;
                cnt8[3][k & 0xFF]++; k >>= 8;
                cnt8[4][k & 0xFF]++; k >>= 8;
                cnt8[5][k & 0xFF]++;
            }
            for (int pass = 0; pass < 6; pass++) {
                uint32_t* c = cnt8[pass];
                int s = 8 * pass;
                if (c[(a[0] >> s) & 0xFF] == nh)
                    continue;   // constant digit: already in order
                uint32_t sum = 0;
                for (int v = 0; v < 256; v++) {
                    uint32_t t = c[v]; c[v] = sum; sum += t;
                }
                for (size_t t = 0; t < nh; t++)
                    b[c[(a[t] >> s) & 0xFF]++] = a[t];
                std::swap(a, b);
            }
            sorted = a;
        } else {
            std::sort(hitkeys.begin(), hitkeys.end());
        }
        // Linear coalesce over sorted hits: within a diagonal, a qo gap
        // > word_len starts a new fragment (identical rule to the
        // streaming grouper, QueryMatch.c:52-121 analog).
        fsqo.reserve(nh); feqo.reserve(nh); fsro.reserve(nh);
        uint64_t cur_diag = sorted[0] >> 16;
        int64_t cur_sqo = (int64_t)(sorted[0] & 0xFFFFull);
        int64_t cur_eqo = cur_sqo;
        for (size_t t = 1; t < nh; t++) {
            uint64_t k = sorted[t];
            uint64_t diag = k >> 16;
            int64_t qo = (int64_t)(k & 0xFFFFull);
            if (diag != cur_diag || qo - cur_eqo > word_len) {
                fsqo.push_back(cur_sqo);
                feqo.push_back(cur_eqo + word_len - 1);
                fsro.push_back((int64_t)((cur_diag + (uint64_t)cur_sqo) &
                                         (uint64_t)M32));
                cur_diag = diag;
                cur_sqo = qo;
                cur_eqo = qo;
            } else {
                cur_eqo = qo;
            }
        }
        fsqo.push_back(cur_sqo);
        feqo.push_back(cur_eqo + word_len - 1);
        fsro.push_back((int64_t)((cur_diag + (uint64_t)cur_sqo) &
                                 (uint64_t)M32));
    } else {
        std::sort(frs.begin(), frs.end(),
                  [](const FR& a, const FR& b) { return a.key < b.key; });
        for (const FR& fr : frs) {
            int64_t diag = (int64_t)(fr.key >> 32);
            int64_t sqo = (int64_t)(fr.key & 0xFFFFFFFFull);
            fsqo.push_back(sqo);
            feqo.push_back(fr.eqo + word_len - 1);
            fsro.push_back((diag + sqo) & M32);
        }
    }

    double _t2 = prof ? _now_s() : 0;
    if (prof) {
        prof->sort += _t2 - _t1;
        prof->frags += (int64_t)fsqo.size();
    }
    int64_t _rv = yt_frags_to_clumps(
        fsqo.data(), feqo.data(), fsro.data(), (int64_t)fsqo.size(), q_len,
        max_gap, max_desert, min_match, min_non_overlap, m_score, go_cost,
        ge_cost, band_width, word_len,
        out_sqo, out_eqo, out_sro, clump_offs, clump_matched,
        cap_frags, cap_clumps);
    if (prof) prof->f2c += _now_s() - _t2;
    return _rv;
}

// Device-fed variant of the front end: the seed scan + ROA expansion +
// (diag, qo) sort already ran on the accelerator (ops/seeds_jax.py /
// parallel/mesh.sharded_expand_sort, the TP-analog sharded-index lookup)
// and hands back per-strand hit arrays sorted by (diag uint32 asc, qo
// asc) — the exact order the reference heap merge visits hits
// (QueryMatch.c:52-121).  This entry runs only the coalesce (qo gap >
// word_len on a diagonal starts a new fragment) and the fragment->clump
// stage, so the staged product pipeline composes with the sharded-index
// seed phase with zero per-read Python.
int64_t yt_hits_to_clumps(
        const uint32_t* hits_diag, const int32_t* hits_qo, int64_t n_hits,
        int64_t q_len, int64_t word_len,
        int64_t max_gap, int64_t max_desert, int64_t min_match,
        int64_t min_non_overlap, int64_t m_score, int64_t go_cost,
        int64_t ge_cost, int64_t band_width,
        int64_t* out_sqo, int64_t* out_eqo, int64_t* out_sro,
        int64_t* clump_offs, int64_t* clump_matched,
        int64_t cap_frags, int64_t cap_clumps) {
    const int64_t M32 = 0xFFFFFFFFll;
    clump_offs[0] = 0;
    if (n_hits <= 0) return 0;
    static thread_local std::vector<int64_t> fsqo, feqo, fsro;
    fsqo.clear(); feqo.clear(); fsro.clear();
    uint64_t cur_diag = hits_diag[0];
    int64_t cur_sqo = hits_qo[0];
    int64_t cur_eqo = cur_sqo;
    for (int64_t t = 1; t < n_hits; t++) {
        uint64_t diag = hits_diag[t];
        int64_t qo = hits_qo[t];
        if (diag != cur_diag || qo - cur_eqo > word_len) {
            fsqo.push_back(cur_sqo);
            feqo.push_back(cur_eqo + word_len - 1);
            fsro.push_back((int64_t)((cur_diag + (uint64_t)cur_sqo) &
                                     (uint64_t)M32));
            cur_diag = diag;
            cur_sqo = qo;
            cur_eqo = qo;
        } else {
            cur_eqo = qo;
        }
    }
    fsqo.push_back(cur_sqo);
    feqo.push_back(cur_eqo + word_len - 1);
    fsro.push_back((int64_t)((cur_diag + (uint64_t)cur_sqo) &
                             (uint64_t)M32));
    if (g_prof) g_prof->frags += (int64_t)fsqo.size();
    return yt_frags_to_clumps(
        fsqo.data(), feqo.data(), fsro.data(), (int64_t)fsqo.size(), q_len,
        max_gap, max_desert, min_match, min_non_overlap, m_score, go_cost,
        ge_cost, band_width, word_len,
        out_sqo, out_eqo, out_sro, clump_offs, clump_matched,
        cap_frags, cap_clumps);
}

// Gap-collection stage for all clumps of one read
// (alignClump's pre-DP stages, AlignHelpers.c:205-262 /
// AlignExtFrag.cpp:30-48,164-234): neighbor perfect extensions (mutating
// the clump's fragment coords), per-fragment Match run init, then the
// gap cascade interleaving new gap sub-fragments (pure D / pure I / 1,1
// mismatch / DP problem with banded-vs-full band selection).
//
// Degenerate chop offsets (EQO < -1 etc.) bail with -2: the caller's
// Python path reproduces the reference's out-of-buffer walk semantics.
//
// Output sfrag records, flattened with per-clump offsets:
//   kind 0 = match fragment        (eol [M qlen],  score m*qlen)
//   kind 1 = gap delete            (eol [D oplen], score gap cost)
//   kind 2 = gap insert            (eol [I oplen], score gap cost)
//   kind 3 = gap 1,1 replace       (eol [R 1],     score -rc)
//   kind 4 = gap DP problem        (aux0/aux1 = leftBW/rightBW)
int64_t yt_collect_gaps(
        const int64_t* cl_offs, int64_t n_clumps,
        int64_t* f_sqo, int64_t* f_eqo, int64_t* f_sro,
        const uint8_t* genome, int64_t genome_len,
        const uint8_t* fwd, const uint8_t* rev, int64_t q_len,
        const uint8_t* cl_rev,
        int64_t m_score, int64_t go_cost, int64_t ge_cost, int64_t r_cost,
        int64_t band_width,
        int64_t* o_offs, int64_t* o_sqo, int64_t* o_eqo, int64_t* o_sro,
        int64_t* o_rlen, int64_t* o_kind, int64_t* o_score,
        int64_t* o_oplen, int64_t* o_aux0, int64_t* o_aux1,
        int64_t cap_out) {
    const int64_t M32 = 0xFFFFFFFFll;
    int64_t n_out = 0;
    for (int64_t k = 0; k < n_clumps; k++) {
        o_offs[k] = n_out;
        const uint8_t* q = cl_rev[k] ? rev : fwd;
        int64_t lo = cl_offs[k], hi = cl_offs[k + 1];
        // Neighbor perfect extensions (AlignHelpers.c:213-222).
        for (int64_t i = lo; i + 1 < hi; i++) {
            int64_t qg = cgap(f_eqo[i], f_sqo[i + 1]);
            int64_t re1 = (f_sro[i] + (f_eqo[i] - f_sqo[i])) & M32;
            int64_t rg = cgap(re1, f_sro[i + 1]);
            int64_t gap = qg < rg ? qg : rg;
            // extendFragmentBackwardToStopPerfectly on frag i+1.
            if (gap > 0) {
                int64_t q_off = f_sqo[i + 1] - 1;
                int64_t r_off = f_sro[i + 1] - 1;
                if (q_off - gap + 1 < 0 || r_off - gap + 1 < 0 ||
                    q_off >= q_len || r_off >= genome_len)
                    return -2;
                int64_t c = 0;
                while (c < gap && q[q_off - c] == genome[r_off - c]) c++;
                if (c > 0) {
                    f_sqo[i + 1] -= c;
                    f_sro[i + 1] = (f_sro[i + 1] - c) & M32;
                    gap -= c;
                }
            }
            // extendFragmentForwardToStopPerfectly on frag i.
            if (gap > 0) {
                int64_t q_off = f_eqo[i] + 1;
                int64_t r_off = ((f_sro[i] + (f_eqo[i] - f_sqo[i])) & M32)
                                + 1;
                if (q_off < 0 || q_off + gap > q_len ||
                    r_off + gap > genome_len || r_off < 0)
                    return -2;
                int64_t c = 0;
                while (c < gap && q[q_off + c] == genome[r_off + c]) c++;
                if (c > 0) f_eqo[i] += c;
            }
        }
        // Match-run init + gap cascade (AlignHelpers.c:224-262).
        for (int64_t i = lo; i < hi; i++) {
            if (n_out + 2 > cap_out) return -1;
            int64_t flen = f_eqo[i] - f_sqo[i] + 1;
            o_sqo[n_out] = f_sqo[i];
            o_eqo[n_out] = f_eqo[i];
            o_sro[n_out] = f_sro[i];
            o_rlen[n_out] = flen;
            o_kind[n_out] = 0;
            o_score[n_out] = m_score * flen;
            o_oplen[n_out] = flen;
            o_aux0[n_out] = 0;
            o_aux1[n_out] = 0;
            n_out++;
            if (i + 1 >= hi) continue;
            int64_t ero1 = (f_sro[i] + (f_eqo[i] - f_sqo[i])) & M32;
            int64_t q_gap = cgap(f_eqo[i], f_sqo[i + 1]);
            int64_t r_gap = cgap(ero1, f_sro[i + 1]);
            if (q_gap == 0 && r_gap == 0) continue;
            int64_t g_sqo = f_eqo[i] + 1;
            int64_t g_eqo = f_sqo[i + 1] - 1;
            int64_t g_sro = (ero1 + 1) & M32;
            int64_t g_rlen = 1 + (f_sro[i + 1] - 1) - g_sro;
            o_sqo[n_out] = g_sqo;
            o_eqo[n_out] = g_eqo;
            o_sro[n_out] = g_sro;
            o_rlen[n_out] = g_rlen;
            o_aux0[n_out] = 0;
            o_aux1[n_out] = 0;
            if (q_gap == 0) {
                o_kind[n_out] = 1;
                o_oplen[n_out] = r_gap;
                o_score[n_out] = r_gap > 0
                    ? -(go_cost + r_gap * ge_cost) : 0;
            } else if (r_gap == 0) {
                o_kind[n_out] = 2;
                o_oplen[n_out] = q_gap;
                o_score[n_out] = q_gap > 0
                    ? -(go_cost + q_gap * ge_cost) : 0;
            } else if (r_gap == 1 && q_gap == 1) {
                o_kind[n_out] = 3;
                o_oplen[n_out] = 1;
                o_score[n_out] = -r_cost;
            } else {
                int64_t len_diff = q_gap > r_gap ? q_gap - r_gap
                                                 : r_gap - q_gap;
                int64_t lbw, rbw;
                if (len_diff + band_width * 2 + 1 < r_gap) {
                    if (r_gap > q_gap) {
                        lbw = band_width;
                        rbw = band_width + (r_gap - q_gap);
                    } else {
                        lbw = band_width + (q_gap - r_gap);
                        rbw = band_width;
                    }
                } else {
                    lbw = rbw = (q_gap > r_gap ? q_gap : r_gap) + 1;
                }
                o_kind[n_out] = 4;
                o_oplen[n_out] = 0;
                o_score[n_out] = 0;
                o_aux0[n_out] = lbw;
                o_aux1[n_out] = rbw;
            }
            n_out++;
        }
    }
    o_offs[n_clumps] = n_out;
    return n_out;
}

// Batched run-length backtrack decodes (SW.cpp:1137-1195).  One call
// decodes every problem of a phase; per-problem runs land in flat
// (ops, lens) arrays with prefix offsets.  Python slices per problem.
// Anchored walk (non-banded arm, SW.cpp:1172-1178) in full coordinates.
int yt_traceback_anchored_batch(const int8_t* eo, const int32_t* idc,
                                const int64_t* qlens, const int64_t* rlens,
                                int64_t n, int64_t eo_h, int64_t eo_w,
                                uint8_t* ops, int32_t* lens,
                                int64_t* offs, int64_t cap) {
    static const char opch[5] = {'U', 'M', 'R', 'I', 'D'};
    int64_t pos = 0;
    for (int64_t k = 0; k < n; k++) {
        offs[k] = pos;
        const int8_t* e = eo + k * eo_h * eo_w;
        const int32_t* d = idc + k * eo_h * eo_w;
        int64_t x = rlens[k], y = qlens[k];
        int prev = e[y * eo_w + x];
        int64_t op_len = 0;
        int64_t start = pos;
        // Emit in walk order (end->start), reversed by the caller.
        for (;;) {
            int code = e[y * eo_w + x];
            if (code == 0) break;        // OP_UNKNOWN
            int64_t length = d[y * eo_w + x];
            if (code == 4) x -= length;              // delete
            else if (code == 3) y -= length;         // insert
            else { x -= 1; y -= 1; length = 1; }
            if (prev != code) {
                if (pos >= cap) return -1;
                ops[pos] = (uint8_t)opch[prev];
                lens[pos++] = (int32_t)op_len;
                prev = code;
                op_len = length;
            } else {
                op_len += length;
            }
        }
        if (pos >= cap) return -1;
        ops[pos] = (uint8_t)opch[prev];
        lens[pos++] = (int32_t)op_len;
        // Reverse to final (front-to-back) order.
        for (int64_t a = start, b = pos - 1; a < b; a++, b--) {
            uint8_t t0 = ops[a]; ops[a] = ops[b]; ops[b] = t0;
            int32_t t1 = lens[a]; lens[a] = lens[b]; lens[b] = t1;
        }
    }
    offs[n] = pos;
    return 0;
}

// Extension walk (banded arm, SW.cpp:1137-1168).  reverse problems keep
// walk order (merge_to_front), forward problems are reversed.  Problems
// with score <= 0 decode to an empty run list.
int yt_traceback_extension_batch(const int8_t* eo, const int32_t* idc,
                                 const int32_t* maxi, const int32_t* maxj,
                                 const int32_t* score,
                                 const uint8_t* reverse,
                                 int64_t n, int64_t eo_h, int64_t eo_w,
                                 uint8_t* ops, int32_t* lens,
                                 int64_t* offs, int64_t cap) {
    static const char opch[5] = {'U', 'M', 'R', 'I', 'D'};
    int64_t pos = 0;
    for (int64_t k = 0; k < n; k++) {
        offs[k] = pos;
        if (score[k] <= 0) continue;
        const int8_t* e = eo + k * eo_h * eo_w;
        const int32_t* d = idc + k * eo_h * eo_w;
        int64_t x = maxj[k], y = maxi[k];
        int prev = e[y * eo_w + x];
        int64_t op_len = 0;
        int64_t start = pos;
        for (;;) {
            int code = e[y * eo_w + x];
            if (code == 0) break;
            int64_t length = d[y * eo_w + x];
            if (code == 4) x -= length;              // delete: left in band
            else if (code == 3) { x += length; y -= length; }  // insert
            else { y -= 1; length = 1; }             // M/R: up
            if (prev != code) {
                if (pos >= cap) return -1;
                ops[pos] = (uint8_t)opch[prev];
                lens[pos++] = (int32_t)op_len;
                prev = code;
                op_len = length;
            } else {
                op_len += length;
            }
        }
        if (pos >= cap) return -1;
        ops[pos] = (uint8_t)opch[prev];
        lens[pos++] = (int32_t)op_len;
        if (!reverse[k]) {
            for (int64_t a = start, b = pos - 1; a < b; a++, b--) {
                uint8_t t0 = ops[a]; ops[a] = ops[b]; ops[b] = t0;
                int32_t t1 = lens[a]; lens[a] = lens[b]; lens[b] = t1;
            }
        }
    }
    offs[n] = pos;
    return 0;
}

// ---- packed-backtrack walkers ----
//
// The Pallas kernels stream one byte per band cell: op in bits 0-2,
// "delete run continues one cell left" in bit 3 (BT_CD), "insert run
// continues up the chain" in bit 4 (BT_CF).  Run lengths are recovered
// by chasing the continue bits, reproducing exactly the IDCount runs the
// unpacked walkers above read (the bits are the forward pass's pd/ii
// counters, ops/sw_pallas.py).
#define YT_BT_OP 7
#define YT_BT_CD 8
#define YT_BT_CF 16

// Extension walk, band coordinates: delete chases left along the row,
// insert chases (y-1, x+1).
int yt_traceback_extension_packed_batch(
        const int8_t* bt, const int32_t* maxi, const int32_t* maxj,
        const int32_t* score, const uint8_t* reverse,
        int64_t n, int64_t eo_h, int64_t eo_w,
        uint8_t* ops, int32_t* lens, int64_t* offs, int64_t cap) {
    static const char opch[5] = {'U', 'M', 'R', 'I', 'D'};
    int64_t pos = 0;
    for (int64_t k = 0; k < n; k++) {
        offs[k] = pos;
        if (score[k] <= 0) continue;
        const int8_t* e = bt + k * eo_h * eo_w;
        int64_t x = maxj[k], y = maxi[k];
        int prev = e[y * eo_w + x] & YT_BT_OP;
        int64_t op_len = 0;
        int64_t start = pos;
        for (;;) {
            int b = e[y * eo_w + x];
            int code = b & YT_BT_OP;
            if (code == 0) break;
            int64_t length = 1;
            if (code == 4) {                         // delete: left in band
                int64_t xx = x;
                while (e[y * eo_w + xx] & YT_BT_CD) { length++; xx--; }
                x -= length;
            } else if (code == 3) {                  // insert: up-right
                int64_t yy = y, xx = x;
                while (e[yy * eo_w + xx] & YT_BT_CF) { length++; yy--; xx++; }
                x += length; y -= length;
            } else {                                 // M/R: up
                y -= 1;
            }
            if (prev != code) {
                if (pos >= cap) return -1;
                ops[pos] = (uint8_t)opch[prev];
                lens[pos++] = (int32_t)op_len;
                prev = code;
                op_len = length;
            } else {
                op_len += length;
            }
        }
        if (pos >= cap) return -1;
        ops[pos] = (uint8_t)opch[prev];
        lens[pos++] = (int32_t)op_len;
        if (!reverse[k]) {
            for (int64_t a = start, b = pos - 1; a < b; a++, b--) {
                uint8_t t0 = ops[a]; ops[a] = ops[b]; ops[b] = t0;
                int32_t t1 = lens[a]; lens[a] = lens[b]; lens[b] = t1;
            }
        }
    }
    offs[n] = pos;
    return 0;
}

// Anchored walk, full coordinates: insert chases straight up the column.
int yt_traceback_anchored_packed_batch(
        const int8_t* bt, const int64_t* qlens, const int64_t* rlens,
        int64_t n, int64_t eo_h, int64_t eo_w,
        uint8_t* ops, int32_t* lens, int64_t* offs, int64_t cap) {
    static const char opch[5] = {'U', 'M', 'R', 'I', 'D'};
    int64_t pos = 0;
    for (int64_t k = 0; k < n; k++) {
        offs[k] = pos;
        const int8_t* e = bt + k * eo_h * eo_w;
        int64_t x = rlens[k], y = qlens[k];
        int prev = e[y * eo_w + x] & YT_BT_OP;
        int64_t op_len = 0;
        int64_t start = pos;
        for (;;) {
            int b = e[y * eo_w + x];
            int code = b & YT_BT_OP;
            if (code == 0) break;
            int64_t length = 1;
            if (code == 4) {                         // delete: left
                int64_t xx = x;
                while (e[y * eo_w + xx] & YT_BT_CD) { length++; xx--; }
                x -= length;
            } else if (code == 3) {                  // insert: up
                int64_t yy = y;
                while (e[yy * eo_w + x] & YT_BT_CF) { length++; yy--; }
                y -= length;
            } else {                                 // M/R: diagonal
                x -= 1; y -= 1;
            }
            if (prev != code) {
                if (pos >= cap) return -1;
                ops[pos] = (uint8_t)opch[prev];
                lens[pos++] = (int32_t)op_len;
                prev = code;
                op_len = length;
            } else {
                op_len += length;
            }
        }
        if (pos >= cap) return -1;
        ops[pos] = (uint8_t)opch[prev];
        lens[pos++] = (int32_t)op_len;
        for (int64_t a = start, b = pos - 1; a < b; a++, b--) {
            uint8_t t0 = ops[a]; ops[a] = ops[b]; ops[b] = t0;
            int32_t t1 = lens[a]; lens[a] = lens[b]; lens[b] = t1;
        }
    }
    offs[n] = pos;
    return 0;
}

// Anchored walk, band-relative coordinates (column o = j - i + lbw):
// delete chases left along the row, insert chases (y-1, o+1).
int yt_traceback_anchored_banded_packed_batch(
        const int8_t* bt, const int64_t* qlens, const int64_t* rlens,
        const int64_t* lbws, int64_t n, int64_t eo_h, int64_t eo_w,
        uint8_t* ops, int32_t* lens, int64_t* offs, int64_t cap) {
    static const char opch[5] = {'U', 'M', 'R', 'I', 'D'};
    int64_t pos = 0;
    for (int64_t k = 0; k < n; k++) {
        offs[k] = pos;
        const int8_t* e = bt + k * eo_h * eo_w;
        int64_t y = qlens[k];
        int64_t o = rlens[k] - y + lbws[k];
        int prev = e[y * eo_w + o] & YT_BT_OP;
        int64_t op_len = 0;
        int64_t start = pos;
        for (;;) {
            int b = e[y * eo_w + o];
            int code = b & YT_BT_OP;
            if (code == 0) break;
            int64_t length = 1;
            if (code == 4) {                         // delete
                int64_t oo = o;
                while (e[y * eo_w + oo] & YT_BT_CD) { length++; oo--; }
                o -= length;
            } else if (code == 3) {                  // insert: up-right
                int64_t yy = y, oo = o;
                while (e[yy * eo_w + oo] & YT_BT_CF) { length++; yy--; oo++; }
                y -= length; o += length;
            } else {                                 // M/R: up (same o)
                y -= 1;
            }
            if (prev != code) {
                if (pos >= cap) return -1;
                ops[pos] = (uint8_t)opch[prev];
                lens[pos++] = (int32_t)op_len;
                prev = code;
                op_len = length;
            } else {
                op_len += length;
            }
        }
        if (pos >= cap) return -1;
        ops[pos] = (uint8_t)opch[prev];
        lens[pos++] = (int32_t)op_len;
        for (int64_t a = start, b = pos - 1; a < b; a++, b--) {
            uint8_t t0 = ops[a]; ops[a] = ops[b]; ops[b] = t0;
            int32_t t1 = lens[a]; lens[a] = lens[b]; lens[b] = t1;
        }
    }
    offs[n] = pos;
    return 0;
}

}  // extern "C"

// ---------- host DP fallbacks ----------
//
// C-speed batched forwards mirroring ops/sw_batch.py semantics (which are
// the reference SW.cpp semantics).  Used by the batch aligner when no TPU
// is attached; the Pallas kernel is the production path.

extern "C" {

static const int32_t DP_WORST = -(0x7FFFFF00);
enum { OP_U = 0, OP_M = 1, OP_R = 2, OP_I = 3, OP_D = 4 };

#ifdef YT_HAVE_AVX512
// Anti-diagonal wavefront fill for ONE banded X-dropoff extension
// problem: a bit-exact reformulation of the scalar row sweep below
// (SW.cpp:959-1094 semantics).  In band coordinates (row i, band column
// j), every cell depends only on earlier anti-diagonals s = 2i + j:
//     match/replace <- (i-1, j)    on s-2
//     delete (E)    <- (i,   j-1)  on s-1   (same row)
//     insert (F)    <- (i-1, j+1)  on s-1   (row above)
// so all cells of one anti-diagonal are independent.  A band of width
// w <= 31 holds at most ceil(w/2) <= 16 active rows per anti-diagonal,
// i.e. one AVX-512 vector covers the whole wavefront step.
//
// The scalar loop's row-major max/argmax (strict >, first cell wins) and
// its per-row X-dropoff exit are reconstructed exactly: per-row maxima
// are tracked with the same strict-> update (within a row, j increases
// with s, preserving scan order), and rows are finalized in increasing i
// as they complete (s_end(i) is strictly increasing in i), applying the
// same `row_max < max - x_cutoff` exit.  On exit, partially-computed
// rows beyond the exit row are re-zeroed.
//
// eo/idc plane contract (per caller):
//  * batch API (yt_extension_forward from host.py): planes arrive
//    zeroed and byte-compare against the scalar fill in A/B tests, so
//    every deviation from zero must match the scalar writer — idc is
//    stored only for D/I cells, and the exit re-zero below erases rows
//    the scalar loop never reached.
//  * pipe ext_dp (yaha_pipe.cpp): the plane is DIRTY (reused across
//    calls, no memset).  Correctness there rests on the backtrack
//    visiting only cells written by THIS call: rows <= the exit row are
//    fully stored, row 0 / the leading OP_I column are primed by the
//    wrapper, and the exit re-zero covers partially-computed rows.
static void ext_wavefront_one(
        const uint8_t* qp, const uint8_t* rp, int32_t qlen, int32_t rlen,
        int bw2, int w, int go, int ge, int rc, int ms,
        int32_t mi_cap, int32_t mg_cap, int x_cutoff,
        int8_t* eop, int32_t* idp,
        int32_t* score_out, int32_t* maxi_out, int32_t* maxj_out) {
    const int32_t WORST = DP_WORST;
    // 11 rolling lane buffers indexed by absolute row i (triple-buffered
    // V, double-buffered E/PD/F/PI), padded so 16-lane unaligned
    // loads/stores at [i-1 .. i+16] never leave the allocation.
    static thread_local std::vector<int32_t> bufs;
    const int64_t stride = (int64_t)qlen + 40;
    if ((int64_t)bufs.size() < stride * 11) bufs.resize(stride * 11);
    int32_t* v0 = bufs.data() + 8;
    int32_t* v1 = v0 + stride;
    int32_t* v2 = v1 + stride;
    int32_t* e0 = v2 + stride;
    int32_t* e1 = e0 + stride;
    int32_t* pd0 = e1 + stride;
    int32_t* pd1 = pd0 + stride;
    int32_t* f0 = pd1 + stride;
    int32_t* f1 = f0 + stride;
    int32_t* pi0 = f1 + stride;
    int32_t* pi1 = pi0 + stride;
    static thread_local std::vector<int32_t> rowm_v, rowj_v;
    if ((int64_t)rowm_v.size() < (int64_t)qlen + 24) {
        rowm_v.resize((size_t)qlen + 24);
        rowj_v.resize((size_t)qlen + 24);
    }
    int32_t* rowm = rowm_v.data();
    int32_t* rowj = rowj_v.data();
    // rowm is initialized incrementally: rows activate one at a time as
    // the anti-diagonal advances (ihi is non-decreasing in s), so the
    // sentinel step below seeds rowm[ihi+1] before that row's first
    // store, and only the first few rows need seeding here.  An O(qlen)
    // init would dominate short X-drop-exited extensions on long reads.
    for (int64_t i = 0; i <= qlen + 1 && i <= 16; i++) rowm[i] = WORST;
    // Prime: v1/e1/f1 hold anti-diagonal bw2+1, v2 holds bw2.
    //   (0, bw2):   V = 0                        [origin]
    //   (0, bw2+1): V = -(go+ge), F = WORST      [row-0 delete boundary]
    //   (1, bw2-0-1=bw2? enter boundary): V(1, start_col(1)-1) = -(go+ge)
    v1[0] = -(go + ge);
    v1[1] = -(go + ge);
    v2[0] = 0;
    f1[0] = WORST;
    pi1[0] = 0;
    e1[1] = WORST;
    pd1[1] = 0;

    const __m512i vge = _mm512_set1_epi32(ge);
    const __m512i vgoge = _mm512_set1_epi32(go + ge);
    const __m512i vms = _mm512_set1_epi32(ms);
    const __m512i vmrc = _mm512_set1_epi32(-rc);
    const __m512i vone = _mm512_set1_epi32(1);
    const __m512i vmi1 = _mm512_set1_epi32(mi_cap - 1);
    const __m512i vmg1 = _mm512_set1_epi32(mg_cap - 1);
    const __m512i vopM = _mm512_set1_epi32(OP_M);
    const __m512i vopR = _mm512_set1_epi32(OP_R);
    const __m512i vopD = _mm512_set1_epi32(OP_D);
    const __m512i vopI = _mm512_set1_epi32(OP_I);
    const __m512i vlane2 = _mm512_setr_epi32(0, 2, 4, 6, 8, 10, 12, 14,
                                             16, 18, 20, 22, 24, 26, 28,
                                             30);
    const __m512i vrev = _mm512_setr_epi32(15, 14, 13, 12, 11, 10, 9, 8,
                                           7, 6, 5, 4, 3, 2, 1, 0);

    const __m512i vstep = _mm512_mullo_epi32(
        _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13,
                          14, 15),
        _mm512_set1_epi32(w - 2));
    int32_t gmax = WORST, gmaxi = 0, gmaxj = 0;
    int64_t next_row = 1;
    bool exited = false;
    const int64_t s_last =
        std::min<int64_t>(2LL * qlen + (w - 1), (int64_t)qlen + bw2 + rlen);
    int64_t s = bw2 + 2;
    int64_t max_touched_row = 0;
    alignas(64) int32_t tmp_op[16];
    for (; s <= s_last; s++) {
        // Active rows on this anti-diagonal.
        int64_t ilo = 1;
        int64_t t = s - w + 1;
        if (t > 0) { int64_t c = (t + 1) >> 1; if (c > ilo) ilo = c; }
        if (s - bw2 - rlen > ilo) ilo = s - bw2 - rlen;
        int64_t ihi = (int64_t)qlen;
        if ((s >> 1) < ihi) ihi = s >> 1;
        if (s - bw2 - 1 < ihi) ihi = s - bw2 - 1;
        if (ihi >= ilo) {
            if (ihi > max_touched_row) max_touched_row = ihi;
            const int nact = (int)(ihi - ilo + 1);
            const __mmask16 amask = (__mmask16)((1u << nact) - 1);
            // q codes: lane l = q[ilo+l-1] (contiguous).
            __m128i qb = _mm_maskz_loadu_epi8(amask, qp + ilo - 1);
            __m512i qv = _mm512_cvtepu8_epi32(qb);
            // r codes: lane l = r[s-bw2-(ilo+l)-1] (contiguous reversed).
            // Valid lanes l < nact read indices >= s-bw2-ihi-1 >= 0; load
            // the 16-byte window ending at s-bw2-ilo-1 with the high-nact
            // byte mask, then reverse lanes.
            const int64_t rbase = s - bw2 - ilo - 1;
            __mmask16 rmask = (__mmask16)(0xFFFFu << (16 - nact));
            __m128i rb = _mm_maskz_loadu_epi8(rmask, rp + rbase - 15);
            __m512i rv = _mm512_permutexvar_epi32(
                vrev, _mm512_cvtepu8_epi32(rb));
            __m512i vd = _mm512_loadu_si512(v2 + ilo - 1);
            __m512i vdel = _mm512_loadu_si512(v1 + ilo);
            __m512i vins = _mm512_loadu_si512(v1 + ilo - 1);
            __m512i e_in = _mm512_loadu_si512(e1 + ilo);
            __m512i pdv = _mm512_loadu_si512(pd1 + ilo);
            __m512i f_in = _mm512_loadu_si512(f1 + ilo - 1);
            __m512i piv = _mm512_loadu_si512(pi1 + ilo - 1);
            __mmask16 meq = _mm512_cmpeq_epi32_mask(qv, rv);
            __m512i g = _mm512_add_epi32(
                vd, _mm512_mask_mov_epi32(vmrc, meq, vms));
            __m512i ce = _mm512_sub_epi32(e_in, vge);
            __m512i ne = _mm512_sub_epi32(vdel, vgoge);
            __mmask16 kd = _mm512_kand(
                _mm512_cmp_epi32_mask(ce, ne, _MM_CMPINT_NLT),
                _mm512_cmp_epi32_mask(pdv, vmi1, _MM_CMPINT_LE));
            __m512i e_o = _mm512_mask_mov_epi32(ne, kd, ce);
            __m512i pd_o = _mm512_mask_add_epi32(vone, kd, pdv, vone);
            __mmask16 td = _mm512_cmp_epi32_mask(e_o, g, _MM_CMPINT_NLT);
            __m512i v1v = _mm512_mask_mov_epi32(g, td, e_o);
            __m512i opv = _mm512_mask_mov_epi32(
                _mm512_mask_mov_epi32(vopR, meq, vopM), td, vopD);
            __m512i idv = _mm512_maskz_mov_epi32(td, pd_o);
            __m512i cf = _mm512_sub_epi32(f_in, vge);
            __m512i nf = _mm512_sub_epi32(vins, vgoge);
            __mmask16 ki = _mm512_kand(
                _mm512_cmp_epi32_mask(cf, nf, _MM_CMPINT_NLT),
                _mm512_cmp_epi32_mask(piv, vmg1, _MM_CMPINT_LE));
            __m512i f_o = _mm512_mask_mov_epi32(nf, ki, cf);
            __m512i pi_o = _mm512_mask_add_epi32(vone, ki, piv, vone);
            __mmask16 ti = _mm512_cmp_epi32_mask(f_o, v1v, _MM_CMPINT_NLT);
            __m512i v2v = _mm512_mask_mov_epi32(v1v, ti, f_o);
            opv = _mm512_mask_mov_epi32(opv, ti, vopI);
            idv = _mm512_mask_mov_epi32(idv, ti, pi_o);
            _mm512_mask_storeu_epi32(v0 + ilo, amask, v2v);
            _mm512_mask_storeu_epi32(e0 + ilo, amask, e_o);
            _mm512_mask_storeu_epi32(pd0 + ilo, amask, pd_o);
            _mm512_mask_storeu_epi32(f0 + ilo, amask, f_o);
            _mm512_mask_storeu_epi32(pi0 + ilo, amask, pi_o);
            // Row-major max: within a row j increases with s, so the
            // strict-> update reproduces the scalar first-cell-wins rule.
            __m512i rmv = _mm512_loadu_si512(rowm + ilo);
            __mmask16 mb = _mm512_kand(
                amask, _mm512_cmp_epi32_mask(v2v, rmv, _MM_CMPINT_NLE));
            _mm512_mask_storeu_epi32(rowm + ilo, mb, v2v);
            __m512i vj = _mm512_sub_epi32(
                _mm512_set1_epi32((int32_t)(s - 2 * ilo)), vlane2);
            _mm512_mask_storeu_epi32(rowj + ilo, mb, vj);
            // eo/idc scatter: lane l -> [(ilo+l)*w + (j0-2l)], stride w-2.
            _mm512_store_si512(tmp_op, opv);
            int8_t* e_sc = eop + ilo * w + (s - 2 * ilo);
            for (int l = 0; l < nact; l++)
                e_sc[(int64_t)l * (w - 2)] = (int8_t)tmp_op[l];
            // idc is written only for D/I cells (the zeroed-plane batch
            // API contract): one masked scatter replaces a branchy
            // per-lane loop.  Lane l's cell is idp[base + l*(w-2)].
            __m512i vidx = _mm512_add_epi32(
                _mm512_set1_epi32((int32_t)(ilo * w + (s - 2 * ilo))),
                vstep);
            _mm512_mask_i32scatter_epi32(
                idp, _mm512_kand(amask, _mm512_kor(td, ti)), vidx, idv, 4);
        }
        // Sentinels for the next two anti-diagonals.
        //  - below the window (lane ilo-1 = virtual cell right of the
        //    band / past rlen), except row 0 cells while s <= w-1;
        //  - above the window (lane ihi+1 = the row about to enter):
        //    its row-start boundary V and a fresh E chain.
        if (ilo == 1 && s <= w - 1) {
            v0[0] = (s == bw2) ? 0
                    : (s > bw2) ? -(go + (int32_t)(s - bw2) * ge)
                                : WORST;
            f0[0] = (s == bw2) ? 0 : WORST;
            pi0[0] = 0;
        } else {
            v0[ilo - 1] = WORST;
            f0[ilo - 1] = WORST;
            pi0[ilo - 1] = 0;
        }
        int64_t i_n = ihi + 1;
        if (i_n >= ilo) {
            v0[i_n] = (i_n <= bw2) ? -(go + (int32_t)i_n * ge) : WORST;
            e0[i_n] = WORST;
            pd0[i_n] = 0;
            // Seed the entering row's rolling max (plus one ahead).
            // Why one-ahead seeding suffices: ihi = min(qlen, s>>1,
            // s-bw2-1) — every term grows by at most 1 per anti-diagonal,
            // so ihi advances by <= 1 and row i_n+1 is always seeded on
            // the step before it can receive its first store.  The
            // active window can also never close and later reopen
            // (ilo and ihi are both monotone in s), so a seeded rowm is
            // never stale.  The finalize loop below exits at the first
            // never-active row, whose rowm was seeded by this one-ahead
            // write.
            if (i_n > 15) rowm[i_n + 1] = WORST;
        }
        // Finalize completed rows in order (the scalar row loop order).
        while (next_row <= qlen) {
            int64_t se = 2 * next_row + (w - 1);
            int64_t se2 = next_row + bw2 + rlen;
            if (se2 < se) se = se2;
            if (se > s) break;
            int32_t rm = rowm[next_row];
            if (rm > gmax) {
                gmax = rm;
                gmaxi = (int32_t)next_row;
                gmaxj = rowj[next_row];
            }
            if (rm < gmax - x_cutoff) { exited = true; break; }
            next_row++;
        }
        if (exited) break;
        // Rotate: v2 <- v1 <- v0 <- (old v2); swap E/PD/F/PI pairs.
        int32_t* tv = v2; v2 = v1; v1 = v0; v0 = tv;
        std::swap(e0, e1);
        std::swap(pd0, pd1);
        std::swap(f0, f1);
        std::swap(pi0, pi1);
    }
    if (exited) {
        // Re-zero rows the scalar loop never reached (it breaks after
        // row next_row): their partially-filled wavefront cells must not
        // survive.  This keeps the batch API's zeroed planes
        // byte-comparable to the scalar fill AND upholds the pipe
        // caller's dirty-plane contract (see the header comment): after
        // this, every non-re-zeroed cell was written by this call.
        for (int64_t i = next_row + 1; i <= max_touched_row; i++) {
            int64_t sc = bw2 + 1 - i; if (sc < 0) sc = 0;
            int64_t ec = bw2 + rlen - i;
            if (ec > w - 1) ec = w - 1;
            if (ec < sc) continue;
            memset(eop + i * w + sc, 0, (size_t)(ec - sc + 1));
            memset(idp + i * w + sc, 0, (size_t)(ec - sc + 1) * 4);
        }
    }
    *score_out = gmax;
    *maxi_out = gmaxi;
    *maxj_out = gmaxj;
}
#endif  // YT_HAVE_AVX512

// Banded X-dropoff extension forward for n problems.
//   q[n*qlmax], r[n*rlmax] (rlmax >= qlmax + 2*bw2), row-major uint8.
//   eo [n*(qlmax+1)*w] int8, idc [...] int32, score/maxi/maxj [n] int32.
int yt_extension_forward(const uint8_t* q, const int32_t* qlens,
                         const uint8_t* r, const int32_t* rlens,
                         int64_t n, int64_t qlmax, int64_t rlmax,
                         int band_width, int go, int ge, int rc, int ms,
                         int max_gap, int max_intron, int x_cutoff,
                         int8_t* eo, int32_t* idc, int32_t* score,
                         int32_t* maxi_out, int32_t* maxj_out) {
    const int bw2 = 2 * band_width;
    const int w = 2 * bw2 + 1;
#ifdef YT_HAVE_AVX512
    // The anti-diagonal wavefront covers bands up to 31 wide (<= 16
    // active rows per anti-diagonal) in one AVX-512 vector step;
    // YT_NO_WAVE=1 forces the scalar sweep (A/B parity testing).
    static const bool no_wave = [] {
        const char* e = getenv("YT_NO_WAVE");
        return e && *e && *e != '0';
    }();
    // The idc scatter computes lane indices in int32
    // (base = ilo*w + s - 2*ilo), so the backtrack plane must stay
    // int32-addressable: (qlmax+1)*w < 2^31 (~69 Mbp rows at w=31 —
    // far beyond any read, but guard rather than silently truncate).
    const bool use_wave = (w <= 31) && !no_wave &&
        ((qlmax + 1) * (int64_t)w < (1ll << 31));
#else
    const bool use_wave = false;
#endif
    static thread_local std::vector<int32_t> pv, pf, pi;
    pv.resize((size_t)w + 2); pf.resize((size_t)w + 2);
    pi.resize((size_t)w + 2);
    for (int64_t kk = 0; kk < n; kk++) {
        const uint8_t* qp = q + kk * qlmax;
        const uint8_t* rp = r + kk * rlmax;
        int32_t qlen = qlens[kk];
        int32_t rlen = rlens[kk];
        int8_t* eop = eo + kk * (qlmax + 1) * w;
        int32_t* idp = idc + kk * (qlmax + 1) * w;
        // Row 0 init.
        for (int j = 0; j < w; j++) {
            if (j > bw2) {
                pv[j] = -(go + (j - bw2) * ge);
                eop[j] = OP_D;
                idp[j] = j - bw2;
            } else {
                pv[j] = (j == bw2) ? 0 : DP_WORST;
                eop[j] = OP_U;
                idp[j] = 0;
            }
            pf[j] = (j == bw2) ? 0 : DP_WORST;
            pi[j] = 0;
        }
        pv[w] = DP_WORST; pf[w] = DP_WORST; pi[w] = 0;
        for (int i = 1; i <= bw2 && i <= (int)qlmax; i++) {
            eop[(int64_t)i * w + (bw2 - i)] = OP_I;
            idp[(int64_t)i * w + (bw2 - i)] = i;
        }
#ifdef YT_HAVE_AVX512
        if (use_wave && qlen >= 1 && rlen >= 1) {
            int32_t mi_cap = (int32_t)std::min<int64_t>(
                (int64_t)max_intron, 0x3FFFFFFF);
            int32_t mg_cap = (int32_t)std::min<int64_t>(
                (int64_t)max_gap, 0x3FFFFFFF);
            ext_wavefront_one(qp, rp, qlen, rlen, bw2, w, go, ge, rc, ms,
                              mi_cap, mg_cap, x_cutoff, eop, idp,
                              &score[kk], &maxi_out[kk], &maxj_out[kk]);
            continue;
        }
#endif
        int32_t max_score = DP_WORST, maxi = 0, maxj = 0;
        int32_t* __restrict__ pvp = pv.data();
        int32_t* __restrict__ pfp = pf.data();
        int32_t* __restrict__ pip = pi.data();
        for (int i = 1; i <= qlen; i++) {
            int start_col = bw2 + 1 - i;
            int32_t pv_col;
            if (start_col <= 0) { start_col = 0; pv_col = DP_WORST; }
            else { pv_col = -(go + i * ge); pvp[start_col - 1] = pv_col; }
            int end_col = bw2 + rlen - i;
            if (end_col > w - 1) end_col = w - 1;
            int32_t pe_col = DP_WORST, pd_col = 0;
            int32_t row_max = DP_WORST;
            int q_char = qp[i - 1];
            int8_t* __restrict__ eor = eop + (int64_t)i * w;
            int32_t* __restrict__ idr = idp + (int64_t)i * w;
            const uint8_t* __restrict__ rrow = rp + i - bw2 - 1;
            for (int j = start_col; j <= end_col; j++) {
                int32_t v = pvp[j];
                // ref index = i - bw2 - 1 + j; in range when
                // j >= start_col.
                int r_char = rrow[j];
                int8_t opcode;
                int32_t cell_idc = 0;
                int32_t g = (q_char == r_char) ? v + ms : v - rc;
                opcode = (q_char == r_char) ? OP_M : OP_R;
                int32_t ce = pe_col - ge;
                int32_t ne = pv_col - (go + ge);
                if (ce >= ne && pd_col + 1 <= max_intron) {
                    pe_col = ce; pd_col += 1;
                } else { pe_col = ne; pd_col = 1; }
                int32_t v1;
                if (pe_col >= g) { v1 = pe_col; opcode = OP_D;
                                   cell_idc = pd_col; }
                else v1 = g;
                int32_t cf = pfp[j + 1] - ge;
                int32_t nf = pvp[j + 1] - (go + ge);
                int32_t f, ii;
                if (cf >= nf && pip[j + 1] + 1 <= max_gap) {
                    f = cf; ii = pip[j + 1] + 1;
                } else { f = nf; ii = 1; }
                int32_t v2;
                if (f >= v1) { v2 = f; opcode = OP_I; cell_idc = ii; }
                else v2 = v1;
                pfp[j] = f;
                pip[j] = ii;
                eor[j] = opcode;
                if (opcode >= OP_I) idr[j] = cell_idc;
                if (v2 > row_max) row_max = v2;
                if (v2 > max_score) { max_score = v2; maxi = i; maxj = j; }
                pvp[j] = v2;
                pv_col = v2;
            }
            if (row_max < max_score - x_cutoff) break;
        }
        score[kk] = max_score;
        maxi_out[kk] = maxi;
        maxj_out[kk] = maxj;
    }
    return 0;
}

// Anchored (gap-fill) masked full-matrix forward for n problems; per
// problem left/right bandwidths (see batched_anchored_forward).
//   eo/idc are [n*(qlmax+1)*(rlmax+1)].
int yt_anchored_forward(const uint8_t* q, const int32_t* qlens,
                        const uint8_t* r, const int32_t* rlens,
                        const int32_t* lbws, const int32_t* rbws,
                        int64_t n, int64_t qlmax, int64_t rlmax,
                        int go, int ge, int rc, int ms,
                        int max_gap, int max_intron,
                        int8_t* eo, int32_t* idc, int32_t* score) {
    int64_t wid = rlmax + 1;
    static thread_local std::vector<int32_t> pv, pf, pi, v_new;
    pv.resize((size_t)wid + 1); pf.resize((size_t)wid + 1);
    pi.resize((size_t)wid + 1); v_new.resize((size_t)wid + 1);
    for (int64_t kk = 0; kk < n; kk++) {
        const uint8_t* qp = q + kk * qlmax;
        const uint8_t* rp = r + kk * rlmax;
        int32_t qlen = qlens[kk], rlen = rlens[kk];
        int32_t lbw = lbws[kk], rbw = rbws[kk];
        int8_t* eop = eo + kk * (qlmax + 1) * wid;
        int32_t* idp = idc + kk * (qlmax + 1) * wid;
        for (int64_t j = 0; j <= wid; j++) {
            if (j >= 1 && j <= rbw && j <= rlen && j < wid) {
                pv[j] = -(go + (int32_t)j * ge);
                eop[j] = OP_D;
                idp[j] = (int32_t)j;
            } else {
                pv[j] = (j == 0) ? 0 : DP_WORST;
                if (j < wid) { eop[j] = OP_U; idp[j] = 0; }
            }
            pf[j] = DP_WORST;
            pi[j] = 0;
        }
        int32_t* __restrict__ pvp = pv.data();
        int32_t* __restrict__ vnp = v_new.data();
        int32_t* __restrict__ pfp = pf.data();
        int32_t* __restrict__ pip = pi.data();
        for (int i = 1; i <= qlen; i++) {
            int8_t* __restrict__ eorow = eop + (int64_t)i * wid;
            int32_t* __restrict__ idrow = idp + (int64_t)i * wid;
            // Column-0 insert boundary while within the left band.
            if (i <= lbw) { eorow[0] = OP_I; idrow[0] = i; }
            else { eorow[0] = OP_U; idrow[0] = 0; }
            int64_t jlo = (int64_t)i - lbw; if (jlo < 1) jlo = 1;
            int64_t jhi = (int64_t)i + rbw; if (jhi > rlen) jhi = rlen;
            // Out-of-band opcode padding (OP_U = 0); idc there is never
            // read (backtrack stops at OP_U).
            if (jlo > 1) {
                int64_t hi = jlo < wid ? jlo : wid;
                memset(eorow + 1, 0, (size_t)(hi - 1));
            }
            if (jhi + 1 < wid)
                memset(eorow + jhi + 1, 0, (size_t)(wid - jhi - 1));
            int q_char = qp[i - 1];
            int32_t pe_col = DP_WORST, pd_col = 0;
            int32_t pv_col = (i <= lbw) ? -(go + i * ge) : DP_WORST;
            // Row value maintenance is band-local: the next row only reads
            // positions [jlo'-1, jhi'] (plus column 0), all written here.
            vnp[0] = (i <= lbw) ? -(go + i * ge) : pvp[0];
            if (jlo - 1 >= 1 && jlo - 1 <= wid) vnp[jlo - 1] = DP_WORST;
            if (jhi + 1 >= 0 && jhi + 1 <= wid) vnp[jhi + 1] = DP_WORST;
            for (int64_t j = jlo; j <= jhi; j++) {
                int32_t v = pvp[j - 1];
                int r_char = rp[j - 1];
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
                int32_t cf = pfp[j] - ge;
                int32_t nf = pvp[j] - (go + ge);
                int32_t f, ii;
                if (cf >= nf && pip[j] + 1 <= max_gap) {
                    f = cf; ii = pip[j] + 1;
                } else { f = nf; ii = 1; }
                int32_t v2;
                if (f > v1) { v2 = f; opcode = OP_I; cell_idc = ii; }
                else v2 = v1;
                pfp[j] = f;
                pip[j] = ii;
                eorow[j] = opcode;
                if (opcode >= OP_I) idrow[j] = cell_idc;
                vnp[j] = v2;
                pv_col = v2;
            }
            if (i == qlen && rlen >= jlo && rlen <= jhi)
                score[kk] = vnp[rlen];
            std::swap(pvp, vnp);
        }
    }
    return 0;
}

}  // extern "C"
