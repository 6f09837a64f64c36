// yaha_tpu native index builder.
//
// Threaded k-mer index construction, byte-exact with the reference file
// output (indexFile, Index.c:49-335) and with the Python builder
// (yaha_tpu/index/build.py, which is byte-parity validated up to a
// 16.3 GB hg-scale build).  Structure:
//
//   pass 1  per-k-mer counts     -- T threads, hash-range partitioned:
//           each thread runs the full skip/renormalize genome scan
//           (Index.c:96-128) but counts only hashes in its range, so no
//           atomics and no cross-thread ordering questions.
//   pass 2  ROA scatter          -- same partitioning; because every
//           thread sees windows in genome order and owns its hash range
//           exclusively, per-k-mer reference offsets land ascending
//           exactly like the reference's sequential fill
//           (Index.c:199-242).
//   pass 3  down-sampling        -- sequential modified-Floyd sampling
//           with the fixed Marsaglia seed (Index.c:271-315,
//           Math.c:304-343), compacting the ROA in place.
//
// The hash-range partitioning trades T-1 extra genome scans (sequential
// reads, cheap) for fully independent random scatter (the actual wall in
// the reference's single-thread build).
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <thread>
#include <algorithm>

namespace yidx {

struct Rng {
    uint32_t s[5] = {123456789u, 362436069u, 521288629u, 88675123u,
                     886756453u};
    uint32_t bits() {
        uint32_t t = s[0] ^ (s[0] >> 7);
        s[0] = s[1]; s[1] = s[2]; s[2] = s[3]; s[3] = s[4];
        s[4] = (uint32_t)((s[4] ^ (s[4] << 6)) ^ (t ^ (t << 13)));
        return (uint32_t)((s[1] + s[1] + 1) * s[4]);
    }
    // Math.c:289-298 semantics (double arithmetic, truncation).
    uint32_t rand_uint(uint32_t start, uint32_t end) {
        double d = (double)bits() / 4294967296.0;
        return start + (uint32_t)(d * (double)(end - start));
    }
};

// Full skip/renormalize scan of one sequence (Index.c:96-128 as in
// index/build.scan_positions), emitting (position, hash) in scan order.
template <class F>
static void scan_seq(const uint8_t* codes, int64_t n, int64_t start,
                     int64_t len, int wl, int64_t sd, int64_t mask,
                     F&& emit) {
    int64_t ending = start + len - wl;
    if (ending < start) return;
    int64_t base = start;
    for (;;) {
        if (base > ending) break;
        // First bad (non-ACGT) code at-or-after base.
        int64_t p_bad = base;
        while (p_bad < n && codes[p_bad] <= 3) p_bad++;
        bool has_bad = p_bad < n;
        int64_t sentinel = has_bad ? p_bad : n + wl;
        int64_t last_good = std::min(ending, sentinel - wl);
        int64_t next_window = base;
        if (last_good >= base) {
            // Rolling hash along the grid {base, base+sd, ...}.
            int64_t h = 0;
            for (int k = 0; k < wl; k++)
                h = (h << 2) | codes[base + k];
            emit(base, h & mask);
            for (int64_t p = base + sd; p <= last_good; p += sd) {
                if (sd < wl) {
                    for (int64_t k = wl - sd; k < wl; k++)
                        h = (h << 2) | codes[p + k];
                    h &= mask;
                } else {
                    h = 0;
                    for (int k = 0; k < wl; k++)
                        h = (h << 2) | codes[p + k];
                    h &= mask;
                }
                emit(p, h);
            }
            next_window = base + ((last_good - base) / sd + 1) * sd;
        }
        if (next_window > ending || sentinel > n) break;
        int64_t cur = p_bad + 1;
        while (cur < n && codes[cur] > 3) cur++;
        base = ((cur + sd - 1) / sd) * sd;
        if (cur >= n) break;
    }
}

}  // namespace yidx

extern "C" {

// Build the index.  Outputs are malloc'd (caller frees with yt_free):
//   out_so:  4^wordLen + 1 uint32 starting offsets (post-sampling)
//   out_roa: total_matches uint32 reference offsets
int yt_build_index(const uint8_t* codes, int64_t codes_len,
                   const int64_t* seq_starts, const int64_t* seq_lens,
                   int64_t n_seqs, int64_t word_len, int64_t skip_dist,
                   int64_t max_hits, int64_t n_threads,
                   uint32_t** out_so, uint32_t** out_roa,
                   int64_t* out_total) {
    using namespace yidx;
    const int64_t ht = 1ll << (2 * word_len);
    const int64_t mask = ht - 1;
    if (n_threads < 1) n_threads = 1;
    int64_t hw = (int64_t)std::thread::hardware_concurrency();
    if (hw > 0 && n_threads > hw) n_threads = hw;
    if (n_threads > ht) n_threads = 1;

    uint32_t* counts = (uint32_t*)calloc((size_t)ht, 4);
    if (!counts) return -1;

    auto range_lo = [&](int64_t t) { return t * (ht / n_threads); };
    auto range_hi = [&](int64_t t) {
        return t == n_threads - 1 ? ht : (t + 1) * (ht / n_threads);
    };

    // Pass 1: counts, hash-range partitioned.
    {
        std::vector<std::thread> ths;
        for (int64_t t = 0; t < n_threads; t++) {
            ths.emplace_back([&, t]() {
                int64_t lo = range_lo(t), hi = range_hi(t);
                for (int64_t s = 0; s < n_seqs; s++) {
                    scan_seq(codes, codes_len, seq_starts[s], seq_lens[s],
                             (int)word_len, skip_dist, mask,
                             [&](int64_t, int64_t h) {
                        if (h >= lo && h < hi) counts[h]++;
                    });
                }
            });
        }
        for (auto& th : ths) th.join();
    }

    // Prefix sum -> scatter cursors (uint32 offsets: < 4 Gbp genomes,
    // the reference's own ceiling, Math.h:90-102).
    uint32_t* so = (uint32_t*)malloc(((size_t)ht + 1) * 4);
    uint32_t* cursor = (uint32_t*)malloc((size_t)ht * 4);
    if (!so || !cursor) { free(counts); free(so); free(cursor); return -1; }
    uint64_t acc = 0;
    for (int64_t h = 0; h < ht; h++) {
        so[h] = (uint32_t)acc;
        cursor[h] = (uint32_t)acc;
        acc += counts[h];
    }
    so[ht] = (uint32_t)acc;
    int64_t total_raw = (int64_t)acc;

    uint32_t* roa = (uint32_t*)malloc((size_t)std::max<int64_t>(
        total_raw, 1) * 4);
    if (!roa) { free(counts); free(so); free(cursor); return -1; }

    // Pass 2: ROA scatter, same partitioning (genome order per k-mer).
    {
        std::vector<std::thread> ths;
        for (int64_t t = 0; t < n_threads; t++) {
            ths.emplace_back([&, t]() {
                int64_t lo = range_lo(t), hi = range_hi(t);
                for (int64_t s = 0; s < n_seqs; s++) {
                    scan_seq(codes, codes_len, seq_starts[s], seq_lens[s],
                             (int)word_len, skip_dist, mask,
                             [&](int64_t p, int64_t h) {
                        if (h >= lo && h < hi)
                            roa[cursor[h]++] = (uint32_t)p;
                    });
                }
            });
        }
        for (auto& th : ths) th.join();
    }
    free(cursor);

    // Pass 3: random down-sampling of k-mers over maxHits, in-place
    // compaction.  RNG flows across k-mers in ascending hash order from
    // the fixed default seed (Index.c:271-315).
    Rng rng;
    std::vector<uint8_t> marked;
    int64_t write = 0;
    int64_t read = 0;
    bool any_over = false;
    uint64_t out_acc = 0;
    uint32_t* new_so = (uint32_t*)malloc(((size_t)ht + 1) * 4);
    if (!new_so) { free(counts); free(so); free(roa); return -1; }
    for (int64_t h = 0; h < ht; h++) {
        int64_t cnt = counts[h];
        new_so[h] = (uint32_t)out_acc;
        if (cnt <= max_hits) {
            if (any_over && cnt > 0)
                memmove(roa + write, roa + read, (size_t)cnt * 4);
            write += cnt;
            read += cnt;
            out_acc += cnt;
            continue;
        }
        any_over = true;
        // Modified Floyd (Math.c:304-343; utils/rng.py rand_sample).
        int64_t in_len = cnt;
        int64_t out_len = max_hits;
        bool keep_marked = true;
        int64_t select = out_len;
        if (out_len > in_len / 2) {
            keep_marked = false;
            select = in_len - out_len;
        }
        marked.assign((size_t)in_len, 0);
        for (int64_t i = in_len - select; i < in_len; i++) {
            uint32_t pos = rng.rand_uint(0, (uint32_t)(i + 1));
            if (marked[pos]) marked[(size_t)i] = 1;
            else marked[pos] = 1;
        }
        const uint8_t want = keep_marked ? 1 : 0;
        for (int64_t k = 0; k < in_len; k++)
            if (marked[(size_t)k] == want)
                roa[write++] = roa[read + k];
        read += in_len;
        out_acc += out_len;
    }
    new_so[ht] = (uint32_t)out_acc;
    free(counts);
    free(so);

    *out_so = new_so;
    *out_roa = roa;
    *out_total = (int64_t)out_acc;
    return 0;
}

}  // extern "C"
