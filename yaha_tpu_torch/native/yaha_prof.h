// Stage accumulators of one native thread (the reference's TIMING phase
// counters, Timing.inl), shared by yaha_host.cpp (the seed scan and
// fragments-to-clumps) and yaha_pipe.cpp (the engines).
//
// g_prof is null unless the thread is bound to a slot: the per-read
// engine binds its workers under YT_PROFILE=1 (the [yt_prof] report on
// stderr), the staged phase 1 when yt_batch_begin is given its profiling
// flag (the batch's sums through yt_batch_prof).  With it null no clock is
// read.  Seconds are thread-seconds (a front end's capacity retry counts
// its scan again); a binder unbinds before it returns.
#pragma once

#include <cstdint>

struct Prof {
    // per-read engine: front end, clump alignment, OQC, SAM text
    double front = 0, align = 0, oqc = 0, print = 0;
    // seed-to-clumps calls, DPs (banded extension, anchored, small),
    // scoring, gap cascade, clump extension
    double s2c = 0, dp = 0, dpa = 0, dps = 0, sc = 0, gapc = 0,
           extfr = 0;
    // host seed scan (yt_seed_to_clumps): rolling hash, SO lookups, ROA
    // gathers; the hit sort and coalesce; fragments-to-clumps
    double scan_hash = 0, scan_so = 0, scan_roa = 0, sort = 0, f2c = 0;
    // the device-fed strands' coalesce and fragments-to-clumps
    // (process_strand_hits); staged phase 1's align_clump_stage1
    double hits_f2c = 0, stage1 = 0;
    int64_t reads = 0, dp_calls = 0, dpa_calls = 0, dps_calls = 0,
            clumps = 0, hits = 0, frags = 0;

    void add(const Prof& p) {
        front += p.front; align += p.align; oqc += p.oqc;
        print += p.print; s2c += p.s2c; dp += p.dp; dpa += p.dpa;
        dps += p.dps; sc += p.sc; gapc += p.gapc; extfr += p.extfr;
        scan_hash += p.scan_hash; scan_so += p.scan_so;
        scan_roa += p.scan_roa; sort += p.sort; f2c += p.f2c;
        hits_f2c += p.hits_f2c; stage1 += p.stage1;
        reads += p.reads; dp_calls += p.dp_calls; dpa_calls += p.dpa_calls;
        dps_calls += p.dps_calls; clumps += p.clumps; hits += p.hits;
        frags += p.frags;
    }
};

extern thread_local Prof* g_prof;
