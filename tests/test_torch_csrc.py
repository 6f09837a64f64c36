"""The CUDA kernels' per-problem bodies, built as C++ on the CPU.

The bodies in yaha_tpu_torch/csrc are __host__ __device__: without
__CUDACC__ they compile with g++.  A small C loop over problems (C_LOOP
below) is built with them into a shared library under the test's
temporary directory and called through ctypes, and its outputs are held to
the plain PyTorch version sw_cuda.extension_forward_reference, with
tolerance zero (integer arrays, the whole backtrack plane included):

  * ext_problem_reg<W>, the register-band body of csrc/ext_kernels.cu, for
    W in {13, 21, 33} (-BW 3, 5, 8), run row by row as a lone problem and
    with every row on its predicated path, as a lane does when another lane
    of its warp needs that path;
  * the wide kernel of csrc/ext_wide_kernels.cu at W in {1, 21, 37, 65}:
    its lane step, fold and copies over an emulated 32-lane warp, each
    lane's output handed to the next lane a step later as the shuffle
    does, on planes prefilled with garbage; and the block kernel
    (ext_block_kernel: BlockWarp's schedule, the lane step, block_store's
    16-byte units, the fold through shared memory) over 2 and 8 emulated
    warps under three schedules (lockstep; one warp held back as far as
    the waits allow; seeded random turns), on the same inputs and on
    problems whose X-drop exit falls in the first strip, a middle strip
    (later warps ahead) or the last row, at W 1, 21, 65, 2,833 and
    12,909, shared memory garbage too;

on the EXT_SWEEP inputs of tests/torch_dp_cases.py, the int32-wrap inputs
(KW_WRAP) and references shorter than qlen + 2*bw2 (the rows whose band
ends before the last column), and for the wide kernel also on reads with
an indel of up to 2*bw bases (indel_extension_inputs);

  * the backtrack walk of csrc/decode_kernels.cu, held to
    decode.rle_walk_reference: rle_walk_window<T> for teams of 8, 16 and
    32 lanes (their run scans a loop over the lanes) with windows of 16,
    64 and 512 bytes (the host copy in place of cp.async), on
    extension, band-relative and full-width planes, 260- and 600-base gap
    runs, walks from every cell of a plane, inactive, OP_UNKNOWN and
    outside starts, and a cap of 3 (n_ops = -1); n_ops whole, the items
    up to min(n_ops, cap), and no slot written past them;
  * the problem gather of csrc/gather_kernels.cu (gather_problem: every
    16-byte chunk of both rows through gather_chunk / gather_store), held
    to gather_dp.gather_reference from every source alignment, forward
    and reversed, with output rows at every alignment, short copies, both
    pads and clamped sources;
  * the seed phase of csrc/seed_kernels.cu: seed_hash_run<WL> over every
    16-window run (runs across row ends, rows of fewer windows than a
    run, a short last run, rows at three alignments), held to
    seeds.seed_hashes_reference; window_run, slot_window, slot_key and
    the sort's steps (sort_span, smem_step, reg_steps, the lane strides
    as an emulated shuffle) with a sequential scan in place of the
    block's, held to seeds.expand_sort_hits_reference on every SEED_CASES
    entry (the golden index's seed rows at capacities 64, 1,024 and 8,192,
    the wrapped run at a tier's last slots, unsigned-order and sentinel
    edges, 650-hit runs across C in rows of three batches, row totals
    around every sort size), and over each model shard of 2 and 4 (a
    shard's hash range, its rebased SO and ROA slice:
    parallel/mesh.ShardedIndex) held to the plain version with the same
    range; the merge's passes (merge_pass_kernel's blocks: the split
    warps' probes as a ballot, the 16-byte loads and stores, each
    thread's merge) for 1 to 8 runs of 1 to 16,384 keys, held to
    seeds.merge_sorted_runs_reference (torch.sort of the gathered keys) on
    runs with diag >= 2^31, 0xFFFFFFFF beside the sentinel, equal keys
    across runs, full and empty runs, rows of nothing but pads and tile
    edges inside runs of equal keys; every output, the passes' second
    buffer and the shared slots prefilled with garbage;
  * wavefront.cuh's wide_warp_bytes and kWideSmemMax, and
    ext_wide_kernels.cu's ext_block_bytes and kBlockWarps, equal to their
    Python copy in ops/sw_cuda.py (full_wide_fits, ext_variant,
    ext_wide_fits) at every plane width 33-4,200 (1-15,000 for the block
    extension);
  * the anchored gap fill of csrc/anch_kernels.cu: the register bodies
    (AnchBand<K>, AnchFull<K>) in every width class and the wide route
    (AnchWideProblem, AnchWideLane, AnchWideSched and the shared copies of
    wavefront.cuh) over an emulated 32-lane warp (anch_wide), alone, for
    the problems wider than 32 columns and routed by warps of 32 as the
    kernels route them, held to the plain versions on planes prefilled
    with garbage (tests/test_torch_anch_wide.py holds the wide route at
    more widths, and to the Pallas kernels);
  * the chain DP of csrc/chain_kernels.cu (ChainLane<K> and chain_merge
    over the threads of a team, run_chain: the pair tests with and
    without the SQO window, then a step at each node with a candidate
    successor), held to chain.batched_chain_dp_ref (and in
    tests/test_torch_chain.py to chain_jax and the native chain_dp).

The plain versions are held to the JAX package in test_torch_decode.py,
test_torch_gather.py, test_torch_seeds.py and test_torch_chain.py.  The test skips only where
g++ is missing.
"""
import ctypes as ct
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from torch_dp_cases import (ANCH_SWEEP, ANCH_SWEEP_IDS, CHAIN_KW,
                            CHAIN_TIE_KW, EXT_SWEEP,
                            EXT_SWEEP_IDS, HASH_SHAPE_IDS, HASH_SHAPES, KW,
                            KW_WRAP, SEED_CASES,
                            anchored_edge_inputs,
                            anchored_sweep_inputs, chain_case,
                            chain_edge_case, chain_tie_case,
                            extension_inputs, gather_aligned_coords,
                            gather_case, gather_clamp_coords, gather_coords,
                            hash_rows, indel_extension_inputs,
                            long_run_inputs, read_rows,
                            seed_case, seed_rows, xdrop_extension_inputs)
from yaha_tpu_torch.ops import chain, decode, gather_dp, seeds, sw_cuda

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "yaha_tpu_torch", "csrc")

C_LOOP = r"""
#include "ext_kernels.cu"
#include "ext_wide_kernels.cu"
#include "decode_kernels.cu"
#include "gather_kernels.cu"
#include "anch_kernels.cu"
#include "seed_kernels.cu"
#include "chain_kernels.cu"

#include <string.h>

#include <algorithm>
#include <vector>

// anch_wide_kernel's warp on problem p, emulated: the stages zeroed and
// the rest of the warp's shared memory garbage, as on the card; at each
// step lane 0 reads the shared row, the 32 lanes take their step in turn,
// lane 31 writes the shared row, and each lane's output goes to the next
// lane for the next step (the shuffle; lane 0 gets its own); every copy
// runs as 32 lane shares; the score from the first lane that computed it
// (the ballot).
template <bool kF>
static void anch_wide(int64_t p, const ytsw::AnchArgs& a, int8_t* bt,
                      int32_t* score) {
    using namespace ytsw;
    const int lanes = kWideLanes;
    AnchWideProblem<kF> P;
    P.init(p, a);
    const int64_t w = P.w;
    std::vector<uint32_t> mem(wide_warp_bytes(w) / 4, 0x5A5A5A5Au);
    uint8_t* wsm = (uint8_t*)mem.data();
    Band3* row = (Band3*)wsm;
    uint8_t* stage = wsm + wide_row_bytes(w);
    const int64_t sb = wide_stage_bytes(w);
    uint8_t* codes = stage + 2 * sb;
    const int64_t cb = wide_code_bytes(w);
    uint8_t* plane = (uint8_t*)bt + p * (a.ql + 1) * w;
    for (int k = 0; k < lanes; k++) {
        anch_zero(stage, (int32_t)(2 * sb), k, lanes);
        for (int32_t c = k; c <= P.ncols; c += lanes) row[c] = P.row0(c);
        copy_share(k, plane, w, AnchFillSrc{0, P.w, P.base, P.hi0});
    }
    std::vector<AnchWideLane<kF>> L(lanes);
    for (int k = 0; k < lanes; k++) L[k].init(k);
    if (P.last >= 1) {
        std::vector<Band3> out(lanes);
        for (int k = 0; k < lanes; k++) {
            P.stage_codes(k, 0, codes);
            P.stage_codes(k, 1, codes + cb);
        }
        AnchWideSched S;
        S.init(P);
        for (int32_t t = 0;; t++) {
            L[0].take_row(row, P);
            for (int k = 0; k < lanes; k++) {
                const int par = ((L[k].i - 1) / lanes) & 1;
                out[k] = L[k].step(P, codes + par * cb,
                                   stage + par * sb + k * w);
            }
            if (L[lanes - 1].j >= 0 && L[lanes - 1].j < P.ncols)
                row[L[lanes - 1].j] = out[lanes - 1];
            for (int k = 0; k < lanes; k++)
                L[k].advance(out[k > 0 ? k - 1 : 0], P);
            if (t != S.copy_at) continue;
            for (int k = 0; k < lanes; k++)
                copy_share(k, plane + ((int64_t)S.strip * lanes + 1) * w,
                           (int64_t)S.rows * w,
                           StageSrc{stage + (S.strip & 1) * sb});
            if (S.last()) break;
            if (S.strip + 2 <= S.last_strip)
                for (int k = 0; k < lanes; k++)
                    P.stage_codes(k, S.strip + 2,
                                  codes + (S.strip & 1) * cb);
            S.next(P);
        }
    }
    const int64_t x0 = ((int64_t)(P.last > 0 ? P.last : 0) + 1) * w;
    for (int k = 0; k < lanes; k++)
        copy_share(k, plane + x0, (a.ql + 1) * w - x0,
                   AnchFillSrc{x0, P.w, P.base, P.hi0});
    score[p] = DP_WORST;
    for (int k = 0; k < lanes; k++)
        if (L[k].got) {
            score[p] = L[k].sc;
            break;
        }
}

// Anchored gap fill, banded (full = 0) or full width, on planes and scores
// prefilled with garbage.  tier 0: every problem through the wide route;
// tier 1: each problem in the smallest register class covering it, raised
// to kmin, every row at least in `mode`, and the problems wider than 32
// columns through the wide route; tier 2: the problems routed by warps of
// 32, as the kernels route them (a warp's register class is its widest
// lane's, every row in `mode`; a warp with a lane wider than 32 columns
// through the wide route).
extern "C" int run_anch(int full, int tier, int kmin, int mode,
                        const uint8_t* q, const uint8_t* r,
                        const int32_t* qlens, const int32_t* rlens,
                        const int32_t* lbws, const int32_t* rbws, int64_t n,
                        int64_t ql, int64_t rl, int32_t wband,
                        const int32_t* kw, int8_t* bt, int32_t* score) {
    ytsw::Scoring s;
    s.go = kw[0];
    s.ge = kw[1];
    s.rc = kw[2];
    s.ms = kw[3];
    s.max_gap = kw[4];
    s.max_intron = kw[5];
    const ytsw::AnchArgs a = {q, r, qlens, rlens, lbws, rbws, ql, rl,
                              wband, s};
    const int64_t w = full ? rl + 1 : wband;
    auto live_of = [&](int64_t p) {
        return full ? ytsw::full_live(rlens[p], rl)
                    : ytsw::band_live(lbws[p], rbws[p], wband);
    };
    for (int64_t p = 0; p < n; p++) {
        int k = 0;
        if (tier == 1) {
            k = ytsw::anch_class(live_of(p));
            if (k && k < kmin) k = kmin;
        } else if (tier == 2) {
            int32_t wmax = 0;
            for (int64_t g = p & ~(int64_t)31; g < n && g < (p | 31) + 1; g++)
                wmax = std::max(wmax, live_of(g));
            k = ytsw::anch_class(wmax);
        }
        bool ok = true;
        switch (k) {
#define YT_K(kk)                                                           \
        case kk:                                                           \
            ok = full ? ytsw::anch_reg_problem<ytsw::AnchFull<kk>>(        \
                            p, a, w, mode, bt, score)                      \
                      : ytsw::anch_reg_problem<ytsw::AnchBand<kk>>(        \
                            p, a, w, mode, bt, score);                     \
            break;
        YT_K(8)
        YT_K(16)
        YT_K(32)
#undef YT_K
        default:
            if (full)
                anch_wide<true>(p, a, bt, score);
            else
                anch_wide<false>(p, a, bt, score);
        }
        if (!ok) return 1;
    }
    return 0;
}

// rle_walk_window by teams of `team` lanes with windows of `window` bytes.
template <bool kFull>
static int walk(int team, int64_t window, const int8_t* bt, int64_t n,
                int64_t h, int64_t w, const int32_t* y0, const int32_t* x0,
                const uint8_t* active, int64_t cap, int32_t* rle,
                int32_t* n_ops) {
    alignas(16) static uint8_t smem[2 * 16384];
    const ytsw::HostCopy cp = {0, 1};
    for (int64_t p = 0; p < n; p++) {
        switch (team) {
#define YT_TEAM(t)                                                       \
        case t:                                                          \
            ytsw::rle_walk_window<kFull, t>(p, bt, h, w, y0, x0, active, \
                                            cap, rle, n_ops, smem,       \
                                            window, cp);                 \
            break;
        YT_TEAM(8)
        YT_TEAM(16)
        YT_TEAM(32)
#undef YT_TEAM
        default:
            return 1;
        }
    }
    return 0;
}

extern "C" int run_walk(int team, int64_t window, int full,
                        const int8_t* bt, int64_t n, int64_t h, int64_t w,
                        const int32_t* y0, const int32_t* x0,
                        const uint8_t* active, int64_t cap, int32_t* rle,
                        int32_t* n_ops) {
    if (window < 16 || window > 16384 || (window & (window - 1))) return 1;
    return full ? walk<true>(team, window, bt, n, h, w, y0, x0, active, cap,
                             rle, n_ops)
                : walk<false>(team, window, bt, n, h, w, y0, x0, active, cap,
                              rle, n_ops);
}

extern "C" void run_gather(const uint8_t* rows2, int64_t nrows, int64_t lpad,
                           const uint8_t* codes, int64_t ncodes,
                           const int64_t* coords, int64_t m, int64_t qg,
                           int64_t rg, int32_t rpad, uint8_t* q, uint8_t* r,
                           int backwards) {
    for (int64_t i = 0; i < m; i++)
        ytsw::gather_problem(backwards ? m - 1 - i : i, m, rows2, nrows,
                             lpad, codes, ncodes, coords, qg, rg, rpad, q,
                             r);
}

// seed_hash_run<WL> over every 16-window run of the flat output, as the
// kernel's threads take them (any word length a template instance of the
// kernel takes).
template <int WL>
static int hash_runs(int32_t wl, const uint8_t* codes, int64_t b, int64_t l,
                     const int32_t* lengths, int32_t* hashes,
                     uint8_t* clean) {
    if (wl != WL) {
        if constexpr (WL > 1)
            return hash_runs<WL - 1>(wl, codes, b, l, lengths, hashes, clean);
        return 1;
    }
    const int64_t total = b * (l - WL + 1);
    for (int64_t k0 = 0; k0 < total; k0 += ytsw::kHashRun)
        ytsw::seed_hash_run<WL>(codes, b, l, lengths, k0, hashes, clean);
    return 0;
}

extern "C" int run_seed_hashes(const uint8_t* codes, int64_t b, int64_t l,
                               const int32_t* lengths, int32_t wl,
                               int32_t* hashes, uint8_t* clean) {
    return hash_runs<15>(wl, codes, b, l, lengths, hashes, clean);
}

// lane_steps of expand_sort_kernel for the 32 lanes of a warp whose
// kRegKeys-key registers are v[lane * kRegKeys ..], lane 0's first element
// i0: the lane strides as a shuffle (each lane reads its partner lane's old
// value), then reg_steps.
static void lane_steps(uint64_t* v, int64_t i0, int64_t k) {
    const int R = ytsw::kRegKeys;
    const int64_t span = ytsw::kWarpKeys;
    std::vector<uint64_t> old(v, v + span);
    for (int m = 16; m > 0; m >>= 1) {
        if ((int64_t)m * R >= k) continue;
        old.assign(v, v + span);
        for (int64_t x = 0; x < span; x++) {
            const int64_t t = x / R, e = x % R;
            v[x] = ytsw::keep(old[x], old[(t ^ m) * R + e],
                              ytsw::bitonic_keeps_min(i0 + x, m * R, k));
        }
    }
    auto* r = (uint64_t(*)[ytsw::kRegKeys])v;
    for (int t = 0; t < 32; t++)
        ytsw::reg_steps(r[t], i0 + (int64_t)t * R, k);
}

// sort_row of expand_sort_kernel: keys[valid, p) the sentinel, each
// stage's long strides through smem_step and its short ones through
// lane_steps, warp by warp.
static void sort_row(std::vector<uint64_t>& keys, int64_t valid,
                     int64_t p) {
    const int64_t span = ytsw::kWarpKeys;
    for (int64_t i = valid; i < p; i++) keys[i] = ytsw::kSeedSentinel;
    for (int64_t k = span; k <= p; k <<= 1) {
        for (int64_t j = k >> 1; k > span && j >= span; j >>= 1)
            for (int64_t q = 0; q < p / 2; q++)
                ytsw::smem_step(keys.data(), q, j, k);
        for (int64_t i0 = 0; i0 < p; i0 += span)
            for (int64_t s = k == span ? 2 : k; s <= k; s <<= 1)
                lane_steps(keys.data() + i0, i0, s);
    }
}

// expand_sort_kernel's rows through its bodies: windows in batches of
// kBatch with a sequential scan in place of the block's, the batch's slots
// below cap expanded last to first (the threads store them in no set
// order) through slot_window and slot_key, the wrapped bits, and the sort
// (sort_row emulated); key slots the sort may not read hold garbage.
extern "C" void run_expand_sort(const int32_t* hashes, const uint8_t* clean,
                                int64_t b, int64_t n, const uint32_t* so,
                                const uint32_t* roa, int32_t max_hits,
                                int32_t hash_lo, int64_t per,
                                int64_t cap, uint32_t* diag, int32_t* qo,
                                int32_t* total, uint8_t* overflow,
                                uint8_t* wrapped, uint8_t* allwrapped) {
    const int nb = ytsw::kBatch;
    std::vector<uint64_t> keys((size_t)std::max<int64_t>(cap, 256));
    std::vector<ytsw::WindowRun> runs(nb);
    std::vector<uint32_t> cum(nb);
    std::vector<uint8_t> ok(nb);
    for (int64_t r = 0; r < b; r++) {
        std::fill(keys.begin(), keys.end(), 0x5A5A5A5A5A5A5A5Aull);
        uint32_t carry = 0;
        bool any = false;
        for (int64_t w0 = 0; w0 < n; w0 += nb) {
            uint32_t at = carry;
            for (int lw = 0; lw < nb; lw++) {
                const int64_t w = w0 + lw;
                runs[lw] = {0, 0};
                if (w < n)
                    runs[lw] = ytsw::window_run(hashes[r * n + w],
                                                clean[r * n + w] != 0, so,
                                                max_hits, hash_lo, per);
                at += (uint32_t)runs[lw].kept;
                cum[lw] = at;
            }
            std::fill(ok.begin(), ok.end(), 0);
            const int64_t t_lo = carry;
            const int64_t t_hi = std::min<int64_t>(t_lo + (at - carry), cap);
            for (int64_t t = t_hi - 1; t >= t_lo; t--) {
                const int win = ytsw::slot_window(cum.data(), t);
                const uint32_t base = win > 0 ? cum[win - 1] : carry;
                const uint32_t ro = roa[(uint64_t)runs[win].so_lo +
                                        (uint32_t)(t - base)];
                keys[t] = ytsw::slot_key(ro, w0 + win);
                if (ro >= (uint32_t)(w0 + win)) ok[win] = 1;
            }
            for (int lw = 0; lw < nb && w0 + lw < n; lw++) {
                const bool wr = runs[lw].kept > 0 && !ok[lw];
                wrapped[r * n + w0 + lw] = wr ? 1 : 0;
                any = any || wr;
            }
            carry = at;
        }
        const int32_t tot = (int32_t)carry;
        const int64_t valid = tot <= 0 ? 0 : std::min<int64_t>(tot, cap);
        const int64_t p = ytsw::sort_span(valid);
        sort_row(keys, valid, p);
        for (int64_t t = 0; t < cap; t++) {
            const uint64_t key = t < p ? keys[t] : ytsw::kSeedSentinel;
            diag[r * cap + t] = (uint32_t)(key >> 32);
            qo[r * cap + t] = (int32_t)(uint32_t)key;
        }
        total[r] = tot;
        overflow[r] = tot > cap ? 1 : 0;
        allwrapped[r] = any ? 1 : 0;
    }
}

// yt_merge_runs' passes and merge_pass_kernel's blocks, blocks in no set
// order: the two split warps as 32 probes a round whose true ones must be
// the first lanes (the ballot's count), the shared slots prefilled with
// garbage, every thread's load and store shares, every thread's merge
// before any writes its outputs back (the barrier).  tmp_d / tmp_q: the
// passes' second buffer (m > 2).  Returns 1 if a round's probes were not
// a prefix of the lanes.
extern "C" int run_merge(const uint32_t* diag, const int32_t* qo, int32_t m,
                         int64_t b, int64_t cap, uint32_t* tmp_d,
                         int32_t* tmp_q, uint32_t* out_d, int32_t* out_q) {
    using namespace ytsw;
    const int np = merge_passes(m);
    std::vector<uint64_t> keys(kMergeSlots);
    std::vector<uint64_t> v((size_t)kMergeThreads * kMergeKeys);
    for (int p = 0; p < np; p++) {
        const MergePass P = merge_pass(p, np, diag, qo, m, b, cap, tmp_d,
                                       tmp_q, out_d, out_q);
        const int64_t grid = b * P.pairs * P.tiles;
        for (int64_t k = 0; k < grid; k++) {
            const int64_t blk = (k * 7919) % grid;
            MergeTile T;
            if (!T.init(P, blk)) continue;
            std::fill(keys.begin(), keys.end(), 0x5A5A5A5A5A5A5A5Aull);
            int64_t split[2];
            for (int warp = 0; warp < 2; warp++) {
                const int64_t d = warp ? T.d1 : T.d0;
                int64_t lo = split_lo(d, T.lb), hi = split_hi(d, T.la);
                while (lo < hi) {
                    int c = 0;
                    for (int lane = 0; lane < 32; lane++) {
                        const bool pr = split_probe(P, T, d, lo, hi, lane);
                        if (pr && c != lane) return 1;
                        c += pr ? 1 : 0;
                    }
                    split_narrow(lo, hi, c);
                }
                split[warp] = lo;
            }
            const int32_t na = (int32_t)(split[1] - split[0]);
            const int32_t n = (int32_t)(T.d1 - T.d0);
            for (int t = 0; t < kMergeThreads; t++) {
                load_keys(t, kMergeThreads, P, T.a_at + split[0], na,
                          keys.data(), 0);
                load_keys(t, kMergeThreads, P, T.b_at + (T.d0 - split[0]),
                          n - na, keys.data(), na);
            }
            for (int t = 0; t < kMergeThreads; t++) {
                uint64_t w[kMergeKeys];
                merge_thread(t, keys.data(), na, n - na, w);
                for (int e = 0; e < kMergeKeys; e++)
                    v[(size_t)t * kMergeKeys + e] = w[e];
            }
            for (int32_t x = 0; x < n; x++) keys[merge_slot(x)] = v[x];
            for (int t = kMergeThreads - 1; t >= 0; t--)
                store_keys(t, kMergeThreads, keys.data(), n, P,
                           T.out_at + T.d0);
        }
    }
    return 0;
}

// The wide routes' shared memory (wavefront.cuh) and the block
// extension's (ext_wide_kernels.cu), for their Python copies.
extern "C" int64_t wide_warp_bytes(int64_t w) {
    return ytsw::wide_warp_bytes(w);
}
extern "C" int64_t wide_smem_max() { return ytsw::kWideSmemMax; }
extern "C" int64_t ext_block_bytes(int64_t w) {
    return ytsw::ext_block_bytes(w);
}
extern "C" int ext_block_warps() { return ytsw::kBlockWarps; }

// A wavefront warp's fold of strip `strip` (every lane's last finished
// row in L[k].done_v / done_j) after the running maximum run, as
// fold_strip does it with shuffles and a ballot: a sequential max-scan
// over the rows and the first exiting row (el, -1 for none).
static ytsw::WideBest fold_lanes(ytsw::WideBest run, const ytsw::WideLane* L,
                                 int32_t strip, const ytsw::WideProblem& P,
                                 int& el) {
    using namespace ytsw;
    WideBest e = run;
    el = -1;
    WideBest at_el = run;
    for (int k = 0; k < kWideLanes; k++) {
        const int32_t i_f = strip * kWideLanes + k + 1;
        e = best_after(e, WideBest{L[k].done_v, i_f, L[k].done_j});
        if (el < 0 && wide_exits(L[k].done_v, e.v, i_f, P)) {
            el = k;
            at_el = e;
        }
    }
    return el >= 0 ? at_el : e;
}

// variant 1: ext_problem_reg<W>; 2: ext_problem_reg<W> with every row
// predicated.
extern "C" int run_ext(int variant, const uint8_t* q, const uint8_t* r,
                       const int32_t* qlens, const int32_t* rlens,
                       int64_t n, int64_t ql, int64_t rl, int32_t bw2,
                       const int32_t* kw, int8_t* bt, int32_t* score,
                       int32_t* maxi, int32_t* maxj) {
    ytsw::Scoring s;
    s.go = kw[0];
    s.ge = kw[1];
    s.rc = kw[2];
    s.ms = kw[3];
    s.max_gap = kw[4];
    s.max_intron = kw[5];
    const int32_t xc = kw[6];
    for (int64_t p = 0; p < n; p++) {
        const bool pred = variant == 2;
        switch (2 * bw2 + 1) {
        case 13:
            ytsw::ext_problem_reg<13>(p, q, ql, r, rl, qlens, rlens, s, xc,
                                      bt, score, maxi, maxj, pred);
            break;
        case 21:
            ytsw::ext_problem_reg<21>(p, q, ql, r, rl, qlens, rlens, s, xc,
                                      bt, score, maxi, maxj, pred);
            break;
        case 33:
            ytsw::ext_problem_reg<33>(p, q, ql, r, rl, qlens, rlens, s, xc,
                                      bt, score, maxi, maxj, pred);
            break;
        default:
            return 1;
        }
    }
    return 0;
}

// ext_wide_kernel's warp, emulated: at each step lane 0 reads the shared
// row, the 32 lanes take their step in turn, lane 31 writes the shared
// row, and each lane's output goes to the next lane for the next step (the
// shuffle); the fold is a sequential max-scan over the strip's rows and
// the first exiting row (the ballot); every copy runs as 32 lane shares.
// The strip stages start as garbage, as shared memory does.
extern "C" void run_ext_wide(const uint8_t* q, const uint8_t* r,
                             const int32_t* qlens, const int32_t* rlens,
                             int64_t n, int64_t ql, int64_t rl, int32_t bw2,
                             const int32_t* kw, int8_t* bt, int32_t* score,
                             int32_t* maxi, int32_t* maxj) {
    using namespace ytsw;
    Scoring s;
    s.go = kw[0];
    s.ge = kw[1];
    s.rc = kw[2];
    s.ms = kw[3];
    s.max_gap = kw[4];
    s.max_intron = kw[5];
    const int32_t w = 2 * bw2 + 1;
    const int lanes = kWideLanes;
    const int64_t sb = wide_stage_bytes(w);
    std::vector<Band3> row(w + 1);
    const int64_t cb = wide_code_bytes(w);
    std::vector<uint32_t> stage_words((2 * sb + 2 * cb) / 4, 0x5A5A5A5Au);
    uint8_t* stage = (uint8_t*)stage_words.data();
    uint8_t* codes = stage + 2 * sb;
    for (int64_t p = 0; p < n; p++) {
        WideProblem P;
        P.init(p, q, ql, r, rl, qlens, rlens, bw2, s, kw[6]);
        uint8_t* plane = (uint8_t*)bt + p * (ql + 1) * w;
        for (int32_t c = 0; c <= w; c++) row[c] = wide_row0(c, bw2, w, s);
        for (int k = 0; k < lanes; k++)
            copy_share(k, plane, w, FillSrc{0, w, bw2});
        WideBest run = {DP_WORST, 0, 0};
        int32_t exit_row = 0;
        if (P.last >= 1) {
            std::vector<WideLane> L(lanes);
            std::vector<Band3> out(lanes);
            for (int k = 0; k < lanes; k++) {
                P.stage_codes(k, 0, codes);
                P.stage_codes(k, 1, codes + cb);
                L[k].init(k);
            }
            int32_t strip = 0;
            int32_t fold_at = 2 * (lanes - 1) + w - 1;
            for (int32_t t = 0;; t++) {
                L[0].take_row(row.data(), P);
                for (int k = 0; k < lanes; k++) {
                    const int par = ((L[k].i - 1) / lanes) & 1;
                    out[k] = L[k].step(P, codes + par * cb,
                                       wide_row_dst(stage, sb, k, L[k].i, w));
                }
                if (L[lanes - 1].j >= 0 && L[lanes - 1].j < w)
                    row[L[lanes - 1].j] = out[lanes - 1];
                for (int k = 0; k < lanes; k++)
                    L[k].advance(out[k > 0 ? k - 1 : 0], P);
                if (t != fold_at) continue;
                int el;
                run = fold_lanes(run, L.data(), strip, P, el);
                for (int k = 0; k < lanes; k++)
                    copy_share(k, plane + ((int64_t)strip * lanes + 1) * w,
                               (int64_t)(el < 0 ? lanes : el + 1) * w,
                               StageSrc{stage + (strip & 1) * sb});
                if (el >= 0) {
                    exit_row = strip * lanes + el + 1;
                    break;
                }
                for (int k = 0; k < lanes; k++)
                    P.stage_codes(k, strip + 2, codes + (strip & 1) * cb);
                strip++;
                fold_at += P.period;
            }
        }
        const int64_t x0 = ((int64_t)exit_row + 1) * w;
        for (int k = 0; k < lanes; k++)
            copy_share(k, plane + x0, (ql + 1) * w - x0, FillSrc{x0, w, bw2});
        score[p] = run.v;
        maxi[p] = run.i;
        maxj[p] = run.j;
    }
}

// ext_block_kernel's block on each problem, `warps` emulated warps under a
// schedule: each turn one warp takes one step of its 32 lanes (as in
// run_ext_wide) in its run of free steps, or, when the run is done, does
// what BlockWarp::next says (start a run with a step; fold a strip; wait,
// changing nothing; stop), as the kernel's loop does.  Schedule 0:
// lockstep, the warps in turn; 1: warp warps / 2 held back, taking a turn
// only when no other warp can move (every other one waits or has
// stopped), so that it lags as far as the waits allow; 2: a warp drawn at
// random (seeded) each turn.  Shared memory (sync state, lane units, row)
// starts as garbage but for what the kernel sets; the plane, score, maxi
// and maxj too.  Returns 1 if every warp still running waits for another
// (a deadlock), else 0.
extern "C" int run_ext_block(int warps, int schedule, uint32_t seed,
                             const uint8_t* q, const uint8_t* r,
                             const int32_t* qlens, const int32_t* rlens,
                             int64_t n, int64_t ql, int64_t rl, int32_t bw2,
                             const int32_t* kw, int8_t* bt, int32_t* score,
                             int32_t* maxi, int32_t* maxj) {
    using namespace ytsw;
    Scoring s;
    s.go = kw[0];
    s.ge = kw[1];
    s.rc = kw[2];
    s.ms = kw[3];
    s.max_gap = kw[4];
    s.max_intron = kw[5];
    const int32_t w = 2 * bw2 + 1;
    const int lanes = kWideLanes;
    const int nt = warps * lanes;
    std::vector<uint32_t> mem(ext_block_bytes(w, warps) / 4, 0x5A5A5A5Au);
    uint8_t* smem = (uint8_t*)mem.data();
    BlockSync* sh = (BlockSync*)smem;
    uint8_t* units = smem + kBlockSyncBytes;
    Band3* row = (Band3*)(units + (int64_t)nt * 16);
    uint64_t rng = seed * 2654435761ull + 1;
    for (int64_t p = 0; p < n; p++) {
        WideProblem P;
        P.init(p, q, ql, r, rl, qlens, rlens, bw2, s, kw[6]);
        P.period = block_period(w, warps);
        uint8_t* plane = (uint8_t*)bt + p * (ql + 1) * w;
        for (int32_t c = 0; c <= w; c++) row[c] = wide_row0(c, bw2, w, s);
        for (int k = 0; k < kBlockMaxWarps; k++) sh->prog[k] = 0;
        sh->folded = 0;
        sh->exit_strip = kNoExit;
        sh->exit_row = 0;
        sh->run_v = DP_WORST;
        sh->run_i = sh->run_j = 0;
        for (int t = nt - 1; t >= 0; t--)
            copy_share(t, plane, w, FillSrc{0, w, bw2}, nt);
        if (P.last >= 1) {
            std::vector<BlockWarp> B(warps);
            std::vector<std::vector<WideLane>> L(warps,
                                                 std::vector<WideLane>(lanes));
            std::vector<int> stopped(warps, 0);
            std::vector<std::vector<BlockRow>> R(
                warps, std::vector<BlockRow>(lanes, BlockRow{}));
            for (int v = 0; v < warps; v++) {
                B[v].init(v, warps, P);
                for (int k = 0; k < lanes; k++) {
                    L[v][k].init(k);
                    L[v][k].i += v * lanes;
                }
            }
            int running = warps, turn = 0, idle = 0;
            const int held = warps / 2;
            std::vector<Band3> out(lanes);
            // One turn of warp v: one step of its run of free steps, or
            // when the run is done what next() gives (a step starts a new
            // run).  Returns what it did.
            std::vector<int32_t> left(warps, 0);
            auto act = [&](int v) {
                const int a = left[v] > 0 ? (int)kBlockStep
                                          : B[v].next(sh, P);
                if (a == kBlockStep && left[v] == 0)
                    left[v] = B[v].free_steps(P);
                if (a == kBlockStop) {
                    stopped[v] = 1;
                    running--;
                } else if (a == kBlockFold) {
                    int el;
                    const WideBest prev = B[v].s31 == 0
                        ? WideBest{DP_WORST, 0, 0}
                        : WideBest{sh->run_v, sh->run_i, sh->run_j};
                    const WideBest run = fold_lanes(prev, L[v].data(),
                                                    B[v].s31, P, el);
                    sh->run_v = run.v;
                    sh->run_i = run.i;
                    sh->run_j = run.j;
                    if (el >= 0) {
                        sh->exit_row = B[v].s31 * lanes + el + 1;
                        sh->exit_strip = B[v].s31;
                    }
                    sh->folded = B[v].s31 + 1;
                    B[v].fold = false;
                    if (el >= 0) {
                        stopped[v] = 1;
                        running--;
                    }
                } else if (a == kBlockStep) {
                    std::vector<WideLane>& W = L[v];
                    left[v]--;
                    W[0].take_row(row, P);
                    for (int k = 0; k < lanes; k++) {
                        int32_t b;
                        const int32_t qc =
                            W[k].j == 0 ? P.query_code(W[k].i) : 0;
                        out[k] = W[k].cell_step(
                            P, qc, P.ref_code(W[k].i, W[k].j), b);
                        if (W[k].j == 0)
                            R[v][k] = block_row(plane, ql, w, W[k].i);
                        block_store(R[v][k], w, W[k].j, b,
                                    units + ((int64_t)v * lanes + k) * 16);
                    }
                    const int32_t j31 = W[lanes - 1].j;
                    if (j31 >= 0 && j31 < w) {
                        row[j31] = out[lanes - 1];
                        if (B[v].publishes(P))
                            sh->prog[v] = B[v].progress();
                    }
                    for (int k = lanes - 1; k >= 0; k--)
                        W[k].advance(out[k > 0 ? k - 1 : 0], P, nt);
                    B[v].advance(P);
                }
                return a;
            };
            while (running > 0) {
                int v;
                if (schedule == 0) {
                    v = turn++ % warps;
                } else if (schedule == 1) {
                    // The other warps in turn, one pass; the held warp
                    // only after a pass in which none moved.
                    bool moved = false;
                    for (int u = 0; u < warps; u++) {
                        if (u == held || stopped[u]) continue;
                        const int a = act(u);
                        moved |= a == kBlockStep || a == kBlockFold ||
                                 a == kBlockStop;
                    }
                    if (moved || stopped[held]) {
                        idle = moved ? 0 : idle + 1;
                        if (idle > 2) return 1;
                        continue;
                    }
                    v = held;
                } else {
                    rng = rng * 6364136223846793005ull +
                          1442695040888963407ull;
                    v = (int)((rng >> 33) % (uint64_t)warps);
                }
                if (stopped[v]) continue;
                const int a = act(v);
                idle = a == kBlockWait ? idle + 1 : 0;
                if (idle > 64 * warps + 1000) return 1;
            }
        }
        const int64_t x0 = ((int64_t)sh->exit_row + 1) * w;
        for (int t = 0; t < nt; t++)
            copy_share(t, plane + x0, (ql + 1) * w - x0, FillSrc{x0, w, bw2},
                       nt);
        score[p] = sh->run_v;
        maxi[p] = sh->run_i;
        maxj[p] = sh->run_j;
    }
    return 0;
}

// The chain DP by teams of T threads with K nodes a thread (K * T >= n;
// T = 0 takes the kernel's team for n, chain_team): the threads' bodies
// in a C loop in place of each barrier (load, the pair tests, then a step
// at each set bit), the team's shared memory and the node records in two
// slots prefilled with garbage, the merge as the kernel's shuffles (lane
// l takes lane l + off's best; the top lanes their own) within warps of 32
// and then over the warps' bests; returns 1 for a team's shared memory
// that is not 16-byte aligned.  steps[range]: the steps taken;
// windows[range]: 1 where the pair tests took the SQO window.
template <int K>
static int chain_teams(int T, const int32_t* sqo, const int32_t* eqo,
                       const int32_t* diag, const int32_t* len,
                       const uint8_t* valid, int64_t b, int32_t n,
                       const ytsw::ChainParams& p, int32_t* best,
                       int32_t* best_score, int32_t* prev,
                       int32_t* path_sqo, int32_t* steps,
                       int32_t* windows) {
    using namespace ytsw;
    std::vector<ChainLane<K>> lanes(T);
    const int warps = (T + 31) / 32;
    std::vector<ChainBest> v(32 * warps), nv(32 * warps);
    // Four teams' shared memory back to back, as a block of four warps
    // has it: range pb takes the (pb % 4)-th, which must stay 16-byte
    // aligned.
    const int64_t tb = chain_team_bytes(n);
    std::vector<ChainStatic> mem((4 * tb + 15) / 16);
    for (int64_t pb = 0; pb < b; pb++) {
        const int64_t base = pb * n;
        uint8_t* team = (uint8_t*)mem.data() + (pb % 4) * tb;
        if ((uintptr_t)team & 15) return 1;
        memset(team, 0x5A, tb);
        ChainStatic* st = (ChainStatic*)team;
        int32_t* jend = (int32_t*)(team + 16 * (int64_t)n);
        uint32_t* bits = (uint32_t*)(team + 20 * (int64_t)n);
        for (int32_t x = 0; x < (n + 31) / 32; x++) bits[x] = 0;
        for (int t = 0; t < T; t++)
            lanes[t].load(sqo + base, eqo + base, diag + base, len + base,
                          valid + base, n, t, T, p, st);
        int32_t last = -1;
        for (int t = 0; t < T; t++)
            last = std::max(last, lanes[t].last_valid(t, T));
        bool windowed = chain_window_params(p);
        for (int t = 0; t < T; t++)
            windowed = lanes[t].window_ok(st, t, T) && windowed;
        for (int t = 0; t < T; t++)
            lanes[t].mark(st, jend, bits, last, windowed, t, T, p);
        ChainState rec[2];
        memset(rec, 0x5A, sizeof rec);
        int32_t i = chain_next_bit(bits, 0, n);
        if (i < n)
            for (int t = 0; t < T; t++) lanes[t].publish(i, t, T, &rec[0]);
        steps[pb] = 0;
        for (int slot = 0; i < n; slot ^= 1) {
            const ChainState si = rec[slot];
            for (int t = 0; t < T; t++)
                lanes[t].relax(st, i, jend[i], si, t, T, p);
            const int32_t nx = chain_next_bit(bits, i + 1, n);
            if (nx < n)
                for (int t = 0; t < T; t++)
                    lanes[t].publish(nx, t, T, &rec[slot ^ 1]);
            steps[pb]++;
            i = nx;
        }
        windows[pb] = windowed;
        for (int t = 0; t < T; t++)
            lanes[t].store(prev + base, path_sqo + base, n, t, T);
        const ChainBest none = {-1, 0, 0, 0};
        for (int l = 0; l < 32 * warps; l++)
            v[l] = l < T ? lanes[l].fold(st, l, T) : none;
        for (int rnd = 0; rnd < 2; rnd++) {
            const int nw = rnd ? 1 : warps;
            if (rnd)
                for (int l = 0; l < 32; l++) v[l] = l < warps ? v[32 * l]
                                                              : none;
            for (int off = 16; off > 0; off >>= 1) {
                for (int l = 0; l < 32 * nw; l++) {
                    const int src = l % 32 + off < 32 ? l + off : l;
                    nv[l] = chain_merge(v[l], v[src]);
                }
                v.swap(nv);
            }
        }
        best[pb] = v[0].idx;
        best_score[pb] = v[0].idx < 0 ? CHAIN_NO_SCORE : v[0].score;
    }
    return 0;
}

extern "C" int run_chain(int K, int T, const int32_t* sqo,
                         const int32_t* eqo, const int32_t* diag,
                         const int32_t* len, const uint8_t* valid,
                         int64_t b, int32_t n, const int32_t* kw,
                         int32_t* best, int32_t* best_score, int32_t* prev,
                         int32_t* path_sqo, int32_t* steps,
                         int32_t* windows) {
    const ytsw::ChainParams p = {kw[0], kw[1], kw[2], kw[3], kw[4]};
    if (T == 0) ytsw::chain_team(n, &K, &T);
    if (T == 0 || (int64_t)K * T < n) return 1;
    switch (K) {
#define YT_K(kk)                                                         \
    case kk:                                                             \
        return chain_teams<kk>(T, sqo, eqo, diag, len, valid, b, n, p,  \
                               best, best_score, prev, path_sqo, steps, \
                               windows);
    YT_K(1)
    YT_K(2)
    YT_K(4)
    YT_K(8)
#undef YT_K
    }
    return 1;
}
"""

REG_WIDTHS = (13, 21, 33)
# The wide body at the widths it serves (W = 1 and W >= 37) and at W = 21.
WIDE_WIDTHS = (1, 21, 37, 65)
# (band_width, x_cutoff, max_gap, max_intron, err, scoring, short
# references, indel inputs); the body tests set band_width from W.
CASES = [sweep + (KW, False, False) for sweep in EXT_SWEEP] + [
    (5, 25, 50, 50, 0.15, KW_WRAP, False, False),
    (5, 25, 50, 50, 0.15, KW, True, False)]
CASE_IDS = EXT_SWEEP_IDS + ["wrap", "short_r"]
# Indel inputs: X-drop at 80, so that paths out to the band's outer
# columns survive their gap; and with binding run caps and short
# references.
WIDE_CASES = CASES + [(9, 80, 50, 50, 0.05, KW, False, True),
                      (9, 25, 2, 3, 0.05, KW, True, True)]
WIDE_CASE_IDS = CASE_IDS + ["indel", "indel_caps_short_r"]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("csrc")
    src = d / "ext_loop.cpp"
    src.write_text(C_LOOP)
    so = d / "libext_loop.so"
    res = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                          "-I", CSRC, "-o", str(so), str(src)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    out = ct.CDLL(str(so))
    ext_args = ([ct.c_void_p] * 4 + [ct.c_int64] * 3 + [ct.c_int32] +
                [ct.c_void_p] * 5)
    out.run_ext.restype = ct.c_int
    out.run_ext.argtypes = [ct.c_int] + ext_args
    out.run_ext_wide.restype = None
    out.run_ext_wide.argtypes = ext_args
    out.run_ext_block.restype = ct.c_int
    out.run_ext_block.argtypes = [ct.c_int, ct.c_int, ct.c_uint32] + ext_args
    out.run_anch.restype = ct.c_int
    out.run_anch.argtypes = ([ct.c_int] * 4 + [ct.c_void_p] * 6 +
                             [ct.c_int64] * 3 + [ct.c_int32] +
                             [ct.c_void_p] * 3)
    out.run_walk.restype = ct.c_int
    out.run_walk.argtypes = ([ct.c_int, ct.c_int64, ct.c_int, ct.c_void_p] +
                             [ct.c_int64] * 3 + [ct.c_void_p] * 3 +
                             [ct.c_int64] + [ct.c_void_p] * 2)
    out.run_gather.restype = None
    out.run_gather.argtypes = ([ct.c_void_p, ct.c_int64, ct.c_int64,
                                ct.c_void_p, ct.c_int64, ct.c_void_p] +
                               [ct.c_int64] * 3 + [ct.c_int32] +
                               [ct.c_void_p] * 2 + [ct.c_int])
    out.run_seed_hashes.restype = ct.c_int
    out.run_seed_hashes.argtypes = [ct.c_void_p, ct.c_int64, ct.c_int64,
                                    ct.c_void_p, ct.c_int32, ct.c_void_p,
                                    ct.c_void_p]
    out.run_chain.restype = ct.c_int
    out.run_chain.argtypes = ([ct.c_int] * 2 + [ct.c_void_p] * 5 +
                              [ct.c_int64, ct.c_int32] + [ct.c_void_p] * 7)
    out.run_expand_sort.restype = None
    out.run_expand_sort.argtypes = ([ct.c_void_p] * 2 + [ct.c_int64] * 2 +
                                    [ct.c_void_p] * 2 +
                                    [ct.c_int32, ct.c_int32, ct.c_int64,
                                     ct.c_int64] +
                                    [ct.c_void_p] * 6)
    out.run_merge.restype = ct.c_int
    out.run_merge.argtypes = ([ct.c_void_p] * 2 + [ct.c_int32] +
                              [ct.c_int64] * 2 + [ct.c_void_p] * 4)
    out.wide_warp_bytes.restype = ct.c_int64
    out.wide_warp_bytes.argtypes = [ct.c_int64]
    out.wide_smem_max.restype = ct.c_int64
    out.wide_smem_max.argtypes = []
    out.ext_block_bytes.restype = ct.c_int64
    out.ext_block_bytes.argtypes = [ct.c_int64]
    out.ext_block_warps.restype = ct.c_int
    out.ext_block_warps.argtypes = []
    return out


def _inputs(bw, err, short, seed, indel):
    if indel:
        q, qlens, r, rlens = indel_extension_inputs(seed, 300, 64, bw, err)
    else:
        q, qlens, r, rlens = extension_inputs(seed, 300, 24, bw, err)
    if short:
        rng = np.random.default_rng(seed + 1)
        rlens = rng.integers(1, rlens + 1)
    return q, qlens.astype(np.int32), r, rlens.astype(np.int32)


def _run(lib, variant, bw, kw, q, qlens, r, rlens):
    """The register body (variant 1, or 2 with every row predicated) on
    zeroed planes, or the wide body ("wide") or the block body (("block",
    warps, schedule, seed)) on planes and outputs prefilled with garbage:
    they must write every byte."""
    n, ql = q.shape
    w = 4 * bw + 1
    wide = variant == "wide" or isinstance(variant, tuple)
    fill = UNWRITTEN_BT if wide else 0
    out = {"bt": np.full((n, ql + 1, w), fill, np.int8)}
    for key in ("score", "maxi", "maxj"):
        out[key] = np.full(n, UNWRITTEN if wide else 0, np.int32)
    params = np.array([kw["go"], kw["ge"], kw["rc"], kw["ms"], kw["max_gap"],
                       kw["max_intron"], kw["x_cutoff"]], np.int32)
    arrays = [np.ascontiguousarray(a) for a in (q, r, qlens, rlens)]
    args = ([a.ctypes.data for a in arrays] +
            [n, ql, r.shape[1], 2 * bw, params.ctypes.data] +
            [out[k].ctypes.data for k in ("bt", "score", "maxi", "maxj")])
    if variant == "wide":
        lib.run_ext_wide(*args)
    elif wide:
        assert lib.run_ext_block(*variant[1:], *args) == 0, "deadlock"
    else:
        assert lib.run_ext(variant, *args) == 0
    return out


def _equal_outputs(got, want, label):
    for key in ("score", "maxi", "maxj", "bt"):
        np.testing.assert_array_equal(got[key], want[key].numpy(),
                                      err_msg="%s %s" % (label, key))


def _check(lib, variants, bw, case, seed):
    _, xc, mg, mi, err, scoring, short, indel = case
    kw = dict(scoring, band_width=bw, x_cutoff=xc, max_gap=mg,
              max_intron=mi)
    q, qlens, r, rlens = _inputs(bw, err, short, seed, indel)
    want = sw_cuda.extension_forward_reference(
        *(torch.from_numpy(a) for a in (q, qlens, r, rlens)), **kw)
    for variant in variants:
        got = _run(lib, variant, bw, kw, q, qlens, r, rlens)
        _equal_outputs(got, want, "variant %s" % (variant,))
    return qlens, want


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("w", REG_WIDTHS)
def test_register_body_matches_plain(lib, w, case):
    bw = (w - 1) // 4
    qlens, want = _check(lib, (1, 2), bw, case, seed=w * 100 + case[1])
    if case[1] < 10:
        # The X-drop point exits early: most problems stop short of their
        # last query row.
        assert (want["maxi"].numpy() < qlens).mean() > 0.5


# The block body's schedules: lockstep, one warp held back, random.
BLOCK_SCHEDULES = ((0, 0), (1, 0), (2, 11))


@pytest.mark.parametrize("case", WIDE_CASES, ids=WIDE_CASE_IDS)
@pytest.mark.parametrize("w", WIDE_WIDTHS)
def test_wide_body_matches_plain(lib, w, case):
    """The wide kernel's lane step, fold and copies over an emulated warp,
    and the block kernel's warps under each schedule: every byte of the
    plane (garbage before), score, maxi and maxj equal the plain
    version's."""
    bw = (w - 1) // 4
    k = lib.ext_block_warps()
    qlens, want = _check(lib, ["wide"] + [("block", k) + sch
                                         for sch in BLOCK_SCHEDULES], bw,
                         case, seed=w * 100 + case[1])
    if case[1] < 10:
        assert (want["maxi"].numpy() < qlens).mean() > 0.5
    if case[7] and case[1] > 25 and w > 1:
        # Some best cells lie past half the band's reach from its centre.
        off = np.abs(want["maxj"].numpy() - 2 * bw)
        assert off.max() > bw


# (band_width, QL, divergence rows, problems): exits in the first strip
# (rows 1-32), in a middle strip while the warps of later strips run ahead,
# and on the last row; at W 1, 21 and 65 over ten strips (every warp, and
# warp 0 again), at W 2,833 (-BW 708, the first width past the wide
# kernel's) over three, and at W 12,909 (-BW 3,227, past the first
# version's 12,905) over two.
BLOCK_XDROP = [(0, 300, (5, 140, 300), 6), (5, 300, (5, 140, 300), 6),
               (16, 300, (5, 140, 300), 6), (708, 72, (5, 40, 72), 4),
               (3227, 33, (5, 33), 4)]


@pytest.fixture(scope="module")
def block_cases():
    """Each BLOCK_XDROP case's inputs and plain outputs, made once."""
    out = {}
    for bw, ql, div, n in BLOCK_XDROP:
        arrs = xdrop_extension_inputs(bw + ql, n, ql, bw, div)
        arrs = [a.astype(np.int32) if a.dtype == np.int64 else a
                for a in arrs]
        kw = dict(KW, band_width=bw, x_cutoff=25)
        with torch.inference_mode():
            want = sw_cuda.extension_forward_reference(
                *(torch.from_numpy(a) for a in arrs), **kw)
        out[bw] = (arrs, kw, want)
    return out


@pytest.mark.parametrize("schedule,seed", BLOCK_SCHEDULES,
                         ids=["lockstep", "held_back", "random"])
@pytest.mark.parametrize("warps", [2, "kernel"])
@pytest.mark.parametrize("bw", [c[0] for c in BLOCK_XDROP],
                         ids=["W%d" % (4 * c[0] + 1) for c in BLOCK_XDROP])
def test_block_body_matches_plain(lib, block_cases, bw, warps, schedule,
                                  seed):
    """ext_block_kernel's warps (2, and the kernel's count) under each
    schedule, on problems whose X-drop exit falls in the first strip, in
    a middle strip or on the last row: every byte of the plane (garbage
    before, shared memory garbage too), score, maxi and maxj equal the
    plain version's, with no deadlock."""
    (q, qlens, r, rlens), kw, want = block_cases[bw]
    k = lib.ext_block_warps() if warps == "kernel" else warps
    got = _run(lib, ("block", k, schedule, seed), bw, kw, q, qlens, r, rlens)
    _equal_outputs(got, want, "block")
    # The best rows (the exits come a few rows later): in the first strip,
    # in a middle one, and on the last row.
    ql = q.shape[1]
    strips = (want["maxi"].numpy() - 1) // 32
    assert strips.min() == 0 and want["maxi"].numpy().max() == ql
    if ql > 64:
        assert ((strips > 0) & (strips < (ql - 1) // 32)).any()


def test_ptxas_report_reads_registers_and_spills():
    """The build's ptxas -v lines, as chip_smoke.py reads them to refuse a
    register kernel that spills or uses a stack frame."""
    from yaha_tpu_torch.ops import _build
    name = "_ZN12_GLOBAL__N_114ext_reg_kernelILi21EEEvlPKhl"
    log = ("ptxas info    : 0 bytes gmem\n"
           "ptxas info    : Compiling entry function '%s' for 'sm_90a'\n"
           "ptxas info    : Function properties for %s\n"
           "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill "
           "loads\n"
           "ptxas info    : Used 168 registers, used 0 barriers, 440 bytes "
           "cmem[0]\n" % (name, name))
    assert _build.ptxas_report(log) == {name: {
        "stack": 8, "spill_stores": 4, "spill_loads": 12,
        "registers": 168}}


# ---- the anchored gap fill ----

# (tier, kmin, mode) of run_anch: the wide route alone; each problem in
# its own register class (wide ones through the wide route), raised to 16
# and to 32 as in a warp with a wider lane; every row with at least the
# right-edge predicates, or both edges; warps of 32 routed as the kernels
# route them.
ANCH_ROUTES = [(0, 0, 0), (1, 8, 0), (1, 16, 0), (1, 32, 0), (1, 8, 1),
               (1, 16, 2), (1, 32, 2), (2, 0, 2)]
UNWRITTEN_BT = 0x5A


def _anch_body(lib, full, route, args, wband, kw):
    """run_anch on planes and scores prefilled with garbage: every route
    must write every byte."""
    q, qlens, r, rlens, lbw, rbw = (
        np.ascontiguousarray(a.astype(np.uint8 if k in (0, 2) else np.int32))
        for k, a in enumerate(args))
    n, ql = q.shape
    rl = r.shape[1]
    w = rl + 1 if full else wband
    bt = np.full((n, ql + 1, w), UNWRITTEN_BT, np.int8)
    score = np.full(n, UNWRITTEN, np.int32)
    params = np.array([kw[k] for k in ("go", "ge", "rc", "ms", "max_gap",
                                       "max_intron")], np.int32)
    rc = lib.run_anch(int(full), *route, *(a.ctypes.data for a in (
        q, r, qlens, rlens, lbw, rbw)), n, ql, rl, wband, params.ctypes.data,
        bt.ctypes.data, score.ctypes.data)
    assert rc == 0
    return {"score": score, "bt": bt}


def _anch_check(lib, args, kw, full, wband=None, routes=ANCH_ROUTES):
    """Every route of run_anch against the plain version: score and the
    whole plane equal.  Returns the width classes the problems took."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if full:
        want = sw_cuda.anchored_forward_reference(*t, **kw)
        live = np.clip(args[3], 0, args[2].shape[1])
    else:
        wband = wband or 1 << int((args[4] + args[5]).max()).bit_length()
        want = sw_cuda.anchored_forward_banded_reference(*t, wband=wband,
                                                         **kw)
        want["bt"] = want.pop("bt_b")
        live = np.clip(args[4].astype(np.int64) + args[5] + 1, 0, wband)
    for route in routes:
        got = _anch_body(lib, full, route, args, wband or 0, kw)
        for key in ("score", "bt"):
            np.testing.assert_array_equal(
                got[key], want[key].numpy(),
                err_msg="route %s %s" % (route, key))
    return {c for c in (8, 16, 32, 0) if (np.array(
        [0 if v > 32 else 8 if v <= 8 else 16 if v <= 16 else 32
         for v in live]) == c).any()}


ANCH_CASES = ANCH_SWEEP_IDS + ["wrap", "edges"]


def _anch_inputs(case):
    if case == "edges":
        return anchored_edge_inputs(5), KW
    if case == "wrap":
        return anchored_sweep_inputs(*ANCH_SWEEP[0][:2]), KW_WRAP
    seed, d, mg, mi = ANCH_SWEEP[ANCH_SWEEP_IDS.index(case)]
    return anchored_sweep_inputs(seed, d), dict(KW, max_gap=mg,
                                                 max_intron=mi)


@pytest.mark.parametrize("case", ANCH_CASES)
@pytest.mark.parametrize("full", [False, True], ids=["banded", "full"])
def test_anchored_bodies_match_plain(lib, full, case):
    """The register bodies (AnchBand<K>, AnchFull<K> of
    csrc/anch_kernels.cu) in every class, as a lone problem and with every
    row predicated, the wide problems through the wide route (an emulated
    warp a problem), the wide route alone and the kernels' routing by
    warps; the planes start as garbage, and every route must write every
    byte."""
    args, kw = _anch_inputs(case)
    classes = _anch_check(lib, args, kw, full)
    assert classes == {8, 16, 32, 0} if case == "edges" else \
        len(classes) >= 2


@pytest.mark.parametrize("wband", [64, 512])
def test_anchored_bodies_narrow_in_wide_planes(lib, wband):
    """Narrow problems (the register classes) in planes of 64 and 512
    band columns: every byte past the live width is written 0."""
    args = list(anchored_edge_inputs(9, n=48, ql=24, rl=30))
    args[4] = np.minimum(args[4], 12)
    args[5] = np.minimum(args[5], 12)
    assert _anch_check(lib, args, KW, False, wband=wband) == {8, 16, 32}


@pytest.mark.parametrize("full", [False, True], ids=["banded", "full"])
@pytest.mark.parametrize("k", [8, 16, 32])
def test_anchored_bodies_plane_as_wide_as_class(lib, full, k):
    """Planes exactly as wide as the register class's staged row (wband =
    K, RL + 1 = K + 1): the rows go out as one copy of whole words, from
    staged rows and to plane rows at every byte offset."""
    args = list(anchored_sweep_inputs(k, 2, n=64, ql=min(20, k), rl=k))
    if not full:
        args[4] = np.minimum(args[4], k // 2 - 1)
        args[5] = np.minimum(args[5], k // 2)
    assert k in _anch_check(lib, args, KW, full, wband=k)


@pytest.mark.parametrize("case,classes", [
    ("D260_banded", {0}), ("D260_full", {0}), ("I40_banded", {0}),
    ("I260_full", {16})])
def test_anchored_bodies_long_runs(lib, case, classes):
    """One gap run of 40 or 260 bases: a deletion at wband 512 and at full
    width and a 40-base insertion at wband 64 go to the wide route, a
    260-base insertion at full width (16 reference columns) to the
    register class 16 for 276 rows."""
    length = int(case[1:4].rstrip("_"))
    args = long_run_inputs(case[0], length)
    kw = dict(KW, max_gap=length + 40, max_intron=length + 40)
    full = case.endswith("full")
    assert _anch_check(lib, args, kw, full, routes=[
        (0, 0, 0), (1, 8, 0), (1, 32, 2)]) == classes


# ---- the backtrack walk ----

# (team, window bytes).
WALK_ROUTES = [(t, s) for t in (8, 16, 32) for s in (16, 64, 512)]
UNWRITTEN = 0x5A5A5A5A


def _walk_planes(case):
    """(bt, y0, x0, active, full) of one plane set, as torch CPU tensors."""
    if case == "extension":
        args = [torch.from_numpy(a) for a in extension_inputs(3, 200, 40, 3)]
        out = sw_cuda.extension_forward(*args, band_width=3, x_cutoff=25,
                                        **KW)
        return out["bt"], out["maxi"], out["maxj"], out["score"] > 0, False
    if case in ("D260", "I260", "D600", "D260_full", "I600_full"):
        length = int(case[1:4])
        args = [torch.from_numpy(a)
                for a in long_run_inputs(case[0], length)]
        kw = dict(KW, max_gap=length + 40, max_intron=length + 40)
        qlen, rlen, lbw = (int(args[k][0]) for k in (1, 3, 4))
        y0 = torch.tensor([qlen], dtype=torch.int32)
        if case.endswith("_full"):
            bt = sw_cuda.anchored_forward(*args, **kw)["bt"]
            return bt, y0, torch.tensor([rlen]), torch.ones(1, dtype=bool), \
                True
        wband = 1 << (lbw + int(args[5][0])).bit_length()
        bt = sw_cuda.anchored_forward_banded(*args, wband=wband,
                                             **kw)["bt_b"]
        return bt, y0, torch.tensor([rlen - qlen + lbw]), \
            torch.ones(1, dtype=bool), False
    args = [torch.from_numpy(a) for a in anchored_sweep_inputs(
        *ANCH_SWEEP[1][:2], n=150, ql=30, rl=36)]
    q, qlens, r, rlens, lbw, rbw = args
    ones = torch.ones(len(qlens), dtype=torch.bool)
    if case == "banded":
        wband = int((lbw + rbw).max()) + 1
        bt = sw_cuda.anchored_forward_banded(*args, wband=wband,
                                             **KW)["bt_b"]
        return bt, qlens, rlens - qlens + lbw, ones, False
    bt = sw_cuda.anchored_forward(*args, **KW)["bt"]
    return bt, qlens, rlens, ones, True


def _every_cell(bt, full, k=3):
    """The first k planes, each walked from every cell and from four cells
    outside it (rows -1 and h, columns -1 and w), half of them inactive."""
    n, h, w = bt.shape
    ys, xs = np.meshgrid(np.arange(-1, h + 1), np.arange(-1, w + 1),
                         indexing="ij")
    ys, xs = ys.ravel(), xs.ravel()
    planes = bt[:k].repeat_interleave(len(ys), 0).contiguous()
    y0 = torch.from_numpy(np.tile(ys, k).astype(np.int32))
    x0 = torch.from_numpy(np.tile(xs, k).astype(np.int32))
    active = torch.from_numpy(np.arange(len(y0)) % 7 != 3)
    return planes, y0, x0, active, full


def _walk_body(lib, team, window, bt, y0, x0, active, cap, full):
    n, h, w = bt.shape
    rle = np.full((n, cap), UNWRITTEN, np.int32)
    n_ops = np.full(n, UNWRITTEN, np.int32)
    arrs = [np.ascontiguousarray(a.numpy()) for a in (
        bt, y0.to(torch.int32), x0.to(torch.int32), active.to(torch.uint8))]
    rc = lib.run_walk(team, window, int(full), arrs[0].ctypes.data, n, h, w,
                      *(a.ctypes.data for a in arrs[1:]), cap,
                      rle.ctypes.data, n_ops.ctypes.data)
    assert rc == 0
    return rle, n_ops


def _walk_check(lib, planes, cap, routes=WALK_ROUTES):
    bt, y0, x0, active, full = planes
    want_rle, want_n = (a.numpy() for a in decode.rle_walk_reference(
        bt, y0, x0, active, cap=cap, full=full))
    stored = np.where(want_n < 0, cap, want_n)
    written = np.arange(cap)[None, :] < stored[:, None]
    for team, window in routes:
        rle, n_ops = _walk_body(lib, team, window, bt, y0, x0, active, cap,
                                full)
        tag = "team %d window %d" % (team, window)
        np.testing.assert_array_equal(n_ops, want_n, err_msg=tag)
        np.testing.assert_array_equal(np.where(written, rle, 0), want_rle,
                                      err_msg=tag)
        assert (rle[~written] == UNWRITTEN).all(), tag
    return want_n


WALK_CASES = ["extension", "banded", "full", "D260", "I260", "D600",
              "D260_full", "I600_full"]


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_bodies_match_plain(lib, case):
    """Every team and window size on one plane set at a cap that no walk
    reaches; the long-run sets are one walk with a run longer than every
    window (a delete run along a row, an insert run up its chain)."""
    n_ops = _walk_check(lib, _walk_planes(case), cap=256)
    assert (n_ops > 0).any() and (n_ops >= 0).all()


@pytest.mark.parametrize("case", ["extension", "banded", "full"])
def test_walk_bodies_overflow_cap(lib, case):
    """At cap 3 walks keep their first 3 items and report n_ops = -1."""
    n_ops = _walk_check(lib, _walk_planes(case), cap=3)
    assert (n_ops == -1).any() and (n_ops >= 0).any()


@pytest.mark.parametrize("case", ["extension", "banded", "full"])
def test_walk_bodies_from_every_cell(lib, case):
    """Walks that start in every row and column of a plane, so in the first
    and the last row of every window, and outside the plane; inactive and
    OP_UNKNOWN starts emit nothing."""
    planes = _every_cell(*(_walk_planes(case)[k] for k in (0, 4)))
    n_ops = _walk_check(lib, planes, cap=64)
    assert (n_ops[~planes[3].numpy()] == 0).all()
    assert (n_ops == 0).sum() > (~planes[3]).sum()   # OP_UNKNOWN starts


# ---- the problem gather ----

def _gather_body(lib, rows2, codes, coords, qg, rg, rpad, out_off,
                 backwards):
    """gather_problem over every problem (last to first when `backwards`,
    so a store past the end of a row lands on a row already written), its
    q and r rows written `out_off` bytes past a 64-byte boundary; the
    bytes around the rows must stay 0."""
    m = coords.shape[1]
    bufs = [np.zeros(m * g + out_off + 64, np.uint8) for g in (qg, rg)]
    views = []
    for b, g in zip(bufs, (qg, rg)):
        start = (-b.ctypes.data) % 64 + out_off
        views.append(b[start:start + m * g])
    lib.run_gather(rows2.ctypes.data, rows2.shape[0], rows2.shape[1],
                   codes.ctypes.data, len(codes), coords.ctypes.data, m, qg,
                   rg, rpad, views[0].ctypes.data, views[1].ctypes.data,
                   int(backwards))
    for b, v in zip(bufs, views):
        assert b.sum() == v.sum(dtype=np.int64)   # nothing written outside
    return [v.reshape(m, g) for v, g in zip(views, (qg, rg))]


@pytest.mark.parametrize("qg,rg", [(64, 96), (40, 75), (48, 1044 % 80)],
                         ids=["64x96", "40x75", "48x4"])
@pytest.mark.parametrize("rpad", [0, 255])
@pytest.mark.parametrize("src_off", [0, 5])
def test_gather_body_matches_plain(lib, qg, rg, rpad, src_off):
    """Random coordinates (gather_coords), every source alignment forward
    and reversed (gather_aligned_coords) and clamped sources at both ends
    of the genome and the rows (gather_clamp_coords); the genome and the
    strand rows start `src_off` bytes past an aligned address and the
    output rows at offsets 0, 3 and 8, problems in both orders."""
    g, fwd, lens = gather_case(41)
    rows2 = read_rows(gather_dp.DeviceCorpus(g, "cpu"), fwd, lens).numpy()
    nrows, lpad = rows2.shape
    coords = np.concatenate([
        np.stack(gather_coords(7, 200, qg, rg, 0.5)).astype(np.int64),
        np.stack(gather_aligned_coords(qg, rg, lpad, len(g), nrows)),
        np.stack(gather_clamp_coords(qg, rg, len(g), nrows))], axis=1)
    want = gather_dp.gather_reference(
        torch.from_numpy(rows2), torch.from_numpy(g),
        torch.from_numpy(coords), qg=qg, rg=rg, rpad=rpad)

    def shifted(a):
        buf = np.zeros(a.size + 64, np.uint8)
        start = (-buf.ctypes.data) % 16 + src_off
        out = buf[start:start + a.size].reshape(a.shape)
        out[...] = a
        return out
    coords = np.ascontiguousarray(coords)
    for out_off, backwards in ((0, False), (3, False), (3, True),
                               (8, True)):
        got = _gather_body(lib, shifted(rows2), shifted(g), coords, qg, rg,
                           rpad, out_off, backwards)
        for w_, g_, name in zip(want, got, "qr"):
            np.testing.assert_array_equal(
                g_, w_.numpy(), err_msg="%s out_off %d backwards %s" % (
                    name, out_off, backwards))


# ---- the seed phase ----

def _hash_body(lib, codes, lens, wl, shift=0):
    """run_seed_hashes on codes placed `shift` bytes past a 16-byte
    boundary, outputs prefilled with garbage."""
    b, l = codes.shape
    n = l - wl + 1
    buf = np.zeros(codes.size + 32, np.uint8)
    start = (-buf.ctypes.data) % 16 + shift
    placed = buf[start:start + codes.size].reshape(codes.shape)
    placed[...] = codes
    hashes = np.full((b, n), UNWRITTEN, np.int32)
    clean = np.full((b, n), 0x5A, np.uint8)
    assert lib.run_seed_hashes(placed.ctypes.data, b, l, lens.ctypes.data,
                               wl, hashes.ctypes.data, clean.ctypes.data) == 0
    return hashes, clean


def _hash_plain(codes, lens, wl):
    h, c = seeds.seed_hashes_reference(torch.from_numpy(codes),
                                       torch.from_numpy(lens), word_len=wl)
    return h.numpy(), c.numpy()


# (word length, row length, shift): the seed rows (l None), and rows
# whose 16-window runs cross row ends (hash_rows) at three alignments.
HASH_BODY_CASES = [pytest.param(wl, None, 0, id=str(wl))
                   for wl in (4, 11, 15)] + [
    pytest.param(wl, l, shift, id="%s-shift%d" % (i, shift))
    for (wl, l), i in zip(HASH_SHAPES, HASH_SHAPE_IDS) for shift in (0, 5, 15)]


@pytest.mark.parametrize("wl,l,shift", HASH_BODY_CASES)
def test_seed_hash_body_matches_plain(lib, wl, l, shift):
    """seed_hash_run over every 16-window run: the seed rows (N and X
    codes, reads shorter than the word, pad code 4; N = 1,021, 1,014 and
    1,010, so runs cross row ends), and rows whose window counts end at
    every place of a run, rows of fewer windows than a run and a short
    last run, placed at every alignment; outputs prefilled with
    garbage."""
    codes, lens = (seed_rows(wl, n_wrapped=2) if l is None else
                   hash_rows(wl + l, wl, l))
    got = _hash_body(lib, codes, lens, wl, shift)
    want = _hash_plain(codes, lens, wl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[1].any() and not want[1].all()


def _seed_inputs(case):
    """(hashes, clean, SO, ROA, max_hits, capacity) of a SEED_CASES id."""
    src, so, roa, max_hits, cap = seed_case(case)
    if src[0] == "rows":
        h, c = seeds.seed_hashes_reference(torch.from_numpy(src[1]),
                                           torch.from_numpy(src[2]),
                                           word_len=src[3])
        src = (None, h.numpy(), c.numpy())
    return src[1], src[2], so, roa, max_hits, cap


@pytest.mark.parametrize("case", SEED_CASES)
def test_expand_bodies_match_plain(lib, case):
    """window_run, slot_window, slot_key and the sort's steps, with a
    sequential scan and the shuffles emulated, on the golden index's seed
    rows (rows that overflow 64 and 1,024 hits, wrapped windows), the
    wrapped run at the end of a 128-slot buffer and past a 64-slot one,
    hits of diag >= 2^31 and 0xFFFFFFFF beside the sentinel, 650-hit runs
    across C in rows of three batches and row totals around every sort
    size; every output prefilled with garbage."""
    hashes, clean, so, roa, max_hits, cap = _seed_inputs(case)
    out = _expand_body(lib, hashes, clean, so, roa, max_hits, cap)
    want = seeds.expand_sort_hits_reference(
        *(_t(a) for a in (hashes, clean, so, roa)), max_hits=max_hits,
        capacity=cap)
    _equal_plain(out, want)
    assert out["wrapped"].any()


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _equal_plain(out, want):
    for key, w in want.items():
        got = out[key].view(np.int32) if key == "diag" else out[key]
        np.testing.assert_array_equal(got, w.numpy().astype(got.dtype),
                                      err_msg=key)


def _expand_body(lib, hashes, clean, so, roa, max_hits, cap, hash_lo=0):
    """run_expand_sort on every output prefilled with garbage; so holds
    per + 1 words: the shard of hashes [hash_lo, hash_lo + per)."""
    b, n = hashes.shape
    out = {"diag": np.full((b, cap), UNWRITTEN, np.uint32),
           "qo": np.full((b, cap), UNWRITTEN, np.int32),
           "total": np.full(b, UNWRITTEN, np.int32),
           "overflow": np.full(b, 0x5A, np.uint8),
           "wrapped": np.full((b, n), 0x5A, np.uint8),
           "allwrapped": np.full(b, 0x5A, np.uint8)}
    arrs = [np.ascontiguousarray(a) for a in (hashes, clean, so, roa)]
    lib.run_expand_sort(arrs[0].ctypes.data, arrs[1].ctypes.data, b, n,
                        arrs[2].ctypes.data, arrs[3].ctypes.data, max_hits,
                        hash_lo, len(so) - 1, cap, *(out[k].ctypes.data
                                                     for k in (
                            "diag", "qo", "total", "overflow", "wrapped",
                            "allwrapped")))
    return out


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("case", ["golden1024", "unsigned16", "longrun1024",
                                  "wrapped64"])
def test_expand_shard_bodies_match_plain(lib, case, n_model):
    """The same bodies over one model shard at a time (the shard's range
    and its rebased SO and ROA slice, parallel/mesh.ShardedIndex): equal
    to the plain version with the same range, and the shards' kept hits
    add up to the whole index's."""
    from yaha_tpu_torch.parallel import mesh

    class Idx:
        pass
    hashes, clean, Idx.starting_offs, Idx.roa, max_hits, cap = \
        _seed_inputs(case)
    Idx.word_len = Idx.max_hits = 0
    sidx = mesh.ShardedIndex(Idx, n_model)
    totals = np.zeros(hashes.shape[0], np.int64)
    for m in range(n_model):
        so, roa = sidx.so_local[m], sidx.roa_parts[m]
        lo = int(sidx.hash_lo[m])
        out = _expand_body(lib, hashes, clean, so, roa, max_hits, cap,
                           hash_lo=lo)
        _equal_plain(out, seeds.expand_sort_hits_reference(
            *(_t(a) for a in (hashes, clean, so, roa)), max_hits=max_hits,
            capacity=cap, hash_lo=lo, per=sidx.per))
        totals += out["total"]
    whole = seeds.expand_sort_hits_reference(
        *(_t(a) for a in (hashes, clean, Idx.starting_offs, Idx.roa)),
        max_hits=max_hits, capacity=cap)
    np.testing.assert_array_equal(totals, whole["total"].numpy())


# (shards M, rows b, capacity C): one pass (M 1, 2), two (3, 4), three
# (8); C from 1 to 16,384, so tiles of 2,048 outputs split pairs of runs
# at every pass from C 1,024 on.
MERGE_SHAPES = [(1, 5, 1), (2, 9, 2), (2, 17, 64), (3, 9, 32), (4, 7, 128),
                (2, 3, 1024), (2, 4, 2048), (2, 3, 16384), (4, 4, 1024),
                (4, 3, 4096), (8, 4, 16), (8, 3, 256), (8, 3, 1),
                (8, 3, 2048)]


@pytest.mark.parametrize("m,b,cap", MERGE_SHAPES)
def test_merge_body_matches_plain(lib, m, b, cap):
    """yt_merge_runs' passes and merge_pass_kernel's blocks (the split
    warps' probes, loads, per-thread merges and stores; shared slots,
    outputs and the passes' second buffer prefilled with garbage): equal
    to merge_sorted_runs_reference, torch.sort of the gathered keys, on
    runs with diag >= 2^31, 0xFFFFFFFF beside the sentinel, equal keys
    across runs, full runs, a row of nothing but pads, and a row whose
    runs repeat one valid key (diag 0xFFFFFFFF) over more than half of
    their slots, so that tile edges fall inside a run of equal keys."""
    rng = np.random.default_rng(m * 1000 + cap)
    pool = np.concatenate([rng.integers(0, 1 << 32, 30, dtype=np.uint64),
                           [0, 1, (1 << 31) - 1, 1 << 31, 0xFFFFFFFF]])
    diag = np.full((m, b, cap), 0xFFFFFFFF, np.uint32)
    qo = np.full((m, b, cap), 0x7FFFFFFF, np.int32)
    for k in range(m):
        for r in range(b):
            if r == 2:
                v = int(rng.integers(cap // 2, cap + 1))
                diag[k, r, :v], qo[k, r, :v] = 0xFFFFFFFF, 5
                continue
            v = (cap, 0)[r] if r < 2 else int(rng.integers(0, cap + 1))
            d = rng.choice(pool, v).astype(np.uint32)
            q = rng.integers(0, 8, v).astype(np.int32)
            o = np.lexsort((q, d.astype(np.int64)))
            diag[k, r, :v], qo[k, r, :v] = d[o], q[o]
    out_d, tmp_d = np.full((2, b, m * cap), UNWRITTEN, np.uint32)
    out_q, tmp_q = np.full((2, b, m * cap), UNWRITTEN, np.int32)
    assert lib.run_merge(diag.ctypes.data, qo.ctypes.data, m, b, cap,
                         tmp_d.ctypes.data, tmp_q.ctypes.data,
                         out_d.ctypes.data, out_q.ctypes.data) == 0
    want_d, want_q = seeds.merge_sorted_runs_reference(_t(diag), _t(qo))
    np.testing.assert_array_equal(out_d, want_d.numpy().view(np.uint32))
    np.testing.assert_array_equal(out_q, want_q.numpy())


def test_wide_warp_bytes_copy_matches_c(lib):
    """ops/sw_cuda's copy of the wide routes' shared-memory limit is the C
    one at every plane width 33..4,200, and the block extension's at every
    width 1..15,000 (its warps too), so full_wide_fits, ext_variant and
    ext_wide_fits say what the C entries take."""
    assert sw_cuda.WIDE_SMEM_MAX == lib.wide_smem_max()
    assert sw_cuda.EXT_BLOCK_WARPS == lib.ext_block_warps()
    for w in range(33, 4201):
        assert sw_cuda.wide_warp_bytes(w) == lib.wide_warp_bytes(w), w
    for w in range(1, 15001):
        assert sw_cuda.ext_block_bytes(w) == lib.ext_block_bytes(w), w


def _chain_inputs(case):
    if case.startswith("seed"):
        return chain_case(int(case[4:]), 16, 48)[:5], CHAIN_KW
    if case.startswith("n="):
        n = int(case[2:])
        return chain_case(n, 6, n, qspan=40 * n)[:5], CHAIN_KW
    if case.startswith("ties"):
        return chain_tie_case(int(case[4:])), CHAIN_TIE_KW
    return dict(chain_edge_case())[case], dict(CHAIN_KW, m_score=2)


@pytest.mark.parametrize("team", [(0, 0), (1, 64), (4, 16), (8, 8)],
                         ids=["kernel_team", "k1t64", "k4t16", "k8t8"])
@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "n=300",
                                  "n=3000", "ties0", "ties1", "n1",
                                  "invalid_row", "int16_wrap"])
def test_chain_bodies_match_plain(lib, case, team):
    """ChainLane's load / window_ok / mark / relax / publish / fold /
    store and chain_merge, over the threads of a team in a C loop (the
    kernel's team for N, and teams of other shapes; four teams' shared
    memory back to back, each 16-byte aligned), held to
    chain.batched_chain_dp_ref: the ranges of tests/test_chain_jax.py
    (seeds 0-2), ranges of up to 300 and 3,000 nodes (teams of 256 and 512
    threads), ranges dense in equal scores (every level of the tie cascade
    and full ties in the fold), one-node ranges, a range with no valid
    node and lengths whose scores wrap int16; every output and the shared
    memory prefilled with garbage."""
    args, kw = _chain_inputs(case)
    b, n = args[0].shape
    k, t = team
    if k * t and k * t < n:
        k, t = 1, 1 << (n - 1).bit_length()
    arrs = [np.ascontiguousarray(a, np.uint8 if a.dtype == bool else
                                 np.int32) for a in args]
    out = {key: np.full(shape, UNWRITTEN, np.int32) for key, shape in (
        ("best", b), ("best_score", b), ("prev", (b, n)),
        ("path_sqo", (b, n)), ("steps", b), ("windows", b))}
    params = np.array([kw[key] for key in ("max_gap", "max_desert",
                                           "m_score", "go_cost", "ge_cost")],
                      np.int32)
    assert lib.run_chain(k, t, *(a.ctypes.data for a in arrs), b, n,
                         params.ctypes.data, *(out[key].ctypes.data for key
                                               in ("best", "best_score",
                                                   "prev", "path_sqo",
                                                   "steps", "windows"))) == 0
    want = chain.batched_chain_dp_ref(
        *(torch.from_numpy(a) for a in args), **kw)
    for key, w in want.items():
        np.testing.assert_array_equal(out[key], w.numpy(), err_msg=key)
