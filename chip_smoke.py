#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (yaha_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py        (from the root of a checkout; one card)
  python3 chip_smoke.py --profile DIR
                               where the 1 kb batch's time goes (below)

Phases, each of which raises on failure (the script then exits non-zero):

  1. device and build: the card's name and power limit, the g++ build of
     the port's native host library, and the nvcc build of
     yaha_tpu_torch/csrc (one nvcc per source, in parallel) into a shared
     library; ptxas's registers, stack frame and spills for every kernel,
     and no spill and no stack frame in any instance of the register
     extension kernel, the two anchored register kernels and the two
     anchored wide-route kernels, the windowed walk kernel, the gather
     kernel, either seed kernel or the chain DP kernel (its seven team
     shapes);
  2. every kernel against its plain PyTorch version on the card, on
     numpy-seeded inputs: both extension kernels (the register kernel at
     W = 13, 21 and 33 and every block size; the wide kernel at W = 1,
     21, 37 and 65, with the int32-wrap scoring, an early X-drop, short
     references and reads with an indel of up to 2*bw bases), the two
     anchored kernels (on warps of each width class 8,
     16 and 32 and wider ones, whose problems take the wide route, a warp
     a problem, on planes of up to 1,024 band columns and RL 1,024;
     backtrack planes included; both scorings) and the anchored `*_p4`
     entries
     against the unpacked ones, the problem gather
     (from every source alignment, forward and reversed, rows of 75 and
     1,044 bytes, clamped sources) and the backtrack walk
     (teams of 8, 16 and 32 lanes; counts, and items up to the counts, the
     only slots the kernel writes; a too-small cap and gap runs of 100-300
     bases included), and the seed expansion on two synthetic indexes (the
     wrapped run of tests/test_seeds_jax.py:76-124 at the end of a 128-slot
     tier and past a 64-slot one; hits of diag >= 2^31 and 0xFFFFFFFF
     beside the sentinel): all outputs equal;
  3. the main path: the staged engine of --engine batch-cuda in its
     default configuration (problems assembled on the card, planes walked
     on the card, run-length items back) over one default batch of 16,384
     reads of 1 kb (sampled at 5 % error, half of them with short indels,
     plus simulated split reads) against a 64 Mbp synthetic genome with
     the default L15/S1 index; a cold and a warm run, SAM bytes equal to
     the native C++ engine's, no backtrack plane brought back; launch
     counts of every kernel over the warm run, every extension through
     the register kernel.  Then the A/B configuration (host fetch, planes to the native walkers)
     once on the same batch, with parity;
  4. the wide extension kernel's path: the whole batch at -BW 9 (W = 37)
     and 2,048 of its reads at -BW 16 (W = 65), every extension through
     that kernel; 256 reads of 10 kb,
     and the 105 kb split read of tests/test_long_reads.py, through the
     default configuration; SAM bytes equal to the native engine's each
     time (counts set to 0 before each run and read after it); the port's
     CLI on the repository's golden test set with --device cuda, with the
     host seed scan and with --seed device;
  5. kernel and plain-version times (CUDA events; a kernel's launches
     queued behind a spin on the card, so that the host's time to issue
     them stays out; distinct inputs) at the main path's largest buckets,
     for every kernel, each beside its bound (bytes over the memory rate
     or int32 operations over the int32 rate, from this run's inputs); the
     two extension kernels, and the register kernel's block sizes, in
     turns at the largest 1 kb bucket and at the 10 kb run's widest
     bucket, and so the walk's team sizes; the wide kernel at the largest
     -BW 9 and -BW 16 buckets (its plain version on their first 2,048
     problems) with its lanes' busy share; the two anchored kernels at
     their largest 1 kb buckets both on shuffled
     copies of the bucket and in the main path's problem order (which
     sets the lanes of a warp), with the plane's zero fill alone; the
     4-bit packed extension entry (unpack + kernel) at the largest 1 kb
     bucket; a histogram of every gap launch of the 1 kb, -BW 9, -BW 16,
     10 kb, 105 kb and medium-indel runs: (qg, rg, plane width, N), its
     warps by width class and each class's share of the in-band cells;
     both anchored kernels at the -BW 16 run's gap buckets (each kernel's
     largest, and the one whose warps wider than 32 columns, the wide
     route's, hold the most cells) beside their bounds, ns per in-band
     cell and the share of cells in those warps (a bucket's warps all fall
     in one class, so the wide warps' cost reads against a K32 bucket's),
     and the plain version on the first 256 problems; the medium-indel
     batch: 2,048 reads of 1 kb, each with one insertion or deletion of
     20-60 bases (half of each, uniform length and place) at 5 %
     substitutions, through the default configuration (-BW 5), SAM bytes
     equal to the native engine's, and in each layout (it must send wide
     warps to both) the bucket whose wide warps hold the most cells timed
     as the -BW 16 buckets are;
  6. the device seed phase (--seed device): the 1 kb batch with the
     seeder, the full L15 index uploaded to the card (bytes and seconds),
     a cold and a warm run (counts set to 0 just before the warm run and
     read after it), SAM bytes equal to the native engine's, the seeder's
     stats (launches, bytes, tier-2 retries, phantom and host-scan rows,
     seed wall); the host seed scan and the seeder in turns (begin_s and
     warm wall); the 10 kb reads (tier 2, host-scan rows) and the golden
     readsC_1kb.fasta at -BW 3 -G 20 -M 15 -X 15 (phantom, retry and
     host-scan rows all present) with the seeder, SAM parity each time;
     both seed kernels against their plain versions on the main path's
     own strand rows and tier launches (C = 1,024 on the batch, 8,192 and
     1,024 on its tier-2 population), and timed at their largest launch
     beside their bounds, the expansion beside torch.sort(dim=1) of the
     same keys; the tier-2 launch's time beside its own bound; each
     tier's breakdown on (i) the main path's inputs, (ii) the same at
     max_hits = 1, (iv) at max_hits = 0, (iii) with no clean window and
     (v) the same kept runs from an index held in L2, beside torch.take
     of one SO word a window (the whole table, and folded into its first
     64 MB);
  7. the chain DP, which no engine runs (the JAX package wires it into
     none): numpy-seeded ranges made as tests/test_chain_jax.py makes
     them, a fifth wrapping uint32, at (B, N) = (32,768, 64) (a range a
     strand row of the 1 kb batch, 1-64 nodes) and (512, 2,048) (long
     reads, 1-2,048 nodes); counts set to 0, batched_chain_dp on both,
     counts read; every output equal to the plain version's and, on the
     first 64 ranges of each, to the native chain_dp's; the kernel's time
     beside its bound (int32 operations of the valid pairs, by how far each
     gets in the relaxation, or bytes: chain_window_ops counts the pairs
     the kernel's SQO window leaves, and the first kernel's bound, every
     valid pair's tests by chain_ops, is printed beside it) and the plain
     version's; each shape's candidate DAG (chain_dag): the steps the
     first kernel took (a step for every node up to each range's last
     valid one), the nodes with a candidate successor (the steps the
     kernel takes now) and the longest path;
  8. --engine batch-torch: StagedAligner(backend="torch") on the first
     2,048 reads of the 1 kb batch, one cold run (the warm one took as
     long), SAM bytes equal to the native engine's, beside the default
     engine's warm wall on the same reads; the largest extension bucket's
     lockstep twin beside extension_forward's kernel; the CLI (in this
     process) with --engine batch-torch --device cuda on phase 4's golden
     set (host seed scan and --seed device), with --engine native, and
     one --trace run whose Chrome trace must name a CUDA kernel of the
     port.

  9. the scale-out: the four long-gap reads of
     tests/torch_dp_cases.long_gap_reads at -G 3,600 (gap buckets of RL
     4,096, too wide for the anchored wide route) through the default
     configuration, their buckets on the lockstep twin (gap_twin > 0), SAM
     bytes equal to the native engine's; past -BW 707, where the staged
     wide extension kernel's warp no longer fits, the block kernel (a
     block of warps a problem): equal to the plain version on 16 problems
     of QL 40 that run to their last row at -BW 708 (W 2,833), equal to
     the staged kernel on 256 x 1,024 problems at W 1,025 and 2,829 (on
     problems at 5 % substitutions and on a bucket whose every other
     problem turns random past row 200), timed beside it there and at
     -BW 708, and readsA's first ten reads at -BW 708 (counts set to 0
     just before and read after: the block kernel's launches) with SAM
     bytes equal to the native engine's; the device seeder over the
     hash-range sharded L15 index on (data x model) grids (1 x 2) and
     (2 x 2) of the card, on the 1 kb batch: beside a single-device
     seeder, each grid's cold and warm run (counts set to 0 just before
     the warm run and read after it; the (1 x 2) run's are the merge
     kernel's launches), SAM bytes equal to the native engine's, hit rows
     equal to the single seeder's wherever both serve a row, seed wall,
     per-shard SO and ROA bytes and all_gather_bytes; each shard's
     range-masked expansion and the merge kernel at that run's largest
     launch of each tier (32,768 rows at 2 x 1,024, the tier-2 rows at 2 x
     8,192), and the merge also over four runs (two row orders of the two
     shards' 32,768 rows, 4 x 1,024: two passes), equal to their plain
     versions, timed beside their bounds, the merge beside torch.sort of
     the packed keys; two CLI processes on the
     card (--num-hosts 2, a gloo group on a free local port), on the 1 kb
     batch with the host seed scan and on the golden readsA with --seed
     device --model-shards 2, each merged SAM equal, apart from @PG, to
     one process's run of the same flags.
 10. the entry points and tools (yaha_tpu_torch/entry.py, tools/):
     entry()'s score, maxi and maxj equal to entry("cpu")'s;
     dryrun_multichip(4) at 16 Mbp (the L15 arm off; then alone where
     ~/hgdata holds an hg-scale index): the staged engine with the
     sharded seeder on a (2 x 2) grid of the card byte-identical to the
     single-device runs, no host-scan fallback, phantom rows, a capacity
     retry; device_replay on phase 3's 1 kb batch: its DP launch sequence
     as a CUDA graph, the replayed walk items equal to the captured ones,
     its device seconds beside the chunk's device_s and the kernels'
     torch.profiler time; decode_profile on the main path's largest
     extension and full gap buckets (every walk team, sorted and unsorted,
     equal); seedscan_scaling on the cached L15 index (1, 2, 4, 8 host
     threads, the device seeder beside them); fuzz_parity over 24 seeds,
     every arm's SAM equal to the native engine's, the oracle arm
     (--engine oracle) among them (a seed whose native run takes over 20
     s is skipped, at most a quarter of them).
 11. the oracle engine and the index builder, which launch no kernel and
     whose rows the kernels line does not gain: the CLI with --engine
     oracle on the 21 golden runs of tests/test_sam_parity.py (a process
     each, all at once), each output byte-equal to its golden; the oracle
     on the first 512 reads of phase 3's batch against the L15 index, SAM
     equal to the native engine's; index/build.build_index on the card
     writing the four golden indexes byte for byte, and at 64 Mbp L15
     (phase 3's genome) SO and ROA equal to the native builder's, with
     both builders' seconds, the device passes' seconds (CUDA events) and
     the card's peak allocation.

Each phase's seconds are printed.

With --profile DIR, phases 1 and 3's batch only, in the default and the
A/B configuration and in the default one with the device seeder: three
warm runs of each, interleaved, with parity (walls, device term, seed
wall, bytes, host terms); then one run of each under cProfile (host
time by function, DIR/cprofile_*.txt) and one under torch.profiler
(device busy time, idle share of the wall, device time by kind and by
name, DIR/device_*.txt).

The genome and index are built from a seed on first use and cached under
.smoke_cache/ (git-ignored).  With no CUDA device, the script exits 2
before printing any result.  The last two lines of standard output are a
JSON object per kernel and the JSON result line.
"""
import argparse
import cProfile
import gzip
import io
import json
import os
import pstats
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".smoke_cache")
SEED = 7
GENOME_GBP = 0.064       # 64 Mbp: bounds the L15 index build; see PERF.md
BATCH = 16384            # the staged engine's default batch
KERNELS = {   # launch counter -> (source, the TPU program it replaces)
    "extension_forward": ("yaha_tpu_torch/csrc/ext_kernels.cu",
                          "yaha_tpu/ops/sw_pallas.py:764"),
    "extension_forward_wide": ("yaha_tpu_torch/csrc/ext_wide_kernels.cu",
                               "yaha_tpu/ops/sw_pallas.py:764"),
    "extension_forward_block": ("yaha_tpu_torch/csrc/ext_wide_kernels.cu",
                                "yaha_tpu/ops/sw_pallas.py:764"),
    "anchored_forward_banded": ("yaha_tpu_torch/csrc/anch_kernels.cu",
                                "yaha_tpu/ops/sw_pallas.py:554"),
    "anchored_forward": ("yaha_tpu_torch/csrc/anch_kernels.cu",
                         "yaha_tpu/ops/sw_pallas.py:353"),
    "gather_problems": ("yaha_tpu_torch/csrc/gather_kernels.cu",
                        "yaha_tpu/ops/gather_dp.py:61"),
    "rle_walk": ("yaha_tpu_torch/csrc/decode_kernels.cu",
                 "yaha_tpu/ops/decode_jax.py:208"),
    "seed_hashes": ("yaha_tpu_torch/csrc/seed_kernels.cu",
                    "yaha_tpu/ops/seeds_jax.py:30"),
    "expand_sort_hits": ("yaha_tpu_torch/csrc/seed_kernels.cu",
                         "yaha_tpu/ops/seeds_jax.py:63"),
    "chain_dp": ("yaha_tpu_torch/csrc/chain_kernels.cu",
                 "yaha_tpu/ops/chain_jax.py:38"),
    "merge_sorted_runs": ("yaha_tpu_torch/csrc/seed_kernels.cu",
                          "yaha_tpu/parallel/mesh.py:204"),
}
# The device seed phase's kernels (--seed device, phase 6); the chain DP,
# which no engine runs (the JAX package wires it into none), driven by
# phase 7; the other kernels run on the host-seed path of phases 3-4.
SEED_KERNELS = ("seed_hashes", "expand_sort_hits")
CHAIN_KERNELS = ("chain_dp",)
# Phase 9's kernels: the merge of the index shards' hit rows (the sharded
# seeder's alone, --model-shards) and the block extension (bands past -BW
# 707).
SCALE_KERNELS = ("merge_sorted_runs", "extension_forward_block")
DP_KERNELS = [k for k in KERNELS
              if k not in SEED_KERNELS + CHAIN_KERNELS + SCALE_KERNELS]
# Kernels of which no instance may spill or use a stack frame.
NO_SPILL = re.compile(r"ext_reg_kernel|ext_wide_kernel|ext_block_kernel|"
                      r"anch_reg_kernel|anch_wide_kernel|rle_win_kernel|"
                      r"gather_kernel|seed_hash_kernel|expand_sort_kernel|"
                      r"merge_pass_kernel|chain_dp_kernel")
AB = {"device_assembly": False, "rle": False}   # the A/B configuration
WIDE_BW = 9              # -BW of the wide kernel's path (W = 37), whole batch
WIDER_BW = 16            # and a wider band (W = 65) on part of the batch
WIDER_READS = 2048
PLAIN_SLICE = 2048       # problems of a wide bucket the plain version runs
BW16_PLAIN = 256         # and of a -BW 16 gap bucket
MEDIUM_INDEL_READS = 2048  # reads of the medium-indel batch (phase 5)
TORCH_READS = 2048       # reads of the 1 kb batch through --engine batch-torch
# The chain DP's shapes (phase 7): (ranges B, nodes N, SQO span): one range
# of up to 64 nodes a strand row of the 1 kb batch, and 512 long-read
# ranges of up to 2,048 nodes.
CHAIN_SHAPES = ((2 * BATCH, 64, 900), (512, 2048, 100_000))
CHAIN_NATIVE = 64        # ranges of each shape also held to native chain_dp

# Bounds: the least time the card could take for a kernel's work, the larger
# of its bytes (each input read once, each output written once) over the
# memory rate and its operations over the peak rate for their type (one
# H100 SXM at its 700 W limit).  The DP cells and the walk and gather are
# int32 work: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz (boost clock).
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 64 * 132 * 1.98e9
CELL_OPS = 25            # int32 operations of one DP cell (sw_cells.cuh)
WALK_STEP_OPS = 8        # one walk step: load, mask, compare, move, merge
GATHER_BYTE_OPS = 6      # one gathered byte: index, compare, select
HASH_WINDOW_OPS = 5      # one window's hash, rolled from the last window's:
                         # shift, or, mask, bad-code count, compare
WINDOW_OPS = 8           # one window's SO run: index, loads, subtract, tests
SORT_CMP_OPS = 2         # one compare of 64-bit keys, in int32 operations
# The chain DP's int32 operations for one pair i < j of valid nodes, by how
# far chain_relax (csrc/chain_kernels.cu) takes it: every pair, its index
# and validity tests and the SQO test; past that, the diagonal gap
# (subtract, absolute value, compare); past that, the SRO test (two adds,
# compare); past all three, the rest of the relaxation (desert and overlap
# tests, gaps and overlaps, the new score, its compares and wrap), 32 in all.
PAIR_STAGE_OPS = (3, 3, 3, 23)
# Since the kernel's pair tests stop at the SQO window (chain_window_ops),
# its bound counts the window's pairs: each by its stages as above, plus
# the window's compare (a subtract, a compare).
WINDOW_PAIR_OPS = 2
QUEUE_CYCLES = 20_000_000  # ~10 ms of card clock ahead of a timed window
# Phase 9, the scale-out: the (data, model) grids of the card that shard
# the index, the -G of the long-gap reads (whose gap fills are too wide for
# the anchored wide route), and the seconds a CLI process may take.
SCALE_GRIDS = ((1, 2), (2, 2))
LONG_GAP_MAX_GAP = 3600
CLI_TIMEOUT = 300
# Phase 10, the entry points and tools: the dryrun's genome (cut from the
# reference's 100 Mbp to bound its set-up), the hg-scale index its L15
# arm wants, the seed-scan tool's reads, and the fuzz's seeds.
DRYRUN_MBP = 16
HG_DIR = os.path.expanduser("~/hgdata")
SEEDSCAN_READS = 4000
FUZZ_SEEDS = 24
FUZZ_SEED0 = 1000
FUZZ_REF_TIMEOUT = 20
# Phase 11, the oracle engine and the index builder: reads of the 1 kb
# batch the oracle is held to the native engine on, the golden indexes
# (file, -L, -S, -H) the builder must write byte for byte, and the big
# genome's index parameters (the CLI's defaults).
ORACLE_READS = 512
GOLDEN_INDEXES = (("testgen.X09_01_65525S", 9, 1, 65525),
                  ("testgen.X10_03_65525S", 10, 3, 65525),
                  ("testgen.X11_01_65525S", 11, 1, 65525),
                  ("testgen.X11_01_00020S", 11, 1, 20))
BIG_INDEX = (15, 1, 65525)


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def log(*a):
    print(*a, flush=True)


def run(cmd, **kw):
    res = subprocess.run(cmd, capture_output=True, text=True, **kw)
    if res.returncode != 0:
        raise RuntimeError("%s failed (%d):\n%s" % (
            " ".join(cmd), res.returncode, res.stderr[-3000:]))
    return res.stdout


# ---- data ----

def genome_files(threads):
    """64 Mbp synthetic genome (tools/make_big_genome.py), its .nib2 and
    its default L15/S1 index, built once per seed."""
    d = os.path.join(CACHE, "genome_seed%d" % SEED)
    fa = os.path.join(d, "big.fasta")
    idx = os.path.join(d, "big.X15_01_65525S")
    if not os.path.exists(idx):
        os.makedirs(d, exist_ok=True)
        t0 = time.time()
        run([sys.executable, os.path.join(REPO, "tools",
                                          "make_big_genome.py"), fa,
             "--gbp", str(GENOME_GBP), "--chroms", "4", "--seed",
             str(SEED)])
        run([sys.executable, "-m", "yaha_tpu_torch.cli", "-g", fa, "-t",
             str(threads)], cwd=REPO)
        log("setup: genome + L15 index built in %.1f s" % (time.time() - t0))
    return fa, os.path.join(d, "big.nib2"), idx


def chromosomes(fa):
    seqs = []
    with open(fa, "rb") as f:
        for rec in f.read().split(b">")[1:]:
            body = rec.split(b"\n", 1)[1]
            seqs.append(np.frombuffer(body.replace(b"\n", b""), np.uint8))
    return seqs


_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")
_BASES = np.frombuffer(b"ACGT", np.uint8)


def sample_reads(seqs, n, length, rng, prefix, indels):
    """Reads sampled from the genome with 5 % substitutions on either
    strand (as tools/hgscale_staged_tpu.py --sample); with `indels`, also
    0.75 % short insertion/deletion events per base (15 % of the 5 %,
    wgsim's default indel fraction; geometric lengths, mean 1.4)."""
    out = []
    for k in range(n):
        c = int(rng.integers(0, len(seqs)))
        pos = int(rng.integers(0, len(seqs[c]) - length))
        r = seqs[c][pos:pos + length].copy()
        m = rng.random(length) < 0.05
        r[m] = _BASES[rng.integers(0, 4, int(m.sum()))]
        if indels:
            parts, j = [], 0
            for e in np.sort(rng.choice(length, int(length * 0.0075),
                                        replace=False)):
                parts.append(r[j:e])
                n_ev = int(rng.geometric(0.7))
                if rng.random() < 0.5:
                    parts.append(_BASES[rng.integers(0, 4, n_ev)])
                    j = e
                else:
                    j = e + n_ev
            parts.append(r[j:])
            r = np.concatenate(parts)[:length]
        s = r.tobytes()
        if rng.random() < 0.5:
            s = s.translate(_COMP)[::-1]
        out.append(b">%s%d\n%s\n" % (prefix, k, s))
    return out


def medium_indel_reads(seqs, n, length, rng, prefix):
    """Reads of `length` bases with 5 % substitutions on either strand,
    each with one insertion or deletion (alternately) of a uniform 20-60
    bases at a uniform place: the medium indels of long-read SV data sets,
    whose gap fills the native pipeline leaves unbanded or bands with
    len_diff + 2 * BW + 1 columns, so they reach the anchored kernels'
    wide route at the default -BW 5 (yaha_pipe.cpp:1126)."""
    out = []
    for k in range(n):
        size = int(rng.integers(20, 61))
        c = int(rng.integers(0, len(seqs)))
        pos = int(rng.integers(0, len(seqs[c]) - length - size))
        r = seqs[c][pos:pos + length + size].copy()
        at = int(rng.integers(0, length))
        if k % 2:
            r = np.concatenate([r[:at], r[at + size:]])
        else:
            r = np.concatenate([r[:at], _BASES[rng.integers(0, 4, size)],
                                r[at:]])
        r = r[:length]
        m = rng.random(length) < 0.05
        r[m] = _BASES[rng.integers(0, 4, int(m.sum()))]
        s = r.tobytes()
        if rng.random() < 0.5:
            s = s.translate(_COMP)[::-1]
        out.append(b">%s%d\n%s\n" % (prefix, k, s))
    return out


def sv_reads(nib, n_max):
    """Split reads over simulated DEL/DUP/INV/INS events
    (tools/make_sv_testdata.py, 1 kb reads)."""
    prefix = os.path.join(CACHE, "sv_seed%d" % SEED)
    if not os.path.exists(prefix + ".fasta"):
        run([sys.executable, os.path.join(REPO, "tools",
                                          "make_sv_testdata.py"), nib,
             prefix, "--read-len", "1000"])
    with open(prefix + ".fasta", "rb") as f:
        recs = [b">" + r for r in f.read().split(b">")[1:]]
    return recs[:n_max]


# ---- phases ----

def phase_build():
    """The card, the kernels' build, and ptxas's report: every instance of
    the register extension kernel must keep its band in registers, and the
    windowed walk and the gather their state (no spill, no stack frame)."""
    from yaha_tpu_torch.ops import _build, sw_cuda
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).strip().splitlines()[0]
    log(smi)
    t0 = time.time()
    built = _build.build()
    log("phase1 build: nvcc %.1f s (%s)" % (built, "compiled" if built
                                           else "up to date"))
    _build.load()
    log("phase1 load: %.2f s" % (time.time() - t0))
    report = _build.ptxas_report()
    widths = {}
    for name, info in sorted(report.items()):
        m = re.search(r"ext_reg_kernelILi(\d+)EE", name)
        tag = "ext_reg W=%s" % m.group(1) if m else name
        log("phase1 ptxas %s: %s registers, %s B stack frame, %s B spill "
            "stores, %s B spill loads" % (
                tag, info.get("registers"), info.get("stack"),
                info.get("spill_stores"), info.get("spill_loads")))
        if m:
            widths[int(m.group(1))] = info
    if sorted(widths) != list(sw_cuda.REG_WIDTHS):
        raise AssertionError("phase1: register kernel instances %s, want %s"
                             % (sorted(widths), sw_cuda.REG_WIDTHS))
    for kind in ("anch_reg_kernel", "anch_wide_kernel"):
        anch = sorted(k for k in report if kind in k)
        if len(anch) != 2:
            raise AssertionError("phase1: %s instances %s, want the banded "
                                 "and the full layout" % (kind, anch))
    hashes = [k for k in report if "seed_hash_kernel" in k]
    expands = [k for k in report if "expand_sort_kernel" in k]
    merges = [k for k in report if "merge_pass_kernel" in k]
    if not (hashes and expands and merges):
        raise AssertionError("phase1: seed kernel instances %s, %s and %s"
                             % (hashes, expands, merges))
    exts = [k for k in report if re.search("ext_wide_kernel|ext_block_kernel",
                                           k)]
    if len(exts) != 2:
        raise AssertionError("phase1: wide extension kernel instances %s, "
                             "want the warp's and the block's" % exts)
    chains = [k for k in report if "chain_dp_kernel" in k]
    if len(chains) != 7:
        raise AssertionError("phase1: chain kernel instances %s, want the 7 "
                             "team shapes" % chains)
    bad = {k: i for k, i in report.items() if NO_SPILL.search(k) and (
        i.get("stack", 1) or i.get("spill_stores", 1) or
        i.get("spill_loads", 1))}
    if bad:
        raise AssertionError("phase1: a kernel spills or uses a stack "
                             "frame: %s" % bad)


def _rand_problems(rng, n, ql, rl, similar):
    q = rng.integers(0, 4, (n, ql)).astype(np.uint8)
    r = rng.integers(0, 4, (n, rl)).astype(np.uint8)
    if similar:
        k = min(ql, rl)
        keep = rng.random((n, k)) < 0.9
        r[:, :k] = np.where(keep, q[:, :k], r[:, :k])
    return q, r


def compare(torch, errs, phase, name, tag, kernel_out, plain_out):
    """Raise unless every output of the kernel equals the plain version's;
    record the max abs error per kernel in `errs`."""
    err = 0
    for key in plain_out:
        a = kernel_out[key].to(torch.int64)
        b = plain_out[key].to(torch.int64)
        if a.shape != b.shape:
            raise AssertionError("%s %s %s %s: shape %s vs %s" % (
                phase, name, tag, key, tuple(a.shape), tuple(b.shape)))
        err = max(err, int((a - b).abs().max()) if a.numel() else 0)
    errs[name] = max(errs.get(name, 0), err)
    if err:
        raise AssertionError("%s %s %s: kernel != plain version (max abs "
                             "err %d)" % (phase, name, tag, err))
    log("%s %s %s: equal" % (phase, name, tag))


def _gather_inputs(rng, m, qg, rg, rev_share, n_reads, lpad, genome_len):
    """Coordinates [8, m] of m problems over n_reads strand rows and a
    genome of genome_len codes: copies shorter than the problem, reversed
    problems, sources at the genome's end."""
    qlen = rng.integers(1, qg + 1, m)
    rlen = rng.integers(1, rg + 1, m)
    q_copy = np.where(rng.random(m) < 0.3, rng.integers(0, qlen + 1), qlen)
    r_copy = np.where(rng.random(m) < 0.3, rng.integers(0, rlen + 1), rlen)
    q_src = rng.integers(0, lpad - q_copy + 1)
    r_src = rng.integers(0, genome_len - r_copy + 1)
    r_src[:16] = genome_len - r_copy[:16]
    return np.stack([rng.integers(0, 2 * n_reads, m), q_src, q_copy, qlen,
                     r_src, r_copy, rlen,
                     rng.random(m) < rev_share]).astype(np.int64)


def _gather_edges(qg, rg, lpad, genome_len, nrows):
    """Coordinates [8, 70]: whole copies (the gather kernel's 16-byte path)
    from every source alignment 0-15, forward and reversed, lengths that
    are not multiples of 16; sources clamped at both ends of the genome and
    of a strand row, and rows outside the strand rows."""
    cols = []
    for rev in (0, 1):
        for a in range(16):
            ql, rl = qg - a % 5, rg - a % 7
            cols.append((a, a, ql, ql, 16 * (a + 3) + a, rl, rl, rev))
            cols.append((a + 5, 16 - a, ql // 2 + a, ql, genome_len // 2 + a,
                         rl // 3 + a, rl, rev))
        cols += [(nrows - 1, lpad - 4, 10, 10, genome_len - 3, 20, 20, rev),
                 (1, -3, 12, 12, genome_len - rg // 2, rg, rg, rev),
                 (nrows, lpad - 17, qg, qg, -5, rg, rg, rev)]
    return np.array(cols, np.int64).T


def _long_runs(rng, n):
    """n gap fills, each one deletion or insertion of 100-300 bases between
    8 matching bases on each side: (q, qlen, r, rlen, lbw, rbw)."""
    ql = rl = 316
    q = np.zeros((n, ql), np.uint8)
    r = np.zeros((n, rl), np.uint8)
    lens = np.zeros((4, n), np.int64)
    for k in range(n):
        size = int(rng.integers(100, 301))
        ref = rng.integers(0, 4, size + 16).astype(np.uint8)
        if k % 2:
            qk, rk, lb, rb = np.concatenate([ref[:8], ref[size + 8:]]), ref, \
                2, size + 2
        else:
            qk = np.concatenate([ref[:8], rng.integers(0, 4, size).astype(
                np.uint8), ref[8:16]])
            rk, lb, rb = ref[:16], size + 2, 2
        q[k, :len(qk)] = qk
        r[k, :len(rk)] = rk
        lens[:, k] = (len(qk), len(rk), lb, rb)
    return q, lens[0], r, lens[1], lens[2], lens[3]


def _anch_classes(rng, n, ql, rl, wband):
    """(qlens, banded rlens, full-width rlens, lbw, rbw) of n gap fills in
    warps of 32 whose live widths (lbw + rbw + 1 banded, rlen full width)
    reach 8, 16, 32 and 64 in turn: lane 0 at the warp's width, the others
    below it; banded references end inside the band."""
    target = np.array([8, 16, 32, 64])[(np.arange(n) // 32) % 4]
    live = rng.integers(1, target + 1)
    live[::32] = target[::32]
    lbw = rng.integers(0, np.minimum(live, wband))
    rbw = np.minimum(live, wband) - 1 - lbw
    qlens = rng.integers(1, ql + 1, n)
    rl_band = np.clip(qlens + rng.integers(-lbw, rbw + 1), 0, rl)
    return qlens, rl_band, np.minimum(live, rl), lbw, rbw


def _seed_synthetic():
    """[(tag, (hashes, clean, SO, ROA, max_hits), capacities)] of synthetic
    seed indexes (word length 4), rows of 40 windows.  The first is the
    index and windows of tests/test_seeds_jax.py:76-124: windows 0, 2 and 4
    hit a 40-hit run at
    10,000 and up, window 6 a 2-hit run [1, 2] (wrapped), whose slots are
    the last of a 122-hit row: at the end of a 128-slot tier, past a 64-slot
    one (the row overflows).  The second has hits with ro < qo (diag >=
    2^31), ro = qo - 1 (diag 0xFFFFFFFF, a valid hit just before the
    sentinel), ro = qo and ro far above qo, a run past max_hits, a wrapped
    window and a row with no clean window."""
    out = []
    for tag, runs, rows, max_hits, caps in (
            ("wrapped run", {5: 10_000 + np.arange(40), 9: [1, 2]},
             [((0, 5), (2, 5), (4, 5), (6, 9))], 650, (64, 128)),
            ("unsigned order", {3: [0, 5, 20, 100], 7: [30, 31],
                                11: [1, 2], 13: np.arange(6),
                                2: [4_000_000_000, 7]},
             [((10, 3), (31, 7), (25, 3), (35, 11)),
              ((8, 13), (31, 7), (32, 7), (0, 2), (39, 2)),
              ((5, 11), (6, 11), (30, 3), (31, 3)), ()], 5,
             (8, 16, 1024))):
        counts = np.zeros(256, np.uint32)
        for h, run in runs.items():
            counts[h] = len(run)
        so = np.zeros(257, np.uint32)
        so[1:] = np.cumsum(counts)
        roa = np.zeros(int(so[-1]), np.uint32)
        for h, run in runs.items():
            roa[so[h]:so[h] + len(run)] = run
        n = 40
        hashes = np.zeros((len(rows), n), np.int32)
        clean = np.zeros((len(rows), n), bool)
        for r, wins in enumerate(rows):
            for w, h in wins:
                hashes[r, w], clean[r, w] = h, True
        out.append((tag, (hashes, clean, so, roa, max_hits), caps))
    return out


def pack4(t):
    """4-bit packing on the card (sw_cuda.pack4_host's layout)."""
    return (t[:, ::2] | (t[:, 1::2] << 4)).contiguous()


def anch_live(lbw, rbw, rlen, *, wband=None, rl=None):
    """Live width of each anchored problem (numpy), as csrc/anch_kernels.cu
    takes it: band-relative columns min(lbw + rbw + 1, wband) for the
    banded layout (`wband` given), else full-matrix columns 1..min(rlen,
    rl)."""
    if wband is not None:
        return np.clip(np.asarray(lbw, np.int64) + np.asarray(rbw, np.int64)
                       + 1, 0, wband)
    return np.clip(np.asarray(rlen, np.int64), 0, rl)


def warp_classes(sw, live):
    """Width class of each warp of 32 consecutive problems, from its lanes'
    live widths (anch_live): "K8", "K16" or "K32", the smallest class
    covering every lane (band state in registers), or "wide" (a lane wider
    than sw_cuda.ANCH_REG_COLS; its problems take the wide route, a warp
    each)."""
    live = np.asarray(live, np.int64)
    wmax = np.pad(live, (0, -len(live) % 32)).reshape(-1, 32).max(1)
    out = np.full(len(wmax), "wide", dtype=object)
    for k in sorted((8, 16, sw.ANCH_REG_COLS), reverse=True):
        out[wmax <= k] = "K%d" % k
    return out


def phase_kernels(torch, sw, errs, dev):
    """Each kernel on the card against its plain version on the card."""
    from yaha_tpu_torch.utils import codec
    from yaha_tpu_torch.ops import decode, gather_dp, seeds
    from yaha_tpu_torch.parallel.mesh import rebase_so
    from yaha_tpu_torch.tools.decode_profile import items_below
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_dp_cases import indel_extension_inputs
    rng = np.random.default_rng(SEED)
    kw0 = dict(go=5, ge=2, rc=3, ms=1, max_gap=50, max_intron=50)
    # At this gap-open cost DP_WORST - (go + ge) wraps int32: the kernels
    # must wrap as the plain versions (and JAX) do.
    wrap = dict(kw0, go=300)

    def check(name, tag, kw, kernel_out, plain_out):
        tag += " go=%d" % kw["go"]
        compare(torch, errs, "phase2", name, tag, kernel_out, plain_out)

    def up(*arrs):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrs]

    def walk_check(tag, bt, y0, x0, active, full):
        """The walk kernel at every team size on a kernel-made plane, at
        the engine's cap and at a cap of 3 (overflowing walks report
        n_ops = -1)."""
        h, w = bt.shape[1], bt.shape[2]
        for cap in (1 << (2 * h + w + 1).bit_length(), 3):
            want = decode.rle_walk_reference(bt, y0, x0, active, cap=cap,
                                             full=full)
            for team in decode.WALK_TEAMS:
                got = decode.rle_walk(bt, y0, x0, active, cap=cap,
                                      full=full, team=team)
                sync(torch, dev)
                compare(torch, errs, "phase2", "rle_walk",
                        "%s team=%d cap=%d" % (tag, team, cap),
                        {"rle": items_below(*got, cap),
                         "n_ops": got[1]},
                        {"rle": want[0], "n_ops": want[1]})

    # Extension, both kernels: N = 4096 at QL = 256 for BW 5 (the register
    # kernel at each block size, and the wide kernel at W = 21) and BW 3; a
    # few hundred problems at QL = 2112 (past 2048, the read lengths the
    # Pallas entry sent to its windowed variant); BW 8 (W = 33, the widest register
    # instance); by dispatch the wide kernel at BW 0, 9 and 16 (W = 1, 37,
    # 65), with an early X-drop (x_cutoff 4), the int32-wrap scoring, and
    # reads with an indel of up to 2*bw bases (X-drop 60: paths out to the
    # band's outer columns survive their gap).  A quarter of the references
    # end before qlen + 2*bw2.
    default = [(None, sw.EXT_BLOCK)]
    forced = [("reg", 32), ("reg", 128), ("wide", sw.EXT_BLOCK)]
    for n, ql, bw, xc, kw, kernels, indel in (
            (4096, 256, 5, 25, kw0, default + forced, False),
            (4096, 256, 3, 15, kw0, default, False),
            (256, 2112, 5, 25, kw0, default, False),
            (1024, 128, 8, 25, kw0, default, False),
            (1024, 128, 0, 25, kw0, default, False),
            (1024, 128, WIDE_BW, 25, kw0, default, False),
            (1024, 128, WIDE_BW, 4, kw0, default, False),
            (1024, 128, WIDER_BW, 25, kw0, default, False),
            (1024, 256, WIDE_BW, 60, kw0, default, True),
            (1024, 256, WIDER_BW, 60, kw0, default, True),
            (512, 64, 5, 25, wrap, default + forced[2:], False),
            (512, 64, 8, 25, wrap, default, False),
            (512, 64, WIDE_BW, 25, wrap, default, False),
            (512, 64, WIDER_BW, 25, wrap, default, False)):
        bw2 = 2 * bw
        rl = ql + 2 * bw2
        if indel:
            q, qlens, r, rlens = indel_extension_inputs(
                int(rng.integers(1 << 30)), n, ql, bw)
        else:
            q, r = _rand_problems(rng, n, ql, rl, similar=True)
            qlens = rng.integers(ql // 2, ql + 1, n)
            rlens = np.minimum(qlens + bw2, rl)
        rlens = np.where(rng.random(n) < 0.25, rng.integers(1, rlens + 1),
                         rlens)
        r[np.arange(rl)[None, :] >= rlens[:, None]] = 255
        args = up(q, qlens.astype(np.int32), r, rlens.astype(np.int32))
        kw = dict(kw, band_width=bw, x_cutoff=xc)
        want = sw.extension_forward_reference(*args, **kw)
        for variant, block in kernels:
            out = sw.extension_forward(*args, variant=variant, block=block,
                                       **kw)
            sync(torch, dev)
            name = ("extension_forward" if (variant or sw.ext_variant(bw))
                    == "reg" else "extension_forward_wide")
            check(name, "N=%d QL=%d BW=%d X=%d block=%d%s" % (
                n, ql, bw, xc, block, " indel" if indel else ""), kw, out,
                want)
        walk_check("extension N=%d QL=%d" % (n, ql), out["bt"], out["maxi"],
                   out["maxj"], out["score"] > 0, False)
    def anch_check(tag, args, kw, wband):
        """The anchored kernel of the layout (banded if `wband`) against
        its plain version; logs the warps per width class; returns the
        kernel's output."""
        if wband:
            name, fn = "anchored_forward_banded", sw.anchored_forward_banded
            want = sw.anchored_forward_banded_reference(*args, wband=wband,
                                                        **kw)
            live = anch_live(args[4].cpu(), args[5].cpu(), None, wband=wband)
            kw = dict(kw, wband=wband)
        else:
            name, fn = "anchored_forward", sw.anchored_forward
            want = sw.anchored_forward_reference(*args, **kw)
            live = anch_live(None, None, args[3].cpu(), rl=args[2].shape[1])
        classes = warp_classes(sw, live)
        out = fn(*args, **kw)
        sync(torch, dev)
        check(name, "%s warps %s" % (tag, json.dumps(
            {k: int((classes == k).sum()) for k in sorted(set(classes))})),
            kw, out, want)
        return out

    # Warps that cycle through the register classes 8, 16 and 32 and wider
    # (lane 0 at its class's width), both layouts, both scorings; the 4-bit
    # packed entries against the unpacked ones.
    for kw in (kw0, wrap):
        n, ql, rl, wband = 4096, 64, 96, 64
        q, r = _rand_problems(rng, n, ql, rl, similar=True)
        qlens, rl_band, rl_full, lbw, rbw = _anch_classes(rng, n, ql, rl,
                                                          wband)
        band_args = up(q, qlens, r, rl_band, lbw, rbw)
        band = anch_check("classes N=%d QL=%d wband=%d" % (n, ql, wband),
                          band_args, kw, wband)
        full_args = up(q, qlens, r, rl_full, lbw, rbw)
        full = anch_check("classes N=%d QL=%d RL=%d" % (n, ql, rl),
                          full_args, kw, 0)
    for name, fn, args, out, akw in (
            ("anchored_forward_banded", sw.anchored_forward_banded_p4,
             band_args, band, dict(wrap, wband=wband)),
            ("anchored_forward", sw.anchored_forward_p4, full_args, full,
             wrap)):
        got = fn(pack4(args[0]), args[1], pack4(args[2]), *args[3:], **akw)
        sync(torch, dev)
        compare(torch, errs, "phase2", name,
                "%s = unpacked entry" % fn.__name__, got, out)
    # Band-relative, mostly wide warps: N = 2048 at QL = 128 (four strips),
    # wband 64 and 256, and N = 64 at wband 1024.
    for n, ql, wband, kw in ((2048, 128, 64, kw0), (2048, 128, 256, kw0),
                             (512, 64, 64, wrap), (64, 16, 1024, kw0)):
        rl = ql + wband
        q, r = _rand_problems(rng, n, ql, rl, similar=True)
        qlens = rng.integers(ql // 2, ql + 1, n)
        rlens = rng.integers(ql // 2, rl + 1, n)
        lbw = rng.integers(0, wband // 2, n)
        rbw = rng.integers(0, wband // 2, n)
        args = up(q, qlens, r, rlens, lbw, rbw)
        out = anch_check("N=%d QL=%d wband=%d" % (n, ql, wband), args, kw,
                         wband)
        ql_d, rl_d, lb_d = args[1], args[3], args[4]
        inside = (rl_d - ql_d + lb_d >= 0) & (rl_d - ql_d + lb_d < wband)
        walk_check("banded N=%d QL=%d" % (n, ql), out["bt_b"], ql_d,
                   rl_d - ql_d + lb_d, inside, False)
    # Anchored, full width: N = 512 at 128 x 128 with bands up to the full
    # matrix; then RL = 1024 with bands wider than 512 (the JAX package's
    # fallback class).
    for n, ql, rl, bmax, kw in ((512, 128, 128, 140, kw0),
                                (16, 64, 1024, 700, kw0),
                                (256, 64, 64, 70, wrap)):
        q, r = _rand_problems(rng, n, ql, rl, similar=True)
        qlens = rng.integers(1, ql + 1, n)
        rlens = rng.integers(rl // 2, rl + 1, n)
        lbw = rng.integers(0, bmax, n)
        rbw = rng.integers(bmax // 2, bmax, n)
        args = up(q, qlens, r, rlens, lbw, rbw)
        out = anch_check("N=%d QL=%d RL=%d" % (n, ql, rl), args, kw, 0)
        walk_check("full N=%d QL=%d RL=%d" % (n, ql, rl), out["bt"],
                   args[1], args[3], torch.ones_like(args[1], dtype=bool),
                   True)
    # Gap runs of 100-300 bases, longer than the walk's windows, in both
    # layouts (the native walker reads each as one run).
    long_kw = dict(kw0, max_gap=320, max_intron=320)
    args = up(*_long_runs(rng, 256))
    ones = torch.ones_like(args[1], dtype=bool)
    for full in (False, True):
        if full:
            bt = sw.anchored_forward(*args, **long_kw)["bt"]
            x0 = args[3]
        else:
            bt = sw.anchored_forward_banded(*args, wband=512,
                                            **long_kw)["bt_b"]
            x0 = args[3] - args[1] + args[4]
        sync(torch, dev)
        walk_check("long runs full=%d" % full, bt, args[1], x0, ones, full)
    # Problem gather at the main path's extension and gap bucket shapes:
    # 16,384 problems over a chunk of 16,384 reads of up to 1 kb.
    glen, n_reads, lpad = 1 << 22, BATCH, 1024
    corpus = gather_dp.DeviceCorpus(
        rng.integers(0, 5, glen).astype(np.uint8), dev)
    lens = rng.integers(1, lpad + 1, n_reads).astype(np.int32)
    fwd = rng.integers(0, 4, (n_reads, lpad)).astype(np.uint8)
    fwd[np.arange(lpad)[None, :] >= lens[:, None]] = 4
    # The strand rows through the engine's row builder, from the reads'
    # sequence characters back to back.
    chars = np.asarray(codec.FOUR_BIT_CHARS, np.uint8)[fwd]
    rows2 = corpus.read_rows(chars[np.arange(lpad)[None, :] < lens[:, None]],
                             np.cumsum(lens) - lens, lens, lpad)
    for m, qg, rg, rpad, rev in ((BATCH, 1024, 1044, 255, 0.5),
                                 (BATCH, 64, 64, 0, 0.0),
                                 (4096, 40, 75, 255, 0.5)):
        coords = up(np.concatenate([
            _gather_inputs(rng, m, qg, rg, rev, n_reads, lpad, glen),
            _gather_edges(qg, rg, lpad, glen, 2 * n_reads)], axis=1))[0]
        got = gather_dp.gather_problems(rows2, corpus.codes, coords, qg=qg,
                                        rg=rg, rpad=rpad)
        sync(torch, dev)
        want = gather_dp.gather_reference(rows2, corpus.codes, coords,
                                          qg=qg, rg=rg, rpad=rpad)
        compare(torch, errs, "phase2", "gather_problems", "m=%d qg=%d rg=%d "
                "rpad=%d" % (m, qg, rg, rpad), {"q": got[0], "r": got[1]},
                {"q": want[0], "r": want[1]})
    # The seed expansion on synthetic indexes (its main-path shapes are
    # phase 6's).
    for tag, (hashes, clean, so, roa, max_hits), caps in _seed_synthetic():
        args = up(hashes, clean, so.view(np.int32), roa.view(np.int32))
        for cap in caps:
            got = seeds.expand_sort_hits(*args, max_hits=max_hits,
                                         capacity=cap)
            sync(torch, dev)
            compare(torch, errs, "phase2", "expand_sort_hits", "%s C=%d" % (
                tag, cap), got, seeds.expand_sort_hits_reference(
                    *args, max_hits=max_hits, capacity=cap))
        # Over two model shards (the scale-out's range-masked expansion),
        # then the shards' rows merged.
        so_local, bases, lens = rebase_so(so, 2)
        per = so_local.shape[1] - 1
        for cap in caps:
            outs = []
            for m in range(2):
                sargs = args[:2] + up(so_local[m].view(np.int32), np.append(
                    roa[bases[m]:bases[m] + lens[m]], 0).view(np.int32))
                kw = dict(max_hits=max_hits, capacity=cap, hash_lo=m * per,
                          per=per)
                outs.append(seeds.expand_sort_hits(*sargs, **kw))
                sync(torch, dev)
                compare(torch, errs, "phase2", "expand_sort_hits",
                        "%s shard %d of 2 C=%d" % (tag, m, cap), outs[-1],
                        seeds.expand_sort_hits_reference(*sargs, **kw))
            runs = [torch.stack([o[k] for o in outs]) for k in ("diag",
                                                                "qo")]
            got = seeds.merge_sorted_runs(*runs)
            sync(torch, dev)
            want = seeds.merge_sorted_runs_reference(*runs)
            compare(torch, errs, "phase2", "merge_sorted_runs",
                    "%s 2 shards C=%d" % (tag, cap),
                    {"diag": got[0], "qo": got[1]},
                    {"diag": want[0], "qo": want[1]})


def _recorder(StagedAligner, gap_dispatch, pack_coords):
    """A StagedAligner that keeps the largest bucket of each kernel for
    phase 5: the DP kernels' inputs as the main path assembled them on the
    card, and the gather's strand rows and coordinates."""
    class Recorder(StagedAligner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.buckets = {}
            self.counts = {}
            self.gap_log = []

        def _keep(self, key, n, arrays):
            self.counts[key] = self.counts.get(key, 0) + n
            if n > self.buckets.get(key, (0, None))[0]:
                self.buckets[key] = (n, arrays)

        def _mk_gather(self, rows2, meta2, idx, qlen, rlen, rev, rpad, qg,
                       rg):
            q_row, q_src, q_copy, r_src, r_copy = meta2
            coords = pack_coords(*(a[idx] for a in (
                q_row, q_src, q_copy, qlen, r_src, r_copy, rlen)),
                None if rev is None else rev[idx])
            self._keep(("gather_problems", qg, rg, rpad), len(idx),
                       (rows2, coords))
            return super()._mk_gather(rows2, meta2, idx, qlen, rlen, rev,
                                      rpad, qg, rg)

        def _run_ext_bucket(self, qa, qlens, ra, rlens, qg=None, rg=None,
                            dev_gather=None):
            def keep(m, pack):
                q, r = dev_gather(m, pack)
                self._keep(("extension_forward", qg, rg, 0), m,
                           (q, qlens, r, rlens))
                return q, r
            return super()._run_ext_bucket(qa, qlens, ra, rlens, qg, rg,
                                           keep if dev_gather else None)

        def _run_gap_bucket(self, qa, qlens, ra, rlens, lbws, rbws, qg=None,
                            rg=None, dev_gather=None):
            if qg is None:
                qg, rg = qa.shape[1], ra.shape[1]
            wband, banded = gap_dispatch(lbws, rbws, rg)
            self.gap_log.append((banded, qg, rg, wband, qlens, rlens, lbws,
                                 rbws))
            name = "anchored_forward_banded" if banded else \
                "anchored_forward"

            def keep(m, pack):
                q, r = dev_gather(m, pack)
                self._keep((name, qg, rg, wband), m,
                           (q, qlens, r, rlens, lbws, rbws))
                return q, r
            return super()._run_gap_bucket(qa, qlens, ra, rlens, lbws, rbws,
                                           qg, rg,
                                           keep if dev_gather else None)
    return Recorder


def _aa(host, index, xfile, **over):
    aa = host.AlignmentArgs()
    aa.xfile_name = os.path.basename(xfile)
    aa.qfile_name = "reads.fasta"
    aa.ofile_name = "out.sam"
    for k, v in over.items():
        setattr(aa, k, v)
    aa.post_process(True)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    return aa


def _report(tag, n, walls, s, launches):
    log("%s: reads=%d parity=true %s reads_per_s=%.1f" % (
        tag, n, " ".join("%s=%.3f" % kv for kv in walls.items()),
        n / (walls.get("warm_wall_s") or walls["cold_wall_s"])))
    log("%s: ext_problems=%d gap_problems=%d gap_dispatch=%s "
        "dp_launches=%d kernel_launches=%s h2d_mb=%.3f d2h_mb=%.3f "
        "plane_d2h_mb=%.3f device_s=%.3f host_s=%s" % (
            tag, s["ext_problems"], s["gap_problems"],
            json.dumps({"banded": s["gap_banded"], "full": s["gap_full"],
                        "fallback": s["gap_fallback"]}),
            s["dp_launches"], json.dumps(launches), s["h2d_bytes"] / 1e6,
            s["d2h_bytes"] / 1e6, s["plane_d2h_bytes"] / 1e6, s["device_s"],
            json.dumps({k[:-2]: round(s[k], 3) for k in (
                "begin_s", "gap_host_s", "phase2_s", "ext_host_s",
                "finish_s")})))


def _timed(torch, sw, st, pr, ref, dev, what):
    """One align_chunk with the launch counts reset just before it; raises
    unless the SAM bytes equal the native engine's.  Returns (wall,
    launches)."""
    sw.reset_launches()
    sync(torch, dev)
    t0 = time.time()
    text = st.align_chunk(pr, 0, pr.n)[0]
    sync(torch, dev)
    wall = time.time() - t0
    launches = sw.launches()
    if text != ref:
        raise AssertionError("%s: SAM differs from the native engine"
                             % what)
    return wall, launches


def phase_main(torch, sw, host, Recorder, genome, index, aa, reads,
               threads, tag, dev):
    """Cold and warm runs of the staged engine's default configuration on
    one batch; byte parity with the native engine, no backtrack plane
    brought back, the gather and walk kernels launched.  Returns (aligner,
    kernel launches of the warm run, parsed reads, native SAM)."""
    pr = host.parse_queries_native(b"".join(reads), False,
                                   aa.max_query_length, aa.word_len)
    if pr.n != len(reads):
        raise AssertionError("%s: parsed %d of %d reads"
                             % (tag, pr.n, len(reads)))
    t0 = time.time()
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=threads)[0]
    t_native = time.time() - t0
    # Cold: the aligner's construction (the genome's upload) and the first
    # batch, as a short job pays them.
    t0 = time.time()
    st = Recorder(aa, genome, index, device=dev, n_threads=threads)
    _timed(torch, sw, st, pr, ref, dev, tag + " cold run")
    cold = time.time() - t0
    st.stats = {k: type(v)() for k, v in st.stats.items()}
    st.gap_log = []
    warm, launches = _timed(torch, sw, st, pr, ref, dev, tag + " warm run")
    s = st.stats
    _report(tag, pr.n, {"native_wall_s": t_native, "cold_wall_s": cold,
                        "warm_wall_s": warm}, s, launches)
    if s["plane_d2h_bytes"] != 0:
        raise AssertionError("%s: the default configuration brought back "
                             "%d bytes of backtrack planes"
                             % (tag, s["plane_d2h_bytes"]))
    for name in ("gather_problems", "rle_walk"):
        if s["dp_launches"] and launches[name] == 0:
            raise AssertionError("%s: %s was never launched" % (tag, name))
    return st, launches, pr, ref


def phase_ab(torch, sw, StagedAligner, genome, index, aa, pr, ref, threads,
             tag, dev):
    """The A/B configuration (host fetch, 4-bit packed uploads, planes to
    the native walkers) once on a batch, after the default runs warmed the
    card; byte parity with the native engine."""
    st = StagedAligner(aa, genome, index, device=dev, n_threads=threads,
                       **AB)
    warm, launches = _timed(torch, sw, st, pr, ref, dev, tag)
    _report(tag, pr.n, {"warm_wall_s": warm}, st.stats, launches)
    if launches["gather_problems"] or launches["rle_walk"]:
        raise AssertionError("%s: the A/B configuration ran the device "
                             "assembly or walk" % tag)


def testgen_files():
    """The repository's test genome and its L11 index, unpacked once."""
    d = os.path.join(CACHE, "testgen")
    idx = os.path.join(d, "testgen.X11_01_65525S")
    if not os.path.exists(idx):
        os.makedirs(d, exist_ok=True)
        gold = os.path.join(REPO, "tests", "golden")
        shutil.copy(os.path.join(gold, "testgen.nib2"), d)
        with gzip.open(os.path.join(gold, "testgen.X11_01_65525S.gz")) as f:
            with open(idx + ".tmp", "wb") as o:
                o.write(f.read())
        os.replace(idx + ".tmp", idx)
    return os.path.join(d, "testgen.nib2"), idx


def long_read_105k(rng):
    """The 105 kb three-segment split read of tests/test_long_reads.py
    (chr1 fwd + chr2 fwd + chr1 revcomp, 0.5 % substitutions)."""
    chr1, chr2 = chromosomes(os.path.join(REPO, "tests", "data",
                                          "testgen.fasta"))[:2]
    read = np.concatenate([
        chr1[2000:52000], chr2[5000:35000],
        np.frombuffer(chr1[60000:85000].tobytes().translate(_COMP)[::-1],
                      np.uint8)])
    m = rng.random(len(read)) < 0.005
    read[m] = _BASES[rng.integers(0, 4, int(m.sum()))]
    return [b">long105k\n%s\n" % read.tobytes()]


def phase_cli(nib, idx):
    """The port's CLI with --device cuda on the golden test set, with the
    host seed scan and with --seed device."""
    gold = os.path.join(REPO, "tests", "golden")
    with tempfile.TemporaryDirectory(dir=CACHE) as d:
        for f in (nib, idx, os.path.join(REPO, "tests", "data",
                                         "readsA_100bp.fasta")):
            os.symlink(f, os.path.join(d, os.path.basename(f)))
        env = dict(os.environ, PYTHONPATH=REPO)

        def body(p):
            with open(p, "rb") as f:
                return [ln for ln in f.read().split(b"\n")
                        if not ln.startswith(b"@PG")]
        for seed in ("host", "device"):
            run([sys.executable, "-m", "yaha_tpu_torch.cli", "-x",
                 "testgen.X11_01_65525S", "-q", "readsA_100bp.fasta",
                 "--engine", "batch-cuda", "--device", "cuda", "--seed",
                 seed, "-osh", "A.sam"], cwd=d, env=env)
            if body(os.path.join(d, "A.sam")) != body(
                    os.path.join(gold, "A_default.sam")):
                raise AssertionError("CLI --device cuda --seed %s: SAM "
                                     "differs from tests/golden/"
                                     "A_default.sam" % seed)
            log("phase4 cli: --engine batch-cuda --device cuda --seed %s == "
                "A_default.sam" % seed)


def _time_kernel(torch, dev, fn, sets, reps=8):
    """Mean ms of `fn` over `reps` launches cycling through the input sets,
    after one warm-up (CUDA events).  The launches queue up behind a spin
    of QUEUE_CYCLES on the card, so the host's time to issue them (the
    wrappers' Python, tens of microseconds a call) is not in the window
    unless the card outruns it."""
    fn(*sets[0])
    sync(torch, dev)
    torch.cuda._sleep(QUEUE_CYCLES)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for k in range(reps):
        fn(*sets[k % len(sets)])
    e1.record()
    sync(torch, dev)
    return e0.elapsed_time(e1) / reps


def _time_once(torch, dev, fn, args):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn(*args)
    e1.record()
    sync(torch, dev)
    return e0.elapsed_time(e1), out


def _bound(nbytes, ops):
    """(bound ms, what sets it) for a kernel that moves `nbytes` and does
    `ops` int32 operations."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / INT32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _record(torch, kernels, errs, phase, name, tag, ms, plain_ms, got,
            want, nbytes, ops, library_ms=None):
    """Hold a timed kernel's output to its plain version's and enter its
    times and bound in the kernels line (unless `kernels` is None)."""
    compare(torch, errs, phase, name, tag, got, want)
    bound_ms, bound_by = _bound(nbytes, ops)
    if kernels is not None:
        kernels[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms,
                             max_abs_err=errs[name])
    log("%s %s %s: kernel %.6f ms, plain %.3f ms, library %s ms, bound "
        "%.6f ms (%s: %d bytes, %d int32 ops), %.1f %% of the bound" % (
            phase, name, tag, ms, plain_ms, "none" if library_ms is None
            else "%.6f" % library_ms, bound_ms, bound_by, nbytes, ops,
            100 * bound_ms / ms))


def _band_cells_each(ql, rl, lb, rb, qmax):
    """In-band cells of each anchored problem: for every row i <= qlen, the
    columns max(1, i - lbw) .. min(i + rbw, rlen); rows 256 at a time."""
    ql, rl, lb, rb = (np.asarray(a, np.int64)[:, None]
                      for a in (ql, rl, lb, rb))
    out = np.zeros(len(ql), np.int64)
    for i0 in range(1, qmax + 1, 256):
        i = np.arange(i0, min(i0 + 256, qmax + 1))[None, :]
        lo = np.maximum(1, i - lb)
        hi = np.minimum(i + rb, rl)
        out += (np.maximum(hi - lo + 1, 0) * (i <= ql)).sum(1)
    return out


def _band_cells(ql, rl, lb, rb, qmax):
    return int(_band_cells_each(ql, rl, lb, rb, qmax).sum())


def _largest(st, name, prefer=None, widest=False):
    """The recorded bucket of kernel `name` with the most problems (with
    qg == prefer when there is one, or with the largest qg when
    `widest`)."""
    keys = [k for k in st.counts if k[0] == name]
    if not keys:
        raise AssertionError("phase5: the main path ran no %s bucket" % name)
    if prefer is not None and any(k[1] == prefer for k in keys):
        keys = [k for k in keys if k[1] == prefer]
    key = max(keys, key=lambda k: (k[1] if widest else 0, st.counts[k]))
    return key, st.buckets[key][1]


# Extension kernels timed in turns, by label: the register kernel in blocks
# of B threads ("regB") and the wide kernel.
EXT_TURNS = ["reg64", "wide", "reg32", "reg128", "reg128", "reg32", "wide",
             "reg64"]
WIDE_TURNS = ["wide", "wide"]


def _ext_turns(torch, sw, dev, kw, sets, tag, order, keep):
    """The extension kernels of `order` timed in turns on the same inputs
    (labels: "regB" the register kernel in blocks of B threads, "wide");
    returns {label: [ms, ...]} and the output of the kernel labelled
    `keep` on sets[1], which every other kernel's must equal."""
    def kernel(label):
        if label == "wide":
            return lambda *a: sw.extension_forward(*a, variant="wide", **kw)
        return lambda *a: sw.extension_forward(
            *a, variant="reg", block=int(label[3:]), **kw)
    times = {}
    for label in order:
        times.setdefault(label, []).append(_time_kernel(
            torch, dev, kernel(label), sets))
    log("phase5 extension %s: %s" % (tag, " ".join(
        "%s=%s ms" % (k, ",".join("%.6f" % t for t in v))
        for k, v in times.items())))
    kept = kernel(keep)(*sets[1])
    for label in times:
        other = kernel(label)(*sets[1])
        sync(torch, dev)
        for key in kept:
            if not torch.equal(other[key], kept[key]):
                raise AssertionError("phase5 extension %s: %s and %s "
                                     "kernels differ in %s" % (
                                         tag, label, keep, key))
    return times, kept


def _ext_plane_work(torch, bt):
    """(cells computed, last computed row of each problem) of an
    extension plane: every computed cell's byte is nonzero, and the other
    nonzero bytes of rows 1.. are the anti-diagonal insert cells (i,
    bw2 - i), i <= bw2."""
    h, w = bt.shape[1], bt.shape[2]
    bw2 = (w - 1) // 2
    fill = torch.zeros((h, w), dtype=torch.bool, device=bt.device)
    fill[0] = True
    for i in range(1, min(bw2, h - 1) + 1):
        fill[i, bw2 - i] = True
    rows = ((bt != 0) & ~fill).sum(-1)
    cells = int(rows.sum())
    idx = torch.arange(h, device=bt.device)
    return cells, ((rows > 0) * idx).max(-1).values


def _wide_lanes(torch, cells, last, w, tag):
    """The wide kernel's lane-step share: cells computed over 32 x its
    wavefront steps (a problem whose last computed row is in strip s takes
    s * P + 62 + W steps, P = max(W + 1, 64))."""
    period = max(w + 1, 64)
    steps = torch.where(last > 0, torch.div(last - 1, 32,
                                            rounding_mode="floor") * period +
                        62 + w, 0)
    total = int(steps.sum())
    log("phase5 extension_forward_wide %s: %d cells over %d wavefront steps "
        "x 32 lanes: %.1f %% of lane-steps busy" % (
            tag, cells, total, 100 * cells / max(1, 32 * total)))


# Walk team sizes timed in turns (lanes per problem).
WALK_TURNS = [32, 8, 16, 16, 8, 32]


def _walk_turns(torch, decode, dev, sets, wkw, tag):
    """The walk at each team size timed in turns on the same inputs;
    returns {team: [ms, ms]} and each team size's output on sets[1], whose
    counts and items must agree."""
    from yaha_tpu_torch.tools.decode_profile import items_below
    times = {}
    for team in WALK_TURNS:
        fn = (lambda t: lambda *a: decode.rle_walk(*a, team=t, **wkw))(team)
        times.setdefault(team, []).append(_time_kernel(torch, dev, fn,
                                                       sets))
    log("phase5 walk %s: %s" % (tag, " ".join(
        "team%d=%s ms" % (k, ",".join("%.6f" % t for t in v))
        for k, v in times.items())))
    outs = {team: decode.rle_walk(*sets[1], team=team, **wkw)
            for team in decode.WALK_TEAMS}
    sync(torch, dev)
    first = outs[decode.WALK_TEAM]
    for team, got in outs.items():
        if not (torch.equal(got[1], first[1]) and torch.equal(
                items_below(*got, wkw["cap"]),
                items_below(*first, wkw["cap"]))):
            raise AssertionError("phase5 walk %s: teams of %d and %d lanes "
                                 "differ" % (tag, team, decode.WALK_TEAM))
    return times, outs


def phase_times(torch, sw, st, st_wide, st_wider, st10, kernels, errs, dev):
    """Kernel (wrapper: output allocation + launch) and plain-version times
    at the main path's largest buckets, on the inputs the main path
    assembled on the card; CUDA events, distinct inputs (4 permutations of
    the bucket).  The kernel's output on the bucket must equal the plain
    version's.  The two extension kernels run in turns at the largest 1 kb
    bucket and at the 10 kb run's widest bucket, and the wide kernel at the
    -BW 9 and -BW 16 runs' largest buckets.  Each kernel's bound comes
    from this run's inputs: the cells its DP computed (the X-drop exits
    counted from the extension's plane), its walk's steps, its gather's
    bytes."""
    from yaha_tpu_torch.ops import decode, gather_dp
    from yaha_tpu_torch.tools.decode_profile import walk_work, items_below
    gap_kw, ext_kw = st.gap_kw, st.ext_kw
    rng = np.random.default_rng(SEED)

    def perms(n):
        return [torch.from_numpy(rng.permutation(n)).to(dev)
                for _ in range(4)]

    def finish(name, key, n, ms, plain_ms, got, want, nbytes, ops):
        _record(torch, kernels, errs, "phase5", name, "bucket=%s N=%d" % (
            list(key[1:]), n), ms, plain_ms, got, want, nbytes, ops)

    def bucket_sets(arrs):
        base = [a if torch.is_tensor(a) else torch.from_numpy(
            a.astype(np.int32)).to(dev) for a in arrs]
        return [[t.index_select(0, p).contiguous() for t in base]
                for p in perms(base[0].shape[0])]

    # The extension at the largest 1 kb bucket: both kernels in turns, then
    # the plain version once.
    ext_key, arrs = _largest(st, "extension_forward", 1024)
    n = arrs[0].shape[0]
    sets = bucket_sets(arrs)
    times, got = _ext_turns(torch, sw, dev, ext_kw, sets, "1kb bucket=%s N=%d"
                            % (list(ext_key[1:]), n), EXT_TURNS, "reg64")
    plain_ms, want = _time_once(
        torch, dev, lambda *a: sw.extension_forward_reference(*a, **ext_kw),
        sets[1])
    h, w = got["bt"].shape[1], got["bt"].shape[2]
    cells, last = _ext_plane_work(torch, got["bt"])
    nbytes = _nbytes(*sets[1]) + _nbytes(*got.values())
    finish("extension_forward", ext_key, n, float(np.mean(times["reg64"])),
           plain_ms, got, want, nbytes, cells * CELL_OPS)
    bound = _bound(nbytes, cells * CELL_OPS)[0]
    wide_ms = float(np.mean(times["wide"]))
    log("phase5 extension 1kb: wide kernel %.6f ms, %.1f %% of the bound" % (
        wide_ms, 100 * bound / wide_ms))
    log("phase5 extension cells computed: %d of %d (%.1f %%)" % (
        cells, n * (h - 1) * w, 100 * cells / (n * (h - 1) * w)))
    _wide_lanes(torch, cells, last, w, "1kb W=%d" % w)
    # Rows each problem computed, against the row steps of warps whose 32
    # lanes run in step (the register kernel).
    rows = last
    warp_rows = torch.nn.functional.pad(rows, (0, -n % 32)).view(
        -1, 32).max(-1).values
    log("phase5 extension rows: computed %d, longest problem %d, warp "
        "row steps x 32 lanes %d (%.1f %% of lane-rows busy)" % (
            int(rows.sum()), int(rows.max()), 32 * int(warp_rows.sum()),
            100 * int(rows.sum()) / (32 * int(warp_rows.sum()))))
    ext_out = got
    del want

    # The 4-bit packed entry (sw_cuda.extension_forward_p4: unpack on the
    # card, then the register kernel) on the same bucket, packed on the
    # card; its output must equal the unpacked entry's.
    psets = [[pack4(a[0]), a[1], pack4(a[2]), a[3]] for a in sets]
    p4_ms = _time_kernel(torch, dev, lambda *a: sw.extension_forward_p4(
        *a, **ext_kw), psets)
    p4 = sw.extension_forward_p4(*psets[1], **ext_kw)
    sync(torch, dev)
    for key in ext_out:
        if not torch.equal(p4[key], ext_out[key]):
            raise AssertionError("phase5 extension_forward_p4 differs from "
                                 "extension_forward in %s" % key)
    p4_bound, p4_by = _bound(_nbytes(*psets[1]) + _nbytes(*p4.values()),
                             cells * CELL_OPS)
    log("phase5 extension_forward_p4 bucket=%s N=%d: %.6f ms (unpack + "
        "register kernel; unpacked entry %.6f ms), bound %.6f ms (%s), "
        "%.1f %% of the bound; output = unpacked entry's" % (
            list(ext_key[1:]), n, p4_ms, float(np.mean(times["reg64"])),
            p4_bound, p4_by, 100 * p4_bound / p4_ms))
    del p4, psets, sets

    # The wide kernel at the largest -BW 9 and -BW 16 buckets (the first
    # enters the kernels line), its plain version on the first
    # PLAIN_SLICE problems (the plain version's time is about that of its
    # longest problem).
    for wst, record in ((st_wide, True), (st_wider, False)):
        key, arrs = _largest(wst, "extension_forward", 1024)
        n = arrs[0].shape[0]
        sets = bucket_sets(arrs)
        kw = wst.ext_kw
        tag = "bucket=%s N=%d BW=%d" % (list(key[1:]), n, kw["band_width"])
        times, got = _ext_turns(torch, sw, dev, kw, sets, tag, WIDE_TURNS,
                                "wide")
        m = min(n, PLAIN_SLICE)
        part = [t[:m].contiguous() for t in sets[1]]
        plain_ms, want = _time_once(
            torch, dev, lambda *a: sw.extension_forward_reference(*a, **kw),
            part)
        cells, last = _ext_plane_work(torch, got["bt"])
        nbytes = _nbytes(*sets[1]) + _nbytes(*got.values())
        ms = float(np.mean(times["wide"]))
        _record(torch, kernels if record else None, errs, "phase5",
                "extension_forward_wide", tag + " (plain: first %d)" % m, ms,
                plain_ms, {k: v[:m] for k, v in got.items()}, want, nbytes,
                cells * CELL_OPS)
        _wide_lanes(torch, cells, last, got["bt"].shape[2], tag)
        del sets, got, want, part, last

    # The extension at the 10 kb run's widest bucket: both kernels in turns
    # (the plain version would take minutes there; both kernels are held to
    # it above and in phase 2).
    key10, arrs10 = _largest(st10, "extension_forward", widest=True)
    times10, got10 = _ext_turns(torch, sw, dev, st10.ext_kw,
                                bucket_sets(arrs10), "10kb bucket=%s N=%d" % (
                                    list(key10[1:]), arrs10[0].shape[0]),
                                EXT_TURNS, "reg64")
    cells10, last10 = _ext_plane_work(torch, got10["bt"])
    b10, by10 = _bound(_nbytes(*bucket_sets(arrs10)[0]) +
                       _nbytes(*got10.values()), cells10 * CELL_OPS)
    log("phase5 extension 10kb: bound %.6f ms (%s), cells computed %d; %s" % (
        b10, by10, cells10, ", ".join(
            "%s %.1f %%" % (k, 100 * b10 / np.mean(v))
            for k, v in times10.items())))
    _wide_lanes(torch, cells10, last10, got10["bt"].shape[2], "10kb")
    # The walk on those planes, every team size in turns (the plain version
    # would take minutes there; every team size is held to it above).
    cap10 = 1 << (2 * key10[1] + got10["bt"].shape[2] + 1).bit_length()
    walk_in = [got10["bt"], got10["maxi"], got10["maxj"], got10["score"] > 0]
    del got10
    sets = [[t.index_select(0, p).contiguous() for t in walk_in]
            for p in perms(walk_in[0].shape[0])]
    del walk_in
    wkw = dict(cap=cap10, full=False)
    times10, outs10 = _walk_turns(torch, decode, dev, sets, wkw,
                                  "10kb bucket=%s N=%d" % (
                                      list(key10[1:]), sets[0][0].shape[0]))
    wb10, steps10 = walk_work(*outs10[decode.WALK_TEAM], cap10,
                               sets[1][1:])
    b10, by10 = _bound(wb10, steps10 * WALK_STEP_OPS)
    log("phase5 walk 10kb: bound %.6f ms (%s: %d bytes, %d steps), %s" % (
        b10, by10, wb10, steps10, " ".join(
            "team%d %.2f %%" % (k, 100 * b10 / np.mean(v))
            for k, v in times10.items())))
    del sets, outs10

    # The anchored entries at their largest 1 kb buckets: the kernel on
    # shuffled copies of the bucket (as every kernel here, and as earlier
    # versions of this script timed the first anchored kernels) and in the
    # main path's problem order, which sets the lanes of each warp, in
    # turns; then the plain version once; the plane's zero fill alone,
    # which the kernel does without (it writes every byte).
    for name in ("anchored_forward_banded", "anchored_forward"):
        key, arrs = _largest(st, name)
        n = arrs[0].shape[0]
        ql_, rl_, lb, rb = (np.asarray(arrs[k]).astype(np.int64)
                            for k in (1, 3, 4, 5))
        if name == "anchored_forward_banded":
            kw = dict(gap_kw, wband=key[3])
            fn = sw.anchored_forward_banded
            plain = sw.anchored_forward_banded_reference
        else:
            fn, kw = sw.anchored_forward, gap_kw
            plain = sw.anchored_forward_reference
        sets = bucket_sets(arrs)
        base = [a if torch.is_tensor(a) else torch.from_numpy(
            a.astype(np.int32)).to(dev) for a in arrs]
        tag = "bucket=%s N=%d" % (list(key[1:]), n)
        times = {}
        for label in ("shuffled", "main", "main", "shuffled"):
            times.setdefault(label, []).append(_time_kernel(
                torch, dev, lambda *a, fn=fn, kw=kw: fn(*a, **kw),
                sets if label == "shuffled" else [base]))
        log("phase5 %s %s: %s" % (name, tag, " ".join(
            "%s=%s ms" % (k, ",".join("%.6f" % t for t in v))
            for k, v in times.items())))
        plain_ms, want = _time_once(torch, dev, lambda *a: plain(*a, **kw),
                                    sets[1])
        got = fn(*sets[1], **kw)
        cells = _band_cells(ql_, rl_, lb, rb, key[1])
        nbytes = _nbytes(*sets[1]) + _nbytes(*got.values())
        ms = float(np.mean(times["shuffled"]))
        finish(name, key, n, ms, plain_ms, got, want, nbytes,
               cells * CELL_OPS)
        main_ms = float(np.mean(times["main"]))
        log("phase5 %s %s: main path order %.6f ms, %.1f %% of the bound" % (
            name, tag, main_ms,
            100 * _bound(nbytes, cells * CELL_OPS)[0] / main_ms))
        plane = got["bt_b" if "bt_b" in got else "bt"]
        fill_ms = _time_kernel(torch, dev, lambda: torch.zeros(
            plane.shape, dtype=torch.int8, device=dev), [[]])
        log("phase5 %s %s: plane zero fill alone %.6f ms (%d bytes), %.1f "
            "%% of the kernel's time" % (name, tag, fill_ms, plane.numel(),
                                         100 * fill_ms / ms))
        del sets, base, got, want, plane

    # The walk on the largest extension bucket's planes, from its best
    # cells, at the engine's cap: every team size in turns, then the plain
    # version once.  The bound counts the walk's own work
    # (walk_work), not the [N, cap] item buffer.
    cap = 1 << (2 * ext_key[1] + w + 1).bit_length()
    walk_in = [ext_out["bt"], ext_out["maxi"], ext_out["maxj"],
               ext_out["score"] > 0]
    n = walk_in[0].shape[0]
    sets = [[t.index_select(0, p).contiguous() for t in walk_in]
            for p in perms(n)]
    del ext_out, walk_in
    wkw = dict(cap=cap, full=False)
    times, outs = _walk_turns(torch, decode, dev, sets, wkw,
                              "1kb bucket=%s N=%d" % (list(ext_key[1:]), n))
    plain_ms, want = _time_once(
        torch, dev, lambda *a: decode.rle_walk_reference(*a, **wkw), sets[1])
    wbytes, steps = walk_work(*want, cap, sets[1][1:])
    got = outs[decode.WALK_TEAM]
    finish("rle_walk", ext_key, n, float(np.mean(times[decode.WALK_TEAM])),
           plain_ms, {"rle": items_below(*got, cap), "n_ops": got[1]},
           {"rle": want[0], "n_ops": want[1]}, wbytes, steps * WALK_STEP_OPS)
    bound, _ = _bound(wbytes, steps * WALK_STEP_OPS)
    log("phase5 walk 1kb: %d steps, %d items; bound %.6f ms; the [N, cap] "
        "item buffer alone would be %.6f ms at the memory rate; %s" % (
            steps, int(torch.where(want[1] < 0, cap, want[1]).sum()), bound,
            _nbytes(want[0]) / HBM_BYTES_S * 1e3, " ".join(
                "team%d %.2f %%" % (k, 100 * bound / np.mean(v))
                for k, v in times.items())))
    del sets, outs, want

    # The gather of the largest extension bucket, from the chunk's strand
    # rows and the bucket's own coordinates.
    key, (rows2, coords) = _largest(st, "gather_problems", 1024)
    gkw = dict(qg=key[1], rg=key[2], rpad=key[3])
    codes = st.corpus.codes
    n = coords.shape[1]
    sets = [[rows2, codes, torch.from_numpy(
        np.ascontiguousarray(coords[:, p.cpu().numpy()])).to(dev)]
        for p in perms(n)]
    ms = _time_kernel(torch, dev,
                      lambda *a: gather_dp.gather_problems(*a, **gkw), sets)
    plain_ms, want = _time_once(
        torch, dev, lambda *a: gather_dp.gather_reference(*a, **gkw),
        sets[1])
    got = gather_dp.gather_problems(*sets[1], **gkw)
    out_bytes = _nbytes(*got)
    copied = int(coords[2].sum() + coords[5].sum())   # q_copy + r_copy
    finish("gather_problems", key, n, ms, plain_ms,
           {"q": got[0], "r": got[1]}, {"q": want[0], "r": want[1]},
           out_bytes + copied + coords.nbytes, out_bytes * GATHER_BYTE_OPS)


def _seed_recorder(torch, DeviceSeeder):
    """A DeviceSeeder that keeps, for phase 6's checks and times, the
    strand rows and lengths of its largest chunk ("rows") and the hashes
    and clean flags of its largest launch at each capacity tier."""
    class SeedRecorder(DeviceSeeder):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.kept = {}

        def _keep(self, key, arrays):
            if key not in self.kept or (arrays[0].shape[0] >
                                        self.kept[key][0].shape[0]):
                self.kept[key] = arrays

        def seed_chunk(self, pr, lo, hi, rows2=None):
            if rows2 is not None:
                offs = np.ctypeslib.as_array(pr.seq_offs, shape=(pr.n + 1,))
                lens = np.repeat(np.diff(offs[lo:hi + 1]), 2)
                self._keep("rows", (rows2, torch.from_numpy(lens.astype(
                    np.int32)).to(rows2.device)))
            return super().seed_chunk(pr, lo, hi, rows2)

        def _expand(self, hashes, clean, capacity):
            self._keep(capacity, (hashes, clean))
            return super()._expand(hashes, clean, capacity)
    return SeedRecorder


def _reset_stats(*objs):
    """Zero the run stats of aligners and seeders (a seeder's index upload
    figures stay)."""
    for o in objs:
        o.stats.update({k: type(v)() for k, v in o.stats.items()
                        if not k.startswith("index_upload")})


def _seed_report(tag, seeder):
    s = seeder.stats
    log("%s seeder: seed_launches=%d seed_h2d_mb=%.3f seed_d2h_mb=%.3f "
        "cap_retries=%d phantom_rows=%d fallback_rows=%d seed_device_s=%.4f"
        % (tag, s["seed_launches"], s["seed_h2d_bytes"] / 1e6,
           s["seed_d2h_bytes"] / 1e6, s["cap_retries"], s["phantom_rows"],
           s["fallback_rows"], s["seed_device_s"]))


def phase_seed(torch, sw, StagedAligner, SeedRecorder, genome, index, aa,
               pr, ref, threads, dev):
    """The 1 kb batch with the device seeder (--seed device, the full L15
    index resident on the card): the seeder's construction (the index's
    upload) and a cold run, then a warm run with the launch counts reset
    just before it, SAM bytes equal to the native engine's each time; then
    the host seed scan and the device seeder in turns (host, device,
    device, host) with begin_s and the warm wall.  Returns (seeder,
    launches of the warm run)."""
    t0 = time.time()
    seeder = SeedRecorder(aa, index, device=dev)
    s = seeder.stats
    log("phase6 index upload: %d bytes (SO %d + ROA %d entries) in %.3f s, "
        "%.2f GB/s" % (s["index_upload_bytes"],
                       seeder.iview.starting_offs.size, seeder.iview.roa.size,
                       s["index_upload_s"], s["index_upload_bytes"] / 1e9 /
                       s["index_upload_s"]))
    st = StagedAligner(aa, genome, index, device=dev, n_threads=threads,
                       seeder=seeder)
    _timed(torch, sw, st, pr, ref, dev, "phase6 1kb seed cold run")
    cold = time.time() - t0
    _reset_stats(st, seeder)
    warm, launches = _timed(torch, sw, st, pr, ref, dev,
                            "phase6 1kb seed warm run")
    _report("phase6 1kb seed", pr.n, {"cold_wall_s": cold,
                                      "warm_wall_s": warm}, st.stats,
            launches)
    _seed_report("phase6 1kb", seeder)
    for name in KERNELS:
        if (launches[name] == 0) != (name == "extension_forward_wide" or
                                     name in CHAIN_KERNELS + SCALE_KERNELS):
            raise AssertionError("phase6: %s launched %d times" % (
                name, launches[name]))
    # The host seed scan (a fresh default aligner) and the device seeder
    # in turns.
    host_st = StagedAligner(aa, genome, index, device=dev, n_threads=threads)
    _timed(torch, sw, host_st, pr, ref, dev, "phase6 host-seed first run")
    for label in ("host", "device", "device", "host"):
        a = host_st if label == "host" else st
        _reset_stats(a, seeder)
        wall, _ = _timed(torch, sw, a, pr, ref, dev, "phase6 turn " + label)
        log("phase6 1kb turn seed=%s: warm_wall_s=%.4f seed_device_s=%.4f "
            "device_s=%.4f host_s=%s" % (
                label, wall, seeder.stats["seed_device_s"] if a is st else 0,
                a.stats["device_s"], json.dumps({k[:-2]: round(
                    a.stats[k], 4) for k in ("begin_s", "gap_host_s",
                                             "phase2_s", "ext_host_s",
                                             "finish_s")})))
    return seeder, launches


def phase_seed_reads(torch, sw, host, StagedAligner, DeviceSeeder, seeder,
                     genome, index, aa10, pr10, ref10, tg_nib, tg_idx,
                     threads, dev):
    """The device seeder on the 10 kb reads (their rows pass 1,024 hits:
    the tier-2 retry and the host-scan rows) and on the golden test set
    (readsC_1kb.fasta at -BW 3 -G 20 -M 15 -X 15 against the L11 test
    index: phantom, retry and host-scan rows all occur); SAM bytes equal to
    the native engine's each time."""
    _reset_stats(seeder)
    st = StagedAligner(aa10, genome, index, device=dev, n_threads=threads,
                       seeder=seeder)
    wall, launches = _timed(torch, sw, st, pr10, ref10, dev,
                            "phase6 10kb seed")
    _report("phase6 10kb seed", pr10.n, {"warm_wall_s": wall}, st.stats,
            launches)
    _seed_report("phase6 10kb", seeder)
    if not seeder.stats["cap_retries"]:
        raise AssertionError("phase6 10kb: no row went to the second tier")
    tg_index = host.load_index(tg_idx)
    tg_genome = host.load_genome(tg_nib)
    aa = _aa(host, tg_index, tg_idx, band_width=3, max_gap=20, min_match=15,
             x_cutoff=15)
    with open(os.path.join(REPO, "tests", "data", "readsC_1kb.fasta"),
              "rb") as f:
        pr = host.parse_queries_native(f.read(), False, aa.max_query_length,
                                       aa.word_len)
    ref = host.align_batch_native(pr, 0, pr.n, tg_genome, tg_index, aa,
                                  n_threads=threads)[0]
    tg_seeder = DeviceSeeder(aa, tg_index, device=dev)
    st = StagedAligner(aa, tg_genome, tg_index, device=dev,
                       n_threads=threads, seeder=tg_seeder)
    wall, launches = _timed(torch, sw, st, pr, ref, dev,
                            "phase6 readsC params seed")
    _seed_report("phase6 readsC params", tg_seeder)
    s = tg_seeder.stats
    if not (s["phantom_rows"] and s["cap_retries"] and s["fallback_rows"]):
        raise AssertionError("phase6 readsC params: phantom, retry and "
                             "host-scan rows must all occur: %s" % s)
    log("phase6 readsC params: reads=%d parity=true wall_s=%.4f launches=%s"
        % (pr.n, wall, json.dumps({k: launches[k] for k in SEED_KERNELS})))


def _mean(v):
    return sum(v) / len(v)


def _cached_index(torch, seeds, hashes, clean, so, max_hits):
    """The same kept runs from an index that stays in L2: each kept window's
    hash becomes its count v, whose run in an SO of max_hits + 2 words
    (so[v] = v (v - 1) / 2) is v words of a random ROA of 845 KB at 650
    hits; windows not kept are not clean.  Row totals, slots and sort sizes
    are the main path's; only the SO and ROA reads hit the cache."""
    cnt, _ = seeds.seed_counts(hashes, clean, so)
    kept = (cnt > 0) & (cnt <= max_hits)
    v = torch.arange(max_hits + 2, dtype=torch.int64, device=so.device)
    so2 = (v * (v - 1) // 2).to(torch.int32)
    gen = torch.Generator(device=so.device).manual_seed(SEED)
    roa2 = torch.randint(-2 ** 31, 2 ** 31, (int(so2[-1]),), generator=gen,
                         dtype=torch.int32, device=so.device)
    return torch.where(kept, cnt, 0).to(torch.int32), kept, so2, roa2


def phase_seed_kernels(torch, seeds, seeder, kernels, errs, dev):
    """Both seed kernels against their plain versions at the 1 kb batch's
    shapes, on the main path's own inputs (the recorder's strand rows and
    tier launches): seed_hashes on the rows, expand_sort_hits on the whole
    batch at C = 1,024 and on the tier-2 population at C = 8,192 and 1,024;
    then each kernel's time at its largest launch (CUDA events, 4 shuffled
    copies) beside its bound and its plain version's time, and beside the
    expansion, torch.sort(dim=1) of the same keys (int64 with the sign bit
    flipped, so that the order is diag's unsigned one) as its library
    yardstick; the tier-2 launch's time beside its own bound; each tier's
    breakdown (PERF.md section 6) and torch.take of its SO words."""
    rng = np.random.default_rng(SEED)
    wl = seeder.word_len
    so, roa = seeder.so_dev, seeder.roa_dev
    mh = int(seeder.aa.max_hits)
    rows2, lengths = seeder.kept["rows"]
    b, l = rows2.shape
    n = l - wl + 1
    hkw = dict(word_len=wl)

    def shuffled(arrs):
        perms = [torch.from_numpy(rng.permutation(arrs[0].shape[0])).to(dev)
                 for _ in range(4)]
        return [[a.index_select(0, p) for a in arrs] for p in perms]

    sets = shuffled([rows2, lengths])
    ms = _time_kernel(torch, dev, lambda *a: seeds.seed_hashes(*a, **hkw),
                      sets)
    plain_ms, want = _time_once(
        torch, dev, lambda *a: seeds.seed_hashes_reference(*a, **hkw), sets[1])
    got = seeds.seed_hashes(*sets[1], **hkw)
    sync(torch, dev)
    tag = "rows=%d L=%d wl=%d" % (b, l, wl)
    _record(torch, kernels, errs, "phase6", "seed_hashes", tag, ms, plain_ms,
            {"hashes": got[0], "clean": got[1]},
            {"hashes": want[0], "clean": want[1]},
            b * l + 4 * b + 5 * b * n, b * n * HASH_WINDOW_OPS)
    del sets, got, want
    for cap, (hashes, clean) in sorted((k, v) for k, v in seeder.kept.items()
                                       if k != "rows"):
        for c in sorted({cap, seeder.CAP_TIERS[0]}):
            kw = dict(max_hits=mh, capacity=c)
            got = seeds.expand_sort_hits(hashes, clean, so, roa, **kw)
            sync(torch, dev)
            compare(torch, errs, "phase6", "expand_sort_hits",
                    "tier-%d population rows=%d N=%d C=%d" % (
                        seeder.CAP_TIERS.index(cap) + 1, hashes.shape[0],
                        hashes.shape[1], c), got,
                    seeds.expand_sort_hits_reference(hashes, clean, so, roa,
                                                     **kw))
            del got
    for cap in seeder.CAP_TIERS:
        hashes, clean = seeder.kept[cap]
        kw = dict(max_hits=mh, capacity=cap)
        sets = shuffled([hashes, clean])
        ms = _time_kernel(torch, dev, lambda *a: seeds.expand_sort_hits(
            *a, so, roa, **kw), sets)
        plain_ms, want = _time_once(
            torch, dev, lambda *a: seeds.expand_sort_hits_reference(
                *a, so, roa, **kw), sets[1])
        got = seeds.expand_sort_hits(*sets[1], so, roa, **kw)
        # The sort's yardstick on the plain expansion's unsorted keys:
        # (diag << 32 | qo) ^ (1 << 63), written (diag - 2^31) << 32 | qo so
        # that no shift leaves the int64 range.
        keys = []
        for h, c in sets:
            pre = seeds._expand_reference(h, c, so, roa, **kw)
            keys.append([((pre["diag"] - (1 << 31)) << 32) | pre["qo"]])
            del pre
        lib_ms = _time_kernel(torch, dev, lambda k: torch.sort(k, dim=1),
                              keys)
        lib = torch.sort(keys[1][0], dim=1).values
        sync(torch, dev)
        if not (torch.equal((lib >> 32) + (1 << 31), got["diag"].to(
                torch.int64) & 0xFFFFFFFF) and torch.equal(
                    lib & 0xFFFFFFFF, got["qo"].to(torch.int64))):
            raise AssertionError("phase6 expand_sort_hits C=%d: torch.sort "
                                 "of the keys differs from the kernel" % cap)
        del keys, lib
        rows, windows = hashes.shape
        valid = want["total"].to(torch.int64).clamp(0, cap)
        steps = torch.where(valid > 1, valid * torch.ceil(torch.log2(
            valid.clamp(min=2).double())).to(torch.int64), 0)
        nbytes = (_nbytes(hashes, clean) + 8 * int(clean.sum()) +
                  4 * int(valid.sum()) + _nbytes(*got.values()))
        ops = SORT_CMP_OPS * int(steps.sum()) + WINDOW_OPS * rows * windows
        tag = "C=%d rows=%d N=%d" % (cap, rows, windows)
        entry = kernels["expand_sort_hits"]
        if cap == seeder.CAP_TIERS[0]:
            _record(torch, kernels, errs, "phase6", "expand_sort_hits", tag,
                    ms, plain_ms, got, want, nbytes, ops, library_ms=lib_ms)
        else:
            compare(torch, errs, "phase6", "expand_sort_hits", tag, got,
                    want)
            bound_ms, bound_by = _bound(nbytes, ops)
            entry["tier2"] = {"rows": rows, "capacity": cap, "ms": ms,
                              "plain_ms": plain_ms, "library_ms": lib_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by}
            log("phase6 expand_sort_hits %s (tier 2): kernel %.6f ms, plain "
                "%.3f ms, torch.sort %.6f ms, bound %.6f ms (%s), %.1f %% of "
                "the bound" % (tag, ms, plain_ms, lib_ms, bound_ms, bound_by,
                               100 * bound_ms / ms))
        del got, want
        # The breakdown (PERF.md section 6): the launch on (i) the main
        # path's inputs, (ii) the same at max_hits = 1 (the same SO reads
        # and scan; only single-hit windows expanded and sorted), (iv) at
        # max_hits = 0 (the SO reads and the scan; nothing kept), (iii) the
        # same hashes with no clean window (the scan of zeros and the
        # C-slot write alone) and (v) the main path's kept runs from an
        # index held in L2 (_cached_index: the same slots and sorts, the
        # reads out of the way); kernel = plain on one copy of each, then
        # the variants timed in turns, first to last and back.
        dst = entry if cap == seeder.CAP_TIERS[0] else entry["tier2"]
        cached = [_cached_index(torch, seeds, h, c, so, mh) for h, c in sets]
        variants = {
            "i_main": ([(h, c, so, roa) for h, c in sets], kw),
            "ii_max_hits_1": ([(h, c, so, roa) for h, c in sets],
                              dict(kw, max_hits=1)),
            "iv_max_hits_0": ([(h, c, so, roa) for h, c in sets],
                              dict(kw, max_hits=0)),
            "iii_no_clean": ([(h, torch.zeros_like(c), so, roa)
                              for h, c in sets], kw),
            "v_cached_index": (cached, kw)}
        for name, (vsets, vkw) in variants.items():
            if name != "i_main":
                got = seeds.expand_sort_hits(*vsets[1], **vkw)
                sync(torch, dev)
                compare(torch, errs, "phase6", "expand_sort_hits",
                        "%s %s" % (name, tag), got,
                        seeds.expand_sort_hits_reference(*vsets[1], **vkw))
                del got
        times = {}
        for name in list(variants) + list(variants)[::-1]:
            vsets, vkw = variants[name]
            times.setdefault(name, []).append(_time_kernel(
                torch, dev, lambda *a: seeds.expand_sort_hits(*a, **vkw),
                vsets))
        dst["breakdown_ms"] = {k: _mean(v) for k, v in times.items()}
        log("phase6 expand_sort_hits %s breakdown: %s" % (tag, " ".join(
            "%s=%s ms" % (k, ",".join("%.6f" % t for t in v))
            for k, v in times.items())))
        del cached, variants
        # The SO reads' yardstick: torch.take of one SO word a window at
        # the same hashes (0 where not clean, as the kernel reads), over
        # the whole 4^wl + 1 table and folded into its first 64 MB.
        idx = [[h.to(torch.int64)] for h, _ in sets]
        near = [[i[0] & ((1 << 24) - 1)] for i in idx]
        dst["so_take_ms"] = {
            "all": _time_kernel(torch, dev, lambda i: torch.take(so, i), idx),
            "first_64mb": _time_kernel(torch, dev,
                                       lambda i: torch.take(so, i), near)}
        log("phase6 expand_sort_hits %s: torch.take of one SO word a "
            "window: %s" % (tag, json.dumps(dst["so_take_ms"])))
        del idx, near
        del sets


def phase_gap_histogram(sw, runs):
    """Every gap launch of each run (the Recorder's gap log): (kernel, qg,
    rg, plane width, N), its warps of 32 problems by width class
    (warp_classes: K8/K16/K32 in registers, "wide" a warp a problem) and
    each class's share of the launch's in-band cells; then each run's
    shares."""
    for tag, st in runs:
        total = {}
        for banded, qg, rg, wband, ql, rl, lb, rb in st.gap_log:
            if banded:
                live = anch_live(lb, rb, rl, wband=wband)
                w = wband
            else:
                live = anch_live(lb, rb, rl, rl=rg)
                w = rg + 1
            classes = warp_classes(sw, live)
            cells = _band_cells_each(ql, rl, lb, rb, qg)
            warp_cells = np.pad(cells, (0, -len(cells) % 32)).reshape(
                -1, 32).sum(1)
            by_class = {k: (int((classes == k).sum()),
                            int(warp_cells[classes == k].sum()))
                        for k in sorted(set(classes))}
            for k, (_, c) in by_class.items():
                total[k] = total.get(k, 0) + c
            log("phase5 gap launch %s: %s qg=%d rg=%d width=%d N=%d warps=%s "
                "cell_share=%s" % (
                    tag, "banded" if banded else "full", qg, rg, w, len(ql),
                    json.dumps({k: v[0] for k, v in by_class.items()}),
                    json.dumps({k: round(v[1] / max(1, cells.sum()), 4)
                                for k, v in by_class.items()})))
        all_cells = max(1, sum(total.values()))
        log("phase5 gap cells %s: %d in-band cells, by class %s; warps wider "
            "than 32 columns carry %.2f %%" % (
                tag, sum(total.values()), json.dumps(
                    {k: round(v / all_cells, 4) for k, v in total.items()}),
                100 * total.get("wide", 0) / all_cells))


def _anch_rows(sw, st, name):
    """(key, arrays, live widths, in-band cells, warp classes, cells in
    wide warps) of every gap bucket a run sent to one anchored kernel."""
    rows = []
    for key in [k for k in st.counts if k[0] == name]:
        arrs = st.buckets[key][1]
        ql_, rl_, lb, rb = (np.asarray(arrs[k]).astype(np.int64)
                            for k in (1, 3, 4, 5))
        if name == "anchored_forward_banded":
            live = anch_live(lb, rb, rl_, wband=key[3])
        else:
            live = anch_live(lb, rb, rl_, rl=key[2])
        cells = _band_cells_each(ql_, rl_, lb, rb, key[1])
        classes = warp_classes(sw, live)
        warp_cells = np.pad(cells, (0, -len(cells) % 32)).reshape(
            -1, 32).sum(1)
        rows.append((key, arrs, live, cells, classes,
                     int(warp_cells[classes == "wide"].sum())))
    return rows


def phase_anch_bw16(torch, sw, st, kernels, errs, dev):
    """Both anchored kernels at the -BW 16 run's gap buckets (the
    wide-band gap fills, where the warps wider than 32 columns take the
    wide route, a warp a problem): for each kernel its largest bucket and
    the bucket whose warps wider than 32 columns hold the most in-band
    cells, timed in the main path's order beside the bound, ns per in-band
    cell and the share of the cells in wide warps (buckets are split by
    shape, so a bucket's warps fall in one class: the wide warps' cost
    reads as ns per cell against a K32 bucket's); the plain version on the
    first BW16_PLAIN problems, which the kernel's output must equal."""
    gap_kw = st.gap_kw
    for name in ("anchored_forward_banded", "anchored_forward"):
        rows = _anch_rows(sw, st, name)
        if not rows:
            log("phase5 BW%d %s: the run sent no gap bucket to this kernel"
                % (WIDER_BW, name))
            continue
        largest = max(rows, key=lambda r: st.counts[r[0]])
        widest = max(rows, key=lambda r: r[5])
        timed = []
        for key, arrs, live, cells, classes, wide_cells in (
                [largest] + ([widest] if widest[5] and widest is not largest
                             else [])):
            timed.append(_anch_bucket(
                torch, sw, gap_kw, errs, name, key, arrs, live, cells,
                classes, wide_cells, dev, "BW%d" % WIDER_BW))
        kernels[name]["bw16"] = timed


def phase_medium_indels(torch, sw, st, kernels, errs, dev):
    """The medium-indel batch's gap buckets: in each layout the bucket
    whose wide warps hold the most in-band cells, timed and held to the
    plain version as phase_anch_bw16 does.  The batch must send wide warps
    to both layouts (it is the wide route's traffic at the default -BW)."""
    for name in ("anchored_forward_banded", "anchored_forward"):
        rows = [r for r in _anch_rows(sw, st, name) if r[5]]
        if not rows:
            raise AssertionError("phase5 medium indels: no wide warp went "
                                 "to %s" % name)
        key, arrs, live, cells, classes, wide_cells = max(
            rows, key=lambda r: r[5])
        kernels[name]["medium_indels"] = _anch_bucket(
            torch, sw, st.gap_kw, errs, name, key, arrs, live, cells,
            classes, wide_cells, dev, "medium indels")


def _anch_bucket(torch, sw, gap_kw, errs, name, key, arrs, live, cells,
                 classes, wide_cells, dev, run):
    """One anchored gap bucket of `run`, timed beside its bound and held to
    the plain version on its first BW16_PLAIN problems; returns its
    figures."""
    n = arrs[0].shape[0]
    if name == "anchored_forward_banded":
        kw = dict(gap_kw, wband=key[3])
        fn, plain = sw.anchored_forward_banded, \
            sw.anchored_forward_banded_reference
    else:
        fn, kw, plain = (sw.anchored_forward, gap_kw,
                         sw.anchored_forward_reference)
    base = [a if torch.is_tensor(a) else torch.from_numpy(
        a.astype(np.int32)).to(dev) for a in arrs]
    ms = _time_kernel(torch, dev, lambda *a: fn(*a, **kw), [base])
    got = fn(*base, **kw)
    m = min(n, BW16_PLAIN)
    part = [t[:m].contiguous() for t in base]
    plain_ms, want = _time_once(torch, dev, lambda *a: plain(*a, **kw),
                                part)
    tag = "%s bucket=%s N=%d" % (run, list(key[1:]), n)
    compare(torch, errs, "phase5", name, tag + " (first %d)" % m,
            {k: v[:m] for k, v in got.items()}, want)
    total = int(cells.sum())
    bound, by = _bound(_nbytes(*base) + _nbytes(*got.values()),
                       total * CELL_OPS)
    out = {"bucket": list(key[1:]), "n": n, "ms": ms, "bound_ms": bound,
           "bound_by": by, "cells": total, "ns_per_cell": 1e6 * ms / total,
           "wide_cell_share": wide_cells / max(1, total),
           "plain_ms": plain_ms, "plain_n": m}
    log("phase5 %s %s: warps %s; kernel %.6f ms, %.1f %% of its bound "
        "%.6f ms (%s), %.4f ns per in-band cell (%d cells), %.2f %% of them "
        "in warps wider than 32 columns; plain %.3f ms on the first %d" % (
            name, tag, json.dumps({k: int((classes == k).sum())
                                   for k in sorted(set(classes))}),
            ms, 100 * bound / ms, bound, by, out["ns_per_cell"], total,
            100 * out["wide_cell_share"], plain_ms, m))
    return out


def phase_chain(torch, sw, kernels, errs, dev):
    """The chain DP (ops/chain.py, csrc/chain_kernels.cu), which no engine
    runs: numpy-seeded ranges made as tests/test_chain_jax.py makes them
    (a fifth wrapping uint32) at CHAIN_SHAPES.  The path: counts set to 0,
    batched_chain_dp on both shapes, counts read.  Then each output equal
    to the plain version's on the card and, on the first CHAIN_NATIVE
    ranges, to the native chain_dp's on the ranges' valid nodes; the
    kernel timed on 4 shuffled copies beside its bound (int32 operations
    of the pairs the SQO window leaves by how far each gets,
    chain_window_ops, or bytes), the first kernel's bound (every valid
    pair, chain_ops) printed beside it, and each shape's candidate-DAG
    counts (chain_dag)."""
    from yaha_tpu_torch.ops import chain
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_dp_cases import CHAIN_KW, chain_case, native_chain
    rng = np.random.default_rng(SEED)
    cases = []
    for k, (b, n, qspan) in enumerate(CHAIN_SHAPES):
        sqo, eqo, diag, length, valid, diag_orig, counts = chain_case(
            SEED + k, b, n, qspan)
        args = [torch.from_numpy(a.astype(np.int32)).to(dev)
                for a in (sqo, eqo, diag, length)]
        args.append(torch.from_numpy(valid).to(dev))
        cases.append((args, (sqo, eqo, diag_orig, length, valid), counts))
    sw.reset_launches()
    sync(torch, dev)
    outs = [chain.batched_chain_dp(*args, **CHAIN_KW)
            for args, _, _ in cases]
    sync(torch, dev)
    launched = sw.launches()
    if launched["chain_dp"] != len(cases) or any(
            v for k, v in launched.items() if k != "chain_dp"):
        raise AssertionError("phase7: launches %s" % launched)
    kernels["chain_dp"]["launches"] = launched["chain_dp"]
    for k, ((args, host_in, counts), got) in enumerate(zip(cases, outs)):
        b, n = args[0].shape
        tag = "B=%d N=%d" % (b, n)
        plain_ms, want = _time_once(
            torch, dev, lambda *a: chain.batched_chain_dp_ref(*a, **CHAIN_KW),
            args)
        compare(torch, errs, "phase7", "chain_dp", tag, got, want)
        native = native_chain(*host_in, CHAIN_KW, rows=CHAIN_NATIVE)
        compare(torch, errs, "phase7", "chain_dp", tag + " first %d ranges "
                "vs native chain_dp" % CHAIN_NATIVE,
                {key: v[:CHAIN_NATIVE] for key, v in got.items()},
                {key: torch.from_numpy(v).to(dev)
                 for key, v in native.items()})
        perms = [torch.from_numpy(rng.permutation(b)).to(dev)
                 for _ in range(4)]
        sets = [[t.index_select(0, p) for t in args] for p in perms]
        ms = _time_kernel(torch, dev, lambda *a: chain.batched_chain_dp(
            *a, **CHAIN_KW), sets)
        ops, stages = chain_ops(torch, args, CHAIN_KW["max_gap"])
        c = counts.astype(np.int64)
        if stages[0] != int((c * (c - 1) // 2).sum()):
            raise AssertionError("phase7: %d valid pairs counted, %d drawn"
                                 % (stages[0], (c * (c - 1) // 2).sum()))
        old_steps, active, depth = chain_dag(torch, args, CHAIN_KW)
        log("phase7 chain_dp %s candidate DAG: the first kernel's steps %d "
            "(a step for every node up to each range's last valid one), "
            "nodes with a candidate successor %d (%.2f %% of those steps; "
            "the kernel's steps now), longest path %d edges (mean of the "
            "ranges' longest %.3f)"
            % (tag, old_steps, active, 100 * active / max(1, old_steps),
               int(depth.max()), float(depth.mean())))
        nbytes = _nbytes(*args) + _nbytes(*got.values())
        old_ms, old_by = _bound(nbytes, ops)
        win_ops, win_stages = chain_window_ops(torch, args, CHAIN_KW)
        log("phase7 chain_dp %s: the first kernel's bound %.6f ms (%s: every "
            "valid pair tested, %d int32 ops), %.1f %% of it; restated for "
            "the SQO window (window pairs %d, past the SQO test %d, the "
            "diagonal gap %d, the SRO test %d; %d int32 ops) below" % (
                tag, old_ms, old_by, ops, 100 * old_ms / ms, *win_stages,
                win_ops))
        _record(torch, kernels if k == 0 else None, errs, "phase7",
                "chain_dp", tag + " (window pairs %d, past the SQO test %d, "
                "the diagonal gap %d, the SRO test %d)" % tuple(win_stages),
                ms, plain_ms, got, want, nbytes, win_ops)
        if k:
            bound_ms, bound_by = _bound(nbytes, win_ops)
            kernels["chain_dp"]["long_ranges"] = {
                "b": b, "n": n, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "all_pairs_bound_ms": old_ms}
        else:
            kernels["chain_dp"]["all_pairs_bound_ms"] = old_ms
        del sets, want, got
    del outs, cases


def chain_dag(torch, args, kw):
    """(steps of the first chain kernel, nodes with a candidate successor,
    longest path of each range in edges) of the chain DP's candidate DAG
    on these ranges: pair (i, j) is an edge when i can relax j
    (chain_pair of csrc/chain_kernels.cu: j > i, both valid, SQO, diagonal
    gap, SRO, desert, new bases; int32 arithmetic wraps, as the kernel's
    does); the first kernel took a step for every node up to each range's
    last valid one.  Longest paths by rounds of depth[j] = max(depth[i] +
    1) over the edges into j, until none changes; ranges a few at a
    time."""
    sqo, eqo, diag, length, valid = args
    b, n = sqo.shape
    dev = sqo.device
    upper = torch.ones((n, n), dtype=torch.bool, device=dev).triu(1)
    lw = ((length + 0x8000) & 0xFFFF) - 0x8000
    idx = torch.arange(n, device=dev)
    last = torch.where(valid.bool(), idx, -1).amax(1)
    old_steps = int(last.clamp(min=0).sum())
    step = max(1, (1 << 24) // (n * n))
    active = 0
    depths = []
    for b0 in range(0, b, step):
        s, e, d, l, v = (t[b0:b0 + step] for t in (sqo, eqo, diag, lw,
                                                   valid.bool()))
        m = v[:, :, None] & v[:, None, :] & upper        # [range, i, j]
        m &= s[:, None, :] > s[:, :, None]
        m &= (d[:, None, :] - d[:, :, None]).abs() <= kw["max_gap"]
        sro, ero = d + s, d + e
        m &= sro[:, None, :] > sro[:, :, None]
        q_gap = (s[:, None, :] - e[:, :, None] - 1).clamp(min=0)
        r_gap = (sro[:, None, :] - ero[:, :, None] - 1).clamp(min=0)
        m &= torch.minimum(q_gap, r_gap) <= kw["max_desert"]
        del q_gap, r_gap
        q_ov = (e[:, :, None] - s[:, None, :] + 1).clamp(min=0)
        r_ov = (ero[:, :, None] - sro[:, None, :] + 1).clamp(min=0)
        m &= l[:, None, :] - torch.maximum(q_ov, r_ov) >= 1
        del q_ov, r_ov
        active += int(m.any(2).sum())
        dep = torch.zeros(s.shape, dtype=torch.int32, device=dev)
        while True:
            new = torch.maximum(dep, torch.where(
                m, dep[:, :, None] + 1, 0).amax(1).to(torch.int32))
            if torch.equal(new, dep):
                break
            dep = new
        depths.append(dep.amax(1).cpu())
    return old_steps, active, torch.cat(depths).numpy()


def chain_window_ops(torch, args, kw):
    """(int32 operations, pairs by stage) of the chain DP's pair tests as
    the SQO window leaves them (csrc/chain_kernels.cu): on a range whose
    valid nodes allow the window (their SQO never falls from one valid
    node to the next; sqo, eqo and diag within +-2^28; max_gap and
    max_desert in [0, 2^28)), the pairs i < j of valid nodes with j up to
    and including the first valid j past i's window (sqo_j - eqo_i - 1 >
    max_desert + max_gap), each charged WINDOW_PAIR_OPS plus its stages'
    PAIR_STAGE_OPS; on any other range every valid pair, as chain_ops.
    Ranges a few at a time."""
    sqo, eqo, diag, _, valid = args
    b, n = sqo.shape
    dev = sqo.device
    small = 1 << 28
    params = 0 <= kw["max_gap"] < small and 0 <= kw["max_desert"] < small
    lim = kw["max_desert"] + kw["max_gap"]
    upper = torch.ones((n, n), dtype=torch.bool, device=dev).triu(1)
    step = max(1, (1 << 25) // (n * n))
    stages = [0, 0, 0, 0]
    windowed = 0
    for b0 in range(0, b, step):
        s, e, d, v = (t[b0:b0 + step] for t in (sqo, eqo, diag,
                                                 valid.bool()))
        m = v[:, :, None] & v[:, None, :] & upper        # [range, i, j]
        lo = torch.iinfo(s.dtype).min
        prior = torch.where(v, s, lo).cummax(1).values
        prior = torch.cat([torch.full_like(prior[:, :1], lo),
                           prior[:, :-1]], 1)
        ok = ((~v | ((s.abs() < small) & (e.abs() < small) &
                     (d.abs() < small) & (s >= prior))).all(1) & params)
        past = m & (s.to(torch.int64)[:, None, :] -
                    e.to(torch.int64)[:, :, None] - 1 > lim)
        first = torch.where(past.any(2), past.int().argmax(2),
                            n).to(torch.int64)                 # [range, i]
        idx = torch.arange(n, device=dev)
        m &= ~ok[:, None, None] | (idx[None, None, :] <= first[:, :, None])
        windowed += int((m & ok[:, None, None]).sum())
        stages[0] += int(m.sum())
        m &= s[:, None, :] > s[:, :, None]
        stages[1] += int(m.sum())
        m &= (d[:, None, :] - d[:, :, None]).abs() <= kw["max_gap"]
        stages[2] += int(m.sum())
        sro = d + s
        m &= sro[:, None, :] > sro[:, :, None]
        stages[3] += int(m.sum())
    ops = sum(k * c for k, c in zip(PAIR_STAGE_OPS, stages))
    return ops + WINDOW_PAIR_OPS * windowed, stages


def chain_ops(torch, args, max_gap):
    """(int32 operations, pairs by stage) of the chain DP on these ranges:
    the pairs i < j of valid nodes that reach each stage of chain_relax
    (all of them; past the SQO test; past the diagonal gap; past the SRO
    test), each stage's count times its PAIR_STAGE_OPS.  int32 arithmetic
    wraps, as the kernel's does; ranges a few at a time."""
    sqo, _, diag, _, valid = args
    b, n = sqo.shape
    upper = torch.ones((n, n), dtype=torch.bool, device=sqo.device).triu(1)
    step = max(1, (1 << 25) // (n * n))
    stages = [0, 0, 0, 0]
    for b0 in range(0, b, step):
        s, d, v = (t[b0:b0 + step] for t in (sqo, diag, valid.bool()))
        m = v[:, :, None] & v[:, None, :] & upper        # [range, i, j]
        stages[0] += int(m.sum())
        m &= s[:, None, :] > s[:, :, None]
        stages[1] += int(m.sum())
        m &= (d[:, None, :] - d[:, :, None]).abs() <= max_gap
        stages[2] += int(m.sum())
        sro = d + s
        m &= sro[:, None, :] > sro[:, :, None]
        stages[3] += int(m.sum())
    return sum(k * c for k, c in zip(PAIR_STAGE_OPS, stages)), stages


def phase_torch(torch, sw, host, StagedAligner, Recorder, genome, index, aa,
                reads, threads, dev):
    """--engine batch-torch's engine, StagedAligner(backend="torch"), on
    the first TORCH_READS reads of the 1 kb batch (the same reads and
    buckets as phase 3): one cold run (its time goes by the rows of the
    lockstep, so a warm run takes as long) with SAM bytes equal to the
    native engine's, no DP kernel launched (only the gather), beside the
    default engine's warm wall on the same reads; then the largest
    extension bucket's lockstep twin beside extension_forward's kernel on
    the same inputs (for information; their score, maxi and maxj must
    agree)."""
    from yaha_tpu_torch.ops import sw_batch
    part = reads[:TORCH_READS]
    pr = host.parse_queries_native(b"".join(part), False,
                                   aa.max_query_length, aa.word_len)
    t0 = time.time()
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=threads)[0]
    t_native = time.time() - t0
    cuda_st = StagedAligner(aa, genome, index, device=dev, n_threads=threads)
    _timed(torch, sw, cuda_st, pr, ref, dev, "phase8 batch-cuda first run")
    cuda_wall, _ = _timed(torch, sw, cuda_st, pr, ref, dev,
                          "phase8 batch-cuda warm run")
    t0 = time.time()
    st = Recorder(aa, genome, index, device=dev, n_threads=threads,
                  backend="torch")
    _, launches = _timed(torch, sw, st, pr, ref, dev,
                         "phase8 batch-torch cold run")
    cold = time.time() - t0
    _report("phase8 %d x 1kb batch-torch" % pr.n, pr.n, {
        "native_wall_s": t_native, "batch_cuda_warm_wall_s": cuda_wall,
        "cold_wall_s": cold}, st.stats, launches)
    if [k for k, v in launches.items() if v] != ["gather_problems"]:
        raise AssertionError("phase8: batch-torch launched %s" % launches)
    key, (q, qlens, r, rlens) = _largest(st, "extension_forward", 1024)
    args = [q, torch.from_numpy(qlens.astype(np.int32)).to(dev), r,
            torch.from_numpy(rlens.astype(np.int32)).to(dev)]
    kw = st.ext_kw
    twin_ms, twin = _time_once(
        torch, dev, lambda *a: sw_batch.batched_extension_forward(*a, **kw),
        args)
    kern_ms = _time_kernel(torch, dev,
                           lambda *a: sw.extension_forward(*a, **kw), [args])
    kern = sw.extension_forward(*args, **kw)
    sync(torch, dev)
    for name in ("score", "maxi", "maxj"):
        if not torch.equal(twin[name], kern[name]):
            raise AssertionError("phase8: the twin and extension_forward "
                                 "differ in %s" % name)
    log("phase8 extension bucket=%s N=%d: batch-torch twin %.3f ms, "
        "extension_forward kernel %.6f ms (score, maxi, maxj equal)" % (
            list(key[1:]), q.shape[0], twin_ms, kern_ms))


def phase_engines_cli(tg_nib, tg_idx):
    """The port's CLI on the golden sets in this process: --engine
    batch-torch --device cuda (readsA, host seed scan and --seed device),
    --engine native (readsA, readsC params), and one --engine batch-cuda
    run under --trace (readsC params), whose trace must name a kernel of
    the port among its CUDA kernels; SAM bytes equal to the goldens each
    time."""
    from yaha_tpu_torch import cli
    gold = os.path.join(REPO, "tests", "golden")
    data = os.path.join(REPO, "tests", "data")
    c_flags = ["-BW", "3", "-G", "20", "-M", "15", "-X", "15"]

    def body(p):
        with open(p, "rb") as f:
            return [ln for ln in f.read().split(b"\n")
                    if not ln.startswith(b"@PG")]
    with tempfile.TemporaryDirectory(dir=CACHE) as d:
        for f in (tg_nib, tg_idx):
            os.symlink(f, os.path.join(d, os.path.basename(f)))
        trace = os.path.join(d, "trace")
        for golden, reads, flags in (
                ("A_default.sam", "readsA_100bp.fasta",
                 ["--engine", "batch-torch", "--device", "cuda"]),
                ("A_default.sam", "readsA_100bp.fasta",
                 ["--engine", "batch-torch", "--device", "cuda", "--seed",
                  "device"]),
                ("A_default.sam", "readsA_100bp.fasta",
                 ["--engine", "native"]),
                ("C_params.sam", "readsC_1kb.fasta",
                 ["--engine", "native"] + c_flags),
                ("C_params.sam", "readsC_1kb.fasta",
                 ["--engine", "batch-cuda", "--device", "cuda", "--trace",
                  trace] + c_flags)):
            out = os.path.join(d, "out.sam")
            rc = cli.main(["-x", os.path.join(d, os.path.basename(tg_idx)),
                           "-q", os.path.join(data, reads)] + flags +
                          ["-osh", out])
            if rc != 0 or body(out) != body(os.path.join(gold, golden)):
                raise AssertionError("phase8 cli %s: SAM differs from "
                                     "tests/golden/%s" % (" ".join(flags),
                                                          golden))
            log("phase8 cli: %s == %s" % (" ".join(
                f if f != trace else "DIR" for f in flags), golden))
        files = [os.path.join(trace, f) for f in os.listdir(trace)]
        if len(files) != 1 or not os.path.getsize(files[0]):
            raise AssertionError("phase8 --trace: files %s" % files)
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        names = sorted({e.get("name", "") for e in events
                        if e.get("cat") == "kernel"})
        ours = [k for k in names if re.search(
            r"ext_reg_kernel|anch_reg_kernel|gather_kernel|rle_win_kernel",
            k)]
        if not ours:
            raise AssertionError("phase8 --trace: no kernel of the port "
                                 "among the trace's CUDA kernels %s"
                                 % names[:20])
        log("phase8 --trace: %d bytes, %d events, %d CUDA kernel names, "
            "of the port's: %s" % (os.path.getsize(files[0]), len(events),
                                   len(names), ", ".join(
                                       k[:40] for k in ours)))


def phase_long_gaps(torch, sw, host, StagedAligner, tg_nib, tg_idx,
                    threads, dev):
    """The four long-gap reads of tests/torch_dp_cases.long_gap_reads (7-8
    kb flanks around a 3.0-3.5 kb deletion and 30-45 inserted bases) at -G
    3,600 through the default configuration: their unbanded gap buckets of
    RL 4,096 are too wide for the anchored wide route and go, by shape, to
    the lockstep twin on the card (gap_twin > 0); SAM bytes equal to the
    native engine's."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_dp_cases import long_gap_reads
    index = host.load_index(tg_idx)
    genome = host.load_genome(tg_nib)
    aa = _aa(host, index, tg_idx, max_gap=LONG_GAP_MAX_GAP)
    pr = host.parse_queries_native(
        long_gap_reads(os.path.join(REPO, "tests", "data", "testgen.fasta")),
        False, aa.max_query_length, aa.word_len)
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=threads)[0]
    st = StagedAligner(aa, genome, index, device=dev, n_threads=threads)
    wall, launches = _timed(torch, sw, st, pr, ref, dev,
                            "phase9 long gaps -G %d" % LONG_GAP_MAX_GAP)
    s = st.stats
    log("phase9 long gaps -G %d: reads=%d parity=true wall_s=%.3f "
        "gap_problems=%d gap_twin=%d banded=%d full=%d fallback=%d "
        "launches=%s" % (LONG_GAP_MAX_GAP, pr.n, wall, s["gap_problems"],
                         s["gap_twin"], s["gap_banded"], s["gap_full"],
                         s["gap_fallback"], json.dumps(
                             {k: v for k, v in launches.items() if v})))
    if not s["gap_twin"]:
        raise AssertionError("phase9 long gaps: no bucket took the twin")


def _ext_sets(torch, dev, n, ql, bw, early):
    """Four numpy-seeded draws of n extension problems of QL rows at band
    width bw: at 5 % substitutions, or (early) with every other problem
    turning random past a row between 200 and QL (its X-drop exits a few
    rows later) and the rest alike to the last row."""
    from torch_dp_cases import extension_inputs, xdrop_extension_inputs
    out = []
    for k in range(4):
        if early:
            arrs = xdrop_extension_inputs(
                bw + 1 + k, n, ql, bw,
                [200 + (j * 37 + k) % (ql - 200) if j % 2 == 0 else ql
                 for j in range(n)])
        else:
            arrs = extension_inputs(bw + k, n, ql, bw, 0.05)
        out.append([torch.from_numpy(a).to(dev) for a in arrs])
    return out


def phase_wide_band(torch, sw, host, StagedAligner, tg_nib, tg_idx,
                    threads, kernels, errs, dev):
    """Bands past -BW 707 (W 2,829), where the staged wide extension
    kernel's warp no longer fits a block's shared memory: the block kernel
    (a block of warps a problem) equal to the plain version on 16
    numpy-seeded problems of QL 40 (two strips, two warps) that run to
    their last row at -BW 708 (W 2,833); the block and the staged kernel
    in turns (staged, block,
    block, staged; CUDA events over 8 launches behind a spin) on 256
    problems of QL 1,024 at W 1,025 and 2,829, equal to each other, at 5 %
    substitutions and on a bucket whose every other problem turns random
    past row 200; the block kernel alone at -BW 708 on both, beside the
    plane's bound; then readsA's first ten reads through the default
    configuration at -BW 708, every extension on the block kernel (counts
    set to 0 just before the run and read after it), SAM bytes equal to
    the native engine's.  Returns that run's launches."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_dp_cases import KW, xdrop_extension_inputs
    kw = dict(KW, band_width=708, x_cutoff=25)
    # The plain version takes a PyTorch op a cell column: on the host.
    arrs = [torch.from_numpy(a) for a in
            xdrop_extension_inputs(708, 16, 40, 708, (40,))]
    got = sw.extension_forward(*(a.to(dev) for a in arrs), **kw)
    sync(torch, dev)
    t0 = time.perf_counter()
    want = sw.extension_forward_reference(*arrs, **kw)
    plain_ms = (time.perf_counter() - t0) * 1e3
    compare(torch, errs, "phase9", "extension_forward_block",
            "BW708 16 x 40 rows", {k: v.cpu() for k, v in got.items()},
            want)
    del got, want

    def run(variant, bw):
        return lambda *a: sw.extension_forward(
            *a, **dict(kw, band_width=bw), variant=variant)

    n, ql = 256, 1024
    block_ms = {}
    for bw in (256, 707, 708):
        w = 4 * bw + 1
        for label in ("5 %", "early exits"):
            sets = _ext_sets(torch, dev, n, ql, bw, label != "5 %")
            order = (("wide", "block", "block", "wide") if bw <= 707
                     else ("block",))
            ms = {}
            for v in order:
                ms.setdefault(v, []).append(
                    _time_kernel(torch, dev, run(v, bw), sets))
            outs = {v: run(v, bw)(*sets[0]) for v in set(order)}
            if bw <= 707:
                compare(torch, errs, "phase9", "extension_forward_block",
                        "W %d %s (= the staged kernel)" % (w, label),
                        outs["block"], outs["wide"])
            bound_ms, bound_by = _bound(n * (ql + 1) * w +
                                        _nbytes(*sets[0]), 0)
            means = {v: _mean(t) for v, t in ms.items()}
            if label == "5 %":
                block_ms[bw] = (means["block"], bound_ms, bound_by)
            log("phase9 extension W %d (-BW %d) %d x %d %s: block %s ms%s, "
                "bound %.6f ms (%s: the plane), block %.2f %% of it" % (
                    w, bw, n, ql, label, " / ".join(
                        "%.6f" % t for t in ms["block"]),
                    "" if bw > 707 else ", staged %s ms, block / staged "
                    "%.3f" % (" / ".join("%.6f" % t for t in ms["wide"]),
                              means["block"] / means["wide"]),
                    bound_ms, bound_by, 100 * bound_ms / means["block"]))
            del sets, outs
    ms, bound_ms, bound_by = block_ms[708]
    kernels["extension_forward_block"].update(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, max_abs_err=errs["extension_forward_block"])
    index = host.load_index(tg_idx)
    genome = host.load_genome(tg_nib)
    aa = _aa(host, index, tg_idx, band_width=708)
    with open(os.path.join(REPO, "tests", "data", "readsA_100bp.fasta"),
              "rb") as f:
        data = b">" + b">".join(f.read().split(b">")[1:11])
    pr = host.parse_queries_native(data, False, aa.max_query_length,
                                   aa.word_len)
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=threads)[0]
    st = StagedAligner(aa, genome, index, device=dev, n_threads=threads)
    wall, launches = _timed(torch, sw, st, pr, ref, dev, "phase9 -BW 708")
    log("phase9 -BW 708: reads=%d parity=true wall_s=%.3f ext_problems=%d "
        "launches=%s" % (pr.n, wall, st.stats["ext_problems"], json.dumps(
            {k: v for k, v in launches.items() if v})))
    if (not launches["extension_forward_block"] or
            launches["extension_forward_wide"]):
        raise AssertionError("phase9 -BW 708: extension launches %s" % (
            {k: v for k, v in launches.items() if "extension" in k}))
    return launches


def _same_rows(what, got, want):
    """Raise unless two seeders' rows (diag, qo, offs, totals) are equal
    wherever both serve a row on the card (totals >= 0), and the sharded
    one (`got`) serves every row the single one does.  Returns the count
    of rows both serve."""
    both = (got[3] >= 0) & (want[3] >= 0)
    if both.sum() != (want[3] >= 0).sum() or not np.array_equal(
            got[3][both], want[3][both]):
        raise AssertionError("%s: row totals differ" % what)
    for k in (0, 1):
        sel = [np.repeat(both, np.diff(x[2])) for x in (got, want)]
        if not np.array_equal(got[k][sel[0]], want[k][sel[1]]):
            raise AssertionError("%s: hit rows differ from the single "
                                 "seeder's" % what)
    return int(both.sum())


def phase_sharded_seed(torch, sw, StagedAligner, SeedRecorder, DeviceSeeder,
                       genome, index, aa, pr, ref, threads, dev):
    """The seeder over the hash-range sharded L15 index on (data x model)
    grids of the card (SCALE_GRIDS), on the 1 kb batch: beside a fresh
    single-device seeder, each grid's seeder built (the index rebased and
    placed: its bytes and seconds), a cold run, then a warm run with the
    counts set to 0 just before it and read just after, SAM bytes equal to
    the native engine's; its hit rows equal to the single seeder's
    wherever both serve a row; seed_device_s, the per-shard SO and ROA
    bytes and all_gather_bytes beside the single seeder's.  Returns the
    (1 x 2) grid's recorder seeder and its warm run's launches."""
    from yaha_tpu_torch.parallel import mesh as pmesh
    one = DeviceSeeder(aa, index, device=dev)
    st = StagedAligner(aa, genome, index, device=dev, n_threads=threads,
                       seeder=one)
    _timed(torch, sw, st, pr, ref, dev, "phase9 single seeder first run")
    _reset_stats(st, one)
    wall, _ = _timed(torch, sw, st, pr, ref, dev, "phase9 single seeder")
    s = one.stats
    log("phase9 1kb grid=1x1 (single seeder): warm_wall_s=%.4f "
        "seed_device_s=%.4f seed_launches=%d all_gather_bytes=%d "
        "index_bytes=%d (SO %d + ROA %d)" % (
            wall, s["seed_device_s"], s["seed_launches"],
            s["all_gather_bytes"], s["index_upload_bytes"],
            one.iview.starting_offs.nbytes, one.iview.roa.nbytes))
    want = one.seed_chunk(pr, 0, pr.n, st._chunk_rows(pr, 0, pr.n))
    del st, one
    kept = None
    for n_data, n_model in SCALE_GRIDS:
        tag = "phase9 1kb grid=%dx%d" % (n_data, n_model)
        grid = pmesh.make_mesh([dev] * n_data * n_model, n_model)
        t0 = time.time()
        seeder = SeedRecorder(aa, index, mesh=grid)
        placed = time.time() - t0
        st = StagedAligner(aa, genome, index, device=dev, n_threads=threads,
                           seeder=seeder)
        _timed(torch, sw, st, pr, ref, dev, tag + " cold run")
        _reset_stats(st, seeder)
        wall, launches = _timed(torch, sw, st, pr, ref, dev,
                                tag + " warm run")
        s = seeder.stats
        sidx = seeder.sidx
        log("%s: warm_wall_s=%.4f seed_device_s=%.4f seed_launches=%d "
            "cap_retries=%d fallback_rows=%d all_gather_bytes=%d "
            "index_bytes=%d placed_s=%.2f shards=%s launches=%s" % (
                tag, wall, s["seed_device_s"], s["seed_launches"],
                s["cap_retries"], s["fallback_rows"], s["all_gather_bytes"],
                s["index_upload_bytes"], placed, json.dumps([
                    {"so_bytes": sidx.shard_nbytes(m)[0],
                     "roa_bytes": sidx.shard_nbytes(m)[1]}
                    for m in range(n_model)]), json.dumps(
                        {k: v for k, v in launches.items() if v})))
        if not (launches["expand_sort_hits"] and
                launches["merge_sorted_runs"]):
            raise AssertionError("%s: launches %s" % (tag, launches))
        got = seeder.seed_chunk(pr, 0, pr.n, st._chunk_rows(pr, 0, pr.n))
        n_rows = _same_rows(tag, got, want)
        log("%s: hit rows equal to the single seeder's on %d rows (it "
            "serves %d, the grid %d)" % (tag, n_rows, (want[3] >= 0).sum(),
                                         (got[3] >= 0).sum()))
        if (n_data, n_model) == SCALE_GRIDS[0]:
            kept = (seeder, launches)
        del st, got
    return kept


def _packed_key(torch, diag, qo):
    """[b, M C] int64 keys of the gathered shard rows whose order is (diag
    uint32, qo): (diag - 2^31) << 32 | qo, so that no shift leaves the
    int64 range."""
    m, b, c = diag.shape
    return (((diag.to(torch.int64) & 0xFFFFFFFF) - (1 << 31)) << 32 |
            qo.to(torch.int64)).permute(1, 0, 2).reshape(b, m * c)


def _merge_work(runs):
    """(bytes, int32 operations) the merge of runs [M, b, C] must take:
    every key in once and out once; a compare of two 64-bit keys an
    output a pass, ceil(log2 M) passes (one at M <= 2)."""
    m, b, c = runs[0].shape
    passes = max(1, int(np.ceil(np.log2(m))))
    return 2 * _nbytes(*runs), SORT_CMP_OPS * m * b * c * passes


def _merge_turn(torch, seeds, errs, tag, msets):
    """The merge kernel on the input sets msets (timed over them), equal
    to its plain version and to torch.sort of the packed keys on the
    second; returns its entry for the kernels line."""
    dev = msets[0][0].device
    ms = _time_kernel(torch, dev, seeds.merge_sorted_runs, msets)
    plain_ms, want = _time_once(torch, dev, seeds.merge_sorted_runs_reference,
                                msets[1])
    got = seeds.merge_sorted_runs(*msets[1])
    keys = [[_packed_key(torch, *m)] for m in msets]
    lib_ms = _time_kernel(torch, dev, lambda k: torch.sort(k, dim=1), keys)
    lib = torch.sort(keys[1][0], dim=1).values
    sync(torch, dev)
    if not (torch.equal((lib >> 32) + (1 << 31), got[0].to(
            torch.int64) & 0xFFFFFFFF) and torch.equal(
                lib & 0xFFFFFFFF, got[1].to(torch.int64))):
        raise AssertionError("phase9 merge_sorted_runs %s: torch.sort of "
                             "the keys differs from the kernel" % tag)
    compare(torch, errs, "phase9", "merge_sorted_runs", tag,
            {"diag": got[0], "qo": got[1]}, {"diag": want[0], "qo": want[1]})
    nbytes, ops = _merge_work(msets[1])
    bound_ms, bound_by = _bound(nbytes, ops)
    m, rows, cap = msets[1][0].shape
    log("phase9 merge_sorted_runs %s: kernel %.6f ms, plain %.3f ms, "
        "torch.sort %.6f ms, bound %.6f ms (%s: %d bytes, %d int32 ops), "
        "%.1f %% of the bound" % (tag, ms, plain_ms, lib_ms, bound_ms,
                                  bound_by, nbytes, ops,
                                  100 * bound_ms / ms))
    return {"shards": m, "rows": rows, "capacity": cap, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_shard_kernels(torch, seeds, seeder, kernels, errs, dev):
    """The range-masked expansion and the merge kernel at the sharded
    seeder's largest launch of each tier (the 1 kb batch's [32,768 rows,
    2 x 1,024], and the tier-2 rows at 2 x 8,192): each shard's expansion
    and the merge of the shards' rows equal to their plain versions; both
    timed (CUDA events, 4 shuffled copies, queued behind a spin) beside
    their bounds and plain versions, the merge beside torch.sort of the
    packed int64 keys."""
    rng = np.random.default_rng(SEED)
    sidx = seeder.sidx
    n_model = sidx.n_model
    mh = int(seeder.aa.max_hits)
    tables = [sidx.tables[(seeder.mesh.grid[0][m], m)]
              for m in range(n_model)]
    for cap in seeder.CAP_TIERS:
        if cap not in seeder.kept:
            log("phase9 expand_sort_hits: no launch at C=%d in the sharded "
                "run" % cap)
            continue
        hashes, clean = seeder.kept[cap]
        rows, windows = hashes.shape
        perms = [torch.from_numpy(rng.permutation(rows)).to(dev)
                 for _ in range(4)]
        sets = [[hashes.index_select(0, p), clean.index_select(0, p)]
                for p in perms]
        tier = "tier %d" % (seeder.CAP_TIERS.index(cap) + 1)
        outs = []
        for m, (so, roa) in enumerate(tables):
            kw = dict(max_hits=mh, capacity=cap,
                      hash_lo=int(sidx.hash_lo[m]), per=sidx.per)
            tag = "%s shard %d of %d C=%d rows=%d N=%d" % (
                tier, m, n_model, cap, rows, windows)
            ms = _time_kernel(torch, dev, lambda *a: seeds.expand_sort_hits(
                *a, so, roa, **kw), sets)
            plain_ms, want = _time_once(
                torch, dev, lambda *a: seeds.expand_sort_hits_reference(
                    *a, so, roa, **kw), sets[1])
            got = seeds.expand_sort_hits(*sets[1], so, roa, **kw)
            sync(torch, dev)
            compare(torch, errs, "phase9", "expand_sort_hits", tag, got,
                    want)
            local = sets[1][0].to(torch.int64) - kw["hash_lo"]
            in_rng = sets[1][1] & (local >= 0) & (local < sidx.per)
            valid = want["total"].to(torch.int64).clamp(0, cap)
            steps = torch.where(valid > 1, valid * torch.ceil(torch.log2(
                valid.clamp(min=2).double())).to(torch.int64), 0)
            nbytes = (_nbytes(*sets[1]) + 8 * int(in_rng.sum()) +
                      4 * int(valid.sum()) + _nbytes(*got.values()))
            ops = SORT_CMP_OPS * int(steps.sum()) + WINDOW_OPS * rows * \
                windows
            bound_ms, bound_by = _bound(nbytes, ops)
            kernels["expand_sort_hits"].setdefault("shards", []).append(
                {"tier": seeder.CAP_TIERS.index(cap) + 1, "shard": m,
                 "rows": rows, "capacity": cap, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by})
            log("phase9 expand_sort_hits %s: kernel %.6f ms, plain %.3f ms, "
                "bound %.6f ms (%s: %d bytes, %d int32 ops), %.1f %% of the "
                "bound" % (tag, ms, plain_ms, bound_ms, bound_by, nbytes,
                           ops, 100 * bound_ms / ms))
            outs.append(got)
            del want
        diag = torch.stack([o["diag"] for o in outs])
        qo = torch.stack([o["qo"] for o in outs])
        # The copy into one [M, b, C] tensor that sharded_expand_sort no
        # longer makes (the shards expand into the merge's input).
        runs = [o[k] for k in ("diag", "qo") for o in outs]
        stack_ms = _time_kernel(torch, dev, lambda *t: (
            torch.stack(t[:n_model]), torch.stack(t[n_model:])), [runs])
        log("phase9 %s C=%d rows=%d: the stack copy of the shards' rows "
            "that the merge's input no longer needs %.6f ms (%d bytes "
            "read, as many written)" % (tier, cap, rows, stack_ms,
                                        _nbytes(*runs)))
        del outs, runs
        msets = [[diag.index_select(1, p), qo.index_select(1, p)]
                 for p in perms]
        entry = _merge_turn(torch, seeds, errs, "%s M=%d C=%d rows=%d" % (
            tier, n_model, cap, rows), msets)
        if cap == seeder.CAP_TIERS[0]:
            kernels["merge_sorted_runs"].update(
                {k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
                max_abs_err=errs["merge_sorted_runs"])
            # Four runs: the two shards' rows in two row orders (two
            # passes of the kernel).
            m4 = [[torch.cat([msets[k][i], msets[(k + 1) % 4][i]])
                   for i in (0, 1)] for k in range(4)]
            kernels["merge_sorted_runs"]["m4"] = _merge_turn(
                torch, seeds, errs, "%s M=4 C=%d rows=%d" % (tier, cap, rows),
                m4)
            del m4
        else:
            kernels["merge_sorted_runs"]["tier2"] = entry
        del msets, sets, diag, qo


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_multihost(reads, idx, tg_idx):
    """Two CLI processes on the card (--num-hosts 2, each its --host-id,
    a gloo group at a free local port, both on cuda:0): the 1 kb batch with
    the host seed scan, and the golden readsA with --seed device
    --model-shards 2 (hosts, data and model at once); each merged SAM equal,
    apart from @PG, to one process's run of the same flags.  Every process
    has CLI_TIMEOUT seconds; one that fails or times out fails the phase
    and the other is stopped."""
    env = dict(os.environ, PYTHONPATH=REPO)

    def body(p):
        with open(p, "rb") as f:
            return [ln for ln in f.read().split(b"\n")
                    if not ln.startswith(b"@PG")]
    with tempfile.TemporaryDirectory(dir=CACHE) as d:
        batch = os.path.join(d, "batch_1kb.fasta")
        with open(batch, "wb") as f:
            f.write(b"".join(reads))
        for tag, q, x, flags in (
                ("1kb host seed", batch, idx, []),
                ("readsA seed device model-shards 2",
                 os.path.join(REPO, "tests", "data", "readsA_100bp.fasta"),
                 tg_idx, ["--seed", "device", "--model-shards", "2"])):
            base = [sys.executable, "-m", "yaha_tpu_torch.cli", "-x", x,
                    "-q", q, "--engine", "batch-cuda", "--device",
                    "cuda"] + flags
            t0 = time.time()
            run(base + ["-osh", os.path.join(d, "one.sam")], env=env,
                timeout=CLI_TIMEOUT)
            one_s = time.time() - t0
            port = _free_port()
            t0 = time.time()
            procs = [subprocess.Popen(
                base + ["--coordinator", "127.0.0.1:%d" % port,
                        "--num-hosts", "2", "--host-id", str(k), "-osh",
                        os.path.join(d, "two.sam")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for k in range(2)]
            try:
                for k, p in enumerate(procs):
                    out = p.communicate(timeout=CLI_TIMEOUT)[0].decode()
                    if p.returncode != 0:
                        raise RuntimeError("phase9 %s: host %d exited %d:\n%s"
                                           % (tag, k, p.returncode,
                                              out[-3000:]))
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            two_s = time.time() - t0
            if body(os.path.join(d, "two.sam")) != body(
                    os.path.join(d, "one.sam")):
                raise AssertionError("phase9 %s: the two hosts' merged SAM "
                                     "differs from one process's" % tag)
            parts = [os.path.getsize(os.path.join(d, "two.sam.part%05d" % k))
                     for k in range(2)]
            log("phase9 cli 2 hosts %s: merged SAM == one process's "
                "(%d records); one process %.1f s, two hosts %.1f s, part "
                "bytes %s" % (tag, len(body(os.path.join(d, "one.sam"))),
                              one_s, two_s, parts))


def phase_tools(torch, sw, StagedAligner, genome, index, aa, pr, idx,
                walk_buckets, threads, dev):
    """Phase 10, the port's entry points and tools (yaha_tpu_torch/entry.py
    and yaha_tpu_torch/tools/) on the card, each with its counts set to 0
    just before it and read just after: entry() equal to entry("cpu");
    dryrun_multichip(4) at DRYRUN_MBP with its L15 arm off, then the L15
    arm alone where ~/hgdata holds an hg-scale index; device_replay
    on phase 3's 1 kb batch (replayed walk items equal to the captured
    ones); decode_profile on the main path's largest extension and full
    gap buckets (every team equal); seedscan_scaling on the cached L15
    index in a process of its own (phase 1's stage sums by thread count);
    fuzz_parity over FUZZ_SEEDS seeds, no
    difference and no crash (a seed whose native reference takes over
    FUZZ_REF_TIMEOUT s is skipped, at most a quarter of them).  Returns
    {tool: report}."""
    from yaha_tpu_torch import entry as ent
    from yaha_tpu_torch.tools import decode_profile, device_replay
    from yaha_tpu_torch.tools import fuzz_parity
    reports = {}
    sw.reset_launches()
    step, ex = ent.entry()
    got = [t.cpu() for t in step(*ex)]
    sync(torch, dev)
    launches = sw.launches()
    want = ent.entry("cpu")[0](*ex)
    if not all(torch.equal(a, b) for a, b in zip(got, want)) or \
            launches["extension_forward"] != 1:
        raise AssertionError("phase10 entry: the card's score/maxi/maxj "
                             "differ from the CPU's, or launches %s"
                             % launches)
    log("phase10 entry: score/maxi/maxj == entry(\"cpu\") on %d problems; "
        "launches %s" % (len(ex[0]), json.dumps(
            {k: v for k, v in launches.items() if v})))
    old = {k: os.environ.get(k) for k in ("YT_DRYRUN_MBP", "YT_DRYRUN_L15")}
    os.environ.update(YT_DRYRUN_MBP=str(DRYRUN_MBP), YT_DRYRUN_L15="0")
    try:
        sw.reset_launches()
        t0 = time.time()
        rep = ent.dryrun_multichip(4)
        launches = sw.launches()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for name in ("expand_sort_hits", "merge_sorted_runs", "seed_hashes"):
        if not launches[name]:
            raise AssertionError("phase10 dryrun: %s never launched" % name)
    rep["launches"] = {k: v for k, v in launches.items() if v}
    rep["seconds"] = time.time() - t0
    reports["dryrun_multichip"] = rep
    log("phase10 dryrun_multichip(4) at %d Mbp: byte identical, %d "
        "fallback rows, %d phantom rows, %d capacity retries; launches %s; "
        "%.1f s" % (DRYRUN_MBP, rep["host_seed_fallbacks"],
                    rep["phantom_rows"], rep["capacity_retries"],
                    json.dumps(rep["launches"]), rep["seconds"]))
    if os.path.isdir(HG_DIR):
        l15 = ent._dryrun_l15(4)
        reports["dryrun_l15"] = l15
        if not l15.get("ok"):
            raise AssertionError("phase10 dryrun L15: %s" % l15)
        log("phase10 dryrun L15: " + json.dumps(l15))
    else:
        log("phase10 dryrun L15: %s not present, arm not run" % HG_DIR)
    st = StagedAligner(aa, genome, index, device=dev, n_threads=threads)
    rep = device_replay.measure_chunk_device(st, pr, 0, pr.n)
    del st
    reports["device_replay"] = rep
    log("phase10 device_replay 1kb: mode %s, replay device s "
        "min/med/max %s, device_s %.4f, profiler kernel s %.4f (the "
        "replayed kernels %.4f), %d kernel launches, walks equal" % (
            rep["mode"], ["%.6f" % x for x in
                          rep["replay_device_s_min_med_max"]],
            rep["device_s"], rep["profiler_kernel_s"],
            rep["profiler_replayed_kernels_s"], rep["kernel_launches"]))
    (q, qlens, r, rlens), (gq, gql, gr, grl, glb, grb) = walk_buckets
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    planes = {"band": decode_profile.band_planes(
        q, i32(qlens), r, i32(rlens), **decode_profile.EXT_KW),
        "full": decode_profile.full_planes(
        gq, i32(gql), gr, i32(grl), i32(glb), i32(grb),
        **decode_profile.GAP_KW)}
    rep = decode_profile.profile(planes)
    del planes
    reports["decode_profile"] = rep
    for layout, row in rep.items():
        log("phase10 decode_profile %s %s: bound %.6f ms (%s, %d walk "
            "bytes of %d plane bytes); med ms %s; teams equal" % (
                layout, row["shape"], row["bound_ms"], row["bound_by"],
                row["walk_bytes"], row["plane_bytes"], json.dumps(
                    {k[:-3]: round(v["med"], 6) for k, v in row.items()
                     if k.endswith("_ms") and isinstance(v, dict)})))
    out = run([sys.executable, "-m", "yaha_tpu_torch.tools.seedscan_scaling",
               "-x", idx, "--reads", str(SEEDSCAN_READS), "--device",
               "cuda"], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
              timeout=600)
    rep = json.loads(out.strip().splitlines()[-1])
    reports["seedscan_scaling"] = rep
    for row in rep["rows"]:
        log("phase10 seedscan_scaling: %s" % json.dumps(row))
    log("phase10 seedscan_scaling device seeder: %s; %s" % (
        json.dumps(rep["device_seeder"]), json.dumps(rep["assets"])))
    sw.reset_launches()
    results, fails = fuzz_parity.run(FUZZ_SEEDS, FUZZ_SEED0, "cuda",
                                     log=log, ref_timeout=FUZZ_REF_TIMEOUT)
    launches = sw.launches()
    reached = {}
    for res in results:
        for arm, v in res["arms"].items():
            reached[arm] = reached.get(arm, 0) + (v == "ok")
    skipped = [r["seed"] for r in results if "skipped" in r]
    reports["fuzz_parity"] = {"seeds": FUZZ_SEEDS, "failures": fails,
                              "skipped": skipped, "ok_by_arm": reached,
                              "launches": launches}
    if fails:
        raise AssertionError("phase10 fuzz_parity: seeds %s failed" % fails)
    if not reached.get("oracle"):
        raise AssertionError("phase10 fuzz_parity: the oracle arm ran on no "
                             "seed")
    if len(skipped) > FUZZ_SEEDS // 4:
        raise AssertionError("phase10 fuzz_parity: %d of %d seeds skipped "
                             "(reference timeouts)" % (len(skipped),
                                                      FUZZ_SEEDS))
    log("phase10 fuzz_parity: %d seeds from %d, no difference, no crash; "
        "skipped (the native reference past %d s) %s; ok runs by arm %s; "
        "kernel launches %s" % (
            FUZZ_SEEDS, FUZZ_SEED0, FUZZ_REF_TIMEOUT, skipped,
            json.dumps(reached),
            json.dumps({k: v for k, v in launches.items() if v})))
    return reports


def phase_oracle_builder(torch, reads, nib, idx, threads, dev):
    """Phase 11, the oracle engine (--engine oracle, core/) and the index
    builder (index/build.py).  The CLI with --engine oracle, one process a
    case, on the 21 golden runs of tests/test_sam_parity.py (copied in
    tests/torch_dp_cases.GOLDEN_CASES), each output byte-equal to its
    golden, @PG line included (the same relative file names); the oracle
    and the native engine on the first ORACLE_READS reads of phase 3's
    batch against the L15 index `idx`, SAM equal apart from @PG; the
    builder on the card writing the four golden indexes byte for byte;
    and at 64 Mbp L15 (the genome `nib` of phase 3), the builder on the
    card against the native builder, SO and ROA equal array for array,
    with each one's seconds, the builder's device seconds (CUDA events
    over its two passes) and the card's peak allocation.  Returns the
    report."""
    import concurrent.futures as cf
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_dp_cases import GOLDEN_CASES
    from yaha_tpu_torch.index import build
    from yaha_tpu_torch.io import nib2
    from yaha_tpu_torch.native import host as native_host
    gold = os.path.join(REPO, "tests", "golden")
    data = os.path.join(REPO, "tests", "data")
    env = dict(os.environ, PYTHONPATH=REPO)
    report = {}

    def body(p):
        with open(p, "rb") as f:
            return [ln for ln in f.read().split(b"\n")
                    if not ln.startswith(b"@PG")]

    def read(p):
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rb") as f:
            return f.read()

    def run_cli(d, args):
        t0 = time.time()
        run([sys.executable, "-m", "yaha_tpu_torch.cli"] + args, cwd=d,
            env=env, timeout=CLI_TIMEOUT)
        return time.time() - t0

    with tempfile.TemporaryDirectory(dir=CACHE) as d:
        for f in os.listdir(data):
            os.symlink(os.path.join(data, f), os.path.join(d, f))
        os.symlink(os.path.join(gold, "testgen.nib2"),
                   os.path.join(d, "testgen.nib2"))
        for name in ("testgen.X11_01_65525S", "testgen.X11_01_00020S"):
            with open(os.path.join(d, name), "wb") as f:
                f.write(read(os.path.join(gold, name + ".gz")))
        t0 = time.time()
        with cf.ThreadPoolExecutor(os.cpu_count() or 1) as ex:
            secs = list(ex.map(lambda c: run_cli(d, [
                "-x", c[2], "-q", c[1], "--engine", "oracle"] + c[3] +
                [c[0]]), GOLDEN_CASES))
        for case in GOLDEN_CASES:
            if read(os.path.join(d, case[0])) != read(
                    os.path.join(gold, case[0])):
                raise AssertionError("phase11 oracle: %s differs from "
                                     "tests/golden/%s" % (
                                         " ".join(case[3]), case[0]))
        report["golden_s"] = time.time() - t0
        log("phase11 oracle: %d golden runs byte-equal (@PG included), "
            "%.1f s on %d processes (each %.2f-%.2f s)" % (
                len(GOLDEN_CASES), report["golden_s"], os.cpu_count() or 1,
                min(secs), max(secs)))
        fa = os.path.join(d, "batch%d.fasta" % ORACLE_READS)
        with open(fa, "wb") as f:
            f.write(b"".join(reads[:ORACLE_READS]))
        for engine in ("oracle", "native"):
            report[engine + "_s"] = run_cli(d, [
                "-x", idx, "-q", fa, "--engine", engine, "-osh",
                engine + ".sam"])
        got, want = (body(os.path.join(d, e + ".sam"))
                     for e in ("oracle", "native"))
        if got != want or len(want) <= ORACLE_READS:
            raise AssertionError("phase11 oracle: the %d reads' SAM differs "
                                 "from the native engine's (%d, %d lines)"
                                 % (ORACLE_READS, len(got), len(want)))
        log("phase11 oracle on %d reads of the 1 kb batch (L15): SAM == "
            "native engine's (%d lines); oracle %.1f s (%.1f ms a read), "
            "native %.1f s" % (
                ORACLE_READS, len(want), report["oracle_s"],
                1e3 * report["oracle_s"] / ORACLE_READS,
                report["native_s"]))
    tg = nib2.load(read(os.path.join(gold, "testgen.nib2")))
    for name, wl, sd, mh in GOLDEN_INDEXES:
        t0 = time.time()
        so, roa, tm = build.build_index(tg, wl, sd, mh, device=dev)
        got = np.array([0xFFFFFFFF, wl, mh, tm], np.uint32).tobytes() + \
            so.tobytes() + roa.tobytes()
        if got != read(os.path.join(gold, name + ".gz")):
            raise AssertionError("phase11 builder: %s differs from its "
                                 "golden" % name)
        log("phase11 builder on the card: %s byte-equal to its golden "
            "(%.2f s)" % (name, time.time() - t0))
    del tg
    genome = nib2.load(read(nib))
    wl, sd, mh = BIG_INDEX
    sync(torch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    stats = {}
    t0 = time.time()
    so, roa, tm = build.build_index(genome, wl, sd, mh, device=dev,
                                    stats=stats)
    report["torch_s"] = time.time() - t0
    report["torch_steps_s"] = stats
    report["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    t0 = time.time()
    nso, nroa, ntm = native_host.build_index(genome, wl, sd, mh,
                                             n_threads=max(threads, 4))
    report["native_build_s"] = time.time() - t0
    if tm != ntm or not np.array_equal(so, nso) or \
            not np.array_equal(roa, nroa):
        raise AssertionError("phase11 builder: the L%d index of the %d bp "
                             "genome differs from the native builder's"
                             % (wl, int(genome.lengths.sum())))
    log("phase11 builder at %d bp L%d S%d H%d: SO and ROA == native "
        "build_index (%d hits); torch on the card %.2f s (host scan %.2f "
        "s, device passes %.3f s by CUDA events, third pass %.2f s, fetch "
        "%.2f s), peak %.2f GB allocated; native (%d threads) %.2f s" % (
            int(genome.lengths.sum()), wl, sd, mh, tm, report["torch_s"],
            stats["scan_s"], stats["device_s"], stats["sample_s"],
            stats["fetch_s"], report["peak_bytes"] / 1e9,
            max(threads, 4), report["native_build_s"]))
    del so, roa, nso, nroa, genome
    torch.cuda.empty_cache()
    return report


def _device_time(torch, prof, wall):
    """(busy ms, idle share of `wall`, ms by kind, ms of the 8 costliest
    names) from the card's events of one torch.profiler run."""
    evs = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, cur = 0.0, None
    for t0, t1, _ in sorted(evs):
        if cur is None or t0 > cur[1]:
            busy += cur[1] - cur[0] if cur else 0.0
            cur = [t0, t1]
        else:
            cur[1] = max(cur[1], t1)
    busy += cur[1] - cur[0] if cur else 0.0
    kinds, names = {}, {}
    for t0, t1, name in evs:
        kind = ("h2d" if "HtoD" in name else "d2h" if "DtoH" in name
                else "memset" if "Memset" in name else "kernel")
        kinds[kind] = kinds.get(kind, 0.0) + (t1 - t0) / 1e3
        names[name] = names.get(name, 0.0) + (t1 - t0) / 1e3
    top = dict(sorted(names.items(), key=lambda kv: -kv[1])[:8])
    return busy / 1e3, 1 - busy / 1e3 / (wall * 1e3), kinds, top


def phase_profile(torch, sw, host, StagedAligner, DeviceSeeder, genome,
                  index, aa, reads, threads, out, dev):
    """--profile: the 1 kb batch in the default and the A/B configuration,
    and in the default one with the device seeder ("seed")."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out, exist_ok=True)
    pr = host.parse_queries_native(b"".join(reads), False,
                                   aa.max_query_length, aa.word_len)
    t0 = time.time()
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=threads)[0]
    log("profile native: wall_s=%.4f" % (time.time() - t0))
    kw = dict(device=dev, n_threads=threads)
    seeder = DeviceSeeder(aa, index, device=dev)
    aligners = {"default": StagedAligner(aa, genome, index, **kw),
                "ab": StagedAligner(aa, genome, index, **kw, **AB),
                "seed": StagedAligner(aa, genome, index, **kw,
                                      seeder=seeder)}
    for name, st in aligners.items():
        _timed(torch, sw, st, pr, ref, dev, "profile %s first run" % name)
    for name in ("default", "ab", "seed", "seed", "ab", "default",
                 "default", "ab", "seed"):
        st = aligners[name]
        _reset_stats(st, seeder)
        wall, _ = _timed(torch, sw, st, pr, ref, dev, "profile " + name)
        s = st.stats
        log("profile %s: warm_wall_s=%.4f device_s=%.4f seed_device_s=%.4f "
            "h2d_mb=%.3f d2h_mb=%.3f plane_d2h_mb=%.3f host_s=%s" % (
                name, wall, s["device_s"], seeder.stats["seed_device_s"],
                s["h2d_bytes"] / 1e6, s["d2h_bytes"] / 1e6,
                s["plane_d2h_bytes"] / 1e6, json.dumps({
                    k[:-2]: round(s[k], 4) for k in (
                        "begin_s", "gap_host_s", "phase2_s", "ext_host_s",
                        "finish_s")})))
    for name, st in aligners.items():
        pf = cProfile.Profile()
        pf.enable()
        _timed(torch, sw, st, pr, ref, dev, "profile %s cProfile" % name)
        pf.disable()
        text = io.StringIO()
        pstats.Stats(pf, stream=text).sort_stats("tottime").print_stats(40)
        with open(os.path.join(out, "cprofile_%s.txt" % name), "w") as f:
            f.write(text.getvalue())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = _timed(torch, sw, st, pr, ref, dev,
                             "profile %s torch.profiler" % name)
        busy, idle, kinds, top = _device_time(torch, prof, wall)
        with open(os.path.join(out, "device_%s.txt" % name), "w") as f:
            f.write(prof.key_averages().table(row_limit=40))
        log("profile %s device: wall_s=%.4f busy_ms=%.3f idle_share=%.4f "
            "ms_by_kind=%s top_ms=%s" % (
                name, wall, busy, idle,
                json.dumps({k: round(v, 3) for k, v in kinds.items()}),
                json.dumps({k[:60]: round(v, 3) for k, v in top.items()})))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="profile the 1 kb batch instead of the smoke run; "
                    "tables go to DIR")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch %s)" % torch.__version__,
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    from yaha_tpu_torch.models.staged import StagedAligner, gap_dispatch
    from yaha_tpu_torch.ops import seeds, sw_cuda as sw
    from yaha_tpu_torch.ops.gather_dp import pack_coords
    dev = torch.device("cuda")
    threads = os.cpu_count() or 1
    t_start = time.time()
    if not host.available():
        raise RuntimeError("native host library did not build")

    t_phase = [time.time()]

    def phase_done(tag):
        now = time.time()
        log("%s: %.1f s" % (tag, now - t_phase[0]))
        t_phase[0] = now

    phase_build()
    phase_done("phase1 seconds")
    errs = {}
    if not args.profile:
        phase_kernels(torch, sw, errs, dev)
        phase_done("phase2 seconds")
    Recorder = _recorder(StagedAligner, gap_dispatch, pack_coords)

    fa, nib, idx = genome_files(threads)
    t0 = time.time()
    genome = host.load_genome(nib)
    index = host.load_index(idx)
    log("setup: genome %d bp, index loaded in %.1f s" % (
        int(genome.codes_len), time.time() - t0))
    seqs = chromosomes(fa)
    rng = np.random.default_rng(SEED)
    sv = sv_reads(nib, BATCH // 8)
    n_half = (BATCH - len(sv)) // 2
    reads = (sample_reads(seqs, n_half, 1000, rng, b"sub", False) +
             sample_reads(seqs, BATCH - len(sv) - n_half, 1000, rng,
                          b"indel", True) + sv)
    reads = [reads[i] for i in rng.permutation(len(reads))]
    log("setup: %d reads of 1 kb (%d substitution-only, %d with indels, "
        "%d split reads)" % (len(reads), n_half,
                             BATCH - len(sv) - n_half, len(sv)))
    phase_done("setup seconds")
    aa = _aa(host, index, idx)
    if args.profile:
        phase_profile(torch, sw, host, StagedAligner, DeviceSeeder, genome,
                      index, aa, reads, threads, args.profile, dev)
        log("total: %.1f s" % (time.time() - t_start))
        return 0
    st, launches, pr, ref = phase_main(torch, sw, host, Recorder, genome,
                                       index, aa, reads, threads,
                                       "phase3 1kb", dev)
    # At -BW 5 (W = 21) every extension goes through the register kernel;
    # the host seed scan launches no seed kernel.
    for name in KERNELS:
        if (launches[name] == 0) != (name == "extension_forward_wide" or
                                     name in SEED_KERNELS + CHAIN_KERNELS +
                                     SCALE_KERNELS):
            raise AssertionError("phase3: %s launched %d times" % (
                name, launches[name]))
    log("phase3 1kb launches by route: %s" % json.dumps(
        {k: launches[k] for k in DP_KERNELS}))
    kernels = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "launches": launches[name],
                      "max_abs_err": errs.get(name, 0)}
               for name, (src, rep) in KERNELS.items()}
    phase_ab(torch, sw, StagedAligner, genome, index, aa, pr, ref, threads,
             "phase3 1kb A/B", dev)
    phase_done("phase3 seconds")
    # The wide extension kernel's path: bands wider than -BW 8, the whole
    # batch at -BW 9 and part of it at -BW 16.
    wide_runs = {}
    for bw, part in ((WIDE_BW, reads), (WIDER_BW, reads[:WIDER_READS])):
        wide_runs[bw] = phase_main(
            torch, sw, host, Recorder, genome, index,
            _aa(host, index, idx, band_width=bw), part, threads,
            "phase4 1kb BW%d" % bw, dev)
        wide = wide_runs[bw][1]
        if wide["extension_forward"] or not wide["extension_forward_wide"]:
            raise AssertionError("phase4 BW%d: extension launches %s" % (
                bw, wide))
    st_wide, st_wider = wide_runs[WIDE_BW][0], wide_runs[WIDER_BW][0]
    kernels["extension_forward_wide"]["launches"] = \
        wide_runs[WIDE_BW][1]["extension_forward_wide"]

    long_reads = (sample_reads(seqs, 128, 10000, rng, b"long", False) +
                  sample_reads(seqs, 128, 10000, rng, b"longindel", True))
    aa10 = _aa(host, index, idx)
    st10, _, pr10, ref10 = phase_main(torch, sw, host, Recorder, genome,
                                      index, aa10, long_reads, threads,
                                      "phase4 10kb", dev)
    tg_nib, tg_idx = testgen_files()
    tg_index = host.load_index(tg_idx)
    st105 = phase_main(torch, sw, host, Recorder, host.load_genome(tg_nib),
               tg_index, _aa(host, tg_index, tg_idx,
                             max_query_length=150000),
               long_read_105k(rng), threads, "phase4 105kb", dev)[0]
    phase_cli(tg_nib, tg_idx)
    phase_done("phase4 seconds")
    # The medium-indel batch: the anchored wide route at the default -BW 5
    # (its own generator, so that every other read set stays as it was).
    mid_reads = medium_indel_reads(seqs, MEDIUM_INDEL_READS, 1000,
                                   np.random.default_rng(SEED + 10),
                                   b"midindel")
    st_mid = phase_main(torch, sw, host, Recorder, genome, index, aa,
                        mid_reads, threads, "phase5 1kb medium indels",
                        dev)[0]
    phase_done("phase5 medium indels run seconds")
    # The device seed phase: its counts are set to 0 just before its warm
    # run and read just after it.
    seeder, seed_launches = phase_seed(
        torch, sw, StagedAligner, _seed_recorder(torch, DeviceSeeder),
        genome, index, aa, pr, ref, threads, dev)
    for name in SEED_KERNELS:
        kernels[name]["launches"] = seed_launches[name]
    phase_seed_reads(torch, sw, host, StagedAligner, DeviceSeeder, seeder,
                     genome, index, aa10, pr10, ref10, tg_nib, tg_idx,
                     threads, dev)
    phase_done("phase6 runs seconds")
    phase_times(torch, sw, st, st_wide, st_wider, st10, kernels, errs, dev)
    phase_anch_bw16(torch, sw, st_wider, kernels, errs, dev)
    phase_medium_indels(torch, sw, st_mid, kernels, errs, dev)
    phase_done("phase5 seconds")
    phase_seed_kernels(torch, seeds, seeder, kernels, errs, dev)
    phase_done("phase6 kernels seconds")
    # Phase 10's walk profile takes the main path's own planes.
    walk_buckets = (_largest(st, "extension_forward", 1024)[1],
                    _largest(st, "anchored_forward")[1])
    phase_gap_histogram(sw, [("1kb", st), ("1kb BW%d" % WIDE_BW, st_wide),
                             ("1kb BW%d" % WIDER_BW, st_wider),
                             ("10kb", st10), ("105kb", st105),
                             ("1kb medium indels", st_mid)])
    del st, st_wide, st_wider, st10, st105, st_mid, wide_runs, seeder
    phase_done("phase5 histogram seconds")
    # The chain DP's own path (no engine runs it): its counts are set to 0
    # just before it and read just after.
    phase_chain(torch, sw, kernels, errs, dev)
    phase_done("phase7 seconds")
    phase_torch(torch, sw, host, StagedAligner, Recorder, genome, index, aa,
                reads, threads, dev)
    phase_engines_cli(tg_nib, tg_idx)
    phase_done("phase8 seconds")
    # The scale-out: the gap buckets too wide for the kernels, then the
    # sharded seeder, whose (1 x 2) grid's warm run (counts set to 0 just
    # before it and read just after) is the merge kernel's path.
    phase_long_gaps(torch, sw, host, StagedAligner, tg_nib, tg_idx, threads,
                    dev)
    # The block extension's path, bands past -BW 707 (its readsA run's
    # counts), then the merge's.
    kernels["extension_forward_block"]["launches"] = phase_wide_band(
        torch, sw, host, StagedAligner, tg_nib, tg_idx, threads, kernels,
        errs, dev)["extension_forward_block"]
    sharded, shard_launches = phase_sharded_seed(
        torch, sw, StagedAligner, _seed_recorder(torch, DeviceSeeder),
        DeviceSeeder, genome, index, aa, pr, ref, threads, dev)
    kernels["merge_sorted_runs"]["launches"] = shard_launches[
        "merge_sorted_runs"]
    phase_shard_kernels(torch, seeds, sharded, kernels, errs, dev)
    del sharded
    phase_multihost(reads, idx, tg_idx)
    phase_done("phase9 seconds")
    phase_tools(torch, sw, StagedAligner, genome, index, aa, pr, idx,
                walk_buckets, threads, dev)
    del walk_buckets
    phase_done("phase10 seconds")
    # The oracle engine and the index builder, which launch no kernel.
    phase_oracle_builder(torch, reads, nib, idx, threads, dev)
    phase_done("phase11 seconds")

    log("total: %.1f s" % (time.time() - t_start))
    log(json.dumps({"kernels": [kernels[k] for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
