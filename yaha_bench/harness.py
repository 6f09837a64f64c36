"""One run of one cell: set-up, the timed window, the trace, the check.

The system under test is the port, `yaha_tpu_torch`, driven as a user's
`--engine batch-cuda` query run drives it: the aligner is built as
cli._do_query builds it (a DeviceSeeder for a card-resident index), and
the window is the CLI's streaming loop, cli._run_native_engine, with its
depth-2 prefetch and writer thread, replaying a FASTA under TMPDIR that
holds copies of the cell's read pool (at least PASS_BATCHES batches, so
the prefetch drains once in that many) pass after pass and writing the
SAM under TMPDIR.  A pass is one call of the loop; the window closes at
the end of the first pass that ends past `seconds`, so it ends on a whole
batch.  The harness wraps the loop's align_fn (StagedAligner.align_chunk)
to keep its spans and the SAM text of one batch a pass, drawn from the
seed before the window (check.py), and wraps nothing else of the
program.

Everything a cell is made of is found by name: the configuration
(configs/<name>.json, as BENCHMARK.json names its file), the traffic mix
(traffic/<name>.json, read by traffic/generator.py) and each per-layer
metric's reader (metrics/<name>.py).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "yaha_tpu")
DP_KERNELS = re.compile(r"\b(ext_reg_kernel|ext_wide_kernel|ext_block_kernel|"
                        r"anch_reg_kernel|anch_wide_kernel|gather_kernel|"
                        r"rle_win_kernel)\b")
SEED_KERNELS = re.compile(r"\b(seed_hash_kernel|expand_sort_kernel)\b")
PASS_BATCHES = 8


class UsageError(Exception):
    pass


def load_cell(name: str, bench_path: str | None = None) -> dict:
    """The cell `name` of BENCHMARK.json: its workload entry, its
    configuration and traffic mix (parsed), and the metrics it reports."""
    bench_path = bench_path or os.path.join(REPO, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise UsageError("no workload %r in %s" % (name, bench_path))
    cfg = next(c for c in bench["configs"] if c["name"] == work["config"])
    with open(os.path.join(REPO, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", work["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(ms):
        return [m for m in ms if name in m.get("workloads", [name])]
    return {"workload": work, "config": config, "traffic": traffic,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def load_reader(metric: str):
    """The `read(ctx)` function of metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "yaha_bench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (yaha_tpu_torch is not yaha_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def card_info() -> dict:
    """nvidia-smi's reading of the card: name, power limit, SM clock."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    line = out.strip().splitlines()[0] if out.strip() else ""
    keys = ("name", "power_limit", "sm_clock", "sm_clock_max", "power_draw")
    return dict(zip(keys, (v.strip() for v in line.split(","))))


class Spans:
    """The harness's host spans: each align_fn call (start, end, reads)
    and each pass of the loop (start, end); perf_counter seconds."""

    def __init__(self):
        self.lock = threading.Lock()
        self.aligns = []
        self.passes = []


def native_genome(g, host_codes):
    """The port's genome record (io/native_loader.NativeGenome) over the
    benchmark's code array, as load_genome fills it from a nib2 file."""
    import ctypes
    from yaha_tpu_torch.io.native_loader import NativeGenome
    ng = NativeGenome()
    ng.names = list(g.names)
    ng.starting_offsets = [int(s) for s in g.starts]
    ng.lengths = [int(n) for n in g.lengths]
    ng.codes_buf = (ctypes.c_char * len(host_codes)).from_buffer(host_codes)
    ng.codes_len = len(host_codes)
    ng.max_roff = ng.starting_offsets[-1] + ng.lengths[-1]
    n = len(ng.names)
    ng._starts_arr = (ctypes.c_int64 * n)(*ng.starting_offsets)
    ng._lens_arr = (ctypes.c_int64 * n)(*ng.lengths)
    blob = "".join(ng.names).encode("latin-1")
    ng._names_blob = ctypes.create_string_buffer(blob, len(blob) + 1)
    offs = np.concatenate([[0], np.cumsum([len(s) for s in ng.names])])
    ng._name_offs = (ctypes.c_int64 * (n + 1))(*offs.tolist())
    ng._mm_refs = host_codes
    return ng


def native_index(word_len, max_hits, so, roa, total):
    """The port's index record (io/native_loader.NativeIndex) over SO and
    ROA arrays, as load_index fills it from an index file."""
    import ctypes
    from yaha_tpu_torch.io.native_loader import NativeIndex
    ix = NativeIndex()
    ix.word_len, ix.max_hits, ix.total_matches = word_len, max_hits, total
    ix.so_ptr = so.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    ix.roa_ptr = roa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    ix.roa_len = len(roa)
    ix._mm, ix._f = so, roa
    return ix


def copies_for(traffic: dict) -> int:
    """Copies of the pool in the FASTA: enough for PASS_BATCHES batches."""
    batch, pool = int(traffic["batch_reads"]), int(traffic["pool_reads"])
    return max(1, -(-PASS_BATCHES * batch // pool))


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None,
        log=sys.stderr) -> dict:
    """One run of `cell` (load_cell's dict); returns the result line's
    object, its "checks" last."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    from yaha_tpu_torch import cli
    from yaha_tpu_torch.index import build as ibuild
    from yaha_tpu_torch.io.genome import Genome
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    from yaha_tpu_torch.models.staged import StagedAligner
    from yaha_tpu_torch.native import host
    from yaha_tpu_torch.ops import _build as cuda_build

    from .reference import index as rindex, runner
    from . import roofline
    from .check import (file_reads, first_read, judge, keep_plan,
                        pick_sample)
    from .trace import device_seconds, summarize
    from .traffic.generator import fasta, make_pool
    from .traffic.genome import make_genome

    config, traffic = cell["config"], cell["traffic"]
    idx_cfg = config["index"]
    on_card = torch.device(device).type == "cuda"
    work = tempfile.mkdtemp(prefix="yaha_bench_")
    try:
        # ---- set-up: the port's libraries (built in the checkout by a
        # checkout's first run), data from the seed, the index, the
        # aligner, a warm-up pass
        t_b0 = time.perf_counter()
        built_s = host.build() + (cuda_build.build() if on_card else 0.0)
        t_data = time.perf_counter()
        g = make_genome(dict(config["genome"], bases=config["genome_bases"]),
                        seed, device)
        t_genome = time.perf_counter()
        pool = make_pool(traffic, g, seed)
        batch = int(traffic["batch_reads"])
        copies = copies_for(traffic)
        reads = file_reads(pool, copies)
        pool_path = os.path.join(work, "pool.fasta")
        sam_path = os.path.join(work, "out.sam")
        with open(pool_path, "wb") as f:
            f.write(fasta(reads))
        host_codes = np.ascontiguousarray(g.codes)
        t0 = time.perf_counter()
        data = {"imports_s": t_b0 - t_start, "build_s": t_data - t_b0,
                "genome_s": t_genome - t_data, "pool_s": t0 - t_genome}
        bstats = {}
        so, roa, total = ibuild.build_index(
            Genome(names=g.names, starting_offsets=g.starts,
                   lengths=g.lengths, codes=host_codes),
            idx_cfg["word_len"], idx_cfg["skip_dist"], idx_cfg["max_hits"],
            device=device, stats=bstats)
        index_wall_s = time.perf_counter() - t0
        ngenome = native_genome(g, host_codes)
        nindex = native_index(idx_cfg["word_len"], idx_cfg["max_hits"], so,
                              roa, total)
        xname = os.path.join(work, "genome.X%02d_%02d_%05dS" % (
            idx_cfg["word_len"], idx_cfg["skip_dist"], idx_cfg["max_hits"]))
        argv = ["-x", xname, "-q", pool_path, "--engine", "batch-cuda",
                "--device", device, "-osh", sam_path, "--batch-size",
                str(batch)] + list(config["query_flags"])
        if config["seed_phase"] == "device":
            argv += ["--seed", "device"]
        aa, _, _ = cli.parse_args(argv)
        cli._take_index_params(aa, nindex)
        t_al0 = time.perf_counter()
        seeder = (DeviceSeeder(aa, nindex, device=device)
                  if config["seed_phase"] == "device" else None)
        aligner = StagedAligner(aa, ngenome, nindex, device=device,
                                n_threads=aa.num_threads, seeder=seeder,
                                backend="cuda")
        spans = Spans()
        # The pass running (-1: the warm-up), the first read of each of a
        # pass's batches (its slots, from the warm-up), the slot kept in
        # each pass and the kept batches' (first, reads, text).
        state = {"pass": -1, "plan": None}
        slots, kept = [], []

        def align_fn(pr, lo, hi, dist=None, want_stats=False):
            a = time.perf_counter()
            text, sm, nr = aligner.align_chunk(pr, lo, hi, dist=dist)
            b = time.perf_counter()
            first = first_read(pr, lo)
            with spans.lock:
                spans.aligns.append((a, b, hi - lo))
                p = state["pass"]
                if p < 0:
                    slots.append(first)
                elif first == state["plan"][p]:
                    kept.append((first, hi - lo, text))
            return text, None, sm, nr

        def loop(path):
            aa.qfile_name = path
            cli._run_native_engine(aa, ngenome, align_fn, aligner.stats,
                                   seeder.stats if seeder else None)

        # Warm-up: one pass, so that every shape, bucket and tier the
        # window's passes meet has run once.
        loop(pool_path)
        _sync(torch, device)
        t_ready = time.perf_counter()
        slots.sort()
        state["plan"] = [slots[k] for k in keep_plan(seed, len(slots))]
        setup = {"setup_s": t_ready - t_start, "warmup_s": t_ready - t_al0,
                 "index_build_s": sum(bstats.values()),
                 "index_wall_s": index_wall_s, "compiled_s": built_s,
                 "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                       if on_card else 0), **data}
        print("set-up %.3f s: imports %.3f s, library builds %.3f s (%s), "
              "genome %.3f s, pool and FASTA %.3f s, index build %.3f s "
              "(wall %.3f s), aligner and warm-up pass %.3f s; device "
              "memory peak %d bytes" % (
                  setup["setup_s"], data["imports_s"], data["build_s"],
                  "compiled in this run: its set-up is not comparable"
                  if built_s > 0 else "already built",
                  data["genome_s"], data["pool_s"], setup["index_build_s"],
                  index_wall_s, setup["warmup_s"],
                  setup["memory_peak_bytes"]), file=log)
        card = card_info() if on_card else {}
        print("card %s, power limit %s, SM clock %s (max %s), draw %s" % (
            card.get("name", "none"), card.get("power_limit", "-"),
            card.get("sm_clock", "-"), card.get("sm_clock_max", "-"),
            card.get("power_draw", "-")), file=log)

        # ---- the timed window
        stats0 = dict(aligner.stats)
        seed0 = dict(seeder.stats) if seeder else None
        spans.aligns.clear()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if on_card:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        mark = torch.profiler.record_function("bench.window")
        mark.__enter__()
        t_w0 = time.perf_counter()
        while True:
            state["pass"] += 1
            a = time.perf_counter()
            loop(pool_path)
            spans.passes.append((a, time.perf_counter()))
            if time.perf_counter() - t_w0 >= seconds:
                break
        _sync(torch, device)
        t_w1 = time.perf_counter()
        mark.__exit__(None, None, None)
        if prof is not None:
            prof.__exit__(None, None, None)
        window_s = t_w1 - t_w0
        n_reads = sum(n for _, _, n in spans.aligns)
        n_pass = len(spans.passes)
        peak = (torch.cuda.max_memory_allocated() if on_card else 0)
        card = card_info() if on_card else {}
        stats = {k: aligner.stats[k] - stats0[k] for k in stats0}
        seed_stats = ({k: seeder.stats[k] - seed0[k] for k in seed0}
                      if seeder else None)
        timeline = None
        if prof is not None:
            tpath = os.path.join(work, "trace.json")
            prof.export_chrome_trace(tpath)
            del prof
            timeline = summarize(tpath, [(a, b) for a, b, _ in spans.aligns],
                                 spans.passes, t_w0)
            os.unlink(tpath)
        flags = list(config["query_flags"])
        del aligner, seeder, nindex, so, roa
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        print("passes (s): " + " ".join("%.3f" % (b - a)
                                        for a, b in spans.passes), file=log)
        print("window %.3f s: %d reads in %d passes of %d (%d copies of the "
              "pool), %.1f reads/s; card %s, power limit %s, SM clock %s "
              "(max %s), draw %s"
              % (window_s, n_reads, n_pass, len(reads), copies,
                 n_reads / window_s, card.get("name", "none"),
                 card.get("power_limit", "-"), card.get("sm_clock", "-"),
                 card.get("sm_clock_max", "-"), card.get("power_draw", "-")),
              file=log)

        # ---- the check against the reference, once the window is closed
        t_c0 = time.perf_counter()
        ref_index = rindex.build(g.codes, g.starts, g.lengths,
                                 idx_cfg["word_len"], idx_cfg["skip_dist"],
                                 idx_cfg["max_hits"], device=device)
        raa = runner.alignment_args(flags, ref_index)
        rgenome = runner.genome(g.names, g.starts, g.lengths, g.codes)
        picks = pick_sample(kept, traffic["check_reads"], seed)
        ref_out = runner.align(raa, rgenome, ref_index, fasta(
            [reads[k] for k in sorted({k for k, _ in picks})]))
        checks, differ = judge(kept, picks, reads, ref_out)
        not_emitted = max(0, n_pass * len(reads) - n_reads)
        checks["reads_not_emitted"] = {"value": not_emitted, "limit": 0}
        check_s = time.perf_counter() - t_c0
        print("check: %d sampled reads of %d kept batches against the "
              "reference in %.3f s; %d differ%s" % (
                  len(picks), len(kept), check_s, len(differ),
                  (": " + ", ".join(differ[:8])) if differ else ""),
              file=log)

        # ---- metrics
        failed = (checks["reads_differing"]["value"] +
                  checks["batches_out_of_order"]["value"] + not_emitted)
        result = {"correct": False, "attempted": n_reads, "failed": failed}
        metrics = {}
        e2e = {"reads_per_s": n_reads / window_s, "setup_s": setup["setup_s"]}
        if not trace:
            for m in cell["end_to_end"]:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        else:
            ctx = {"reads": n_reads, "batches": len(spans.aligns),
                   "passes": n_pass, "window_s": window_s, "setup": setup,
                   "stats": stats, "seed_stats": seed_stats,
                   "align_spans": [(a, b) for a, b, _ in spans.aligns],
                   "timeline": timeline, "dp_kernels": DP_KERNELS,
                   "seed_kernels": SEED_KERNELS,
                   "device_seconds": device_seconds, "roofline": roofline,
                   "seed_work": None}
            if seed_stats is not None:
                w = roofline.seed_work([r for _, r in pool],
                                       ref_index.starting_offs,
                                       ref_index.word_len, raa.max_hits,
                                       device=device)
                ctx["seed_work"] = tuple(n_pass * copies * x for x in w)
            for m in cell["per_layer"]:
                v = load_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if ctx.get("seed_count"):
                print("seed roofline count: %s" % json.dumps(
                    ctx["seed_count"]), file=log)
        result["metrics"] = metrics
        result["device"] = {
            "platform": "gpu" if on_card else "cpu",
            "kind": (torch.cuda.get_device_name() if on_card else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak)}
        if timeline is not None:
            result["device"]["busy_s"] = timeline["busy_s"]
            result["device"]["window_s"] = timeline["window_s"]
            result["breakdown"] = {"device_ops": timeline["device_ops"],
                                   "idle_gaps": timeline["idle_gaps"]}
        result["setup_compiled_s"] = built_s
        result["correct"] = all(c["value"] <= c["limit"]
                                for c in checks.values())
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)
