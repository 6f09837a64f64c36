#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (yaha_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py        (from the root of a checkout; one card)

Phases, each of which raises on failure (the script then exits non-zero):

  1. device and build: the card's name and power limit, and the nvcc
     build of yaha_tpu_torch/csrc into a shared library;
  2. every DP kernel against its plain PyTorch version on the card, on
     numpy-seeded inputs: all outputs equal, backtrack planes included;
  3. the main path: the staged engine of --engine batch-cuda over one
     default batch of 16,384 reads of 1 kb (sampled at 5 % error, half of
     them with short indels, plus simulated split reads) against a 64 Mbp
     synthetic genome with the default L15/S1 index; a cold and a warm
     run, SAM bytes equal to the native C++ engine's; launch counts of
     every kernel over the warm run;
  4. 256 reads of 10 kb, and the 105 kb split read of
     tests/test_long_reads.py, through the same engine, SAM bytes equal to
     the native engine's; the port's CLI on the repository's golden test
     set with --device cuda;
  5. kernel and plain-version times (CUDA events, distinct inputs) at the
     main path's largest buckets.

The genome and index are built from a seed on first use and cached under
.smoke_cache/ (git-ignored).  With no CUDA device, the script exits 2
before printing any result.  The last two lines of standard output are a
JSON object per kernel and the JSON result line.
"""
import gzip
import json
import os
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
SOURCE = "yaha_tpu_torch/csrc/sw_kernels.cu"
KERNELS = {              # wrapper -> the Pallas entry it replaces
    "extension_forward": "yaha_tpu/ops/sw_pallas.py:764",
    "anchored_forward_banded": "yaha_tpu/ops/sw_pallas.py:554",
    "anchored_forward": "yaha_tpu/ops/sw_pallas.py:353",
}


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
    from yaha_tpu_torch.ops import _build
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).strip().splitlines()[0]
    log(smi)
    t0 = time.time()
    built = _build.build()
    log("phase1 build: nvcc %.1f s (%s)" % (built, "compiled" if built
                                           else "up to date"))
    _build.load()
    log("phase1 load: %.2f s" % (time.time() - t0))


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


def phase_kernels(torch, sw, errs, dev):
    """Each kernel on the card against its plain version on the card."""
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

    # Extension: N = 4096 at QL = 256 for BW 5 and 3; a few hundred
    # problems at QL = 4096 (the read lengths the Pallas entry sent to its
    # windowed variant).
    for n, ql, bw, xc, kw in ((4096, 256, 5, 25, kw0), (4096, 256, 3, 15, kw0),
                              (256, 4096, 5, 25, kw0), (512, 64, 5, 25, wrap)):
        bw2 = 2 * bw
        rl = ql + 2 * bw2
        q, r = _rand_problems(rng, n, ql, rl, similar=True)
        qlens = rng.integers(ql // 2, ql + 1, n)
        rlens = np.minimum(qlens + bw2, rl)
        r[np.arange(rl)[None, :] >= rlens[:, None]] = 255
        args = up(q, qlens.astype(np.int32), r, rlens.astype(np.int32))
        kw = dict(kw, band_width=bw, x_cutoff=xc)
        out = sw.extension_forward(*args, **kw)
        sync(torch, dev)
        check("extension_forward", "N=%d QL=%d BW=%d" % (n, ql, bw), kw,
              out, sw.extension_forward_reference(*args, **kw))
    # Anchored, band-relative: N = 2048 at QL = 256, wband 64 and 256.
    for n, ql, wband, kw in ((2048, 256, 64, kw0), (2048, 256, 256, kw0),
                             (512, 64, 64, wrap)):
        rl = ql + wband
        q, r = _rand_problems(rng, n, ql, rl, similar=True)
        qlens = rng.integers(ql // 2, ql + 1, n)
        rlens = rng.integers(ql // 2, rl + 1, n)
        lbw = rng.integers(0, wband // 2, n)
        rbw = rng.integers(0, wband // 2, n)
        args = up(q, qlens, r, rlens, lbw, rbw)
        out = sw.anchored_forward_banded(*args, wband=wband, **kw)
        sync(torch, dev)
        check("anchored_forward_banded", "N=%d QL=%d wband=%d" % (
            n, ql, wband), kw, out,
            sw.anchored_forward_banded_reference(*args, wband=wband, **kw))
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
        out = sw.anchored_forward(*args, **kw)
        sync(torch, dev)
        check("anchored_forward", "N=%d QL=%d RL=%d" % (n, ql, rl), kw,
              out, sw.anchored_forward_reference(*args, **kw))


def _recorder(StagedAligner, gap_dispatch):
    class Recorder(StagedAligner):
        """Keeps the largest bucket of each DP class for phase 5."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.buckets = {}
            self.counts = {}

        def _keep(self, key, arrays):
            n = len(arrays[1])
            self.counts[key] = self.counts.get(key, 0) + n
            if n > len(self.buckets.get(key, (None, ()))[1]):
                self.buckets[key] = arrays

        def _run_ext_bucket(self, qa, qlens, ra, rlens):
            self._keep(("extension_forward", qa.shape[1], ra.shape[1], 0),
                       (qa, qlens, ra, rlens))
            return super()._run_ext_bucket(qa, qlens, ra, rlens)

        def _run_gap_bucket(self, qa, qlens, ra, rlens, lbws, rbws):
            wband, banded = gap_dispatch(lbws, rbws, ra.shape[1])
            name = "anchored_forward_banded" if banded else \
                "anchored_forward"
            self._keep((name, qa.shape[1], ra.shape[1], wband),
                       (qa, qlens, ra, rlens, lbws, rbws))
            return super()._run_gap_bucket(qa, qlens, ra, rlens, lbws,
                                           rbws)
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


def phase_main(torch, sw, host, Recorder, genome, index, aa, reads,
               threads, tag, dev):
    """Cold and warm runs of the staged engine on one batch; byte parity
    with the native engine.  Returns (aligner, kernel launches of the warm
    run)."""
    pr = host.parse_queries_native(b"".join(reads), False,
                                   aa.max_query_length, aa.word_len)
    if pr.n != len(reads):
        raise AssertionError("%s: parsed %d of %d reads"
                             % (tag, pr.n, len(reads)))
    t0 = time.time()
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=threads)[0]
    t_native = time.time() - t0
    st = Recorder(aa, genome, index, device=dev, n_threads=threads)
    t0 = time.time()
    text = st.align_chunk(pr, 0, pr.n)[0]
    cold = time.time() - t0
    if text != ref:
        raise AssertionError("%s cold run: SAM differs from the native "
                             "engine" % tag)
    st.stats = {k: type(v)() for k, v in st.stats.items()}
    sw.reset_launches()
    sync(torch, dev)
    t0 = time.time()
    text = st.align_chunk(pr, 0, pr.n)[0]
    sync(torch, dev)
    warm = time.time() - t0
    launches = sw.launches()
    if text != ref:
        raise AssertionError("%s warm run: SAM differs from the native "
                             "engine" % tag)
    s = st.stats
    log("%s: reads=%d parity=true native_wall_s=%.3f cold_wall_s=%.3f "
        "warm_wall_s=%.3f reads_per_s=%.1f" % (
            tag, pr.n, t_native, cold, warm, pr.n / warm))
    log("%s: ext_problems=%d gap_problems=%d gap_dispatch=%s "
        "dp_launches=%d kernel_launches=%s h2d_mb=%.3f d2h_mb=%.3f "
        "device_s=%.3f host_s=%s" % (
            tag, s["ext_problems"], s["gap_problems"],
            json.dumps({"banded": s["gap_banded"], "full": s["gap_full"],
                        "fallback": s["gap_fallback"]}),
            s["dp_launches"], json.dumps(launches), s["h2d_bytes"] / 1e6,
            s["d2h_bytes"] / 1e6, s["device_s"],
            json.dumps({k[:-2]: round(s[k], 3) for k in (
                "begin_s", "gap_host_s", "phase2_s", "ext_host_s",
                "finish_s")})))
    return st, launches


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
    """The port's CLI with --device cuda on the golden test set."""
    gold = os.path.join(REPO, "tests", "golden")
    with tempfile.TemporaryDirectory(dir=CACHE) as d:
        for f in (nib, idx, os.path.join(REPO, "tests", "data",
                                         "readsA_100bp.fasta")):
            os.symlink(f, os.path.join(d, os.path.basename(f)))
        env = dict(os.environ, PYTHONPATH=REPO)
        run([sys.executable, "-m", "yaha_tpu_torch.cli", "-x",
             "testgen.X11_01_65525S", "-q", "readsA_100bp.fasta",
             "--engine", "batch-cuda", "--device", "cuda", "-osh",
             "A.sam"], cwd=d, env=env)

        def body(p):
            with open(p, "rb") as f:
                return [ln for ln in f.read().split(b"\n")
                        if not ln.startswith(b"@PG")]
        if body(os.path.join(d, "A.sam")) != body(
                os.path.join(gold, "A_default.sam")):
            raise AssertionError("CLI --device cuda: SAM differs from "
                                 "tests/golden/A_default.sam")
    log("phase4 cli: --engine batch-cuda --device cuda == A_default.sam")


def phase_times(torch, sw, st, kernels, errs, dev):
    """Kernel (wrapper: plane zero-fill + launch) and plain-version times
    at the main path's largest buckets; CUDA events, distinct inputs.  The
    kernel's output on the bucket must equal the plain version's."""
    gap_kw, ext_kw = st.gap_kw, st.ext_kw
    for name in KERNELS:
        keys = [k for k in st.counts if k[0] == name]
        if not keys:
            raise AssertionError("phase5: the main path ran no %s bucket"
                                 % name)
        if name == "extension_forward" and any(k[1] == 1024 for k in keys):
            keys = [k for k in keys if k[1] == 1024]
        key = max(keys, key=lambda k: st.counts[k])
        arrs = st.buckets[key]
        n = len(arrs[1])
        base = [torch.from_numpy(np.ascontiguousarray(
            a if a.dtype == np.uint8 else a.astype(np.int32))).to(dev)
            for a in arrs]
        ql_ = arrs[1].astype(np.int64)
        if name == "extension_forward":
            fn, kw = sw.extension_forward, ext_kw
            plain = sw.extension_forward_reference
            cells = int((ql_ * (4 * st.aa.band_width + 1)).sum())
        else:
            lb, rb = arrs[4].astype(np.int64), arrs[5].astype(np.int64)
            rl_ = arrs[3].astype(np.int64)
            cells = int((np.minimum(lb + rb + 1, rl_ + 1) * ql_).sum())
            if name == "anchored_forward_banded":
                kw = dict(gap_kw, wband=key[3])
                fn = sw.anchored_forward_banded
                plain = sw.anchored_forward_banded_reference
            else:
                fn, kw = sw.anchored_forward, gap_kw
                plain = sw.anchored_forward_reference
        rng = np.random.default_rng(SEED)
        sets = []
        for _ in range(4):
            perm = torch.from_numpy(rng.permutation(n)).to(dev)
            sets.append([t.index_select(0, perm).contiguous()
                         for t in base])
        fn(*sets[0], **kw)
        sync(torch, dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        reps = 8
        e0.record()
        for k in range(reps):
            fn(*sets[k % len(sets)], **kw)
        e1.record()
        sync(torch, dev)
        ms = e0.elapsed_time(e1) / reps
        e0.record()
        want = plain(*sets[1], **kw)
        e1.record()
        sync(torch, dev)
        plain_ms = e0.elapsed_time(e1)
        compare(torch, errs, "phase5", name, "bucket=%s N=%d" % (
            list(key[1:]), n), fn(*sets[1], **kw), want)
        kernels[name].update(ms=round(ms, 4), plain_ms=round(plain_ms, 2),
                             max_abs_err=errs[name])
        log("phase5 %s bucket=%s N=%d cells=%d: kernel %.4f ms "
            "(%.2f Gcells/s), plain %.1f ms (%.4f Gcells/s)" % (
                name, list(key[1:]), n, cells, ms, cells / ms / 1e6,
                plain_ms, cells / plain_ms / 1e6))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch %s)" % torch.__version__,
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.staged import StagedAligner, gap_dispatch
    from yaha_tpu_torch.ops import sw_cuda as sw
    dev = torch.device("cuda")
    threads = os.cpu_count() or 1
    t_start = time.time()
    if not host.available():
        raise RuntimeError("native host library did not build")

    phase_build()
    errs = {}
    phase_kernels(torch, sw, errs, dev)
    Recorder = _recorder(StagedAligner, gap_dispatch)

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
    st, launches = phase_main(torch, sw, host, Recorder, genome, index,
                              _aa(host, index, idx), reads, threads,
                              "phase3 1kb", dev)
    for name in KERNELS:
        if launches[name] == 0:
            raise AssertionError("phase3: %s was never launched" % name)
    kernels = {name: {"name": name, "route": "cuda", "source": SOURCE,
                      "replaces": KERNELS[name],
                      "launches": launches[name],
                      "max_abs_err": errs[name]} for name in KERNELS}

    long_reads = (sample_reads(seqs, 128, 10000, rng, b"long", False) +
                  sample_reads(seqs, 128, 10000, rng, b"longindel", True))
    phase_main(torch, sw, host, Recorder, genome, index,
               _aa(host, index, idx), long_reads, threads, "phase4 10kb",
               dev)
    tg_nib, tg_idx = testgen_files()
    tg_index = host.load_index(tg_idx)
    phase_main(torch, sw, host, Recorder, host.load_genome(tg_nib),
               tg_index, _aa(host, tg_index, tg_idx,
                             max_query_length=150000),
               long_read_105k(rng), threads, "phase4 105kb", dev)
    phase_cli(tg_nib, tg_idx)
    phase_times(torch, sw, st, kernels, errs, dev)

    log("total: %.1f s" % (time.time() - t_start))
    log(json.dumps({"kernels": [kernels[k] for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
