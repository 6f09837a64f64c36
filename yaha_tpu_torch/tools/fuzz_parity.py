"""Differential fuzz of the port's engines against its native engine.

Counterpart of tools/fuzz_parity.py.  Each seed draws a random genome
(1-3 sequences of 2-60 kb with repeats and N runs), a read set (genome
pieces of 60 bp to 20 kb, chimeras, garbage, length extremes up to 33 kb,
substitutions and IUPAC codes at 0-15 %, FASTA or FASTQ) and a random
flag set, with the reference tool's own generators (gen_genome,
gen_reads, gen_config: copied, so one seed gives the same bytes).  Then
draws that reach the port's routes, from the same generator after the
reference's:

  -BW 0, 9 or 16       the wide extension kernel (three cases in ten)
  -BW 708              the block extension kernel (one case in 50)
  -G 300               the anchored gap fill's wide route (one in five)
  -G 3600              buckets past the wide route: the lockstep twin
                       (one case in 100)
  medium indels        1-4 reads of 300-1,000 bases with one 20-60 base
                       insertion or deletion (one case in three)

The port's CLI indexes the genome (-g ... -L/-S as drawn); the reference
is the port's --engine native on that index, and where the reference
binary exists (YT_YAHA_REF, default ~/yaha_ref_build/bin/yaha) the native
output is held to it too.  The arms under test, each on --device (default cuda):

  batch-cuda           host seed scan
  batch-cuda-seed      --seed device
  batch-cuda-shards    --model-shards 2
  batch-cuda-b64       --batch-size 64
  batch-torch          the lockstep twins, on the seed's reads of at most
                       TWIN_MAX_READ bases and at -BW up to 707 (a column
                       step a PyTorch op: a 20 kb read would take minutes),
                       against the native engine on the same reads
  oracle               --engine oracle, the reference-exact Python aligner
                       (core/; the reference tool's oracle arm); it has no
                       device, and --device is ignored

Every output is compared with the reference's, @PG lines ignored.  A
failing seed's directory is kept; its seed, flags and the first line
that differs are printed.  The reference runs in a process of its own,
and a seed whose native run takes longer than REF_TIMEOUT seconds is
skipped (the reference tool's "ref-timeout"); the arms run the CLI in
this process.

  python -m yaha_tpu_torch.tools.fuzz_parity [n_seeds] [seed0]
      [--device cuda|cpu] [--arms batch-cuda,batch-torch,...]
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

YAHA = os.environ.get("YT_YAHA_REF",
                      os.path.expanduser("~/yaha_ref_build/bin/yaha"))

BASES = "ACGT"
# The widest band the batch-torch arm runs, and the longest read it takes
# (the rest of the seed's reads run on the kernels' arms only): its
# lockstep twin takes a PyTorch op a band column a row, so -BW 708 (W
# 2,833) or a 20 kb read would take minutes on a read set that the
# kernels align in a fraction of a second.
TWIN_MAX_BW = 707
TWIN_MAX_READ = 300
# Seconds the native reference may take on a seed before the seed is
# skipped (the reference tool's "ref-timeout": tandem-repeat reads of 32
# kb can take any aligner minutes).
REF_TIMEOUT = 60

ARMS = {
    "batch-cuda": ["--engine", "batch-cuda"],
    "batch-cuda-seed": ["--engine", "batch-cuda", "--seed", "device"],
    "batch-cuda-shards": ["--engine", "batch-cuda", "--model-shards", "2"],
    "batch-cuda-b64": ["--engine", "batch-cuda", "--batch-size", "64"],
    "batch-torch": ["--engine", "batch-torch"],
    "oracle": ["--engine", "oracle"],
}


# ---- the reference tool's generators (tools/fuzz_parity.py:25-170) ----

def gen_genome(rng, path):
    n_seqs = rng.randint(1, 4)
    genome = {}
    with open(path, "w") as f:
        for s in range(n_seqs):
            name = "c%d" % s
            size = rng.randint(2000, 60000)
            seq = [rng.choice(BASES) for _ in range(size)]
            # repeats
            if size > 3000:
                rep = [rng.choice(BASES) for _ in range(rng.randint(50, 300))]
                for _ in range(rng.randint(0, 12)):
                    p = rng.randrange(0, size - len(rep))
                    seq[p:p + len(rep)] = rep
            # N runs
            for _ in range(rng.randint(0, 3)):
                p = rng.randrange(0, size - 100)
                ln = rng.randint(1, 90)
                seq[p:p + ln] = "N" * ln
            genome[name] = "".join(seq)
            f.write(">%s\n" % name)
            for i in range(0, size, 60):
                f.write(genome[name][i:i + 60] + "\n")
    return genome


COMP = str.maketrans("ACGTN", "TGCAN")


def gen_reads(rng, genome, path, fastq=False):
    names = list(genome)
    n_reads = rng.randint(5, 60)
    iupac = "RYKMSWBDHVN"
    with open(path, "w") as f:
        for i in range(n_reads):
            kind = rng.random()
            if kind < 0.6:
                c = rng.choice(names)
                g = genome[c]
                ln = min(rng.choice([60, 100, 300, 1000, 5000, 20000]),
                         len(g) - 1)
                p = rng.randrange(0, len(g) - ln)
                s = list(g[p:p + ln])
            elif kind < 0.85:
                # chimera
                c1, c2 = rng.choice(names), rng.choice(names)
                l1 = rng.randint(30, 300)
                l2 = rng.randint(30, 300)
                l1 = min(l1, len(genome[c1]) - 1)
                l2 = min(l2, len(genome[c2]) - 1)
                p1 = rng.randrange(0, len(genome[c1]) - l1)
                p2 = rng.randrange(0, len(genome[c2]) - l2)
                part2 = genome[c2][p2:p2 + l2]
                if rng.random() < 0.5:
                    part2 = part2.translate(COMP)[::-1]
                s = list(genome[c1][p1:p1 + l1] + part2)
            elif kind < 0.95:
                # random garbage
                s = [rng.choice(BASES) for _ in range(rng.randint(20, 200))]
            else:
                # length extremes: tiny (< wordLen), near/over the 32kb
                # cap (exercises skip-with-warning and realloc analogs,
                # Query.c:81-100,148-213)
                ln = rng.choice([1, 5, 12, 14, 31990, 32000, 32001, 33000])
                c = rng.choice(names)
                g = genome[c]
                if ln <= len(g) - 1:
                    p = rng.randrange(0, len(g) - ln)
                    s = list(g[p:p + ln])
                    # long reads tile the genome piece if needed
                else:
                    reps = ln // (len(g) - 1) + 1
                    s = list((g[:-1] * reps)[:ln])
            err = rng.choice([0.0, 0.01, 0.03, 0.08, 0.15])
            for k in range(len(s)):
                r = rng.random()
                if r < err:
                    s[k] = rng.choice(BASES)
                elif r < err * 1.2:
                    s[k] = rng.choice(iupac)
            s = "".join(s)
            if rng.random() < 0.5:
                s = s.translate(COMP)[::-1]
            if fastq:
                qual = "".join(chr(33 + rng.randrange(10, 40)) for _ in s)
                f.write("@r%d\n%s\n+\n%s\n" % (i, s, qual))
            else:
                f.write(">r%d\n" % i)
                for j in range(0, len(s), 70):
                    f.write(s[j:j + 70] + "\n")


def gen_config(rng):
    args = []
    if rng.random() < 0.3:
        args += ["-L", str(rng.choice([9, 10, 11, 12]))]
    else:
        args += ["-L", "11"]
    if rng.random() < 0.3:
        args += ["-S", str(rng.randint(1, 5))]
    cfg = []
    if rng.random() < 0.3:
        cfg += ["-H", str(rng.choice([20, 100, 650]))]
    if rng.random() < 0.3:
        cfg += ["-BW", str(rng.choice([2, 3, 5, 8]))]
    if rng.random() < 0.3:
        cfg += ["-G", str(rng.choice([10, 25, 50, 100]))]
    if rng.random() < 0.3:
        cfg += ["-M", str(rng.choice([12, 25, 40]))]
    if rng.random() < 0.3:
        cfg += ["-MD", str(rng.choice([20, 50, 120]))]
    if rng.random() < 0.3:
        cfg += ["-P", rng.choice(["0.50", "0.60", "0.75",
                          "0.80", "0.90", "0.95"])]
    if rng.random() < 0.3:
        cfg += ["-X", str(rng.choice([10, 25, 60]))]
    if rng.random() < 0.25:
        cfg += ["-AGS", "N"]
    else:
        if rng.random() < 0.3:
            cfg += ["-GOC", str(rng.randint(1, 8)),
                    "-GEC", str(rng.randint(1, 4)),
                    "-RC", str(rng.randint(1, 6)),
                    "-MS", str(rng.randint(1, 3))]
    mode = rng.random()
    if mode < 0.2:
        cfg += ["-OQC", "N"]
    elif mode < 0.5:
        cfg += ["-FBS", "Y"]
        if rng.random() < 0.5:
            cfg += ["-PRL", rng.choice(["0.25", "0.50", "0.75",
                                        "0.90"]),
                    "-PSS", rng.choice(["0.10", "0.50",
                                        "0.75", "0.90"])]
    if rng.random() < 0.3:
        cfg += ["-BP", str(rng.randint(1, 12)),
                "-MGDP", str(rng.randint(1, 9)),
                "-MNO", str(rng.choice([5, 25, 60]))]
    out = rng.choice(["-osh", "-oss", "-o8"])
    return args, cfg, out


# ---- the port's own draws ----

def gen_port_extras(rng, genome, path, fastq):
    """Flags and reads that reach the port's routes, drawn after the
    reference's generators from the same generator: returns the extra
    flags (later flags override the drawn ones) and appends medium-indel
    reads (chip_smoke.py medium_indel_reads: one insertion or deletion of
    20-60 bases, alternately, at 5 % substitutions) to the read file."""
    extra = []
    b = rng.random()
    if b < 0.02:
        extra += ["-BW", "708"]
    elif b < 0.32:
        extra += ["-BW", str(rng.choice([0, 9, 16]))]
    g = rng.random()
    if g < 0.01:
        extra += ["-G", "3600"]
    elif g < 0.21:
        extra += ["-G", "300"]
    if rng.random() < 1 / 3:
        names = [c for c in genome if len(genome[c]) > 1200]
        with open(path, "a") as f:
            for k in range(rng.randint(1, 4) if names else 0):
                c = genome[rng.choice(names)]
                size = rng.randint(20, 60)
                length = rng.randint(300, min(1000, len(c) - size - 1))
                p = rng.randrange(0, len(c) - length - size)
                s = list(c[p:p + length + size])
                at = rng.randrange(0, length)
                if k % 2:
                    s = s[:at] + s[at + size:]
                else:
                    s = (s[:at] + [rng.choice(BASES) for _ in range(size)]
                         + s[at:])
                s = s[:length]
                for i in range(length):
                    if rng.random() < 0.05:
                        s[i] = rng.choice(BASES)
                s = "".join(s)
                if rng.random() < 0.5:
                    s = s.translate(COMP)[::-1]
                if fastq:
                    f.write("@mi%d\n%s\n+\n%s\n" % (k, s, "I" * len(s)))
                else:
                    f.write(">mi%d\n%s\n" % (k, s))
    return extra


def _native(idx, reads, cfg, out_mode, timeout):
    """The reference: the port's --engine native in a process of its own,
    stopped after `timeout` seconds.  Returns (output lines without @PG,
    None), or (None, why) on a crash or a timeout."""
    out = reads + ".native"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    try:
        r = subprocess.run([sys.executable, "-m", "yaha_tpu_torch.cli", "-x",
                            idx, "-q", reads, "--engine", "native"] + cfg +
                           [out_mode, out], env=env, capture_output=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        return None, "timeout: the native engine took more than %d s" % (
            timeout)
    if r.returncode != 0:
        return None, "crash %d: %s" % (r.returncode,
                                       r.stderr.decode()[-300:])
    return _body(out), None


def _short_reads(path, fastq, limit):
    """Write the reads of at most `limit` bases of a generated read file
    to <path>.short (same format); returns (that path, reads kept, reads
    in all), or None when none is that short."""
    with open(path) as f:
        text = f.read()
    if fastq:
        lines = text.splitlines(keepends=True)
        recs = ["".join(lines[k:k + 4]) for k in range(0, len(lines), 4)]
        seqs = [lines[k + 1].strip() for k in range(0, len(lines), 4)]
    else:
        recs = [">" + r for r in text.split(">")[1:]]
        seqs = ["".join(r.splitlines()[1:]) for r in recs]
    keep = [r for r, q in zip(recs, seqs) if len(q) <= limit]
    if not keep:
        return None
    out = path + ".short" + os.path.splitext(path)[1]
    with open(out, "w") as f:
        f.write("".join(keep))
    return out, len(keep), len(recs)


def _band_width(cfg):
    """The -BW a flag list sets (the last one wins), default 5."""
    bw = 5
    for k, v in zip(cfg, cfg[1:]):
        if k == "-BW":
            bw = int(v)
    return bw


def _cli(argv):
    """The port's CLI in this process: (exit code, its stderr text)."""
    from .. import cli
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            rc = cli.main(argv)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
        except Exception as e:         # a crash of the arm, reported
            rc = "%s: %s" % (type(e).__name__, str(e)[:300])
    return rc, err.getvalue()


def _body(path):
    with open(path, "rb") as f:
        return [ln for ln in f.read().split(b"\n")
                if not ln.startswith(b"@PG")]


def _first_diff(a, b):
    for k, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return "line %d: %r != %r" % (k, x[:200], y[:200])
    return "lengths %d != %d" % (len(a), len(b))


def run_one(seed, device="cuda", arms=tuple(ARMS), keep=False,
            ref_timeout=REF_TIMEOUT):
    """One seed; returns its result dict: "seed", "flags", "arms" ({arm:
    "ok" | "DIFF" | "crash ..."}), "skipped" (the reference took longer
    than ref_timeout seconds: nothing to compare), "first_diff" ({arm:
    text}), "dir" (kept only on a failure or with keep), "seconds"."""
    t0 = time.time()
    rng = random.Random(seed)
    d = tempfile.mkdtemp(prefix="yt_fuzz%d_" % seed)
    res = {"seed": seed, "arms": {}, "first_diff": {}}
    try:
        gpath = os.path.join(d, "g.fasta")
        genome = gen_genome(rng, gpath)
        fastq = rng.random() < 0.25
        rpath = os.path.join(d, "reads.fastq" if fastq else "reads.fasta")
        gen_reads(rng, genome, rpath, fastq=fastq)
        idx_args, cfg, out_mode = gen_config(rng)
        cfg = cfg + gen_port_extras(rng, genome, rpath, fastq)
        res["flags"] = " ".join(idx_args + cfg + [out_mode])
        rc, err = _cli(["-g", gpath] + idx_args)
        if rc != 0:
            res["arms"]["index"] = "crash %s: %s" % (rc, err[-300:])
            return res
        idx = os.path.join(d, [f for f in os.listdir(d) if ".X" in f][0])
        want, why = _native(idx, rpath, cfg, out_mode, ref_timeout)
        if why and why.startswith("timeout"):
            res["skipped"] = why
            return res
        if why:
            res["arms"]["native"] = why
            return res
        if os.path.exists(YAHA):
            try:
                r = subprocess.run([YAHA, "-x", idx, "-q", rpath] + cfg +
                                   [out_mode, os.path.join(d, "ref.out")],
                                   cwd=d, capture_output=True,
                                   timeout=ref_timeout)
            except subprocess.TimeoutExpired:
                r = None
            if r is not None and r.returncode == 0:
                got = _body(os.path.join(d, "ref.out"))
                res["arms"]["native-vs-binary"] = (
                    "ok" if got == want else "DIFF")
                if got != want:
                    res["first_diff"]["native-vs-binary"] = _first_diff(
                        want, got)
        short = None
        for arm in arms:
            reads, ref_body = rpath, want
            if arm == "batch-torch":
                # The twin's cost grows with rows x band columns: it runs
                # on the reads of at most TWIN_MAX_READ bases, against the
                # native engine on the same reads.
                why = None
                if _band_width(cfg) > TWIN_MAX_BW:
                    why = "-BW %d past %d" % (_band_width(cfg), TWIN_MAX_BW)
                elif short is None:
                    short = _short_reads(rpath, fastq, TWIN_MAX_READ)
                    if short is not None:
                        body, why = _native(idx, short[0], cfg, out_mode,
                                            ref_timeout)
                        if why and not why.startswith("timeout"):
                            res["arms"]["native-short"] = why
                            continue
                        short = None if why else short + (body,)
                if why is None and short is None:
                    why = "no read of at most %d bases" % TWIN_MAX_READ
                if why:
                    res.setdefault("not_run", {})[arm] = why
                    continue
                reads, ref_body = short[0], short[3]
                res["twin_reads"] = short[1:3]
            out = os.path.join(d, arm + ".out")
            t1 = time.time()
            rc, err = _cli(["-x", idx, "-q", reads] + ARMS[arm] +
                           ["--device", device] + cfg + [out_mode, out])
            res.setdefault("arm_s", {})[arm] = time.time() - t1
            if rc != 0:
                res["arms"][arm] = "crash %s: %s" % (rc, err[-300:])
                continue
            got = _body(out)
            res["arms"][arm] = "ok" if got == ref_body else "DIFF"
            if got != ref_body:
                res["first_diff"][arm] = _first_diff(ref_body, got)
        return res
    finally:
        res["seconds"] = time.time() - t0
        failed = any(v != "ok" for v in res["arms"].values())
        if keep or failed:
            res["dir"] = d
        else:
            shutil.rmtree(d, ignore_errors=True)


def run(n, seed0, device="cuda", arms=tuple(ARMS), log=print,
        ref_timeout=REF_TIMEOUT):
    """Seeds seed0 .. seed0 + n - 1; returns (results, failed seeds)."""
    results, fails = [], []
    for seed in range(seed0, seed0 + n):
        res = run_one(seed, device, arms, ref_timeout=ref_timeout)
        results.append(res)
        bad = {a: v for a, v in res["arms"].items() if v != "ok"}
        if "skipped" in res:
            log("fuzz seed %d: skipped, %s (%s)" % (seed, res["skipped"],
                                                    res["flags"]))
        elif bad:
            fails.append(seed)
            log("fuzz seed %d: %s; flags %s; first difference %s; "
                "artifacts in %s" % (seed, json.dumps(bad), res["flags"],
                                     json.dumps(res["first_diff"]),
                                     res.get("dir")))
        else:
            log("fuzz seed %d: ok (%s; %.1f s; arms %s; not run %s)" % (
                seed, res["flags"], res["seconds"], json.dumps(
                    {a: round(t, 2) for a, t in res.get("arm_s", {}).items()}),
                json.dumps(res.get("not_run", {}))))
    return results, fails


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Differential fuzz of the "
                                 "port's engines against its native "
                                 "engine.")
    ap.add_argument("n", nargs="?", type=int, default=50)
    ap.add_argument("seed0", nargs="?", type=int, default=1000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arms", default=",".join(ARMS))
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fuzz_parity: no CUDA device; use --device cpu")
    arms = tuple(a for a in args.arms.split(",") if a)
    for a in arms:
        if a not in ARMS:
            raise SystemExit("unknown arm %s (%s)" % (a, ", ".join(ARMS)))
    _, fails = run(args.n, args.seed0, args.device, arms)
    print("done: %d/%d failures %s" % (len(fails), args.n, fails))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
