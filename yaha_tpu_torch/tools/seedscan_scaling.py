"""Thread scaling of the host seed scan, beside the device seeder.

Counterpart of tools/seedscan_scaling.py.  Phase 1 of the staged engine
(parse -> seed scan -> chain -> clumps, the native yt_batch_begin; the
stat begin_s) runs at each thread count on the same reads, warm, best of
`iters`, under StagedAligner(backend="native") so that no device work is
in the chunk.  Beside each row: phase 1's stage CPU seconds summed over
the threads (the scan and its hash / SO / ROA parts, the hit sort,
fragments-to-clumps, the clumps' stage-1 alignment) and its hit,
fragment and clump counts, which the recorder (utils/timing, enabled for
the measurement) takes from the native library (native/host.
profile_counters) onto the batch's staged.phase1 span, so contention
shows as wall x threads against summed seconds.  The device seed phase
is the alternative to the host scan: models/seeder.DeviceSeeder.
seed_chunk on the same reads, its seed_device_s (best of `iters`) beside
the rows.  Every thread count must give the same SAM bytes.

  python -m yaha_tpu_torch.tools.seedscan_scaling [--dir D | -x INDEX]
      [--reads 4000] [--len 1000] [--err 0.05] [--threads 1,2,4,8]
      [--iters 3] [--device cuda|cpu]

Assets: D/big.nib2 + D/big.X15_01_65525S (default ~/hgdata), or an
index named by -x with its .nib2 beside it.  Reads are sampled from the
genome as the reference's tool samples them (seed 33, half reverse
complemented).  Thread counts above the host's cores are dropped.
"""
from __future__ import annotations

import ctypes
import json
import os
import time

import numpy as np

HG_DIR = os.path.expanduser("~/hgdata")
HG_GBP = 3.1      # the human genome the hg-scale assets hold


def sample_reads(genome, n, length, err, seed=33):
    """FASTA bytes of n reads of `length` sampled from the genome at `err`
    substitutions, half reverse complemented (the reference tool's
    sampler, the same draws)."""
    from ..utils import codec
    rng = np.random.default_rng(seed)
    codes = np.ctypeslib.as_array(
        ctypes.cast(genome.codes_buf, ctypes.POINTER(ctypes.c_uint8)),
        shape=(int(genome.codes_len),))
    starts, lens = genome.starting_offsets, genome.lengths
    parts = []
    for i in range(n):
        c = int(rng.integers(0, len(starts)))
        pos = int(starts[c]) + int(rng.integers(
            0, max(1, int(lens[c]) - length)))
        r = codes[pos:pos + length].copy()
        m = (rng.random(length) < err) & (r < 4)
        r[m] = rng.integers(0, 4, int(m.sum()))
        if rng.random() < 0.5:
            r = codec.FOUR_BIT_COMP_CODES[r][::-1]
        parts.append(b">rd%d\n%s\n" % (i, codec.unmap4to8(r).tobytes()))
    return b"".join(parts)


def measure(aa, genome, index, pr, threads, iters=3, device="cuda"):
    """The scaling rows and the device seeder's row on reads pr (all of
    them as one chunk); returns the report."""
    from ..models.seeder import DeviceSeeder
    from ..models.staged import StagedAligner
    from ..native import host
    from ..utils.timing import RECORDER
    rows = []
    ref = None
    RECORDER.enable()
    try:
        for t in threads:
            st = StagedAligner(aa, genome, index, device=device,
                               n_threads=t, backend="native")
            text = st.align_chunk(pr, 0, pr.n)[0]      # warm
            ref = text if ref is None else ref
            best = None
            for _ in range(iters):
                t0 = time.perf_counter()
                text = st.align_chunk(pr, 0, pr.n)[0]
                wall = time.perf_counter() - t0
                if text != ref:
                    raise AssertionError("seedscan_scaling: %d threads give "
                                         "other SAM bytes than %d" % (
                                             t, threads[0]))
                p1 = [s for s in RECORDER.spans()
                      if s[1] == "staged.phase1"][-1]
                begin = (p1[6] - p1[5]) * 1e-9
                if best is None or begin < best[0]:
                    best = (begin, wall, p1[7])
            begin, wall, prof = best
            scan = prof["scan_hash_s"] + prof["scan_so_s"] + prof["scan_roa_s"]
            if scan <= 0:
                raise AssertionError("seedscan_scaling: the scan counters "
                                     "did not move")
            rows.append({
                "threads": t, "phase1_wall_s": begin, "chunk_wall_s": wall,
                "scan_cpu_s_thread_sum": scan,
                "scan_hash_so_roa_cpu_s": [prof["scan_hash_s"],
                                           prof["scan_so_s"],
                                           prof["scan_roa_s"]],
                "sort_cpu_s": prof["sort_s"], "f2c_cpu_s": prof["f2c_s"],
                "stage1_cpu_s": prof["stage1_s"],
                "scan_s_per_thread": scan / t,
                "hits": prof["hits"], "frags": prof["frags"],
                "clumps": prof["clumps"],
                "phase1_reads_per_s": pr.n / begin})
    finally:
        RECORDER.disable()
    base = rows[0]["phase1_wall_s"] * rows[0]["threads"]
    for r in rows:
        r["speedup_vs_t%d" % rows[0]["threads"]] = (
            base / rows[0]["threads"] / r["phase1_wall_s"])
        r["efficiency"] = base / r["phase1_wall_s"] / r["threads"]
    seeder = DeviceSeeder(aa, index, device=device)
    seeder.seed_chunk(pr, 0, pr.n)                  # warm
    seed_s = []
    for _ in range(iters):
        seeder.stats["seed_device_s"] = 0.0
        seeder.seed_chunk(pr, 0, pr.n)
        seed_s.append(seeder.stats["seed_device_s"])
    return {"rows": rows,
            "device_seeder": {"device": str(seeder.device),
                              "seed_device_s": min(seed_s),
                              "seed_device_s_all": seed_s,
                              "index_upload_s":
                                  seeder.stats["index_upload_s"],
                              "index_upload_bytes":
                                  seeder.stats["index_upload_bytes"]},
            "library": host.LIB_PATH}


def main(argv=None):
    import argparse
    from ..config import AlignmentArgs
    from ..io import native_loader
    from ..native import host
    ap = argparse.ArgumentParser(description="Phase-1 wall of the host "
                                 "seed scan by thread count, beside the "
                                 "device seeder.")
    ap.add_argument("--dir", default=HG_DIR,
                    help="big.nib2 + big.X15_01_65525S")
    ap.add_argument("-x", help="an index file, its .nib2 beside it "
                    "(in place of --dir)")
    ap.add_argument("--reads", type=int, default=4000)
    ap.add_argument("--len", dest="rlen", type=int, default=1000)
    ap.add_argument("--err", type=float, default=0.05)
    ap.add_argument("--threads", default="1,2,4,8")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    xpath = args.x or os.path.join(args.dir, "big.X15_01_65525S")
    gpath = os.path.splitext(xpath)[0] + ".nib2"
    genome = native_loader.load_genome(gpath)
    index = native_loader.load_index(xpath)
    aa = AlignmentArgs()
    aa.xfile_name, aa.qfile_name, aa.ofile_name = xpath, "reads.fa", "o"
    aa.post_process(True)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    pr = host.parse_queries_native(
        sample_reads(genome, args.reads, args.rlen, args.err), False,
        aa.max_query_length, aa.word_len)
    cores = os.cpu_count() or 1
    threads = [t for t in (int(x) for x in args.threads.split(","))
               if t <= cores] or [1]
    genome_bp = int(genome.max_roff)
    report = measure(aa, genome, index, pr, threads, args.iters,
                     args.device)
    report.update({
        "protocol": "staged native phase-1 wall (parse + seed scan + "
                    "chain + clumps) on %d x %d bp reads, L%d index, warm, "
                    "best of %d; the device seeder on the same reads"
                    % (pr.n, args.rlen, index.word_len, args.iters),
        "assets": {"index": xpath, "genome_bp": genome_bp,
                   "index_bytes": 4 * ((1 << 2 * index.word_len) + 1) +
                   4 * int(index.roa_len),
                   "cut": None if genome_bp > 1e9 else
                   "genome cut from %.1f Gbp to %.3f Gbp" % (
                       HG_GBP, genome_bp / 1e9)},
        "host_cores": cores})
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
