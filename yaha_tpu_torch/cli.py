"""Command line of the PyTorch/CUDA port: ``python -m yaha_tpu_torch.cli``.

Counterpart of yaha_tpu/cli.py, with the reference's four operations
(Main.c:187-671) selected by the same flags, the same file-name derivation
(.nib2, .X{LL}_{SS}_{HHHHH}S) and the same validation messages:

  -g genome.fa [-L -S -H -t -v]   index (compressing the FASTA first when its
                                  .nib2 is missing or older)
  -g genome.fa -c / -g g.nib2 -u  compress / uncompress
  -x index -q reads ...           align, with the reference flag set plus:

  --engine batch-cuda   the staged engine with its DP on the card (the
                        default): the genome stays on the card, every DP
                        problem is assembled there, and the backtrack walk
                        runs there, so only run-length items come back (the
                        JAX package's default batch-pallas configuration).
                        YT_STAGED_DEVRES=0 fetches problems on the host and
                        YT_STAGED_RLE=0 brings the planes back to the
                        native walkers (A/B configurations).
  --engine batch-torch  the staged engine with the lockstep DPs of
                        ops/sw_batch.py in PyTorch ops on the --device (the
                        JAX package's batch-xla): eo/idc planes back to the
                        native apply.
  --engine native       the per-read native C++ pipeline
                        (native/host.align_batch_native); no device.
  --engine oracle       the reference-exact Python aligner (core/), its
                        DPs, chain DP and seed-to-clump front end in the
                        native library; no device.
  --device cuda|cpu     where the staged engines' DP runs (default cuda);
                        cpu runs the kernels' plain PyTorch versions (and
                        batch-torch's ops on the CPU).  With cuda and no
                        card the run stops with an error.
  --seed host|device    where the seed scan of a staged engine runs
                        (default host, the native library); device hashes
                        and expands every read's seeds on the --device
                        against the index resident there (models/seeder.py).
  --trace DIR           a torch.profiler trace of the align loop (CPU ops
                        of every thread, and the card's kernels and copies
                        with --device cuda), written to DIR as a Chrome
                        trace; the batches keep their prefetch schedule
  --model-shards N      shard the k-mer index by hash range over N columns
                        of a local (data x model) grid of the --device
                        kind's devices (parallel/mesh.py); implies --seed
                        device.  N is a power of two (it divides the
                        index's 4^L hashes).  n local devices give data = max(1, n // N)
                        rows; n > N must be a multiple of N, and with fewer
                        devices than N the shards share them (one card, or
                        the CPU, holds every shard)
  --coordinator HOST:PORT, --num-hosts N, --host-id I
                        a run over N processes (hosts): each runs the same
                        command with its own --host-id in [0, N), aligns its range of
                        the query file into OUT.partIIIII, and after a
                        barrier host 0 writes OUT from the parts in host
                        order (parallel/distributed.py; a gloo group at
                        host 0's HOST:PORT)
  --prewarm             accepted and does nothing: nothing is cached

--engine native and --engine oracle ignore --model-shards and the three
host flags, as the reference's do.

The host work runs in the port's own native library (native/host.py).
"""
from __future__ import annotations

import os
import re
import struct
import sys

from .config import AlignmentArgs

ENGINES = ("batch-cuda", "batch-torch", "native", "oracle")
DEVICES = ("cuda", "cpu")

_INT_FLAGS = {
    "-t": "num_threads", "-H": "max_hits", "-BW": "band_width",
    "-G": "max_gap", "-M": "min_match", "-MD": "max_desert",
    "-X": "x_cutoff", "-GEC": "ge_cost", "-GOC": "go_cost",
    "-MS": "m_score", "-RC": "r_cost", "-BP": "bp_cost",
    "-MGDP": "max_bp_log", "-MNO": "oqc_min_non_overlap",
    "-I": "max_intron", "-R": "min_raw_score", "-L": "word_len",
    "-S": "skip_dist", "--batch-size": "batch_size",
    "--max-query-length": "max_query_length",
    "--max-region-frags": "max_region_frags",
    "--model-shards": "model_shards", "--num-hosts": "num_hosts",
    "--host-id": "host_id",
}
_FLOAT_FLAGS = {"-P": "min_identity", "-PRL": "fbs_ps_length",
                "-PSS": "fbs_ps_score"}
_BOOL_FLAGS = {"-AGS": "affine_gap_scoring", "-OQC": "oqc", "-FBS": "fbs"}
_STR_FLAGS = {"-x": "xfile_name", "-q": "qfile_name", "-qs": "qs_file_name",
              "-g": "gfile_name", "--trace": "trace_dir",
              "--coordinator": "coordinator"}
_SWITCHES = {"-v": "verbose", "--prewarm": "prewarm", "--resume": "resume"}

USAGE = """\
yaha_tpu_torch: split-read DNA aligner, DP phases on an NVIDIA GPU

Create an index:
  python -m yaha_tpu_torch.cli -g <genomeFile (fa|fasta|fna|nib2)>
           [-L wordLen] [-S skipDist] [-H maxHits] [-t threads] [-v]
Compress / uncompress a genome:
  python -m yaha_tpu_torch.cli -g <file> -c | -u
Align queries:
  python -m yaha_tpu_torch.cli -x <indexFile> -q <queryFile (fa|fastq)>
           [-osh|-oss|-o8 <outFile>] [reference options]
           [--engine batch-cuda|batch-torch|native|oracle]
           [--device cuda|cpu]
           [--seed host|device] [--trace DIR] [--batch-size N]
           [--max-query-length N] [--max-region-frags N] [--resume]
           [--model-shards N] [--coordinator HOST:PORT --num-hosts N
            --host-id I]
--engine batch-cuda (the default) assembles the DP problems and walks
their backtrack planes on the device; YT_STAGED_DEVRES=0 /
YT_STAGED_RLE=0 select the host-fetch / plane-transfer A/B
configurations.  batch-torch runs the DPs as PyTorch ops on the device;
native runs the per-read C++ pipeline with no device, and oracle the
reference-exact Python aligner with no device.  --seed device
runs a staged engine's seed scan on the device as well.  --trace DIR
writes a torch.profiler trace of the align loop into DIR.
--model-shards N shards the index by hash range over N columns of a
local (data x model) grid of the --device kind's devices (implies --seed
device; N a power of two): n local devices give max(1, n // N) data rows, n > N must be a
multiple of N, and with fewer devices than N the shards share them.
--coordinator/--num-hosts/--host-id run the staged engines over N
processes, host ids 0 to N - 1: each aligns its range of the reads into a part file, and host
0 merges the parts after a barrier (gloo).  --engine native and --engine
oracle ignore these four flags."""


def _fail(msg):
    print(msg, file=sys.stderr)
    sys.exit(1)


# ---- flag values, with the reference's C parsing (Main.c uses atoi/atof) --

def _parse_bool(s, key):
    if len(s) == 1:
        if s in "YyTt":
            return True
        if s in "NnFf":
            return False
    _fail("%s is not a valid value for parameter %s." % (s, key))


def _atoi(s):
    """C atoi: leading whitespace, optional sign, digit prefix; 0 when
    there is no number."""
    m = re.match(r"\s*([+-]?\d+)", s)
    return int(m.group(1)) if m else 0


def _atof(s):
    """C atof: numeric prefix, 0.0 when there is no number."""
    m = re.match(r"\s*([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)", s)
    return float(m.group(1)) if m else 0.0


def _parse_int(s, key):
    v = _atoi(s)
    if v < 0:
        _fail("%s is not a valid value for parameter %s." % (s, key))
    return v


def _parse_float(s, key):
    v = _atof(s)
    if v <= 0.0 or v > 1.0:
        _fail("%s is not a valid value for parameter %s." % (s, key))
    # The reference stores minIdentity/FBS_PSLength/FBS_PSScore as
    # single-precision floats (Math.h:292,314-315): round as it does.
    return struct.unpack("f", struct.pack("f", v))[0]


def parse_args(argv):
    """Parse a command line into (AlignmentArgs, device, operation), the
    operation one of "query", "compress", "uncompress", "index"."""
    aa = AlignmentArgs()
    device = "cuda"
    ops = set()
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in _SWITCHES:
            setattr(aa, _SWITCHES[a], True)
            i += 1
            continue
        if a in ("-c", "-u"):
            ops.add("compress" if a == "-c" else "uncompress")
            i += 1
            continue
        if i + 1 >= len(argv):
            _fail("%s is not a valid option.\n" % a)
        val = argv[i + 1]
        if a in _INT_FLAGS:
            setattr(aa, _INT_FLAGS[a], _parse_int(val, a))
        elif a in _FLOAT_FLAGS:
            setattr(aa, _FLOAT_FLAGS[a], _parse_float(val, a))
        elif a in _BOOL_FLAGS:
            setattr(aa, _BOOL_FLAGS[a], _parse_bool(val, a))
        elif a in _STR_FLAGS:
            setattr(aa, _STR_FLAGS[a], val)
            if a in ("-x", "-q"):
                ops.add("query")
        elif a in ("-osh", "-oss", "-o8"):
            aa.output_blast8 = a == "-o8"
            aa.output_sam = a != "-o8"
            if a != "-o8":
                aa.hard_clip = a == "-osh"
            aa.ofile_name = val
        elif a == "--engine":
            if val not in ENGINES:
                _fail("--engine must be one of: %s" % ", ".join(ENGINES))
            aa.engine = val
        elif a == "--device":
            if val not in DEVICES:
                _fail("--device must be one of: %s" % ", ".join(DEVICES))
            device = val
        elif a == "--seed":
            if val not in ("host", "device"):
                _fail("--seed must be host or device")
            aa.seed = val
        else:
            _fail("%s is not a valid option.\n" % a)
        i += 2
    _check_scale_flags(aa)
    # The reference's order: compress, uncompress, query, index.
    op = next((o for o in ("compress", "uncompress", "query") if o in ops),
              "index")
    if "query" in ops:
        if aa.xfile_name is None:
            _fail("Index file specification (-x) is required for query "
                  "alignment.")
        aa.gfile_name = os.path.splitext(aa.xfile_name)[0] + ".nib2"
        if op == "query" and aa.ofile_name is None:
            aa.output_blast8 = False
            aa.output_sam = True
            aa.hard_clip = True
            aa.ofile_name = "stdout"
    elif os.path.splitext(aa.gfile_name or "")[1] not in (
            ".fna", ".fa", ".fasta", ".nib2"):
        _fail('Expecting a ".fa", ".fna", ".fasta", or ".nib2" genome '
              'file.')
    base = os.path.splitext(aa.gfile_name)[0]
    aa.ofile_name = {"uncompress": base + ".fasta",
                     "compress": base + ".nib2"}.get(op, aa.ofile_name)
    aa.post_process("query" in ops)
    if op == "index":
        aa.xfile_name = os.path.splitext(aa.gfile_name)[0] + (
            ".X%02d_%02d_%05dS" % (aa.word_len, aa.skip_dist, aa.max_hits))
    return aa, device, op


def _check_scale_flags(aa):
    """Refuse a shard or host count below 1, a host id outside [0,
    --num-hosts) and several hosts without --coordinator."""
    shards = getattr(aa, "model_shards", 1)
    hosts = getattr(aa, "num_hosts", 1)
    host_id = getattr(aa, "host_id", 0)
    if shards < 1:
        _fail("--model-shards must be at least 1, got %d." % shards)
    if hosts < 1:
        _fail("--num-hosts must be at least 1, got %d." % hosts)
    if not 0 <= host_id < hosts:
        _fail("--host-id must be in [0, %d) for --num-hosts %d, got %d."
              % (hosts, hosts, host_id))
    if hosts > 1 and not getattr(aa, "coordinator", None):
        _fail("--num-hosts %d needs --coordinator HOST:PORT (host 0's "
              "address)." % hosts)


# ---- compress, uncompress, index ----

def _do_compress(aa):
    from .native import host
    host.compress_fasta_file(aa.gfile_name, aa.ofile_name)


def _load_nib2(path):
    from .io import nib2
    with open(path, "rb") as f:
        return nib2.load(f.read())


def _do_uncompress(aa):
    from .io import nib2
    genome = _load_nib2(aa.gfile_name)
    with open(aa.ofile_name, "wb") as f:
        f.write(nib2.uncompress_to_fasta(genome))


def _do_index(aa):
    if aa.word_len > 15:
        _fail("Word Length (-L) for index creation is currently restricted "
              "to < 16.")
    if aa.skip_dist < 1 or aa.skip_dist > aa.word_len:
        _fail("Skip Distance (-S) for index creation must be between 1 and "
              "WordLength (inclusive).")
    from .io import index_io
    from .native import host
    if not aa.gfile_name.endswith(".nib2"):
        # Index a FASTA through its .nib2, compressed first when missing
        # or older than the FASTA.
        nib2_name = os.path.splitext(aa.gfile_name)[0] + ".nib2"
        if (not os.path.exists(nib2_name) or os.path.getmtime(
                aa.gfile_name) > os.path.getmtime(nib2_name)):
            aa.ofile_name = nib2_name
            _do_compress(aa)
        aa.gfile_name = nib2_name
    genome = _load_nib2(aa.gfile_name)
    # Threaded native builder (yaha_index.cpp); -t sets the scan threads.
    so, roa, tm = host.build_index(genome, aa.word_len, aa.skip_dist,
                                   aa.max_hits,
                                   n_threads=max(aa.num_threads, 4))
    if aa.verbose:
        index_io.print_count_statistics(so, aa.word_len)
    index_io.write_index(aa.xfile_name, aa.word_len, aa.max_hits, so, roa,
                         tm)
    print("Index %s created." % aa.xfile_name, file=sys.stderr)


# ---- query streaming ----

def _find_chunk_cut(data, fastq):
    """Byte offset of the last record start in `data`, or -1.

    FASTA: the last "\\n>".  FASTQ: the last "\\n@" that opens a plausible
    record (a line starting with '+' follows the id line within a few
    lines), as readNextQuery's own '@'-after-newline terminator
    (Query.c:177-198).
    """
    if not fastq:
        p = data.rfind(b"\n>")
        return p + 1 if p >= 0 else -1
    pos = len(data)
    for _ in range(16):
        p = data.rfind(b"\n@", 0, pos)
        if p < 0:
            return -1
        start = p + 1
        nl1 = data.find(b"\n", start)
        if nl1 >= 0:
            q = nl1 + 1
            for _ in range(64):
                if data[q:q + 1] == b"+":
                    return start
                e = data.find(b"\n", q)
                if e < 0:
                    break
                q = e + 1
        pos = p
    return -1


def _iter_query_chunks(path, block_size=64 << 20):
    """Stream (chunk_bytes, fastq) pieces that start at record boundaries;
    memory is bounded by block_size + one record.  Each block read is a
    `stream.read` span."""
    from .utils.timing import span
    with open(path, "rb") as f:
        with span("stream.read"):
            first = f.read(1)
            fastq = first == b"@"
            carry = first + f.read(block_size)
        while True:
            with span("stream.read"):
                nxt = f.read(block_size)
            if not nxt:
                if carry:
                    yield carry, fastq
                return
            data = carry + nxt
            cut = _find_chunk_cut(data, fastq)
            if cut <= 0:
                carry = data       # no boundary yet: grow
                continue
            yield data[:cut], fastq
            carry = data[cut:]


def _run_native_engine(aa, genome, align_fn, dp_stats, seed_stats=None,
                       read_range=None, write_header=True):
    """The streaming query loop: the file streams through bounded chunks,
    each parsed natively and aligned in batches by `align_fn(pr, lo, hi,
    dist, want_stats) -> (text, stats, seed_matches, records)`; output is
    emitted per batch by a writer thread, with the --resume cursor.  With
    YT_STAGED_PREFETCH on (default), batch k+1's host phases overlap
    batch k, traced (--trace) or not.  The loop's spans (utils/timing):
    stream.read and stream.parse, stream.wait on a batch's result and
    stream.put into the writer's queue on the calling thread, stream.emit
    on the writer, and each batch's root span `align` (its sequence
    number as the batch id, its reads) on the thread that aligns it.
    `dp_stats` is a staged engine's
    launch/byte accounting (None for the native engine) and `seed_stats`
    the device seeder's (or None), reported under -v.  `read_range`
    restricts the run to the file's reads [lo, hi) (a host's share of a
    multi-host run); `write_header` off leaves the SAM header out (a part
    file's; host 0 writes it at the merge)."""
    import concurrent.futures as cf
    import ctypes as ct
    import queue
    import threading
    import time
    from collections import deque

    from .io import sam
    from .native import host
    from .utils.timing import span

    with open(aa.qfile_name, "rb") as f:
        aa.fastq = f.read(1) == b"@"
    batch_size = getattr(aa, "batch_size", 0) or 65536
    cursor_path = aa.ofile_name + ".cursor"
    start_read = 0
    mode = "w"
    if getattr(aa, "resume", False) and os.path.exists(cursor_path):
        with open(cursor_path) as f:
            fields = f.read().split()
        start_read = int(fields[0]) if fields else 0
        cursor_bytes = int(fields[1]) if len(fields) > 1 else None
        if cursor_bytes is not None and os.path.exists(aa.ofile_name):
            with open(aa.ofile_name, "r+b") as tf:
                tf.truncate(cursor_bytes)
        mode = "a"
        print("Resuming at read %d." % start_read, file=sys.stderr)
    t_loop = time.perf_counter_ns()
    # The -v report's stage seconds (the writer adds "emit").
    totals = {"parse": 0.0, "emit": 0.0}
    out = (sys.stdout.buffer if aa.ofile_name in ("stdout", "-")
           else open(aa.ofile_name, mode + "b"))
    emit_q = queue.Queue(maxsize=2)
    emit_err = []
    n = start_read

    def _writer():
        while True:
            item = emit_q.get()
            if item is None:
                return
            text, n_done = item
            try:
                with span("stream.emit", bytes=len(text)) as sp:
                    t0 = sp.start()
                    out.write(text)
                    out.flush()
                    if n_done is not None and out is not sys.stdout.buffer:
                        with open(cursor_path, "w") as f:
                            f.write("%d %d" % (n_done, out.tell()))
                    totals["emit"] += sp.stop(t0)
            except Exception as e:          # pragma: no cover
                emit_err.append(e)
                while True:
                    if emit_q.get() is None:
                        return

    writer = threading.Thread(target=_writer, daemon=True)
    writer.start()
    done = 0
    qs_name = getattr(aa, "qs_file_name", None)
    qs_file = open(qs_name, "w") if qs_name else None
    if qs_file:
        qs_file.write("query\tlen\tseedMatches\talignments\tusec\n")
    seed_total = 0
    rec_total = 0
    dist_acc = [0, 0, (1 << 62), 0, 0, (1 << 62), 0, 0, 0, (1 << 62), -1] \
        if aa.verbose else None
    rlo, rhi = read_range if read_range is not None else (0, None)
    eff_start = max(start_read, rlo)

    def _batches():
        nonlocal done
        for chunk, fastq in _iter_query_chunks(aa.qfile_name):
            if rhi is not None and done >= rhi:
                return   # this host's read range is done
            with span("stream.parse", bytes=len(chunk)) as sp:
                t0 = sp.start()
                pr = host.parse_queries_native(
                    chunk, fastq, aa.max_query_length, aa.word_len)
                totals["parse"] += sp.stop(t0)
                sp.add(reads=pr.n)
            base = done
            done += pr.n
            for lo in range(0, pr.n, batch_size):
                hi = min(lo + batch_size, pr.n)
                if rhi is not None:
                    hi = min(hi, rhi - base)
                if hi <= lo:
                    break
                if base + hi <= eff_start:
                    continue   # resume, or before this host's range
                # Partial overlap (e.g. a different --batch-size than
                # the interrupted run): start inside the batch.
                yield pr, max(lo, eff_start - base), hi, base + hi
            if pr.stopped:
                # Reference semantics: a zero-length record ends the
                # run (Query.c:306).
                return

    def _align_one(seq, pr, lo, hi):
        dist = (ct.c_int64 * 11)() if dist_acc is not None else None
        with span("align", batch=seq, reads=hi - lo):
            text, stats, sm, nr = align_fn(pr, lo, hi, dist=dist,
                                           want_stats=qs_file is not None)
        return text, stats, sm, nr, dist

    def _wait(fut, seq):
        with span("stream.wait", batch=seq):
            return fut.result()

    def _consume(res, n_done, seq):
        nonlocal n, seed_total, rec_total
        text, stats, sm, nr, dist = res
        seed_total += sm
        rec_total += nr
        if dist is not None:
            for k in (0, 1, 4, 7, 8):           # sums
                dist_acc[k] += dist[k]
            for k in (2, 5, 9):                 # mins
                dist_acc[k] = min(dist_acc[k], dist[k])
            for k in (3, 6, 10):                # maxes
                dist_acc[k] = max(dist_acc[k], dist[k])
        if stats is not None:
            qs_file.write(stats.decode("latin-1"))
        if emit_err:
            raise emit_err[0]
        n = n_done
        with span("stream.put", batch=seq):
            emit_q.put((text, n))

    prefetch = os.environ.get("YT_STAGED_PREFETCH", "1") != "0"
    try:
        if start_read == 0 and write_header:
            emit_q.put((sam.file_header(aa, genome).encode("latin-1"),
                        None))
        if prefetch:
            # Depth-2 batch pipeline: the host phases of batch k+1 overlap
            # batch k's device DP.  Batches are consumed in submission
            # order, so output order and the resume cursor are unchanged.
            ex = cf.ThreadPoolExecutor(max_workers=2)
            try:
                pending = deque()
                for seq, (pr, lo, hi, n_done) in enumerate(_batches()):
                    pending.append(
                        (ex.submit(_align_one, seq, pr, lo, hi), n_done,
                         seq))
                    if len(pending) > 1:
                        fut, nd, sq = pending.popleft()
                        _consume(_wait(fut, sq), nd, sq)
                while pending:
                    fut, nd, sq = pending.popleft()
                    _consume(_wait(fut, sq), nd, sq)
            finally:
                ex.shutdown(wait=True)
        else:
            for seq, (pr, lo, hi, n_done) in enumerate(_batches()):
                _consume(_align_one(seq, pr, lo, hi), n_done, seq)
        emit_q.put(None)
        writer.join()
        if emit_err:
            raise emit_err[0]
        if aa.verbose:
            _report(totals, (time.perf_counter_ns() - t_loop) * 1e-9,
                    n - eff_start, seed_total, rec_total, dp_stats,
                    dist_acc, seed_stats)
    finally:
        if writer.is_alive():
            try:
                emit_q.put_nowait(None)
            except queue.Full:
                pass
            writer.join(timeout=30)
        if qs_file:
            qs_file.close()
        if out is not sys.stdout.buffer:
            out.close()
            target = done if rhi is None else min(rhi, done)
            if os.path.exists(cursor_path) and n >= target:
                os.unlink(cursor_path)


def _report(totals, loop_s, emitted, seed_total, rec_total, dp_stats,
            dist_acc, seed_stats=None):
    """The -v run summary (the STATS compile-switch analog,
    Query.c:519-536): the parse and the writer's emit (a thread of its
    own, overlapping the rest) against the loop's wall, the throughput
    over that wall, the device DP's launch/byte budget and dispatch time
    (the part blocked on the card's results apart), and the device
    seeder's."""
    for name, secs in totals.items():
        pct = 100.0 * secs / loop_s if loop_s > 0 else 0.0
        print("%-42s %8.3fs (%5.1f%%)" % (name + " took:", secs, pct),
              file=sys.stderr)
    print("%-42s %8.3fs" % ("total:", loop_s), file=sys.stderr)
    print("Processed %d reads: %d seed matches, %d alignments printed."
          % (emitted, seed_total, rec_total), file=sys.stderr)
    if loop_s > 0 and emitted > 0:
        print("Throughput: %.0f reads/s." % (emitted / loop_s),
              file=sys.stderr)
    if dp_stats is not None:
        print("Device DP: %d launches, %d gap + %d ext problems, %.1f MB "
              "h2d, %.1f MB d2h; %.2fs in the dispatch, %.2fs of it "
              "blocked on the card's results; %d gap problems too wide "
              "for the kernels, on the lockstep twin."
              % (dp_stats["dp_launches"], dp_stats["gap_problems"],
                 dp_stats["ext_problems"], dp_stats["h2d_bytes"] / 1e6,
                 dp_stats["d2h_bytes"] / 1e6, dp_stats["device_s"],
                 dp_stats["dispatch_wait_s"], dp_stats["gap_twin"]),
              file=sys.stderr)
    if seed_stats is not None:
        print("Device seed: %d launches, %.1f MB h2d, %.1f MB d2h, %.1f MB "
              "gathered from index shards, %d retries, %d phantom rows, %d "
              "host-scan rows, %.2fs; index %.1f MB placed in %.2fs."
              % (seed_stats["seed_launches"],
                 seed_stats["seed_h2d_bytes"] / 1e6,
                 seed_stats["seed_d2h_bytes"] / 1e6,
                 seed_stats["all_gather_bytes"] / 1e6,
                 seed_stats["cap_retries"], seed_stats["phantom_rows"],
                 seed_stats["fallback_rows"], seed_stats["seed_device_s"],
                 seed_stats["index_upload_bytes"] / 1e6,
                 seed_stats["index_upload_s"]), file=sys.stderr)
    if dist_acc[0] <= 0:
        return
    q, qlt, qlmin, qlmax = dist_acc[0:4]
    ct_, cmin, cmax, nonal = dist_acc[4:8]
    cl, clmin, clmax = dist_acc[8:11]
    print("%d queries processed." % q, file=sys.stderr)
    print("Query Lengths vary from %d to %d with average %d."
          % (qlmin, qlmax, qlt // q), file=sys.stderr)
    print("Total Counts vary from %d to %d with average %d."
          % (cmin if cmin < (1 << 62) else 0, cmax, ct_ // (2 * q)),
          file=sys.stderr)
    print("There were %d queries with no Alignment." % nonal,
          file=sys.stderr)
    if cl <= 0:
        print("No Alignments found.", file=sys.stderr)
        return
    print("Total Alignments Output = %d, average %4.2f per non-zero query."
          % (cl, cl / (q - nonal)), file=sys.stderr)
    print("Of those queries with an alignment, the min number of "
          "alignments was %d." % clmin, file=sys.stderr)
    print("The max number of alignments per query was %d." % clmax,
          file=sys.stderr)


def _take_index_params(aa, index):
    """The run's word length is the index's; a -H above the index's
    maxHits is lowered to it, with the reference's warning."""
    aa.word_len = index.word_len
    if index.max_hits < aa.max_hits:
        print("WARNING: Index file made with maxHits of %d, while %d "
              "specified for this query run.\nMimimum of two (%d) will be "
              "used." % (index.max_hits, aa.max_hits, index.max_hits),
              file=sys.stderr)
        aa.max_hits = index.max_hits


def _do_query(aa, device):
    engine = getattr(aa, "engine", "batch-cuda")
    seed = getattr(aa, "seed", "host")
    if engine in ("native", "oracle"):
        if seed == "device":
            _fail("--seed device runs in a staged engine (batch-cuda or "
                  "batch-torch), not in --engine %s." % engine)
    else:
        import torch
        if device == "cuda" and not torch.cuda.is_available():
            _fail("--device cuda: no CUDA device is available (torch %s); "
                  "use --device cpu to run the DP on the host." %
                  torch.__version__)
    if getattr(aa, "prewarm", False):
        return
    if engine == "oracle":
        _run_oracle(aa)
        return
    from .io import native_loader
    from .utils.timing import device_trace
    genome = native_loader.load_genome(aa.gfile_name)
    index = native_loader.load_index(aa.xfile_name)
    _take_index_params(aa, index)
    if engine == "native":
        from .native import host

        def _native(pr, lo, hi, dist=None, want_stats=False):
            return host.align_batch_native(
                pr, lo, hi, genome, index, aa, n_threads=aa.num_threads,
                want_stats=want_stats, dist=dist)
        with device_trace(getattr(aa, "trace_dir", None)):
            _run_native_engine(aa, genome, _native, None)
        return
    from .models.staged import StagedAligner
    if not getattr(aa, "batch_size", 0):
        aa.batch_size = 16384
    mshards = getattr(aa, "model_shards", 1)
    if (4 ** aa.word_len) % mshards:
        _fail("--model-shards %d does not divide the %d hashes of the L%d "
              "index (it must be a power of two up to 4^%d)."
              % (mshards, 4 ** aa.word_len, aa.word_len, aa.word_len))
    # The usage errors come before a host joins the group.
    mesh = local_mesh(device, mshards) if mshards > 1 else None
    num_hosts = getattr(aa, "num_hosts", 1)
    read_range = merged_ofile = None
    if num_hosts > 1:
        # Reads range-shard over the hosts; each writes a part file and
        # host 0 merges the parts in host order after the run.
        from .parallel import distributed as dist
        dist.initialize(getattr(aa, "coordinator", None), num_hosts,
                        getattr(aa, "host_id", 0))
        read_range = dist.host_read_range(_count_records(aa))
        merged_ofile = aa.ofile_name
        aa.ofile_name = dist.part_file_name(merged_ofile)
        aa.resume = False
    # The trace holds the set-up too: the seeder's and the corpus's
    # uploads (setup.* spans).
    with device_trace(getattr(aa, "trace_dir", None), device):
        seeder = None
        if seed == "device" or mshards > 1:
            from .models.seeder import DeviceSeeder
            if mesh is not None:
                device = mesh.grid[0][0]
                seeder = DeviceSeeder(aa, index, mesh=mesh)
            else:
                seeder = DeviceSeeder(aa, index, device=device)
        aligner = StagedAligner(aa, genome, index, device=device,
                                n_threads=aa.num_threads, seeder=seeder,
                                backend="torch" if engine == "batch-torch"
                                else "cuda")

        def _align(pr, lo, hi, dist=None, want_stats=False):
            if want_stats:
                text, sm, nr, stats = aligner.align_chunk(
                    pr, lo, hi, dist=dist, want_stats=True)
                return text, stats, sm, nr
            text, sm, nr = aligner.align_chunk(pr, lo, hi, dist=dist)
            return text, None, sm, nr
        _run_native_engine(aa, genome, _align, aligner.stats,
                           seeder.stats if seeder else None,
                           read_range=read_range,
                           write_header=num_hosts == 1)
    if num_hosts > 1:
        _multihost_merge(aa, genome, merged_ofile)


def _run_oracle(aa):
    """--engine oracle: the genome and index loaded into numpy (io/nib2,
    io/index_io), the query file streamed in record-aligned chunks through
    core/pipeline.run_query_chunks."""
    from .core import pipeline
    from .io import index_io
    genome = _load_nib2(aa.gfile_name)
    index = index_io.load_index(aa.xfile_name)
    _take_index_params(aa, index)
    chunks = _iter_query_chunks(aa.qfile_name)
    if aa.ofile_name in ("stdout", "-"):
        pipeline.run_query_chunks(aa, genome, index, chunks, sys.stdout)
    else:
        with open(aa.ofile_name, "w") as out:
            pipeline.run_query_chunks(aa, genome, index, chunks, out)


def local_mesh(device, n_model, n_local=None):
    """The (data x model) grid of --model-shards n_model over the local
    devices of the `device` kind (n_local of them: every visible card for
    cuda, one CPU): data = max(1, n_local // n_model) rows.  More devices
    than n_model must be a multiple of it, as the reference requires;
    fewer share the shards (parallel/mesh.make_mesh)."""
    import torch
    from .parallel import mesh as pmesh
    if n_local is None:
        n_local = torch.cuda.device_count() if device == "cuda" else 1
    if n_local > n_model and n_local % n_model:
        _fail("--model-shards %d does not divide the %d local devices."
              % (n_model, n_local))
    devices = (["cuda:%d" % k for k in range(n_local)] if device == "cuda"
               else ["cpu"] * n_local)
    return pmesh.make_mesh(devices[:max(1, n_local // n_model) * n_model],
                           n_model)


def _count_records(aa):
    """The query file's read count, by the same native parse every host
    runs, so that the hosts' ranges tile it exactly."""
    from .native import host
    total = 0
    for chunk, fastq in _iter_query_chunks(aa.qfile_name):
        pr = host.parse_queries_native(chunk, fastq, aa.max_query_length,
                                       aa.word_len)
        total += pr.n
        if pr.stopped:
            break
    return total


def _multihost_merge(aa, genome, merged_ofile):
    """The barrier (an all_reduce of ones over the gloo group), then host 0
    concatenates the parts in host order under the header, whose @PG line
    names the merged file."""
    from .io import sam
    from .parallel import distributed as dist
    try:
        n = dist.barrier()
        if dist.rank() == 0:
            aa.ofile_name = merged_ofile
            dist.merge_part_files(merged_ofile, n,
                                  sam.file_header(aa, genome))
    finally:
        dist.shutdown()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if any(a in ("-h", "-?", "-xh") for a in argv):
        print(USAGE, file=sys.stderr)
        return 0
    aa, device, op = parse_args(argv)
    {"query": lambda: _do_query(aa, device),
     "compress": lambda: _do_compress(aa),
     "uncompress": lambda: _do_uncompress(aa),
     "index": lambda: _do_index(aa)}[op]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
