"""Per-query alignment pipeline (host oracle path, --engine oracle).

Frozen copy of the port's core/pipeline.py (yaha_tpu_torch).  Port of the processQueries
loop body (Query.c:255-497): hash both strands, form fragments, chain into
clumps, align + score, OQC/dup filter, emit.  This is the reference-exact
path; the native engine (native/yaha_pipe.cpp) transliterates the same
stage functions, and the staged engines batch its DPs on the device.
"""
from __future__ import annotations

import numpy as np

from ..rng import RandState, query_seed_state
from .. import sam
from .align import align_clump, score_clump
from .chain import process_strand
from .oqc import post_filter_by_similarity, post_filter_remove_dups


class QueryState:
    """Per-query state (QueryState_t, Math.h:586-666 analog)."""

    def __init__(self, aa, genome, index):
        self.aa = aa
        self.genome = genome
        self.index = index
        self.genome_codes = genome.codes
        self.max_roff = genome.max_roff
        self.coverage = np.zeros(aa.max_query_length, dtype=bool)
        self.rand_gen = RandState.default()
        self.clumps = []
        self.primary_count = 0
        self.reversed = False
        self.query_id = ""
        self.query_len = 0
        self.forward_buf = None
        self.forward_codes = None
        self.reverse_buf = None
        self.reverse_codes = None
        self.qual = None

    def find_seq_num(self, offset):
        return self.genome.find_seq_num(offset)

    def set_query(self, rec):
        self.query_id = rec.query_id
        self.query_len = rec.query_len
        self.forward_buf = rec.forward_buf
        self.forward_codes = rec.forward_codes
        self.reverse_buf = rec.reverse_buf
        self.reverse_codes = rec.reverse_codes
        self.qual = rec.qual
        self.clumps = []
        self.primary_count = 0
        # Per-query RNG seed from the read content (QueryState.c:171-187).
        self.rand_gen.set_state(query_seed_state(rec.forward_codes,
                                                 rec.query_len))

    def clump_query_codes(self, clump):
        return self.reverse_codes if clump.reversed else self.forward_codes

    def clump_query_buf(self, clump):
        return self.reverse_buf if clump.reversed else self.forward_buf

    def add_clump(self, clump):
        """addClump (QueryState.c:156-161): stamps current strand, prepends."""
        clump.reversed = self.reversed
        self.clumps.insert(0, clump)


def align_query(qs: QueryState, rec, stats=None) -> str:
    """Process one query; returns its output text (SAM/Blast8 lines)."""
    import time
    aa = qs.aa
    index = qs.index
    qs.set_query(rec)
    t0 = time.perf_counter() if stats is not None else 0.0
    seed_matches = 0

    for rev in (False, True):
        qs.reversed = rev
        codes = qs.reverse_codes if rev else qs.forward_codes
        seed_matches += process_strand(aa, qs, index, codes)

    # postProcessClumps (QueryMatch.c:306-331).
    clumps = qs.clumps
    qs.clumps = []
    for clump in clumps:
        align_clump(clump, aa, qs)
        score_clump(clump, aa, qs)
        if clump.scored:
            qs.clumps.insert(0, clump)

    if aa.oqc:
        post_filter_by_similarity(aa, qs)
    else:
        post_filter_remove_dups(aa, qs)

    out = []
    for clump in qs.clumps:
        out.append(sam.print_clump(clump, aa, qs))
    if stats is not None:
        usec = int((time.perf_counter() - t0) * 1e6)
        stats.write("%s\t%d\t%d\t%d\t%d\n" % (
            qs.query_id, qs.query_len, seed_matches, len(qs.clumps), usec))
    return "".join(out)


def run_query_chunks(aa, genome, index, chunks, out_stream) -> int:
    """Streaming oracle loop: `chunks` yields (bytes, fastq) pieces
    that start at record boundaries (cli._iter_query_chunks), so a
    multi-GB FASTQ aligns at bounded RSS — the batched analog of
    readNextQuery's per-read streaming (Query.c:102-228)."""
    from .. import fasta
    qs = QueryState(aa, genome, index)
    n = 0
    header_done = False
    stats = None
    qs_name = getattr(aa, "qs_file_name", None)
    if qs_name:
        stats = open(qs_name, "w")
        stats.write("query\tlen\tseedMatches\talignments\tusec\n")
    try:
        for query_data, fastq in chunks:
            aa.fastq = fastq
            if not header_done:
                out_stream.write(sam.file_header(aa, genome))
                header_done = True
            for rec in fasta.read_queries(query_data, aa):
                out_stream.write(align_query(qs, rec, stats=stats))
                n += 1
            if getattr(aa, "stopped", False):
                break   # zero-length record ends the run (Query.c:306)
    finally:
        if stats is not None:
            stats.close()
    return n
