"""Align reads with the reference: the frozen pure-Python oracle, read by
read, over the reference's own index, the reads shared out among worker
processes.

`alignment_args` reads a configuration's query flags with the CLI's flag
table (a frozen copy of the parts of the port's cli.py that query flags
use) and applies the index's word length and maxHits as a query run does.
`align` returns each read's output text, the SAM records yaha 0.1.83
writes for it (none for a read that does not align).

A read's records depend on that read alone (QueryState is reset for each
read and its RNG seeded from the read's codes), so the reads are aligned
one a task by up to MAX_WORKERS processes and merged in file order, byte
for byte what one loop over them gives.  The workers are forked: the
caller may hold a CUDA context, which they never touch (they run the
reference's numpy code alone), and the genome, the index and the parsed
reads reach them copy-on-write rather than pickled.  Where fork is not
available, or one CPU is, the reads are aligned in the caller.
"""
from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import fasta
from .config import AlignmentArgs
from .core.pipeline import QueryState, align_query
from .genome import Genome

INT_FLAGS = {
    "-t": "num_threads", "-H": "max_hits", "-BW": "band_width",
    "-G": "max_gap", "-M": "min_match", "-MD": "max_desert",
    "-X": "x_cutoff", "-GEC": "ge_cost", "-GOC": "go_cost",
    "-MS": "m_score", "-RC": "r_cost", "-BP": "bp_cost",
    "-MGDP": "max_bp_log", "-MNO": "oqc_min_non_overlap",
    "-I": "max_intron", "-R": "min_raw_score",
    "--max-query-length": "max_query_length",
}
FLOAT_FLAGS = {"-P": "min_identity", "-PRL": "fbs_ps_length",
               "-PSS": "fbs_ps_score"}
BOOL_FLAGS = {"-AGS": "affine_gap_scoring", "-OQC": "oqc", "-FBS": "fbs"}


def alignment_args(flags, index) -> AlignmentArgs:
    """The run configuration of `flags` (pairs of flag and value) against
    `index`, SAM output with hard clips (-osh)."""
    aa = AlignmentArgs()
    for k in range(0, len(flags), 2):
        flag, val = flags[k], flags[k + 1]
        if flag in INT_FLAGS:
            setattr(aa, INT_FLAGS[flag], int(val))
        elif flag in FLOAT_FLAGS:
            # the reference's float fields, rounded to float32
            setattr(aa, FLOAT_FLAGS[flag], float(np.float32(val)))
        elif flag in BOOL_FLAGS and val in ("Y", "y", "T", "t", "N", "n",
                                             "F", "f"):
            setattr(aa, BOOL_FLAGS[flag], val in "YyTt")
        else:
            raise ValueError("the reference does not take %s" % flag)
    aa.post_process(True)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    aa.output_sam, aa.output_blast8, aa.hard_clip = True, False, True
    return aa


def genome(names, starts, lengths, codes) -> Genome:
    return Genome(names=list(names),
                  starting_offsets=np.asarray(starts, np.int64),
                  lengths=np.asarray(lengths, np.int64), codes=codes)


MAX_WORKERS = 8
# A worker's QueryState and parsed reads, set by _start in the forked
# worker alone.
_WORKER = {}


def workers() -> int:
    """Processes `align` uses: one a CPU this process may run on, up to
    MAX_WORKERS; 1 where fork is not available."""
    if "fork" not in multiprocessing.get_all_start_methods():
        return 1
    return min(MAX_WORKERS, len(os.sched_getaffinity(0)))


def _start(qs, recs):
    _WORKER["qs"], _WORKER["recs"] = qs, recs


def _align_one(k: int) -> str:
    return align_query(_WORKER["qs"], _WORKER["recs"][k])


def align(aa, ref_genome: Genome, index, fasta_bytes: bytes) -> dict:
    """{read name: its output text} for every read of `fasta_bytes`.  A
    worker's exception, or a worker that dies, raises here."""
    qs = QueryState(aa, ref_genome, index)
    aa.fastq = False
    recs = list(fasta.read_queries(fasta_bytes, aa))
    n = min(workers(), len(recs))
    if n <= 1:
        texts = [align_query(qs, rec) for rec in recs]
    else:
        # fork passes the initializer's arguments by memory, unpickled
        pool = ProcessPoolExecutor(
            n, mp_context=multiprocessing.get_context("fork"),
            initializer=_start, initargs=(qs, recs))
        try:
            texts = list(pool.map(_align_one, range(len(recs))))
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
    return {rec.query_id: text for rec, text in zip(recs, texts)}
