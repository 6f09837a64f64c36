"""What decides `correct`: the sampled reads' SAM records, the program's
against the reference's, byte for byte.

The FASTA the window streams holds `copies` copies of the pool; read i of
copy c is pool read i named <prefix><c * pool + i>, so every read of a pass
has a name of its own.  A pass's batches (the align_fn calls, each a run
of consecutive reads) are its slots.  Before the window, one slot a pass
is drawn from the seed (keep_plan); the harness keeps only that batch's
text.  After the window the sample, `check_reads` reads, is drawn from the
seed among the kept batches' reads (pick_sample), and judge() compares
each sampled read's records, taken from the text of the batch that aligned
it, with the reference's: a batch answered with another batch's records
shows.  A read whose records differ in any byte (or are missing on one
side) counts once; a kept batch whose records are not in read order counts
once.  Each limit is 0: an exact comparison.
"""
from __future__ import annotations

import re

import numpy as np

_INDEX = re.compile(rb"(\d+)$")
MAX_PASSES = 1 << 16


def file_reads(pool, copies: int) -> list:
    """The (name, codes) of the FASTA's reads: `copies` copies of `pool`
    (whose names are <prefix><pool index>), each read named by its index
    in the file."""
    n = len(pool)
    return [("%s%d" % (name.rstrip("0123456789"), c * n + i), r)
            for c in range(copies) for i, (name, r) in enumerate(pool)]


def keep_plan(seed: int, slots: int) -> np.ndarray:
    """The slot of each pass whose batch text the window keeps."""
    rng = np.random.default_rng([int(seed), 2])
    return rng.integers(0, slots, MAX_PASSES)


def pick_sample(kept, n_check: int, seed: int) -> list:
    """(file index, kept batch) of the reads the check compares: `n_check`
    of the kept batches' reads (each batch a (first, n, ...) tuple), drawn
    from the seed without repeats."""
    sizes = np.array([b[1] for b in kept], np.int64)
    total = int(sizes.sum())
    rng = np.random.default_rng([int(seed), 3])
    at = np.sort(rng.choice(total, min(int(n_check), total), replace=False))
    ends = np.cumsum(sizes)
    which = np.searchsorted(ends, at, side="right")
    return [(int(kept[b][0] + a - (ends[b] - sizes[b])), int(b))
            for a, b in zip(at, which)]


def records_of(blob: bytes, name: str) -> bytes:
    """The lines of SAM text `blob` whose QNAME is `name` (contiguous, as
    the engines write a read's records)."""
    key = name.encode() + b"\t"
    if blob.startswith(key):
        at = 0
    else:
        at = blob.find(b"\n" + key) + 1
        if at == 0:
            return b""
    end = at
    while blob.startswith(key, end):
        nl = blob.find(b"\n", end)
        end = len(blob) if nl < 0 else nl + 1
    return blob[at:end]


def first_read(pr, lo: int) -> int:
    """The file index of read `lo` of a parsed chunk (the port's
    ParsedReads), from its name."""
    offs = np.ctypeslib.as_array(pr.id_offs, shape=(pr.n + 1,))
    ids = np.ctypeslib.as_array(pr.ids, shape=(max(int(offs[pr.n]), 1),))
    return int(_INDEX.search(ids[offs[lo]:offs[lo + 1]].tobytes()).group(1))


def in_read_order(batch) -> bool:
    """Whether a batch's records name only its reads, in their order."""
    first, n, text = batch[:3]
    last = first
    for line in text.split(b"\n"):
        if not line:
            continue
        k = int(_INDEX.search(line.split(b"\t", 1)[0]).group(1))
        if not last <= k < first + n:
            return False
        last = k
    return True


def judge(kept, picks, reads, ref_out):
    """(checks, names of the reads that differ) of the sample `picks`
    (pick_sample's) against the reference's output `ref_out` (name -> its
    records' text); each check is a number beside its limit.  `kept`:
    (first, n, text) of each kept batch; `reads`: the file's (name,
    codes)."""
    differ = [reads[k][0] for k, b in picks
              if records_of(kept[b][2], reads[k][0]) !=
              ref_out[reads[k][0]].encode("latin-1")]
    used = sorted({b for _, b in picks})
    disordered = sum(not in_read_order(kept[b]) for b in used)
    return ({"reads_differing": {"value": len(differ), "limit": 0},
             "batches_out_of_order": {"value": disordered, "limit": 0}},
            differ)
