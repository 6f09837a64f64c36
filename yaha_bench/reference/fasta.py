"""Query FASTA/FASTQ reader with readNextQuery-exact semantics.

Frozen copy of the port's io/fasta.py (yaha_tpu_torch) (the oracle engine's reader;
the other engines parse queries in the native library).

Port of openQueryFile/readNextQuery (Query.c:46-228): format sniffed from
the first byte ('@' => FASTQ), IDs have spaces mapped to underscores and
are truncated at 200 chars, newlines are skipped inside sequences, reads
longer than maxQueryLength or shorter than wordLen are skipped with a
warning, FASTQ quality is read until an '@' preceded by a newline, and a
zero-length record terminates processing.
"""
from __future__ import annotations

import sys
import dataclasses

import numpy as np

from . import codec

MAX_QUERY_ID_LEN = 200


@dataclasses.dataclass
class QueryRecord:
    query_id: str
    forward_buf: np.ndarray       # uint8 chars, as read
    forward_codes: np.ndarray     # uint8 4-bit codes
    reverse_buf: np.ndarray       # uint8 chars (canonical complement chars)
    reverse_codes: np.ndarray     # uint8 complemented codes, reversed
    qual: np.ndarray | None       # uint8 chars or None

    @property
    def query_len(self):
        return len(self.forward_buf)


def _make_record(qid_raw: bytes, seq: bytes, qual: bytes | None):
    qid = qid_raw.replace(b" ", b"_")[:MAX_QUERY_ID_LEN]
    fwd = np.frombuffer(seq, dtype=np.uint8)
    fcodes = codec.map8to4(fwd)
    rcodes = codec.complement4to4(fcodes)[::-1].copy()
    rbuf = codec.unmap4to8(rcodes)
    q = np.frombuffer(qual, dtype=np.uint8) if qual is not None else None
    return QueryRecord(query_id=qid.decode("latin-1"), forward_buf=fwd,
                       forward_codes=fcodes, reverse_buf=rbuf,
                       reverse_codes=rcodes, qual=q)


def read_queries(data: bytes, aa):
    """Yield QueryRecords; sets aa.fastq from the first byte.

    Sets aa.stopped = True when a zero-length record terminated the run
    (Query.c:306) so streaming callers stop feeding further chunks.
    """
    aa.fastq = data[:1] == b"@"
    aa.stopped = False
    if aa.fastq:
        yield from _read_fastq(data, aa)
    else:
        yield from _read_fasta(data, aa)


def _warn(msg):
    print(msg, file=sys.stderr)


def _read_fasta(data: bytes, aa):
    pos = 1  # first '>' consumed by format sniff
    n = len(data)
    while pos <= n:
        nl = data.find(b"\n", pos)
        if nl < 0:
            nl = n
        qid_raw = data[pos:nl]
        if len(qid_raw) > MAX_QUERY_ID_LEN:
            _warn("Warning, Query Id length of %d exceeds maximum length %d."
                  "  Id will be truncated." % (len(qid_raw), MAX_QUERY_ID_LEN))
        pos = nl + 1
        nxt = data.find(b">", pos)
        if nxt < 0:
            nxt = n
        seq = data[pos:nxt].replace(b"\n", b"")
        pos = nxt + 1
        if len(seq) > aa.max_query_length:
            _warn("Warning.  Query sequence exceeds maximum length of %d."
                  "  Query will be skipped." % aa.max_query_length)
            continue
        if len(seq) == 0:
            # Reference: zero-length read ends processing (Query.c:306).
            aa.stopped = True
            return
        if len(seq) < aa.word_len:
            _warn("Query length must be at least wordlen bases long. "
                  "Query will be skipped.")
            continue
        yield _make_record(qid_raw, seq, None)


def _read_fastq(data: bytes, aa):
    pos = 1  # first '@' consumed by format sniff
    n = len(data)
    while pos <= n and pos < n:
        nl = data.find(b"\n", pos)
        if nl < 0:
            nl = n
        qid_raw = data[pos:nl]
        if len(qid_raw) > MAX_QUERY_ID_LEN:
            _warn("Warning, Query Id length of %d exceeds maximum length %d."
                  "  Id will be truncated." % (len(qid_raw), MAX_QUERY_ID_LEN))
        pos = nl + 1
        # Sequence until '+'.
        plus = data.find(b"+", pos)
        if plus < 0:
            plus = n
        seq = data[pos:plus].replace(b"\n", b"")
        pos = plus + 1
        # Skip rest of '+' line.
        nl = data.find(b"\n", pos)
        pos = (nl + 1) if nl >= 0 else n
        # Quality until '@' preceded by newline (Query.c:177-198).
        qual_start = pos
        qpos = pos
        while True:
            at = data.find(b"@", qpos)
            if at < 0:
                qual_end = n
                pos = n
                break
            # prevChar starts as 0, not '\n' (Query.c:180): an '@' at the
            # very start of the quality region does not terminate it.
            if at > qual_start and data[at - 1:at] == b"\n":
                qual_end = at
                pos = at + 1
                break
            qpos = at + 1
        qual = data[qual_start:qual_end].replace(b"\n", b"")
        fail = False
        if len(seq) > aa.max_query_length:
            _warn("Warning.  Query sequence exceeds maximum length of %d."
                  "  Query will be skipped." % aa.max_query_length)
            fail = True
        if len(qual) > aa.max_query_length:
            fail = True
        if not fail and len(seq) != len(qual):
            _warn("Warning.  Query sequence (%d) and quality score sequence "
                  "(%d) have different lengths in fastq file.  Query will be "
                  "skipped." % (len(seq), len(qual)))
            fail = True
        if fail:
            continue
        if len(seq) == 0:
            aa.stopped = True
            return
        if len(seq) < aa.word_len:
            _warn("Query length must be at least wordlen bases long. "
                  "Query will be skipped.")
            continue
        yield _make_record(qid_raw, seq, qual)
