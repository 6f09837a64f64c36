"""Fragments: maximal exact-match runs of seed hits on one diagonal.

Frozen copy of the port's core/frags.py (yaha_tpu_torch).

Port of the seed-hit phase (Query.c:361-412), findFragmentsSort
(QueryMatch.c:43-121), and the fragment algebra (FragsClumps.inl:35-199).
The reference's binary-heap k-way merge is replaced by one vectorized
lexsort over (diagonal, queryOffset) pairs — the heap exists only to
produce exactly that order (QueryHeap.inl), so the outputs agree.

Diagonals are uint32 values that deliberately wrap for reference offsets
smaller than the query offset (QueryMatch.c:46-51); all diagonal arithmetic
here is done mod 2^32 with the reference's signed-difference helpers.
"""
from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF


def abs_diag_diff(a: int, b: int) -> int:
    """absUINTDiff (FragsClumps.inl:133-137)."""
    a &= M32
    b &= M32
    return a - b if a > b else b - a


def calc_gap(low: int, high: int) -> int:
    """calcGap macro (FragsClumps.inl:158)."""
    return high - low - 1 if high > low else 0


def calc_overlap(low: int, high: int) -> int:
    """calcOverlap macro (FragsClumps.inl:159)."""
    return low - high + 1 if low >= high else 0


class Fragment:
    """Fragment_t (Math.h:448-456).  Offsets are Python ints; sro is kept
    in uint32 range."""

    __slots__ = ("sqo", "eqo", "sro", "ref_len")

    def __init__(self, sqo=0, eqo=0, sro=0, ref_len=0):
        self.sqo = sqo
        self.eqo = eqo
        self.sro = sro & M32
        self.ref_len = ref_len

    def __repr__(self):
        return "Frag(Q[%d-%d] R[%d-%d])" % (self.sqo, self.eqo, self.sro,
                                            self.ero)

    def copy(self):
        return Fragment(self.sqo, self.eqo, self.sro, self.ref_len)

    @property
    def q_len(self):
        return 1 + self.eqo - self.sqo

    @property
    def ero(self):
        """fragEndRefOff (FragsClumps.inl:54-57)."""
        return (self.sro + self.ref_len - 1) & M32

    def set_ero(self, ro):
        self.ref_len = 1 + ro - self.sro

    @property
    def diag(self):
        """fragDiag (FragsClumps.inl:122-125), wraps as uint32."""
        return (self.sro - self.sqo) & M32

    @property
    def match_count(self):
        """fragMatchCount (FragsClumps.inl:196-199)."""
        return self.ref_len

    def add_q_front(self, n):
        self.sqo -= n

    def add_r_front(self, n):
        self.sro = (self.sro - n) & M32
        self.ref_len += n

    def add_front(self, n):
        self.add_q_front(n)
        self.add_r_front(n)

    def add_q_back(self, n):
        self.eqo += n

    def add_r_back(self, n):
        self.ref_len += n

    def add_back(self, n):
        self.add_q_back(n)
        self.add_r_back(n)

    def sub_front(self, n):
        self.sqo += n
        self.sro = (self.sro + n) & M32
        self.ref_len -= n

    def sub_back(self, n):
        self.eqo -= n
        self.ref_len -= n


def calc_query_gap(f1: Fragment, f2: Fragment) -> int:
    return calc_gap(f1.eqo, f2.sqo)


def calc_ref_gap(f1: Fragment, f2: Fragment) -> int:
    return calc_gap(f1.ero, f2.sro)


def calc_max_overlap(f1: Fragment, f2: Fragment) -> int:
    """calcMaxOverlap (FragsClumps.inl:161-164)."""
    return max(calc_overlap(f1.eqo, f2.sqo), calc_overlap(f1.ero, f2.sro))


def calc_gap_cost(length: int, aa) -> int:
    """calcGapCost (FragsClumps.inl:190-193)."""
    return -(aa.go_cost + length * aa.ge_cost) if length > 0 else 0


def seed_hits(query_codes: np.ndarray, index, max_hits: int):
    """Phase 1 (Query.c:361-412): per-offset hash + SO lookup.

    Returns (offsets int64, so_offsets int64, counts int64) for query
    offsets whose k-mer is clean (no non-ACGT code) and whose index count
    is in (0, maxHits].
    """
    wl = index.word_len
    q_len = len(query_codes)
    n = q_len - wl + 1
    if n <= 0:
        return (np.empty(0, np.int64),) * 3
    c = query_codes.astype(np.int64)
    bad = (c > 3).astype(np.int64)
    bad_cum = np.concatenate([[0], np.cumsum(bad)])
    clean = (bad_cum[wl:] - bad_cum[:-wl]) == 0  # window has no bad code
    h = np.zeros(n, dtype=np.int64)
    for i in range(wl):
        h = (h << 2) | c[i:i + n]
    h = np.where(clean, h, 0)
    # The two SO entries of each window, widened window by window (an
    # int64 copy of the whole L15 table would take 8.6 GB).
    so = index.starting_offs
    so_lo = so[h].astype(np.int64)
    counts = so[h + 1].astype(np.int64) - so_lo
    ok = clean & (counts > 0) & (counts <= max_hits)
    offsets = np.flatnonzero(ok).astype(np.int64)
    return offsets, so_lo[offsets], counts[offsets]


def phantom_hits(offsets, so_offsets, counts, roa, wrapped_idx):
    """The reference phantom-hit quirk (QueryMatch.c:57-69): for each
    window k in `wrapped_idx` (its whole ROA run has ro < qo), the heap
    pre-seed loop reads PAST the run into the next k-mer's ROA entries,
    pushing each as a hit for this window, until one with ro >= qo
    (inclusive).  Returns (extra_qo, extra_ro) lists.  Shared by the
    host path (find_fragments) and the device front end's per-window
    injection (models/seeder.py)."""
    roa_len = len(roa)
    extra_qo = []
    extra_ro = []
    for k in wrapped_idx:
        off = int(offsets[k])
        j = int(so_offsets[k] + counts[k])
        while j < roa_len:
            v = int(roa[j])
            extra_qo.append(off)
            extra_ro.append(v)
            if v >= off:
                break
            j += 1
    return extra_qo, extra_ro


def find_fragments(offsets, so_offsets, counts, roa, word_len):
    """Phases of findFragmentsSort (QueryMatch.c:52-121) as sort+coalesce.

    Returns a list of Fragment in ascending (diag uint32, SQO) order, the
    same order the heap merge produces.
    """
    if len(offsets) == 0:
        return []
    qo = np.repeat(offsets, counts)
    # Gather ROA runs: idx[t] = so_offsets[run(t)] + rank-within-run(t).
    run_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    total0 = int(counts.sum())
    rank = np.arange(total0) - np.repeat(run_starts, counts)
    idx = np.repeat(so_offsets, counts) + rank
    ro = np.asarray(roa[idx], dtype=np.int64)

    # Reference quirk (QueryMatch.c:57-69): the heap pre-seeding loop pushes
    # ROA entries while roff < queryOffset, then one more.  When EVERY entry
    # of an offset's run wraps (ro < qo), it reads past the run into the
    # next k-mer's ROA entries, injecting phantom hits until one with
    # ro >= qo.  SAM parity requires reproducing those phantoms.
    run_any_ok = np.maximum.reduceat(
        (ro >= qo).astype(np.int8), run_starts) if total0 else None
    all_wrapped = np.flatnonzero(run_any_ok == 0) if total0 else []
    extra_qo, extra_ro = phantom_hits(offsets, so_offsets, counts, roa,
                                      all_wrapped)
    if extra_qo:
        qo = np.concatenate([qo, np.array(extra_qo, dtype=np.int64)])
        ro = np.concatenate([ro, np.array(extra_ro, dtype=np.int64)])
    total = len(qo)
    diag = (ro - qo) & M32
    order = np.lexsort((qo, diag))
    qo = qo[order]
    diag = diag[order]
    # Coalesce runs: same diag and qo step <= wordLen.
    if total == 1:
        brk = np.empty(0, dtype=np.int64)
    else:
        brk = np.flatnonzero((np.diff(diag) != 0) |
                             (np.diff(qo) > word_len)) + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk - 1, [total - 1]])
    frags = []
    for s, e in zip(starts, ends):
        sqo = int(qo[s])
        eqo = int(qo[e]) + word_len - 1
        frags.append(Fragment(sqo=sqo, eqo=eqo,
                              sro=int((diag[s] + sqo) & M32),
                              ref_len=eqo - sqo + 1))
    return frags
