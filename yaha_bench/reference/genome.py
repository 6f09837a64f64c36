"""Genome model: chromosome table + unpacked 4-bit code array.

Frozen copy of the port's io/genome.py (yaha_tpu_torch): the Genome record that the
index builders, uncompress and the oracle engine read.  Reference offsets
are in bases after normalization (BaseSeq.c:113-119); the code array is
indexed by them.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np


@dataclasses.dataclass
class Genome:
    names: list[str]
    starting_offsets: np.ndarray  # base units (normalized), int64
    lengths: np.ndarray           # bases, int64
    codes: np.ndarray             # uint8, one 4-bit code per entry (padded)

    @property
    def n_seqs(self) -> int:
        return len(self.names)

    @property
    def max_roff(self) -> int:
        """baseSequencesMaxROff (BaseSeq.c:121-125)."""
        return int(self.starting_offsets[-1] + self.lengths[-1])

    def find_seq_num(self, offset: int) -> int:
        """findBaseSequenceNum (BaseSeq.c:81-90): -1 if not within any seq.

        Uses bisect over ascending start offsets (equivalent to the reference
        linear scan because sequences are disjoint and ordered).
        """
        i = bisect.bisect_right(self._starts_list(), int(offset)) - 1
        if i < 0:
            return -1
        if offset < self.starting_offsets[i] + self.lengths[i]:
            return i
        return -1

    def _starts_list(self):
        cached = getattr(self, "_starts_cache", None)
        if cached is None:
            cached = self.starting_offsets.tolist()
            object.__setattr__(self, "_starts_cache", cached)
        return cached
