"""Genome model: chromosome table + unpacked 4-bit code array.

The port's copy of the Genome record of yaha_tpu/io/genome.py, as the
index build and uncompress read it.  Reference offsets are in bases after
normalization (BaseSeq.c:113-119); the code array is indexed by them.
"""
from __future__ import annotations

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
