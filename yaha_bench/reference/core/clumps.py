"""Clump model: a candidate alignment assembled from fragments.

Frozen copy of the port's core/clumps.py (yaha_tpu_torch).

Port of Clump_t / SFragment_t (Math.h:469-547) with Python lists replacing
the slab-allocated linked lists.  Status bits keep the reference values
(FragsClumps.inl:235-240) because they are emitted verbatim in the SAM
YF:H tag (AlignOutput.c:278).
"""
from __future__ import annotations

from .editops import EditOpList
from .frags import Fragment

REVERSED = 0x01
FORMED = 0x02
ALIGNED = 0x04
SCORED = 0x08
SPLIT = 0x10
PRIMARY = 0x20


class SFragment:
    __slots__ = ("frag", "score", "eol")

    def __init__(self, frag: Fragment | None = None):
        self.frag = frag if frag is not None else Fragment()
        self.score = 0
        self.eol = EditOpList()


class Clump:
    __slots__ = ("eol", "sfrags", "tot_score", "tot_length", "matched_bases",
                 "mismatched_bases", "gap_bases", "num_secondaries",
                 "matched_primary", "status", "map_quality")

    def __init__(self):
        self.eol = EditOpList()
        self.sfrags: list[SFragment] = []
        self.tot_score = 0
        self.tot_length = 0
        self.matched_bases = 0
        self.mismatched_bases = 0
        self.gap_bases = 0
        self.num_secondaries = 0
        self.matched_primary = 0
        self.status = 0
        self.map_quality = 255

    # --- status bits ---
    def _get(self, bit):
        return (self.status & bit) != 0

    def _set(self, bit, value):
        if value:
            self.status |= bit
        else:
            self.status &= ~bit

    @property
    def reversed(self):
        return self._get(REVERSED)

    @reversed.setter
    def reversed(self, v):
        self._set(REVERSED, v)

    @property
    def aligned(self):
        return self._get(ALIGNED)

    @aligned.setter
    def aligned(self, v):
        self._set(ALIGNED, v)

    @property
    def scored(self):
        return self._get(SCORED)

    @scored.setter
    def scored(self, v):
        self._set(SCORED, v)

    @property
    def split(self):
        return self._get(SPLIT)

    @split.setter
    def split(self, v):
        self._set(SPLIT, v)

    @property
    def primary(self):
        return self._get(PRIMARY)

    @primary.setter
    def primary(self, v):
        self._set(PRIMARY, v)

    # --- geometry (FragsClumps.inl:320-375) ---
    @property
    def is_empty(self):
        return not self.sfrags

    @property
    def first_frag(self) -> Fragment:
        return self.sfrags[0].frag

    @property
    def last_frag(self) -> Fragment:
        return self.sfrags[-1].frag

    @property
    def sqo(self):
        return self.first_frag.sqo

    @property
    def eqo(self):
        return self.last_frag.eqo

    @property
    def sro(self):
        return self.first_frag.sro

    @property
    def ero(self):
        return self.last_frag.ero

    def plus_sqo(self, query_len):
        """clumpPlusSQO (FragsClumps.inl:355-359)."""
        return (query_len - 1) - self.eqo if self.reversed else self.sqo

    def plus_eqo(self, query_len):
        return (query_len - 1) - self.sqo if self.reversed else self.eqo

    @property
    def query_len(self):
        return 1 + self.eqo - self.sqo

    def reset(self):
        """resetClump (FragsClumps.c:125-135)."""
        self.tot_score = 0
        self.tot_length = 0
        self.matched_bases = 0
        self.status = 0
        self.map_quality = 255
        self.eol.clear()
        self.sfrags = []
