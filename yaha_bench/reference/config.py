"""Run configuration with reference-exact defaults and derived defaults.

Frozen copy of the port's config.py (yaha_tpu_torch).

Port of AlignmentArgs_t (Math.h:257-339) and postProcessAlignmentArgs
(AlignArgs.c:108-169).  The derived-default logic is bit-parity critical:
minExtLength, maxIntron, minRawScore, OQCMinNonOverlap, minNonOverlap, and
the maxHits index/query split all change alignment output.
"""
from __future__ import annotations

import dataclasses
import sys

DEFAULT = -1
SUINT_MAX = 0xFFFF


@dataclasses.dataclass
class AlignmentArgs:
    # File names
    gfile_name: str | None = None
    xfile_name: str | None = None
    qfile_name: str = "stdin"
    ofile_name: str | None = None

    num_threads: int = 1
    fastq: bool = False

    # Index parameters
    word_len: int = 15
    skip_dist: int = 1
    max_hits: int = DEFAULT

    # General alignment parameters
    max_gap: int = 50
    max_intron: int = DEFAULT
    min_match: int = 25
    # float32-rounded like the reference's `float` fields
    # (Math.h:292,314-315); see cli._parse_float.
    min_identity: float = 0.8999999761581421
    band_width: int = 5
    max_desert: int = 50
    min_raw_score: int = DEFAULT
    min_non_overlap: int = DEFAULT

    # Affine gap scoring (BWASW defaults)
    affine_gap_scoring: bool = True
    go_cost: int = 5
    ge_cost: int = 2
    r_cost: int = 3
    m_score: int = 1
    x_cutoff: int = 25
    min_ext_length: int = 0  # derived

    # OQC / FBS
    oqc: bool = True
    oqc_min_non_overlap: int = DEFAULT
    bp_cost: int = 5
    max_bp_log: int = 5
    fbs: bool = False
    fbs_ps_length: float = 0.8999999761581421
    fbs_ps_score: float = 0.8999999761581421

    max_query_length: int = 32000
    # Safety valve (--max-region-frags, 0 = off): skip fragment regions
    # with more than N fragments instead of running the O(n^2) chain DP
    # over pathological tandem-repeat reads (the reference segfaults on
    # such inputs; parity configs leave this off).
    max_region_frags: int = 0
    verbose: bool = False
    output_blast8: bool = False
    output_sam: bool = True
    hard_clip: bool = True

    def post_process(self, query: bool) -> "AlignmentArgs":
        """Derived defaults (AlignArgs.c:108-169). Mutates and returns self."""
        if self.max_intron == DEFAULT:
            self.max_intron = self.max_gap
        if self.min_raw_score == DEFAULT:
            self.min_raw_score = self.min_match
        if self.oqc_min_non_overlap == DEFAULT:
            self.oqc_min_non_overlap = self.min_match
        if self.oqc_min_non_overlap <= 0:
            print("MNO parameter must be >=1.  MNO=1 will be used.",
                  file=sys.stderr)
            self.oqc_min_non_overlap = 1
        if self.min_non_overlap == DEFAULT:
            self.min_non_overlap = self.oqc_min_non_overlap
        if not self.affine_gap_scoring:
            # Edit-distance emulation (AlignArgs.c:126-133).
            self.m_score = 1
            self.r_cost = self.ge_cost = 1
            self.go_cost = 0
        # minExtLength: smallest extension length worth a DP call
        # (AlignArgs.c:134-149).
        length = 1
        score = 0
        target = min(self.r_cost, self.go_cost + self.ge_cost)
        while score <= target:
            score += self.m_score
            length += 1
        self.min_ext_length = length

        if self.max_hits == DEFAULT:
            self.max_hits = 650 if query else SUINT_MAX - 10
        else:
            self.max_hits = min(self.max_hits, SUINT_MAX - 10)
        if self.max_bp_log < 1:
            print("MGDP parameter must be between 1 and 9 (inclusive). "
                  "MGDP=1 will be used.", file=sys.stderr)
            self.max_bp_log = 1
        if self.max_bp_log > 9:
            print("MGDP parameter must be between 1 and 9 (inclusive). "
                  "MGDP=9 will be used.", file=sys.stderr)
            self.max_bp_log = 9
        return self
