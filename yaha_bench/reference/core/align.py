"""Clump alignment, scoring, and local-alignment splitting.

Frozen copy of the port's core/align.py (yaha_tpu_torch).

Ports alignClump / collapseSFragments / scoreClump / splitClump
(AlignHelpers.c:205-579), the perfect fragment extensions and gap-fill
cascade (AlignExtFrag.cpp:30-234), and the clump DP extensions.
"""
from __future__ import annotations

import numpy as np

from .cints import wrap_u16
from .clumps import Clump, SFragment
from .editops import MATCH, REPLACE, INSERT, DELETE
from .frags import calc_gap_cost, calc_query_gap, calc_ref_gap
from . import sw


def extend_forward_perfect(frag, genome_codes, q_codes, length) -> int:
    """extendFragmentForwardToStopPerfectly (AlignExtFrag.cpp:30-38).

    Slice-compare formulation of the reference's per-base loop: count is
    the first mismatch position (or `length` on a full match).  Chopped
    fragments can carry degenerate offsets (insertFragment can push EQO
    below -1, AlignHelpers.c:60-90) where the reference walks out of its
    buffer until the first mismatch; the scalar fallback reproduces the
    prior element-indexing semantics for those rare cases.
    """
    if length <= 0:
        return 0
    q_off = frag.eqo + 1
    r_off = frag.ero + 1
    if (q_off < 0 or q_off + length > len(q_codes) or
            r_off + length > len(genome_codes)):
        count = 0
        while (count < length and
               q_codes[q_off + count] == genome_codes[r_off + count]):
            count += 1
    else:
        neq = np.flatnonzero(q_codes[q_off:q_off + length] !=
                             genome_codes[r_off:r_off + length])
        count = int(neq[0]) if len(neq) else length
    if count > 0:
        frag.add_back(count)
    return count


def extend_backward_perfect(frag, genome_codes, q_codes, length) -> int:
    """extendFragmentBackwardToStopPerfectly (AlignExtFrag.cpp:40-48)."""
    if length <= 0:
        return 0
    q_off = frag.sqo - 1
    r_off = frag.sro - 1
    if q_off - length + 1 < 0 or r_off - length + 1 < 0 or \
            q_off >= len(q_codes) or r_off >= len(genome_codes):
        count = 0
        while (count < length and
               q_codes[q_off - count] == genome_codes[r_off - count]):
            count += 1
    else:
        neq = np.flatnonzero(
            q_codes[q_off - length + 1:q_off + 1][::-1] !=
            genome_codes[r_off - length + 1:r_off + 1][::-1])
        count = int(neq[0]) if len(neq) else length
    if count > 0:
        frag.add_front(count)
    return count


def make_and_align_gap(sf1: SFragment, sf2: SFragment, aa, qs,
                       clump: Clump) -> SFragment | None:
    """makeAndAlignSFragmentToFillGap (AlignExtFrag.cpp:164-234)."""
    frag1, frag2 = sf1.frag, sf2.frag
    q_gap = calc_query_gap(frag1, frag2)
    r_gap = calc_ref_gap(frag1, frag2)
    if q_gap == 0 and r_gap == 0:
        return None
    new_sf = SFragment()
    nf = new_sf.frag
    nf.sqo = frag1.eqo + 1
    nf.eqo = frag2.sqo - 1
    nf.sro = (frag1.ero + 1) & 0xFFFFFFFF
    nf.set_ero(frag2.sro - 1)
    lst = new_sf.eol
    if q_gap == 0:
        lst.add_front(DELETE, r_gap)
        new_sf.score = calc_gap_cost(r_gap, aa)
    elif r_gap == 0:
        lst.add_front(INSERT, q_gap)
        new_sf.score = calc_gap_cost(q_gap, aa)
    elif r_gap == 1 and q_gap == 1:
        lst.add_front(REPLACE, 1)
        new_sf.score = -aa.r_cost
    else:
        q_codes = qs.clump_query_codes(clump)
        len_diff = abs(q_gap - r_gap)
        banded = len_diff + aa.band_width * 2 + 1 < r_gap
        new_sf.score = sw.find_ags_alignment(
            aa, qs.genome_codes, nf.sro, r_gap, q_codes, nf.sqo, q_gap,
            lst, banded)
    return new_sf


def collapse_sfragments(clump: Clump) -> None:
    """collapseSFragments (AlignHelpers.c:274-300)."""
    lst = clump.eol
    total = 0
    for sf in clump.sfrags:
        total += sf.score
        lst.merge_to_back(sf.eol)
    sf0 = clump.sfrags[0]
    sfn = clump.sfrags[-1]
    sf0.frag.eqo = sfn.frag.eqo
    sf0.frag.set_ero(sfn.frag.ero)
    sf0.score = total
    clump.sfrags = [sf0]


def extend_clump_fr(clump: Clump, aa, qs, go_back=True, go_forw=True,
                    carefully=False) -> None:
    """extendClumpForwardReverseTemplated (AlignExtFrag.cpp:64-144)."""
    sf = clump.sfrags[0]
    frag = sf.frag
    lst = clump.eol
    genome = qs.genome_codes
    q_codes = qs.clump_query_codes(clump)
    score = sf.score

    back_len = forw_len = 0
    if go_back:
        back_len = min(frag.sqo, frag.sro)
        if back_len > 0:
            new_matches = extend_backward_perfect(frag, genome, q_codes,
                                                 back_len)
            if new_matches > 0:
                lst.first()[1] += new_matches
                score += new_matches * aa.m_score
                back_len -= new_matches
    if go_forw:
        qlen = (qs.query_len - 1) - frag.eqo
        rlen = qs.max_roff - frag.ero
        forw_len = min(qlen, rlen)
        if forw_len > 0:
            new_matches = extend_forward_perfect(frag, genome, q_codes,
                                                forw_len)
            if new_matches > 0:
                lst.last()[1] += new_matches
                score += new_matches * aa.m_score
                forw_len -= new_matches

    if go_back and back_len >= aa.min_ext_length:
        if carefully:
            new_score, aq, ar = sw.find_ags_backward_extension_carefully(
                aa, genome, qs.max_roff, frag.sro - 1, q_codes,
                frag.sqo - 1, back_len, lst, score)
        else:
            new_score, aq, ar = sw.find_ags_extension(
                aa, genome, qs.max_roff, frag.sro - 1, q_codes,
                frag.sqo - 1, back_len, lst, True)
        if new_score > 0:
            score += new_score
            frag.add_q_front(aq)
            frag.add_r_front(ar)
    if go_forw and forw_len >= aa.min_ext_length:
        if carefully:
            new_score, aq, ar = sw.find_ags_forward_extension_carefully(
                aa, genome, qs.max_roff, frag.ero + 1, q_codes,
                frag.eqo + 1, forw_len, lst, score)
        else:
            new_score, aq, ar = sw.find_ags_extension(
                aa, genome, qs.max_roff, frag.ero + 1, q_codes,
                frag.eqo + 1, forw_len, lst, False)
        if new_score > 0:
            score += new_score
            frag.add_q_back(aq)
            frag.add_r_back(ar)
    sf.score = score


def align_clump(clump: Clump, aa, qs) -> int:
    """alignClump (AlignHelpers.c:205-272)."""
    if clump.aligned:
        return 0
    genome = qs.genome_codes
    q_codes = qs.clump_query_codes(clump)
    sfrags = clump.sfrags

    # Perfect extensions of fragments toward each other.
    for k in range(len(sfrags) - 1):
        frag1 = sfrags[k].frag
        frag2 = sfrags[k + 1].frag
        gap = min(calc_query_gap(frag1, frag2), calc_ref_gap(frag1, frag2))
        gap -= extend_backward_perfect(frag2, genome, q_codes, gap)
        gap -= extend_forward_perfect(frag1, genome, q_codes, gap)

    # Per-fragment Match edit op + score.
    for sf in sfrags:
        q_len = sf.frag.q_len
        sf.eol.add_front(MATCH, q_len)
        sf.score = aa.m_score * q_len

    # Gap-fill SFragments (inserted after current; the inserted one is
    # visited next and yields zero gaps).
    i = 0
    while i < len(sfrags) - 1:
        new_sf = make_and_align_gap(sfrags[i], sfrags[i + 1], aa, qs, clump)
        if new_sf is not None:
            sfrags.insert(i + 1, new_sf)
        i += 1

    collapse_sfragments(clump)
    extend_clump_fr(clump, aa, qs)
    clump.aligned = True
    return 1


def score_clump(clump: Clump, aa, qs) -> int:
    """scoreClump (AlignHelpers.c:302-366)."""
    if clump.scored:
        return 1
    ags = 0
    max_ags = 0
    matches = mismatches = inserts = deletes = 0
    items = clump.eol.items
    aligned_score = clump.sfrags[0].score
    last_idx = len(items) - 1
    for idx, (op, length) in enumerate(items):
        if op == MATCH:
            matches += length
            ags += aa.m_score * length
        elif op == REPLACE:
            mismatches += length
            ags -= aa.r_cost * length
        elif op == INSERT:
            inserts += length
            ags -= aa.go_cost + aa.ge_cost * length
        elif op == DELETE:
            deletes += length
            ags -= aa.go_cost + aa.ge_cost * length
        if ags <= 0 or (ags >= aligned_score and idx != last_idx):
            return split_clump(clump, aa, qs)
        if ags > max_ags:
            max_ags = ags
    if matches >= aa.min_raw_score and max_ags > ags:
        return split_clump(clump, aa, qs)
    if matches < aa.min_raw_score:
        return 0

    # Clump counters are QOFF = uint16 in the reference (Math.h:517-521);
    # large values wrap and the wrapped values flow into identity
    # filtering, OQC, and output (see core/cints.py).
    clump.matched_bases = wrap_u16(matches)
    clump.mismatched_bases = wrap_u16(mismatches)
    clump.gap_bases = wrap_u16(inserts + deletes)
    clump.tot_length = wrap_u16(matches + mismatches + inserts + deletes)
    clump.tot_score = wrap_u16(ags)

    percent = clump.matched_bases / clump.tot_length
    if percent < aa.min_identity:
        return 0
    clump.scored = True
    return 1


def _split_clump_helper(clump: Clump, aa, qs, w_sqo, w_eqo) -> int:
    """splitClumpHelper (AlignHelpers.c:374-557)."""
    cur_sf = clump.sfrags[0]
    cur_frag = cur_sf.frag
    lst = cur_sf.eol
    lst.merge_to_front(clump.eol)

    # Forward pass: find max-scoring end point.
    s_qo = e_qo = 0
    s_ro = e_ro = 0
    matches = mismatches = inserts = deletes = 0
    ags = 0
    max_ags = -10000
    max_idx = -1
    for idx, (op, length) in enumerate(lst.items):
        if op == MATCH:
            matches += length
            new_score = aa.m_score * length
        elif op == REPLACE:
            mismatches += length
            new_score = -(aa.r_cost * length)
        elif op == INSERT:
            inserts += length
            new_score = -(aa.go_cost + aa.ge_cost * length)
        else:  # DELETE
            deletes += length
            new_score = -(aa.go_cost + aa.ge_cost * length)
        ags += new_score
        if ags < 0:
            ags = 0
        if ags > max_ags:
            max_ags = ags
            max_idx = idx
            e_qo = cur_frag.sqo + matches + mismatches + inserts - 1
            e_ro = cur_frag.sro + matches + mismatches + deletes - 1

    # Backward pass from the max: find the first zero.
    ags = max_ags
    matches = mismatches = inserts = deletes = 0
    max_match = 0
    min_idx = -1
    for idx in range(max_idx, -1, -1):
        op, length = lst.items[idx]
        if op == MATCH:
            matches += length
            ags -= aa.m_score * length
            if length > max_match:
                max_match = length
        elif op == REPLACE:
            mismatches += length
            ags += aa.r_cost * length
        elif op == INSERT:
            inserts += length
            ags += aa.go_cost + aa.ge_cost * length
        else:
            deletes += length
            ags += aa.go_cost + aa.ge_cost * length
        if ags <= 0:
            min_idx = idx
            s_qo = e_qo - (matches + mismatches + inserts - 1)
            s_ro = e_ro - (matches + mismatches + deletes - 1)
            break
    if max_match < aa.word_len:
        return 0

    retval = 0
    # Head piece.
    if min_idx != 0:
        new_sf = SFragment()
        new_clump = Clump()
        new_clump.reversed = clump.reversed
        new_clump.sfrags = [new_sf]
        new_eol = new_sf.eol
        new_eol.merge_to_front(lst)
        # Split so new_eol keeps [:min_idx], lst gets [min_idx:].
        tail = new_eol.split_before(min_idx)
        lst.items = tail.items
        max_idx -= min_idx  # maxItem pointer survives the split
        if new_eol.max_match_at_least(aa.word_len):
            nf = new_sf.frag
            nf.sqo = cur_frag.sqo
            nf.eqo = s_qo - 1
            nf.sro = cur_frag.sro
            nf.set_ero(s_ro - 1)
            retval += _split_clump_helper(new_clump, aa, qs, w_sqo, w_eqo)
        if new_clump.scored:
            new_clump.split = True
            new_clump.aligned = True
            qs.add_clump(new_clump)
            new_clump.reversed = clump.reversed
    # Tail piece.
    if max_idx != len(lst.items) - 1:
        new_sf = SFragment()
        new_clump = Clump()
        new_clump.reversed = clump.reversed
        new_clump.sfrags = [new_sf]
        new_eol = new_sf.eol
        tail = lst.split_after(max_idx)
        new_eol.items = tail.items
        if new_eol.max_match_at_least(aa.word_len):
            nf = new_sf.frag
            nf.sqo = e_qo + 1
            nf.eqo = cur_frag.eqo
            nf.sro = (e_ro + 1) & 0xFFFFFFFF
            nf.set_ero(cur_frag.ero)
            retval += _split_clump_helper(new_clump, aa, qs, w_sqo, w_eqo)
        if new_clump.scored:
            new_clump.split = True
            new_clump.aligned = True
            qs.add_clump(new_clump)
            new_clump.reversed = clump.reversed

    # The surviving core.
    cur_frag.sqo = s_qo
    cur_frag.eqo = e_qo
    cur_frag.sro = s_ro & 0xFFFFFFFF
    cur_frag.set_ero(e_ro)
    cur_sf.score = max_ags
    clump.eol.merge_to_front(lst)

    go_back = s_qo != w_sqo
    go_forw = e_qo != w_eqo
    extend_clump_fr(clump, aa, qs, go_back=go_back, go_forw=go_forw,
                    carefully=True)
    clump.split = True
    retval += score_clump(clump, aa, qs)
    return retval


def split_clump(clump: Clump, aa, qs) -> int:
    """splitClump (AlignHelpers.c:561-579)."""
    cur_frag = clump.sfrags[0].frag
    return _split_clump_helper(clump, aa, qs, cur_frag.sqo, cur_frag.eqo)
