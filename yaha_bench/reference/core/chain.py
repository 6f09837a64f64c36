"""Fragment chaining: best clump per reference region, iterated.

Frozen copy of the port's core/chain.py (yaha_tpu_torch).

Ports processFragmentsGapped / region split (QueryMatch.c:146-158,224-303),
the O(n^2) sparse chain DP with exact tie-breaks
(GraphPath.cpp:65-292), fragment insertion with overlap chopping and the
clump clean-up heuristic (AlignHelpers.c:48-193), and the
coverage-elimination loop (QueryMatch.c:161-215).

The deterministic tie-break cascade (GraphPath.cpp:239-251 relaxation,
85-105 backtrack preference) is load-bearing for SAM parity — do not
"simplify" it.
"""
from __future__ import annotations

from .cints import wrap_i16
from .clumps import Clump, SFragment
from .frags import (Fragment, abs_diag_diff, calc_gap, calc_gap_cost,
                    calc_max_overlap, calc_overlap)


class _Node:
    __slots__ = ("best_prev", "frag", "best_score", "path_length",
                 "path_sqo", "node_score", "diag", "node_length",
                 "sqo", "eqo")

    def __init__(self, frag: Fragment, aa):
        """initfGraphNode (GraphPath.cpp:108-121)."""
        self.best_prev = None
        self.path_length = 1
        self.frag = frag
        self.diag = frag.diag
        # nodeLength/bestScore are SINT = int16 (GraphPath.cpp:71-76);
        # long-fragment scores wrap, changing path choices.
        self.node_length = wrap_i16(frag.match_count)
        self.best_score = wrap_i16(self.node_length * aa.m_score)
        self.sqo = frag.sqo
        self.eqo = frag.eqo
        self.path_sqo = self.sqo


def _differentiate_equal_frag_nodes(left: _Node, best: _Node) -> bool:
    """differentiateEqualFragNodesDuringBacktrack (GraphPath.cpp:88-94):
    prefer lower EQO, then greater pathSQO (shorter query path)."""
    if left.eqo != best.eqo:
        return left.eqo < best.eqo
    return left.path_sqo > best.path_sqo


def add_fragment(clump: Clump, frag: Fragment) -> None:
    """addFragment (AlignHelpers.c:48-56): copies frag, counts its matches,
    prepends."""
    clump.matched_bases += frag.match_count
    sf = SFragment(frag.copy())
    clump.sfrags.insert(0, sf)


def insert_fragment(clump: Clump, frag1: Fragment) -> None:
    """insertFragment (AlignHelpers.c:60-90).

    NOTE: when the incoming fragment is chopped, the chop mutates the
    caller's Fragment (an entry of the per-strand fragment array) — that
    mutation persists into later clump-extraction rounds, exactly like the
    reference.
    """
    if clump.is_empty:
        add_fragment(clump, frag1)
        return
    next_sf = clump.sfrags[0]
    frag2 = next_sf.frag
    max_overlap = calc_max_overlap(frag1, frag2)
    if max_overlap > 0:
        len1 = frag1.q_len
        len2 = frag2.q_len
        if len1 != len2:
            chop1 = len1 < len2
        else:
            chop1 = len(clump.sfrags) == 1  # nextSFrag->next == NULL
        if chop1:
            frag1.sub_back(max_overlap)
        else:
            frag2.sub_front(max_overlap)
    add_fragment(clump, frag1)


def clean_up_clump(clump: Clump, aa) -> None:
    """cleanUpClump (AlignHelpers.c:92-193): drop chopped sub-wordLen
    fragments that banded SW will re-find anyway."""
    sfrags = clump.sfrags
    wl = aa.word_len
    # Middle pass over triples (SFrag1, SFrag2, SFrag3), tracked by object
    # identity to mirror the reference's pointer walk.
    sf1 = sfrags[0] if len(sfrags) > 0 else None
    sf2 = sfrags[1] if len(sfrags) > 1 else None
    sf3 = sfrags[2] if len(sfrags) > 2 else None
    while sf2 is not None and sf3 is not None:
        if sf2.frag.q_len < wl:
            # Find the next full frag, or the last frag.
            ai = sfrags.index(sf3)
            while sfrags[ai].frag.q_len < wl and ai + 1 < len(sfrags):
                ai += 1
            anchor = sfrags[ai]
            f1_diag = sf1.frag.diag
            anchor_diag = anchor.frag.diag
            if abs_diag_diff(f1_diag, anchor_diag) <= aa.max_gap:
                j = sfrags.index(sf2)
                while sfrags[j] is not anchor:
                    del_diag = sfrags[j].frag.diag
                    mid = not ((del_diag < f1_diag and del_diag < anchor_diag)
                               or (del_diag > f1_diag and del_diag > anchor_diag))
                    if mid or min(abs_diag_diff(f1_diag, del_diag),
                                  abs_diag_diff(del_diag, anchor_diag)) <= aa.band_width:
                        sfrags.pop(j)
                    else:
                        j += 1
            sf1 = anchor
            ai = sfrags.index(anchor)
            sf2 = sfrags[ai + 1] if ai + 1 < len(sfrags) else None
        else:
            sf1, sf2 = sf2, sf3
        if sf2 is not None:
            i2 = sfrags.index(sf2)
            sf3 = sfrags[i2 + 1] if i2 + 1 < len(sfrags) else None

    # First fragment (vs 2x bandwidth adjacency).
    if len(sfrags) >= 2:
        frag1 = sfrags[0].frag
        if frag1.q_len < wl:
            frag2 = sfrags[1].frag
            q_gap = calc_gap(frag1.eqo, frag2.sqo)
            r_gap = calc_gap(frag1.ero, frag2.sro)
            if ((q_gap == 0 and r_gap <= 2 * aa.band_width) or
                    (r_gap == 0 and q_gap <= 2 * aa.band_width)):
                sfrags.pop(0)
    # Last fragment.
    if sfrags:
        frag2 = sfrags[-1].frag
        if frag2.q_len < wl:
            if len(sfrags) < 2:
                return
            frag1 = sfrags[-2].frag
            q_gap = calc_gap(frag1.eqo, frag2.sqo)
            r_gap = calc_gap(frag1.ero, frag2.sro)
            if ((q_gap == 0 and r_gap <= 2 * aa.band_width) or
                    (r_gap == 0 and q_gap <= 2 * aa.band_width)):
                sfrags.pop()


def build_best_clump(aa, qs, frags, used, start, end, clump: Clump) -> None:
    """buildBestClumpFromFragmentRange (GraphPath.cpp:161-270)."""
    nodes = [_Node(frags[i], aa) for i in range(start, end + 1) if not used[i]]
    if not nodes:
        return
    # Sort ascending (SQO, diag) — compareFragsByQueryOffsets
    # (GraphPath.cpp:148-159).
    nodes.sort(key=lambda n: (n.sqo, n.diag))
    if len(nodes) >= 24:
        best_node = _chain_dp_vectorized(aa, nodes)
        _emit_best_path(aa, qs, best_node, clump)
        return

    best_score = -0x7FFFFF00
    best_node = None
    max_gap = aa.max_gap
    max_desert = aa.max_desert
    n = len(nodes)
    for i in range(n):
        left = nodes[i]
        l_sqo = left.sqo
        l_eqo = left.eqo
        l_sro = (left.diag + l_sqo) & 0xFFFFFFFF
        l_ero = (left.diag + left.eqo) & 0xFFFFFFFF
        for j in range(n - 1, i, -1):
            right = nodes[j]
            r_sqo = right.sqo
            if r_sqo == l_sqo:
                break
            diag_gap = abs_diag_diff(left.diag, right.diag)
            if diag_gap > max_gap:
                continue
            r_sro = (right.diag + r_sqo) & 0xFFFFFFFF
            if l_sro >= r_sro:
                continue
            desert = min(calc_gap(l_eqo, r_sqo), calc_gap(l_ero, r_sro))
            if desert > max_desert:
                continue
            max_overlap = max(calc_overlap(l_eqo, r_sqo),
                              calc_overlap(l_ero, r_sro))
            newbases = right.node_length - max_overlap
            if newbases < 1:
                continue
            # `int newScore` (GraphPath.cpp:230): the candidate stays
            # unwrapped for comparisons; only the store wraps.
            new_score = (left.best_score + newbases * aa.m_score +
                         calc_gap_cost(diag_gap, aa))
            if right.best_score > new_score:
                continue
            elif right.best_score == new_score:
                prev_best = right.best_prev
                if prev_best is None:
                    continue
                diag_cmp = (abs_diag_diff(left.diag, right.diag) -
                            abs_diag_diff(prev_best.diag, right.diag))
                if diag_cmp > 0:
                    continue
                elif diag_cmp == 0:
                    gap_cmp = (calc_gap(left.eqo, right.sqo) -
                               calc_gap(prev_best.eqo, right.sqo))
                    if gap_cmp > 0:
                        continue
                    elif gap_cmp == 0 and left.path_sqo <= prev_best.path_sqo:
                        continue
            right.best_score = wrap_i16(new_score)
            right.best_prev = left
            right.path_length = left.path_length + 1
            right.path_sqo = left.path_sqo
        if left.best_score < best_score:
            continue
        if (left.best_score > best_score or
                _differentiate_equal_frag_nodes(left, best_node)):
            best_node = left
            best_score = left.best_score

    _emit_best_path(aa, qs, best_node, clump)


def _emit_best_path(aa, qs, best_node, clump: Clump) -> None:
    """processBestFragmentPath (GraphPath.cpp:134-146)."""
    node = best_node
    while node is not None:
        insert_fragment(clump, node.frag)
        node = node.best_prev
    if clump.matched_bases < aa.min_match:
        clump.reset()
    else:
        clean_up_clump(clump, aa)


def _chain_dp_vectorized(aa, nodes):
    """SoA inner-loop vectorization of the chain DP.

    The reference relaxes all right nodes j for each left node i in
    ascending-i order; for a fixed i the per-j updates are independent, so
    the inner loop becomes numpy vector ops while the outer loop and every
    tie-break stay identical (GraphPath.cpp:194-266).
    """
    import numpy as np
    n = len(nodes)
    sqo = np.array([nd.sqo for nd in nodes], np.int64)
    eqo = np.array([nd.eqo for nd in nodes], np.int64)
    diag = np.array([nd.diag for nd in nodes], np.int64)  # uint32 values
    length = np.array([nd.node_length for nd in nodes], np.int64)
    sro = (diag + sqo) & 0xFFFFFFFF
    ero = (diag + eqo) & 0xFFFFFFFF
    # SINT nodeLength/bestScore stores (int16 wrap), as in _Node.
    length_w = ((length + 0x8000) & 0xFFFF) - 0x8000
    best_score = ((length_w * aa.m_score + 0x8000) & 0xFFFF) - 0x8000
    prev_idx = np.full(n, -1, np.int64)
    path_length = np.ones(n, np.int64)
    path_sqo = sqo.copy()

    max_gap = aa.max_gap
    max_desert = aa.max_desert
    for i in range(n - 1):
        cand = sqo > sqo[i]
        cand[:i + 1] = False
        if not cand.any():
            continue
        diag_gap = np.abs(diag - diag[i])
        cand &= diag_gap <= max_gap
        cand &= sro > sro[i]
        q_gap = np.where(sqo > eqo[i], sqo - eqo[i] - 1, 0)
        r_gap = np.where(sro > ero[i], sro - ero[i] - 1, 0)
        cand &= np.minimum(q_gap, r_gap) <= max_desert
        q_ov = np.where(eqo[i] >= sqo, eqo[i] - sqo + 1, 0)
        r_ov = np.where(ero[i] >= sro, ero[i] - sro + 1, 0)
        newbases = length_w - np.maximum(q_ov, r_ov)
        cand &= newbases >= 1
        if not cand.any():
            continue
        gap_cost = np.where(diag_gap > 0,
                            -(aa.go_cost + diag_gap * aa.ge_cost), 0)
        new_score = best_score[i] + newbases * aa.m_score + gap_cost
        better = new_score > best_score
        equal = new_score == best_score
        # Tie cascade vs the stored best_prev (GraphPath.cpp:239-251).
        has_prev = prev_idx >= 0
        pidx = np.where(has_prev, prev_idx, 0)
        prev_diag_diff = np.abs(diag[pidx] - diag)
        diag_cmp = diag_gap - prev_diag_diff
        prev_gap = np.where(sqo > eqo[pidx], sqo - eqo[pidx] - 1, 0)
        gap_cmp = q_gap - prev_gap
        tie_win = has_prev & (
            (diag_cmp < 0) |
            ((diag_cmp == 0) & ((gap_cmp < 0) |
                                ((gap_cmp == 0) &
                                 (path_sqo[i] > path_sqo[pidx])))))
        accept = cand & (better | (equal & tie_win))
        if accept.any():
            wrapped = ((new_score + 0x8000) & 0xFFFF) - 0x8000
            best_score = np.where(accept, wrapped, best_score)
            prev_idx = np.where(accept, i, prev_idx)
            path_length = np.where(accept, path_length[i] + 1, path_length)
            path_sqo = np.where(accept, path_sqo[i], path_sqo)

    # Best-node fold in ascending order (GraphPath.cpp:259-266).
    best = None
    best_sc = -0x7FFFFF00
    for i in range(n):
        if best_score[i] < best_sc:
            continue
        if best_score[i] > best_sc or (
                (eqo[i] < eqo[best]) if eqo[i] != eqo[best]
                else (path_sqo[i] > path_sqo[best])):
            best = i
            best_sc = int(best_score[i])
    # Materialize the linked best path back onto the node objects.
    for k, nd in enumerate(nodes):
        nd.best_prev = nodes[prev_idx[k]] if prev_idx[k] >= 0 else None
    return nodes[best]


def check_start_end_coverage(coverage, frag: Fragment, min_left: int) -> bool:
    """checkStartEndCoverage (QueryMatch.c:177-197): keep a frag iff at
    least one end has minLeft uncovered bases."""
    min_left -= 1
    sqo, eqo = frag.sqo, frag.eqo
    if eqo - sqo < min_left:
        return False
    if not coverage[sqo:sqo + min_left + 1].any():
        return True
    if not coverage[eqo - min_left:eqo + 1].any():
        return True
    return False


def eliminate_fragments(aa, qs, frags, used, start, end, clump: Clump):
    """eliminateFragments (QueryMatch.c:201-215)."""
    if clump.is_empty:
        return
    for i in range(start, end + 1):
        if used[i]:
            continue
        if not check_start_end_coverage(qs.coverage, frags[i],
                                        aa.min_non_overlap):
            used[i] = True


def process_fragment_range(aa, qs, frags, used, start, end) -> None:
    """processFragmentRangeUsingGraph (GraphPath.cpp:272-292)."""
    qs.coverage[:qs.query_len] = False
    while True:
        clump = Clump()
        build_best_clump(aa, qs, frags, used, start, end, clump)
        if clump.is_empty:
            return
        qs.coverage[clump.sqo:clump.sqo + clump.query_len] = True
        eliminate_fragments(aa, qs, frags, used, start, end, clump)
        qs.add_clump(clump)


def process_strand(aa, qs, index, codes) -> int:
    """One strand of processQueries (Query.c:361-412 + QueryMatch.c):
    seed scan -> fragments -> clumps.  Returns the seed-hit total (the
    seedMatches stat).  Uses the fused native front end when available."""
    from .frags import seed_hits, find_fragments
    offsets, so_offs, counts = seed_hits(codes, index, aa.max_hits)
    total = int(counts.sum())
    if total == 0:
        return 0
    frags = find_fragments(offsets, so_offs, counts, index.roa,
                           index.word_len)
    process_fragments_gapped(aa, qs, frags)
    return total


def process_fragments_gapped(aa, qs, frags) -> None:
    """processFragmentsGapped (QueryMatch.c:224-303): split into reference
    regions by diagonal proximity, then chain each region."""
    frag_count = len(frags)
    if frag_count == 0:
        return
    used = [False] * frag_count
    next_frag = 0
    while next_frag < frag_count:
        start = next_frag
        # findAlignableFragsForw (QueryMatch.c:146-158).
        end = start
        cur_diag = frags[start].diag
        for i in range(start, frag_count):
            d = frags[i].diag
            if abs_diag_diff(cur_diag, d) > aa.max_gap:
                end = i - 1
                break
            cur_diag = d
            end = i
        num = 1 + end - start
        mrf = getattr(aa, "max_region_frags", 0)
        if mrf > 0 and num > mrf:
            # Safety valve (--max-region-frags): the chain DP is O(n^2)
            # per region; pathological tandem-repeat reads are skipped
            # with a warning instead of grinding for minutes (the
            # reference segfaults on such inputs).
            import sys
            print("Warning: skipped a fragment region with %d fragments "
                  "(> %d)." % (num, mrf), file=sys.stderr)
            next_frag = end + 1
            continue
        if num == 1:
            frag = frags[start]
            if frag.match_count >= aa.min_match:
                clump = Clump()
                add_fragment(clump, frag)
                qs.add_clump(clump)
        else:
            process_fragment_range(aa, qs, frags, used, start, end)
        next_frag = end + 1
