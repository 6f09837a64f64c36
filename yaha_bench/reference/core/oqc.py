"""Optimal Query Coverage (OQC), FBS similarity filtering, and dup removal.

Frozen copy of the port's core/oqc.py (yaha_tpu_torch).

Ports the clump half of GraphPath.cpp: the RNG-tie-break quicksort
(GraphPath.cpp:365-459 — transliterated exactly because coin flips consume
the per-query RNG stream in comparison order), subsumed-dup deletion
(461-517), the breakpoint-penalty interval DP with accurate overlap scores
(694-1086), FBS + mapping quality (519-692), and the non-OQC dup removal
(1088-1174).
"""
from __future__ import annotations

import math

from .cints import wrap_i16, c_div
from .editops import MATCH, REPLACE, INSERT, DELETE

WORST_SCORE = -0x7FFFFF00


class _CNode:
    __slots__ = ("best_prev", "clump", "best_score", "path_length",
                 "sro", "ero", "sqo", "eqo", "node_length", "node_score",
                 "q_len_in_oqc", "reversed", "seq_num", "dead")

    def __init__(self, aa, qs, clump):
        """initcGraphNode (GraphPath.cpp:342-363)."""
        self.best_prev = None
        self.path_length = 1
        self.clump = clump
        # bestScore/nodeScore are SINT = int16 in the reference
        # (GraphPath.cpp:305-307): clump scores above 32767 wrap negative,
        # which changes which alignments win OQC.  Parity-critical.
        self.best_score = self.node_score = wrap_i16(clump.tot_score)
        self.node_length = wrap_i16(clump.tot_length)
        self.sqo = clump.plus_sqo(qs.query_len)
        self.eqo = clump.plus_eqo(qs.query_len)
        self.sro = clump.sro
        self.ero = clump.ero
        self.reversed = clump.reversed
        self.q_len_in_oqc = clump.query_len
        # seqNum is a UBYTE in the reference (Math.h:323).
        self.seq_num = qs.find_seq_num(self.sro) & 0xFF
        self.dead = False


def _compare_key(node: _CNode) -> int:
    """getCompareKey (GraphPath.cpp:377-380): (SQO asc, EQO desc,
    score desc) packed into a u64."""
    return ((((node.sqo << 16) + ((-node.eqo) & 0xFFFF)) << 16) +
            ((-node.node_score) & 0xFFFF))


def _node_less_than(n1: _CNode, n2: _CNode, rng) -> bool:
    """graphNodeLessThan (GraphPath.cpp:382-388): coin flip on full tie."""
    k1 = _compare_key(n1)
    k2 = _compare_key(n2)
    if k1 == k2:
        return bool(rng.rand_bits() & 0x1)
    return k1 < k2


def _quick_sort(nodes: list, rng) -> None:
    """myQuickSort (GraphPath.cpp:427-459), transliterated so the RNG is
    consumed in the same comparison order as the reference."""

    def helper(left, right):
        if left >= right:
            return
        pivot_index = (left + right) // 2
        nodes[pivot_index], nodes[right] = nodes[right], nodes[pivot_index]
        pivot = nodes[right]
        store = left
        for i in range(left, right):
            if _node_less_than(nodes[i], pivot, rng):
                nodes[i], nodes[store] = nodes[store], nodes[i]
                store += 1
        nodes[store], nodes[right] = nodes[right], nodes[store]
        helper(left, store - 1)
        helper(store + 1, right)

    helper(0, len(nodes) - 1)


def _delete_subsumed_dups(qs, nodes: list) -> list:
    """deleteSubsumedDups (GraphPath.cpp:488-517)."""
    out = []
    n = len(nodes)
    for i in range(n):
        cur = nodes[i]
        if cur.dead:
            continue
        out.append(cur)
        # C int division truncates toward zero; wrapped scores can be
        # negative (GraphPath.cpp:501).
        threshold = c_div(cur.node_score, 8)
        for j in range(i + 1, n):
            nxt = nodes[j]
            if nxt.dead:
                continue
            if nxt.eqo > cur.eqo:
                break
            # nodeIsSubsumed (GraphPath.cpp:477-480): EQO strictly greater
            # for cur means nxt contained; sort guarantees nxt.sqo >= cur.sqo.
            subsumed = (cur.eqo > nxt.eqo and nxt.node_score < threshold)
            dups = (cur.sro == nxt.sro and cur.ero == nxt.ero and
                    cur.reversed == nxt.reversed and cur.sqo == nxt.sqo and
                    cur.eqo == nxt.eqo)
            if subsumed or dups:
                nxt.dead = True
    return out


def _calc_score_for_length(items, length, aa, forward: bool) -> int:
    """calcScoreForLength<forward> (GraphPath.cpp:705-732)."""
    q_len = 0
    ags = 0
    seq = items if forward else list(reversed(items))
    for op, ln in seq:
        if q_len >= length:
            break
        if op == DELETE:
            ags -= aa.go_cost + aa.ge_cost * ln
        else:
            if q_len + ln > length:
                ln = length - q_len
            q_len += ln
            if op == MATCH:
                ags += aa.m_score * ln
            elif op == REPLACE:
                ags -= aa.r_cost * ln
            elif op == INSERT:
                ags -= aa.go_cost + aa.ge_cost * ln
    return ags


def _calc_accurate_overlap_score(left: _CNode, right: _CNode, overlap, aa):
    """calcAccurateOverlapScore (GraphPath.cpp:744-800).

    Returns (score, right_best).
    """
    right_items = right.clump.eol.items
    if right.reversed:
        right_overlap_score = _calc_score_for_length(right_items, overlap,
                                                     aa, forward=False)
    else:
        right_overlap_score = _calc_score_for_length(right_items, overlap,
                                                     aa, forward=True)
    path_overlap_score = 0
    remaining = overlap
    cur = left
    while True:
        cur_items = cur.clump.eol.items
        cur_rev_qlen = min(remaining, cur.q_len_in_oqc)
        remaining -= cur_rev_qlen
        if cur.reversed:
            path_overlap_score += _calc_score_for_length(
                cur_items, cur_rev_qlen, aa, forward=True)
        else:
            path_overlap_score += _calc_score_for_length(
                cur_items, cur_rev_qlen, aa, forward=False)
        if remaining <= 0:
            break
        cur = cur.best_prev
    if path_overlap_score > right_overlap_score:
        return right_overlap_score, False
    return path_overlap_score, True


def _cache_qlen_reverse(left: _CNode, right: _CNode, overlap, right_best):
    """cacehQlenInOQCPathReverse (GraphPath.cpp:802-826)."""
    if right_best:
        right.q_len_in_oqc = 1 + right.eqo - right.sqo
        remaining = overlap
        cur = left
        while True:
            cur_rev = min(remaining, cur.q_len_in_oqc)
            cur.q_len_in_oqc -= cur_rev
            remaining -= cur_rev
            if remaining <= 0:
                break
            cur = cur.best_prev
    else:
        right.q_len_in_oqc = (1 + right.eqo - right.sqo) - overlap


def _cache_qlen_path(right: _CNode, aa) -> _CNode:
    """cacheQlenInOQCPath (GraphPath.cpp:841-867), recursive re-cache."""
    q_len = 1 + right.eqo - right.sqo
    if right.best_prev is None:
        right.q_len_in_oqc = q_len
        return right
    left = _cache_qlen_path(right.best_prev, aa)
    overlap = max(left.eqo - right.sqo + 1, 0) if left.eqo >= right.sqo else 0
    if overlap > 0:
        _, right_best = _calc_accurate_overlap_score(left, right, overlap, aa)
        _cache_qlen_reverse(left, right, overlap, right_best)
    else:
        right.q_len_in_oqc = q_len
    return right


def _cache_qlen_right(right: _CNode, overlap, right_best):
    """cacheQlenInRightNode (GraphPath.cpp:873-878)."""
    q_len = 1 + right.eqo - right.sqo
    right.q_len_in_oqc = q_len if right_best else q_len - overlap


class _PrimaryAttrs:
    __slots__ = ("aligned_query_length", "num_output_secondaries",
                 "second_score", "third_score")

    def __init__(self, node: _CNode):
        self.aligned_query_length = 1 + node.eqo - node.sqo
        self.second_score = 0
        self.third_score = 0
        self.num_output_secondaries = 0


def _filter_by_similarity(aa, qs, nodes, best_node: _CNode) -> None:
    """filterBySimilarity (GraphPath.cpp:571-692)."""
    new_clumps = []
    prime_count = best_node.path_length
    primaries = [None] * prime_count
    pa_array = [None] * prime_count
    idx = prime_count - 1
    path_node = best_node
    while path_node is not None:
        primaries[idx] = path_node
        pa_array[idx] = _PrimaryAttrs(path_node)
        clump = path_node.clump
        clump.primary = True
        clump.matched_primary = idx + 1
        new_clumps.insert(0, clump)
        path_node_prev = path_node.best_prev
        path_node.dead = True
        path_node = path_node_prev
        idx -= 1

    target_overlap = aa.fbs_ps_length
    for cur in nodes:
        if cur.dead:
            continue
        clump = cur.clump
        cur_sqo, cur_eqo = cur.sqo, cur.eqo
        cur_qlen = 1 + cur_eqo - cur_sqo
        max_overlap = 0
        max_index = 0
        for i in range(prime_count):
            p = primaries[i]
            overlap = 1 + min(cur_eqo, p.eqo) - max(cur_sqo, p.sqo)
            if overlap > max_overlap:
                max_overlap = overlap
                max_index = i
        if max_overlap > 0:
            pas = pa_array[max_index]
            # memoPAsFromOverlappingNode (GraphPath.cpp:545-557).
            if cur.node_score > pas.second_score:
                pas.third_score = pas.second_score
                pas.second_score = cur.node_score
            elif cur.node_score > pas.third_score:
                pas.third_score = cur.node_score
            p = primaries[max_index]
            # C double division: inf/nan instead of raising when the
            # (wrapped) primary score is zero.
            if p.node_score != 0:
                ratio = cur.node_score / p.node_score
            elif cur.node_score > 0:
                ratio = float("inf")
            elif cur.node_score < 0:
                ratio = float("-inf")
            else:
                ratio = float("nan")
            if ratio >= aa.fbs_ps_score:
                overlap = 1 + min(cur_eqo, p.eqo) - max(cur_sqo, p.sqo)
                path_qlen = pas.aligned_query_length
                if (overlap / cur_qlen >= target_overlap and
                        overlap / path_qlen >= target_overlap):
                    pas.num_output_secondaries += 1
                    if aa.fbs:
                        clump.matched_primary = max_index + 1
                        new_clumps.insert(0, clump)
                        continue
        # Secondary not output; drop it.

    qs.clumps = new_clumps
    qs.primary_count = prime_count

    # calcMQfromPAs (GraphPath.cpp:559-569).
    for i in range(prime_count):
        clump = primaries[i].clump
        pas = pa_array[i]
        if pas.second_score == 0:
            clump.map_quality = 250
        elif clump.tot_score == 0:
            # C: 0/0 -> nan, (int)(nan*250+0.5) is UB; in practice 0.
            clump.map_quality = 0
        else:
            ratio = max(float(clump.tot_score - pas.second_score), 0.0) / float(clump.tot_score)
            ratio = ratio * (1.0 + max(float(clump.tot_score - pas.third_score), 0.0) / clump.tot_score) / 2.0
            clump.map_quality = int(250.0 * ratio + 0.5) & 0xFF
        clump.num_secondaries = pas.num_output_secondaries


def post_filter_by_similarity(aa, qs) -> None:
    """postFilterBySimilarity (GraphPath.cpp:897-1086): the OQC DP."""
    node_count = len(qs.clumps)
    if node_count < 1:
        return
    if node_count == 1:
        clump = qs.clumps[0]
        clump.primary = True
        clump.map_quality = 250
        clump.num_secondaries = 0
        clump.matched_primary = 1
        qs.primary_count = 1
        return

    nodes = [_CNode(aa, qs, c) for c in qs.clumps]
    _quick_sort(nodes, qs.rand_gen)
    nodes = _delete_subsumed_dups(qs, nodes)

    best_score = WORST_SCORE
    best_node = None
    min_non_overlap = aa.oqc_min_non_overlap
    bp_cost = aa.bp_cost
    mbpl = aa.max_bp_log
    n = len(nodes)
    startj = 1
    for i in range(n):
        left = nodes[i]
        _cache_qlen_path(left, aa)
        left_sqo = left.sqo
        left_eqo = left.eqo
        found_startj = False
        for j in range(startj, n):
            right = nodes[j]
            right_sqo = right.sqo
            if (right_sqo - left_sqo) >= min_non_overlap:
                if not found_startj:
                    startj = j
                    found_startj = True
                right_eqo = right.eqo
                if (right_eqo - left_eqo) >= min_non_overlap:
                    # SINT newScore (GraphPath.cpp:1004): int16 wrap.
                    new_score = wrap_i16(left.best_score + right.node_score)
                    if right.best_score > new_score:
                        continue
                    # Breakpoint penalty (GraphPath.cpp:1006-1025).
                    if left.seq_num == right.seq_num:
                        if left.sro > right.ero:
                            distance = left.sro - right.ero
                        elif right.sro > left.ero:
                            distance = right.sro - left.ero
                        else:
                            distance = 0
                        if distance <= 10:
                            bpp = bp_cost
                        else:
                            lg = math.log10(distance)
                            if lg > mbpl:
                                lg = float(mbpl)
                            bpp = int(lg * bp_cost + 0.5)
                    else:
                        bpp = mbpl * bp_cost
                    new_score = wrap_i16(new_score - bpp)
                    if right.best_score > new_score:
                        continue
                    overlap = (left_eqo - right_sqo + 1
                               if left_eqo >= right_sqo else 0)
                    right_best = False
                    if overlap > 0:
                        ov_score, right_best = _calc_accurate_overlap_score(
                            left, right, overlap, aa)
                        new_score = wrap_i16(new_score - ov_score)
                        if right.best_score > new_score:
                            continue
                    if (right.best_score < new_score or
                            (right.best_prev is not None and
                             left.path_length < right.best_prev.path_length)):
                        if overlap > 0:
                            _cache_qlen_right(right, overlap, right_best)
                        right.best_score = new_score
                        right.best_prev = left
                        right.path_length = left.path_length + 1
        if not found_startj:
            startj = n
        if left.best_score < best_score:
            continue
        if (left.best_score > best_score or
                (best_node is not None and
                 left.path_length < best_node.path_length)):
            best_node = left
            best_score = left.best_score

    _filter_by_similarity(aa, qs, nodes, best_node)


def post_filter_remove_dups(aa, qs) -> None:
    """postFilterRemoveDups (GraphPath.cpp:1127-1174) for -OQC N mode.

    The reference qsort comparator is (SRO asc, score desc); glibc qsort is
    a stable mergesort, which Python's sorted matches.
    """
    node_count = len(qs.clumps)
    if node_count < 2:
        return
    elems = [[c, c.sro, c.tot_score] for c in qs.clumps]
    elems.sort(key=lambda e: (e[1], -e[2]))

    def are_dups(c1, c2):
        return (c1.sro == c2.sro and c1.sqo == c2.sqo and c1.eqo == c2.eqo
                and c1.ero == c2.ero and c1.reversed == c2.reversed)

    new_clumps = []
    for i in range(node_count):
        c1 = elems[i][0]
        if c1 is None:
            continue
        for j in range(i + 1, node_count):
            if elems[i][1] < elems[j][1]:
                break
            c2 = elems[j][0]
            if c2 is None:
                continue
            if are_dups(c1, c2):
                elems[j][0] = None
        new_clumps.insert(0, c1)
    qs.clumps = new_clumps
