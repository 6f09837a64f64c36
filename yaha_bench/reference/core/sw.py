"""Reference-exact banded affine-gap DP (the benchmark's plain reference).

Frozen copy of the pure-Python DP of the port's core/sw.py.  Semantics port of
findAffineGapScore (SW.cpp:798-1208) and its wrappers — anchored
full/banded alignment for seed-gap fill and X-dropoff extensions —
including the indel tie rules (extensions prefer indels: `>=` at
SW.cpp:1036,1054), the maxIntron/maxGap indel run caps, the columnar band
layout, and the run-length backtrack.  The core keeps its rows and cells
in Python lists of exact ints; test_bench_reference.py holds the same loop
over numpy arrays and compares the two.
"""
from __future__ import annotations

import numpy as np

from .editops import EditOpList, MATCH, REPLACE, INSERT, DELETE

DP_WORST = -(0x7FFFFF00)
_UNKNOWN = "U"


def _find_affine_gap_score(aa, q, r, banded, extension, reverse, xcutoff,
                           band_width):
    """Core DP.  q and r are int arrays of 4-bit codes, already oriented
    (for reverse extensions the caller passes reversed slices).  Returns
    (score, oplist_items, maxi, maxj, bandwidth) — oplist built in the
    reference's emit order (front-insert for forward, back for reverse) is
    returned as a plain list in final order.
    """
    go, ge = aa.go_cost, aa.ge_cost
    rc, ms = aa.r_cost, aa.m_score
    max_intron, max_gap = aa.max_intron, aa.max_gap
    q_len, r_len = len(q), len(r)
    arr_height = q_len + 1

    if banded:
        if extension:
            bandwidth = 2 * band_width
            left_bw = right_bw = bandwidth
            maxi = maxj = 0
        else:
            bandwidth = band_width
            if r_len > q_len:
                right_bw = bandwidth + (r_len - q_len)
                left_bw = bandwidth
            else:
                left_bw = bandwidth + (q_len - r_len)
                right_bw = bandwidth
            maxi, maxj = q_len, right_bw
        arr_width = left_bw + right_bw + 1
    else:
        bandwidth = band_width
        left_bw = right_bw = 0
        arr_width = r_len + 1
        maxi, maxj = arr_height - 1, arr_width - 1

    # Backtrack arrays (+1 col of headroom like the reference's arrWidth+2
    # overflow slots; we size exactly and guard instead): a row of Python
    # lists is made when the DP first writes it, since an X-drop extension
    # stops long before its arr_height (the remaining query) rows; a row
    # never written reads _UNKNOWN / 0.  Plain lists and ints, not numpy
    # scalars: the same exact integers, read and written per cell.
    eo = [None] * arr_height
    idc = [None] * arr_height

    def row(i):
        if eo[i] is None:
            eo[i] = [_UNKNOWN] * arr_width
            idc[i] = [0] * arr_width
        return eo[i], idc[i]

    # PVRow has a [-1] hack slot in the reference (DPInit, SW.cpp:385-388):
    # pv[k + 1] is PV(k), and so for pf and pi.
    pv = [DP_WORST] * (arr_width + 2)
    pf = [DP_WORST] * (arr_width + 2)
    pi = [0] * (arr_width + 2)
    r = np.asarray(r).tolist()

    eo0, idc0 = row(0)
    if banded:
        start_init = left_bw + 1
        eo0[left_bw] = _UNKNOWN
        idc0[left_bw] = 0
        pf[arr_width + 1] = DP_WORST
        pv[arr_width + 1] = DP_WORST
        pi[arr_width + 1] = 0
    else:
        start_init = 1
        eo0[0] = _UNKNOWN
        idc0[0] = 0
    end_init = arr_width
    delete_count = 1
    for j in range(start_init, end_init):
        eo0[j] = DELETE
        idc0[j] = delete_count
        pv[j + 1] = -(go + delete_count * ge)
        delete_count += 1
        pf[j + 1] = DP_WORST
        pi[j + 1] = 0
    pf[start_init] = 0
    pi[start_init] = 0
    pv[start_init] = 0

    # The reference initializes leftBW rows here even when qLen < leftBW
    # (its arrays are maxQueryLength tall, SW.cpp:925-933); rows beyond
    # qLen are never read, so clamping is equivalent.
    end_init = min(left_bw if banded else arr_height - 1, arr_height - 1)
    for i in range(1, end_init + 1):
        loffset = (left_bw - i) if banded else 0
        eo_i, idc_i = row(i)
        eo_i[loffset] = INSERT
        idc_i[loffset] = i

    max_score = DP_WORST
    cutoff = aa.x_cutoff

    if not banded:
        start_col, end_col = 1, arr_width - 1

    V = 0
    for i in range(1, arr_height):
        pd_col = 0
        pe_col = DP_WORST
        if banded:
            start_col = left_bw + 1 - i
            if start_col <= 0:
                start_col = 0
                pv_col = DP_WORST
            else:
                pv_col = -(go + i * ge)
                pv[start_col] = pv_col
            end_col = min(left_bw + r_len - i, arr_width - 1)
        else:
            pv_col = -(go + i * ge)

        row_max = DP_WORST
        q_char = int(q[1 - i] if reverse else q[i - 1])
        r_row_start = i - left_bw - 1 if banded else 0

        eo_row, idc_row = row(i)
        for j in range(start_col, end_col + 1):
            rm_off = j if banded else j - 1
            i_off = rm_off + 1

            V = pv[rm_off + 1]
            r_char = r[r_row_start + j] if banded else r[j - 1]
            if q_char == r_char:
                V += ms
                opcode = MATCH
            else:
                V -= rc
                opcode = REPLACE

            # Delete (gap in query, consumes reference).
            ce = pe_col - ge
            ne = pv_col - (go + ge)
            if ce >= ne and (pd_col + 1) <= max_intron:
                pe_col = ce
                pd_col += 1
            else:
                pe_col = ne
                pd_col = 1
            if (pe_col >= V) if extension else (pe_col > V):
                V = pe_col
                opcode = DELETE
                idc_row[j] = pd_col

            # Insert (gap in reference, consumes query).
            cf = pf[i_off + 1] - ge
            nf = pv[i_off + 1] - (go + ge)
            if cf >= nf and (pi[i_off + 1] + 1) <= max_gap:
                F = cf
                I = pi[i_off + 1] + 1
            else:
                F = nf
                I = 1
            if (F >= V) if extension else (F > V):
                V = F
                opcode = INSERT
                idc_row[j] = I
            pf[j + 1] = F
            pi[j + 1] = I

            eo_row[j] = opcode
            if xcutoff and V > row_max:
                row_max = V
            if extension and V > max_score:
                max_score = V
                maxi, maxj = i, j
            if banded:
                pv[j + 1] = V
            else:
                pv[j] = pv_col
            pv_col = V

        if xcutoff and extension and row_max < (max_score - cutoff):
            break
        if not banded:
            pv[end_col + 1] = V

    retval = max_score if extension else V
    if extension and retval <= 0:
        return 0, [], 0, 0, bandwidth

    # Backtrack (SW.cpp:1137-1195).
    x, y = maxj, maxi
    prev_code = _UNKNOWN if eo[y] is None else eo[y][x]
    op_len = 0
    items = []  # built via front-insert (forward) or append (reverse)
    while True:
        code = _UNKNOWN if eo[y] is None else eo[y][x]
        if code == _UNKNOWN:
            break
        eolen = idc[y][x]
        if banded:
            if code == DELETE:
                x -= eolen
            elif code == INSERT:
                x += eolen
                y -= eolen
            else:
                y -= 1
                eolen = 1
        else:
            if code == DELETE:
                x -= eolen
            elif code == INSERT:
                y -= eolen
            else:
                x -= 1
                y -= 1
                eolen = 1
        if prev_code != code:
            if reverse:
                items.append([prev_code, op_len])
            else:
                items.insert(0, [prev_code, op_len])
            prev_code = code
            op_len = eolen
        else:
            op_len += eolen
    if reverse:
        items.append([prev_code, op_len])
    else:
        items.insert(0, [prev_code, op_len])

    return retval, items, maxi, maxj, bandwidth


def find_ags_alignment(aa, genome_codes, r_off, r_len, q_codes, q_off, q_len,
                       out_list: EditOpList, banded: bool) -> int:
    """findAGSAlignment[Banded] (SW.cpp:462-475): anchored gap-fill DP."""
    r = genome_codes[r_off:r_off + r_len]
    q = q_codes[q_off:q_off + q_len]
    score, items, _, _, _ = _find_affine_gap_score(
        aa, q, r, banded, False, False, False, aa.band_width)
    out_list.items = items
    return score


def find_ags_extension(aa, genome_codes, max_roff, r_off, q_codes, q_off,
                       q_len, out_list: EditOpList, reverse: bool):
    """findAGSExtension<reverse> (SW.cpp:479-533).

    Returns (score, added_q_len, added_r_len); merges the extension ops
    into out_list when score > 0.
    """
    q_len = int(q_len)
    if q_len <= 0:
        return 0, 0, 0
    bandwidth = 2 * aa.band_width
    r_len = q_len + bandwidth
    if reverse:
        if r_len > r_off:
            r_len = r_off + 1
            q_len = r_len - bandwidth
            if q_len <= 0:
                return 0, 0, 0
        r = genome_codes[r_off - r_len + 1:r_off + 1][::-1]
    else:
        if r_off + r_len > max_roff:
            r_len = max_roff - r_off
            q_len = r_len - bandwidth
            if q_len <= 0:
                return 0, 0, 0
        r = genome_codes[r_off:r_off + r_len]
    if reverse:
        # qStr indexed qStr[qOff + 1 - i], i in 1..qLen.
        q = q_codes[q_off - q_len + 1:q_off + 2]  # slice w/ q[1-i] semantics
        # Use a view where index [1-i] works: pass full array with offset.
        q = _RevView(q_codes, q_off)
    else:
        q = q_codes[q_off:q_off + q_len]

    score, items, maxi, maxj, bw = _find_affine_gap_score(
        aa, _LenWrap(q, q_len), r, True, True, reverse, True, aa.band_width)
    if score <= 0:
        return 0, 0, 0
    added_q = maxi
    added_r = maxi + (maxj - bw)
    tmp = EditOpList(items)
    if reverse:
        out_list.merge_to_front(tmp)
    else:
        out_list.merge_to_back(tmp)
    return score, added_q, added_r


class _RevView:
    """Index view supporting q[1-i] for backward extensions."""

    __slots__ = ("codes", "off", "n")

    def __init__(self, codes, off):
        self.codes = codes
        self.off = off
        self.n = off + 1

    def __getitem__(self, i):
        return self.codes[self.off + i]

    def __len__(self):  # qLen is passed separately; len unused
        return self.n


class _LenWrap:
    """Wraps a 1-indexable object with an explicit length."""

    __slots__ = ("obj", "n")

    def __init__(self, obj, n):
        self.obj = obj
        self.n = n

    def __getitem__(self, i):
        return self.obj[i]

    def __len__(self):
        return self.n


def find_ags_forward_extension_carefully(aa, genome_codes, max_roff, r_off,
                                         q_codes, q_off, q_len,
                                         out_list: EditOpList, score):
    """findAGSForwardExtensionCarefully (SW.cpp:553-669)."""
    tmp = EditOpList()
    init_ags, added_q, added_r = find_ags_extension(
        aa, genome_codes, max_roff, r_off, q_codes, q_off, q_len, tmp, False)
    if init_ags <= 0:
        return 0, 0, 0
    ql = rl = 0
    ags = score
    max_ags = score
    max_idx = -1
    max_ql = max_rl = 0
    for idx, (op, length) in enumerate(tmp.items):
        if op == MATCH:
            ql += length
            rl += length
            ags += aa.m_score * length
        elif op == REPLACE:
            ql += length
            rl += length
            ags -= aa.r_cost * length
        elif op == INSERT:
            ql += length
            ags -= aa.go_cost + aa.ge_cost * length
        elif op == DELETE:
            rl += length
            ags -= aa.go_cost + aa.ge_cost * length
        if ags > max_ags:
            max_ags = ags
            max_ql, max_rl = ql, rl
            max_idx = idx
        elif ags <= 0:
            if max_ags <= score:
                return 0, 0, 0
            tmp.split_after(max_idx)  # discard unwanted tail
            added_q, added_r = max_ql, max_rl
            init_ags = max_ags - score
            break
    out_list.merge_to_back(tmp)
    return init_ags, added_q, added_r


def find_ags_backward_extension_carefully(aa, genome_codes, max_roff, r_off,
                                          q_codes, q_off, q_len,
                                          out_list: EditOpList, score):
    """findAGSBackwardExtensionCarefully (SW.cpp:671-788)."""
    tmp = EditOpList()
    init_ags, added_q, added_r = find_ags_extension(
        aa, genome_codes, max_roff, r_off, q_codes, q_off, q_len, tmp, True)
    if init_ags <= 0:
        return 0, 0, 0
    ql = rl = 0
    ags = 0
    max_ags = 0
    start_idx = -1
    for idx, (op, length) in enumerate(tmp.items):
        if op == MATCH:
            ql += length
            rl += length
            ags += aa.m_score * length
        elif op == REPLACE:
            ql += length
            rl += length
            ags -= aa.r_cost * length
        elif op == INSERT:
            ql += length
            ags -= aa.go_cost + aa.ge_cost * length
        elif op == DELETE:
            rl += length
            ags -= aa.go_cost + aa.ge_cost * length
        if ags <= 0:
            ags = 0
            max_ags = 0
            ql = rl = 0
            start_idx = idx
        if ags > max_ags:
            max_ags = ags
    if ags <= 0 or max_ags >= ags + score:
        return 0, 0, 0
    if start_idx >= 0:
        wanted = tmp.split_after(start_idx)
        out_list.merge_to_front(wanted)
    else:
        out_list.merge_to_front(tmp)
    return ags, ql, rl
