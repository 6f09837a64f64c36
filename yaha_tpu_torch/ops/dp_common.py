"""DP constants shared by the kernels' wrappers, their plain versions and
the backtrack walk, and the host decodes of one problem's planes.

The port's copy of the constants of yaha_tpu/ops/dp_common.py, and of its
two unpacked-plane tracebacks, which the oracle engine runs on the
native host DPs' eo/idc planes (core/sw.py); the same values are in
csrc/sw_cells.cuh.
"""
from __future__ import annotations

DP_WORST = -(0x7FFFFF00)

# Op codes (int8) of the backtrack planes, and the reference's op chars.
OP_UNKNOWN = 0
OP_MATCH = 1
OP_REPLACE = 2
OP_INSERT = 3
OP_DELETE = 4
OP_CHARS = ["U", "M", "R", "I", "D"]

# Packed-backtrack bits above the op (bits 0-2): "delete run continues one
# cell left" and "insert run continues up the chain".
BT_CD = 8
BT_CF = 16


def traceback_extension(eo, idc, maxi, maxj, score, bw2, reverse):
    """Host run-length decode of one problem's backtrack arrays.

    Mirrors the banded backtrack (SW.cpp:1137-1195): Delete moves left in
    the band, Insert moves up-right, M/R up.  Returns (items, added_q,
    added_r) with items in final list order.
    """
    if score <= 0:
        return [], 0, 0
    x = int(maxj)
    y = int(maxi)
    prev = int(eo[y][x])
    op_len = 0
    items = []
    while True:
        code = int(eo[y][x])
        if code == OP_UNKNOWN:
            break
        length = int(idc[y][x])
        if code == OP_DELETE:
            x -= length
        elif code == OP_INSERT:
            x += length
            y -= length
        else:
            y -= 1
            length = 1
        if prev != code:
            if reverse:
                items.append([OP_CHARS[prev], op_len])
            else:
                items.insert(0, [OP_CHARS[prev], op_len])
            prev = code
            op_len = length
        else:
            op_len += length
    if reverse:
        items.append([OP_CHARS[prev], op_len])
    else:
        items.insert(0, [OP_CHARS[prev], op_len])
    added_q = int(maxi)
    added_r = int(maxi) + (int(maxj) - bw2)
    return items, added_q, added_r


def traceback_anchored(eo, idc, qlen, rlen):
    """Host run-length decode for anchored problems (full coordinates).

    Mirrors the non-banded backtrack arm (SW.cpp:1172-1178); banded
    problems computed by batched_anchored_forward land on the same cells
    in full coordinates.
    """
    x = int(rlen)
    y = int(qlen)
    prev = int(eo[y][x])
    op_len = 0
    items = []
    while True:
        code = int(eo[y][x])
        if code == OP_UNKNOWN:
            break
        length = int(idc[y][x])
        if code == OP_DELETE:
            x -= length
        elif code == OP_INSERT:
            y -= length
        else:
            x -= 1
            y -= 1
            length = 1
        if prev != code:
            items.insert(0, [OP_CHARS[prev], op_len])
            prev = code
            op_len = length
        else:
            op_len += length
    items.insert(0, [OP_CHARS[prev], op_len])
    return items
