"""Run-length edit operations for alignments.

Frozen copy of the port's core/editops.py (yaha_tpu_torch).

The reference stores edit ops in a doubly-linked list over a slab array
(SW.cpp:38-321, Math.h:352-413).  Here an EditOpList is a plain Python list
of [opcode, length] pairs; merge operations knit equal opcodes at the seam
exactly like mergeEOLToFront/Back (SW.cpp:151-261).  Op codes are the
output characters themselves (Math.h:352-360).
"""
from __future__ import annotations

MATCH = "M"
REPLACE = "R"
INSERT = "I"
DELETE = "D"
HARD_CLIP = "H"
SOFT_CLIP = "S"


class EditOpList:
    """Run-length op list; items are mutable [op, length] pairs."""

    __slots__ = ("items",)

    def __init__(self, items=None):
        self.items = items if items is not None else []

    def __bool__(self):
        return bool(self.items)

    def __iter__(self):
        return iter(self.items)

    def __repr__(self):
        return "".join("%d%s" % (l, op) for op, l in self.items)

    def clear(self):
        self.items = []

    def add_front(self, op: str, length: int) -> None:
        self.items.insert(0, [op, length])

    def add_back(self, op: str, length: int) -> None:
        self.items.append([op, length])

    def first(self):
        return self.items[0]

    def last(self):
        return self.items[-1]

    def merge_to_front(self, source: "EditOpList") -> None:
        """Prepend source, knitting equal opcodes at the seam
        (mergeEOLToFront, SW.cpp:151-205).  Empties source."""
        if not source.items:
            return
        if self.items and source.items[-1][0] == self.items[0][0]:
            source.items[-1][1] += self.items[0][1]
            self.items = source.items + self.items[1:]
        else:
            self.items = source.items + self.items
        source.items = []

    def merge_to_back(self, source: "EditOpList") -> None:
        """Append source, knitting equal opcodes (mergeEOLToBack,
        SW.cpp:207-261).  Empties source."""
        if not source.items:
            return
        if self.items and self.items[-1][0] == source.items[0][0]:
            self.items[-1][1] += source.items[0][1]
            self.items = self.items + source.items[1:]
        else:
            self.items = self.items + source.items
        source.items = []

    def split_before(self, idx: int) -> "EditOpList":
        """Split so self keeps items[:idx], returns tail items[idx:]
        (splitEditOpListBefore, SW.cpp:263-272)."""
        tail = EditOpList(self.items[idx:])
        self.items = self.items[:idx]
        return tail

    def split_after(self, idx: int) -> "EditOpList":
        """Split so self keeps items[:idx+1], returns tail items[idx+1:]
        (splitEditOpListAfter, SW.cpp:274-283)."""
        tail = EditOpList(self.items[idx + 1:])
        self.items = self.items[:idx + 1]
        return tail

    def max_match_at_least(self, minimum: int) -> bool:
        """EditOpList2Maxmatch (SW.cpp:1215-1222)."""
        return any(op == MATCH and l >= minimum for op, l in self.items)

    def ags(self, aa) -> int:
        """EditOpList2AGS (SW.cpp:1225-1237)."""
        score = 0
        for op, l in self.items:
            if op == MATCH:
                score += aa.m_score * l
            elif op == REPLACE:
                score -= aa.r_cost * l
            elif op in (INSERT, DELETE):
                score -= aa.go_cost + aa.ge_cost * l
        return score
