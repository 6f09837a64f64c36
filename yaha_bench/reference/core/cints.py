"""C integer-width emulation helpers.

Frozen copy of the port's core/cints.py (yaha_tpu_torch).

The reference stores several scores in narrow types that silently wrap:
clump totScore/totLength/matchedBases are QOFF = uint16 (Math.h:517-521),
and both graph DPs keep bestScore/nodeScore in SINT = int16
(GraphPath.cpp:71,305-317).  A 20 kb read at MScore 2 scores ~38000, which
wraps negative in the OQC node and loses to alternatives — observable in
reference output, so byte parity requires reproducing the wraps.
"""


def wrap_i16(x: int) -> int:
    """Store through int16_t (two's complement wrap)."""
    return ((int(x) + 0x8000) & 0xFFFF) - 0x8000


def wrap_u16(x: int) -> int:
    """Store through uint16_t."""
    return int(x) & 0xFFFF


def c_div(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q
