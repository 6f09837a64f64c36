"""Marsaglia 5-word xorshift RNG with bit-exact reference semantics.

Frozen copy of the port's utils/rng.py (yaha_tpu_torch).

The reference (Math.c:251-343) uses this RNG in two output-affecting places:
random down-sampling of over-maxHits k-mers at index build time
(Index.c:271-315) and coin-flip tie-breaks in the OQC clump sort
(GraphPath.cpp:382-388).  SAM/index parity therefore requires a bit-exact
reimplementation, including the modified-Floyd order-preserving sampler
(Math.c:304-343) and the query-content-derived seed (QueryState.c:171-187).
"""
from __future__ import annotations

import numpy as np

_DEFAULT_STATE = (123456789, 362436069, 521288629, 88675123, 886756453)
_M32 = 0xFFFFFFFF


class RandState:
    """Bit-exact port of randState_t + getRandBits (Math.c:274-284)."""

    __slots__ = ("s",)

    def __init__(self, state=_DEFAULT_STATE):
        self.s = list(state)

    @classmethod
    def default(cls) -> "RandState":
        return cls(_DEFAULT_STATE)

    def set_state(self, state) -> None:
        self.s = [int(x) & _M32 for x in state]

    def rand_bits(self) -> int:
        s = self.s
        t = (s[0] ^ (s[0] >> 7)) & _M32
        s[0] = s[1]
        s[1] = s[2]
        s[2] = s[3]
        s[3] = s[4]
        s[4] = ((s[4] ^ ((s[4] << 6) & _M32)) ^ (t ^ ((t << 13) & _M32))) & _M32
        return ((s[1] + s[1] + 1) * s[4]) & _M32

    def rand_double(self) -> float:
        # (double)bits / (UINT_MAX + 1.0)  (Math.c:289-292)
        return self.rand_bits() / 4294967296.0

    def rand_uint(self, start: int, end: int) -> int:
        # start + (UINT)(rand_double * (end-start))  (Math.c:295-298)
        return start + int(self.rand_double() * (end - start))

    def rand_sample(self, inp: np.ndarray, out_len: int) -> np.ndarray:
        """Order-preserving sample without replacement (Math.c:304-343).

        Modified Floyd: marks either the keepers or the discards depending on
        which set is smaller, then emits input order.  Must consume RNG draws
        in exactly the reference order.
        """
        in_len = len(inp)
        marked = np.zeros(in_len, dtype=bool)
        keep_marked = True
        select_num = out_len
        if out_len > in_len // 2:
            keep_marked = False
            select_num = in_len - out_len
        for i in range(in_len - select_num, in_len):
            pos = self.rand_uint(0, i + 1)
            if marked[pos]:
                marked[i] = True
            else:
                marked[pos] = True
        return inp[marked] if keep_marked else inp[~marked]


def query_seed_state(forward_codes: np.ndarray, query_len: int):
    """Derive the per-query RNG seed from the read's 4-bit codes.

    Port of generateRandomSeed (QueryState.c:171-187): 5 words, each 16
    2-bit codes packed MSB-first, wrapping around the query as needed.
    """
    state = []
    qoffset = 0
    for _ in range(5):
        word = 0
        for _ in range(16):
            word = ((word << 2) | (int(forward_codes[qoffset]) & 0x3)) & _M32
            qoffset += 1
            if qoffset >= query_len:
                qoffset = 0
        state.append(word)
    return state
