"""4-bit DNA codec tables and vectorized conversions.

Frozen copy of the port's utils/codec.py (yaha_tpu_torch).
Code values match the reference exactly (Math.c:141-157): T/U=0, C=1, A=2,
G=3, N=4, IUPAC codes 5-13/15, X (and every unmapped char) = 14.  Packing is
two codes per byte, high nibble first (Math.c:180-188).
"""
from __future__ import annotations

import numpy as np

# char -> 4-bit code for all 256 byte values (reference covers 0-127,
# Math.c:141-152; FASTA input is ASCII so 128-255 also map to X=14).
FOUR_BIT_CODES = np.full(256, 14, dtype=np.uint8)
for _ch, _code in {
    "A": 2, "B": 5, "C": 1, "D": 6, "G": 3, "H": 7, "K": 8, "M": 9,
    "N": 4, "R": 10, "S": 11, "T": 0, "U": 0, "V": 12, "W": 13, "Y": 15,
}.items():
    FOUR_BIT_CODES[ord(_ch)] = _code
    FOUR_BIT_CODES[ord(_ch.lower())] = _code

FOUR_BIT_CHARS = np.frombuffer(b"TCAGNBDHKMRSVWXY", dtype=np.uint8)
FOUR_BIT_COMP_CODES = np.array(
    [2, 3, 0, 1, 4, 12, 7, 6, 9, 8, 15, 11, 5, 13, 14, 10], dtype=np.uint8)


def map8to4(chars: np.ndarray) -> np.ndarray:
    """Vectorized char->code (Math.inl:37-40)."""
    return FOUR_BIT_CODES[np.asarray(chars, dtype=np.uint8)]


def complement4to4(codes: np.ndarray) -> np.ndarray:
    """Vectorized complement (Math.inl:55-59)."""
    return FOUR_BIT_COMP_CODES[np.asarray(codes, dtype=np.uint8)]


def unmap4to8(codes: np.ndarray) -> np.ndarray:
    """Vectorized code->char (Math.inl:84-88)."""
    return FOUR_BIT_CHARS[np.asarray(codes, dtype=np.uint8)]


def unpack_nib2(packed: np.ndarray) -> np.ndarray:
    """Unpack bytes into one 4-bit code per byte (getFrom4Code,
    Math.c:180-188)."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty(len(packed) * 2, dtype=np.uint8)
    out[0::2] = packed >> 4
    out[1::2] = packed & 0xF
    return out
