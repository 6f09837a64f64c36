"""nib2 genome container: byte-exact read of the reference format.

The port's copy of load and uncompress_to_fasta from yaha_tpu/io/nib2.py
(writing a nib2 file is the native library's yt_compress_fasta_file).

Format (Compress.c:25-74): 16-byte header {magic 0x01020304, version,
byte-offset-of-bases, seqCount}; per-sequence block {startOffset(bytes),
length(bases), nameOffset, nameLen} (v2: 4 u32; v1: 3 u32 with packed
name info); mask-block count (always 0); concatenated names padded to a
4-byte boundary; packed 4-bit bases, each sequence padded with X to a
4-byte boundary.
"""
from __future__ import annotations

import numpy as np

from ..utils import codec
from .genome import Genome

NIB2_MARKER = 0x01020304


def load(data: bytes) -> Genome:
    """Parse nib2 bytes into a normalized Genome.

    Port of loadBaseSequences (Compress.c:76-134) + normalizeBaseSequences
    (BaseSeq.c:113-119): returned offsets are in bases.
    """
    head = np.frombuffer(data[:16], dtype=np.uint32)
    if head[0] != NIB2_MARKER or head[1] not in (1, 2):
        raise ValueError("Input nib2 file bad header format.")
    version = int(head[1])
    base_off = int(head[2])
    seq_count = int(head[3])
    bs_block = 12 if version == 1 else 16
    name_start = 16 + bs_block * seq_count + 4  # + mask header (0 blocks)

    recs = np.frombuffer(
        data[16:16 + bs_block * seq_count], dtype=np.uint32
    ).reshape(seq_count, bs_block // 4)
    names = []
    starts = np.empty(seq_count, dtype=np.int64)
    lengths = np.empty(seq_count, dtype=np.int64)
    for i in range(seq_count):
        starts[i] = int(recs[i, 0]) * 2  # bytes -> bases (normalize)
        lengths[i] = int(recs[i, 1])
        if version == 1:
            name_info = int(recs[i, 2])
            noff, nlen = (name_info >> 16) & 0xFFFF, name_info & 0xFFFF
        else:
            noff, nlen = int(recs[i, 2]), int(recs[i, 3])
        names.append(data[name_start + noff:name_start + noff + nlen]
                     .decode("latin-1"))
    packed = np.frombuffer(data[base_off:], dtype=np.uint8)
    codes = codec.unpack_nib2(packed)
    # The reference mmaps the genome file (Query.c:556); reads past EOF
    # land on the mmap zero page, i.e. code 0 ('T'), for up to a page.
    codes = np.concatenate([codes, np.zeros(8192, dtype=np.uint8)])
    return Genome(names=names, starting_offsets=starts, lengths=lengths,
                  codes=codes)


def uncompress_to_fasta(genome: Genome) -> bytes:
    """nib2 -> FASTA bytes. Port of uncompressFile (Compress.c:337-402):
    50-char lines, names as stored."""
    parts = []
    for i in range(genome.n_seqs):
        parts.append(b">" + genome.names[i].encode("latin-1") + b"\n")
        start = int(genome.starting_offsets[i])
        length = int(genome.lengths[i])
        chars = codec.unmap4to8(genome.codes[start:start + length])
        full = (length // 50) * 50
        if full:
            block = np.empty((full // 50, 51), np.uint8)
            block[:, :50] = chars[:full].reshape(-1, 50)
            block[:, 50] = ord("\n")
            parts.append(block.tobytes())
        if length > full:
            parts.append(chars[full:].tobytes() + b"\n")
    return b"".join(parts)
