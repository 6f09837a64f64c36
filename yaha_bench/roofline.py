"""The benchmark's frozen count of the work the seed kernels' problems
need, and the peak it is held to.

Peak: one H100 SXM at its 700 W limit, as published: 3.35 TB/s of HBM.  A
share of a peak is the least time the card could take for the work (its
bytes over the byte rate) over the device time the kernels took.  What is
counted is the work, not what today's kernels do: each input byte once
and each final output once.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12

# The seed phase's bytes: an SO run is two uint32 entries; a hit is one
# uint32 ROA read in and a (diag uint32, qo int32) row out.
SO_ENTRY_BYTES = 8
HIT_IN_BYTES = 4
HIT_OUT_BYTES = 8


def seed_bytes(bases: int, clean_windows: int, hits: int) -> int:
    """The seed phase's bytes: the reads' codes in, the SO run of every
    clean window of both strands, and each hit's ROA read and row out."""
    return (bases + SO_ENTRY_BYTES * clean_windows +
            (HIT_IN_BYTES + HIT_OUT_BYTES) * hits)


def share_pct(bound_s: float, device_s: float):
    """The bound's share of the device time, in percent; None where no
    kernel ran."""
    if device_s <= 0:
        return None
    return 100.0 * bound_s / device_s


def seed_work(reads, starting_offs, word_len: int, max_hits: int,
              device="cpu", block=8192):
    """(bases, clean windows of both strands, hits) of one pass of the
    seed phase over `reads` (4-bit code arrays): a window is clean when its
    codes are all bases, and its hits are its k-mer's ROA run where the run
    is in (0, max_hits], as the query's seed scan takes them
    (Query.c:361-412).  `starting_offs` is the reference's SO table."""
    import numpy as np
    import torch
    dev = torch.device(device)
    so = torch.from_numpy(starting_offs.view(np.int32)).to(dev)
    bases = clean_n = hits = 0
    for k in range(0, len(reads), block):
        part = reads[k:k + block]
        width = max(len(r) for r in part)
        if width < word_len:
            continue
        mat = np.full((len(part), width), 4, np.uint8)
        for i, r in enumerate(part):
            mat[i, :len(r)] = r
            bases += len(r)
        c = torch.from_numpy(mat).to(dev).to(torch.int64)
        n = width - word_len + 1
        for strand in (c, torch.flip(torch.where(c < 4, c ^ 2, c), [1])):
            h = torch.zeros((len(part), n), dtype=torch.int64, device=dev)
            bad = torch.zeros((len(part), n), dtype=torch.bool, device=dev)
            for i in range(word_len):
                h = (h << 2) | (strand[:, i:i + n] & 3)
                bad |= strand[:, i:i + n] > 3
            h = h[~bad]
            clean_n += int(h.numel())
            run = ((so[h + 1].to(torch.int64) & 0xFFFFFFFF) -
                   (so[h].to(torch.int64) & 0xFFFFFFFF))
            hits += int(run[(run > 0) & (run <= max_hits)].sum())
    return bases, clean_n, hits
