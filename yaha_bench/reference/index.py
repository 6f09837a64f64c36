"""The reference's own k-mer index, worked out again from the genome.

yaha's index (Index.c:49-335) at skip 1: every window of `word_len` bases
that lies inside one chromosome and holds no code above 3 is hashed (two
bits a base, first base highest); SO[h] is the number of such windows with
a hash below h, and the ROA lists each k-mer's window offsets in ascending
order.  A k-mer with more than `max_hits` windows keeps `max_hits` of them,
chosen by the reference's order-preserving Floyd sample from the fixed
Marsaglia seed, k-mer after k-mer in ascending hash order.  Plain PyTorch
ops on `device` (a sort of (hash, offset) keys), written apart from the
port's builder.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .rng import RandState


@dataclasses.dataclass
class RefIndex:
    word_len: int
    max_hits: int
    total_matches: int
    starting_offs: np.ndarray     # uint32, 4^word_len + 1
    roa: np.ndarray               # uint32


def window_hashes(codes, word_len: int):
    """(hash, clean) of every window start of a code tensor: the hash of
    codes[p:p + word_len] and whether all of them are bases."""
    import torch
    n = codes.numel() - word_len + 1
    c = codes.to(torch.int64)
    h = torch.zeros(n, dtype=torch.int64, device=codes.device)
    bad = torch.zeros(n, dtype=torch.int32, device=codes.device)
    for i in range(word_len):
        h = (h << 2) | (c[i:i + n] & 3)
        bad += (c[i:i + n] > 3).to(torch.int32)
    return h, bad == 0


def build(codes: np.ndarray, starts, lengths, word_len: int,
          skip_dist: int, max_hits: int, device="cpu") -> RefIndex:
    import torch
    if skip_dist != 1:
        raise ValueError("the reference index takes skip 1 only")
    dev = torch.device(device)
    keys = []
    for s, ln in zip(starts, lengths):
        s, ln = int(s), int(ln)
        if ln < word_len:
            continue
        seg = torch.from_numpy(np.ascontiguousarray(codes[s:s + ln])).to(dev)
        h, clean = window_hashes(seg, word_len)
        pos = torch.arange(s, s + len(h), dtype=torch.int64, device=dev)
        keys.append((h[clean] << 32) | pos[clean])
        del seg, h, clean, pos
    key = torch.sort(torch.cat(keys)).values
    del keys
    ht = 1 << (2 * word_len)
    counts = torch.bincount(key >> 32, minlength=ht)
    low = key & 0xFFFFFFFF
    roa = torch.where(low >= 1 << 31, low - (1 << 32), low).to(torch.int32)
    roa = roa.cpu().numpy().view(np.uint32)
    del key, low
    so = torch.zeros(ht + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=so[1:])
    over = torch.nonzero(counts > max_hits).flatten()
    if len(over):
        bounds = torch.stack([so[over], so[over + 1]], 1).cpu().tolist()
        rng = RandState.default()
        pieces, prev = [], 0
        for lo, hi in bounds:
            pieces += [roa[prev:lo], rng.rand_sample(roa[lo:hi], max_hits)]
            prev = hi
        pieces.append(roa[prev:])
        roa = np.ascontiguousarray(np.concatenate(pieces), np.uint32)
        torch.cumsum(counts.clamp_(max=max_hits), 0, out=so[1:])
    del counts
    total = int(so[-1])
    so = torch.where(so >= 1 << 31, so - (1 << 32), so).to(torch.int32)
    return RefIndex(word_len=word_len, max_hits=max_hits,
                    total_matches=total,
                    starting_offs=so.cpu().numpy().view(np.uint32),
                    roa=roa)
