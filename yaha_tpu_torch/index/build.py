"""k-mer index construction with byte-exact reference file output.

Counterpart of yaha_tpu/index/build.py, a port of indexFile
(Index.c:49-335).  The reference's two rolling-hash genome scans become
array passes on a torch device: the windows' hashes, a count per k-mer
(pass 1), the SO table as their running sum, and the ROA fill (pass 2: a
stable sort of each chunk's hashes, each window's rank within its k-mer
run, and a scatter to SO[h] + seen[h] + rank), which reproduces the
per-k-mer ascending reference-offset order of the reference's fill.  Two
steps stay on the host, as in the JAX package: the scan's window
positions (scan_positions) and the third pass, the order-preserving Floyd
down-sampling of k-mers over maxHits from the fixed Marsaglia seed,
sequential over those k-mers in ascending hash order.

The subtle part is *which* window positions are scanned when skipDist > 1:
the scan starts on the grid {seqStart + k*skipDist} but renormalizes to the
absolute grid {k*skipDist} after every run of non-ACGT codes
(Index.c:108-117).  scan_positions() reproduces that exactly.

On the device, positions and SO are int64 (human-scale offsets pass
2^31); the per-k-mer counts are int32 and the ROA holds each offset's low
32 bits in an int32, as the file's uint32.  Windows go `chunk` at a time,
so a build holds SO + the counts + ROA + one chunk on the device.  The
index operation of the CLI runs the native builder (native/host.py
build_index); this one is held to it and to the golden index files.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..io.genome import Genome
from ..utils.rng import RandState

M32 = 0xFFFFFFFF


def scan_positions(codes: np.ndarray, start: int, length: int,
                   word_len: int, skip_dist: int) -> np.ndarray:
    """Window start offsets the reference scan visits-and-counts.

    Exact emulation of the skip/renormalize loop in Index.c:96-128 for one
    sequence [start, start+length).
    """
    ending = start + length - word_len
    if ending < start:
        return np.empty(0, dtype=np.uint32)
    n = len(codes)
    # Bad (non-ACGT) code positions at-or-after start.
    bad = np.flatnonzero(codes[start:] > 3) + start
    positions = []
    base = start  # current grid anchor
    while base <= ending:
        # First bad position >= base.
        bi = np.searchsorted(bad, base)
        p_bad = int(bad[bi]) if bi < len(bad) else n + word_len
        # Windows on grid {base, base+s, ...} with window end before p_bad.
        # Window [p, p+wl) is good iff p + wl - 1 < p_bad.
        last_good_start = min(ending, p_bad - word_len)
        if last_good_start >= base:
            count = (last_good_start - base) // skip_dist + 1
            positions.append((base + skip_dist *
                              np.arange(count, dtype=np.int64))
                             .astype(np.uint32))
            next_window = base + count * skip_dist
        else:
            next_window = base
        if next_window > ending or p_bad > n:
            break
        # The scan hit the bad code: skip the run of bad codes starting at
        # p_bad + 1, then renormalize to the absolute skipDist grid.
        cur = p_bad + 1
        while cur < n and codes[cur] > 3:
            cur += 1
        base = ((cur + skip_dist - 1) // skip_dist) * skip_dist
        if cur >= n:
            break
    if not positions:
        return np.empty(0, dtype=np.uint32)
    return np.concatenate(positions)


def genome_scan_positions(genome: Genome, word_len: int,
                          skip_dist: int) -> np.ndarray:
    parts = [scan_positions(genome.codes, int(s), int(l), word_len, skip_dist)
             for s, l in zip(genome.starting_offsets, genome.lengths)]
    return (np.concatenate(parts) if parts
            else np.empty(0, dtype=np.uint32))


def hash_windows(codes: torch.Tensor, positions: torch.Tensor,
                 word_len: int) -> torch.Tensor:
    """2-bit hash per window: codes packed MSB-first (Index.c:32-43).

    `codes` is the genome's uint8 code array and `positions` ascending
    int64 window starts, both on one device.  The hash is rolled over the
    contiguous span covering `positions` (a shifted slice OR'd in per code,
    sequential-bandwidth work), then gathered at the positions.
    2*word_len <= 30 bits fits int32.
    """
    if len(positions) == 0:
        return torch.empty(0, dtype=torch.int32, device=codes.device)
    lo = int(positions[0])
    nwin = int(positions[-1]) - lo + 1
    c = codes[lo:lo + nwin + word_len - 1].to(torch.int32)
    h = torch.zeros(nwin, dtype=torch.int32, device=codes.device)
    for i in range(word_len):
        h.bitwise_left_shift_(2).bitwise_or_(c[i:i + nwin])
    return h[positions - lo]


def _low32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 of their low 32 bits (x is
    changed in place)."""
    x[x >= 1 << 31] -= 1 << 32
    return x.to(torch.int32)


def build_index(genome: Genome, word_len: int, skip_dist: int,
                max_hits: int, chunk: int = 64 << 20, device="cuda",
                stats=None):
    """Returns (starting_offs[HTsize+1] uint32, roa uint32, total_matches),
    numpy, as yaha_tpu.index.build.build_index does.

    `device` runs the two passes ("cuda" by default, as every entry point
    of the port; a CUDA device without a card raises).  `stats`, a dict,
    gets the seconds of each step: "scan_s" (the host's window
    positions), "device_s" (the two passes on the device, by CUDA events
    on a card, else the host's clock), "sample_s" (the host's third pass)
    and "fetch_s" (SO and ROA back to the host).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_index: device %s requested but no CUDA "
                           "device is available" % dev)
    ht_size = 1 << (2 * word_len)
    t0 = time.perf_counter()
    positions = genome_scan_positions(genome, word_len, skip_dist)
    n = len(positions)
    t1 = time.perf_counter()
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    codes = torch.from_numpy(np.ascontiguousarray(genome.codes,
                                                  np.uint8)).to(dev)

    def chunk_windows(lo):
        pos = torch.from_numpy(positions[lo:lo + chunk].view(np.int32))
        pos = pos.to(dev).to(torch.int64) & M32
        return pos, hash_windows(codes, pos, word_len)

    # Pass 1: the count of each k-mer's windows (Index.c:96-128).
    counts = torch.zeros(ht_size, dtype=torch.int32, device=dev)
    for lo in range(0, n, chunk):
        _, h = chunk_windows(lo)
        counts.index_add_(0, h, torch.ones_like(h))
    so = torch.zeros(ht_size + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, dtype=torch.int64, out=so[1:])
    # Pass 2: each window's offset to SO[h] + seen[h] + its rank among the
    # chunk's windows of k-mer h (Index.c:130-242).  The stable sort keeps
    # the genome order within a k-mer run, so the fill equals the
    # reference's in-scan-order one.  `counts`, zeroed, holds each k-mer's
    # windows filled so far (the reference's `seen`), and so ends equal to
    # the counts again.
    roa = torch.empty(n, dtype=torch.int32, device=dev)
    counts.zero_()
    for lo in range(0, n, chunk):
        pos, h = chunk_windows(lo)
        hs, order = torch.sort(h, stable=True)
        idx = torch.arange(len(hs), device=dev)
        starts = torch.ones(len(hs), dtype=torch.bool, device=dev)
        starts[1:] = hs[1:] != hs[:-1]
        run_start = torch.where(starts, idx, 0).cummax(0).values
        hl = hs.to(torch.int64)
        dest = so[hl] + counts[hl] + (idx - run_start)
        roa[dest] = _low32(pos[order])
        counts.index_add_(0, hs, torch.ones_like(hs))
    del codes
    over = torch.nonzero(counts > max_hits).flatten()
    bounds = torch.stack([so[over], so[over + 1]], 1).cpu().numpy()
    if dev.type == "cuda":
        ev[1].record()
        ev[1].synchronize()
        device_s = ev[0].elapsed_time(ev[1]) / 1e3
    else:
        device_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    roa_h = roa.cpu().numpy().view(np.uint32)
    del roa
    t3 = time.perf_counter()

    # Third pass: random down-sampling of k-mers over maxHits
    # (Index.c:271-315).  RNG state flows across k-mers in ascending hash
    # order from the fixed default Marsaglia seed.
    if len(bounds):
        rng = RandState.default()
        pieces = []
        prev = 0
        for lo, hi in bounds.tolist():
            pieces.append(roa_h[prev:lo])
            pieces.append(rng.rand_sample(roa_h[lo:hi], max_hits))
            prev = hi
        pieces.append(roa_h[prev:])
        roa_h = np.ascontiguousarray(np.concatenate(pieces), dtype=np.uint32)
        counts.clamp_(max=max_hits)
        torch.cumsum(counts, 0, dtype=torch.int64, out=so[1:])
    del counts
    t4 = time.perf_counter()
    total_matches = int(so[-1])
    starting_offs = _low32(so).cpu().numpy().view(np.uint32)
    if stats is not None:
        stats.update(scan_s=t1 - t0, device_s=device_s,
                     sample_s=t4 - t3,
                     fetch_s=(t3 - t2) + (time.perf_counter() - t4))
    return starting_offs, roa_h, total_matches
