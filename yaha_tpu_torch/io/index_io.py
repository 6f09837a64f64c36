"""Index file (de)serialization, byte-exact with the reference format.

The port's copy of yaha_tpu/io/index_io.py (the staged and native engines
map the file with io/native_loader.py; the oracle engine loads it here).
Layout (Index.c:161-194): header [version=-1, wordLen, maxHits,
totalMatches] as 4 u32, then the SO array (4^wordLen + 1 u32, with
sentinel), then the ROA (totalMatches u32 reference offsets).
"""
from __future__ import annotations

import dataclasses

import numpy as np

INDEX_FILE_VERSION = 0xFFFFFFFF  # (UINT)-1


@dataclasses.dataclass
class Index:
    word_len: int
    max_hits: int
    total_matches: int
    starting_offs: np.ndarray  # uint32, 4^wordLen + 1
    roa: np.ndarray            # uint32, totalMatches


def write_index(path: str, word_len: int, max_hits: int,
                starting_offs: np.ndarray, roa: np.ndarray,
                total_matches: int) -> None:
    header = np.array([INDEX_FILE_VERSION, word_len, max_hits,
                       total_matches], dtype=np.uint32)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(np.ascontiguousarray(starting_offs, dtype=np.uint32).tobytes())
        f.write(np.ascontiguousarray(roa, dtype=np.uint32).tobytes())


def load_index(path: str) -> Index:
    """mmap-style load (Query.c:594-626 equivalent)."""
    data = np.memmap(path, dtype=np.uint32, mode="r")
    version, word_len, max_hits, total_matches = (int(x) for x in data[:4])
    if version != INDEX_FILE_VERSION:
        raise ValueError("Index file version is out of date.\n"
                         "Please remake index file and try again.")
    ht_size = 1 << (2 * word_len)
    so = data[4:4 + ht_size + 1]
    roa = data[4 + ht_size + 1:]
    return Index(word_len=word_len, max_hits=max_hits,
                 total_matches=total_matches,
                 starting_offs=so, roa=roa)


def print_count_statistics(starting_offs, word_len, file=None):
    """Index statistics under -v (outputCountStatistics analog,
    Index.c:337-407): total hits, zero-hit
    k-mers, and count percentiles over k-mers and hits."""
    import sys
    file = file or sys.stderr
    so = np.asarray(starting_offs, dtype=np.int64)
    counts = np.diff(so)
    total = int(counts.sum())
    ht_size = len(counts)
    print("Found %d total hits across %d %d-mers." % (total, ht_size,
                                                      word_len), file=file)
    print("Found %d %d-mers with zero hits." %
          (int((counts == 0).sum()), word_len), file=file)
    percs = [0.25, 0.50, 0.75, 0.90, 0.95, 0.99, 0.999, 0.9999]
    nz = np.sort(counts)
    hit_cum = np.cumsum(nz)
    for p in percs:
        kmer_thresh = nz[min(int(ht_size * p + 0.5), ht_size - 1)]
        hit_idx = int(np.searchsorted(hit_cum, total * p + 0.5))
        hit_thresh = nz[min(hit_idx, ht_size - 1)]
        print("The %g percentile of %d-mers is %d, and of total matches "
              "is %d." % (p, word_len, int(kmer_thresh), int(hit_thresh)),
              file=file)
