"""The benchmark's frozen count of the seed kernels' work, on tiny
problems against a count by hand, and the DP kernels' device time.

    python -m pytest -q yaha_bench/test_bench_roofline.py
"""
import numpy as np
import pytest

from yaha_bench import harness, roofline, trace
from yaha_bench.reference.index import RefIndex


def test_share_of_the_peak():
    t = roofline.seed_bytes(10**8, 10**8, 10**7) / roofline.HBM_BYTES_S
    assert t == pytest.approx((10**8 + 8 * 10**8 + 12 * 10**7) / 3.35e12)
    assert roofline.share_pct(t, 2 * t) == pytest.approx(50.0)
    assert roofline.share_pct(t, 0) is None


def test_dp_device_time_per_kread():
    """kernels.dp_ms_per_kread: the DP kernels' device seconds by name (the
    seed kernels and copies left out) per 1,000 reads; nothing untraced or
    where no DP kernel ran."""
    import re
    read = harness.load_reader("kernels.dp_ms_per_kread")
    by_name = {"void ext_reg_kernel<21>(Ext)": 0.5, "gather_kernel": 0.25,
               "seed_hash_kernel<15>": 9.0, "Memcpy HtoD": 3.0}
    ctx = {"timeline": {"device_s_by_name": by_name}, "reads": 1000,
           "dp_kernels": harness.DP_KERNELS,
           "device_seconds": trace.device_seconds}
    assert read(ctx) == pytest.approx(750.0)
    assert read(dict(ctx, timeline=None)) is None
    assert read(dict(ctx, dp_kernels=re.compile("none"))) is None


def test_seed_work_by_hand():
    """wl 2 over a 16-entry SO: hits of a window are its k-mer's run where
    the run is in (0, max_hits]; windows with N are not clean."""
    wl = 2
    counts = np.zeros(16, np.int64)
    counts[0b1000] = 3       # "AT": A=2, T=0
    counts[0b0010] = 1       # "TA"
    counts[0b1010] = 9       # "AA": over max_hits 5
    so = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint32)
    reads = [np.array([2, 0, 2, 4, 2], np.uint8)]      # A T A N A
    bases, clean, hits = roofline.seed_work(reads, so, wl, 5)
    # forward windows AT, TA clean (TN, NA not); reverse complement of
    # ATANA is TNTAT: windows TN, NT no, TA, AT clean
    assert (bases, clean) == (5, 4)
    assert hits == 3 + 1 + 1 + 3
    assert roofline.seed_bytes(bases, clean, hits) == 5 + 8 * 4 + 12 * 8


def test_reference_index_samples_over_max_hits():
    """The reference's own index on a tiny genome: ascending offsets per
    k-mer, no window over an N, and a k-mer over maxHits keeps maxHits of
    its offsets, in order."""
    from yaha_bench.reference import index as rindex
    codes = np.array([2, 0] * 40 + [4] + [1, 3, 1, 3], np.uint8)
    idx = rindex.build(codes, [0], [len(codes)], 2, 1, 65525)
    so = idx.starting_offs.astype(np.int64)
    at = idx.roa[so[0b1000]:so[0b1001]]                # "AT"
    assert list(at) == list(range(0, 80, 2))
    small = rindex.build(codes, [0], [len(codes)], 2, 1, 10)
    so2 = small.starting_offs.astype(np.int64)
    kept = small.roa[so2[0b1000]:so2[0b1001]]
    assert len(kept) == 10 and set(kept) <= set(at)
    assert list(kept) == sorted(kept)
    # AT 40, TA 39, CG 2, GC 1; no window holds the N
    assert idx.total_matches == 82 and small.total_matches == 23


def test_reference_seed_work_matches_the_index():
    idx = RefIndex(2, 65525, 0, np.zeros(17, np.uint32), np.zeros(0,
                                                                  np.uint32))
    assert roofline.seed_work([np.array([1, 1], np.uint8)],
                              idx.starting_offs, 2, 650) == (2, 2, 0)
