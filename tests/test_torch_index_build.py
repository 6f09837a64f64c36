"""The port's index builder (yaha_tpu_torch/index/build.py) on the CPU.

Its two passes run as torch ops on the device it is given (here "cpu";
tests/test_torch_cuda.py runs them on the card): its files are held byte
for byte to the four golden indexes of tests/test_index.py, and its SO
and ROA arrays to yaha_tpu.index.build.build_index and to the port's
native builder (native/host.build_index) on numpy-seeded genomes with
several sequences, N runs, IUPAC codes, skip 1-3 and max_hits low enough
to down-sample (tests/torch_dp_cases.index_genome), in one chunk and in
chunks of a few hundred windows.
"""
import gzip
import os

import numpy as np
import pytest

from conftest import GOLD
from torch_dp_cases import INDEX_CASE_IDS, INDEX_CASES, index_genome

from yaha_tpu_torch.index import build
from yaha_tpu_torch.io import nib2


@pytest.fixture(scope="module")
def genome():
    with open(os.path.join(GOLD, "testgen.nib2"), "rb") as f:
        return nib2.load(f.read())


def _file_bytes(so, roa, tm, wl, mh):
    header = np.array([0xFFFFFFFF, wl, mh, tm], np.uint32)
    return header.tobytes() + so.tobytes() + roa.tobytes()


@pytest.mark.parametrize("gold,wl,sd,mh", [
    ("testgen.X09_01_65525S.gz", 9, 1, 65525),
    ("testgen.X11_01_65525S.gz", 11, 1, 65525),
    ("testgen.X10_03_65525S.gz", 10, 3, 65525),   # skipDist > 1 grid logic
    ("testgen.X11_01_00020S.gz", 11, 1, 20),      # random down-sampling
])
def test_build_matches_golden_index(genome, gold, wl, sd, mh):
    stats = {}
    so, roa, tm = build.build_index(genome, wl, sd, mh, device="cpu",
                                    stats=stats)
    assert so.dtype == np.uint32 and roa.dtype == np.uint32
    with gzip.open(os.path.join(GOLD, gold)) as f:
        assert _file_bytes(so, roa, tm, wl, mh) == f.read()
    assert set(stats) == {"scan_s", "device_s", "sample_s", "fetch_s"}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("wl,sd,mh", INDEX_CASES, ids=INDEX_CASE_IDS)
def test_build_matches_jax_and_native(wl, sd, mh, seed):
    from yaha_tpu.index import build as jax_build
    from yaha_tpu_torch.native import host
    g = index_genome(seed)
    want = jax_build.build_index(g, wl, sd, mh)
    native = host.build_index(g, wl, sd, mh, n_threads=2)
    assert want[2] == native[2]
    assert np.array_equal(want[0], native[0])
    assert np.array_equal(want[1], native[1])
    # Repeats pass max_hits, so the third pass runs (apart from L11S3).
    assert (int(np.diff(want[0].astype(np.int64)).max()) == mh) == (
        mh < 65525)
    for chunk in (64 << 20, 333):
        so, roa, tm = build.build_index(g, wl, sd, mh, chunk=chunk,
                                        device="cpu")
        assert tm == want[2]
        assert so.dtype == np.uint32 and roa.dtype == np.uint32
        assert np.array_equal(so, want[0])
        assert np.array_equal(roa, want[1])


def test_scan_positions_match_jax():
    """The host's window positions, around N runs at each skip."""
    from yaha_tpu.index import build as jax_build
    g = index_genome(2)
    for wl in (4, 11, 15):
        for sd in (1, 2, 3):
            assert np.array_equal(
                build.genome_scan_positions(g, wl, sd),
                jax_build.genome_scan_positions(g, wl, sd))


def test_hash_windows_match_jax():
    import torch
    from yaha_tpu.index import build as jax_build
    g = index_genome(3)
    for wl in (4, 11, 15):
        pos = jax_build.genome_scan_positions(g, wl, 2)
        want = jax_build.hash_windows(g.codes, pos, wl)
        got = build.hash_windows(torch.from_numpy(g.codes),
                                 torch.from_numpy(pos.astype(np.int64)), wl)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_build_refuses_cuda_without_card(genome):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build.build_index(genome, 9, 1, 65525)
