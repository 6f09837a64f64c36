"""The port's copies of the host layers against the JAX package's.

yaha_tpu_torch keeps its own copy of the native C++ pipeline (built into
yaha_tpu_torch/_build), the loaders, the run configuration and the CLI's
non-query operations.  Tolerance zero throughout:

  * the port's align_batch_native writes the same SAM bytes, seed and
    record counts as yaha_tpu.native.host.align_batch_native on the five
    configurations of tests/test_torch_staged.py, both libraries loaded in
    one process;
  * `-g testgen.fasta -c`, `-g testgen.nib2 -u` and `-g ... -L 11` write
    the goldens of tools/make_goldens.sh byte for byte;
  * the two libraries are separate: their entry points are distinct, and
    a thread-local setting of one does not reach the other.
"""
import ctypes as ct
import gzip
import os
import shutil

import pytest

from conftest import DATA, GOLD
from test_torch_staged import CONFIGS, INDEX, _aa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from yaha_tpu_torch import host
    d = tmp_path_factory.mktemp("torch_host")
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), d)
    with gzip.open(os.path.join(GOLD, INDEX + ".gz")) as f:
        with open(os.path.join(d, INDEX), "wb") as out:
            out.write(f.read())
    return (host.load_genome(os.path.join(d, "testgen.nib2")),
            host.load_index(os.path.join(d, INDEX)))


@pytest.mark.parametrize("qfile,over,n_max", CONFIGS,
                         ids=["A_default", "D_fbs", "E_fastq", "F_edge",
                              "C_params"])
def test_native_engine_matches_jax_package(env, qfile, over, n_max):
    from yaha_tpu.native import host as jax_host
    from yaha_tpu_torch import host
    genome, index = env
    aa = _aa(index, qfile, over)
    with open(os.path.join(DATA, qfile), "rb") as f:
        data = f.read()
    aa.fastq = data[:1] == b"@"
    args = (aa.fastq, aa.max_query_length, aa.word_len)
    pr = host.parse_queries_native(data, *args)
    pr_ref = jax_host.parse_queries_native(data, *args)
    assert pr.n == pr_ref.n
    n = pr.n if n_max is None else min(pr.n, n_max)
    got = host.align_batch_native(pr, 0, n, genome, index, aa, n_threads=2,
                                  want_stats=True)
    want = jax_host.align_batch_native(pr_ref, 0, n, genome, index, aa,
                                       n_threads=2, want_stats=True)
    assert got[0] == want[0]
    assert got[2:] == want[2:]
    # QUERYSTATS rows carry per-read microseconds: compare the rest.
    strip = [ln.rsplit(b"\t", 1)[0] for ln in got[1].split(b"\n")]
    assert strip == [ln.rsplit(b"\t", 1)[0] for ln in want[1].split(b"\n")]


def _cli(cwd, *args):
    from yaha_tpu_torch import cli
    old = os.getcwd()
    os.chdir(cwd)
    try:
        assert cli.main(list(args)) == 0
    finally:
        os.chdir(old)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_cli_compress_writes_golden_nib2(tmp_path):
    shutil.copy(os.path.join(DATA, "testgen.fasta"), tmp_path)
    _cli(tmp_path, "-g", "testgen.fasta", "-c")
    assert _read(tmp_path / "testgen.nib2") == _read(
        os.path.join(GOLD, "testgen.nib2"))


def test_cli_uncompress_writes_golden_fasta(tmp_path):
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), tmp_path)
    _cli(tmp_path, "-g", "testgen.nib2", "-u")
    assert _read(tmp_path / "testgen.fasta") == _read(
        os.path.join(GOLD, "testgen.uncompressed.fasta"))


@pytest.mark.parametrize("source", ["testgen.nib2", "testgen.fasta"])
def test_cli_index_writes_golden_index(tmp_path, source):
    """From the .nib2, and from the FASTA through the compress-if-stale
    step (which must then also leave the golden .nib2 beside it)."""
    src = os.path.join(GOLD if source.endswith(".nib2") else DATA, source)
    shutil.copy(src, tmp_path)
    _cli(tmp_path, "-g", source, "-L", "11")
    with gzip.open(os.path.join(GOLD, INDEX + ".gz")) as f:
        assert _read(tmp_path / INDEX) == f.read()
    assert _read(tmp_path / "testgen.nib2") == _read(
        os.path.join(GOLD, "testgen.nib2"))


def _read_codes(name, k):
    import numpy as np
    from yaha_tpu_torch.utils import codec
    with open(os.path.join(DATA, name), "rb") as f:
        rec = f.read().split(b">")[k + 1]
    seq = b"".join(rec.split(b"\n")[1:])
    return codec.FOUR_BIT_CODES[np.frombuffer(seq, np.uint8)]


def test_libraries_are_separate(test_index, monkeypatch):
    """Both libraries in one process: distinct files and entry points, and
    the region-frag cap (a C++ thread_local that --max-region-frags sets,
    yaha_tpu/native/host.py _set_region_cap) set to 1 in the JAX
    package's library does not reach the port's on the same thread: the
    port's seed-to-clumps stage skips no region and gives the uncapped
    clumps, while the JAX package's, capped, skips regions."""
    import copy

    import numpy as np
    from yaha_tpu.native import host as jax_host
    from yaha_tpu_torch.config import AlignmentArgs
    from yaha_tpu_torch.native import host
    lib, ref = host._load(), jax_host._load()
    assert os.path.realpath(lib._name) == os.path.realpath(
        os.path.join(REPO, "yaha_tpu_torch", "_build", "libyaha_host.so"))
    assert os.path.realpath(ref._name) != os.path.realpath(lib._name)

    def addr(fn):
        return ct.cast(fn, ct.c_void_p).value
    assert addr(lib.yt_align_batch) != addr(ref.yt_align_batch)

    aa = AlignmentArgs().post_process(True)
    aa.word_len = test_index.word_len
    aa.max_hits = min(aa.max_hits, test_index.max_hits)
    capped = copy.copy(aa)
    capped.max_region_frags = 1
    codes = _read_codes("readsD_sv.fasta", 1)
    want = jax_host.seed_to_clumps(codes, test_index, aa)
    try:
        assert jax_host.seed_to_clumps(codes, test_index, capped)[1].size \
            < want[1].size
        assert jax_host.take_skipped_regions() > 0
        # The same binding on the port's library, without setting its cap.
        monkeypatch.setattr(jax_host, "_load", lambda: lib)
        monkeypatch.setattr(jax_host, "_set_region_cap", lambda l, a: None)
        got = jax_host.seed_to_clumps(codes, test_index, aa)
        lib.yt_take_skipped_regions.restype = ct.c_int64
        assert lib.yt_take_skipped_regions() == 0
    finally:
        ref.yt_set_max_region_frags(0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
