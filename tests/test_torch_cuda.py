"""The port's CUDA kernels and engine on the card (marker `cuda`).

Every test here needs an NVIDIA GPU and skips without one.  The kernels
are held to their plain PyTorch versions on the card, on the inputs with
which tests/test_torch_sw.py holds the plain versions to the JAX package:
every output equal, the whole backtrack plane included (integer DPs,
tolerance zero).  The engine is held to the native C++ engine, SAM bytes
equal.  Neither jax nor tests/conftest.py is needed, so on a machine with
a card run them from the repository root with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from torch_dp_cases import (ANCH_SWEEP, ANCH_SWEEP_IDS, EXT_SWEEP,
                            EXT_SWEEP_IDS, KW, KW_WRAP, anchored_inputs,
                            anchored_sweep_inputs, extension_inputs,
                            indel_reads)
from yaha_tpu_torch.ops import sw_cuda

pytestmark = pytest.mark.cuda

TESTS = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(TESTS, "data")
GOLD = os.path.join(TESTS, "golden")
INDEX = "testgen.X11_01_65525S"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _up(dev, *arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]


def _equal(got, want):
    torch.cuda.synchronize()
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert torch.equal(got[key], w), key


@pytest.mark.parametrize("kw", [KW, KW_WRAP], ids=["default", "wrap"])
def test_extension_kernel_matches_plain(dev, kw):
    # N = 1000 is not a multiple of the block size.
    args = _up(dev, *extension_inputs(11, 1000, 40, 2))
    ekw = dict(band_width=2, x_cutoff=25, **kw)
    _equal(sw_cuda.extension_forward(*args, **ekw),
           sw_cuda.extension_forward_reference(*args, **ekw))


@pytest.mark.parametrize("bw,xc,mg,mi,err", EXT_SWEEP, ids=EXT_SWEEP_IDS)
def test_extension_kernel_matches_plain_sweep(dev, bw, xc, mg, mi, err):
    args = _up(dev, *extension_inputs(bw * 100 + xc, 300, 24, bw, err))
    kw = dict(KW, band_width=bw, x_cutoff=xc, max_gap=mg, max_intron=mi)
    _equal(sw_cuda.extension_forward(*args, **kw),
           sw_cuda.extension_forward_reference(*args, **kw))


def _anchored_pair(dev, args, kw):
    """Both anchored kernels against their plain versions."""
    args = _up(dev, *args)
    wband = int((args[4] + args[5]).max()) + 1
    _equal(sw_cuda.anchored_forward(*args, **kw),
           sw_cuda.anchored_forward_reference(*args, **kw))
    _equal(sw_cuda.anchored_forward_banded(*args, wband=wband, **kw),
           sw_cuda.anchored_forward_banded_reference(*args, wband=wband,
                                                     **kw))


@pytest.mark.parametrize("kw", [KW, KW_WRAP], ids=["default", "wrap"])
def test_anchored_kernels_match_plain(dev, kw):
    _anchored_pair(dev, anchored_inputs(23, 1000, 11, 14), kw)


@pytest.mark.parametrize("seed,d,mg,mi", ANCH_SWEEP, ids=ANCH_SWEEP_IDS)
def test_anchored_kernels_match_plain_sweep(dev, seed, d, mg, mi):
    _anchored_pair(dev, anchored_sweep_inputs(seed, d),
                   dict(KW, max_gap=mg, max_intron=mi))


def test_wrappers_count_launches_and_check_inputs(dev):
    q, qlens, r, rlens = _up(dev, *extension_inputs(5, 64, 16, 1))
    kw = dict(KW, band_width=1, x_cutoff=25)
    sw_cuda.reset_launches()
    sw_cuda.extension_forward(q, qlens, r, rlens, **kw)
    sw_cuda.extension_forward(q[:0], qlens[:0], r[:0], rlens[:0], **kw)
    assert sw_cuda.launches()["extension_forward"] == 1   # N = 0: none
    for bad in (r.to(torch.int32), r.t().contiguous().t(), r.cpu()):
        with pytest.raises(ValueError):
            sw_cuda.extension_forward(q, qlens, bad, rlens, **kw)
    assert sw_cuda.launches()["extension_forward"] == 1


@pytest.fixture(scope="module")
def testgen(dev, tmp_path_factory):
    from yaha_tpu_torch import host
    d = tmp_path_factory.mktemp("torch_cuda")
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), d)
    with gzip.open(os.path.join(GOLD, INDEX + ".gz")) as f:
        with open(os.path.join(d, INDEX), "wb") as out:
            out.write(f.read())
    return (host.load_genome(os.path.join(d, "testgen.nib2")),
            host.load_index(os.path.join(d, INDEX)))


def _reads(name):
    if name == "indel":
        return indel_reads(os.path.join(DATA, "testgen.fasta"), 200, 5)
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("qfile,over", [
    ("readsA_100bp.fasta", {}),
    ("readsD_sv.fasta", {"fbs": True}),
    ("indel", {}),
], ids=["A_default", "D_fbs", "indel"])
def test_staged_cuda_matches_native(dev, testgen, qfile, over):
    """Every gap fill and extension through the kernels (inline_small off):
    SAM bytes equal the native engine's."""
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.staged import StagedAligner
    genome, index = testgen
    aa = host.AlignmentArgs()
    aa.xfile_name = INDEX
    aa.ofile_name = "out.sam"
    for k, v in over.items():
        setattr(aa, k, v)
    aa.post_process(True)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    pr = host.parse_queries_native(_reads(qfile), False,
                                   aa.max_query_length, aa.word_len)
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=4)
    st = StagedAligner(aa, genome, index, device=dev, n_threads=4,
                       inline_small=False)
    sw_cuda.reset_launches()
    text, sm, nr = st.align_chunk(pr, 0, pr.n)
    assert text == ref[0]
    assert (sm, nr) == (ref[2], ref[3])
    launched = sw_cuda.launches()
    assert launched["extension_forward"] > 0
    assert launched["anchored_forward_banded"] > 0
    if qfile == "indel":
        assert st.stats["gap_full"] > 0
        assert launched["anchored_forward"] > 0
