"""Full-width gap buckets wider than the card's wide route takes go to the
lockstep twin (yaha_tpu_torch/models/staged.py, backend "cuda"), and wide
extension bands stay on the kernels.

The anchored wide route gives each problem a warp whose shared memory
grows with the plane's row width; a plane whose warp does not fit a
block's shared memory is refused by the C entry (csrc/wavefront.cuh
kWideSmemMax).  The engine decides by shape, before any launch, which
buckets those are (ops/sw_cuda.full_wide_fits) and sends them to
ops/sw_batch.py's twin on the same device, as the reference sends its
gap_fallback class to its XLA twin.  Past W 2,829, where the wide
extension kernel's strip stages no longer fit, the block extension kernel
takes the band, so every band up to -BW 3,566 stays on a kernel
(ops/sw_cuda.ext_wide_fits).  On the CPU the dispatch
runs as on the card, with the kernel entries replaced by recorders that
fail on a plane the C entry would refuse:

  * four reads with 7-8 kb flanks around a 3.0-3.5 kb deletion and 30-45
    inserted bases (tests/torch_dp_cases.long_gap_reads) at -G 3,600: two
    unbanded gap buckets of RL 4,096 go to the twin, no refused plane
    reaches anchored_forward, and the SAM equals the native engine's;
  * -BW 708 (W 2,833, one band past the staged wide kernel's 2,829): the
    JAX package's batch-xla engine aligns readsA's first reads as its
    native engine does, with its extensions on the device; the port sends
    every extension bucket to extension_forward and writes the native
    engine's SAM.

The copies of wide_warp_bytes and ext_block_bytes that the predicates
use are held to the C functions in tests/test_torch_csrc.py.
"""
import gzip
import os
import shutil

import pytest

from conftest import DATA, GOLD
from torch_dp_cases import long_gap_reads
from yaha_tpu_torch.ops import sw_cuda

INDEX = "testgen.X11_01_65525S"


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    d = tmp_path_factory.mktemp("twin_route")
    shutil.copy(os.path.join(DATA, "readsA_100bp.fasta"), d)
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), d)
    with gzip.open(os.path.join(GOLD, INDEX + ".gz")) as f:
        with open(os.path.join(d, INDEX), "wb") as out:
            out.write(f.read())
    return str(d)


def _aa(host, index, **over):
    aa = host.AlignmentArgs()
    aa.xfile_name = INDEX
    aa.qfile_name = "reads.fa"
    aa.ofile_name = "out.sam"
    for k, v in over.items():
        setattr(aa, k, v)
    aa.post_process(True)
    aa.word_len = index.word_len
    aa.fastq = False
    return aa


def test_anch_wide_fits_edges():
    """Full-width planes of up to 32 columns stay in registers; wider ones
    fit up to 2,832 columns (RL 2,831); extension bands up to -BW 3,566
    (the block kernel past -BW 707, whose row of W + 1 cells must fit)."""
    fits = sw_cuda.full_wide_fits
    assert fits(31) and fits(2831)
    assert not fits(2832) and not fits(4096)
    assert sw_cuda.ext_wide_fits(3566) and not sw_cuda.ext_wide_fits(3567)
    assert all(sw_cuda.ext_wide_fits(bw) for bw in range(0, 3567))
    assert sw_cuda.wide_warp_bytes(4 * 707 + 1) <= sw_cuda.WIDE_SMEM_MAX < (
        sw_cuda.wide_warp_bytes(4 * 708 + 1))


def _recorders(monkeypatch):
    """Replace the three DP entries by recorders that fail on a plane the
    C entry refuses and then run the plain version; returns the log."""
    log = []
    real = {k: getattr(sw_cuda, k) for k in (
        "anchored_forward", "anchored_forward_banded", "extension_forward")}

    def anchored(q, ql, r, rl, lb, rb, **kw):
        log.append(("full", r.shape[1]))
        assert sw_cuda.full_wide_fits(r.shape[1])
        return real["anchored_forward"](q, ql, r, rl, lb, rb, **kw)

    def banded(q, ql, r, rl, lb, rb, *, wband, **kw):
        log.append(("banded", wband))
        return real["anchored_forward_banded"](q, ql, r, rl, lb, rb,
                                               wband=wband, **kw)

    def extension(q, ql, r, rl, *, band_width, **kw):
        log.append(("ext", band_width))
        assert sw_cuda.ext_wide_fits(band_width)
        return real["extension_forward"](q, ql, r, rl,
                                         band_width=band_width, **kw)

    monkeypatch.setattr(sw_cuda, "anchored_forward", anchored)
    monkeypatch.setattr(sw_cuda, "anchored_forward_banded", banded)
    monkeypatch.setattr(sw_cuda, "extension_forward", extension)
    return log


def test_long_gap_buckets_take_the_twin(scratch, monkeypatch):
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.staged import StagedAligner
    genome = host.load_genome(os.path.join(scratch, "testgen.nib2"))
    index = host.load_index(os.path.join(scratch, INDEX))
    aa = _aa(host, index, max_gap=3600)
    data = long_gap_reads(os.path.join(DATA, "testgen.fasta"))
    pr = host.parse_queries_native(data, False, aa.max_query_length,
                                   aa.word_len)
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=2)
    log = _recorders(monkeypatch)
    st = StagedAligner(aa, genome, index, device="cpu", n_threads=2)
    text, sm, nr = st.align_chunk(pr, 0, pr.n)
    assert text == ref[0]
    assert (sm, nr) == (ref[2], ref[3])
    s = st.stats
    assert s["gap_twin"] == 2 and s["gap_fallback"] == 0
    assert s["gap_problems"] == s["gap_twin"] + s["gap_banded"] + s[
        "gap_full"]
    assert log and all(k != "full" or rl < 4096 for k, rl in log)


def test_reference_and_port_align_at_bw_708(scratch, monkeypatch):
    """The extension's width check: the JAX package's batch-xla engine
    aligns at -BW 708 as its native engine does (with its extensions on
    the device), and so does the port, through extension_forward (the
    block extension kernel on the card), with the native engine's SAM."""
    from yaha_tpu.models.staged import StagedAligner as JaxStaged
    from yaha_tpu.io import native_loader as jloader
    from yaha_tpu.native import host as jhost
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.staged import StagedAligner
    with open(os.path.join(scratch, "readsA_100bp.fasta"), "rb") as f:
        data = f.read()
    data = b">" + b">".join(data.split(b">")[1:11])
    jgenome = jloader.load_genome(os.path.join(scratch, "testgen.nib2"))
    jindex = jloader.load_index(os.path.join(scratch, INDEX))
    jaa = _aa(host, jindex, band_width=708)
    jpr = jhost.parse_queries_native(data, False, jaa.max_query_length,
                                     jaa.word_len)
    jref = jhost.align_batch_native(jpr, 0, jpr.n, jgenome, jindex, jaa,
                                    n_threads=2)[0]
    jst = JaxStaged(jaa, jgenome, jindex, backend="xla", n_threads=2)
    assert jst.align_chunk(jpr, 0, jpr.n)[0] == jref
    assert jst.stats["ext_problems"] > 0 and jst.stats["dp_launches"] > 0

    genome = host.load_genome(os.path.join(scratch, "testgen.nib2"))
    index = host.load_index(os.path.join(scratch, INDEX))
    aa = _aa(host, index, band_width=708)
    pr = host.parse_queries_native(data, False, aa.max_query_length,
                                   aa.word_len)
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=2)[0]
    assert ref == jref
    log = _recorders(monkeypatch)
    st = StagedAligner(aa, genome, index, device="cpu", n_threads=2)
    assert st.align_chunk(pr, 0, pr.n)[0] == ref
    assert st.stats["ext_problems"] > 0
    assert {e for e in log if e[0] == "ext"} == {("ext", 708)}
