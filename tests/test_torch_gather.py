"""The port's device problem assembly (yaha_tpu_torch.ops.gather_dp) and its
4-bit packed DP entries against the JAX package.

On CPU tensors DeviceCorpus runs the gather kernel's plain version
(gather_reference), the function the CUDA kernel is held to on the card.
Both corpora are built from one numpy genome and fed the same numpy
coordinates; every output must be equal (u8 planes, tolerance zero).
"""
import numpy as np
import pytest
import torch

from torch_dp_cases import (KW, anchored_inputs, extension_inputs,
                            gather_aligned_coords, gather_case, gather_coords,
                            read_rows)
from yaha_tpu.ops import gather_dp as jax_gather
from yaha_tpu.ops import sw_pallas
from yaha_tpu_torch.ops import gather_dp, sw_cuda


@pytest.fixture(scope="module")
def corpora():
    g, fwd, lens = gather_case(41)
    jc = jax_gather.DeviceCorpus(g)
    tc = gather_dp.DeviceCorpus(g, "cpu")
    return jc, tc, jc.chunk_rows(fwd, lens), read_rows(tc, fwd, lens)


@pytest.mark.parametrize("seed", [41, 42])
def test_read_rows_match_jax_chunk_rows(seed):
    """The engine's strand rows, built on the device from the reads'
    sequence characters, equal the JAX rows built from host-coded ones."""
    g, fwd, lens = gather_case(seed)
    want = jax_gather.DeviceCorpus(g).chunk_rows(fwd, lens)
    got = read_rows(gather_dp.DeviceCorpus(g, "cpu"), fwd, lens)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("rpad,pack,rev_share", [
    (0, False, 0.0), (0, True, 0.0), (255, False, 0.5), (255, True, 0.5),
], ids=["gap", "gap_p4", "ext_rev", "ext_rev_p4"])
def test_gather_matches_jax(corpora, rpad, pack, rev_share):
    jc, tc, jrows, trows = corpora
    qg, rg = 64, 96
    c = gather_coords(rpad + 2 * pack, 300, qg, rg, rev_share)
    rev = c[7] if rev_share else None
    want = jc.gather(jrows, *c[:7], rev, qg=qg, rg=rg, rpad=rpad, pack=pack)
    got = tc.gather(trows, *c[:7], rev, qg=qg, rg=rg, rpad=rpad, pack=pack)
    for w_, g_ in zip(want, got):
        assert g_.dtype == torch.uint8
        np.testing.assert_array_equal(np.asarray(w_), g_.numpy())
    if not pack:
        # Past the problem: q is 0, r takes the pad value.
        jr = np.arange(rg)[None, :]
        assert (got[1].numpy()[jr >= c[6][:, None]] == rpad).all()


@pytest.mark.parametrize("qg,rg,rpad", [(64, 96, 0), (40, 75, 255)],
                         ids=["64x96", "40x75_pad"])
def test_gather_aligned_and_clamped_match_jax(corpora, qg, rg, rpad):
    """Whole copies from every source alignment 0-15, forward and
    reversed, lengths and widths that are not multiples of 16, and sources
    clamped at the end of a row and of the genome and before the start of
    a row (gather_aligned_coords): the gather kernel's 16-byte path and
    its edges."""
    jc, tc, jrows, trows = corpora
    c = gather_aligned_coords(qg, rg, trows.shape[1],
                              int(tc.codes.shape[0]), trows.shape[0])
    want = jc.gather(jrows, *c, qg=qg, rg=rg, rpad=rpad, pack=False)
    got = tc.gather(trows, *c, qg=qg, rg=rg, rpad=rpad, pack=False)
    for w_, g_ in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w_), g_.numpy())


def test_gather_wrapper_refuses_other_devices():
    meta = torch.empty((2, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        gather_dp.gather_problems(meta, meta[0], torch.empty(
            (8, 2), dtype=torch.int64, device="meta"), qg=4, rg=4, rpad=0)


def test_pack4_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 16, (7, 20)).astype(np.uint8)
    a[:, 15:] = 255
    p = sw_cuda.pack4_host(a)
    np.testing.assert_array_equal(sw_pallas.pack4_host(a), p)
    got = sw_cuda.unpack4(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(np.asarray(sw_pallas._unpack4(p)), got)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _equal(want, got):
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_extension_p4_matches_unpacked():
    q, qlens, r, rlens = extension_inputs(17, 200, 24, 2)
    r[np.arange(r.shape[1])[None, :] >= rlens[:, None]] = 255
    kw = dict(KW, band_width=2, x_cutoff=25)
    _equal(sw_cuda.extension_forward(*_t(q, qlens, r, rlens), **kw),
           sw_cuda.extension_forward_p4(
               *_t(sw_cuda.pack4_host(q), qlens, sw_cuda.pack4_host(r),
                   rlens), **kw))


def test_anchored_p4_match_unpacked():
    q, qlens, r, rlens, lbw, rbw = anchored_inputs(19, 200, 12, 16)
    wband = int((lbw + rbw).max()) + 1
    packed = _t(sw_cuda.pack4_host(q), qlens, sw_cuda.pack4_host(r), rlens,
                lbw, rbw)
    plain = _t(q, qlens, r, rlens, lbw, rbw)
    _equal(sw_cuda.anchored_forward(*plain, **KW),
           sw_cuda.anchored_forward_p4(*packed, **KW))
    _equal(sw_cuda.anchored_forward_banded(*plain, wband=wband, **KW),
           sw_cuda.anchored_forward_banded_p4(*packed, wband=wband, **KW))
