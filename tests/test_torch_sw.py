"""The port's DP kernels (yaha_tpu_torch.ops.sw_cuda) against the JAX package.

On a CPU tensor each wrapper runs its plain PyTorch version, the function
its CUDA kernel is held to on the card (chip_smoke.py).  Here the plain
versions are held to the JAX package on numpy-seeded inputs:

  * against the Pallas kernels in interpret mode, at the shapes of
    tests/test_sw_pallas.py: every output equal, the whole packed
    backtrack plane included;
  * against the sw_batch XLA twins, through unpack_backtrack /
    unshift_anchored_banded, over band widths, asymmetric bands, binding
    max_gap / max_intron caps and X-drop exits.

These are integer DPs: every comparison is exact (tolerance zero).
"""
import numpy as np
import pytest
import torch

from torch_dp_cases import (ANCH_SWEEP, ANCH_SWEEP_IDS, EXT_SWEEP,
                            EXT_SWEEP_IDS, KW, KW_WRAP, anchored_inputs,
                            anchored_sweep_inputs, extension_inputs)
from yaha_tpu.ops import sw_batch, sw_pallas
from yaha_tpu_torch.ops import sw_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _assert_equal(want, got, keys):
    for key in keys:
        np.testing.assert_array_equal(np.asarray(want[key]),
                                      got[key].numpy(), err_msg=key)


@pytest.mark.parametrize("kw", [KW, KW_WRAP], ids=["default", "wrap"])
def test_extension_plain_matches_pallas(kw):
    q, qlens, r, rlens = extension_inputs(11, sw_pallas.TILE, 12, 2)
    ekw = dict(band_width=2, x_cutoff=25, **kw)
    want = sw_pallas.extension_forward_pallas(q, qlens, r, rlens,
                                              interpret=True, **ekw)
    got = sw_cuda.extension_forward(*_t(q, qlens, r, rlens), **ekw)
    _assert_equal(want, got, ("score", "maxi", "maxj", "bt"))


@pytest.mark.parametrize("kw", [KW, KW_WRAP], ids=["default", "wrap"])
def test_anchored_banded_plain_matches_pallas(kw):
    args = anchored_inputs(23, sw_pallas.TILE, 11, 14)
    wband = int((args[4] + args[5]).max()) + 1
    want = sw_pallas.anchored_forward_pallas_banded(
        *args, wband=wband, interpret=True, **kw)
    got = sw_cuda.anchored_forward_banded(*_t(*args), wband=wband, **kw)
    _assert_equal(want, got, ("score", "bt_b"))


@pytest.mark.parametrize("kw", [KW, KW_WRAP], ids=["default", "wrap"])
def test_anchored_full_plain_matches_pallas(kw):
    args = anchored_inputs(7, sw_pallas.TILE, 10, 12)
    want = sw_pallas.anchored_forward_pallas(*args, interpret=True, **kw)
    got = sw_cuda.anchored_forward(*_t(*args), **kw)
    _assert_equal(want, got, ("score", "bt"))


@pytest.mark.parametrize("bw,xc,mg,mi,err", EXT_SWEEP,
                         ids=EXT_SWEEP_IDS)
def test_extension_plain_matches_xla(bw, xc, mg, mi, err):
    n, ql = 300, 24
    q, qlens, r, rlens = extension_inputs(bw * 100 + xc, n, ql, bw, err)
    kw = dict(KW, band_width=bw, x_cutoff=xc, max_gap=mg, max_intron=mi)
    want = sw_batch.batched_extension_forward(q, qlens, r, rlens, **kw)
    got = sw_cuda.extension_forward(*_t(q, qlens, r, rlens), **kw)
    _assert_equal(want, got, ("score", "maxi", "maxj"))
    eo, idc = sw_pallas.unpack_backtrack(got["bt"].numpy(), "diag")
    np.testing.assert_array_equal(np.asarray(want["eo"]), eo)
    np.testing.assert_array_equal(np.asarray(want["idc"]).astype(np.int32),
                                  idc)
    if xc < 10:
        # The sweep point is meant to exit early: most problems stop short
        # of their last query row.
        assert (got["maxi"].numpy() < qlens).mean() > 0.5


@pytest.mark.parametrize("seed,d,mg,mi", ANCH_SWEEP,
                         ids=ANCH_SWEEP_IDS)
def test_anchored_plain_matches_xla(seed, d, mg, mi):
    q, qlens, r, rlens, lbw, rbw = anchored_sweep_inputs(seed, d)
    ql, rl = q.shape[1], r.shape[1]
    kw = dict(KW, max_gap=mg, max_intron=mi)
    want = sw_batch.batched_anchored_forward(q, qlens, r, rlens, lbw, rbw,
                                             **kw)
    ref_eo = np.asarray(want["eo"])
    ref_idc = np.asarray(want["idc"]).astype(np.int32)
    args = _t(q, qlens, r, rlens, lbw, rbw)

    full = sw_cuda.anchored_forward(*args, **kw)
    np.testing.assert_array_equal(np.asarray(want["score"]),
                                  full["score"].numpy())
    # The full-width kernel writes in-band cells only (as the Pallas one).
    ii = np.arange(ql + 1)[None, :, None]
    jj = np.arange(rl + 1)[None, None, :]
    band = ((ii <= qlens[:, None, None]) & (jj <= rlens[:, None, None])
            & (jj >= ii - lbw[:, None, None])
            & (jj <= ii + rbw[:, None, None]))
    eo, idc = sw_pallas.unpack_backtrack(full["bt"].numpy(), "up")
    np.testing.assert_array_equal(np.where(band, ref_eo, 0),
                                  np.where(band, eo, 0))
    np.testing.assert_array_equal(np.where(band, ref_idc, 0),
                                  np.where(band, idc, 0))

    wband = int((lbw + rbw).max()) + 1
    banded = sw_cuda.anchored_forward_banded(*args, wband=wband, **kw)
    np.testing.assert_array_equal(np.asarray(want["score"]),
                                  banded["score"].numpy())
    eo_b, idc_b = sw_pallas.unpack_backtrack(banded["bt_b"].numpy(), "diag")
    eo, idc = sw_pallas.unshift_anchored_banded(eo_b, idc_b, lbw,
                                                wid=rl + 1)
    np.testing.assert_array_equal(ref_eo, np.asarray(eo))
    np.testing.assert_array_equal(ref_idc, np.asarray(idc))


def test_wrappers_take_any_n_and_reject_other_devices():
    """N need not be a multiple of a tile (N = 0 and N = 3 here), and a
    tensor that is neither on the CPU nor on a CUDA device is refused."""
    for n in (0, 3):
        q, qlens, r, rlens = extension_inputs(5, n, 8, 1)
        out = sw_cuda.extension_forward(*_t(q, qlens, r, rlens),
                                        band_width=1, x_cutoff=25, **KW)
        assert out["bt"].shape == (n, 9, 5)
        assert out["score"].shape == (n,)
    meta = torch.empty((2, 4), dtype=torch.uint8, device="meta")
    lens = torch.ones(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        sw_cuda.anchored_forward(meta, lens, meta, lens, lens, lens, **KW)
