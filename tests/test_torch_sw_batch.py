"""The port's lockstep DPs (yaha_tpu_torch.ops.sw_batch) against the JAX
package's XLA twins (yaha_tpu.ops.sw_batch) and the port's native host
DPs (native/host.extension_forward / anchored_forward).

The same numpy inputs of tests/torch_dp_cases.py go through
yaha_tpu.ops.sw_batch.batched_extension_forward / batched_anchored_forward
and their PyTorch counterparts on the CPU: every array (score, maxi,
maxj, eo, idc) equal, with no tolerance.

  * the extension at -BW 0, 1, 5, 9 and 16 (W = 1, 5, 21, 37, 65) on
    substitution reads, reads with an indel of up to 2*bw bases, an early
    X-drop (x_cutoff 4) and references shorter than qlen + 2*bw2, and at
    -BW 2 and 9 with the int32-wrap scoring;
  * the anchored gap fill as the masked full matrix on banded problems
    with asymmetric left/right widths (offsets 2 and 5, binding run caps)
    and on problems alternating full DP and bands, both scorings.
"""
import numpy as np
import pytest
import torch

from torch_dp_cases import (ANCH_SWEEP, ANCH_SWEEP_IDS, KW, KW_WRAP,
                            anchored_inputs, anchored_sweep_inputs,
                            extension_inputs, indel_extension_inputs)
from yaha_tpu.ops import sw_batch as jax_sw_batch
from yaha_tpu_torch.native import host
from yaha_tpu_torch.ops import sw_batch

EXT_KEYS = ("score", "maxi", "maxj", "eo", "idc")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _all_equal(args, kw, jax_fn, port_fn, native_fn, keys):
    want = {k: np.asarray(v) for k, v in jax_fn(*args, **kw).items()}
    got = port_fn(*_t(*args), **kw)
    nat = native_fn(*args, **kw)
    for key in keys:
        np.testing.assert_array_equal(want[key], got[key].numpy(),
                                      err_msg=key)
        np.testing.assert_array_equal(want[key], nat[key], err_msg=key)
    return got


def _ext_inputs(bw, kind, seed):
    if kind == "indel":
        return indel_extension_inputs(seed, 200, 48, bw)
    q, qlens, r, rlens = extension_inputs(seed, 200, 24, bw,
                                          0.5 if kind == "xdrop" else 0.15)
    if kind == "short_r":
        rlens = np.random.default_rng(seed).integers(1, rlens + 1)
    return q, qlens, r, rlens


@pytest.mark.parametrize("kind", ["subst", "indel", "xdrop", "short_r"])
@pytest.mark.parametrize("bw", [0, 1, 5, 9, 16])
def test_extension_twin_matches_jax(bw, kind):
    args = _ext_inputs(bw, kind, 100 * bw + len(kind))
    kw = dict(KW, band_width=bw, x_cutoff=4 if kind == "xdrop" else 25)
    got = _all_equal(args, kw, jax_sw_batch.batched_extension_forward,
                     sw_batch.batched_extension_forward,
                     host.extension_forward, EXT_KEYS)
    if kind == "xdrop":
        # The X-drop ends most problems before their last row.
        assert (got["maxi"].numpy() < args[1]).mean() > 0.5


@pytest.mark.parametrize("bw", [2, 9])
def test_extension_twin_wrap_scoring(bw):
    """DP_WORST - (go + ge) wraps int32 at this gap-open cost."""
    args = extension_inputs(11, 200, 12, bw)
    _all_equal(args, dict(KW_WRAP, band_width=bw, x_cutoff=25),
               jax_sw_batch.batched_extension_forward,
               sw_batch.batched_extension_forward, host.extension_forward,
               EXT_KEYS)


@pytest.mark.parametrize("seed,d,mg,mi", ANCH_SWEEP, ids=ANCH_SWEEP_IDS)
def test_anchored_twin_matches_jax_banded(seed, d, mg, mi):
    args = anchored_sweep_inputs(seed, d)
    _all_equal(args, dict(KW, max_gap=mg, max_intron=mi),
               jax_sw_batch.batched_anchored_forward,
               sw_batch.batched_anchored_forward, host.anchored_forward,
               ("score", "eo", "idc"))


@pytest.mark.parametrize("kw", [KW, KW_WRAP], ids=["default", "wrap"])
def test_anchored_twin_matches_jax_full(kw):
    """Problems alternating full DP (left_bw = right_bw >= max(qlen,
    rlen)) and asymmetric bands."""
    args = anchored_inputs(7, 200, 10, 12)
    _all_equal(args, kw, jax_sw_batch.batched_anchored_forward,
               sw_batch.batched_anchored_forward, host.anchored_forward,
               ("score", "eo", "idc"))
