"""The port's fragment-chain DP (yaha_tpu_torch.ops.chain) against the JAX
package and the native library.

On a CPU tensor batched_chain_dp runs its plain version, the function its
CUDA kernel (csrc/chain_kernels.cu) is held to on the card
(tests/test_torch_cuda.py, chip_smoke.py) and its g++-built body here
(tests/test_torch_csrc.py).  Here the plain version is held to
yaha_tpu.ops.chain_jax.batched_chain_dp on numpy-seeded inputs of
tests/torch_dp_cases.py, and to the port's native chain_dp (the C++
yt_chain_dp of the per-read engine) run on each range's valid nodes:

  * the ranges of tests/test_chain_jax.py (seeds 0-2, b 16, n_max 48, a
    fifth of them wrapping uint32 before the re-base);
  * one-node ranges, a range with no valid node, lengths whose scores
    wrap int16 (length * m_score past 32,767, at m_score 1 and 2);
  * ranges dense in equal scores with pads between valid nodes: every
    level of the relax's tie cascade and full ties in the fold.

All four outputs (best, best_score, prev, path_sqo) must be equal, with
no tolerance (integer arrays); the native engine runs on each range's
valid nodes (torch_dp_cases.native_chain maps its indices back; pads keep
prev -1 and their own SQO).
"""
import numpy as np
import pytest
import torch

from torch_dp_cases import (CHAIN_KW, CHAIN_TIE_KW, chain_case,
                            chain_edge_case, chain_tie_case, native_chain)
from yaha_tpu.ops import chain_jax
from yaha_tpu_torch.ops import chain

KEYS = ("best", "best_score", "prev", "path_sqo")


def _port(args, kw):
    return chain.batched_chain_dp(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw)


def _jax_equal(args, kw):
    want = chain_jax.batched_chain_dp(*args, **kw)
    got = _port(args, kw)
    for key in KEYS:
        np.testing.assert_array_equal(np.asarray(want[key]),
                                      got[key].numpy(), err_msg=key)
    return got


def _native_equal(got, sqo, eqo, diag, length, valid, kw):
    want = native_chain(sqo, eqo, diag, length, valid, kw)
    for key in KEYS:
        np.testing.assert_array_equal(want[key], got[key].numpy(),
                                      err_msg=key)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_matches_jax_and_native(seed):
    """tests/test_chain_jax.py's ranges: re-based diagonals for the port
    and JAX, the drawn (uint32) diagonals for the native engine."""
    sqo, eqo, diag, length, valid, diag_orig, counts = chain_case(seed, 16,
                                                                  48)
    got = _jax_equal((sqo, eqo, diag, length, valid), CHAIN_KW)
    _native_equal(got, sqo, eqo, diag_orig, length, valid, CHAIN_KW)


def test_chain_cases_wrap_uint32():
    """Seeds 0-2 hold ranges whose drawn diagonals wrap uint32: re-based
    as test_chain_jax re-bases them, their diagonals pass 2^31 and reach
    the DP as negative int32 values, whose differences wrap back."""
    wrapped = 0
    for seed in range(3):
        _, _, diag, _, valid, diag_orig, _ = chain_case(seed, 16, 48)
        lo = np.where(valid, diag_orig, 2**32).min(1)
        span = (diag_orig.max(1) - lo) > 2**31
        assert ((diag >= 2**31).any(1) == span).all()
        wrapped += int(span.sum())
    assert wrapped > 0


@pytest.mark.parametrize("m_score", [1, 2])
@pytest.mark.parametrize("case", ["n1", "invalid_row", "int16_wrap"])
def test_chain_edge_cases(case, m_score):
    args = dict(chain_edge_case())[case]
    kw = dict(CHAIN_KW, m_score=m_score)
    got = _jax_equal(args, kw)
    _native_equal(got, *args, kw)
    if case == "int16_wrap":
        # The SINT stores wrap: negative int16 lengths and scores occur.
        assert (got["best_score"].numpy() < 32768).all()
    if case == "invalid_row":
        assert int(got["best"][0]) == -1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_ties(seed):
    """Equal scores in the relax (diagonal gap, query gap and pathSQO
    decide) and in the fold (EQO, pathSQO, and full ties keep the earlier
    node), with pads between valid nodes."""
    args = chain_tie_case(seed)
    got = _jax_equal(args, CHAIN_TIE_KW)
    _native_equal(got, *args, CHAIN_TIE_KW)


def test_chain_wrapper_devices():
    """A CPU tensor runs the plain version (N = 0 included); a tensor on
    another device is refused."""
    z = torch.zeros((3, 0), dtype=torch.int32)
    out = chain.batched_chain_dp(z, z, z, z, z.bool(), **CHAIN_KW)
    assert out["best"].tolist() == [-1, -1, -1]
    assert out["best_score"].tolist() == [chain.NO_SCORE] * 3
    meta = torch.empty((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        chain.batched_chain_dp(meta, meta, meta, meta, meta.bool(),
                               **CHAIN_KW)


def _stages_by_loop(sqo, diag, valid, max_gap):
    """Pairs i < j of valid nodes reaching each test of chain_relax
    (csrc/chain_kernels.cu), one pair at a time in int32 arithmetic."""
    def w(x):
        return (int(x) + 2**31) % 2**32 - 2**31
    out = [0, 0, 0, 0]
    for r in range(sqo.shape[0]):
        idx = np.nonzero(valid[r])[0]
        for a, i in enumerate(idx):
            for j in idx[a + 1:]:
                out[0] += 1
                if sqo[r, j] <= sqo[r, i]:
                    continue
                out[1] += 1
                dg = w(w(diag[r, j]) - w(diag[r, i]))
                if (w(-dg) if dg < 0 else dg) > max_gap:
                    continue
                out[2] += 1
                if w(w(diag[r, j]) + sqo[r, j]) > w(w(diag[r, i]) +
                                                     sqo[r, i]):
                    out[3] += 1
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_smoke_chain_ops_counts_stages(seed):
    """chip_smoke.chain_ops, which sets the chain kernel's bound from a
    run's inputs, counts each stage's pairs as a per-pair loop does (the
    ranges of test_chain_jax, a fifth wrapping uint32; and tie-dense
    ranges with pads)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    for case in (chain_case(seed, 16, 48)[:5], chain_tie_case(seed)):
        sqo, eqo, diag, length, valid = case
        args = [torch.from_numpy(np.asarray(a).astype(np.int32))
                for a in (sqo, eqo, diag, length)]
        args.append(torch.from_numpy(np.asarray(valid)))
        ops, stages = chip_smoke.chain_ops(torch, args, CHAIN_KW["max_gap"])
        assert stages == _stages_by_loop(
            sqo, diag, valid, CHAIN_KW["max_gap"])
        assert ops == sum(k * c for k, c in
                          zip(chip_smoke.PAIR_STAGE_OPS, stages))
