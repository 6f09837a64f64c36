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

The CUDA kernel's bodies, built with g++ (tests/test_torch_csrc.py's
run_chain: the kernel's team for N, the pair tests, then a step at each
node with a candidate successor), are held here to chain_jax and the native
chain_dp directly, at N = 1, 48, 64, 65, 2,048 and 4,096, on the
tie-dense and edge ranges, on ranges out of SQO order and with values
past 2^28 (no SQO window), and on ranges whose candidate DAG is one path
through every node (a step at every node but the last); the steps taken
must number the nodes with a candidate successor
(torch_dp_cases.chain_candidates).
"""
import numpy as np
import pytest
import torch

from test_torch_csrc import lib  # noqa: F401
from torch_dp_cases import (CHAIN_KW, CHAIN_TIE_KW, chain_candidates,
                            chain_case, chain_edge_case, chain_path_case,
                            chain_tie_case, chain_unsorted_case,
                            native_chain)
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
@pytest.mark.parametrize("case", ["n1", "invalid_row", "int16_wrap",
                                  "gap_edges"])
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


def _body(lib, args, kw):
    """The kernel's bodies (run_chain, the kernel's team for N) on outputs
    prefilled with garbage; returns the outputs, the steps taken
    and whether each range took the SQO window."""
    b, n = np.asarray(args[0]).shape
    arrs = [np.ascontiguousarray(a, np.uint8 if np.asarray(a).dtype == bool
                                 else np.int32) for a in args]
    out = {key: np.full(shape, 0x5A5A5A5A, np.int32) for key, shape in (
        ("best", b), ("best_score", b), ("prev", (b, n)),
        ("path_sqo", (b, n)), ("steps", b), ("windows", b))}
    params = np.array([kw[key] for key in ("max_gap", "max_desert",
                                           "m_score", "go_cost", "ge_cost")],
                      np.int32)
    assert lib.run_chain(0, 0, *(a.ctypes.data for a in arrs), b, n,
                         params.ctypes.data, *(out[key].ctypes.data for key
                                               in KEYS + ("steps",
                                                          "windows"))) == 0
    return out


def _body_case(case):
    if case.startswith("seed"):
        return chain_case(int(case[4:]), 16, 48)[:5], CHAIN_KW
    if case.startswith("n="):
        n = int(case[2:])
        return chain_case(n, 4 if n <= 65 else 2, n, qspan=40 * n)[:5], \
            CHAIN_KW
    if case.startswith("path="):
        return chain_path_case(int(case[5:])), CHAIN_KW
    if case == "ties":
        return chain_tie_case(0), CHAIN_TIE_KW
    if case == "unsorted":
        return chain_unsorted_case(), CHAIN_KW
    if case == "far":
        # Query offsets past 2^28: the window's arithmetic bound does not
        # hold, so every pair is scanned (the sums stay within int32).
        sqo, eqo, diag, length, valid = chain_case(5, 8, 48)[:5]
        return (sqo + 2**29, eqo + 2**29, diag, length, valid), CHAIN_KW
    return dict(chain_edge_case())[case], dict(CHAIN_KW, m_score=2)


@pytest.mark.parametrize("case", [
    "seed0", "n1", "invalid_row", "int16_wrap", "gap_edges", "ties",
    "unsorted", "far", "n=64", "n=65",
    "n=2048", "n=4096", "path=64", "path=300", "path=4096"])
def test_chain_body_matches_jax_and_native(lib, case):
    """The two-phase kernel body (pair tests, then steps at the nodes with
    a candidate successor) equals chain_jax and the native chain_dp, every
    output; its steps number those nodes.  The pair tests stop at the SQO
    window on every range that allows it (valid nodes in SQO order, values
    within 2^28; the re-based ranges that wrap uint32 included), and scan
    every pair of the unsorted and the far ranges."""
    args, kw = _body_case(case)
    got = _body(lib, args, kw)
    assert got["windows"].all() != (case in ("unsorted", "far"))
    assert got["windows"].all() or not got["windows"].any()
    want = chain_jax.batched_chain_dp(*args, **kw)
    for key in KEYS:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    native = native_chain(*args, kw)
    for key in KEYS:
        np.testing.assert_array_equal(got[key], native[key], err_msg=key)
    n = np.asarray(args[0]).shape[1]
    if case.startswith("path="):
        assert got["steps"].tolist() == [n - 1] * len(got["steps"])
    elif n <= 300:
        want_steps = [int(chain_candidates(*(np.asarray(a)[r] for a in args),
                                           kw).any(1).sum())
                      for r in range(len(got["steps"]))]
        assert got["steps"].tolist() == want_steps


@pytest.mark.parametrize("case", ["seed0", "seed1", "ties", "path=40"])
def test_smoke_chain_dag_counts(case):
    """chip_smoke.chain_dag, which prints phase 7's candidate-DAG counts,
    agrees with torch_dp_cases.chain_candidates: the first kernel's steps
    (every node up to each range's last valid one), the nodes with a
    candidate successor and each range's longest path."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    args, kw = _body_case(case)
    t = [torch.from_numpy(np.asarray(a).astype(np.int32)) for a in args[:4]]
    t.append(torch.from_numpy(np.asarray(args[4])))
    old_steps, active, depth = chip_smoke.chain_dag(torch, t, kw)
    valid = np.asarray(args[4])
    want_steps, want_active, want_depth = 0, 0, []
    for r in range(valid.shape[0]):
        m = chain_candidates(*(np.asarray(a)[r] for a in args), kw)
        idx = np.nonzero(valid[r])[0]
        want_steps += int(idx[-1]) if len(idx) else 0
        want_active += int(m.any(1).sum())
        dep = np.zeros(m.shape[0], int)
        for j in range(m.shape[0]):
            pred = np.nonzero(m[:, j])[0]
            if len(pred):
                dep[j] = dep[pred].max() + 1
        want_depth.append(dep.max())
    assert (old_steps, active) == (want_steps, want_active)
    assert depth.tolist() == want_depth
    if case.startswith("path="):
        assert depth.tolist() == [int(case[5:]) - 1] * valid.shape[0]


def _window_stages_by_loop(args, kw):
    """chip_smoke.chain_window_ops's counts, one pair at a time: on a
    range that allows the SQO window, each valid i's valid j > i up to the
    first past the window; elsewhere every pair of valid nodes."""
    sqo, eqo, diag, _, valid = (np.asarray(a) for a in args)
    small = 2**28
    lim = kw["max_desert"] + kw["max_gap"]
    out, windowed = [0, 0, 0, 0], 0
    for r in range(sqo.shape[0]):
        idx = np.nonzero(valid[r])[0]
        # The values as the kernel reads them: int32.
        s, e, d = ((np.asarray(x[r], np.int64) + 2**31) % 2**32 - 2**31
                   for x in (sqo, eqo, diag))
        ok = (0 <= kw["max_gap"] < small and 0 <= kw["max_desert"] < small
              and all(abs(int(x[j])) < small for x in (s, e, d) for j in idx)
              and all(s[a] <= s[b] for a, b in zip(idx, idx[1:])))
        for a, i in enumerate(idx):
            for j in idx[a + 1:]:
                stages = _stages_by_loop(sqo[r:r + 1, [i, j]],
                                         diag[r:r + 1, [i, j]],
                                         np.ones((1, 2), bool),
                                         kw["max_gap"])
                out = [x + y for x, y in zip(out, stages)]
                windowed += ok
                if ok and s[j] - e[i] - 1 > lim:
                    break
    return out, windowed


@pytest.mark.parametrize("case", ["seed0", "ties", "unsorted", "far",
                                  "gap_edges", "path=40"])
def test_smoke_chain_window_ops_counts_pairs(case):
    """chip_smoke.chain_window_ops, which sets the chain kernel's restated
    bound (the pairs the SQO window leaves), counts as a per-pair loop."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    args, kw = _body_case(case)
    t = [torch.from_numpy(np.asarray(a).astype(np.int32)) for a in args[:4]]
    t.append(torch.from_numpy(np.asarray(args[4])))
    ops, stages = chip_smoke.chain_window_ops(torch, t, kw)
    want, windowed = _window_stages_by_loop(args, kw)
    assert stages == want
    assert ops == sum(k * c for k, c in zip(chip_smoke.PAIR_STAGE_OPS,
                                            stages)) + \
        chip_smoke.WINDOW_PAIR_OPS * windowed
    if case in ("unsorted", "far"):
        assert windowed == 0
    else:
        assert windowed == stages[0]
