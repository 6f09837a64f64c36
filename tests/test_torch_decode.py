"""The port's device backtrack walk (yaha_tpu_torch.ops.decode) against the
JAX package's decode and the native packed-plane walkers.

On CPU tensors the walk runs its plain version (rle_walk_reference), the
function the CUDA kernel is held to on the card.  Planes come from the
port's plain DP versions (held to the Pallas kernels in
tests/test_torch_sw.py) on mutated copies (tests/test_decode_jax.py's
fixtures), so every op kind appears: match/replace runs, deletes to the
band edge, insert chains, X-drop exits and score <= 0 walks.  Items and
n_ops are integers: every comparison is exact.
"""
import random

import numpy as np
import pytest
import torch

from test_decode_jax import _items_from_rle, _mutate
from torch_dp_cases import long_run_inputs
from yaha_tpu.ops import decode_jax, dp_common
from yaha_tpu_torch.ops import decode, sw_cuda

KW = dict(go=2, ge=1, rc=3, ms=1, max_gap=50, max_intron=100, x_cutoff=25)
GAP_KW = {k: v for k, v in KW.items() if k != "x_cutoff"}


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _same_as_jax(got, want):
    """The port's (rle, n_ops) equal decode_jax's, item slots past n_ops
    included (both zero)."""
    rle, n_ops = got
    np.testing.assert_array_equal(np.asarray(want[1]), n_ops.numpy())
    np.testing.assert_array_equal(np.asarray(want[0]), rle.numpy())


def _extension_case(n=300, ql=48, bw=4, seed=20260819):
    rng = random.Random(seed)
    bw2 = 2 * bw
    rl = ql + 2 * bw2
    q = np.zeros((n, ql), np.uint8)
    r = np.full((n, rl), 255, np.uint8)
    qlens = np.zeros(n, np.int64)
    rlens = np.zeros(n, np.int64)
    for i in range(n):
        qn = rng.randrange(4, ql + 1)
        base = [rng.randrange(4) for _ in range(qn)]
        mut = _mutate(rng, base, rng.randrange(0, 6), rng.randrange(0, 3))
        rn = min(rl, len(mut) + rng.randrange(0, 2 * bw2))
        q[i, :qn] = base
        r[i, :rn] = (mut + [rng.randrange(4) for _ in range(rl)])[:rn]
        qlens[i] = qn
        rlens[i] = rn
    return sw_cuda.extension_forward(*_t(q, qlens, r, rlens), band_width=bw,
                                     **KW)


def test_band_walk_matches_jax_and_native_on_extensions():
    out = _extension_case()
    ql = out["bt"].shape[1] - 1
    w = out["bt"].shape[2]
    cap = 256
    active = out["score"] > 0
    got = decode.rle_decode_band(out["bt"], out["maxi"], out["maxj"],
                                 active, cap=cap)
    _same_as_jax(got, decode_jax.rle_decode_band(
        out["bt"].numpy(), out["maxi"].numpy(), out["maxj"].numpy(),
        active.numpy(), cap=cap, max_iters=2 * ql + w + 16))
    rle, n_ops = (a.numpy() for a in got)
    score = out["score"].numpy()
    assert (n_ops[score <= 0] == 0).all() and (score <= 0).any()
    for i in np.nonzero(score > 0)[0]:
        want, _, _ = dp_common.traceback_extension_packed(
            out["bt"][i].numpy(), out["maxi"][i], out["maxj"][i], score[i],
            2 * 4, reverse=True)
        assert _items_from_rle(rle[i], n_ops[i]) == want, i


def _anchored_case(seed, n, ql, rl, wband, mg=50, mi=100):
    rng = random.Random(seed)
    q = np.zeros((n, ql), np.uint8)
    r = np.full((n, rl), 255, np.uint8)
    qlens, rlens, lbw, rbw = (np.zeros(n, np.int64) for _ in range(4))
    for i in range(n):
        qn = rng.randrange(2, ql + 1)
        base = [rng.randrange(4) for _ in range(qn)]
        mut = _mutate(rng, base, rng.randrange(0, 5), rng.randrange(0, 3))
        rn = max(1, min(rl, len(mut)))
        q[i, :qn] = base
        r[i, :rn] = (mut + [rng.randrange(4) for _ in range(rl)])[:rn]
        qlens[i], rlens[i] = qn, rn
        lbw[i] = max(4, qn - rn + 2)
        rbw[i] = max(4, rn - qn + 2)
        if lbw[i] + rbw[i] >= wband:
            rbw[i] = wband - 1 - lbw[i]
    args = _t(q, qlens, r, rlens, lbw, rbw)
    kw = dict(GAP_KW, max_gap=mg, max_intron=mi)
    return (args, sw_cuda.anchored_forward_banded(*args, wband=wband, **kw),
            sw_cuda.anchored_forward(*args, **kw))


def test_band_walk_matches_jax_and_native_on_gap_fills():
    args, banded, _ = _anchored_case(7, 300, 40, 48, 32)
    qlens, rlens, lbw = args[1], args[3], args[4]
    y0 = qlens.to(torch.int32)
    x0 = (rlens - qlens + lbw).to(torch.int32)
    ones = torch.ones(len(y0), dtype=torch.bool)
    cap = 256
    got = decode.rle_decode_band(banded["bt_b"], y0, x0, ones, cap=cap)
    _same_as_jax(got, decode_jax.rle_decode_band(
        banded["bt_b"].numpy(), y0.numpy(), x0.numpy(), ones.numpy(),
        cap=cap, max_iters=2 * 40 + 32 + 16))
    rle, n_ops = (a.numpy() for a in got)
    for i in range(len(y0)):
        want = dp_common.traceback_anchored_banded_packed(
            banded["bt_b"][i].numpy(), lbw[i], qlens[i], rlens[i])
        assert _items_from_rle(rle[i], n_ops[i])[::-1] == want, i


def test_full_walk_matches_jax_and_native():
    args, _, full = _anchored_case(99, 300, 32, 40, 64)
    qlens, rlens = args[1], args[3]
    y0, x0 = qlens.to(torch.int32), rlens.to(torch.int32)
    ones = torch.ones(len(y0), dtype=torch.bool)
    cap = 256
    got = decode.rle_decode_full(full["bt"], y0, x0, ones, cap=cap)
    _same_as_jax(got, decode_jax.rle_decode_full(
        full["bt"].numpy(), y0.numpy(), x0.numpy(), ones.numpy(), cap=cap,
        max_iters=32 + 40 + 16))
    rle, n_ops = (a.numpy() for a in got)
    for i in range(len(y0)):
        want = dp_common.traceback_anchored_packed(full["bt"][i].numpy(),
                                                   qlens[i], rlens[i])
        assert _items_from_rle(rle[i], n_ops[i])[::-1] == want, i


def test_long_match_run_is_one_item():
    """A clean 400-base extension decodes to one M run (JAX's
    test_rle_long_runs_cap_and_merge, which crosses its 255-cell cap)."""
    rng = random.Random(5)
    ql, bw2 = 400, 8
    base = [rng.randrange(4) for _ in range(ql)]
    q = np.array([base, base[:1] + [0] * (ql - 1)], np.uint8)
    r = np.full((2, ql + 2 * bw2), 255, np.uint8)
    r[:, :ql] = q
    qlens = rlens = np.array([ql, 1])
    out = sw_cuda.extension_forward(*_t(q, qlens, r, rlens), band_width=4,
                                    **KW)
    rle, n_ops = decode.rle_decode_band(out["bt"], out["maxi"], out["maxj"],
                                        out["score"] > 0, cap=64)
    assert int(n_ops[0]) == 1
    assert _items_from_rle(rle[0].numpy(), 1) == [["M", ql]]
    want = decode_jax.rle_decode_band(
        out["bt"].numpy(), out["maxi"].numpy(), out["maxj"].numpy(),
        (out["score"] > 0).numpy(), cap=64, max_iters=2 * ql + 64)
    _same_as_jax((rle, n_ops), want)


def test_too_small_cap_flags_minus_one():
    """A walk with more items than cap keeps its first cap items and
    reports n_ops = -1; decode_jax, bounded by as many iterations as the
    cap, flags the same walks."""
    args, _, full = _anchored_case(99, 300, 32, 40, 64)
    y0, x0 = args[1].to(torch.int32), args[3].to(torch.int32)
    ones = torch.ones(len(y0), dtype=torch.bool)
    full_rle, full_n = decode.rle_decode_full(full["bt"], y0, x0, ones,
                                              cap=256)
    cap = 3
    rle, n_ops = decode.rle_decode_full(full["bt"], y0, x0, ones, cap=cap)
    over = full_n.numpy() > cap
    assert over.any() and (~over).any()
    np.testing.assert_array_equal(n_ops.numpy(),
                                  np.where(over, -1, full_n.numpy()))
    np.testing.assert_array_equal(rle.numpy(), full_rle[:, :cap].numpy())
    _, jax_n = decode_jax.rle_decode_full(
        full["bt"].numpy(), y0.numpy(), x0.numpy(), ones.numpy(), cap=cap,
        max_iters=cap)
    assert (np.asarray(jax_n)[over] == -1).all()


def _long_run_problem(event):
    """One gap fill with a 260-base deletion ("D") or insertion ("I")."""
    return _t(*long_run_inputs(event))


@pytest.mark.parametrize("full,event", [(True, "D"), (True, "I"),
                                        (False, "D"), (False, "I")],
                         ids=["full_del", "full_ins", "band_del", "band_ins"])
def test_runs_longer_than_255_follow_the_native_walker(full, event):
    """max_gap = max_intron = 300: a 260-base gap is one run, as the native
    walkers (the SAM truth) read it.  decode_jax, whose jumps stop at 255
    cells, merges the two jumps into the same item."""
    args = _long_run_problem(event)
    qlen, rlen, lbw = (int(args[k][0]) for k in (1, 3, 4))
    kw = dict(GAP_KW, max_gap=300, max_intron=300)
    y0 = torch.tensor([qlen], dtype=torch.int32)
    one = torch.ones(1, dtype=torch.bool)
    walk_kw = dict(cap=64, max_iters=qlen + rlen + 16)
    if full:
        bt = sw_cuda.anchored_forward(*args, **kw)["bt"]
        x0 = torch.tensor([rlen], dtype=torch.int32)
        got = decode.rle_decode_full(bt, y0, x0, one, cap=64)
        jax_got = decode_jax.rle_decode_full(
            bt.numpy(), y0.numpy(), x0.numpy(), one.numpy(), **walk_kw)
        want = dp_common.traceback_anchored_packed(bt[0].numpy(), qlen,
                                                   rlen)
    else:
        bt = sw_cuda.anchored_forward_banded(*args, wband=512, **kw)["bt_b"]
        x0 = torch.tensor([rlen - qlen + lbw], dtype=torch.int32)
        got = decode.rle_decode_band(bt, y0, x0, one, cap=64)
        jax_got = decode_jax.rle_decode_band(
            bt.numpy(), y0.numpy(), x0.numpy(), one.numpy(), **walk_kw)
        want = dp_common.traceback_anchored_banded_packed(
            bt[0].numpy(), lbw, qlen, rlen)
    items = _items_from_rle(got[0][0].numpy(), int(got[1][0]))[::-1]
    assert items == want
    assert [event, 260] in items
    _same_as_jax(got, jax_got)


def test_inactive_and_unknown_starts_emit_nothing():
    bt = torch.zeros((3, 4, 5), dtype=torch.int8)
    bt[:, 3, 2] = dp_common.OP_MATCH
    bt[:, 2, 2] = dp_common.OP_MATCH
    y0 = torch.tensor([3, 3, 1], dtype=torch.int32)
    x0 = torch.tensor([2, 2, 2], dtype=torch.int32)
    active = torch.tensor([True, False, True])
    rle, n_ops = decode.rle_decode_band(bt, y0, x0, active, cap=4)
    assert n_ops.tolist() == [1, 0, 0]
    assert _items_from_rle(rle[0].numpy(), 1) == [["M", 2]]
    assert not rle[1:].any()


@pytest.mark.parametrize("garbage", [False, True],
                         ids=["zero_tail", "garbage_tail"])
def test_gather_rle_flat_matches_jax(garbage):
    """The flat items equal decode_jax's on zero-tailed items; the port's
    gather writes 0 past n_ops, so slots the card leaves unwritten there
    (non-zero garbage here) never reach the flat items."""
    rng = np.random.default_rng(8)
    cap = 16
    n_ops = rng.integers(0, cap + 1, 40).astype(np.int32)
    rle = rng.integers(1, 1 << 30, (40, cap)).astype(np.int32)
    rle[np.arange(cap)[None, :] >= n_ops[:, None]] = 0
    src = rng.permutation(40)[:25]
    t = np.sort(rng.choice([0, 8, 16], 25))
    t = np.maximum(t, np.minimum(n_ops[src], 8))
    order = np.argsort(t, kind="stable")
    src, t = src[order], t[order]
    total = int(t.sum())
    starts = np.concatenate([[0], np.cumsum(t)[:-1]])
    card = rle.copy()
    if garbage:
        tail = np.arange(cap)[None, :] >= n_ops[:, None]
        card[tail] = rng.integers(1, 1 << 30, int(tail.sum()))
    got = decode.gather_rle_flat(*_t(card, n_ops, src, t), total)
    # decode_jax pads to total_pad with one sentinel problem.
    total_pad = 1024
    src_aug = np.append(src, 0).astype(np.int32)
    t_aug = np.append(t, total_pad - total)
    starts_aug = np.append(starts, total)
    want = decode_jax.gather_rle_flat(rle, src_aug, t_aug, starts_aug,
                                      cap=cap, total_pad=total_pad)
    np.testing.assert_array_equal(np.asarray(want)[:total], got.numpy())
