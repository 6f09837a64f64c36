"""Batched fragment-chain DP on the device: a CUDA kernel + its plain version.

Counterpart of yaha_tpu/ops/chain_jax.py (batched_chain_dp, :38), the
device analog of buildBestClumpFromFragmentRange (GraphPath.cpp:161-270):
B independent fragment ranges, padded to N nodes, relax in lockstep.  The
outer loop over left nodes i is sequential (node i's score is final once
every earlier node has relaxed it); for a fixed i every right node j > i
relaxes independently.

The contract is chain_jax's:

  * sqo, eqo, diag, length: [B, N] int32, valid: [B, N] bool;
  * the caller re-bases each problem's diag by its region minimum, diag'
    = (diag - min) mod 2^32 (small, since a region is a run of fragments
    whose successive diagonals differ by at most maxGap,
    QueryMatch.c:146-158): every comparison and difference is unchanged;
  * nodes arrive sorted ascending by (SQO, diag); rows with valid=False
    never relax and never win the fold;
  * the SINT stores wrap to int16: length, length * m_score and every
    stored best score; the candidate score newScore is compared unwrapped
    (GraphPath.cpp:230);
  * equal scores go through the tie cascade against the stored edge
    (GraphPath.cpp:239-251): smaller diagonal gap, then smaller query gap,
    then the greater pathSQO;
  * the best node is folded in ascending order (GraphPath.cpp:259-266):
    the higher score, then the lower EQO, then the greater pathSQO; on a
    full tie the earlier index stays (the fold replaces only on a strict
    win, as chain_jax and the native yt_chain_dp do);
  * int32 arithmetic wraps as in JAX.

Returns best [B] (-1 when a row has no valid node), best_score [B]
(-0x7FFFFF00 then), prev [B, N] and path_sqo [B, N], all int32.

batched_chain_dp takes its device from the input tensors: on a CUDA
tensor it launches chain_dp_kernel (csrc/chain_kernels.cu) and raises if
the launch fails; on a CPU tensor it runs batched_chain_dp_ref, a Python
loop over i with [B, N]-wide tensor work, step for step as chain_jax.
The JAX package wires the chain DP into no engine (its one caller is
tests/test_chain_jax.py), and neither does the port: chip_smoke.py drives
it on the card.
"""
from __future__ import annotations

import torch

from . import sw_cuda

I32 = torch.int32
NO_SCORE = -0x7FFFFF00
# Most nodes a problem may have on the card: a block of 512 threads keeps
# 8 nodes a thread in registers (csrc/chain_kernels.cu chain_team).
MAX_NODES = 4096


def _wrap_i16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def batched_chain_dp_ref(sqo, eqo, diag, length, valid, *, max_gap,
                         max_desert, m_score, go_cost, ge_cost):
    """Plain version of batched_chain_dp (chain_jax.batched_chain_dp)."""
    sqo, eqo, diag, length = (t.to(I32) for t in (sqo, eqo, diag, length))
    valid = valid.to(torch.bool)
    b, n = sqo.shape
    dev = sqo.device
    sro = diag + sqo
    ero = diag + eqo
    length_w = _wrap_i16(length)
    best_score = _wrap_i16(length_w * m_score)
    prev = torch.full((b, n), -1, dtype=I32, device=dev)
    path_len = torch.ones((b, n), dtype=I32, device=dev)
    path_sqo = sqo.clone()
    prev_dd = torch.zeros((b, n), dtype=I32, device=dev)
    prev_qg = torch.zeros_like(prev_dd)
    prev_psqo = torch.zeros_like(prev_dd)
    j_idx = torch.arange(n, device=dev)[None, :]
    zero = torch.zeros((), dtype=I32, device=dev)
    for i in range(n - 1):
        s = slice(i, i + 1)
        sqo_i, eqo_i, diag_i = sqo[:, s], eqo[:, s], diag[:, s]
        sro_i, ero_i = sro[:, s], ero[:, s]
        sc_i, plen_i, psqo_i = (best_score[:, s], path_len[:, s],
                                path_sqo[:, s])
        cand = valid & valid[:, s] & (j_idx > i) & (sqo > sqo_i)
        diag_gap = torch.abs(diag - diag_i)
        cand &= diag_gap <= max_gap
        cand &= sro > sro_i
        q_gap = torch.maximum(sqo - eqo_i - 1, zero)
        r_gap = torch.maximum(sro - ero_i - 1, zero)
        cand &= torch.minimum(q_gap, r_gap) <= max_desert
        q_ov = torch.maximum(eqo_i - sqo + 1, zero)
        r_ov = torch.maximum(ero_i - sro + 1, zero)
        newbases = length_w - torch.maximum(q_ov, r_ov)
        cand &= newbases >= 1
        gap_cost = torch.where(diag_gap > 0, -(go_cost + diag_gap * ge_cost),
                               zero)
        # `int newScore` (GraphPath.cpp:230): compared unwrapped.
        new_score = sc_i + newbases * m_score + gap_cost
        better = new_score > best_score
        equal = new_score == best_score
        diag_cmp = diag_gap - prev_dd
        gap_cmp = q_gap - prev_qg
        tie_win = (prev >= 0) & (
            (diag_cmp < 0) |
            ((diag_cmp == 0) & ((gap_cmp < 0) |
                                ((gap_cmp == 0) & (psqo_i > prev_psqo)))))
        accept = cand & (better | (equal & tie_win))
        best_score = torch.where(accept, _wrap_i16(new_score), best_score)
        prev = torch.where(accept, torch.full_like(prev, i), prev)
        path_len = torch.where(accept, plen_i + 1, path_len)
        path_sqo = torch.where(accept, psqo_i, path_sqo)
        prev_dd = torch.where(accept, diag_gap, prev_dd)
        prev_qg = torch.where(accept, q_gap, prev_qg)
        prev_psqo = torch.where(accept, psqo_i, prev_psqo)

    best = torch.full((b,), -1, dtype=I32, device=dev)
    best_sc = torch.full((b,), NO_SCORE, dtype=I32, device=dev)
    best_eqo = torch.zeros((b,), dtype=I32, device=dev)
    best_psqo = torch.zeros((b,), dtype=I32, device=dev)
    for i in range(n):
        sc, e, ps = best_score[:, i], eqo[:, i], path_sqo[:, i]
        win = valid[:, i] & ((best < 0) | (sc > best_sc) | (
            (sc == best_sc) & torch.where(e != best_eqo, e < best_eqo,
                                          ps > best_psqo)))
        best = torch.where(win, torch.full_like(best, i), best)
        best_sc = torch.where(win, sc, best_sc)
        best_eqo = torch.where(win, e, best_eqo)
        best_psqo = torch.where(win, ps, best_psqo)
    return {"best": best, "best_score": best_sc, "prev": prev,
            "path_sqo": path_sqo}


def batched_chain_dp(sqo, eqo, diag, length, valid, *, max_gap, max_desert,
                     m_score, go_cost, ge_cost):
    """Chain DP over B problems of up to N nodes (the module docstring has
    the contract).  On a CUDA tensor N may be at most MAX_NODES."""
    kw = dict(max_gap=max_gap, max_desert=max_desert, m_score=m_score,
              go_cost=go_cost, ge_cost=ge_cost)
    if sqo.device.type == "cpu":
        return batched_chain_dp_ref(sqo, eqo, diag, length, valid, **kw)
    name = "chain_dp"
    dev = sqo.device
    if dev.type != "cuda":
        raise ValueError("%s: tensors on %s are not supported (cpu or cuda)"
                         % (name, dev))
    ins = []
    for label, t in (("sqo", sqo), ("eqo", eqo), ("diag", diag),
                     ("length", length), ("valid", valid)):
        if t.dim() != 2 or t.shape != sqo.shape or t.device != dev:
            raise ValueError("%s: %s must be [B, N] on %s like sqo"
                             % (name, label, dev))
        ins.append(t.to(torch.uint8 if label == "valid" else I32)
                   .contiguous())
    b, n = sqo.shape
    if n > MAX_NODES:
        raise ValueError("%s: N = %d nodes, at most %d on the card"
                         % (name, n, MAX_NODES))
    best, best_score = torch.empty((2, b), dtype=I32, device=dev)
    prev, path_sqo = torch.empty((2, b, n), dtype=I32, device=dev)
    if b and n:
        from . import _build
        sw_cuda._launched(name, _build.load().yt_chain_dp_cuda(
            *(t.data_ptr() for t in ins), b, n, max_gap, max_desert,
            m_score, go_cost, ge_cost, best.data_ptr(),
            best_score.data_ptr(), prev.data_ptr(), path_sqo.data_ptr(),
            sw_cuda._stream(dev)))
    elif b:
        best.fill_(-1)
        best_score.fill_(NO_SCORE)
    return {"best": best, "best_score": best_score, "prev": prev,
            "path_sqo": path_sqo}
