"""Profile of the backtrack walk (ops/decode.rle_walk) at a hot tier shape.

Counterpart of tools/decode_profile.py.  The reference splits its JAX
decode into the jump-plane precompute, the walk loop and the sort
compaction; those are TPU workarounds the port does not have (the walk
kernel, csrc/decode_kernels.cu rle_walk_window<T>, follows each run from
windows of the plane in shared memory).  So this profile splits what the
port's walk does have:

  team     lanes per problem, each of decode.WALK_TEAMS (8, 16, 32);
  order    the problems as the driver hands them ("unsorted") or sorted
           by their walk bound ("sorted": maxi for an extension, qlen +
           rlen for a full-layout gap fill), which groups short walks
           into the same warps;
  layout   band planes (extensions, -BW 5: W 21) and full planes (gap
           fills).

Each configuration is timed with CUDA events over `reps` distinct inputs
(each the planes rolled along the problem axis by 257 k), and its median
and least ms are printed beside the walk's bound: the plane bytes it
visits (a byte per cell of run length, plus the cell that ends each
walk), 4 bytes per stored item, its per-problem inputs and n_ops, over
the memory rate, or its steps' int32 operations over the int32 rate, the
larger.  Every team and both orders must give the same n_ops and the
same items in slots [0, min(n_ops, cap)).  It changes no default.

  python -m yaha_tpu_torch.tools.decode_profile [--n 16384] [--ql 1024]
      [--reps 5] [--device cuda|cpu]

builds extension planes with sw_cuda.extension_forward at -BW 5 on
problems made as the reference's tool makes them (5 % substitutions, half
of the references random: X-drop exits after a few rows) and full planes
with sw_cuda.anchored_forward on n gap problems of 64 x 64.  On the CPU
the plain walk runs once a layout and order, untimed.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import decode, sw_cuda
from ..ops.decode import RLE_LEN_MASK

# One H100 SXM: memory rate, and int32 lanes x SMs x boost clock.
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 64 * 132 * 1.98e9
WALK_STEP_OPS = 8        # one walk step: load, mask, compare, move, merge
EXT_KW = dict(band_width=5, go=5, ge=2, rc=3, ms=1, max_gap=50,
              max_intron=50, x_cutoff=25)
GAP_KW = dict(go=5, ge=2, rc=3, ms=1, max_gap=50, max_intron=50)


def _pow2(x, lo=32):
    return max(lo, 1 << (int(x) - 1).bit_length())


def items_below(rle, n_ops, cap):
    """The items in slots [0, min(n_ops, cap)), 0 elsewhere."""
    live = torch.where(n_ops < 0, cap, n_ops).clamp(max=cap)
    keep = torch.arange(cap, device=rle.device)[None, :] < live[:, None]
    return torch.where(keep, rle, 0)


def walk_work(rle, n_ops, cap, inputs):
    """(bytes, steps) of one walk launch (chip_smoke.py _walk_work)."""
    items = items_below(rle, n_ops, cap)
    steps = int((items & RLE_LEN_MASK).sum()) + int((n_ops > 0).sum())
    stored = int(torch.where(n_ops < 0, cap, n_ops).sum())
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    return steps + 4 * stored + nbytes + 4 * n_ops.numel(), steps


def band_planes(q, qlens, r, rlens, **kw):
    """The walk's inputs over extension planes, as the staged driver wires
    them: (bt, maxi, maxj, score > 0, cap)."""
    out = sw_cuda.extension_forward(q, qlens, r, rlens, **kw)
    w = out["bt"].shape[2]
    cap = _pow2(2 * q.shape[1] + w + 2, 32)
    return out["bt"], out["maxi"], out["maxj"], out["score"] > 0, cap


def full_planes(q, qlens, r, rlens, lbw, rbw, **kw):
    """The walk's inputs over full-layout gap planes: (bt, qlens, rlens,
    all active, cap)."""
    out = sw_cuda.anchored_forward(q, qlens, r, rlens, lbw, rbw, **kw)
    cap = _pow2(q.shape[1] + r.shape[1] + 2, 32)
    return (out["bt"], qlens.to(torch.int32), rlens.to(torch.int32),
            torch.ones(q.shape[0], dtype=torch.bool, device=q.device), cap)


def synthetic_problems(n, ql, device, seed=3, err=0.05, junk=0.5):
    """Extension problems as the reference's tool draws them: q random,
    r = q at `err` substitutions, a `junk` share of references random."""
    rng = np.random.default_rng(seed)
    bw2 = 10
    q = rng.integers(0, 4, (n, ql)).astype(np.uint8)
    rl = ql + 2 * bw2
    r = np.zeros((n, rl), np.uint8)
    r[:, :ql] = q
    m = rng.random((n, ql)) < err
    r[:, :ql][m] = rng.integers(0, 4, int(m.sum()))
    bad = rng.random(n) < junk
    r[bad] = rng.integers(0, 4, (int(bad.sum()), rl)).astype(np.uint8)
    qlens = np.full(n, ql, np.int32)
    rlens = qlens + bw2
    return [torch.from_numpy(a).to(device) for a in (q, qlens, r, rlens)]


def synthetic_gaps(n, g, device, seed=4, err=0.05):
    """Gap problems of up to g x g: lengths g/2 to g, r = q at `err`
    substitutions, both bands the full width."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (n, g)).astype(np.uint8)
    r = q.copy()
    m = rng.random((n, g)) < err
    r[m] = rng.integers(0, 4, int(m.sum()))
    qlens = rng.integers(g // 2, g + 1, n).astype(np.int32)
    rlens = np.clip(qlens + rng.integers(-2, 3, n), 1, g).astype(np.int32)
    bw = np.full(n, g, np.int32)
    return [torch.from_numpy(a).to(device)
            for a in (q, qlens, r, rlens, bw, bw)]


def _order(layout, y0, x0, active):
    """The walk-bound order of the problems (ascending, stable)."""
    bound = (y0.to(torch.int64) if layout == "band" else
             y0.to(torch.int64) + x0.to(torch.int64))
    bound = torch.where(active, bound, 0)
    return torch.sort(bound, stable=True).indices


def profile(planes, teams=decode.WALK_TEAMS, reps=5):
    """planes: {layout: (bt, y0, x0, active, cap)} with layout "band" or
    "full".  Returns the report: for each layout the shape, plane bytes,
    walk bytes and steps, bound, and ms by order and team (on a card),
    after checking that every team and both orders agree."""
    report = {}
    for layout, (bt, y0, x0, active, cap) in planes.items():
        full = layout == "full"
        dev = bt.device
        n = bt.shape[0]
        order = _order(layout, y0, x0, active)
        base = {"unsorted": (bt, y0, x0, active),
                "sorted": tuple(t.index_select(0, order).contiguous()
                                for t in (bt, y0, x0, active))}
        ref = decode.rle_walk(bt, y0, x0, active, cap=cap, full=full)
        nbytes, steps = walk_work(*ref, cap, (y0, x0, active))
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = steps * WALK_STEP_OPS / INT32_OPS_S * 1e3
        row = {"shape": list(bt.shape), "cap": cap,
               "plane_bytes": bt.numel(), "walk_bytes": nbytes,
               "walk_steps": steps,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        want = (ref[1], items_below(*ref, cap))
        runs = [(o, t) for o in ("unsorted", "sorted")
                for t in (teams if dev.type == "cuda" else (None,))]
        for o, team in runs:
            kw = {} if team is None else {"team": team}
            got = decode.rle_walk(*base[o], cap=cap, full=full, **kw)
            if o == "sorted":
                back = torch.empty_like(order)
                back[order] = torch.arange(n, device=dev)
                got = tuple(t.index_select(0, back) for t in got)
            if not (torch.equal(got[1], want[0]) and
                    torch.equal(items_below(*got, cap), want[1])):
                raise AssertionError(
                    "decode_profile %s: %s order, team %s: n_ops or items "
                    "differ from the default walk's" % (layout, o, team))
        row["teams_equal"] = True
        if dev.type == "cuda":
            for o in ("unsorted", "sorted"):
                sets = [tuple(torch.roll(t, (k * 257) % n, 0)
                              for t in base[o]) for k in range(reps)]
                for team in teams:
                    decode.rle_walk(*sets[0], cap=cap, full=full, team=team)
                    ms = []
                    for s in sets:
                        torch.cuda.synchronize(dev)
                        e0 = torch.cuda.Event(enable_timing=True)
                        e1 = torch.cuda.Event(enable_timing=True)
                        e0.record()
                        decode.rle_walk(*s, cap=cap, full=full, team=team)
                        e1.record()
                        torch.cuda.synchronize(dev)
                        ms.append(e0.elapsed_time(e1))
                    ms.sort()
                    row["%s_team%d_ms" % (o, team)] = {
                        "med": ms[len(ms) // 2], "min": ms[0]}
                del sets
        report[layout] = row
    return report


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Time the backtrack walk by "
                                 "team, order and layout.")
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--ql", type=int, default=1024)
    ap.add_argument("--gap", type=int, default=64,
                    help="side of the full-layout gap problems")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("decode_profile: no CUDA device; use --device "
                           "cpu")
    planes = {
        "band": band_planes(*synthetic_problems(args.n, args.ql, dev),
                            **EXT_KW),
        "full": full_planes(*synthetic_gaps(args.n, args.gap, dev),
                            **GAP_KW)}
    print(json.dumps({"n": args.n, "ql": args.ql,
                      "layouts": profile(planes, reps=args.reps)}))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
