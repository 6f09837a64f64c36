"""Device backtrack walk of the staged engine: packed planes in, run-length
items out, so the planes never leave the card.

Counterpart of yaha_tpu/ops/decode_jax.py:

  rle_decode_band   band-layout planes (extension, band-relative gap fill)
  rle_decode_full   full-layout planes (full-width gap fill)
  gather_rle_flat   one ragged gather of the items into a flat array, so a
                    bucket's items leave the device in one transfer

The two decodes call rle_walk: on a CUDA tensor the kernel of
csrc/decode_kernels.cu (a team of lanes per problem, walking from windows
of the plane in shared memory), on a CPU tensor its plain version,
rle_walk_reference (vectorised over problems, one plane cell per step
until every walk has ended).  Both walk as the native packed-plane
walkers do (ops/dp_common.py traceback_*_packed) and emit int32 items
op << 28 | len in walk order, unreversed, with n_ops per problem: 0 for an inactive walk or one that starts on OP_UNKNOWN, -1 for a
walk that needs more than `cap` items (its first cap items are kept).  On
the card, item slots past min(n_ops, cap) are left as they were allocated
(uninitialised); the plain version leaves them 0, and gather_rle_flat
writes 0 there, so the flat items equal decode_jax's.  The JAX decode's
jump plane, 255-cell jump cap, time-major buffer and slice plan are TPU
workarounds and have no counterpart.
"""
from __future__ import annotations

import torch

from .dp_common import BT_CD, BT_CF, OP_DELETE, OP_INSERT, OP_UNKNOWN

from . import sw_cuda

RLE_OP_SHIFT = 28
RLE_LEN_MASK = (1 << RLE_OP_SHIFT) - 1

I32 = torch.int32

# The kernel's team sizes (lanes per problem) and the default, and its
# window of plane bytes in shared memory (two per team, four teams a
# block): about WINDOW_ROWS plane rows, within [WINDOW_MIN, WINDOW_MAX]
# bytes.  Only rows wider than 512 bytes (full-width gap planes of the
# gap_fallback class, which none of chip_smoke.py's read sets produced)
# get fewer rows a window, and rows wider than WINDOW_MAX less than one.
WALK_TEAMS = (8, 16, 32)
WALK_TEAM = 32
WINDOW_MIN, WINDOW_MAX = 512, 16384
WINDOW_ROWS = 32


def window_bytes(w, full):
    """The window for planes of width w: the power of two at or above
    WINDOW_ROWS steps up the plane (a full layout's match step moves one
    row up and one column left), clamped to [WINDOW_MIN, WINDOW_MAX]."""
    want = WINDOW_ROWS * (w + 1 if full else w)
    return min(max(1 << (want - 1).bit_length(), WINDOW_MIN), WINDOW_MAX)


def rle_walk_reference(bt, y0, x0, active, *, cap, full):
    """Plain version of rle_walk.  A delete run is taken one cell per step
    while BT_CD says it continues left, an insert run while BT_CF says it
    continues up its chain; the runs and their merging are those of the
    native walker, which chases each run in one step."""
    n, h, w = bt.shape
    dev = bt.device
    flat = bt.reshape(n, h * w)
    y = y0.to(device=dev, dtype=torch.int64).clone()
    x = x0.to(device=dev, dtype=torch.int64).clone()
    live = active.to(device=dev, dtype=torch.bool).clone()
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    prev, run, cnt = zero.clone(), zero.clone(), zero.clone()
    d_cont = torch.zeros(n, dtype=torch.bool, device=dev)
    i_cont = d_cont.clone()
    rle = torch.zeros((n, cap), dtype=I32, device=dev)
    rows = torch.arange(n, device=dev)

    def emit(mask):
        put = mask & (cnt < cap)
        item = ((prev << RLE_OP_SHIFT) | (run & RLE_LEN_MASK)).to(I32)
        rle[rows[put], cnt[put]] = item[put]
        cnt.add_(mask.to(torch.int64))

    while bool(live.any()):
        inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        idx = (y.clamp(0, h - 1) * w + x.clamp(0, w - 1))[:, None]
        cell = flat.gather(1, idx)[:, 0].to(torch.int64) & 0xFF
        b = torch.where(inside, cell, 0)
        code = torch.where(d_cont, OP_DELETE,
                           torch.where(i_cont, OP_INSERT, b & 7))
        end = live & (code == OP_UNKNOWN)
        step = live & ~end
        change = step & (code != prev)
        emit((change | end) & (prev != OP_UNKNOWN))
        run = torch.where(change, 1, torch.where(step, run + 1, run))
        prev = torch.where(step, code, prev)
        is_d = step & (code == OP_DELETE)
        is_i = step & (code == OP_INSERT)
        is_mr = step & ~is_d & ~is_i
        y = y - (is_i | is_mr).to(torch.int64)
        if full:
            x = x - (is_d | is_mr).to(torch.int64)
        else:
            x = x - is_d.to(torch.int64) + is_i.to(torch.int64)
        d_cont = is_d & ((b & BT_CD) != 0)
        i_cont = is_i & ((b & BT_CF) != 0)
        live = live & ~end
    n_ops = torch.where(cnt > cap, -1, cnt).to(I32)
    return rle, n_ops


def rle_walk(bt, y0, x0, active, *, cap, full, team=WALK_TEAM):
    """Walk each problem's packed plane bt[p] ([N, H, W] int8) from
    (y0[p], x0[p]) where active[p]; returns (rle [N, cap] int32,
    n_ops [N] int32).  full selects the full layout, else the band one.
    On the card `team` is the kernel's lanes per problem; every team size
    returns the same n_ops and the same items in slots
    [0, min(n_ops, cap))."""
    if bt.device.type == "cpu":
        return rle_walk_reference(bt, y0, x0, active, cap=cap, full=full)
    name = "rle_walk"
    if bt.device.type != "cuda":
        raise ValueError("%s: tensors on %s are not supported (cpu or "
                         "cuda)" % (name, bt.device))
    if bt.dtype != torch.int8 or bt.dim() != 3 or not bt.is_contiguous():
        raise ValueError("%s: bt must be a contiguous 3-D int8 tensor"
                         % name)
    n, h, w = bt.shape
    if team not in WALK_TEAMS:
        raise ValueError("%s: teams of %s lanes are not supported (%s)"
                         % (name, team, WALK_TEAMS))
    y0, x0 = (t.to(device=bt.device, dtype=I32).contiguous()
              for t in (y0, x0))
    active = active.to(device=bt.device, dtype=torch.uint8).contiguous()
    for t in (y0, x0, active):
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError("%s: per-problem arrays must be [N]" % name)
    rle = torch.empty((n, cap), dtype=I32, device=bt.device)
    n_ops = torch.empty(n, dtype=I32, device=bt.device)
    if n:
        from . import _build
        sw_cuda._launched(name, _build.load().yt_rle_walk(
            bt.data_ptr(), n, h, w, y0.data_ptr(), x0.data_ptr(),
            active.data_ptr(), cap, 1 if full else 0, rle.data_ptr(),
            n_ops.data_ptr(), team, window_bytes(w, full),
            sw_cuda._stream(bt.device)))
    return rle, n_ops


def rle_decode_band(bt, y0, x0, active, *, cap):
    """Band layout: match/replace (y-1, x), delete (y, x-1), insert
    (y-1, x+1) (decode_jax.rle_decode_band)."""
    return rle_walk(bt, y0, x0, active, cap=cap, full=False)


def rle_decode_full(bt, y0, x0, active, *, cap):
    """Full layout: match/replace (y-1, x-1), delete (y, x-1), insert
    (y-1, x) (decode_jax.rle_decode_full)."""
    return rle_walk(bt, y0, x0, active, cap=cap, full=True)


def gather_rle_flat(rle, n_ops, src, t, total):
    """flat[starts[k] + i] = rle[src[k], i] for i < t[k], with starts the
    exclusive cumulative sum of t and total = sum(t), and 0 for the slots
    at or past n_ops[src[k]] (n_ops >= 0): one ragged gather of the slots
    of problems src (decode_jax.gather_rle_flat on zero-tailed items,
    unpadded)."""
    src = src.to(device=rle.device, dtype=torch.int64)
    t = t.to(device=rle.device, dtype=torch.int64)
    starts = torch.cumsum(t, 0) - t
    rows = torch.repeat_interleave(src, t, output_size=total)
    cols = (torch.arange(total, device=rle.device) -
            torch.repeat_interleave(starts, t, output_size=total))
    keep = cols < n_ops.to(device=rle.device, dtype=torch.int64)[rows]
    return torch.where(keep, rle[rows, cols], 0)
