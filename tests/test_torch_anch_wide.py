"""The anchored gap fill's wide route (csrc/anch_kernels.cu: a warp a
problem on a row wavefront, for the warps with a lane wider than 32
columns), built as C++ on the CPU.

tests/test_torch_csrc.py builds the kernels' host/device bodies with g++
(its C_LOOP) and runs the wide route's lane step, schedule and copies over
an emulated 32-lane warp (anch_wide, through run_anch).  Here it is held,
byte for byte (score and whole planes, prefilled with garbage, so every
byte must be written; integer arrays, tolerance zero):

  * to the plain PyTorch versions (sw_cuda.anchored_forward_reference,
    anchored_forward_banded_reference) in both layouts at live widths 33,
    63, 64, 65, 127 and 512 (banded planes of 64, 128 and 512 columns,
    full planes of RL + 1 = 65, 129 and 513), at RL 1,024 with live widths
    up to 600 (the staged engine's gap_fallback buckets), with queries
    that differ from their references by an indel at the band's edge or
    by substitutions alone, in warps that mix narrow and wide lanes, with
    lbw = 0, rbw = 0 and empty queries; the routing by warps of 32 as the
    kernels route them as well as every problem through the wide route;
  * to the Pallas kernels of yaha_tpu/ops/sw_pallas.py in interpret mode
    at live widths 33 to 127, and on the gap fills of 1 kb reads with one
    20-60 base insertion or deletion (torch_dp_cases.medium_indel_gaps,
    the medium-indel traffic chip_smoke.py phase 5 runs through the
    engine), whose bands put both layouts on the wide route at -BW 5.
"""
import numpy as np
import pytest
import torch

from test_torch_csrc import _anch_body, lib  # noqa: F401
from torch_dp_cases import KW, anchored_wide_inputs, medium_indel_gaps
from yaha_tpu_torch.ops import sw_cuda

# The wide route for every problem, and the kernels' routing by warps.
WIDE_ROUTES = [(0, 0, 0), (2, 0, 2)]


def _plain(args, full, w, kw):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if full:
        out = sw_cuda.anchored_forward_reference(*t, **kw)
    else:
        out = sw_cuda.anchored_forward_banded_reference(*t, wband=w, **kw)
        out["bt"] = out.pop("bt_b")
    return {k: v.numpy() for k, v in out.items()}


def _pallas(args, full, w, kw):
    """The Pallas kernel in interpret mode, N padded to a multiple of its
    tile with empty problems."""
    from yaha_tpu.ops import sw_pallas
    n = args[0].shape[0]
    pad = -n % sw_pallas.TILE
    padded = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
              for a in args]
    if full:
        out = sw_pallas.anchored_forward_pallas(*padded, interpret=True,
                                                **kw)
    else:
        out = sw_pallas.anchored_forward_pallas_banded(
            *padded, wband=w, interpret=True, **kw)
        out["bt"] = out.pop("bt_b")
    return {k: np.asarray(out[k])[:n] for k in ("score", "bt")}


def _live(args, full, w):
    q, qlens, r, rlens, lbw, rbw = args
    if full:
        return np.clip(rlens, 0, r.shape[1])
    return np.clip(lbw + rbw + 1, 0, w)


def _check(lib, args, full, w, want, kw=KW, routes=WIDE_ROUTES):
    for route in routes:
        got = _anch_body(lib, full, route, args, 0 if full else w, kw)
        for key in ("score", "bt"):
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg="route %s %s" % (route, key))


WIDE_LIVES = [33, 63, 64, 65, 127, 512]


@pytest.mark.parametrize("indel", [True, False], ids=["indel", "subst"])
@pytest.mark.parametrize("live", WIDE_LIVES)
@pytest.mark.parametrize("full", [False, True], ids=["banded", "full"])
def test_wide_route_matches_plain(lib, full, live, indel):
    """Every warp's lane 0 at the live width, its other lanes narrower;
    lbw = 0, rbw = 0 and empty queries in every warp."""
    args, w = anchored_wide_inputs(live + 1000 * indel, live, full,
                                   n=64 if live < 512 else 40,
                                   indel=indel)
    live_w = _live(args, full, w)
    assert live_w.max() == live and (live_w <= 32).any()
    assert (args[4] == 0).any() and (args[5] == 0).any()
    assert (args[1] == 0).any()
    _check(lib, args, full, w, _plain(args, full, w, KW))


@pytest.mark.parametrize("full", [False, True], ids=["banded", "full"])
def test_wide_route_beyond_512(lib, full):
    """Planes wider than MAX_WBAND (the engine's gap_fallback buckets, RL
    1,024; banded wband 1,024) at live widths up to 600, QL 34 rows."""
    args, w = anchored_wide_inputs(600, 600, full, n=32, ql=34, rl=1024)
    if not full:
        w = 1024
    assert _live(args, full, w).max() == 600 and w > 512
    _check(lib, args, full, w, _plain(args, full, w, KW))


@pytest.mark.parametrize("live", [33, 64, 127])
@pytest.mark.parametrize("full", [False, True], ids=["banded", "full"])
def test_wide_route_matches_pallas(lib, full, live):
    """The wide route and the plain version against the Pallas kernel in
    interpret mode."""
    args, w = anchored_wide_inputs(live + 7, live, full, n=64)
    want = _pallas(args, full, w, KW)
    got = _plain(args, full, w, KW)
    for key in ("score", "bt"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    _check(lib, args, full, w, want)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("full", [False, True], ids=["banded", "full"])
def test_medium_indel_gaps_match_pallas(lib, full, seed):
    """The gap fills of 1 kb reads with one 20-60 base indel at -BW 5:
    banded where len_diff + 11 < r_gap, else unbanded over full width; a
    quarter to all of them are wider than 32 columns.  Plain version, wide
    route and the kernels' routing all equal the Pallas kernel."""
    args, w = medium_indel_gaps(seed)["full" if full else "banded"]
    assert (_live(args, full, w) > 32).mean() >= 0.25
    want = _pallas(args, full, w, KW)
    got = _plain(args, full, w, KW)
    for key in ("score", "bt"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    _check(lib, args, full, w, want)
