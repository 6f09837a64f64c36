"""The port's CUDA kernels and engine on the card (marker `cuda`).

Every test here needs an NVIDIA GPU and skips without one.  The kernels
(the extension kernels, at each block size of the register one, the wide
one also at W = 1, 37 and 65 with indel inputs, the block one past -BW
707 up to its widest band, -BW 3,566; both
anchored kernels, on warps of every width class and wider ones, whose
problems take the wide route, at live widths 33 to 600, on planes up to
1,025 columns and on the medium-indel gap fills) are held
to their plain PyTorch versions on the card, on the inputs with
which tests/test_torch_sw.py, test_torch_gather.py and test_torch_decode.py
hold the plain versions to the JAX package: every output equal, whole
backtrack planes, assembled problem planes and walk items included
(integer arrays, tolerance zero).  The walk kernel, at each team size, is held
to its plain version on the items up to n_ops, the only slots it writes.
Both seed kernels are held to their plain versions on the seed rows of the
golden index at capacities 64 to 16,384 (both tiers), on the
unsigned-order, sentinel and wrapped-run edges, on 650-hit runs across C
in rows of three expansion batches, on row totals around every sort size,
and on hash rows whose 16-window runs cross row ends, at two alignments
(tests/test_torch_seeds.py holds the plain versions to the JAX
package); the expansion also on each shard of 2 and 4 of the index
(parallel/mesh.ShardedIndex), and the merge of the shards' rows
(merge_sorted_runs) on them and on random sorted runs of 1 to 8 shards up
to the 1 kb batch's [2, 32,768, 1,024] and [4, 32,768, 1,024].  The
chain DP kernel is held to its plain
version on the ranges of tests/test_chain_jax.py, on ranges dense in equal scores, on the edge
ranges, at every team shape (N = 20 to 4,096 nodes) and on ranges whose
candidate DAG is one path through every node.  The lockstep
twins of ops/sw_batch.py on the card are held to the same functions on
the CPU, array for array.  The engine is held to the
native C++ engine, SAM bytes equal, in its default configuration (device
assembly + device walk) and in the A/B one, with the device seeder, and
with the "torch" backend, on the long-gap reads at -G 3,600 (their RL
4,096 gap buckets on the lockstep twin) and with the seeder on (1 x 2) and
(2 x 2) grids of the card.  The index builder's passes on the card
(index/build.py) are held to its run on the CPU, array for array, on
tests/torch_dp_cases.index_genome's genomes, and write the golden
down-sampled index byte for byte.  Neither jax nor tests/conftest.py is
needed, so on a machine with a card run them from the repository root
with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from torch_dp_cases import (ANCH_SWEEP, ANCH_SWEEP_IDS, CHAIN_KW,
                            CHAIN_TIE_KW, EXT_SWEEP,
                            EXT_SWEEP_IDS, HASH_SHAPE_IDS, HASH_SHAPES,
                            INDEX_CASE_IDS, INDEX_CASES, KW,
                            KW_WRAP, SEED_CASES, WIDE_SWEEP, WIDE_SWEEP_IDS,
                            anchored_edge_inputs,
                            anchored_inputs,
                            anchored_sweep_inputs, anchored_wide_inputs,
                            chain_case, chain_edge_case, chain_path_case,
                            chain_tie_case,
                            extension_inputs,
                            gather_aligned_coords,
                            index_genome, gather_case,
                            gather_clamp_coords, gather_coords, hash_rows,
                            indel_extension_inputs, indel_reads,
                            long_gap_reads, long_run_inputs,
                            medium_indel_gaps, read_rows, seed_case,
                            seed_rows)
from yaha_tpu_torch.ops import (chain, decode, gather_dp, seeds, sw_batch,
                                sw_cuda)

pytestmark = pytest.mark.cuda

TESTS = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(TESTS, "data")
GOLD = os.path.join(TESTS, "golden")
INDEX = "testgen.X11_01_65525S"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _up(dev, *arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]


def _equal(got, want):
    torch.cuda.synchronize()
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert torch.equal(got[key], w), key


# The extension's two kernels (sw_cuda.ext_variant picks one by band
# width; both are held to the plain version at the register kernel's
# widths) and the register kernel's block sizes.
EXT_KERNELS = [("reg", 32), ("reg", 64), ("reg", 128), ("wide", 64)]
EXT_KERNEL_IDS = ["reg32", "reg64", "reg128", "wide"]


@pytest.mark.parametrize("variant,block", EXT_KERNELS, ids=EXT_KERNEL_IDS)
@pytest.mark.parametrize("kw", [KW, KW_WRAP], ids=["default", "wrap"])
def test_extension_kernel_matches_plain(dev, kw, variant, block):
    # N = 1000 is not a multiple of the block size.
    args = _up(dev, *extension_inputs(11, 1000, 40, 2))
    ekw = dict(band_width=2, x_cutoff=25, **kw)
    _equal(sw_cuda.extension_forward(*args, variant=variant, block=block,
                                     **ekw),
           sw_cuda.extension_forward_reference(*args, **ekw))


def test_span_brackets_its_kernel_on_the_trace(dev, tmp_path):
    """A recorder span around a kernel launch followed by
    torch.cuda.synchronize() brackets that kernel in the --trace file to
    within 0.5 ms: the spans are placed on the profiler's clock by the
    recorder's anchor (utils/timing.device_trace)."""
    import json
    from yaha_tpu_torch.utils.timing import device_trace, span
    args = _up(dev, *extension_inputs(11, 16384, 200, 2))
    ekw = dict(KW, band_width=2, x_cutoff=25)
    sw_cuda.extension_forward(*args, **ekw)      # built and warm
    torch.cuda.synchronize()
    with device_trace(str(tmp_path), dev):
        with span("probe"):
            sw_cuda.extension_forward(*args, **ekw)
            torch.cuda.synchronize()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    probe = next(e for e in events
                 if e.get("cat") == "yaha" and e["name"] == "probe")
    kernels = [e for e in events
               if e.get("cat") == "kernel" and "ext_" in e["name"]]
    assert kernels
    for k in kernels:
        assert k["ts"] >= probe["ts"] - 500.0
        assert k["ts"] + k["dur"] <= probe["ts"] + probe["dur"] + 500.0
    print("span bracket: probe [%.1f, %.1f] us, kernels %s" % (
        probe["ts"], probe["ts"] + probe["dur"],
        [(round(k["ts"], 1), round(k["ts"] + k["dur"], 1))
         for k in kernels]))


@pytest.mark.parametrize("variant", ["reg", "wide"])
@pytest.mark.parametrize("bw,xc,mg,mi,err", EXT_SWEEP, ids=EXT_SWEEP_IDS)
def test_extension_kernel_matches_plain_sweep(dev, bw, xc, mg, mi, err,
                                              variant):
    args = _up(dev, *extension_inputs(bw * 100 + xc, 300, 24, bw, err))
    kw = dict(KW, band_width=bw, x_cutoff=xc, max_gap=mg, max_intron=mi)
    _equal(sw_cuda.extension_forward(*args, variant=variant, **kw),
           sw_cuda.extension_forward_reference(*args, **kw))


@pytest.mark.parametrize("indel", [False, True], ids=["subst", "indel"])
@pytest.mark.parametrize("bw,xc,mg,mi,err", WIDE_SWEEP, ids=WIDE_SWEEP_IDS)
def test_wide_extension_kernel_matches_plain(dev, bw, xc, mg, mi, err,
                                             indel):
    """The wide kernel at the widths it serves (W = 1, 37, 65), on the
    inputs of test_torch_sw.py's wide sweep."""
    seed = bw * 100 + xc
    if indel:
        arrs = indel_extension_inputs(seed, 300, 64, bw, min(err, 0.05))
    else:
        arrs = extension_inputs(seed, 300, 24, bw, err)
    args = _up(dev, *arrs)
    kw = dict(KW, band_width=bw, x_cutoff=xc, max_gap=mg, max_intron=mi)
    _equal(sw_cuda.extension_forward(*args, variant="wide", **kw),
           sw_cuda.extension_forward_reference(*args, **kw))


@pytest.mark.parametrize("indel", [False, True], ids=["subst", "indel"])
@pytest.mark.parametrize("bw", [708, 3566])
def test_block_extension_kernel_matches_plain(dev, bw, indel):
    """Past W 2,829 the wide kernel's strip stages do not fit a block's
    shared memory and the block kernel (a strip a warp) serves, up to
    -BW 3,566 (W 14,265, past the first version's 12,905); every byte of
    the plane equals the plain version's.  QL 40 is two strips; the plain
    version (a PyTorch op a cell column) runs on the CPU, where its small
    ops cost less than a launch each."""
    if indel:
        arrs = indel_extension_inputs(bw, 16, 40, bw)
    else:
        arrs = extension_inputs(bw, 16, 40, bw, 0.15)
    kw = dict(KW, band_width=bw, x_cutoff=25)
    sw_cuda.reset_launches()
    got = sw_cuda.extension_forward(*_up(dev, *arrs), **kw)
    assert sw_cuda.launches()["extension_forward_block"] == 1
    want = sw_cuda.extension_forward_reference(
        *(torch.from_numpy(a) for a in arrs), **kw)
    _equal({k: v.cpu() for k, v in got.items()}, want)


@pytest.mark.parametrize("bw", [0, 1, 8, 9, 16])
def test_extension_dispatch_by_band_width(dev, bw):
    """-BW 1 and 8 (W = 5, 33) launch the register kernel, -BW 0, 9 and 16
    (W = 1, 37, 65) the wide kernel; references shorter than qlen + 2*bw2
    included."""
    q, qlens, r, rlens = extension_inputs(bw, 700, 48, bw, 0.1)
    rlens = np.random.default_rng(bw).integers(1, rlens + 1)
    args = _up(dev, q, qlens, r, rlens)
    kw = dict(KW, band_width=bw, x_cutoff=25)
    sw_cuda.reset_launches()
    got = sw_cuda.extension_forward(*args, **kw)
    name = ("extension_forward" if 1 <= bw <= 8 else
            "extension_forward_wide")
    assert {k: v for k, v in sw_cuda.launches().items() if v} == {name: 1}
    _equal(got, sw_cuda.extension_forward_reference(*args, **kw))


def _anchored_pair(dev, args, kw, wband=None):
    """Both anchored kernels against their plain versions, each launch
    counted once."""
    args = _up(dev, *args)
    wband = wband or int((args[4] + args[5]).max()) + 1
    sw_cuda.reset_launches()
    _equal(sw_cuda.anchored_forward(*args, **kw),
           sw_cuda.anchored_forward_reference(*args, **kw))
    _equal(sw_cuda.anchored_forward_banded(*args, wband=wband, **kw),
           sw_cuda.anchored_forward_banded_reference(*args, wband=wband,
                                                     **kw))
    assert {k: v for k, v in sw_cuda.launches().items() if v} == {
        "anchored_forward": 1, "anchored_forward_banded": 1}


def _warp_classes(live):
    """Width class of each warp of 32 consecutive problems: the smallest
    of 8, 16 and 32 columns covering every lane's live width, else 0 (the
    wide route, a warp a problem)."""
    live = np.asarray(live, np.int64)
    wmax = np.pad(live, (0, -len(live) % 32)).reshape(-1, 32).max(1)
    return {next((k for k in (8, 16, 32) if w <= k), 0) for w in wmax}


@pytest.mark.parametrize("kw", [KW, KW_WRAP], ids=["default", "wrap"])
def test_anchored_kernels_match_plain(dev, kw):
    _anchored_pair(dev, anchored_inputs(23, 1000, 11, 14), kw)


@pytest.mark.parametrize("seed,d,mg,mi", ANCH_SWEEP, ids=ANCH_SWEEP_IDS)
def test_anchored_kernels_match_plain_sweep(dev, seed, d, mg, mi):
    _anchored_pair(dev, anchored_sweep_inputs(seed, d),
                   dict(KW, max_gap=mg, max_intron=mi))


@pytest.mark.parametrize("wband", [None, 64, 512])
def test_anchored_kernels_every_class(dev, wband):
    """Live widths at the edges of the register classes 8, 16 and 32 and
    above them, in warps that mix classes, lbw >= qlen, rlen < qlen, empty
    queries and references; banded planes of 64 and 512 columns."""
    args = anchored_edge_inputs(5, n=256)
    band = np.clip(args[4] + args[5] + 1, 0, wband or 64)
    full = np.clip(args[3], 0, args[2].shape[1])
    assert _warp_classes(band) == _warp_classes(full) == {8, 16, 32, 0}
    _anchored_pair(dev, args, KW, wband=wband)


@pytest.mark.parametrize("event,length,wband", [
    ("D", 260, 512), ("I", 100, 128), ("D", 600, 1024)])
def test_anchored_kernels_long_runs(dev, event, length, wband):
    """Wide warps (wband 128 to 1024, RL 276 and 616): the wide route."""
    args = long_run_inputs(event, length)
    kw = dict(KW, max_gap=length + 40, max_intron=length + 40)
    _anchored_pair(dev, args, kw, wband=wband)


def _anchored_one(dev, args, full, w):
    """One anchored kernel against its plain version, one launch."""
    args = _up(dev, *args)
    sw_cuda.reset_launches()
    if full:
        got = sw_cuda.anchored_forward(*args, **KW)
        want = sw_cuda.anchored_forward_reference(*args, **KW)
    else:
        got = sw_cuda.anchored_forward_banded(*args, wband=w, **KW)
        want = sw_cuda.anchored_forward_banded_reference(*args, wband=w,
                                                         **KW)
    _equal(got, want)
    name = "anchored_forward" if full else "anchored_forward_banded"
    assert {k: v for k, v in sw_cuda.launches().items() if v} == {name: 1}


@pytest.mark.parametrize("indel", [True, False], ids=["indel", "subst"])
@pytest.mark.parametrize("live", [33, 63, 64, 65, 127, 512, 600])
@pytest.mark.parametrize("full", [False, True], ids=["banded", "full"])
def test_anchored_wide_route_matches_plain(dev, full, live, indel):
    """The wide route (a warp a problem) in warps that mix narrow and wide
    lanes, lbw = 0, rbw = 0 and empty queries, at live widths 33 to 512
    and 600 on planes of 1,024 (banded) and 1,025 (full) columns, as the
    staged engine's gap_fallback buckets have them."""
    rl = 1024 if live > 512 else None
    args, w = anchored_wide_inputs(live + 1000 * indel, live, full, n=96,
                                   ql=34 if rl else 40, rl=rl, indel=indel)
    if rl and not full:
        w = 1024
    _anchored_one(dev, args, full, w)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("full", [False, True], ids=["banded", "full"])
def test_anchored_medium_indel_gaps(dev, full, seed):
    """The gap fills of 1 kb reads with one 20-60 base indel at -BW 5."""
    args, w = medium_indel_gaps(seed)["full" if full else "banded"]
    _anchored_one(dev, args, full, w)


def test_anchored_refuses_planes_too_wide_for_a_warp(dev):
    """A plane wider than 32 columns whose wide warp would not fit a
    block's shared memory (wband 4,096, RL 4,096) is refused before either
    kernel launches, and counted as no launch."""
    args = _up(dev, *anchored_inputs(3, 64, 8, 4096))
    sw_cuda.reset_launches()
    with pytest.raises(RuntimeError):
        sw_cuda.anchored_forward_banded(*args, wband=4096, **KW)
    with pytest.raises(RuntimeError):
        sw_cuda.anchored_forward(*args, **KW)
    assert not any(sw_cuda.launches().values())


def test_wrappers_count_launches_and_check_inputs(dev):
    q, qlens, r, rlens = _up(dev, *extension_inputs(5, 64, 16, 1))
    kw = dict(KW, band_width=1, x_cutoff=25)
    sw_cuda.reset_launches()
    sw_cuda.extension_forward(q, qlens, r, rlens, **kw)
    sw_cuda.extension_forward(q[:0], qlens[:0], r[:0], rlens[:0], **kw)
    assert sw_cuda.launches()["extension_forward"] == 1   # N = 0: none
    for bad in (r.to(torch.int32), r.t().contiguous().t(), r.cpu()):
        with pytest.raises(ValueError):
            sw_cuda.extension_forward(q, qlens, bad, rlens, **kw)
    for bad in (dict(block=96), dict(variant="other"),
                dict(variant="reg", band_width=9)):
        with pytest.raises(ValueError):
            sw_cuda.extension_forward(q, qlens, r, rlens, **dict(kw, **bad))
    # W 2,833 with the wide kernel, and W 14,269 with the block kernel:
    # their shared memory exceeds a block's; the C entries refuse them.
    for variant, bw in (("wide", 708), ("block", 3567)):
        with pytest.raises(RuntimeError):
            sw_cuda.extension_forward(q, qlens, r, rlens, variant=variant,
                                      **dict(kw, band_width=bw))
    assert sw_cuda.launches()["extension_forward"] == 1
    assert sw_cuda.launches()["extension_forward_wide"] == 0
    assert sw_cuda.launches()["extension_forward_block"] == 0


@pytest.mark.parametrize("qg,rg,rpad,rev_share", [
    (64, 96, 0, 0.0), (64, 96, 255, 0.5), (40, 75, 255, 0.5)],
    ids=["gap", "ext_rev", "40x75"])
def test_gather_kernel_matches_plain(dev, qg, rg, rpad, rev_share):
    """Random coordinates, whole copies from every source alignment 0-15
    forward and reversed, and clamped sources at both ends of the genome
    and of the strand rows; rows of 75 bytes start at every alignment."""
    g, fwd, lens = gather_case(41)
    corpus = gather_dp.DeviceCorpus(g, dev)
    rows2 = read_rows(corpus, fwd, lens)
    nrows, lpad = rows2.shape
    c = np.concatenate([
        np.stack(gather_coords(7, 3000, qg, rg, rev_share)).astype(np.int64),
        np.stack(gather_aligned_coords(qg, rg, lpad, len(g), nrows)),
        np.stack(gather_clamp_coords(qg, rg, len(g), nrows))], axis=1)
    coords = torch.from_numpy(c).to(dev)
    sw_cuda.reset_launches()
    got = gather_dp.gather_problems(rows2, corpus.codes, coords, qg=qg,
                                    rg=rg, rpad=rpad)
    assert sw_cuda.launches()["gather_problems"] == 1
    want = gather_dp.gather_reference(rows2, corpus.codes, coords, qg=qg,
                                      rg=rg, rpad=rpad)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _walks_equal(bt, y0, x0, active, cap, full, team):
    """The kernel's n_ops and its items up to min(n_ops, cap) equal the
    plain version's; returns n_ops."""
    sw_cuda.reset_launches()
    got = decode.rle_walk(bt, y0, x0, active, cap=cap, full=full, team=team)
    assert {k: v for k, v in sw_cuda.launches().items() if v} == {
        "rle_walk": 1}
    want = decode.rle_walk_reference(bt, y0, x0, active, cap=cap, full=full)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    stored = torch.where(want[1] < 0, cap, want[1])
    written = torch.arange(cap, device=bt.device)[None, :] < stored[:, None]
    assert torch.equal(torch.where(written, got[0], 0), want[0])
    return got[1]


@pytest.mark.parametrize("team", decode.WALK_TEAMS)
@pytest.mark.parametrize("cap", [256, 3], ids=["cap", "overflow"])
def test_walk_kernel_matches_plain(dev, cap, team):
    """Both layouts, on extension, band-relative and full-width planes
    made by the kernels, and on 260-base gap runs; at cap 3 many walks
    overflow (n_ops = -1)."""
    args = _up(dev, *extension_inputs(11, 1000, 40, 2))
    ext = sw_cuda.extension_forward(*args, band_width=2, x_cutoff=25, **KW)
    n_ops = _walks_equal(ext["bt"], ext["maxi"], ext["maxj"],
                         ext["score"] > 0, cap, False, team)
    assert (n_ops == 0).any() and (n_ops > 0).any()
    args = _up(dev, *anchored_sweep_inputs(2, 5))
    q, qlens, r, rlens, lbw, rbw = args
    wband = int((lbw + rbw).max()) + 1
    band = sw_cuda.anchored_forward_banded(*args, wband=wband, **KW)
    full = sw_cuda.anchored_forward(*args, **KW)
    ones = torch.ones_like(qlens, dtype=torch.bool)
    _walks_equal(band["bt_b"], qlens, rlens - qlens + lbw, ones, cap,
                 False, team)
    n_ops = _walks_equal(full["bt"], qlens, rlens, ones, cap, True, team)
    if cap == 3:
        assert (n_ops == -1).any()
    kw = dict(KW, max_gap=300, max_intron=300)
    for event in ("D", "I"):
        args = _up(dev, *long_run_inputs(event))
        qlen, rlen, lb = args[1], args[3], args[4]
        one = torch.ones(1, dtype=torch.bool, device=dev)
        bt = sw_cuda.anchored_forward_banded(*args, wband=512, **kw)["bt_b"]
        _walks_equal(bt, qlen, rlen - qlen + lb, one, cap, False, team)
        bt = sw_cuda.anchored_forward(*args, **kw)["bt"]
        _walks_equal(bt, qlen, rlen, one, cap, True, team)


@pytest.mark.parametrize("w,full", [(21, False), (512, False), (1100, True),
                                    (20000, True)])
def test_walk_kernel_any_width(dev, w, full):
    """Random planes of every byte value: windows of 1,024 bytes up to the
    largest, 16,384, which holds less than one row of 20,000 bytes; walks
    from inside and outside the plane, a tenth of them inactive."""
    rng = np.random.default_rng(w)
    n, h = 256, 40
    bt = torch.from_numpy(rng.integers(0, 32, (n, h, w)).astype(
        np.int8)).to(dev)
    y0, x0 = _up(dev, rng.integers(-1, h + 1, n).astype(np.int32),
                 rng.integers(-1, w + 1, n).astype(np.int32))
    active = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    sw_cuda.reset_launches()
    got = decode.rle_walk(bt, y0, x0, active, cap=64, full=full)
    assert {k: v for k, v in sw_cuda.launches().items() if v} == {
        "rle_walk": 1}
    want = decode.rle_walk_reference(bt, y0, x0, active, cap=64, full=full)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    written = torch.arange(64, device=dev)[None, :] < torch.where(
        want[1] < 0, 64, want[1])[:, None]
    assert torch.equal(torch.where(written, got[0], 0), want[0])


def test_walk_refused_launch_raises(dev):
    """A team or window the C entry does not take is refused, the wrapper
    raises and counts nothing; so does a team the wrapper does not take."""
    from yaha_tpu_torch.ops import _build
    bt = torch.zeros((4, 3, 5), dtype=torch.int8, device=dev)
    yx = torch.zeros(4, dtype=torch.int32, device=dev)
    act = torch.ones(4, dtype=torch.uint8, device=dev)
    rle = torch.empty((4, 8), dtype=torch.int32, device=dev)
    n_ops = torch.empty(4, dtype=torch.int32, device=dev)
    sw_cuda.reset_launches()
    for team, window in ((12, 512), (0, 512), (32, 300), (32, 32768)):
        with pytest.raises(RuntimeError):
            sw_cuda._launched("rle_walk", _build.load().yt_rle_walk(
                bt.data_ptr(), 4, 3, 5, yx.data_ptr(), yx.data_ptr(),
                act.data_ptr(), 8, 0, rle.data_ptr(), n_ops.data_ptr(),
                team, window, sw_cuda._stream(dev)))
    with pytest.raises(ValueError):
        decode.rle_walk(bt, yx, yx, act, cap=8, full=False, team=12)
    assert not any(sw_cuda.launches().values())


# (word length, row length, shift): the seed rows (l None), and rows
# whose 16-window runs cross row ends (hash_rows), also starting 5 bytes
# past a 16-byte boundary (a view into a larger tensor).
HASH_KERNEL_CASES = [pytest.param(wl, None, 0, id=str(wl))
                     for wl in (4, 11, 15)] + [
    pytest.param(wl, l, shift, id="%s-shift%d" % (i, shift))
    for (wl, l), i in zip(HASH_SHAPES, HASH_SHAPE_IDS) for shift in (0, 5)]


@pytest.mark.parametrize("wl,l,shift", HASH_KERNEL_CASES)
def test_seed_hash_kernel_matches_plain(dev, wl, l, shift):
    codes, lens = (seed_rows(wl) if l is None else hash_rows(wl + l, wl, l))
    buf = torch.zeros(codes.size + 16, dtype=torch.uint8, device=dev)
    codes_d = buf[shift:shift + codes.size].view(codes.shape)
    codes_d.copy_(torch.from_numpy(codes))
    lens_d, = _up(dev, lens)
    sw_cuda.reset_launches()
    got = seeds.seed_hashes(codes_d, lens_d, word_len=wl)
    assert {k: v for k, v in sw_cuda.launches().items() if v} == {
        "seed_hashes": 1}
    want = seeds.seed_hashes_reference(codes_d, lens_d, word_len=wl)
    _equal({"h": got[0], "c": got[1]}, {"h": want[0], "c": want[1]})


@pytest.mark.parametrize("case", SEED_CASES + ["golden16384",
                                               "unsigned1024"])
def test_expand_sort_kernel_matches_plain(dev, case):
    """Every output equal, the sentinel slots and the wrapped flags of
    overflowed rows included; one launch."""
    src, so, roa, max_hits, cap = seed_case(case)
    if src[0] == "rows":
        codes, lens = _up(dev, src[1], src[2])
        hashes, clean = seeds.seed_hashes_reference(codes, lens,
                                                    word_len=src[3])
    else:
        hashes, clean = _up(dev, src[1], src[2])
    so, roa = _up(dev, so.view(np.int32), roa.view(np.int32))
    kw = dict(max_hits=max_hits, capacity=cap)
    sw_cuda.reset_launches()
    got = seeds.expand_sort_hits(hashes, clean, so, roa, **kw)
    assert {k: v for k, v in sw_cuda.launches().items() if v} == {
        "expand_sort_hits": 1}
    _equal(got, seeds.expand_sort_hits_reference(hashes, clean, so, roa,
                                                 **kw))


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("case", ["golden1024", "golden8192", "unsigned16",
                                  "longrun1024", "wrapped64"])
def test_expand_sort_shard_kernel_matches_plain(dev, case, n_model):
    """The range-masked expansion on each model shard of the index
    (parallel/mesh.ShardedIndex: its range, rebased SO and ROA slice) and
    the merge of the shards' rows, each kernel equal to its plain version
    on the card, one launch each; the merged rows equal the plain
    version's whole-index rows wherever no shard overflowed."""
    from yaha_tpu_torch.parallel import mesh

    class Idx:
        word_len = max_hits = 0
    src, Idx.starting_offs, Idx.roa, max_hits, cap = seed_case(case)
    if src[0] == "rows":
        codes, lens = _up(dev, src[1], src[2])
        hashes, clean = seeds.seed_hashes_reference(codes, lens,
                                                    word_len=src[3])
    else:
        hashes, clean = _up(dev, src[1], src[2])
    sidx = mesh.ShardedIndex(Idx, n_model)
    kw = dict(max_hits=max_hits, capacity=cap, per=sidx.per)
    outs = []
    for m in range(n_model):
        so, roa = _up(dev, sidx.so_local[m].view(np.int32),
                      sidx.roa_parts[m].view(np.int32))
        lo = int(sidx.hash_lo[m])
        sw_cuda.reset_launches()
        got = seeds.expand_sort_hits(hashes, clean, so, roa, hash_lo=lo,
                                     **kw)
        assert {k: v for k, v in sw_cuda.launches().items() if v} == {
            "expand_sort_hits": 1}
        _equal(got, seeds.expand_sort_hits_reference(
            hashes, clean, so, roa, hash_lo=lo, **kw))
        outs.append(got)
    diag = torch.stack([o["diag"] for o in outs])
    qo = torch.stack([o["qo"] for o in outs])
    sw_cuda.reset_launches()
    got = seeds.merge_sorted_runs(diag, qo)
    assert {k: v for k, v in sw_cuda.launches().items() if v} == {
        "merge_sorted_runs": 1}
    want = seeds.merge_sorted_runs_reference(diag, qo)
    _equal({"diag": got[0], "qo": got[1]}, {"diag": want[0], "qo": want[1]})
    so, roa = _up(dev, Idx.starting_offs.view(np.int32),
                  Idx.roa.view(np.int32))
    whole = seeds.expand_sort_hits_reference(
        hashes, clean, so, roa, max_hits=max_hits, capacity=n_model * cap)
    ok = ~torch.stack([o["overflow"] for o in outs]).any(0)
    tot = whole["total"].clamp(min=0)
    mask = (torch.arange(n_model * cap, device=dev)[None, :] <
            tot[:, None]) & ok[:, None]
    assert torch.equal(got[0][mask], whole["diag"][mask])
    assert torch.equal(got[1][mask], whole["qo"][mask])


@pytest.mark.parametrize("m,b,cap", [(2, 32768, 1024), (2, 300, 8192),
                                     (3, 1000, 64), (4, 17, 2048),
                                     (1, 5, 16), (4, 32768, 1024),
                                     (4, 374, 8192), (8, 50, 2048)])
def test_merge_kernel_matches_plain(dev, m, b, cap):
    """The merge kernel on random sorted runs (diag >= 2^31, 0xFFFFFFFF
    beside the sentinel, equal keys across runs, full and empty runs) at
    the 1 kb batch's tier-1 shape and a tier-2 one, with 2, 4 and 8
    shards (one, two and three passes): equal to torch.sort of the
    gathered keys."""
    gen = torch.Generator(device=dev).manual_seed(m * 7 + cap)
    valid = torch.randint(0, cap + 1, (m, b, 1), generator=gen, device=dev)
    valid[:, 0] = cap
    valid[:, 1] = 0
    pool = torch.tensor([0, 1, 2 ** 31 - 1, -2 ** 31, -1], dtype=torch.int32,
                        device=dev)
    d = torch.randint(-2 ** 31, 2 ** 31, (m, b, cap), generator=gen,
                      device=dev, dtype=torch.int32)
    pick = torch.randint(0, 8, (m, b, cap), generator=gen, device=dev)
    d = torch.where(pick < 5, pool[pick.clamp(max=4)], d)
    q = torch.randint(0, 16, (m, b, cap), generator=gen, device=dev,
                      dtype=torch.int32)
    live = torch.arange(cap, device=dev)[None, None, :] < valid
    key = torch.where(live, ((d.to(torch.int64) & 0xFFFFFFFF) << 31) | q,
                      (0xFFFFFFFF << 31) | 0x7FFFFFFF)
    key, _ = torch.sort(key, dim=2)
    diag = seeds._as_i32(key >> 31)
    qo = (key & 0x7FFFFFFF).to(torch.int32)
    got = seeds.merge_sorted_runs(diag, qo)
    want = seeds.merge_sorted_runs_reference(diag, qo)
    _equal({"diag": got[0], "qo": got[1]}, {"diag": want[0], "qo": want[1]})


def test_seed_wrappers_refuse_shapes(dev):
    """A capacity that is not a power of two or is past MAX_CAPACITY, and a
    word length past 15, raise and launch nothing."""
    codes, lens = _up(dev, *seed_rows(1, n_sampled=4, n_wrapped=0))
    hashes, clean = seeds.seed_hashes_reference(codes, lens, word_len=11)
    so, roa = _up(dev, np.zeros(8, np.int32), np.zeros(4, np.int32))
    sw_cuda.reset_launches()
    for cap in (1000, 2 * seeds.MAX_CAPACITY):
        with pytest.raises(ValueError):
            seeds.expand_sort_hits(hashes, clean, so, roa, max_hits=650,
                                   capacity=cap)
    with pytest.raises(ValueError):
        seeds.seed_hashes(codes, lens, word_len=16)
    assert not any(sw_cuda.launches().values())


@pytest.fixture(scope="module")
def testgen(dev, tmp_path_factory):
    from yaha_tpu_torch import host
    d = tmp_path_factory.mktemp("torch_cuda")
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), d)
    with gzip.open(os.path.join(GOLD, INDEX + ".gz")) as f:
        with open(os.path.join(d, INDEX), "wb") as out:
            out.write(f.read())
    return (host.load_genome(os.path.join(d, "testgen.nib2")),
            host.load_index(os.path.join(d, INDEX)))


def _reads(name):
    if name == "indel":
        return indel_reads(os.path.join(DATA, "testgen.fasta"), 200, 5)
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("qfile,over,config", [
    ("readsA_100bp.fasta", {}, {}),
    ("readsD_sv.fasta", {"fbs": True}, {}),
    ("indel", {}, {}),
    ("indel", {}, {"device_assembly": False, "rle": False}),
], ids=["A_default", "D_fbs", "indel", "indel_ab"])
def test_staged_cuda_matches_native(dev, testgen, qfile, over, config):
    """Every gap fill and extension through the kernels (inline_small off),
    problems assembled and planes walked on the card: SAM bytes equal the
    native engine's, and no backtrack plane comes back."""
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.staged import StagedAligner
    genome, index = testgen
    aa = host.AlignmentArgs()
    aa.xfile_name = INDEX
    aa.ofile_name = "out.sam"
    for k, v in over.items():
        setattr(aa, k, v)
    aa.post_process(True)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    pr = host.parse_queries_native(_reads(qfile), False,
                                   aa.max_query_length, aa.word_len)
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=4)
    st = StagedAligner(aa, genome, index, device=dev, n_threads=4,
                       inline_small=False, **config)
    sw_cuda.reset_launches()
    text, sm, nr = st.align_chunk(pr, 0, pr.n)
    assert text == ref[0]
    assert (sm, nr) == (ref[2], ref[3])
    launched = sw_cuda.launches()
    assert launched["extension_forward"] > 0
    assert launched["extension_forward_wide"] == 0
    assert launched["anchored_forward_banded"] > 0
    if qfile == "indel":
        assert st.stats["gap_full"] > 0
        assert launched["anchored_forward"] > 0
    default = not config
    assert (launched["gather_problems"] > 0) == default
    assert (launched["rle_walk"] > 0) == default
    assert (st.stats["plane_d2h_bytes"] == 0) == default


@pytest.mark.parametrize("qfile,over", [
    ("readsC_1kb.fasta", {"band_width": 3, "max_gap": 20, "min_match": 15,
                          "x_cutoff": 15}),
    ("readsA_100bp.fasta", {}),
], ids=["C_params", "A_default"])
def test_staged_cuda_with_seeder_matches_native(dev, testgen, qfile, over):
    """The engine with the device seeder (--seed device) on the card: SAM
    bytes equal the native engine's; both seed kernels launched; on
    C_params the phantom, retry and host-scan rows all occur."""
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    from yaha_tpu_torch.models.staged import StagedAligner
    genome, index = testgen
    aa = host.AlignmentArgs()
    aa.xfile_name = INDEX
    aa.ofile_name = "out.sam"
    for k, v in over.items():
        setattr(aa, k, v)
    aa.post_process(True)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    pr = host.parse_queries_native(_reads(qfile), False,
                                   aa.max_query_length, aa.word_len)
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=4)
    seeder = DeviceSeeder(aa, index, device=dev)
    st = StagedAligner(aa, genome, index, device=dev, n_threads=4,
                       seeder=seeder)
    sw_cuda.reset_launches()
    text, sm, nr = st.align_chunk(pr, 0, pr.n)
    assert text == ref[0]
    assert (sm, nr) == (ref[2], ref[3])
    launched = sw_cuda.launches()
    assert launched["seed_hashes"] == 1
    assert launched["expand_sort_hits"] == seeder.stats["seed_launches"]
    if qfile == "readsC_1kb.fasta":
        s = seeder.stats
        assert s["phantom_rows"] > 0 and s["cap_retries"] > 0
        assert s["fallback_rows"] > 0


def _chain_args(case):
    if case.startswith("seed"):
        return chain_case(int(case[4:]), 16, 48)[:5], CHAIN_KW
    if case.startswith("n="):
        n = int(case[2:])
        return chain_case(n, 24, n, qspan=40 * n)[:5], CHAIN_KW
    if case.startswith("ties"):
        return chain_tie_case(int(case[4:])), CHAIN_TIE_KW
    if case.startswith("path="):
        return chain_path_case(int(case[5:]), b=8), CHAIN_KW
    return dict(chain_edge_case())[case], dict(CHAIN_KW, m_score=2)


@pytest.mark.parametrize("case", [
    "seed0", "seed1", "seed2", "ties0", "ties1", "n1", "invalid_row",
    "int16_wrap", "gap_edges", "n=20", "n=48", "n=64", "n=65", "n=200",
    "n=400", "n=1000", "n=2000", "n=2048", "n=3000", "n=4096", "path=64",
    "path=4096"])
def test_chain_kernel_matches_plain(dev, case):
    """chain_dp_kernel = batched_chain_dp_ref on the card, every output;
    N = 20 .. 4,096 runs every team shape (a warp for N <= 64, blocks of
    256 and 512 threads above), and ranges whose candidate DAG is one path
    a step at every node; one launch a call."""
    args, kw = _chain_args(case)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
    sw_cuda.reset_launches()
    got = chain.batched_chain_dp(*t, **kw)
    assert sw_cuda.launches()["chain_dp"] == 1
    _equal(got, chain.batched_chain_dp_ref(*t, **kw))


def test_chain_kernel_refuses_wide_ranges(dev):
    z = torch.zeros((2, chain.MAX_NODES + 1), dtype=torch.int32,
                    device=dev)
    sw_cuda.reset_launches()
    with pytest.raises(ValueError):
        chain.batched_chain_dp(z, z, z, z, z.bool(), **CHAIN_KW)
    assert sw_cuda.launches()["chain_dp"] == 0


@pytest.mark.parametrize("bw", [0, 5, 9])
def test_extension_twin_card_matches_cpu(dev, bw):
    """ops/sw_batch's extension on the card = the same on the CPU."""
    args = indel_extension_inputs(bw + 3, 300, 48, bw)
    kw = dict(KW, band_width=bw, x_cutoff=25)
    cpu = sw_batch.batched_extension_forward(
        *(torch.from_numpy(a) for a in args), **kw)
    _equal({k: v.cpu() for k, v in sw_batch.batched_extension_forward(
        *_up(dev, *args), **kw).items()}, cpu)


@pytest.mark.parametrize("seed,d,mg,mi", ANCH_SWEEP, ids=ANCH_SWEEP_IDS)
def test_anchored_twin_card_matches_cpu(dev, seed, d, mg, mi):
    args = anchored_sweep_inputs(seed, d)
    kw = dict(KW, max_gap=mg, max_intron=mi)
    cpu = sw_batch.batched_anchored_forward(
        *(torch.from_numpy(a) for a in args), **kw)
    _equal({k: v.cpu() for k, v in sw_batch.batched_anchored_forward(
        *_up(dev, *args), **kw).items()}, cpu)


def test_staged_cuda_too_wide_gap_buckets_take_the_twin(dev, testgen):
    """tests/torch_dp_cases.long_gap_reads at -G 3,600: the two unbanded
    gap buckets of RL 4,096, too wide for the anchored wide route, go to
    the lockstep twin on the card (gap_twin), every other bucket to the
    kernels; SAM bytes equal the native engine's."""
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.staged import StagedAligner
    genome, index = testgen
    aa = host.AlignmentArgs()
    aa.xfile_name = INDEX
    aa.ofile_name = "out.sam"
    aa.max_gap = 3600
    aa.post_process(True)
    aa.word_len = index.word_len
    pr = host.parse_queries_native(
        long_gap_reads(os.path.join(DATA, "testgen.fasta")), False,
        aa.max_query_length, aa.word_len)
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=4)
    st = StagedAligner(aa, genome, index, device=dev, n_threads=4)
    sw_cuda.reset_launches()
    text, sm, nr = st.align_chunk(pr, 0, pr.n)
    assert text == ref[0]
    assert (sm, nr) == (ref[2], ref[3])
    assert st.stats["gap_twin"] == 2
    assert sw_cuda.launches()["anchored_forward_banded"] > 0


@pytest.mark.parametrize("bw", [708, 3300])
def test_staged_cuda_bw_708_takes_the_block_kernel(dev, testgen, bw):
    """readsA's first reads at -BW 708 (W 2,833, past the staged wide
    kernel) and -BW 3,300 (W 13,201, past the first version's 12,905):
    every extension bucket goes to the block kernel, none to a twin; SAM
    bytes equal the native engine's."""
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.staged import StagedAligner
    genome, index = testgen
    aa = host.AlignmentArgs()
    aa.xfile_name = INDEX
    aa.ofile_name = "out.sam"
    aa.band_width = bw
    aa.post_process(True)
    aa.word_len = index.word_len
    data = _reads("readsA_100bp.fasta")
    pr = host.parse_queries_native(b">" + b">".join(data.split(b">")[1:11]),
                                   False, aa.max_query_length, aa.word_len)
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=4)
    st = StagedAligner(aa, genome, index, device=dev, n_threads=4)
    sw_cuda.reset_launches()
    text, sm, nr = st.align_chunk(pr, 0, pr.n)
    assert text == ref[0]
    assert (sm, nr) == (ref[2], ref[3])
    assert st.stats["ext_problems"] > 0
    assert sw_cuda.launches()["extension_forward_block"] > 0
    assert sw_cuda.launches()["extension_forward_wide"] == 0


def test_sharded_seeder_on_card_matches_native(dev, testgen):
    """DeviceSeeder on (1 x 2) and (2 x 2) grids of the card (readsC at
    -BW 3 -G 20 -M 15 -X 15): seed rows equal the single-device seeder's
    wherever both serve a row, SAM bytes equal the native engine's, both
    kernels launched."""
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    from yaha_tpu_torch.models.staged import StagedAligner
    from yaha_tpu_torch.parallel import mesh
    genome, index = testgen
    aa = host.AlignmentArgs()
    aa.xfile_name = INDEX
    aa.ofile_name = "out.sam"
    for k, v in {"band_width": 3, "max_gap": 20, "min_match": 15,
                 "x_cutoff": 15}.items():
        setattr(aa, k, v)
    aa.post_process(True)
    aa.word_len = index.word_len
    pr = host.parse_queries_native(_reads("readsC_1kb.fasta"), False,
                                   aa.max_query_length, aa.word_len)
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=4)
    want = DeviceSeeder(aa, index, device=dev).seed_chunk(pr, 0, pr.n)
    for n_data in (1, 2):
        grid = mesh.make_mesh([dev] * 2 * n_data, 2)
        seeder = DeviceSeeder(aa, index, mesh=grid)
        got = seeder.seed_chunk(pr, 0, pr.n)
        both = (got[3] >= 0) & (want[3] >= 0)
        assert both.sum() == (want[3] >= 0).sum()
        for r in np.flatnonzero(both):
            for k in (0, 1):
                np.testing.assert_array_equal(
                    got[k][got[2][r]:got[2][r + 1]],
                    want[k][want[2][r]:want[2][r + 1]])
        st = StagedAligner(aa, genome, index, device=dev, n_threads=4,
                           seeder=seeder)
        sw_cuda.reset_launches()
        text, sm, nr = st.align_chunk(pr, 0, pr.n)
        assert text == ref[0]
        assert (sm, nr) == (ref[2], ref[3])
        launched = sw_cuda.launches()
        assert launched["seed_hashes"] == 1
        assert launched["expand_sort_hits"] >= 2 * n_data
        assert launched["merge_sorted_runs"] >= n_data


@pytest.mark.parametrize("qfile,over", [
    ("readsA_100bp.fasta", {}),
    ("indel", {}),
], ids=["A_default", "indel"])
def test_staged_torch_backend_on_card(dev, testgen, qfile, over):
    """StagedAligner(backend="torch") on the card: SAM bytes equal to the
    native engine's, problems gathered on the card, no DP kernel
    launched."""
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.staged import StagedAligner
    genome, index = testgen
    aa = host.AlignmentArgs()
    aa.xfile_name = INDEX
    aa.ofile_name = "out.sam"
    for k, v in over.items():
        setattr(aa, k, v)
    aa.post_process(True)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    pr = host.parse_queries_native(_reads(qfile), False,
                                   aa.max_query_length, aa.word_len)
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=4)
    st = StagedAligner(aa, genome, index, device=dev, n_threads=4,
                       inline_small=False, backend="torch")
    sw_cuda.reset_launches()
    text, sm, nr = st.align_chunk(pr, 0, pr.n)
    assert text == ref[0]
    assert (sm, nr) == (ref[2], ref[3])
    launched = {k: v for k, v in sw_cuda.launches().items() if v}
    assert list(launched) == ["gather_problems"]
    assert st.stats["plane_d2h_bytes"] > 0


@pytest.mark.parametrize("wl,sd,mh", INDEX_CASES, ids=INDEX_CASE_IDS)
def test_index_build_on_card_matches_cpu(dev, wl, sd, mh):
    """index/build.build_index's passes on the card = on the CPU, in one
    chunk and in chunks of 333 windows (the third pass down-samples the
    repeats' k-mers wherever max_hits < 65,525)."""
    from yaha_tpu_torch.index import build
    for seed in (0, 1):
        g = index_genome(seed)
        for chunk in (64 << 20, 333):
            got = build.build_index(g, wl, sd, mh, chunk=chunk, device=dev)
            want = build.build_index(g, wl, sd, mh, chunk=chunk,
                                     device="cpu")
            assert got[2] == want[2]
            for a, b in zip(got[:2], want[:2]):
                assert a.dtype == b.dtype == np.uint32
                assert np.array_equal(a, b)


def test_index_build_on_card_matches_golden(dev):
    from yaha_tpu_torch.index import build
    from yaha_tpu_torch.io import nib2
    with open(os.path.join(GOLD, "testgen.nib2"), "rb") as f:
        g = nib2.load(f.read())
    so, roa, tm = build.build_index(g, 11, 1, 20, device=dev)
    got = np.array([0xFFFFFFFF, 11, 20, tm], np.uint32).tobytes() + \
        so.tobytes() + roa.tobytes()
    with gzip.open(os.path.join(GOLD, "testgen.X11_01_00020S.gz")) as f:
        assert got == f.read()
