"""The port's device seed phase (yaha_tpu_torch) against the JAX package's.

On the CPU the seed entries of yaha_tpu_torch/ops/seeds.py run their plain
PyTorch versions, which are held here to yaha_tpu/ops/seeds_jax.py on the
same numpy-seeded inputs, array for array (integer arrays, tolerance
zero): the window hashes (word lengths 4, 11 and 15, N and X codes inside
reads, reads shorter than the word, pad code 4), the hit expansion and
sort on the golden L11 index at capacities 64, 1,024 and 8,192 (rows that
overflow each of the first two), on the synthetic index of
test_seeds_jax.py's tier-capacity test, on hits whose diag is 2^31 or
more (the uint32 order), on 650-hit runs across C in rows of three
expansion batches and on row totals around every sort size; hashes also
on rows whose 16-window runs cross row ends; and the three plain ops with
no kernel.  The
port's DeviceSeeder.seed_chunk must return the JAX DeviceSeeder's hit rows
on the read sets of tests/test_seeder.py, with phantom, retry and
host-scan rows, also from 24 concurrent calls with no stats update lost;
the engine with the seeder must write the native engine's
SAM bytes in the default and the A/B configuration, and the CLI with
--seed device the golden SAM.  Without a card, DeviceSeeder(device="cuda")
raises.
"""
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from conftest import DATA, GOLD
from torch_dp_cases import (HASH_SHAPE_IDS, HASH_SHAPES, SEED_CASES,
                            SIZE_TOTALS, golden_index, hash_rows,
                            parse_clump_record, seed_case, seed_rows,
                            unsigned_case, wrapped_case)
from yaha_tpu.ops import seeds_jax
from yaha_tpu_torch.ops import seeds

INDEX = "testgen.X11_01_65525S"


def _t(a):
    """numpy -> CPU tensor; uint32 arrays as int32 tensors of their bits."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _np(key, t):
    a = t.numpy()
    return a.view(np.uint32) if key == "diag" else a


def _equal_jax(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = _np(key, got[key])
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)


# ---- the two kernel programs ----

def _code_batch(seed, wl, b=40, l=96):
    """Random code rows with N (4) and X (14) codes inside the reads, pad
    code 4 past each length, lengths from 0 up to the row, three of them
    below the word length."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (b, l)).astype(np.uint8)
    bad = rng.random((b, l)) < 0.04
    codes[bad] = rng.choice(np.array([4, 14], np.uint8), int(bad.sum()))
    lens = rng.integers(wl, l + 1, b)
    lens[:4] = [0, 1, wl - 1, l]
    codes[np.arange(l)[None, :] >= lens[:, None]] = 4
    return codes, lens.astype(np.int32)


# (word length, row length): random rows of 96 codes (l None), and the
# rows whose 16-window runs cross row ends (hash_rows).
HASH_CASES = [pytest.param(wl, None, id=str(wl)) for wl in (4, 11, 15)] + [
    pytest.param(wl, l, id=i) for (wl, l), i in zip(HASH_SHAPES,
                                                     HASH_SHAPE_IDS)]


@pytest.mark.parametrize("wl,l", HASH_CASES)
def test_seed_hashes_match_jax(wl, l):
    codes, lens = (_code_batch(wl, wl) if l is None else
                   hash_rows(wl + l, wl, l))
    hashes, clean = seeds.seed_hashes(_t(codes), _t(lens), word_len=wl)
    want = seeds_jax.batched_seed_hashes(codes, lens, word_len=wl)
    _equal_jax({"h": hashes, "c": clean}, {"h": want[0], "c": want[1]})
    assert clean.any() and not clean.all()
    assert not clean[:3].any()


@pytest.fixture(scope="module")
def golden_batch():
    """Hashes of seed_rows(5) on the golden L11 index, and its tables."""
    wl, _, so, roa = golden_index()
    codes, lens = seed_rows(5)
    hashes, clean = seeds.seed_hashes(_t(codes), _t(lens), word_len=wl)
    return hashes, clean, so, roa


@pytest.mark.parametrize("capacity", [64, 1024, 8192])
def test_expand_sort_matches_jax_golden_index(golden_batch, capacity):
    hashes, clean, so, roa = golden_batch
    got = seeds.expand_sort_hits(hashes, clean, _t(so), _t(roa),
                                 max_hits=650, capacity=capacity)
    _equal_jax(got, seeds_jax.expand_sort_hits_device(
        hashes.numpy(), clean.numpy(), so, roa, max_hits=650,
        capacity=capacity))
    assert got["allwrapped"].any()
    # Rows overflow the first two capacities; none the largest.
    assert got["overflow"].any() == (capacity < 8192)


@pytest.mark.parametrize("capacity", [64, 128])
def test_expand_sort_matches_jax_wrapped_run_at_capacity(capacity):
    """The wrapped run in the last slots of the buffer (tier capacity 128)
    and past it (64: the row overflows and the run's window reads as
    wrapped)."""
    hashes, clean, so, roa = wrapped_case()
    got = seeds.expand_sort_hits(_t(hashes), _t(clean), _t(so), _t(roa),
                                 max_hits=650, capacity=capacity)
    _equal_jax(got, seeds_jax.expand_sort_hits_device(
        hashes, clean, so, roa, max_hits=650, capacity=capacity))
    assert bool(got["overflow"][0]) == (capacity == 64)
    # At 64 the run of window 4 (slots 80-119) also lies past the cutoff.
    assert got["wrapped"][0].tolist() == [False] * 4 + [capacity == 64,
                                                        False, True, False]


@pytest.mark.parametrize("capacity", [8, 16, 1024])
def test_expand_sort_unsigned_order_and_sentinel(capacity):
    """Hits with diag >= 2^31 sort after the others, and a valid hit with
    diag = 0xFFFFFFFF before the sentinel by its qo."""
    hashes, clean, so, roa, max_hits = unsigned_case()
    got = seeds.expand_sort_hits(_t(hashes), _t(clean), _t(so), _t(roa),
                                 max_hits=max_hits, capacity=capacity)
    _equal_jax(got, seeds_jax.expand_sort_hits_device(
        hashes, clean, so, roa, max_hits=max_hits, capacity=capacity))
    diag = _np("diag", got["diag"]).astype(np.int64)
    key = diag << 31 | got["qo"].numpy()     # qo < 2^31
    assert (np.diff(key, axis=1) >= 0).all()
    if capacity == 16:
        # row 0: 12 hits, the last the valid (0xFFFFFFFF, 31), then the
        # sentinel
        assert diag[0, 11] == 0xFFFFFFFF and got["qo"][0, 11] == 31
        assert (diag[0, :11] < 0xFFFFFFFF).all() and (diag[0, 4] >= 1 << 31)
        assert (got["qo"][0, 12:] == seeds.QO_SENTINEL).all()
        assert got["total"].tolist() == [12, 8, 12, 0]


# The seed cases no test above runs: 650-hit runs across C in rows of
# three batches, and row totals around every sort size.
EDGE_CASES = [c for c in SEED_CASES if c.startswith(("longrun", "sizes"))]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_expand_sort_matches_jax_cases(case):
    """The seed cases of the kernel's edges (the g++ and card tests run
    them too): whole dicts equal."""
    src, so, roa, max_hits, cap = seed_case(case)
    hashes, clean = _t(src[1]), _t(src[2])
    got = seeds.expand_sort_hits(hashes, clean, _t(so), _t(roa),
                                 max_hits=max_hits, capacity=cap)
    _equal_jax(got, seeds_jax.expand_sort_hits_device(
        hashes.numpy(), clean.numpy(), so, roa, max_hits=max_hits,
        capacity=cap))
    if case == "sizes1024":
        assert got["total"].tolist() == list(SIZE_TOTALS)
    if case.startswith("longrun"):
        total = got["total"].tolist()
        # the 650 runs of rows 1 and 2 start at slots 600 and 500 and
        # straddle 1,024, row 4's starts there; row 2's run is wrapped (all
        # its slots below C have ro < qo)
        assert [total[1], total[2], total[4]] == [1350, 1250, 1684]
        assert bool(got["wrapped"][2, 900])
        assert bool(got["overflow"][3]) == (cap < total[3])


# ---- the plain ops with no kernel ----

def test_seed_counts_match_jax(golden_batch):
    hashes, clean, so, _ = golden_batch
    got = seeds.seed_counts(hashes, clean, _t(so))
    want = seeds_jax.seed_counts(hashes.numpy(), clean.numpy(),
                                 so.astype(np.int64))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_strand_hit_totals_match_jax(golden_batch):
    hashes, clean, so, _ = golden_batch
    got = seeds.strand_hit_totals(hashes, clean, _t(so), 650)
    want = seeds_jax.strand_hit_totals(hashes.numpy(), clean.numpy(), so,
                                       650)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fragment_boundaries_match_jax(golden_batch):
    hashes, clean, so, roa = golden_batch
    out = seeds.expand_sort_hits(hashes, clean, _t(so), _t(roa),
                                 max_hits=650, capacity=1024)
    valid = torch.arange(1024)[None, :] < out["total"][:, None]
    got = seeds.fragment_boundaries(out["diag"], out["qo"], valid,
                                    word_len=11)
    want = seeds_jax.fragment_boundaries(
        _np("diag", out["diag"]), out["qo"].numpy(), valid.numpy(),
        word_len=11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > len(got)


# ---- the seeder and the engine ----

@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_seeds")
    for f in ("readsA_100bp.fasta", "readsC_1kb.fasta", "readsD_sv.fasta",
              "readsE_150bp.fastq"):
        shutil.copy(os.path.join(DATA, f), d)
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), d)
    with gzip.open(os.path.join(GOLD, INDEX + ".gz")) as f:
        with open(os.path.join(d, INDEX), "wb") as out:
            out.write(f.read())
    return str(d)


@pytest.fixture(scope="module")
def env(scratch):
    from yaha_tpu_torch import host
    return (host.load_genome(os.path.join(scratch, "testgen.nib2")),
            host.load_index(os.path.join(scratch, INDEX)))


# The read sets of tests/test_seeder.py.
CONFIGS = [
    ("readsC_1kb.fasta", {"band_width": 3, "max_gap": 20, "min_match": 15,
                          "x_cutoff": 15}),
    ("readsD_sv.fasta", {"fbs": True}),
    ("readsE_150bp.fastq", {}),
]
CONFIG_IDS = ["params1kb", "sv_fbs", "fastq"]


def _setup(scratch, index, qfile, over):
    from yaha_tpu_torch import host
    aa = host.AlignmentArgs()
    aa.xfile_name = INDEX
    aa.qfile_name = qfile
    aa.ofile_name = "out.sam"
    for k, v in over.items():
        setattr(aa, k, v)
    aa.post_process(True)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    with open(os.path.join(scratch, qfile), "rb") as f:
        data = f.read()
    aa.fastq = data[:1] == b"@"
    return aa, host.parse_queries_native(data, aa.fastq,
                                         aa.max_query_length, aa.word_len)


@pytest.mark.parametrize("qfile,over", CONFIGS, ids=CONFIG_IDS)
def test_seed_chunk_matches_jax_seeder(scratch, env, qfile, over):
    """(diag, qo, offs, totals) equal to the JAX DeviceSeeder's, array for
    array; on params1kb the phantom, retry and host-scan rows all occur."""
    from yaha_tpu.models.seeder import DeviceSeeder as JaxSeeder
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    _, index = env
    aa, pr = _setup(scratch, index, qfile, over)
    seeder = DeviceSeeder(aa, index, device="cpu")
    got = seeder.seed_chunk(pr, 0, pr.n)
    want = JaxSeeder(aa, index).seed_chunk(pr, 0, pr.n)
    for name, g, w in zip(("diag", "qo", "offs", "totals"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    s = seeder.stats
    assert s["cap_retries"] == 1 and s["seed_launches"] == 2
    assert s["index_upload_bytes"] == 4 * ((1 << 22) + 1 + index.roa_len)
    if qfile == "readsC_1kb.fasta":
        assert s["phantom_rows"] > 0 and s["fallback_rows"] > 0
        assert (got[3] == -1).sum() == s["fallback_rows"]


def test_seed_chunk_splice_span(scratch, env):
    """With phantom and retried rows, the hit rows' splice is a
    seeder.splice span under seeder.seed, counting the bytes it returns,
    and seed_device_s stops where it starts."""
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    from yaha_tpu_torch.utils.timing import RECORDER
    _, index = env
    aa, pr = _setup(scratch, index, *CONFIGS[0])
    seeder = DeviceSeeder(aa, index, device="cpu")
    RECORDER.enable()
    try:
        diag, qo, _, _ = seeder.seed_chunk(pr, 0, pr.n)
    finally:
        RECORDER.disable()
    spans = RECORDER.spans()
    (seed,) = [s for s in spans if s[1] == "seeder.seed"]
    (splice,) = [s for s in spans if s[1] == "seeder.splice"]
    assert splice[3] == seed[0] and seed[5] <= splice[5] <= splice[6] <= \
        seed[6]
    assert splice[7]["bytes"] == diag.nbytes + qo.nbytes > 0
    assert 0 < seeder.stats["seed_device_s"] <= (splice[5] - seed[5]) * 1e-9


def test_seed_chunk_concurrent_calls(scratch, env):
    """seed_chunk runs from the CLI's prefetch threads: 24 calls on 12
    threads (more than the cores here) with a short switch interval return
    the hit rows of a lone call, and no stats update is lost."""
    import concurrent.futures as cf
    import sys
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    _, index = env
    aa, pr = _setup(scratch, index, "readsE_150bp.fastq", {})
    seeder = DeviceSeeder(aa, index, device="cpu")
    want = seeder.seed_chunk(pr, 0, pr.n)
    one = dict(seeder.stats)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cf.ThreadPoolExecutor(max_workers=12) as ex:
            outs = [f.result(timeout=120) for f in [
                ex.submit(seeder.seed_chunk, pr, 0, pr.n)
                for _ in range(24)]]
    finally:
        sys.setswitchinterval(old)
    for got in outs:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for key in ("seed_launches", "seed_h2d_bytes", "seed_d2h_bytes",
                "phantom_rows", "cap_retries"):
        assert seeder.stats[key] == 25 * one[key], key


@pytest.mark.parametrize("config", [{}, {"device_assembly": False,
                                         "rle": False}],
                         ids=["default", "ab"])
@pytest.mark.parametrize("qfile,over", CONFIGS, ids=CONFIG_IDS)
def test_staged_with_seeder_matches_native(scratch, env, qfile, over,
                                           config):
    """The engine with the device seeder on the CPU: SAM bytes, seed
    matches and records equal to the port's native engine; begin_s leaves
    out the seed phase, which the seeder's seed_device_s holds."""
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    from yaha_tpu_torch.models.staged import StagedAligner
    genome, index = env
    aa, pr = _setup(scratch, index, qfile, over)
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=2)
    seeder = DeviceSeeder(aa, index, device="cpu")
    st = StagedAligner(aa, genome, index, device="cpu", n_threads=2,
                       seeder=seeder, **config)
    text, sm, nr = st.align_chunk(pr, 0, pr.n)
    assert text == ref[0]
    assert (sm, nr) == (ref[2], ref[3])
    assert seeder.stats["seed_launches"] == 2
    assert 0 < seeder.stats["seed_device_s"]
    assert (st.stats["dp_launches"] > 0)


def test_cli_seed_device_cpu_matches_golden(scratch, monkeypatch):
    from yaha_tpu_torch import cli
    monkeypatch.chdir(scratch)
    rc = cli.main(["-x", INDEX, "-q", "readsA_100bp.fasta", "--engine",
                   "batch-cuda", "--seed", "device", "--device", "cpu",
                   "-osh", "seed_device.sam"])
    assert rc == 0

    def body(p):
        with open(p, "rb") as f:
            return [ln for ln in f.read().split(b"\n")
                    if not ln.startswith(b"@PG")]
    assert body(os.path.join(scratch, "seed_device.sam")) == body(
        os.path.join(GOLD, "A_default.sam"))


@pytest.mark.parametrize("qfile,over", CONFIGS, ids=CONFIG_IDS)
def test_seed_clumps_routing(scratch, env, qfile, over):
    """seed_clumps on the CPU (the clump kernel's plain version): a served
    row's record holds yt_hits_to_clumps' clumps of seed_chunk's hits for
    that row and the row carries no hits; every other row within a tier
    (phantom rows, the kernel's overflow) carries seed_chunk's hits; the
    totals are seed_chunk's; the stats and the seeder.seed span count the
    rows each way (params1kb: phantom and tier-2 fallback rows occur)."""
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    from yaha_tpu_torch.native import host as native
    from yaha_tpu_torch.utils.timing import RECORDER
    _, index = env
    aa, pr = _setup(scratch, index, qfile, over)
    d0, q0, o0, t0 = DeviceSeeder(aa, index, device="cpu").seed_chunk(
        pr, 0, pr.n)
    seeder = DeviceSeeder(aa, index, device="cpu")
    RECORDER.enable()
    try:
        d, q, o, t, recs, rec_offs = seeder.seed_clumps(pr, 0, pr.n)
    finally:
        RECORDER.disable()
    np.testing.assert_array_equal(t, t0)
    offs = np.ctypeslib.as_array(pr.seq_offs, shape=(pr.n + 1,))
    qlens = np.repeat(np.diff(offs), 2)
    served = rec_offs >= 0
    for r in range(len(t)):
        if served[r]:
            assert o[r + 1] == o[r]
            got = parse_clump_record(recs[rec_offs[r]:])
            c_offs, sqo, eqo, sro, matched, skipped = native.hits_to_clumps(
                d0[o0[r]:o0[r + 1]], q0[o0[r]:o0[r + 1]], int(qlens[r]), aa)
            want = (skipped, [(int(matched[k]), [
                (int(sqo[i]), int(eqo[i]), int(sro[i]))
                for i in range(c_offs[k], c_offs[k + 1])])
                for k in range(len(matched))])
            assert got == want, r
        elif t[r] >= 0:
            np.testing.assert_array_equal(d[o[r]:o[r + 1]],
                                          d0[o0[r]:o0[r + 1]])
            np.testing.assert_array_equal(q[o[r]:o[r + 1]],
                                          q0[o0[r]:o0[r + 1]])
    s = seeder.stats
    assert s["clump_rows"] == served.sum() > 0
    assert s["clump_host_rows"] == ((t >= 0) & ~served).sum()
    assert s["clump_host_rows"] >= s["phantom_rows"]
    assert s["clump_rows"] + s["clump_host_rows"] + s["fallback_rows"] == \
        len(t)
    (seed,) = [x for x in RECORDER.spans() if x[1] == "seeder.seed"]
    assert seed[7]["clump_rows"] == s["clump_rows"]
    assert seed[7]["clump_host_rows"] == s["clump_host_rows"]
    if qfile == "readsC_1kb.fasta":
        assert s["phantom_rows"] > 0 and s["fallback_rows"] > 0


def test_cli_seed_device_clumps_golden(scratch, monkeypatch, capsys):
    """The CLI with --seed device on the CPU writes the C_params golden
    (readsC at -BW 3 -G 20 -M 15 -X 15) with clumps made by the clump
    kernel's plain version for most rows, while phantom rows and tier-2
    fallback rows take the host path; -v reports the counts."""
    from yaha_tpu_torch import cli
    monkeypatch.chdir(scratch)
    rc = cli.main(["-x", INDEX, "-q", "readsC_1kb.fasta", "-BW", "3", "-G",
                   "20", "-M", "15", "-X", "15", "--engine", "batch-cuda",
                   "--seed", "device", "--device", "cpu", "-v", "-osh",
                   "seed_clumps.sam"])
    assert rc == 0
    err = capsys.readouterr().err

    def body(p):
        with open(p, "rb") as f:
            return [ln for ln in f.read().split(b"\n")
                    if not ln.startswith(b"@PG")]
    assert body(os.path.join(scratch, "seed_clumps.sam")) == body(
        os.path.join(GOLD, "C_params.sam"))
    import re
    m = re.search(r"(\d+) phantom rows, (\d+) host-scan rows.*clumps made on "
                  r"the device for (\d+) rows, (\d+) rows' hits to the host",
                  err, re.S)
    assert m, err[-2000:]
    phantom, scan, served, host_rows = (int(x) for x in m.groups())
    assert served > 0 and phantom > 0 and scan > 0
    assert host_rows >= phantom


def test_device_seeder_cuda_without_card_raises(env):
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    aa = host.AlignmentArgs()
    aa.post_process(True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSeeder(aa, env[1], device="cuda")
