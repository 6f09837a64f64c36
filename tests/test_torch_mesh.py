"""The port's local scale-out (yaha_tpu_torch/parallel/mesh.py) against the
JAX package's (yaha_tpu/parallel/mesh.py).

Every array is an integer array, so the comparisons are exact:

  * rebase_so on the golden L11 index and on the synthetic SO tables of
    tests/test_rebase_boundary.py (crossing 2^31, ending at 2^32 - 1),
    equal to the JAX function; a shard of 2^31 entries or more, which the
    JAX function refuses for its int32 gathers, is rebased (the port's
    local ROA offsets are 64-bit);
  * ShardedIndex on the golden index: the rebased SO, each shard's ROA
    slice, lengths, bases and hash ranges equal to the JAX one's;
  * sharded_expand_sort (on the CPU: the plain versions of the range-masked
    expansion and of the merge) against the JAX one on (data x model)
    meshes (1 x 2), (2 x 2) and (1 x 4) of the conftest's virtual CPU
    devices, diag, qo, total, overflow and wrapped, on the golden index's
    seed rows and the synthetic cases of tests/torch_dp_cases.py, and with
    ROA values near 2^32; the rows' hit prefixes equal to the
    single-device expand_sort_hits at capacity M C;
  * expand_sort_hits with the whole index as its one shard (hash_lo 0,
    per 4^wl) equal to the call without a shard, and merge_sorted_runs'
    plain version equal to a numpy lexsort;
  * DeviceSeeder(mesh=...) with StagedAligner(device="cpu"): seed rows
    equal to the single-device seeder's and SAM equal to the native
    engine's on readsA (default) and readsC at -BW 3 -G 20 -M 15 -X 15
    (phantom, tier-2 retry and host-scan rows);
  * the CLI's local grid for --model-shards.
"""
import gzip
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from conftest import DATA, GOLD
from torch_dp_cases import golden_index, seed_case
from yaha_tpu.parallel import mesh as jmesh
from yaha_tpu_torch.ops import seeds
from yaha_tpu_torch.parallel import mesh as tmesh

INDEX = "testgen.X11_01_65525S"
# (data, model) grids.
GRIDS = [(1, 2), (2, 2), (1, 4)]
GRID_IDS = ["1x2", "2x2", "1x4"]


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _synthetic_so(ht, total, seed=0, start=0):
    """tests/test_rebase_boundary.py's SO: nondecreasing uint32 over ht
    k-mers spanning [start, start + total)."""
    rng = np.random.default_rng(seed)
    w = rng.random(ht)
    counts = np.floor(w / w.sum() * total).astype(np.int64)
    counts[-1] += total - counts.sum()
    so = np.zeros(ht + 1, np.int64)
    np.cumsum(counts, out=so[1:])
    so += start
    assert so[-1] < (1 << 32)
    return so.astype(np.uint32)


REBASE_CASES = {
    "golden": lambda: golden_index()[2],
    "cross_2_31": lambda: _synthetic_so(1 << 12, 4_000_000,
                                        start=(1 << 31) - 1_000_000),
    "near_2_32": lambda: _synthetic_so(1 << 10, 5_000_000, seed=3,
                                       start=(1 << 32) - 5_000_001),
}


@pytest.mark.parametrize("n_model", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(REBASE_CASES))
def test_rebase_so_matches_jax(case, n_model):
    so = REBASE_CASES[case]()
    got = tmesh.rebase_so(so, n_model)
    want = jmesh.rebase_so(so, n_model)
    for g, w, name in zip(got, want, ("so_local", "bases", "lens")):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    so_local, bases, lens = got
    per = (len(so) - 1) // n_model
    np.testing.assert_array_equal(
        bases[:, None] + so_local.astype(np.int64),
        so.astype(np.int64)[np.arange(n_model)[:, None] * per +
                            np.arange(per + 1)[None, :]])


def test_rebase_so_takes_shards_past_2_31():
    """The JAX function refuses a shard of 2^31 entries or more (its
    device gathers index the local ROA with int32); the port's kernel and
    plain version index it with 64-bit offsets, so the shard is rebased."""
    so = np.array([0, 1 << 31, (1 << 31) + 10, (1 << 31) + 20,
                   (1 << 31) + 30], np.uint32)
    with pytest.raises(AssertionError):
        jmesh.rebase_so(so, 2)
    so_local, bases, lens = tmesh.rebase_so(so, 2)
    np.testing.assert_array_equal(lens, [(1 << 31) + 10, 20])
    np.testing.assert_array_equal(bases, [0, (1 << 31) + 10])
    np.testing.assert_array_equal(so_local, np.array(
        [[0, 1 << 31, (1 << 31) + 10], [0, 10, 20]], np.uint32))


@pytest.mark.parametrize("n_model", [0, -2, 3, 5])
def test_rebase_so_refuses_shards_that_do_not_divide(n_model):
    """A shard count below 1 or not dividing the hashes is a ValueError,
    also under python -O (no assert)."""
    so = np.arange(17, dtype=np.uint32)
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.rebase_so(so, n_model)


class _Index:
    """The golden L11 index as the ShardedIndex of either package takes
    it."""

    def __init__(self):
        self.word_len, self.max_hits, so, roa = golden_index()
        self.starting_offs = so.copy()
        self.roa = roa.copy()


@pytest.fixture(scope="module")
def gidx():
    return _Index()


@pytest.mark.parametrize("n_model", [2, 4])
def test_sharded_index_matches_jax(gidx, n_model):
    got = tmesh.ShardedIndex(gidx, n_model)
    want = jmesh.ShardedIndex(gidx, n_model)
    assert (got.n_model, got.per, got.word_len, got.max_hits) == (
        want.n_model, want.per, want.word_len, want.max_hits)
    np.testing.assert_array_equal(got.so_local, want.so_local)
    np.testing.assert_array_equal(got.roa_lens, want.roa_lens)
    np.testing.assert_array_equal(got.hash_lo, want.hash_lo)
    assert got.so_nbytes == want.so_nbytes
    for m in range(n_model):
        n = int(want.roa_lens[m])
        np.testing.assert_array_equal(got.roa_parts[m][:n],
                                      want.roa_sh[m, :n])
        assert len(got.roa_parts[m]) == max(n, 1)
        assert got.shard_nbytes(m) == (4 * (got.per + 1), 4 * max(n, 1))
    assert got.roa_nbytes == sum(4 * max(int(n), 1) for n in got.roa_lens)
    # Placed on a (2 x n_model) grid of one device: one copy a shard.
    got.place(tmesh.make_mesh(["cpu"] * 2 * n_model, n_model))
    assert sorted(m for _, m in got.tables) == list(range(n_model))
    assert got.so_local is None and got.roa_parts is None
    assert got.placed_nbytes() == got.so_nbytes + got.roa_nbytes


def _jax_run(so, roa, wl, max_hits, grid, hashes, clean, cap):
    """The JAX sharded_expand_sort on a (data x model) mesh of virtual CPU
    devices, the batch padded with rows of no clean window to a multiple of
    `data` (and cut back)."""
    n_data, n_model = grid

    class Idx:
        pass
    Idx.word_len, Idx.max_hits, Idx.starting_offs, Idx.roa = (
        wl, max_hits, so, roa)
    mesh = JaxMesh(np.array(jax.devices()[:n_data * n_model]).reshape(
        n_data, n_model), ("data", "model"))
    sidx = jmesh.ShardedIndex(Idx, n_model).place(mesh)
    b = hashes.shape[0]
    pad = -b % n_data
    out = jmesh.sharded_expand_sort(
        mesh, np.pad(hashes, ((0, pad), (0, 0))),
        np.pad(clean, ((0, pad), (0, 0))), sidx, max_hits=max_hits,
        capacity=cap)
    return {k: np.asarray(v)[:b] for k, v in out.items()}


def _torch_run(so, roa, wl, max_hits, grid, hashes, clean, cap):
    class Idx:
        pass
    Idx.word_len, Idx.max_hits, Idx.starting_offs, Idx.roa = (
        wl, max_hits, so, roa)
    mesh = tmesh.make_mesh(["cpu"] * grid[0] * grid[1], grid[1])
    assert mesh.shape == {"data": grid[0], "model": grid[1]}
    sidx = tmesh.ShardedIndex(Idx, grid[1]).place(mesh)
    return tmesh.sharded_expand_sort(mesh, _t(hashes), _t(clean), sidx,
                                     max_hits=max_hits, capacity=cap)


def _case_inputs(case):
    """(hashes, clean, SO, ROA, word length, max_hits, capacity)."""
    src, so, roa, max_hits, cap = seed_case(case)
    if src[0] == "rows":
        h, c = seeds.seed_hashes_reference(_t(src[1]), _t(src[2]),
                                           word_len=src[3])
        return h.numpy(), c.numpy(), so, roa, src[3], max_hits, cap
    wl = int(np.log2(len(so) - 1)) // 2
    return src[1], src[2], so, roa, wl, max_hits, cap


# The golden index's seed rows at C 64 (rows overflow a shard) and 1,024,
# the wrapped run, the unsigned-order edges and 650-hit runs in rows of
# three expansion batches.
MESH_CASES = ["golden64", "golden1024", "wrapped64", "unsigned16",
              "longrun1024"]


@pytest.mark.parametrize("case", MESH_CASES)
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_sharded_expand_sort_matches_jax(grid, case):
    hashes, clean, so, roa, wl, max_hits, cap = _case_inputs(case)
    got = _torch_run(so, roa, wl, max_hits, grid, hashes, clean, cap)
    want = _jax_run(so, roa, wl, max_hits, grid, hashes, clean, cap)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].numpy()
        if key == "diag":
            g = g.view(np.uint32)
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    # The hit prefix of every row that no shard overflowed is the
    # single-device expansion's at capacity M C.
    m = grid[1]
    one = seeds.expand_sort_hits(_t(hashes), _t(clean), _t(so), _t(roa),
                                 max_hits=max_hits, capacity=m * cap)
    ok = ~got["overflow"].numpy()
    # The wrapped case's one row (122 hits) is all in shard 0.
    assert ok.any() != (case == "wrapped64")
    tot = got["total"].numpy()
    np.testing.assert_array_equal(tot[ok], one["total"].numpy()[ok])
    for r in np.flatnonzero(ok):
        for key in ("diag", "qo"):
            np.testing.assert_array_equal(got[key][r, :tot[r]].numpy(),
                                          one[key][r, :tot[r]].numpy())
        np.testing.assert_array_equal(got["wrapped"][r].numpy(),
                                      one["wrapped"][r].numpy())
    if case == "golden64":
        assert got["overflow"].any()


@pytest.mark.parametrize("grid", [(2, 2)], ids=["2x2"])
def test_sharded_lookup_ref_offsets_near_2_32(grid):
    """tests/test_rebase_boundary.py's sharded lookup with ROA values near
    2^32 (diag wrapping both ways): equal to the JAX function."""
    ht = 256
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 6, ht)
    so = np.zeros(ht + 1, np.uint32)
    so[1:] = np.cumsum(counts).astype(np.uint32)
    total = int(so[-1])
    roa = ((1 << 32) - 1 - rng.integers(0, 5000, total)).astype(np.uint32)
    small = rng.random(total) < 0.2
    roa[small] = rng.integers(0, 50, int(small.sum())).astype(np.uint32)
    b, n = 4, 16
    hashes = rng.integers(0, ht, (b, n)).astype(np.int32)
    clean = rng.random((b, n)) < 0.8
    got = _torch_run(so, roa, 4, 650, grid, hashes, clean, 64)
    want = _jax_run(so, roa, 4, 650, grid, hashes, clean, 64)
    for key, w in want.items():
        g = got[key].numpy()
        np.testing.assert_array_equal(g.view(np.uint32) if key == "diag"
                                      else g, w, err_msg=key)
    assert (got["total"].numpy() > 0).all()


@pytest.mark.parametrize("case", ["golden1024", "unsigned8", "longrun1024"])
def test_expand_sort_whole_index_as_one_shard(case):
    """hash_lo 0 with per 4^wl is the call without a shard."""
    hashes, clean, so, roa, _, max_hits, cap = _case_inputs(case)
    args = (_t(hashes), _t(clean), _t(so), _t(roa))
    kw = dict(max_hits=max_hits, capacity=cap)
    got = seeds.expand_sort_hits(*args, hash_lo=0, per=len(so) - 1, **kw)
    want = seeds.expand_sort_hits(*args, **kw)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _sorted_runs(seed, m, b, c):
    """[m, b, c] rows of (diag, qo) sorted by (diag uint32, qo) with the
    sentinel past each row's valid count: diag >= 2^31 and 0xFFFFFFFF
    beside the sentinel, and equal keys across runs."""
    rng = np.random.default_rng(seed)
    diag = np.full((m, b, c), 0xFFFFFFFF, np.uint32)
    qo = np.full((m, b, c), 0x7FFFFFFF, np.int32)
    pool_d = np.concatenate([rng.integers(0, 1 << 32, 40, dtype=np.uint64),
                             [0, 1, (1 << 31) - 1, 1 << 31, 0xFFFFFFFF,
                              0xFFFFFFFF]]).astype(np.uint32)
    for k in range(m):
        for r in range(b):
            v = int(rng.integers(0, c + 1)) if r else c
            d = rng.choice(pool_d, v)
            q = rng.integers(0, 50, v).astype(np.int32)
            o = np.lexsort((q, d.astype(np.int64)))
            diag[k, r, :v], qo[k, r, :v] = d[o], q[o]
    return diag, qo


@pytest.mark.parametrize("m,c", [(1, 8), (2, 16), (3, 32), (4, 64)])
def test_merge_sorted_runs_plain_matches_lexsort(m, c):
    diag, qo = _sorted_runs(m, m, 9, c)
    got_d, got_q = seeds.merge_sorted_runs(_t(diag), _t(qo))
    d = diag.transpose(1, 0, 2).reshape(9, m * c)
    q = qo.transpose(1, 0, 2).reshape(9, m * c)
    o = np.lexsort((q, d.astype(np.int64)), axis=1)
    np.testing.assert_array_equal(got_d.numpy().view(np.uint32),
                                  np.take_along_axis(d, o, 1))
    np.testing.assert_array_equal(got_q.numpy(), np.take_along_axis(q, o, 1))


# ---- the seeder and the engine ----

@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mesh")
    for f in ("readsA_100bp.fasta", "readsC_1kb.fasta"):
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
    with open(os.path.join(scratch, qfile), "rb") as f:
        data = f.read()
    aa.fastq = False
    return aa, host.parse_queries_native(data, False, aa.max_query_length,
                                         aa.word_len)


READ_SETS = [("readsA_100bp.fasta", {}),
             ("readsC_1kb.fasta", {"band_width": 3, "max_gap": 20,
                                   "min_match": 15, "x_cutoff": 15})]


def same_rows(got, want):
    """Hold two seeders' rows (diag, qo, offs, totals) equal wherever
    both serve the row on the device (totals >= 0); returns that mask."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
    both = (got[3] >= 0) & (want[3] >= 0)
    np.testing.assert_array_equal(got[3][both], want[3][both])
    for r in np.flatnonzero(both):
        for k in (0, 1):
            np.testing.assert_array_equal(
                got[k][got[2][r]:got[2][r + 1]],
                want[k][want[2][r]:want[2][r + 1]])
    return both


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("qfile,over", READ_SETS, ids=["A", "C_params"])
def test_sharded_seeder_matches_native(scratch, env, qfile, over, grid):
    """The seeder on a grid of the CPU: its seed rows equal the
    single-device seeder's, array for array, and the engine's SAM the
    native engine's."""
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    from yaha_tpu_torch.models.staged import StagedAligner
    genome, index = env
    aa, pr = _setup(scratch, index, qfile, over)
    mesh = tmesh.make_mesh(["cpu"] * grid[0] * grid[1], grid[1])
    seeder = DeviceSeeder(aa, index, mesh=mesh)
    one = DeviceSeeder(aa, index, device="cpu")
    got = seeder.seed_chunk(pr, 0, pr.n)
    want = one.seed_chunk(pr, 0, pr.n)
    both = same_rows(got, want)
    # A row overflows a tier only where a shard passes C, so M C hits can
    # stay on the device: rows the single device sends to the host scan
    # (totals -1) may be served here, and never the other way round.
    assert both.sum() == (want[3] >= 0).sum()
    s = seeder.stats
    assert s["fallback_rows"] <= one.stats["fallback_rows"]
    # Tier 1's merge takes M [rows, 1,024] buffers of diag and qo, tier 2's
    # M [retried rows, 8,192].
    tier1 = 2 * 4 * grid[1] * 2 * pr.n * seeder.CAP_TIERS[0]
    assert s["all_gather_bytes"] > tier1 if s["cap_retries"] else (
        s["all_gather_bytes"] == tier1)
    assert one.stats["all_gather_bytes"] == 0
    if over:
        # Phantom and tier-2 rows; the host-scan rows of one device (over
        # 8,192 hits) fit in M 8,192 slots here.
        assert s["phantom_rows"] and s["cap_retries"]
        assert one.stats["fallback_rows"] > s["fallback_rows"]
    ref = host.align_batch_native(pr, 0, pr.n, genome, index, aa,
                                  n_threads=2)
    seeder = DeviceSeeder(aa, index, mesh=mesh)
    st = StagedAligner(aa, genome, index, device=mesh.grid[0][0],
                       n_threads=2, seeder=seeder)
    text, sm, nr = st.align_chunk(pr, 0, pr.n)
    assert text == ref[0]
    assert (sm, nr) == (ref[2], ref[3])


def test_make_mesh_shapes():
    m = tmesh.make_mesh(["cpu"] * 6, 2)
    assert m.shape == {"data": 3, "model": 2}
    m = tmesh.make_mesh(["cuda:0", "cuda:1"], 4)
    assert m.shape == {"data": 1, "model": 4}
    assert [str(d) for d in m.grid[0]] == ["cuda:0", "cuda:1", "cuda:0",
                                           "cuda:1"]
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_mesh(["cpu"] * 3, 2)


def test_cli_local_mesh():
    """--model-shards N over n local devices: data = max(1, n // N); more
    devices than N must be a multiple; fewer share the shards."""
    from yaha_tpu_torch import cli
    assert cli.local_mesh("cpu", 2).shape == {"data": 1, "model": 2}
    m = cli.local_mesh("cuda", 2, n_local=4)
    assert m.shape == {"data": 2, "model": 2}
    assert [[str(d) for d in r] for r in m.grid] == [
        ["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]
    m = cli.local_mesh("cuda", 4, n_local=1)
    assert m.shape == {"data": 1, "model": 4}
    assert {str(d) for d in m.grid[0]} == {"cuda:0"}
    with pytest.raises(SystemExit):
        cli.local_mesh("cuda", 2, n_local=3)
