"""The port's oracle engine (--engine oracle, yaha_tpu_torch/core/) on the
CPU.

  * the port's CLI with --engine oracle on the 21 cases of
    tests/test_sam_parity.py, each output byte-equal to its golden apart
    from @PG;
  * the same 21 cases in this process with the pure-Python paths forced
    (core.sw._NATIVE = False: the Python DP; core.chain._NATIVE_CHAIN =
    None: the Python seed scan, fragments, region split and chain DP);
  * module checks against the JAX package on numpy-seeded inputs: the
    Marsaglia RNG's streams, rand_sample and query seeds; seed_hits and
    find_fragments on the golden reads, both strands; the vectorized
    chain DP against the port's native chain_dp; _find_affine_gap_score
    against yaha_tpu.core.sw's (anchored banded and full, extension, each
    forward and reverse), and the native delegations of core/sw.py
    against the Python DP;
  * --max-region-frags 100 on tests/test_region_valve.py's tandem read:
    the oracle and the native engine both report the two skipped regions
    and write equal SAM;
  * a -qs file equal to the JAX oracle's apart from the usec column.
"""
import gzip
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import DATA, GOLD
from test_sam_parity import CASES

from yaha_tpu_torch import cli
from yaha_tpu_torch.config import AlignmentArgs
from yaha_tpu_torch.core import chain, frags, sw
from yaha_tpu_torch.io import fasta, index_io
from yaha_tpu_torch.native import host
from yaha_tpu_torch.utils import rng as port_rng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INDEX = "testgen.X11_01_65525S"
M32 = 0xFFFFFFFF
CASE_IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    d = tmp_path_factory.mktemp("oracle")
    for f in os.listdir(DATA):
        shutil.copy(os.path.join(DATA, f), d)
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), d)
    for idx in (INDEX, "testgen.X11_01_00020S"):
        with gzip.open(os.path.join(GOLD, idx + ".gz")) as f:
            with open(os.path.join(d, idx), "wb") as out:
                out.write(f.read())
    return str(d)


def _body(path):
    with open(path, "rb") as f:
        return [ln for ln in f.read().split(b"\n")
                if not ln.startswith(b"@PG")]


def _run(scratch, module, args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", module] + args,
                          cwd=scratch, env=env, capture_output=True,
                          timeout=600)


def _aa(**over):
    aa = AlignmentArgs()
    aa.xfile_name, aa.qfile_name, aa.ofile_name = INDEX, "q", "o"
    for k, v in over.items():
        setattr(aa, k, v)
    aa.post_process(True)
    return aa


def _no_native(name):
    def call(*args, **kw):
        raise AssertionError("the forced Python path called host.%s" % name)
    return call


@pytest.mark.parametrize("out_name,reads,idx,args", CASES, ids=CASE_IDS)
def test_oracle_cli_matches_golden(scratch, out_name, reads, idx, args):
    out = "oracle_" + out_name
    r = _run(scratch, "yaha_tpu_torch.cli",
             ["-x", idx, "-q", reads, "--engine", "oracle"] + args + [out])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert _body(os.path.join(scratch, out)) == _body(
        os.path.join(GOLD, out_name))


@pytest.mark.parametrize("out_name,reads,idx,args", CASES, ids=CASE_IDS)
def test_oracle_pure_python_matches_golden(scratch, monkeypatch, out_name,
                                           reads, idx, args):
    monkeypatch.setattr(sw, "_NATIVE", False)
    monkeypatch.setattr(chain, "_NATIVE_CHAIN", None)
    for name in ("anchored_forward", "extension_forward", "chain_dp",
                 "seed_to_clumps", "frags_to_clumps"):
        monkeypatch.setattr(host, name, _no_native(name))
    monkeypatch.chdir(scratch)
    out = "pure_" + out_name
    assert cli.main(["-x", idx, "-q", reads, "--engine", "oracle"] + args +
                    [out]) == 0
    assert _body(os.path.join(scratch, out)) == _body(
        os.path.join(GOLD, out_name))


def test_golden_cases_copy_matches_sam_parity():
    """chip_smoke.py phase 11 runs torch_dp_cases' copy of the cases."""
    from torch_dp_cases import GOLDEN_CASES
    assert GOLDEN_CASES == CASES


# ---- module checks against the JAX package ----

def test_rand_state_streams_match_jax():
    from yaha_tpu.utils import rng as jax_rng
    gen = np.random.default_rng(14)
    for _ in range(8):
        state = [int(x) for x in gen.integers(0, 1 << 32, 5)]
        a, b = port_rng.RandState(state), jax_rng.RandState(state)
        assert [a.rand_bits() for _ in range(500)] == \
            [b.rand_bits() for _ in range(500)]
        assert [a.rand_uint(3, 1000) for _ in range(100)] == \
            [b.rand_uint(3, 1000) for _ in range(100)]
        codes = gen.integers(0, 16, int(gen.integers(1, 120))).astype(
            np.uint8)
        assert port_rng.query_seed_state(codes, len(codes)) == \
            jax_rng.query_seed_state(codes, len(codes))


def test_rand_sample_matches_jax():
    """Both of the modified Floyd's branches (keep the marked, or drop
    them), with the state flowing from one sample to the next."""
    from yaha_tpu.utils import rng as jax_rng
    gen = np.random.default_rng(15)
    a, b = port_rng.RandState.default(), jax_rng.RandState.default()
    for _ in range(40):
        n = int(gen.integers(1, 300))
        inp = np.sort(gen.integers(0, 1 << 32, n, dtype=np.uint64)).astype(
            np.uint32)
        k = int(gen.integers(0, n + 1))
        got, want = a.rand_sample(inp, k), b.rand_sample(inp, k)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert len(got) == k
    assert a.s == b.s


@pytest.fixture(scope="module")
def indexes(scratch):
    from yaha_tpu.io import index_io as jax_index_io
    path = os.path.join(scratch, INDEX)
    return index_io.load_index(path), jax_index_io.load_index(path)


@pytest.mark.parametrize("reads", ["readsC_1kb.fasta", "readsD_sv.fasta",
                                   "readsF_edge.fasta"])
def test_seed_hits_and_fragments_match_jax(indexes, reads):
    from yaha_tpu.core import frags as jax_frags
    index, jax_index = indexes
    aa = _aa()
    aa.word_len = index.word_len
    with open(os.path.join(DATA, reads), "rb") as f:
        recs = list(fasta.read_queries(f.read(), aa))
    assert recs
    n_frags = 0
    for rec in recs:
        for codes in (rec.forward_codes, rec.reverse_codes):
            got = frags.seed_hits(codes, index, aa.max_hits)
            want = jax_frags.seed_hits(codes, jax_index, aa.max_hits)
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
            got_f = frags.find_fragments(*got, index.roa, index.word_len)
            want_f = jax_frags.find_fragments(*want, jax_index.roa,
                                              jax_index.word_len)
            assert [(f.sqo, f.eqo, f.sro, f.ref_len) for f in got_f] == \
                [(f.sqo, f.eqo, f.sro, f.ref_len) for f in want_f]
            n_frags += len(got_f)
    assert n_frags > 0


def _chain_nodes(gen, n, aa, ties):
    """Chain nodes of numpy-seeded fragments, sorted by (SQO, diag) as
    build_best_clump sorts them; diagonals near 0 or wrapping past 2^32,
    and with `ties` equal lengths on a few diagonals (dense equal
    scores)."""
    sqo = gen.integers(0, 4 * n, n)
    length = np.full(n, 16) if ties else gen.integers(8, 40, n)
    base = int(gen.choice([3, M32 - 40]))
    step = 10 if ties else 1
    diag = (base + step * gen.integers(0, 80 // step, n)) & M32
    nodes = [chain._Node(frags.Fragment(
        sqo=int(s), eqo=int(s + l - 1), sro=int((d + s) & M32),
        ref_len=int(l)), aa) for s, l, d in zip(sqo, length, diag)]
    nodes.sort(key=lambda nd: (nd.sqo, nd.diag))
    return nodes


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("n", [24, 64, 300])
def test_vectorized_chain_dp_matches_native(n, ties):
    gen = np.random.default_rng(n + 7 * ties)
    for over in ({}, {"max_gap": 12, "max_desert": 30}, {"m_score": 2}):
        aa = _aa(**over)
        for _ in range(4):
            nodes = _chain_nodes(gen, n, aa, ties)
            best = chain._chain_dp_vectorized(aa, nodes)
            prev = [nodes.index(nd.best_prev) if nd.best_prev is not None
                    else -1 for nd in nodes]
            want = host.chain_dp(
                [nd.sqo for nd in nodes], [nd.eqo for nd in nodes],
                [nd.diag for nd in nodes], [nd.node_length for nd in nodes],
                max_gap=aa.max_gap, max_desert=aa.max_desert,
                m_score=aa.m_score, go_cost=aa.go_cost, ge_cost=aa.ge_cost)
            assert nodes.index(best) == want[0]
            assert prev == want[2].tolist()


def _dp_case(gen, ql, rl, err):
    """q and r of related codes: r is q with substitutions at `err` and a
    few one-base indels, cut or padded to rl."""
    q = gen.integers(0, 4, ql).astype(np.uint8)
    r = list(q)
    for _ in range(int(gen.integers(0, 3))):
        p = int(gen.integers(0, max(1, len(r) - 1)))
        if gen.random() < 0.5:
            del r[p]
        else:
            r.insert(p, int(gen.integers(0, 4)))
    r = np.array(r[:rl] + list(gen.integers(0, 4, max(0, rl - len(r)))),
                 np.uint8)
    sub = gen.random(rl) < err
    r[sub] = gen.integers(0, 4, int(sub.sum()))
    return q, r


def _dp_args(mod, gen, banded, extension, reverse, aa):
    """The arguments of _find_affine_gap_score for one problem, in `mod`'s
    own view classes: anchored problems of QL 5-40 against RL within 6 of
    it; extensions of QL 5-40 against QL + 2 BW reference bases; reverse
    ones index their query backwards from its last code (q[1 - i])."""
    ql = int(gen.integers(5, 41))
    if extension:
        rl = ql + 2 * aa.band_width
    else:
        rl = max(1, ql + int(gen.integers(-6, 7)))
    q, r = _dp_case(gen, ql, rl, float(gen.choice([0.0, 0.1, 0.3])))
    if reverse:
        qv = mod._LenWrap(mod._RevView(q[::-1].copy(), ql - 1), ql)
        r = r[::-1].copy()
    else:
        qv = mod._LenWrap(q, ql)
    return qv, r


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("banded,extension", [
    (True, False), (False, False), (True, True)],
    ids=["banded", "full", "extension"])
def test_affine_gap_dp_matches_jax(banded, extension, reverse):
    from yaha_tpu.core import sw as jax_sw
    for k, over in enumerate(({}, {"band_width": 3, "x_cutoff": 15},
                              {"max_gap": 2, "max_intron": 3},
                              {"m_score": 2, "r_cost": 4, "go_cost": 6,
                               "ge_cost": 1})):
        aa = _aa(**over)
        for j in range(25):
            seed = 1000 * k + j
            q, r = _dp_args(sw, np.random.default_rng(seed), banded,
                            extension, reverse, aa)
            jq, jr = _dp_args(jax_sw, np.random.default_rng(seed), banded,
                              extension, reverse, aa)
            got = sw._find_affine_gap_score(aa, q, r, banded, extension,
                                            reverse, extension,
                                            aa.band_width)
            want = jax_sw._find_affine_gap_score(aa, jq, jr, banded,
                                                 extension, reverse,
                                                 extension, aa.band_width)
            assert got == want


def test_native_delegation_matches_python_dp(monkeypatch):
    """core/sw.py's wrappers give the same score, items and added lengths
    through the native host DPs as through the Python DP."""
    gen = np.random.default_rng(21)
    genome = gen.integers(0, 4, 4000).astype(np.uint8)
    for over in ({}, {"band_width": 3, "x_cutoff": 15},
                 {"max_gap": 2, "max_intron": 3}):
        aa = _aa(**over)
        for _ in range(30):
            ql = int(gen.integers(5, 60))
            r_off = int(gen.integers(100, 3800))
            rl = max(1, ql + int(gen.integers(-8, 9)))
            q, _ = _dp_case(gen, ql, rl, 0.1)
            qc = np.concatenate([gen.integers(0, 4, 70).astype(np.uint8),
                                 genome[r_off:r_off + ql] if gen.random()
                                 < 0.5 else q,
                                 gen.integers(0, 4, 70).astype(np.uint8)])
            outs = []
            for native in (None, False):
                monkeypatch.setattr(sw, "_NATIVE", native)
                res = []
                for banded in (True, False):
                    lst = sw.EditOpList()
                    res.append((sw.find_ags_alignment(
                        aa, genome, r_off, rl, qc, 70, ql, lst, banded),
                        lst.items))
                for reverse, qo, ro in ((False, 70, r_off),
                                        (True, 70 + ql - 1, r_off + ql)):
                    lst = sw.EditOpList([["M", 3]])
                    res.append((sw.find_ags_extension(
                        aa, genome, len(genome), ro, qc, qo, ql,
                        lst, reverse), lst.items))
                outs.append(res)
            assert outs[0] == outs[1]


# ---- the valve and -qs ----

def test_region_valve_oracle_and_native(tmp_path):
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), tmp_path)
    with gzip.open(os.path.join(GOLD, INDEX + ".gz")) as f:
        (tmp_path / INDEX).write_bytes(f.read())
    # tests/test_region_valve.py's read: 200 tandem copies of a genome
    # 20-mer, all fragments in one region a strand.
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_testdata as mt
    g = mt.make_genome(random.Random(20260816))
    unit = g[sorted(g)[0]][5000:5020]
    (tmp_path / "tandem.fasta").write_text(">tandem_read\n%s\n" % (
        unit * 200))
    bodies = {}
    for engine in ("oracle", "native"):
        out = "valve_%s.sam" % engine
        r = _run(str(tmp_path), "yaha_tpu_torch.cli",
                 ["-x", INDEX, "-q", "tandem.fasta", "--engine", engine,
                  "--max-region-frags", "100", "-osh", out])
        assert r.returncode == 0, r.stderr.decode()[-1500:]
        assert b"skipped 2 fragment region(s)" in r.stderr, r.stderr
        bodies[engine] = _body(str(tmp_path / out))
    assert bodies["oracle"] == bodies["native"]
    assert len([ln for ln in bodies["oracle"] if ln[:1] != b"@"]) > 0


@pytest.mark.parametrize("reads,args", [
    ("readsD_sv.fasta", ["-osh"]), ("readsE_150bp.fastq", ["-FBS", "Y",
                                                           "-oss"])],
    ids=["D", "E_fbs"])
def test_query_stats_match_jax_oracle(scratch, reads, args):
    rows = {}
    for module in ("yaha_tpu_torch.cli", "yaha_tpu.cli"):
        qs = "%s_%s.qs" % (module.split(".")[0], reads)
        r = _run(scratch, module,
                 ["-x", INDEX, "-q", reads, "--engine", "oracle", "-qs", qs] +
                 args + ["qs_%s.sam" % module.split(".")[0]])
        assert r.returncode == 0, r.stderr.decode()[-1500:]
        with open(os.path.join(scratch, qs)) as f:
            rows[module] = [ln.rstrip("\n").split("\t")
                            for ln in f.readlines()]
    port, ref = rows["yaha_tpu_torch.cli"], rows["yaha_tpu.cli"]
    assert port[0] == ref[0] == ["query", "len", "seedMatches",
                                 "alignments", "usec"]
    assert len(port) == len(ref) > 1
    assert [p[:4] for p in port] == [q[:4] for q in ref]
    assert all(p[4].isdigit() for p in port[1:])
