"""The port's staged engine and CLI (yaha_tpu_torch) against the JAX package.

With --device cpu the DP phases run the kernels' plain PyTorch versions,
and inline_small=False sends every gap fill and extension through them.
The default configuration assembles every problem on the device and walks
the planes there (FMT_RLE items); the A/B configurations fetch problems on
the host and/or bring the planes back to the native walkers.
The "torch" backend (the lockstep DPs of ops/sw_batch.py, --engine
batch-torch) and the "native" one (the native library's batched host DPs)
return eo/idc planes (FMT_EOIDC) to the native apply, with and without the
device seeder.
The SAM bytes must equal the JAX package's per-read native C++ engine's
(yaha_tpu.native.host.align_batch_native; the port runs its own copy of
that library), and the CLI must reproduce the golden SAM files of
tests/golden (ignoring @PG lines, which embed paths) with each engine
(batch-cuda and batch-torch on --device cpu, native) and under --trace.
The CLI must not import jax or anything of the JAX package, must load its
native library from yaha_tpu_torch/_build, and must fail on --device cuda
without a card.
The port's -g / -c / -u operations must write the golden .nib2, FASTA and
index files byte for byte.
"""
import gzip
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import DATA, GOLD
from torch_dp_cases import indel_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INDEX = "testgen.X11_01_65525S"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_staged")
    for f in ("readsA_100bp.fasta", "readsC_1kb.fasta", "readsD_sv.fasta",
              "readsE_150bp.fastq", "readsF_edge.fasta"):
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


def _aa(index, qfile, over):
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
    return aa


def _parity(env, aa, data, n_max=None, **config):
    """Align through the port's engine on the CPU; assert byte parity with
    the JAX package's native engine and return the engine's stats."""
    from yaha_tpu.native import host as jax_host
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.staged import StagedAligner
    genome, index = env
    aa.fastq = data[:1] == b"@"
    pr = host.parse_queries_native(data, aa.fastq, aa.max_query_length,
                                   aa.word_len)
    n = pr.n if n_max is None else min(pr.n, n_max)
    ref, _, sm0, nr0 = jax_host.align_batch_native(pr, 0, n, genome, index,
                                                   aa, n_threads=2)
    st = StagedAligner(aa, genome, index, device="cpu", n_threads=2,
                       inline_small=False, **config)
    text, sm, nr = st.align_chunk(pr, 0, n)
    assert text == ref
    assert (sm, nr) == (sm0, nr0)
    return st.stats


CONFIGS = [
    ("readsA_100bp.fasta", {}, None),
    ("readsD_sv.fasta", {"fbs": True}, None),
    ("readsE_150bp.fastq", {}, None),
    ("readsF_edge.fasta", {}, None),
    ("readsC_1kb.fasta", {"band_width": 3, "max_gap": 20, "min_match": 15,
                          "x_cutoff": 15}, 6),
]


@pytest.mark.parametrize("qfile,over,n_max", CONFIGS,
                         ids=["A_default", "D_fbs", "E_fastq", "F_edge",
                              "C_params"])
def test_staged_cpu_matches_native(scratch, env, qfile, over, n_max):
    aa = _aa(env[1], qfile, over)
    with open(os.path.join(scratch, qfile), "rb") as f:
        stats = _parity(env, aa, f.read(), n_max)
    assert stats["ext_problems"] > 0 and stats["gap_problems"] > 0
    assert stats["gap_banded"] > 0
    assert stats["plane_d2h_bytes"] == 0


@pytest.mark.parametrize("seeded", [False, True],
                         ids=["host_seed", "device_seed"])
@pytest.mark.parametrize("backend", ["torch", "native"])
@pytest.mark.parametrize("qfile,over,n_max", [CONFIGS[0], CONFIGS[4]],
                         ids=["A_default", "C_params"])
def test_staged_eoidc_backends_match_native(scratch, env, qfile, over,
                                            n_max, backend, seeded):
    """StagedAligner(backend="torch" | "native"): every gap fill and
    extension through the lockstep twins on the CPU (problems assembled on
    the device) or the native host DPs (problems fetched on the host), the
    eo/idc planes to the native apply; with the host seed scan and with
    the device seeder."""
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    aa = _aa(env[1], qfile, over)
    seeder = DeviceSeeder(aa, env[1], device="cpu") if seeded else None
    with open(os.path.join(scratch, qfile), "rb") as f:
        stats = _parity(env, aa, f.read(), n_max, backend=backend,
                        seeder=seeder)
    assert stats["dp_launches"] > 0
    assert stats["gap_problems"] > 0 and stats["ext_problems"] > 0
    assert (stats["plane_d2h_bytes"] > 0) == (backend == "torch")


def test_staged_backend_checks(env):
    """An unknown backend is refused; the "torch" backend on --device cuda
    without a card stops with an error."""
    from yaha_tpu_torch.models.staged import StagedAligner
    genome, index = env
    aa = _aa(index, "readsA_100bp.fasta", {})
    with pytest.raises(ValueError, match="backend"):
        StagedAligner(aa, genome, index, device="cpu", backend="xla")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StagedAligner(aa, genome, index, device="cuda", backend="torch")


@pytest.mark.parametrize("device_assembly,rle", [
    (False, False), (True, False), (False, True),
], ids=["host_fetch_planes", "device_assembly_planes", "host_fetch_rle"])
def test_staged_cpu_ab_configurations_match_native(scratch, env,
                                                   device_assembly, rle):
    """The A/B configurations (host fetch with u8 uploads, plane transfer
    to the native walkers) stay byte-identical too."""
    with open(os.path.join(scratch, "readsA_100bp.fasta"), "rb") as f:
        stats = _parity(env, _aa(env[1], "readsA_100bp.fasta", {}), f.read(),
                        device_assembly=device_assembly, rle=rle)
    assert (stats["plane_d2h_bytes"] > 0) == (not rle)


def _fetch_recorder():
    """A StagedAligner whose device gathers also fetch the same bucket on
    the host (yt_batch_*_fetch) and record whether the planes agree."""
    import numpy as np
    from yaha_tpu_torch.models.staged import StagedAligner, _p64, _pu8

    class FetchCheck(StagedAligner):
        checked = []

        def _meta2(self, ctx, n, fn):
            self._ctx = ctx
            return super()._meta2(ctx, n, fn)

        def _mk_gather(self, rows2, meta2, idx, qlen, rlen, rev, rpad, qg,
                       rg):
            g = super()._mk_gather(rows2, meta2, idx, qlen, rlen, rev, rpad,
                                   qg, rg)

            def check(mpad, pack):
                q, r = g(mpad, pack)
                qa = np.zeros((len(idx), qg), np.uint8)
                ra = np.full((len(idx), rg), rpad, np.uint8)
                fetch = (self.lib.yt_batch_ext_fetch if rev is not None
                         else self.lib.yt_batch_gap_fetch)
                fetch(self._ctx, len(idx), _p64(idx), _pu8(qa), qg, _pu8(ra),
                      rg)
                self.checked.append((rev is not None, len(idx),
                                     np.array_equal(q.numpy(), qa),
                                     np.array_equal(r.numpy(), ra)))
                return q, r
            return check
    return FetchCheck


@pytest.mark.parametrize("qfile,over", [
    ("readsD_sv.fasta", {"fbs": True}),
    ("readsC_1kb.fasta", {"band_width": 3, "max_gap": 20, "min_match": 15,
                          "x_cutoff": 15}),
], ids=["D_fbs", "C_params"])
def test_device_planes_equal_host_fetch(scratch, env, qfile, over):
    """Planes assembled on the device from the native meta2 coordinates
    equal the host fetch planes, bucket by bucket, for gap fills and for
    extensions in both directions."""
    from yaha_tpu_torch import host
    genome, index = env
    aa = _aa(index, qfile, over)
    with open(os.path.join(scratch, qfile), "rb") as f:
        pr = host.parse_queries_native(f.read(), False, aa.max_query_length,
                                       aa.word_len)
    st = _fetch_recorder()(aa, genome, index, device="cpu", n_threads=2,
                           inline_small=False)
    st.align_chunk(pr, 0, min(pr.n, 8))
    assert st.checked
    assert all(q_ok and r_ok for _, _, q_ok, r_ok in st.checked)
    assert {ext for ext, _, _, _ in st.checked} == {False, True}


def test_walk_overflow_raises(env):
    """A walk that needs more items than its cap (n_ops = -1) stops the
    engine instead of applying a truncated edit list."""
    from yaha_tpu_torch.models.staged import StagedAligner
    genome, index = env
    st = StagedAligner(_aa(index, "readsA_100bp.fasta", {}), genome, index,
                       device="cpu")
    score = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="cap=8"):
        st._rle_items(torch.zeros((2, 8), dtype=torch.int32),
                      torch.tensor([2, -1], dtype=torch.int32), [score], 8)


def test_staged_cpu_full_width_gap_kernel(env, monkeypatch):
    """Reads with indels route gap buckets to the full-width kernel, and a
    small launch-byte bound slices every bucket into several launches;
    the SAM bytes still equal the native engine's."""
    from yaha_tpu_torch.models import staged
    monkeypatch.setattr(staged, "MAX_LAUNCH_BYTES", 1 << 20)
    stats = _parity(env, _aa(env[1], "indel.fasta", {}),
                    indel_reads(os.path.join(DATA, "testgen.fasta"), 60,
                                5))
    assert stats["gap_full"] > 0
    assert stats["dp_launches"] > 10


GOLDENS = [
    ("A_default.sam", "readsA_100bp.fasta", []),
    ("D_fbs.sam", "readsD_sv.fasta", ["-FBS", "Y"]),
    ("E_fastq.sam", "readsE_150bp.fastq", []),
    ("F_edge.sam", "readsF_edge.fasta", []),
]


def _strip_pg(path):
    with open(path, "rb") as f:
        return [ln for ln in f.read().split(b"\n")
                if not ln.startswith(b"@PG")]


@pytest.mark.parametrize("gold,qfile,flags", GOLDENS,
                         ids=[g[0][:-4] for g in GOLDENS])
def test_cli_cpu_matches_golden(scratch, monkeypatch, gold, qfile, flags):
    from yaha_tpu_torch import cli
    monkeypatch.chdir(scratch)
    out = "torch_" + gold
    rc = cli.main(["-x", INDEX, "-q", qfile, "--engine", "batch-cuda",
                   "--device", "cpu"] + flags + ["-osh", out])
    assert rc == 0
    assert _strip_pg(os.path.join(scratch, out)) == _strip_pg(
        os.path.join(GOLD, gold))


C_FLAGS = ["-BW", "3", "-G", "20", "-M", "15", "-X", "15"]
ENGINE_RUNS = [
    ("A_default.sam", "readsA_100bp.fasta", ["--engine", "batch-torch"]),
    ("A_default.sam", "readsA_100bp.fasta", ["--engine", "batch-torch",
                                             "--seed", "device"]),
    ("C_params.sam", "readsC_1kb.fasta", ["--engine", "batch-torch"] +
     C_FLAGS),
    ("A_default.sam", "readsA_100bp.fasta", ["--engine", "native"]),
    ("C_params.sam", "readsC_1kb.fasta", ["--engine", "native"] + C_FLAGS),
    ("D_fbs.sam", "readsD_sv.fasta", ["--engine", "native", "-FBS", "Y"]),
]


@pytest.mark.parametrize("gold,qfile,flags", ENGINE_RUNS,
                         ids=["torch_A", "torch_A_seed", "torch_C",
                              "native_A", "native_C", "native_D_fbs"])
def test_cli_engines_match_golden(scratch, monkeypatch, gold, qfile, flags):
    """--engine batch-torch (on --device cpu, with the host seed scan and
    with --seed device) and --engine native write the golden SAM."""
    from yaha_tpu_torch import cli
    monkeypatch.chdir(scratch)
    out = "engine_%s_%s" % ("_".join(f.strip("-") for f in flags), gold)
    rc = cli.main(["-x", INDEX, "-q", qfile, "--device", "cpu"] + flags +
                  ["-osh", out])
    assert rc == 0
    assert _strip_pg(os.path.join(scratch, out)) == _strip_pg(
        os.path.join(GOLD, gold))


def test_cli_trace(scratch, monkeypatch):
    """--trace DIR leaves a Chrome trace of the align loop (the DP's
    PyTorch ops among its events, and the recorder's spans: an `align`
    span a batch with its batch id, the phases under it with the same id)
    and the SAM is the golden one."""
    import json
    from yaha_tpu_torch import cli
    monkeypatch.chdir(scratch)
    rc = cli.main(["-x", INDEX, "-q", "readsF_edge.fasta", "--device",
                   "cpu", "--batch-size", "2", "--trace", "trace_F", "-osh",
                   "traced_F.sam"])
    assert rc == 0
    assert _strip_pg(os.path.join(scratch, "traced_F.sam")) == _strip_pg(
        os.path.join(GOLD, "F_edge.sam"))
    files = os.listdir(os.path.join(scratch, "trace_F"))
    assert len(files) == 1 and files[0].startswith("yaha_trace_")
    with open(os.path.join(scratch, "trace_F", files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::where" in names
    spans = [e for e in events if e.get("cat") == "yaha"]
    aligns = [e for e in spans if e["name"] == "align"]
    assert len(aligns) >= 2
    assert sorted(e["args"]["batch"] for e in aligns) == list(
        range(len(aligns)))
    by_id = {e["args"]["id"]: e for e in spans}
    for e in spans:
        if e["name"].startswith("staged."):
            up = by_id[e["args"]["parent"]]
            assert up["name"] == "align" and up["tid"] == e["tid"]
            assert e["args"]["batch"] == up["args"]["batch"]
            assert up["ts"] <= e["ts"] and \
                e["ts"] + e["dur"] <= up["ts"] + up["dur"] + 1e-3
    assert {"stream.read", "stream.parse", "stream.wait", "stream.emit",
            "staged.phase1", "staged.gap", "staged.ext",
            "setup.corpus_upload"} <= names


def test_cli_trace_device_seed(scratch, monkeypatch):
    """With --seed device, --trace DIR also holds the set-up's uploads
    (setup.seeder_upload, setup.corpus_upload, before the first `align`)
    and the seed phase's spans under each batch's `align`."""
    import json
    from yaha_tpu_torch import cli
    monkeypatch.chdir(scratch)
    rc = cli.main(["-x", INDEX, "-q", "readsF_edge.fasta", "--device",
                   "cpu", "--seed", "device", "--batch-size", "2",
                   "--trace", "trace_F_seed", "-osh", "traced_F_seed.sam"])
    assert rc == 0
    assert _strip_pg(os.path.join(scratch, "traced_F_seed.sam")) == \
        _strip_pg(os.path.join(GOLD, "F_edge.sam"))
    (name,) = os.listdir(os.path.join(scratch, "trace_F_seed"))
    with open(os.path.join(scratch, "trace_F_seed", name)) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "yaha"]
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    first = min(e["ts"] for e in by["align"])
    for setup in ("setup.seeder_upload", "setup.corpus_upload"):
        (e,) = by[setup]
        assert e["args"]["parent"] == 0 and "batch" not in e["args"]
        assert e["args"]["h2d"] > 0 and e["ts"] + e["dur"] <= first
    ids = {e["args"]["id"]: e for e in spans}
    for e in by["seeder.seed"]:
        assert ids[e["args"]["parent"]]["name"] == "align"
    assert by["seeder.fetch"]


def test_cli_native_engine_refuses_device_seed(scratch):
    r = _run_cli(scratch, ["-x", INDEX, "-q", "readsF_edge.fasta",
                           "--engine", "native", "--seed", "device", "-osh",
                           "native_seed.sam"])
    assert r.returncode != 0
    assert b"staged engine" in r.stderr


def test_cli_oracle_engine_refuses_device_seed(scratch):
    r = _run_cli(scratch, ["-x", INDEX, "-q", "readsF_edge.fasta",
                           "--engine", "oracle", "--seed", "device", "-osh",
                           "oracle_seed.sam"])
    assert r.returncode != 0
    assert b"staged engine" in r.stderr and b"--engine oracle" in r.stderr
    assert not os.path.exists(os.path.join(scratch, "oracle_seed.sam"))


def _run_cli(scratch, args):
    """The port's CLI in a fresh interpreter; after the run it asserts
    that neither jax nor any module of the JAX package was imported, and
    prints the paths of the native host libraries the process mapped."""
    code = ("import sys\n"
            "from yaha_tpu_torch import cli\n"
            "rc = cli.main(sys.argv[1:])\n"
            "assert 'jax' not in sys.modules, 'the port imported jax'\n"
            "ref = [m for m in sys.modules\n"
            "       if m == 'yaha_tpu' or m.startswith('yaha_tpu.')]\n"
            "assert not ref, 'the port imported %s' % ref\n"
            "with open('/proc/self/maps') as f:\n"
            "    libs = {ln.split()[-1] for ln in f\n"
            "            if ln.rstrip().endswith('libyaha_host.so')}\n"
            "print('\\n'.join(sorted(libs)))\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code] + args, cwd=scratch,
                          env=env, capture_output=True, timeout=600)


def test_cli_imports_no_jax(scratch):
    """A query run imports neither jax nor the JAX package, and runs the
    port's own native library (yaha_tpu_torch/_build), not the JAX
    package's."""
    r = _run_cli(scratch, ["-x", INDEX, "-q", "readsF_edge.fasta",
                           "--device", "cpu", "-osh", "nojax.sam"])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert _strip_pg(os.path.join(scratch, "nojax.sam")) == _strip_pg(
        os.path.join(GOLD, "F_edge.sam"))
    libs = [os.path.realpath(p) for p in r.stdout.decode().split()]
    assert libs == [os.path.realpath(os.path.join(
        REPO, "yaha_tpu_torch", "_build", "libyaha_host.so"))]


def test_cli_oracle_imports_no_jax(scratch):
    """--engine oracle (core/ and the port's io/ copies) imports neither
    jax nor the JAX package, and its DPs and front end run in the port's
    own native library."""
    r = _run_cli(scratch, ["-x", INDEX, "-q", "readsF_edge.fasta",
                           "--engine", "oracle", "-osh", "nojax_oracle.sam"])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert _strip_pg(os.path.join(scratch, "nojax_oracle.sam")) == _strip_pg(
        os.path.join(GOLD, "F_edge.sam"))
    libs = [os.path.realpath(p) for p in r.stdout.decode().split()]
    assert libs == [os.path.realpath(os.path.join(
        REPO, "yaha_tpu_torch", "_build", "libyaha_host.so"))]


def test_cli_device_cuda_without_card_fails(scratch):
    """The default --device cuda never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run_cli(scratch, ["-x", INDEX, "-q", "readsF_edge.fasta", "-osh",
                           "nocard.sam"])
    assert r.returncode != 0
    assert b"no CUDA device" in r.stderr
    assert not os.path.exists(os.path.join(scratch, "nocard.sam"))


def test_cli_batch_torch_device_cuda_without_card_fails(scratch):
    """--engine batch-torch on the default --device cuda stops too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run_cli(scratch, ["-x", INDEX, "-q", "readsF_edge.fasta",
                           "--engine", "batch-torch", "-osh",
                           "nocard_torch.sam"])
    assert r.returncode != 0
    assert b"no CUDA device" in r.stderr
    assert not os.path.exists(os.path.join(scratch, "nocard_torch.sam"))


def test_cli_rejects_unported_flags(scratch):
    """Every flag of the JAX package's CLI is ported but its engines for
    other devices: --engine batch-pallas is refused, and --model-shards
    (the last flag ported) runs, in a process that imports no jax, with
    the golden output."""
    r = _run_cli(scratch, ["-x", INDEX, "-q", "readsF_edge.fasta",
                           "--device", "cpu", "--engine", "batch-pallas"])
    assert r.returncode != 0
    assert b"--engine must be one of" in r.stderr
    r = _run_cli(scratch, ["-x", INDEX, "-q", "readsF_edge.fasta",
                           "--device", "cpu", "--model-shards", "2", "-osh",
                           "shards.sam"])
    assert r.returncode == 0, r.stderr[-2000:]

    def body(p):
        with open(p, "rb") as f:
            return [ln for ln in f.read().split(b"\n")
                    if not ln.startswith(b"@PG")]
    assert body(os.path.join(scratch, "shards.sam")) == body(
        os.path.join(GOLD, "F_edge.sam"))
