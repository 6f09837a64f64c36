"""The port's staged engine and CLI (yaha_tpu_torch) against the JAX package.

With --device cpu the DP phases run the kernels' plain PyTorch versions,
and inline_small=False sends every gap fill and extension through them.
The SAM bytes must equal the per-read native C++ engine's
(host.align_batch_native), and the CLI must reproduce the golden SAM
files of tests/golden (ignoring @PG lines, which embed paths).  The CLI
must not import jax, and must fail on --device cuda without a card.
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


def _parity(env, aa, data, n_max=None):
    """Align through the port's engine on the CPU; assert byte parity with
    the native engine and return the engine's stats."""
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.staged import StagedAligner
    genome, index = env
    aa.fastq = data[:1] == b"@"
    pr = host.parse_queries_native(data, aa.fastq, aa.max_query_length,
                                   aa.word_len)
    n = pr.n if n_max is None else min(pr.n, n_max)
    ref, _, sm0, nr0 = host.align_batch_native(pr, 0, n, genome, index, aa,
                                               n_threads=2)
    st = StagedAligner(aa, genome, index, device="cpu", n_threads=2,
                       inline_small=False)
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


def _run_cli(scratch, args):
    code = ("import sys\n"
            "from yaha_tpu_torch import cli\n"
            "rc = cli.main(sys.argv[1:])\n"
            "assert 'jax' not in sys.modules, 'the port imported jax'\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code] + args, cwd=scratch,
                          env=env, capture_output=True, timeout=600)


def test_cli_imports_no_jax(scratch):
    r = _run_cli(scratch, ["-x", INDEX, "-q", "readsF_edge.fasta",
                           "--device", "cpu", "-osh", "nojax.sam"])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert _strip_pg(os.path.join(scratch, "nojax.sam")) == _strip_pg(
        os.path.join(GOLD, "F_edge.sam"))


def test_cli_device_cuda_without_card_fails(scratch):
    """The default --device cuda never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run_cli(scratch, ["-x", INDEX, "-q", "readsF_edge.fasta", "-osh",
                           "nocard.sam"])
    assert r.returncode != 0
    assert b"no CUDA device" in r.stderr
    assert not os.path.exists(os.path.join(scratch, "nocard.sam"))


def test_cli_rejects_unported_flags(scratch):
    r = _run_cli(scratch, ["-x", INDEX, "-q", "readsF_edge.fasta",
                           "--device", "cpu", "--seed", "device"])
    assert r.returncode != 0
    assert b"not ported" in r.stderr
