"""The port's driver entry points (yaha_tpu_torch/entry.py) against the JAX
package's (__graft_entry__.py), on the CPU.

  * _example_problems gives the reference's bytes from the same seed;
  * entry("cpu")'s step gives the score, maxi and maxj of the reference's
    step (sw_batch.batched_extension_forward, the XLA twin on the CPU)
    on the same arguments: exact, every array is int32;
  * dryrun_multichip(n, "cpu") at YT_DRYRUN_MBP=2 on (1 x 2) and (2 x 2)
    grids of the CPU: ok, byte identity of its three arms, no host-scan
    fallback, phantom rows, a capacity retry, merged bytes; and its SAM
    equal to the JAX package's native engine
    (yaha_tpu.native.host.align_batch_native) on the same genome and
    reads;
  * "cuda" without a card raises; python -m yaha_tpu_torch.entry
    --device cpu runs entry() and the 8-entry dryrun in a child process.
"""
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from yaha_tpu_torch import entry as ent

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n,ql,seed", [(64, 64, 0), (32, 128, 1),
                                       (16, 40, 2)])
def test_example_problems_are_the_reference_bytes(n, ql, seed):
    import __graft_entry__ as g
    for a, b in zip(ent._example_problems(n, ql, seed),
                    g._example_problems(n, ql, seed)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,ql,seed", [(64, 64, 0), (32, 128, 1),
                                       (16, 40, 2)])
def test_entry_step_matches_reference(n, ql, seed):
    import __graft_entry__ as g
    ref_step, ref_args = g.entry()
    step, args = ent.entry("cpu")
    for a, b in zip(args, ref_args):
        assert a.tobytes() == b.tobytes()
    if (n, ql, seed) != (64, 64, 0):
        args = ent._example_problems(n, ql, seed)
    got = step(*args)
    want = ref_step(*args)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_entry_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ent.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ent.dryrun_multichip(2)


def _jax_native_sha(mbp, tmp_path):
    """sha256 of the JAX package's native engine's SAM over the dryrun's
    genome and reads (the port's dryrun_assets), in chunks of 100."""
    from yaha_tpu.config import AlignmentArgs
    from yaha_tpu.io import native_loader
    from yaha_tpu.native import host
    gpath, xpath, _, _, qdata = ent.dryrun_assets(mbp, str(tmp_path))
    genome = native_loader.load_genome(gpath)
    index = native_loader.load_index(xpath)
    aa = AlignmentArgs()
    aa.word_len = 13
    aa.qfile_name = "dryrun.fa"
    aa.xfile_name = "dryrun.X"
    aa.ofile_name = "out.sam"
    aa.post_process(True)
    aa.max_hits = min(aa.max_hits, index.max_hits)
    aa.fastq = False
    pr = host.parse_queries_native(qdata, False, aa.max_query_length,
                                   aa.word_len)
    out = b"".join(host.align_batch_native(pr, lo, min(lo + 100, pr.n),
                                           genome, index, aa,
                                           n_threads=2)[0]
                   for lo in range(0, pr.n, 100))
    return hashlib.sha256(out).hexdigest(), pr.n


@pytest.fixture(scope="module")
def jax_dryrun_sha(tmp_path_factory):
    return _jax_native_sha(2, tmp_path_factory.mktemp("dryrun_ref"))


@pytest.mark.parametrize("n_devices,mesh", [(2, {"data": 1, "model": 2}),
                                            (4, {"data": 2, "model": 2})])
def test_dryrun_multichip_cpu(n_devices, mesh, monkeypatch, jax_dryrun_sha):
    monkeypatch.setenv("YT_DRYRUN_MBP", "2")
    monkeypatch.setenv("YT_DRYRUN_L15", "0")
    rep = ent.dryrun_multichip(n_devices, "cpu")
    assert rep["byte_identical"] and rep["mesh"] == mesh
    assert rep["host_seed_fallbacks"] == 0
    assert rep["phantom_rows"] > 0 and rep["capacity_retries"] > 0
    assert rep["all_gather_bytes"] > 0 and rep["l15"] is None
    assert rep["reads"] == 200 and rep["genome_mbp"] == 2
    assert (rep["sam_sha256"], rep["reads"]) == jax_dryrun_sha


def test_entry_main_cpu():
    env = dict(os.environ, YT_DRYRUN_MBP="2", YT_DRYRUN_L15="0",
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "yaha_tpu_torch.entry",
                        "--device", "cpu"], cwd=REPO, env=env,
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    out = r.stdout.decode()
    assert "entry ok:" in out
    assert "dryrun_multichip ok:" in out and '"model": 2' in out
    assert '"data": 4' in out
