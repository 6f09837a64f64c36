"""The port's multi-host runs (yaha_tpu_torch/parallel/distributed.py and
the CLI's --coordinator / --num-hosts / --host-id / --model-shards) on the
CPU: the analogs of tests/test_distributed.py and tests/test_multihost.py.

The helpers are held to the JAX package's (read ranges, part names, the
merge).  Two processes join a gloo group on a free local port, each with
its own timeout: a worker script that aligns its read range with the
staged engine and merges after the barrier (byte-identical to the golden
SAM), and the CLI with --device cpu in the staged engines, alone, with
--seed device, and with all three axes at once (two hosts, each with a
(1 x 2) grid of the CPU sharding the index: four grid entries), each
merged SAM equal to the golden apart from @PG.  --engine native ignores
the four flags.
"""
import gzip
import os
import shutil
import socket
import subprocess
import sys

import pytest

from conftest import DATA, GOLD
from yaha_tpu.parallel import distributed as jdist
from yaha_tpu_torch.parallel import distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INDEX = "testgen.X11_01_65525S"
TIMEOUT = 300     # seconds a process of a two-process run may take


def test_host_read_range_partition():
    n, pc = 103, 4
    ranges = [dist.host_read_range(n, pi, pc) for pi in range(pc)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (a, b), (c, d) in zip(ranges, ranges[1:]):
        assert b == c and a <= b


@pytest.mark.parametrize("n", [0, 1, 5, 100, 103])
@pytest.mark.parametrize("pc", [1, 2, 3, 4, 7])
def test_host_read_range_matches_jax(n, pc):
    for pi in range(pc):
        assert dist.host_read_range(n, pi, pc) == jdist.host_read_range(
            n, pi, pc)


def test_merge_part_files(tmp_path):
    ofile = str(tmp_path / "out.sam")
    for pi in range(3):
        assert dist.part_file_name(ofile, pi) == jdist.part_file_name(
            ofile, pi)
        with open(dist.part_file_name(ofile, pi), "w") as f:
            f.write("part%d\n" % pi)
    dist.merge_part_files(ofile, 3, "@HD\n")
    with open(ofile) as f:
        assert f.read() == "@HD\npart0\npart1\npart2\n"


def test_single_process_defaults():
    """Without a group: rank 0 of 1, initialize does nothing, the barrier
    counts one process."""
    dist.initialize(None, 1, 0)
    assert dist.host_read_range(10) == (0, 10)
    assert dist.part_file_name("o.sam") == "o.sam.part00000"
    assert dist.barrier() == 1
    with pytest.raises(ValueError, match="coordinator"):
        dist.initialize(None, 2, 0)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture()
def run_dir(tmp_path):
    shutil.copy(os.path.join(DATA, "readsA_100bp.fasta"), tmp_path)
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), tmp_path)
    with gzip.open(os.path.join(GOLD, INDEX + ".gz")) as f:
        with open(os.path.join(tmp_path, INDEX), "wb") as out:
            out.write(f.read())
    return tmp_path


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def _two_processes(cwd, argv_of):
    """Start the two processes argv_of(0) and argv_of(1) together; every
    process must exit 0 within TIMEOUT (the others are killed at the first
    failure)."""
    procs = [subprocess.Popen(argv_of(pid), cwd=cwd, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for pid in range(2)]
    try:
        for p in procs:
            out = p.communicate(timeout=TIMEOUT)[0].decode()
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _body(path):
    with open(path, "rb") as f:
        return [ln for ln in f.read().splitlines()
                if not ln.startswith(b"@PG")]


WORKER = r"""
import sys
pid, port = int(sys.argv[1]), sys.argv[2]
from yaha_tpu_torch import host
from yaha_tpu_torch.io import sam
from yaha_tpu_torch.models.staged import StagedAligner
from yaha_tpu_torch.parallel import distributed as dist

dist.initialize("127.0.0.1:" + port, 2, pid)
aa = host.AlignmentArgs()
aa.qfile_name = "readsA_100bp.fasta"
aa.xfile_name = "testgen.X11_01_65525S"
aa.ofile_name = "A_default.sam"
aa.post_process(True)
genome = host.load_genome("testgen.nib2")
index = host.load_index("testgen.X11_01_65525S")
aa.word_len = index.word_len
with open("readsA_100bp.fasta", "rb") as f:
    pr = host.parse_queries_native(f.read(), False, aa.max_query_length,
                                   aa.word_len)
lo, hi = dist.host_read_range(pr.n)
text = StagedAligner(aa, genome, index, device="cpu").align_chunk(
    pr, lo, hi)[0]
with open(dist.part_file_name("out.sam"), "wb") as f:
    f.write(text)
assert dist.barrier() == 2
if pid == 0:
    dist.merge_part_files("out.sam", 2, sam.file_header(aa, genome))
dist.shutdown()
"""


def test_two_process_distributed(run_dir):
    """Two gloo processes align their read ranges and host 0 merges after
    the barrier: byte-identical to the golden (the worker names the files
    as the golden's run did, so @PG matches too)."""
    (run_dir / "worker.py").write_text(WORKER)
    port = str(_free_port())
    _two_processes(run_dir, lambda pid: [sys.executable, "worker.py",
                                         str(pid), port])
    with open(run_dir / "out.sam", "rb") as f, open(
            os.path.join(GOLD, "A_default.sam"), "rb") as g:
        assert f.read() == g.read()


# The CLI's two-host runs: (engine and flags, the grid entries of a host).
CLI_RUNS = {
    "batch_cuda": ["--engine", "batch-cuda"],
    "seed_device": ["--engine", "batch-cuda", "--seed", "device"],
    "three_axis": ["--engine", "batch-cuda", "--seed", "device",
                   "--model-shards", "2"],
    "batch_torch_shards": ["--engine", "batch-torch", "--model-shards",
                           "2"],
}


@pytest.mark.parametrize("run", sorted(CLI_RUNS))
def test_multihost_cli(run_dir, run):
    """Two CLI processes, --num-hosts 2 with their own --host-id, the
    staged engine on the CPU: reads range-shard over the hosts, each host
    writes a part, host 0 merges; the SAM equals the golden apart from
    @PG, and the parts hold the two read ranges."""
    port = _free_port()
    _two_processes(run_dir, lambda pid: [
        sys.executable, "-m", "yaha_tpu_torch.cli", "-x", INDEX, "-q",
        "readsA_100bp.fasta", "--device", "cpu"] + CLI_RUNS[run] + [
            "--coordinator", "127.0.0.1:%d" % port, "--num-hosts", "2",
            "--host-id", str(pid), "-osh", "out.sam"])
    assert _body(run_dir / "out.sam") == _body(
        os.path.join(GOLD, "A_default.sam"))
    parts = [(run_dir / ("out.sam.part%05d" % pi)).read_bytes()
             for pi in range(2)]
    assert all(p and not p.startswith(b"@") for p in parts)
    with open(run_dir / "out.sam", "rb") as f:
        pg = [ln for ln in f.read().splitlines() if ln.startswith(b"@PG")]
    assert len(pg) == 1 and b"-osh out.sam " in pg[0]


def test_native_engine_ignores_scale_flags(run_dir, monkeypatch):
    """--engine native returns before the four flags, as the reference's
    does: one process, the whole golden output."""
    from yaha_tpu_torch import cli
    monkeypatch.chdir(run_dir)
    assert cli.main(["-x", INDEX, "-q", "readsA_100bp.fasta", "--engine",
                     "native", "--model-shards", "2", "--num-hosts", "1",
                     "--host-id", "0", "--coordinator", "127.0.0.1:1",
                     "-osh", "native.sam"]) == 0
    assert _body(run_dir / "native.sam") == _body(
        os.path.join(GOLD, "A_default.sam"))


def test_cli_takes_the_four_flags():
    from yaha_tpu_torch import cli
    aa, device, op = cli.parse_args(
        ["-x", "i.X11", "-q", "r.fa", "--model-shards", "2",
         "--coordinator", "10.0.0.1:1234", "--num-hosts", "3",
         "--host-id", "2", "--device", "cpu"])
    assert (op, device) == ("query", "cpu")
    assert (aa.model_shards, aa.coordinator, aa.num_hosts, aa.host_id) == (
        2, "10.0.0.1:1234", 3, 2)
    for flag in ("--model-shards", "--coordinator", "--num-hosts",
                 "--host-id"):
        assert flag in cli.USAGE
    assert "ot ported" not in cli.USAGE


@pytest.mark.parametrize("argv, msg", [
    (["--model-shards", "0"], "--model-shards must be at least 1"),
    (["--model-shards", "-2"], "not a valid value for parameter "
     "--model-shards"),
    (["--num-hosts", "0"], "--num-hosts must be at least 1"),
    (["--num-hosts", "2", "--host-id", "2", "--coordinator",
      "127.0.0.1:1"], "--host-id must be in [0, 2)"),
    (["--num-hosts", "2", "--host-id", "-1", "--coordinator",
      "127.0.0.1:1"], "not a valid value for parameter --host-id"),
    (["--host-id", "1"], "--host-id must be in [0, 1)"),
    (["--num-hosts", "2", "--host-id", "1"], "needs --coordinator"),
], ids=["shards0", "shards_neg", "hosts0", "host_id_past", "host_id_neg",
        "host_id_one_host", "no_coordinator"])
def test_cli_refuses_bad_scale_flags(argv, msg, capsys):
    """Values of the four flags that no run can take are usage errors."""
    from yaha_tpu_torch import cli
    with pytest.raises(SystemExit) as e:
        cli.parse_args(["-x", "i.X11", "-q", "r.fa", "--device", "cpu"] +
                       argv)
    assert e.value.code == 1
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("shards", [3, 6])
def test_cli_refuses_shards_that_do_not_divide_the_index(run_dir,
                                                         monkeypatch,
                                                         capsys, shards):
    """--model-shards N must divide the L11 index's 4^11 hashes: a usage
    error before any host joins a group or any shard is built."""
    from yaha_tpu_torch import cli
    monkeypatch.chdir(run_dir)
    with pytest.raises(SystemExit) as e:
        cli.main(["-x", INDEX, "-q", "readsA_100bp.fasta", "--engine",
                  "batch-torch", "--device", "cpu", "--model-shards",
                  str(shards), "-osh", "bad.sam"])
    assert e.value.code == 1
    assert ("--model-shards %d does not divide the 4194304 hashes"
            % shards) in capsys.readouterr().err
