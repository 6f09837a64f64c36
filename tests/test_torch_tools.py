"""The port's tools (yaha_tpu_torch/tools/) against the JAX package's
tools/, on the CPU.

  * device_replay: the DP buckets the port's capture records over a chunk
    of readsA and of readsC on the testgen index equal those of
    tools/device_replay.capture_chunk on a JAX StagedAligner(backend=
    "pallas") in interpret mode over the same reads (bucket shapes, wband,
    per-problem qlens, rlens, lbws and rbws; the JAX pow2 tile padding
    stripped first, and checked to be zeros); the eager replay gives the
    captured walks, and a rolled window gives them rolled;
  * decode_profile: the plain walk's n_ops and items (slots below
    min(n_ops, cap)) equal decode_jax.rle_decode_band / rle_decode_full
    on the same planes, and every order agrees;
  * seedscan_scaling at 1 and 2 threads on the testgen index (a process of
    its own, YT_PROFILE set there): equal SAM and hits at both thread
    counts, the counters from the port's own library;
  * fuzz_parity: one seed draws the same genome, reads and flags as
    tools/fuzz_parity.py's generators (loaded by path: it imports nothing
    of yaha_tpu), and three seeds of short reads pass with --device cpu,
    batch-cuda, batch-torch and oracle against --engine native (seeds
    whose reads are all under 1 kb, since the CPU runs the kernels' plain
    versions; batch-torch on the reads of at most
    fuzz_parity.TWIN_MAX_READ bases).
"""
import gzip
import importlib.util
import json
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import DATA, GOLD

from yaha_tpu_torch.tools import decode_profile, device_replay, fuzz_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KERNEL = {"extension_forward_pallas_p4": "extension_forward",
              "anchored_forward_pallas_banded_p4": "anchored_forward_banded",
              "anchored_forward_pallas_p4": "anchored_forward"}


@pytest.fixture(scope="module")
def testgen(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), d)
    idx = os.path.join(d, "testgen.X11_01_65525S")
    with gzip.open(os.path.join(GOLD, "testgen.X11_01_65525S.gz")) as f:
        with open(idx, "wb") as out:
            out.write(f.read())
    return str(d), idx


def _aa(mod, index):
    aa = mod.AlignmentArgs()
    aa.xfile_name, aa.qfile_name, aa.ofile_name = "x", "q", "o"
    aa.post_process(True)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    return aa


def _jax_calls(d, idx, reads, n, monkeypatch):
    """tools/device_replay.capture_chunk on the JAX staged engine."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import device_replay as jdr
    finally:
        sys.path.pop(0)
    from yaha_tpu import config
    from yaha_tpu.io import native_loader
    from yaha_tpu.models.staged import StagedAligner
    from yaha_tpu.native import host
    monkeypatch.setenv("YT_PALLAS_INTERPRET", "1")
    genome = native_loader.load_genome(os.path.join(d, "testgen.nib2"))
    index = native_loader.load_index(idx)
    aa = _aa(config, index)
    with open(os.path.join(DATA, reads), "rb") as f:
        pr = host.parse_queries_native(f.read(), False, aa.max_query_length,
                                       aa.word_len)
    st = StagedAligner(aa, genome, index, backend="pallas", n_threads=2)
    return jdr.capture_chunk(st, pr, 0, min(n, pr.n))


def _port_steps(d, idx, reads, n):
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.staged import StagedAligner
    genome = host.load_genome(os.path.join(d, "testgen.nib2"))
    index = host.load_index(idx)
    aa = _aa(host, index)
    with open(os.path.join(DATA, reads), "rb") as f:
        pr = host.parse_queries_native(f.read(), False, aa.max_query_length,
                                       aa.word_len)
    st = StagedAligner(aa, genome, index, device="cpu", n_threads=2)
    return device_replay.capture_chunk(st, pr, 0, min(n, pr.n))


@pytest.mark.parametrize("reads,n", [("readsA_100bp.fasta", 200),
                                     ("readsC_1kb.fasta", 6)])
def test_replay_capture_matches_jax(reads, n, testgen, monkeypatch):
    d, idx = testgen
    steps = _port_steps(d, idx, reads, n)
    got = device_replay.kernel_calls(steps)
    want = _jax_calls(d, idx, reads, n, monkeypatch)
    assert [c["kernel"] for c in got] == [JAX_KERNEL[w[0]] for w in want]
    for c, (name, args, kw) in zip(got, want):
        npad = args[0].shape[0]
        assert npad == max(1024, 1 << (c["n"] - 1).bit_length())
        assert (c["qg"], c["rg"]) == (2 * args[0].shape[1],
                                      2 * args[2].shape[1])
        assert c["wband"] == kw.get("wband")
        lens = [args[1], args[3]] + ([args[4], args[5]]
                                     if len(args) > 4 else [])
        for key, a in zip(("qlens", "rlens", "lbws", "rbws"), lens):
            a = np.asarray(a, np.int64)
            np.testing.assert_array_equal(c[key], a[:c["n"]], key)
            assert not a[c["n"]:].any(), key
    assert any(s["op"] == "gather" for s in steps)
    assert sum(s["op"] == "walk" for s in steps) == len(
        [s for s in steps if s["op"] in device_replay._KERNELS])


def test_eager_replay_gives_the_captured_walks(testgen):
    d, idx = testgen
    steps = _port_steps(d, idx, "readsA_100bp.fasta", 200)
    rep = device_replay.Replay(steps)
    device_replay.check_walks(steps, rep.run())
    # A rolled window: the walks of a bucket launched in one slice come
    # back rolled by the window's amount.
    rep.make_windows(2)
    rep.load_window(1)
    walks = rep.run()
    captured = [s for s in steps if s["op"] == "walk"]
    rolled = 0
    for s, (rle, n_ops) in zip(captured, walks):
        k = steps[s["src"]]
        if k["src"] is None or k["src"][1:] != (0, steps[k["src"][0]]["m"]):
            continue
        sh = 17 % k["n"]
        assert torch.equal(n_ops, torch.roll(s["n_ops"], sh))
        want = decode_profile.items_below(s["rle"], s["n_ops"], s["cap"])
        assert torch.equal(decode_profile.items_below(rle, n_ops, s["cap"]),
                           torch.roll(want, sh, 0))
        rolled += 1
    assert rolled
    rep.load_window(0)
    device_replay.check_walks(steps, rep.run())


def test_measure_chunk_device_cpu_is_eager(testgen):
    from yaha_tpu_torch import host
    from yaha_tpu_torch.models.staged import StagedAligner
    d, idx = testgen
    genome = host.load_genome(os.path.join(d, "testgen.nib2"))
    index = host.load_index(idx)
    aa = _aa(host, index)
    with open(os.path.join(DATA, "readsA_100bp.fasta"), "rb") as f:
        pr = host.parse_queries_native(f.read(), False, aa.max_query_length,
                                       aa.word_len)
    st = StagedAligner(aa, genome, index, device="cpu", n_threads=2)
    rep = device_replay.measure_chunk_device(st, pr, 0, 64)
    assert rep["mode"] == "eager" and rep["walks_equal"]
    assert "replay_device_s_min_med_max" not in rep
    assert rep["entry_calls"]["walk"] >= 1 and rep["left_out"]


def _profile_planes():
    band = decode_profile.band_planes(
        *decode_profile.synthetic_problems(96, 64, "cpu"),
        **decode_profile.EXT_KW)
    full = decode_profile.full_planes(
        *decode_profile.synthetic_gaps(96, 32, "cpu"),
        **decode_profile.GAP_KW)
    return {"band": band, "full": full}


def test_decode_profile_cpu_matches_decode_jax():
    from yaha_tpu.ops import decode_jax
    from yaha_tpu_torch.ops import decode
    planes = _profile_planes()
    rep = decode_profile.profile(planes)
    for layout, (bt, y0, x0, active, cap) in planes.items():
        row = rep[layout]
        assert row["teams_equal"] and row["shape"] == list(bt.shape)
        assert row["walk_steps"] > 0 and row["bound_ms"] > 0
        assert not any(k.endswith("_ms") and isinstance(v, dict)
                       for k, v in row.items())
        full = layout == "full"
        rle, n_ops = decode.rle_walk(bt, y0, x0, active, cap=cap, full=full)
        h, w = bt.shape[1], bt.shape[2]
        jfn = decode_jax.rle_decode_full if full else \
            decode_jax.rle_decode_band
        jrle, jn = jfn(bt.numpy(), y0.numpy(), x0.numpy(), active.numpy(),
                       cap=cap, max_iters=(h + w + 16) if full
                       else 2 * h + w + 16)
        jn = torch.from_numpy(np.asarray(jn))
        assert torch.equal(n_ops, jn.to(n_ops.dtype))
        assert (n_ops > 0).any()
        assert torch.equal(
            decode_profile.items_below(rle, n_ops, cap),
            decode_profile.items_below(
                torch.from_numpy(np.asarray(jrle)).to(rle.dtype), n_ops,
                cap))


def test_seedscan_scaling_threads_agree(testgen):
    d, idx = testgen
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("YT_PROFILE", None)
    r = subprocess.run(
        [sys.executable, "-m", "yaha_tpu_torch.tools.seedscan_scaling",
         "-x", idx, "--reads", "200", "--len", "500", "--threads", "1,2",
         "--iters", "2", "--device", "cpu"], cwd=REPO, env=env,
        capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    rep = json.loads(r.stdout.decode().strip().splitlines()[-1])
    assert [row["threads"] for row in rep["rows"]] == [1, 2]
    assert rep["rows"][0]["hits"] == rep["rows"][1]["hits"] > 0
    for row in rep["rows"]:
        assert row["scan_cpu_s_thread_sum"] > 0 and row["phase1_wall_s"] > 0
    assert rep["library"] == os.path.join(
        REPO, "yaha_tpu_torch", "_build", "libyaha_host.so")
    assert rep["device_seeder"]["device"] == "cpu"
    assert rep["device_seeder"]["seed_device_s"] > 0
    assert rep["assets"]["cut"]


def _jax_fuzz():
    spec = importlib.util.spec_from_file_location(
        "jax_fuzz_parity", os.path.join(REPO, "tools", "fuzz_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 55, 1000, 1007])
def test_fuzz_generators_draw_the_reference_bytes(seed, tmp_path):
    ref = _jax_fuzz()
    ra, rb = random.Random(seed), random.Random(seed)
    ga = fuzz_parity.gen_genome(ra, str(tmp_path / "a.fa"))
    gb = ref.gen_genome(rb, str(tmp_path / "b.fa"))
    assert ga == gb
    fq = ra.random() < 0.25
    assert fq == (rb.random() < 0.25)
    fuzz_parity.gen_reads(ra, ga, str(tmp_path / "a.reads"), fastq=fq)
    ref.gen_reads(rb, gb, str(tmp_path / "b.reads"), fastq=fq)
    assert fuzz_parity.gen_config(ra) == ref.gen_config(rb)
    for ext in ("fa", "reads"):
        assert (tmp_path / ("a." + ext)).read_bytes() == \
            (tmp_path / ("b." + ext)).read_bytes()
    assert ra.random() == rb.random()


@pytest.mark.parametrize("seed", [55, 119, 259])
def test_fuzz_seed_passes_on_cpu(seed):
    res = fuzz_parity.run_one(seed, "cpu", ("batch-cuda", "batch-torch",
                                            "oracle"))
    assert res["arms"] == {"batch-cuda": "ok", "batch-torch": "ok",
                           "oracle": "ok"}, res
    assert "dir" not in res and "not_run" not in res
    kept, total = res["twin_reads"]
    assert 0 < kept <= total
