"""Whole runs of the harness on the CPU at a tiny size: the result line's
shape, the check catching the timed path's faults, the control, and the
reference against the goldens.  The harness's look for a card is skipped
(device "cpu" runs the kernels' plain versions through the same engine).

    python -m pytest -q yaha_bench/test_bench_run.py      # ~7 min
"""
import gzip
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from yaha_bench import control, harness
from yaha_bench.reference import index as rindex, runner

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(REPO, "tests", "golden")
SEED = 2**31 + 4242


def tiny(name, pool=48, batch=16, check=12):
    """A cell of BENCHMARK.json cut to a test's size: a 1 Mbp genome, an L11
    index, a pool of `pool` reads."""
    cell = harness.load_cell(name)
    cfg = cell["config"]
    cell["config"] = dict(cfg, genome_bases=1_000_000,
                          index=dict(cfg["index"], word_len=11),
                          genome=dict(cfg["genome"], chromosomes=2,
                                      repeat_every=20_000))
    cell["traffic"] = dict(cell["traffic"], pool_reads=pool,
                           batch_reads=batch, check_reads=check)
    return cell


def run(cell, trace=False, seed=SEED, log=None):
    return harness.run(cell, seed, 0.1, trace, device="cpu",
                       log=log or io.StringIO())


@pytest.fixture(scope="module")
def traced():
    """A traced run's result and what it wrote to its log."""
    log = io.StringIO()
    return run(tiny("devidx.1kb_mixed"), trace=True, log=log), log.getvalue()


def test_result_line_shape(traced):
    r = traced[0]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["setup_compiled_s"] >= 0.0     # the builds, recorded apart
    assert r["correct"] is True and r["failed"] == 0
    per_pass = 48 * harness.copies_for(tiny("devidx.1kb_mixed")["traffic"])
    assert per_pass == 144
    assert r["attempted"] >= per_pass and r["attempted"] % per_pass == 0
    dev = r["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    assert {"memory_peak_bytes", "busy_s", "window_s"} <= set(dev)
    for name, c in r["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    names = {m["name"]: m["unit"] for m in tiny("devidx.1kb_mixed")[
        "per_layer"]}
    for name, m in r["metrics"].items():
        assert m["unit"] == names[name]
        assert isinstance(m["value"], float) or isinstance(m["value"], int)
    # the host's stats and spans read in every cell (in devidx under the
    # names that move memory_peak_gb); the device's only on a card (no
    # kernel runs here)
    for name in ("stream.reads_per_s", "stream.overlap.devidx",
                 "staged.phase1_ms_per_kread.devidx",
                 "staged.host_ms_per_kread.devidx", "seeder.ms_per_kread",
                 "dispatch.launches_per_batch.devidx", "setup.index_build_s",
                 "setup.warmup_s"):
        assert name in r["metrics"], name
    assert "kernels.dp_ms_per_kread.devidx" not in r["metrics"]
    assert "stream.overlap" not in r["metrics"]
    assert r["metrics"]["staged.host_ms_per_kread.devidx"]["value"] > 0
    line = [ln for ln in traced[1].splitlines() if ln.startswith("window ")]
    rate = float(line[0].split(" reads/s")[0].rsplit(", ", 1)[1])
    assert r["metrics"]["stream.reads_per_s"]["value"] == pytest.approx(
        rate, abs=0.06)
    json.dumps(r)


def test_traced_run_prints_idle_by_span(traced):
    """The traced run prints the idle-by-span table on its log: the card's
    idle time in the window by the program spans open across it (no
    kernel runs here, so the whole window is idle)."""
    log = traced[1]
    head = [ln for ln in log.splitlines() if ln.startswith("idle by span:")]
    assert len(head) == 1 and "of device idle time in the window" in head[0]
    rows = log.split(head[0], 1)[1].splitlines()[1:]
    assert rows and rows[0].lstrip().split()[1] == "s"
    assert any("worker:" in r for r in rows)


@pytest.mark.parametrize("name,ends", [
    ("hostidx.1kb_mixed", {"reads_per_s": "reads/s", "setup_s": "s"}),
    ("devidx.1kb_mixed", {"memory_peak_gb": "GB", "setup_s": "s"})])
def test_untraced_reports_end_to_end(name, ends):
    r = run(tiny(name))
    assert r["correct"] is True
    assert {k: m["unit"] for k, m in r["metrics"].items()} == ends
    if "memory_peak_gb" in ends:
        assert r["metrics"]["memory_peak_gb"]["value"] == (
            r["device"]["memory_peak_bytes"] / 1e9)
    assert "busy_s" not in r["device"] and "breakdown" not in r


def broken(monkeypatch, fault):
    """Plant `fault` in StagedAligner.align_chunk, the timed path."""
    from yaha_tpu_torch.models.staged import StagedAligner
    real = StagedAligner.align_chunk
    last = {}

    def align_chunk(self, pr, lo, hi, dist=None, want_stats=False):
        if fault == "half_batch":
            # half the batch left out: its reads get no records
            text, sm, nr = real(self, pr, lo, lo + (hi - lo) // 2, dist=dist)
            return text, sm, nr
        text, sm, nr = real(self, pr, lo, hi, dist=dist)
        if fault == "stale":
            # a step that returns its state unchanged: the batch before's
            # records again
            prev = last.get("text", text)
            last["text"] = text
            return prev, sm, nr
        if fault == "altered":
            # one answer altered where it is produced: a CIGAR's first
            # count changed in every batch
            lines = text.split(b"\n")
            for k, ln in enumerate(lines):
                f = ln.split(b"\t")
                if len(f) > 5 and f[5][:1].isdigit():
                    f[5] = b"9" + f[5]
                    lines[k] = b"\t".join(f)
                    break
            return b"\n".join(lines), sm, nr
        raise AssertionError(fault)
    monkeypatch.setattr(StagedAligner, "align_chunk", align_chunk)


@pytest.mark.parametrize("fault", ["half_batch", "stale", "altered"])
def test_faults_make_it_incorrect(monkeypatch, fault):
    broken(monkeypatch, fault)
    # every sampled read is checked: a fault in one batch shows
    r = run(tiny("hostidx.1kb_mixed", pool=32, batch=16, check=32))
    assert r["correct"] is False
    assert r["checks"]["reads_differing"]["value"] > 0
    assert r["failed"] > 0


@pytest.mark.parametrize("name", ["hostidx.1kb_mixed", "devidx.1kb_mixed",
                                  "hostidx.10kb_long"])
def test_control_fails_the_check(name):
    """The control's records, through the harness's comparison, come out
    not correct: most of the sample differs.  The reference and the
    control align their reads in worker processes."""
    with open(os.devnull, "w") as log:
        checks, ok = control.readings(tiny(name, pool=48, check=24), 7,
                                      "cpu", passes=2, log=log)
    assert ok is False
    assert checks["reads_differing"]["value"] >= 12
    assert checks["batches_out_of_order"]["value"] == 0


def test_reference_matches_goldens():
    """The reference's index is the golden L11 index byte for byte (with
    maxHits 65525 and with 20, its down-sampled twin), and its records
    are the goldens' at the default flags."""
    from yaha_tpu_torch.io import nib2
    with open(os.path.join(GOLDEN, "testgen.nib2"), "rb") as f:
        g = nib2.load(f.read())
    for name, hits in (("testgen.X11_01_65525S.gz", 65525),
                       ("testgen.X11_01_00020S.gz", 20)):
        idx = rindex.build(g.codes, g.starting_offsets, g.lengths, 11, 1,
                           hits)
        gold = gzip.open(os.path.join(GOLDEN, name)).read()
        head = np.frombuffer(gold[:16], np.uint32)
        n_so = 4 ** 11 + 1
        assert int(head[3]) == idx.total_matches
        assert gold[16:16 + 4 * n_so] == idx.starting_offs.tobytes()
        assert gold[16 + 4 * n_so:] == idx.roa.tobytes()
    idx = rindex.build(g.codes, g.starting_offsets, g.lengths, 11, 1, 65525)
    rg = runner.genome(g.names, g.starting_offsets, g.lengths, g.codes)
    for reads, golden in (("readsA_100bp.fasta", "A_default.sam"),
                          ("readsD_sv.fasta", "D_default.sam")):
        with open(os.path.join(REPO, "tests", "data", reads), "rb") as f:
            out = runner.align(runner.alignment_args([], idx), rg, idx,
                               f.read())
        with open(os.path.join(GOLDEN, golden)) as f:
            want = "".join(ln for ln in f if not ln.startswith("@"))
        assert "".join(out.values()) == want


def test_run_py_refuses_without_a_card():
    """No CUDA device here: run.py exits non-zero and prints no result."""
    p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                        "--workload", "hostidx.1kb_mixed", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaha_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "yaha_tpu.io", sys)
    assert harness.forbidden_modules() == ["yaha_tpu"]


def test_sample_is_drawn_from_the_kept_batches():
    """file_reads names every read of the FASTA by its index; keep_plan and
    pick_sample depend on the seed alone; every pick lies in its kept
    batch, none twice."""
    from yaha_bench import check
    pool = [("s0", np.zeros(3, np.uint8)), ("v1", np.ones(3, np.uint8))]
    assert [n for n, _ in check.file_reads(pool, 3)] == [
        "s0", "v1", "s2", "v3", "s4", "v5"]
    plan = check.keep_plan(SEED, 9)
    assert (plan == check.keep_plan(SEED, 9)).all() and set(plan) == set(
        range(9))
    kept = [(160, 16), (32, 16), (160, 16)]
    picks = check.pick_sample(kept, 20, SEED)
    assert picks == check.pick_sample(kept, 20, SEED)
    assert len(picks) == 20 and len(set(picks)) == 20
    assert all(kept[b][0] <= k < kept[b][0] + kept[b][1] for k, b in picks)
    assert len(check.pick_sample(kept, 100, SEED)) == 48
