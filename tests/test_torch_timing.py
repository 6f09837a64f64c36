"""The port's span recorder (yaha_tpu_torch/utils/timing.py) and what feeds
it: parent links and batch ids across threads, nothing recorded while it
is off, the spans placed on a torch.profiler trace's clock, the staged
engine's phase spans under the CLI loop's depth-2 prefetch (each batch's
gap_host_s / ext_host_s equal to its own spans), and phase 1's native
stage counters (yaha_prof.h through yt_batch_prof) against the seed
scan's and the Python front end's own counts.
"""
import gzip
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from conftest import DATA, GOLD

INDEX = "testgen.X11_01_65525S"


@pytest.fixture
def rec():
    from yaha_tpu_torch.utils import timing
    timing.RECORDER.enable()
    yield timing.RECORDER
    timing.RECORDER.disable()


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_timing")
    for f in ("readsA_100bp.fasta", "readsC_1kb.fasta"):
        shutil.copy(os.path.join(DATA, f), d)
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), d)
    with gzip.open(os.path.join(GOLD, INDEX + ".gz")) as f:
        with open(os.path.join(d, INDEX), "wb") as out:
            out.write(f.read())
    return str(d)


def by_name(spans, name):
    return [s for s in spans if s[1] == name]


def dur(s):
    return (s[6] - s[5]) * 1e-9


# ---- the recorder ----

def test_nesting_parents_and_counts(rec):
    from yaha_tpu_torch.utils.timing import span
    with span("outer", batch=3, reads=10) as a:
        with span("mid") as b:
            with span("leaf", d2h=4) as c:
                rec.count(d2h=6, h2d=1)
            b.add(launches=2)
        with span("mid2"):
            pass
    got = {s[1]: s for s in rec.spans()}
    assert [s[1] for s in rec.spans()] == ["leaf", "mid", "mid2", "outer"]
    assert got["outer"][3] == 0 and got["outer"][2] == 3
    assert got["mid"][3] == a.id and got["mid2"][3] == a.id
    assert got["leaf"][3] == b.id and got["leaf"][0] == c.id
    assert {s[2] for s in got.values()} == {3}
    assert got["leaf"][7] == {"d2h": 10, "h2d": 1}
    assert got["mid"][7] == {"launches": 2}
    assert got["outer"][7] == {"reads": 10}
    for child, parent in (("leaf", "mid"), ("mid", "outer"),
                          ("mid2", "outer")):
        assert got[parent][5] <= got[child][5] <= got[child][6] <= \
            got[parent][6]


def test_start_stop_are_the_span_bounds(rec):
    """sp.start() / sp.stop(t0) give the sums their clock reads, and the
    same reads are the span's start and end."""
    from yaha_tpu_torch.utils.timing import span
    with span("timed") as sp:
        time.sleep(0.001)
        t0 = sp.start()
        time.sleep(0.002)
        secs = sp.stop(t0)
        time.sleep(0.001)
    s = by_name(rec.spans(), "timed")[0]
    assert s[5] == t0
    assert dur(s) == pytest.approx(secs, abs=1e-12)
    assert secs >= 0.002


def test_batch_ids_across_two_worker_threads(rec):
    from yaha_tpu_torch.utils.timing import span
    barrier = threading.Barrier(2, timeout=30)

    def work(seq):
        with span("align", batch=seq):
            barrier.wait()
            for _ in range(3):
                with span("staged.gap"):
                    with span("dispatch.wait"):
                        time.sleep(0.001)
            barrier.wait()
    ts = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    spans = rec.spans()
    ids = {s[0]: s for s in spans}
    aligns = by_name(spans, "align")
    assert sorted(s[2] for s in aligns) == [0, 1]
    assert len({s[4] for s in aligns}) == 2
    # the two batches overlap in time, and no span takes the other's id
    a0, a1 = sorted(aligns, key=lambda s: s[2])
    assert a0[5] < a1[6] and a1[5] < a0[6]
    for s in spans:
        if s[1] == "align":
            continue
        up = ids[s[3]]
        assert up[4] == s[4] and up[2] == s[2]
        root = s
        while root[3]:
            root = ids[root[3]]
        assert root[1] == "align" and root[2] == s[2]
    assert len(by_name(spans, "dispatch.wait")) == 6
    assert set(rec.threads) == {s[4] for s in aligns}


def test_nothing_recorded_when_off():
    """Off, span() is the one shared do-nothing object, nothing is
    appended, and start/stop still time the sums."""
    from yaha_tpu_torch.utils import timing
    rec = timing.RECORDER
    rec.disable()
    assert not rec.recording()
    before = rec.spans()
    sp = timing.span("align", batch=1, reads=5)
    assert sp is timing.OFF
    with sp as s:
        t0 = s.start()
        s.add(launches=1)
        rec.count(h2d=3)
        assert s.stop(t0) >= 0.0
    assert rec.spans() == before


def test_a_new_recording_starts_after_off(rec):
    from yaha_tpu_torch.utils import timing
    with timing.span("first"):
        pass
    rec.disable()
    assert not rec.recording()
    assert [s[1] for s in rec.spans()] == ["first"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert rec.recording()
        with timing.span("second"):
            pass
    assert [s[1] for s in rec.spans()] == ["second"]


def test_span_lands_on_the_trace_clock(tmp_path):
    """The recorder's span around a record_function block lands within
    1 ms of it in the exported CPU trace (device_trace's merge)."""
    from yaha_tpu_torch.utils.timing import device_trace, span
    with device_trace(str(tmp_path)):
        with span("probe"):
            with torch.profiler.record_function("probe_rf"):
                time.sleep(0.02)
    files = os.listdir(tmp_path)
    assert files == ["yaha_trace_%d.json" % os.getpid()]
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "yaha"]
    assert [e["name"] for e in mine] == ["probe"]
    rf = next(e for e in events if e.get("name") == "probe_rf"
              and e.get("ph") == "X")
    p = mine[0]
    assert p["tid"] == threading.get_native_id() == rf["tid"]
    assert abs(p["ts"] - rf["ts"]) < 1000.0
    assert abs((p["ts"] + p["dur"]) - (rf["ts"] + rf["dur"])) < 1000.0
    assert p["args"]["parent"] == 0 and p["dur"] >= 20000.0


# ---- the staged engine's spans under the CLI loop ----

def _loop(scratch, qfile, flags, seeded, batch=32):
    """The CLI's streaming loop over `qfile` with a StagedAligner on the
    CPU (its prefetch on), as cli._do_query builds them; returns
    (aligner stats, SAM path, seeder stats or None)."""
    from yaha_tpu_torch import cli
    from yaha_tpu_torch.io import native_loader
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    from yaha_tpu_torch.models.staged import StagedAligner
    out = os.path.join(scratch, "spans_%s_%d.sam" % (qfile, seeded))
    aa, _, _ = cli.parse_args(
        ["-x", os.path.join(scratch, INDEX), "-q",
         os.path.join(scratch, qfile), "--device", "cpu", "--batch-size",
         str(batch), "-osh", out] + flags)
    genome = native_loader.load_genome(aa.gfile_name)
    index = native_loader.load_index(aa.xfile_name)
    cli._take_index_params(aa, index)
    seeder = DeviceSeeder(aa, index, device="cpu") if seeded else None
    st = StagedAligner(aa, genome, index, device="cpu", n_threads=2,
                       seeder=seeder)

    def align_fn(pr, lo, hi, dist=None, want_stats=False):
        text, sm, nr = st.align_chunk(pr, lo, hi, dist=dist)
        return text, None, sm, nr
    cli._run_native_engine(aa, genome, align_fn, st.stats)
    return st.stats, out, seeder.stats if seeded else None


PHASES = ("staged.phase1", "staged.gap", "staged.phase2", "staged.ext",
          "staged.finish", "staged.free")


@pytest.mark.parametrize("qfile,flags,gold,seeded", [
    ("readsA_100bp.fasta", [], "A_default.sam", True),
    ("readsC_1kb.fasta", ["-BW", "3", "-G", "20", "-M", "15", "-X", "15"],
     "C_params.sam", False),
], ids=["A_device_seed", "C_params"])
def test_staged_spans_under_prefetch(scratch, rec, qfile, flags, gold,
                                     seeded):
    """Every batch has one `align` root and one of each phase span under
    it, children lie inside their parents on their thread, and each
    batch's gap / extension host time (the span's host_s, added to
    gap_host_s / ext_host_s) is >= 0 and equal to its span less its own
    dispatch children, whatever the other batch in flight adds."""
    stats, out, seed_stats = _loop(scratch, qfile, flags, seeded)
    with open(out, "rb") as f, open(os.path.join(GOLD, gold), "rb") as g:
        strip = [[ln for ln in x.read().split(b"\n")
                  if not ln.startswith(b"@PG")] for x in (f, g)]
    assert strip[0] == strip[1]
    spans = rec.spans()
    ids = {s[0]: s for s in spans}
    aligns = by_name(spans, "align")
    n = len(aligns)
    assert n >= 2 and sorted(s[2] for s in aligns) == list(range(n))
    for s in spans:
        if s[3]:
            up = ids[s[3]]
            assert up[4] == s[4] and up[5] <= s[5] <= s[6] <= up[6], s
            assert s[2] == up[2]
    kids = {}
    for s in spans:
        kids.setdefault(s[3], []).append(s)
    names = PHASES + ("staged.upload",) + (("seeder.seed",) if seeded
                                           else ())
    for a in aligns:
        under = [k[1] for k in kids.get(a[0], [])]
        assert sorted(under) == sorted(names), under
    for phase, key, child in (("staged.gap", "gap_host_s", "dispatch.gap"),
                              ("staged.ext", "ext_host_s", "dispatch.ext")):
        total = 0.0
        for s in by_name(spans, phase):
            own = [k for k in kids.get(s[0], [])]
            assert {k[1] for k in own} <= {child}
            host_s = s[7]["host_s"]
            assert host_s >= 0.0
            assert host_s == pytest.approx(
                dur(s) - sum(dur(k) for k in own), abs=1e-9)
            total += host_s
        assert stats[key] == pytest.approx(total, rel=1e-9, abs=1e-12)
    waits = by_name(spans, "dispatch.wait")
    assert waits and all(ids[w[3]][1] in ("dispatch.gap", "dispatch.ext")
                         for w in waits)
    assert stats["dispatch_wait_s"] == pytest.approx(
        sum(dur(w) for w in waits), rel=1e-9)
    assert stats["dispatch_wait_s"] <= stats["device_s"]
    assert stats["begin_s"] == pytest.approx(
        sum(dur(s) for s in by_name(spans, "staged.phase1")), rel=1e-9)
    assert stats["p1_stage1_s"] > 0 and stats["p1_clumps_s"] > 0
    if seeded:
        fetches = by_name(spans, "seeder.fetch")
        splices = by_name(spans, "seeder.splice")
        assert fetches and all(ids[f[3]][1] == "seeder.seed"
                               for f in fetches + splices)
        # seed_device_s stops where the splice starts; seeder.seed goes on.
        seeds = by_name(spans, "seeder.seed")
        assert 0 < seed_stats["seed_device_s"] <= sum(map(dur, seeds)) - sum(
            map(dur, splices)) + 1e-9
    else:
        assert stats["p1_scan_s"] > 0
    main = threading.get_native_id()
    loop = {s[1] for s in spans if s[4] == main}
    assert {"stream.read", "stream.parse", "stream.wait",
            "stream.put"} <= loop
    assert by_name(spans, "stream.emit")
    assert all(s[4] != main for s in by_name(spans, "stream.emit"))


def _counts(st):
    return {k: v for k, v in st.stats.items() if not k.endswith("_s")}


def test_stats_sums_the_same_on_or_off(scratch):
    """The launch, byte and problem counts are the same with the recorder
    on and off; the time sums are filled either way; phase 1's native
    sums only while it is on."""
    from yaha_tpu_torch import host
    from yaha_tpu_torch.io import native_loader
    from yaha_tpu_torch.models.staged import StagedAligner
    from yaha_tpu_torch.utils.timing import RECORDER
    aa = host.AlignmentArgs()
    aa.xfile_name, aa.qfile_name, aa.ofile_name = INDEX, "r.fa", "o.sam"
    aa.post_process(True)
    genome = native_loader.load_genome(os.path.join(scratch, "testgen.nib2"))
    index = native_loader.load_index(os.path.join(scratch, INDEX))
    aa.word_len = index.word_len
    with open(os.path.join(scratch, "readsA_100bp.fasta"), "rb") as f:
        pr = host.parse_queries_native(f.read(), False, aa.max_query_length,
                                       aa.word_len)
    got = []
    for on in (False, True):
        st = StagedAligner(aa, genome, index, device="cpu", n_threads=2)
        if on:
            RECORDER.enable()
        try:
            text = st.align_chunk(pr, 0, pr.n)[0]
        finally:
            RECORDER.disable()
        got.append((text, st.stats))
    (t0, off), (t1, on) = got
    assert t0 == t1
    assert {k: v for k, v in off.items() if not k.endswith("_s")} == \
        {k: v for k, v in on.items() if not k.endswith("_s")}
    for k in ("device_s", "begin_s", "gap_host_s", "phase2_s", "ext_host_s",
              "finish_s", "dispatch_wait_s"):
        assert off[k] > 0 and on[k] > 0, k
    assert off["p1_scan_s"] == off["p1_clumps_s"] == off["p1_stage1_s"] == 0
    assert on["p1_scan_s"] > 0 and on["p1_stage1_s"] > 0


# ---- phase 1's native counters ----

class _KeepProf:
    """The native library with yt_batch_free wrapped: each batch's stage
    sums are kept (native/host.profile_counters) before it is freed."""

    def __init__(self, lib):
        self._lib = lib
        self.kept = []

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def yt_batch_free(self, ctx):
        from yaha_tpu_torch.native import host
        self.kept.append(host.profile_counters(ctx))
        self._lib.yt_batch_free(ctx)


def _front_end_counts(data, aa, index_path):
    """Hits, fragments and clumps of every read's two strands: hits and
    clumps as yt_seed_to_clumps reports them (native/host.seed_to_clumps),
    fragments from the Python front end (core/frags)."""
    from yaha_tpu_torch.core.frags import find_fragments, seed_hits
    from yaha_tpu_torch.io import index_io
    from yaha_tpu_torch.native import host
    from yaha_tpu_torch.utils import codec
    index = index_io.load_index(index_path)
    hits = frags = clumps = 0
    for rec_ in data.split(b">")[1:]:
        seq = b"".join(rec_.split(b"\n")[1:])
        fwd = codec.map8to4(np.frombuffer(seq, np.uint8))
        for codes in (fwd, codec.complement4to4(fwd)[::-1]):
            codes = np.ascontiguousarray(codes)
            offs, o_sqo, _, _, _, total = host.seed_to_clumps(codes, index,
                                                              aa)
            hits += total
            clumps += len(offs) - 1
            o, so, c = seed_hits(codes, index, aa.max_hits)
            frags += len(find_fragments(o, so, c, index.roa,
                                        index.word_len))
    return hits, frags, clumps


@pytest.mark.parametrize("threads", [1, 3])
def test_native_phase1_counters(scratch, threads):
    """With the flag on (recorder on), phase 1's counters are non-zero and
    its hit, fragment and clump counts equal the front end's own; with it
    off, every sum of the batch is 0 (no slot bound)."""
    from yaha_tpu_torch import host
    from yaha_tpu_torch.io import native_loader
    from yaha_tpu_torch.models.staged import StagedAligner
    from yaha_tpu_torch.utils.timing import RECORDER
    aa = host.AlignmentArgs()
    aa.xfile_name, aa.qfile_name, aa.ofile_name = INDEX, "r.fa", "o.sam"
    aa.post_process(True)
    genome = native_loader.load_genome(os.path.join(scratch, "testgen.nib2"))
    index = native_loader.load_index(os.path.join(scratch, INDEX))
    aa.word_len = index.word_len
    with open(os.path.join(scratch, "readsA_100bp.fasta"), "rb") as f:
        data = f.read()
    pr = host.parse_queries_native(data, False, aa.max_query_length,
                                   aa.word_len)
    st = StagedAligner(aa, genome, index, device="cpu", n_threads=threads,
                       backend="native")
    st.lib = keep = _KeepProf(st.lib)
    st.align_chunk(pr, 0, pr.n)
    RECORDER.enable()
    try:
        _, sm, _ = st.align_chunk(pr, 0, pr.n)
    finally:
        RECORDER.disable()
    off, on = keep.kept
    from yaha_tpu_torch.native import host as native
    assert set(off) == set(native.PROFILE_SECONDS + native.PROFILE_COUNTS)
    assert all(v == 0 for v in off.values())
    hits, frags, clumps = _front_end_counts(
        data, aa, os.path.join(scratch, INDEX))
    assert on["hits"] == sm == hits > 0
    assert on["frags"] == frags > 0
    assert on["clumps"] == clumps > 0
    for k in ("scan_hash", "scan_so", "scan_roa", "sort", "f2c", "stage1"):
        assert on[k] > 0, k
    assert on["hits_f2c"] == 0
    p1 = by_name(RECORDER.spans(), "staged.phase1")[-1][7]
    assert p1["hits"] == hits and p1["scan_so_s"] == on["scan_so"]


def test_native_counters_with_the_device_seeder(scratch):
    """Strands fed by the device seeder count their hit rows and time
    their coalesce + fragments-to-clumps (hits_f2c); the fragments are
    the front end's (phantom hits included); no row takes the host scan
    on readsA."""
    from yaha_tpu_torch import host
    from yaha_tpu_torch.io import native_loader
    from yaha_tpu_torch.models.seeder import DeviceSeeder
    from yaha_tpu_torch.models.staged import StagedAligner
    from yaha_tpu_torch.utils.timing import RECORDER
    aa = host.AlignmentArgs()
    aa.xfile_name, aa.qfile_name, aa.ofile_name = INDEX, "r.fa", "o.sam"
    aa.post_process(True)
    genome = native_loader.load_genome(os.path.join(scratch, "testgen.nib2"))
    index = native_loader.load_index(os.path.join(scratch, INDEX))
    aa.word_len = index.word_len
    with open(os.path.join(scratch, "readsA_100bp.fasta"), "rb") as f:
        data = f.read()
    pr = host.parse_queries_native(data, False, aa.max_query_length,
                                   aa.word_len)
    seeder = DeviceSeeder(aa, index, device="cpu")
    st = StagedAligner(aa, genome, index, device="cpu", n_threads=2,
                       seeder=seeder, backend="native")
    st.lib = keep = _KeepProf(st.lib)
    RECORDER.enable()
    try:
        st.align_chunk(pr, 0, pr.n)
    finally:
        RECORDER.disable()
    (on,) = keep.kept
    _, frags, clumps = _front_end_counts(data, aa,
                                         os.path.join(scratch, INDEX))
    assert seeder.stats["fallback_rows"] == 0
    assert on["hits_f2c"] > 0 and on["hits"] > 0
    assert on["scan_hash"] == on["scan_so"] == on["scan_roa"] == 0
    assert on["frags"] == frags and on["clumps"] == clumps


@pytest.mark.parametrize("threads", ["1", "2"])
def test_yt_profile_report_of_the_native_engine(scratch, threads):
    """YT_PROFILE=1 makes the per-read native engine print its [yt_prof]
    report from the same accumulator: the scan's hits equal the seed
    matches the -v report counts."""
    import re
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, YT_PROFILE="1")
    r = subprocess.run(
        [sys.executable, "-m", "yaha_tpu_torch.cli", "-x", INDEX, "-q",
         "readsA_100bp.fasta", "--engine", "native", "-t", threads, "-v",
         "-osh", "native_prof_%s.sam" % threads], cwd=scratch, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[yt_prof] reads=200 " in r.stderr
    scan = re.search(r"\[yt_prof2\] scan=([0-9.]+)s .* hits=(\d+) "
                     r"frags=(\d+)", r.stderr)
    seeds = re.search(r"Processed 200 reads: (\d+) seed matches", r.stderr)
    assert scan and seeds
    assert float(scan.group(1)) > 0 and int(scan.group(3)) > 0
    assert int(scan.group(2)) == int(seeds.group(1)) > 0


def test_verbose_report_uses_the_loop_wall(scratch, monkeypatch, capsys):
    """-v: the stage lines against the loop's wall, the throughput over
    that wall, and the dispatch's wait on the card named apart."""
    import re
    from yaha_tpu_torch import cli
    monkeypatch.chdir(scratch)
    rc = cli.main(["-x", INDEX, "-q", "readsA_100bp.fasta", "--device",
                   "cpu", "-v", "-osh", "verbose_A.sam"])
    assert rc == 0
    err = capsys.readouterr().err
    total = float(re.search(r"^total: +([0-9.]+)s$", err, re.M).group(1))
    rate = int(re.search(r"^Throughput: (\d+) reads/s\.$", err,
                         re.M).group(1))
    assert abs(rate - 200 / total) <= 1 + 0.01 * rate
    assert re.search(r"^parse took: +[0-9.]+s", err, re.M)
    assert re.search(r"^emit took: +[0-9.]+s", err, re.M)
    assert "align batch" not in err
    m = re.search(r"Device DP: .*; ([0-9.]+)s in the dispatch, ([0-9.]+)s "
                  r"of it blocked on the card's results;", err)
    assert m and float(m.group(2)) <= float(m.group(1))
