"""The program-span readers and spans.py on synthetic windows: the six
metrics that read the port's recorder, the stall, and the attribution of
the card's idle time to the spans open across it.

    python -m pytest -q yaha_bench/test_bench_spans.py
"""
import pytest

from yaha_bench import harness, spans

MS = 1_000_000          # ns


def sp(sid, name, tid, a_ms, b_ms, batch=None, parent=0, **counts):
    return (sid, name, batch, parent, tid, a_ms * MS, b_ms * MS, counts)


# Two batches on two workers (tids 2 and 3) under the main thread's loop
# (tid 1), in a window of 100 ms; the main thread reads before the first
# batch and waits after it.
WINDOW = [
    sp(1, "stream.read", 1, 0, 10),
    sp(2, "stream.parse", 1, 10, 20),
    sp(3, "align", 2, 20, 60, batch=0, reads=500),
    sp(4, "seeder.fetch", 2, 22, 25, batch=0, parent=3, d2h=100),
    sp(5, "dispatch.wait", 2, 40, 46, batch=0, parent=3, d2h=10),
    sp(6, "align", 3, 50, 90, batch=1, reads=500),
    sp(7, "dispatch.wait", 3, 70, 71, batch=1, parent=6),
    sp(8, "seeder.fetch", 3, 52, 53, batch=1, parent=6),
    sp(9, "stream.wait", 1, 20, 60, batch=0),
]


def ctx(program_spans=WINDOW, stats=None, reads=1000, window_s=0.1):
    st = {"p1_scan_s": 0.002, "p1_clumps_s": 0.003, "p1_stage1_s": 0.004}
    return {"reads": reads, "window_s": window_s, "stats": st if stats is
            None else stats, "program_spans": program_spans}


@pytest.mark.parametrize("name,want", [
    # 100 ms window, aligns open over [20, 90]: 30 ms stalled
    ("stream.stall_ms_per_kread", 30.0),
    ("staged.p1_scan_ms_per_kread", 2.0),
    ("staged.p1_clumps_ms_per_kread", 3.0),
    ("staged.p1_stage1_ms_per_kread", 4.0),
    ("dispatch.wait_ms_per_kread", 7.0),
    ("seeder.fetch_ms_per_kread", 4.0),
])
def test_reader_values(name, want):
    assert harness.load_reader(name)(ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "stream.stall_ms_per_kread", "staged.p1_scan_ms_per_kread",
    "staged.p1_clumps_ms_per_kread", "staged.p1_stage1_ms_per_kread",
    "dispatch.wait_ms_per_kread", "seeder.fetch_ms_per_kread"])
def test_readers_give_nothing_without_the_recorder(name, monkeypatch):
    """A program that records no spans and has no p1 sums (the parent
    commit's) reports none of the six; nor does a window with no reads."""
    read = harness.load_reader(name)
    monkeypatch.setattr(spans, "program_spans", lambda c=None: None)
    assert read(ctx(stats={"begin_s": 1.0})) is None
    monkeypatch.undo()
    assert read(ctx(reads=0)) is None


def test_span_readers_need_their_spans():
    only_aligns = [s for s in WINDOW if s[1] == "align"]
    assert harness.load_reader("seeder.fetch_ms_per_kread")(
        ctx(only_aligns)) is None
    assert harness.load_reader("dispatch.wait_ms_per_kread")(
        ctx(only_aligns)) is None
    no_align = [s for s in WINDOW if s[1] != "align"]
    assert harness.load_reader("stream.stall_ms_per_kread")(
        ctx(no_align)) is None


def test_stall_and_union():
    assert spans.union_s([(0, 10), (5, 20), (30, 40), (31, 32)]) == 30
    assert spans.stall_s(WINDOW, 0.1) == pytest.approx(0.03)
    # the stall never goes below zero
    assert spans.stall_s(WINDOW, 0.05) == 0.0
    assert spans.total_s(WINDOW, "dispatch.wait") == pytest.approx(0.007)
    assert spans.total_s(WINDOW, "nothing") is None


def test_program_spans_from_the_recorder():
    """Without ctx["program_spans"], the port's recorder's latest
    recording (while a profile is open or enable() holds) is read."""
    from yaha_tpu_torch.utils import timing
    rec = timing.RECORDER
    rec.enable()
    try:
        with timing.span("align", batch=7):
            with timing.span("dispatch.wait"):
                pass
    finally:
        rec.disable()
    got = spans.program_spans({"reads": 1})
    assert [s[1] for s in got] == ["dispatch.wait", "align"]
    assert got[0][2] == got[1][2] == 7
    assert got[0][3] == got[1][0]


def test_thread_roles():
    assert spans.thread_role("MainThread") == "main"
    assert spans.thread_role("Thread-3 (_writer)") == "writer"
    assert spans.thread_role("ThreadPoolExecutor-12_1") == "worker"


def test_idle_by_span_innermost_per_thread():
    """Idle pieces are split where spans open and close; each piece goes to
    the innermost span of each thread; time with no span open is the
    empty combination."""
    roles = {1: "main", 2: "worker", 3: "worker"}
    placed = [(tid, name, a / MS, b / MS)
              for _, name, _, _, tid, a, b, _ in WINDOW]
    idle = [(0, 30), (40, 50), (85, 100)]
    combos, covered, total = spans.idle_by_span(idle, placed, roles)
    assert total == 55
    want = {
        ("main:stream.read",): 10,
        ("main:stream.parse",): 10,
        ("main:stream.wait", "worker:align"): 2 + 5 + 4,
        ("main:stream.wait", "worker:seeder.fetch"): 3,
        ("main:stream.wait", "worker:dispatch.wait"): 6,
        ("worker:align",): 5,
        (): 10,
    }
    assert {c: pytest.approx(v) for c, v in combos.items() if v} == want
    assert covered == pytest.approx(45)


def test_idle_by_span_equal_starts_nest():
    """A parent and a child that start at the same instant: the child is
    the innermost."""
    placed = [(1, "parent", 0, 10), (1, "child", 0, 4)]
    combos, covered, total = spans.idle_by_span([(0, 10)], placed,
                                                {1: "worker"})
    assert combos[("worker:child",)] == 4
    assert combos[("worker:parent",)] == 6
    assert covered == total == 10


def test_phase_open():
    assert spans.phase_open(("main:stream.wait", "worker:dispatch.wait"))
    assert not spans.phase_open(("main:stream.wait", "worker:align"))
    assert not spans.phase_open(("main:stream.parse",))


def test_idle_table_on_a_trace(tmp_path):
    """A Chrome trace with the window's mark and one kernel: the idle
    stretches around the kernel, the spans placed by the window's start,
    the share under any span and the share under a worker's phase."""
    import json
    events = [{"name": "bench.window", "ph": "X", "ts": 1000.0,
               "dur": 100.0},
              {"name": "k", "cat": "kernel", "ph": "X", "ts": 1030.0,
               "dur": 10.0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    us = 1000    # ns, with the window's start at 0 on the spans' clock
    placed = [sp(1, "stream.wait", 1, 0, 0),
              sp(2, "align", 2, 0, 0, batch=0),
              sp(3, "staged.phase1", 2, 0, 0, batch=0, parent=2)]
    placed = [s[:5] + (a * us, b * us, s[7]) for s, (a, b) in zip(
        placed, [(0, 100), (0, 100), (0, 20)])]
    table = spans.idle_table(str(path), placed,
                             {1: "MainThread", 2: "ThreadPoolExecutor-0_0"},
                             0.0)
    assert table["idle_s"] == pytest.approx(90e-6)
    assert table["covered_pct"] == pytest.approx(100.0)
    assert table["phase_pct"] == pytest.approx(100.0 * 20 / 90)
    rows = dict((c, v) for c, v in table["rows"])
    assert rows["main:stream.wait + worker:staged.phase1"] == \
        pytest.approx(20e-6)
    assert rows["main:stream.wait + worker:align"] == pytest.approx(70e-6)
