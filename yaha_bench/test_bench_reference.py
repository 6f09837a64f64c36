"""The reference's aligner shared out among worker processes: the same
records, byte for byte and in the same order, as one loop over the reads,
and a worker's failure raised to the caller.  The reference's DP core on
Python lists against its numpy-scalar version, problem by problem and
read by read.

    python -m pytest -q yaha_bench/test_bench_reference.py
"""
import multiprocessing
import os
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest

from yaha_bench.reference import fasta as rfasta, index as rindex, runner
from yaha_bench.reference.core import sw
from yaha_bench.reference.core.editops import DELETE, INSERT, MATCH, REPLACE
from yaha_bench.reference.core.pipeline import QueryState, align_query
from yaha_bench.traffic import generator, genome

SPEC = {"bases": 600_000, "chromosomes": 3,
        "repeat_unit_lengths": [150, 320, 500], "repeat_every": 20_000,
        "n_runs_per_chromosome": 1, "n_run_length": [10, 1000]}
SEED = 2**31 + 2020
SUBS = {"kind": "sampled", "share": 0.5, "prefix": "s", "substitution": 0.05}
INDELS = dict(SUBS, prefix="i", indel_events=0.0075, indel_geometric_p=0.7)


@pytest.fixture(scope="module")
def case():
    """(run configuration, genome, index, FASTA) over a 600 kbp genome and
    an L11 index: 1 kb and 10 kb reads with substitutions and with indel
    events, reads across a deletion (split), and random bases (no
    alignment)."""
    g = genome.make_genome(SPEC, SEED, "cpu")
    idx = rindex.build(g.codes, g.starts, g.lengths, 11, 1, 65525)
    aa = runner.alignment_args([], idx)
    reads = []
    for n, length in ((6, 1000), (3, 10_000)):
        for k, part in enumerate((SUBS, INDELS)):
            reads += generator.sampled(g, n, dict(part, length=length),
                                       genome.generator(SEED, "cpu", k))
    chrom = g.chrom(1)
    reads += [np.concatenate([chrom[5000 + s:5600 + s],
                              chrom[9000 + s:9600 + s]]) for s in (0, 3000)]
    rng = np.random.default_rng(5)
    reads += [rng.integers(0, 4, 1000).astype(np.uint8)]
    pool = [("r%d" % k, r) for k, r in enumerate(reads)]
    rg = runner.genome(g.names, g.starts, g.lengths, g.codes)
    return aa, rg, idx, generator.fasta(pool)


def loop(aa, rg, idx, data):
    """The reference's records read after read in this process."""
    qs = QueryState(aa, rg, idx)
    aa.fastq = False
    return {rec.query_id: align_query(qs, rec)
            for rec in rfasta.read_queries(data, aa)}


@pytest.fixture(scope="module")
def want(case):
    return loop(*case)


def cpus(monkeypatch, n):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(n)))


def test_case_has_each_kind(want):
    texts = list(want.values())
    lines = [t.count("\n") for t in texts]
    assert len(texts) == 21
    assert lines[20] == 0                   # the random read
    assert any(n >= 2 for n in lines[18:20])   # a split read
    assert all(n >= 1 for n in lines[:18])


def test_workers_align_as_one_loop(case, want, monkeypatch):
    cpus(monkeypatch, 4)
    assert runner.workers() == 4
    got = runner.align(*case)
    assert list(got.items()) == list(want.items())
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("why", ["one_cpu", "no_fork"])
def test_fallback_aligns_in_the_caller(case, want, monkeypatch, why):
    if why == "one_cpu":
        cpus(monkeypatch, 1)
    else:
        cpus(monkeypatch, 4)
        monkeypatch.setattr(multiprocessing, "get_all_start_methods",
                            lambda: ["spawn"])
    assert runner.workers() == 1
    got = runner.align(*case)
    assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("fault", ["raises", "dies"])
def test_a_workers_failure_reaches_the_caller(case, monkeypatch, fault):
    """A read whose worker raises, or whose worker process ends, raises in
    the caller: never a missing read or a passing one."""
    real = runner.align_query

    def align_query(qs, rec):
        if rec.query_id == "r7":
            if fault == "dies":
                os._exit(3)
            raise ValueError("planted in r7")
        return real(qs, rec)
    monkeypatch.setattr(runner, "align_query", align_query)
    cpus(monkeypatch, 4)
    with pytest.raises(ValueError if fault == "raises" else
                       BrokenProcessPool):
        runner.align(*case)
    assert not multiprocessing.active_children()


DP_WORST = sw.DP_WORST
_UNKNOWN = sw._UNKNOWN


def loop_dp(aa, q, r, banded, extension, reverse, xcutoff,
                           band_width):
    """sw._find_affine_gap_score as it was before its rows and cells
    became Python lists: numpy arrays read and written a scalar at a time
    through accessor functions."""
    go, ge = aa.go_cost, aa.ge_cost
    rc, ms = aa.r_cost, aa.m_score
    max_intron, max_gap = aa.max_intron, aa.max_gap
    q_len, r_len = len(q), len(r)
    arr_height = q_len + 1

    if banded:
        if extension:
            bandwidth = 2 * band_width
            left_bw = right_bw = bandwidth
            maxi = maxj = 0
        else:
            bandwidth = band_width
            if r_len > q_len:
                right_bw = bandwidth + (r_len - q_len)
                left_bw = bandwidth
            else:
                left_bw = bandwidth + (q_len - r_len)
                right_bw = bandwidth
            maxi, maxj = q_len, right_bw
        arr_width = left_bw + right_bw + 1
    else:
        bandwidth = band_width
        left_bw = right_bw = 0
        arr_width = r_len + 1
        maxi, maxj = arr_height - 1, arr_width - 1

    # Backtrack arrays (+1 col of headroom like the reference's arrWidth+2
    # overflow slots; we size exactly and guard instead).
    eo = np.full((arr_height, arr_width), _UNKNOWN, dtype=object)
    idc = np.zeros((arr_height, arr_width), dtype=np.int64)

    # PVRow has a [-1] hack slot in the reference (DPInit, SW.cpp:385-388).
    pv = np.full(arr_width + 2, DP_WORST, dtype=np.int64)   # index shift +1
    pf = np.full(arr_width + 2, DP_WORST, dtype=np.int64)
    pi = np.zeros(arr_width + 2, dtype=np.int64)

    def PV(i):
        return pv[i + 1]

    def PVset(i, v):
        pv[i + 1] = v

    def PF(i):
        return pf[i + 1]

    def PFset(i, v):
        pf[i + 1] = v

    def PI(i):
        return pi[i + 1]

    def PIset(i, v):
        pi[i + 1] = v

    if banded:
        start_init = left_bw + 1
        eo[0][left_bw] = _UNKNOWN
        idc[0][left_bw] = 0
        PFset(arr_width, DP_WORST)
        PVset(arr_width, DP_WORST)
        PIset(arr_width, 0)
    else:
        start_init = 1
        eo[0][0] = _UNKNOWN
        idc[0][0] = 0
    end_init = arr_width
    delete_count = 1
    for j in range(start_init, end_init):
        eo[0][j] = DELETE
        idc[0][j] = delete_count
        PVset(j, -(go + delete_count * ge))
        delete_count += 1
        PFset(j, DP_WORST)
        PIset(j, 0)
    PFset(start_init - 1, 0)
    PIset(start_init - 1, 0)
    PVset(start_init - 1, 0)

    # The reference initializes leftBW rows here even when qLen < leftBW
    # (its arrays are maxQueryLength tall, SW.cpp:925-933); rows beyond
    # qLen are never read, so clamping is equivalent.
    end_init = min(left_bw if banded else arr_height - 1, arr_height - 1)
    for i in range(1, end_init + 1):
        loffset = (left_bw - i) if banded else 0
        eo[i][loffset] = INSERT
        idc[i][loffset] = i

    max_score = DP_WORST
    cutoff = aa.x_cutoff

    if not banded:
        start_col, end_col = 1, arr_width - 1

    V = 0
    for i in range(1, arr_height):
        pd_col = 0
        pe_col = DP_WORST
        if banded:
            start_col = left_bw + 1 - i
            if start_col <= 0:
                start_col = 0
                pv_col = DP_WORST
            else:
                pv_col = -(go + i * ge)
                PVset(start_col - 1, pv_col)
            end_col = min(left_bw + r_len - i, arr_width - 1)
        else:
            pv_col = -(go + i * ge)

        row_max = DP_WORST
        q_char = q[1 - i] if reverse else q[i - 1]
        r_row_start = i - left_bw - 1 if banded else 0

        eo_row = eo[i]
        idc_row = idc[i]
        for j in range(start_col, end_col + 1):
            rm_off = j if banded else j - 1
            i_off = rm_off + 1

            V = PV(rm_off)
            r_char = r[r_row_start + j] if banded else r[j - 1]
            if q_char == r_char:
                V += ms
                opcode = MATCH
            else:
                V -= rc
                opcode = REPLACE

            # Delete (gap in query, consumes reference).
            ce = pe_col - ge
            ne = pv_col - (go + ge)
            if ce >= ne and (pd_col + 1) <= max_intron:
                pe_col = ce
                pd_col += 1
            else:
                pe_col = ne
                pd_col = 1
            if (pe_col >= V) if extension else (pe_col > V):
                V = pe_col
                opcode = DELETE
                idc_row[j] = pd_col

            # Insert (gap in reference, consumes query).
            cf = PF(i_off) - ge
            nf = PV(i_off) - (go + ge)
            if cf >= nf and (PI(i_off) + 1) <= max_gap:
                F = cf
                I = PI(i_off) + 1
            else:
                F = nf
                I = 1
            if (F >= V) if extension else (F > V):
                V = F
                opcode = INSERT
                idc_row[j] = I
            PFset(j, F)
            PIset(j, I)

            eo_row[j] = opcode
            if xcutoff and V > row_max:
                row_max = V
            if extension and V > max_score:
                max_score = V
                maxi, maxj = i, j
            if banded:
                PVset(j, V)
            else:
                PVset(j - 1, pv_col)
            pv_col = V

        if xcutoff and extension and row_max < (max_score - cutoff):
            break
        if not banded:
            PVset(end_col, V)

    retval = max_score if extension else V
    if extension and retval <= 0:
        return 0, [], 0, 0, bandwidth

    # Backtrack (SW.cpp:1137-1195).
    x, y = maxj, maxi
    prev_code = eo[y][x]
    op_len = 0
    items = []  # built via front-insert (forward) or append (reverse)
    while True:
        code = eo[y][x]
        if code == _UNKNOWN:
            break
        eolen = int(idc[y][x])
        if banded:
            if code == DELETE:
                x -= eolen
            elif code == INSERT:
                x += eolen
                y -= eolen
            else:
                y -= 1
                eolen = 1
        else:
            if code == DELETE:
                x -= eolen
            elif code == INSERT:
                y -= eolen
            else:
                x -= 1
                y -= 1
                eolen = 1
        if prev_code != code:
            if reverse:
                items.append([prev_code, op_len])
            else:
                items.insert(0, [prev_code, op_len])
            prev_code = code
            op_len = eolen
        else:
            op_len += eolen
    if reverse:
        items.append([prev_code, op_len])
    else:
        items.insert(0, [prev_code, op_len])

    return retval, items, maxi, maxj, bandwidth


@pytest.mark.parametrize("kind", ["full", "banded", "extension",
                                  "reverse_extension"])
def test_dp_core_as_the_numpy_loop(case, kind):
    """Random gap fills and X-drop extensions (related and unrelated
    sequences, N codes, band widths 1-8, indel run caps hit, gap and
    mismatch costs that tie): score,
    operations and end cell equal the numpy-scalar loop's, as exact
    integers."""
    rng = np.random.default_rng([SEED, len(kind)])
    for k in range(150):
        aa = runner.alignment_args([
            "-BW", str(1 + k % 8), "-G", str(3 + k % 40), "-I",
            str(2 + k % 50), "-GOC", str(k % 5), "-GEC", str(1 + k % 3),
            "-MS", str(1 + k % 2), "-RC", str(1 + k % 4)], case[2])
        n = int(rng.integers(1, 40 if kind in ("full", "banded") else 700))
        r = rng.integers(0, 4, n + int(rng.integers(0, 30))).astype(np.uint8)
        q = r[:n].copy()
        if k % 3:
            m = rng.random(n) < 0.1
            q[m] = rng.integers(0, 5, int(m.sum()))
            q = np.delete(q, rng.integers(0, n, int(rng.integers(0, 4))))
            q = np.insert(q, rng.integers(0, len(q) + 1, 3), [1, 2, 3])
        else:
            q = rng.integers(0, 4, n).astype(np.uint8)
        if kind == "full":
            args = (aa, q, r, False, False, False, False, aa.band_width)
        elif kind == "banded":
            args = (aa, q, r[:len(q) + int(rng.integers(0, 2 * aa.band_width
                                                         + 1))],
                    True, False, False, False, aa.band_width)
        elif kind == "extension":
            args = (aa, sw._LenWrap(q, len(q)), r, True, True, False, True,
                    aa.band_width)
        else:
            codes = np.concatenate([rng.integers(0, 4, 5).astype(np.uint8),
                                    q[::-1]])
            args = (aa, sw._LenWrap(sw._RevView(codes, len(codes) - 1),
                                    len(q)), r, True, True, True, True,
                    aa.band_width)
        assert sw._find_affine_gap_score(*args) == loop_dp(*args), k


def test_reads_as_with_the_numpy_loop(case, want, monkeypatch):
    """Every read's records with the DP core put back to the numpy-scalar
    loop are the records of the list version, byte for byte."""
    cpus(monkeypatch, 1)
    monkeypatch.setattr(sw, "_find_affine_gap_score", loop_dp)
    assert list(runner.align(*case).items()) == list(want.items())
