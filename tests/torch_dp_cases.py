"""Numpy-seeded inputs shared by the port's tests.

tests/test_torch_sw.py holds the plain PyTorch versions to the JAX package
on these DP problems, tests/test_torch_gather.py the problem assembly on
these genomes and coordinates, and tests/test_torch_staged.py the engine
to the native one on these reads; tests/test_torch_cuda.py holds the CUDA
kernels and the engine to the same references on the card, and
chip_smoke.py draws its indel extension inputs from here;
tests/test_torch_index_build.py holds the index builder to the JAX
package's and the native one on the genomes of index_genome.  This module
imports neither jax nor torch nor anything of the JAX package (its codec
tables are the port's copy), so the card tests and chip_smoke.py run
where jax is not installed.
"""
import gzip
import os

import numpy as np

from yaha_tpu_torch.utils import codec

TESTS = os.path.dirname(os.path.abspath(__file__))

KW = dict(go=5, ge=2, rc=3, ms=1, max_gap=50, max_intron=50)
# DP_WORST - (go + ge) wraps int32 at this gap-open cost; the kernels must
# wrap exactly as JAX does.
KW_WRAP = dict(KW, go=300)

EXT_SWEEP = [
    # (band_width, x_cutoff, max_gap, max_intron, err)
    (5, 25, 50, 50, 0.15),
    (3, 15, 50, 50, 0.15),
    (3, 25, 2, 3, 0.3),        # run caps bind
    (5, 4, 50, 50, 0.5),       # X-drop fires early
]
EXT_SWEEP_IDS = ["bw5", "bw3", "caps", "xdrop"]

# The widths the wide extension kernel serves (W = 1 and W >= 37), apart
# from EXT_SWEEP, over which the register kernel's tests run.
WIDE_SWEEP = [
    # (band_width, x_cutoff, max_gap, max_intron, err)
    (0, 25, 50, 50, 0.15),
    (9, 25, 50, 50, 0.15),
    (9, 4, 50, 50, 0.5),       # X-drop fires early
    (9, 25, 2, 3, 0.3),        # run caps bind
    (16, 25, 50, 50, 0.15),
]
WIDE_SWEEP_IDS = ["bw0", "bw9", "xdrop9", "caps9", "bw16"]

ANCH_SWEEP = [
    # (seed, band offset d, max_gap, max_intron)
    (1, 2, 50, 50),
    (2, 5, 50, 50),
    (3, 3, 2, 3),              # run caps bind
]
ANCH_SWEEP_IDS = ["d2", "d5", "caps"]


def bands(n, qlens, rlens, d=2):
    """Alternating full-DP encodings and asymmetric bands
    (test_sw_pallas._bands)."""
    lbw = np.zeros(n, np.int64)
    rbw = np.zeros(n, np.int64)
    for k in range(n):
        if k % 2 == 0:
            lbw[k] = rbw[k] = max(qlens[k], rlens[k]) + 1
        elif rlens[k] >= qlens[k]:
            lbw[k], rbw[k] = d, d + (rlens[k] - qlens[k])
        else:
            lbw[k], rbw[k] = d + (qlens[k] - rlens[k]), d
    return lbw, rbw


def anchored_inputs(seed, n, ql, rl):
    """Unrelated q/r codes 0-4 with full-DP and asymmetric bands."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (n, ql)).astype(np.uint8)
    r = rng.integers(0, 5, (n, rl)).astype(np.uint8)
    qlens = rng.integers(1, ql + 1, n).astype(np.int64)
    rlens = rng.integers(1, rl + 1, n).astype(np.int64)
    lbw, rbw = bands(n, qlens, rlens)
    return q, qlens, r, rlens, lbw, rbw


def anchored_sweep_inputs(seed, d, n=300, ql=18, rl=22):
    """Related q/r (70 % shared codes) with bands offset by d."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (n, ql)).astype(np.uint8)
    r = rng.integers(0, 5, (n, rl)).astype(np.uint8)
    r[:, :ql] = np.where(rng.random((n, ql)) < 0.7, q, r[:, :ql])
    qlens = rng.integers(1, ql + 1, n).astype(np.int64)
    rlens = rng.integers(1, rl + 1, n).astype(np.int64)
    lbw, rbw = bands(n, qlens, rlens, d)
    return q, qlens, r, rlens, lbw, rbw


def anchored_edge_inputs(seed, n=96, ql=40, rl=48):
    """Gap fills at the anchored kernels' edges: first live widths at the
    register classes' edges (lbw + rbw + 1 and rlen of 8/9, 16/17, 32/33),
    lbw >= qlen (the insert boundary in every row), rlen < qlen, qlen = QL,
    empty query or reference; then narrow problems (live widths up to 8)
    in warps of 32 whose widest lane (lane 5) has a live width of 8, 16,
    17, 32, 9 or 33 in turn, so that every width class runs as a warp and
    warps mix classes."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (n, ql)).astype(np.uint8)
    r = rng.integers(0, 5, (n, rl)).astype(np.uint8)
    r[:, :ql] = np.where(rng.random((n, ql)) < 0.7, q, r[:, :ql])
    qlens = rng.integers(1, ql + 1, n)
    rlens = rng.integers(1, 9, n)
    lbw = rng.integers(0, 4, n)
    rbw = rng.integers(0, 4, n)
    rows = []
    for live in (8, 9, 16, 17, 32, 33):
        lb = live // 3
        rows += [(30, min(rl, 30 + live - 1 - 2 * lb), lb, live - 1 - lb),
                 (ql, live, 2, live - 3)]
    rows += [(10, 20, 12, 10), (5, 6, 6, 1), (35, 20, 17, 3), (30, 5, 27, 2),
             (ql, 44, 3, 7), (ql, rl, 4, 12), (0, 5, 2, 3), (7, 0, 8, 1)]
    for w, live in enumerate((8, 16, 17, 32, 9, 33)):
        if 32 * (w + 1) + 5 < n:
            rows += [(0, 0, 0, 0)] * (32 * (w + 1) + 5 - len(rows))
            lb = live // 3
            rows.append((int(qlens[len(rows)]), live, lb, live - 1 - lb))
    for k, row in enumerate(rows):
        if row != (0, 0, 0, 0):
            qlens[k], rlens[k], lbw[k], rbw[k] = row
    return q, qlens, r, rlens, lbw, rbw


def _pow2(x):
    return 1 << max(0, int(x) - 1).bit_length()


def _related(rng, ref, qlen, rlen, err):
    """A query of qlen codes read from ref[:rlen] with one insertion
    (qlen > rlen) or deletion (qlen < rlen) of |qlen - rlen| bases at a
    random place, then `err` substitutions."""
    d = qlen - rlen
    a = int(rng.integers(0, max(1, min(qlen, rlen)) + 1))
    if d >= 0:
        q = np.concatenate([ref[:a], rng.integers(0, 4, d).astype(np.uint8),
                            ref[a:rlen]])
    else:
        q = np.concatenate([ref[:a], ref[a - d:rlen]])
    q = q[:qlen].copy()
    m = rng.random(len(q)) < err
    q[m] = rng.integers(0, 4, int(m.sum()))
    return q


def anchored_wide_inputs(seed, live, full, n=64, ql=40, rl=None,
                         indel=True):
    """Gap fills for the anchored kernels' wide route: (q, qlen, r, rlen,
    lbw, rbw) and the plane width (banded wband, the power of two >= live;
    full RL + 1).  Lane 0 of every warp of 32 has live width `live`
    (banded lbw + rbw + 1, full min(rlen, RL)), the other lanes widths 1 ..
    live (lanes 4-11 at most 32), so warps mix narrow and wide lanes;
    lanes 1 and 2 of a warp have
    lbw = 0 and rbw = 0, lane 3 an empty query.  `indel`: queries differ
    from their reference by one insertion or deletion of |qlen - rlen|
    bases (the band's edge), else by substitutions alone (qlen = rlen where
    the band allows), at 5 % or 15 % substitutions.  RL defaults to ql +
    live (full: the power of two >= live)."""
    rng = np.random.default_rng(seed)
    width = rng.integers(1, live + 1, n)
    lane = np.arange(n) % 32
    narrow = (lane >= 4) & (lane < 12)
    width[narrow] = rng.integers(1, min(live, 32) + 1, int(narrow.sum()))
    width[::32] = live
    if full:
        rl = rl or _pow2(live)
    else:
        rl = rl or ql + live
    q = np.zeros((n, ql), np.uint8)
    r = rng.integers(0, 4, (n, rl)).astype(np.uint8)
    qlens, rlens, lbw, rbw = (np.zeros(n, np.int64) for _ in range(4))
    for k in range(n):
        wk = int(width[k])
        if full:
            rlen = min(wk, rl)
            lo = max(1, min(ql, rlen - 60))
            qlen = int(rng.integers(lo, min(ql, rlen + 60) + 1)) if indel \
                else max(1, min(rlen, ql))
            if k % 4 == 0:
                lb = rb = max(qlen, rlen) + 1     # an unbanded gap fill
            else:
                lb = 5 + max(0, qlen - rlen)      # findAGSAlignmentBanded
                rb = 5 + max(0, rlen - qlen)
        else:
            lb = int(rng.integers(0, wk))
            rb = wk - 1 - lb
            qlen = int(rng.integers(1, ql + 1))
            rlen = qlen + (int(rng.integers(-lb, rb + 1)) if indel else 0)
            rlen = int(np.clip(rlen, 0, rl))
        if k % 32 == 1:
            lb, rb = 0, max(lb + rb, 0)
        elif k % 32 == 2:
            lb, rb = max(lb + rb, 0), 0
        elif k % 32 == 3:
            qlen = 0
        q[k, :qlen] = _related(rng, r[k], qlen, rlen,
                               0.05 if indel else 0.15)
        qlens[k], rlens[k], lbw[k], rbw[k] = qlen, rlen, lb, rb
    w = rl + 1 if full else _pow2(live)
    return (q, qlens, r, rlens, lbw, rbw), w


def medium_indel_gaps(seed, n=96, band_width=5):
    """Gap fills of 1 kb reads with one insertion or deletion of 20-60
    bases (half of each) at 5 % substitutions, as the native pipeline
    makes them (yaha_pipe.cpp fill_gap / find_ags_alignment): the gap
    between the two fragments around the indel holds it and 0-24
    flanking bases on each side; banded when len_diff + 2 * band_width
    + 1 < r_gap (lbw, rbw from the length difference), else unbanded.
    Returns {"banded": (args, wband), "full": (args, RL + 1)}, each set
    bucketed as the staged engine buckets it (power-of-two QL and RL)."""
    rng = np.random.default_rng(seed)
    rows = {"banded": [], "full": []}
    for k in range(n):
        size = int(rng.integers(20, 61))
        left, right = (int(x) for x in rng.integers(0, 25, 2))
        ref = rng.integers(0, 4, left + right + size).astype(np.uint8)
        if k % 2:     # deletion: the reference holds `size` more bases
            rlen, qlen = left + right + size, left + right
            q = np.concatenate([ref[:left], ref[left + size:]])
        else:         # insertion
            rlen, qlen = left + right, left + right + size
            q = np.concatenate([ref[:left], rng.integers(
                0, 4, size).astype(np.uint8), ref[left:left + right]])
            ref = ref[:rlen]
        m = rng.random(len(q)) < 0.05
        q[m] = rng.integers(0, 4, int(m.sum()))
        diff = abs(qlen - rlen)
        if diff + 2 * band_width + 1 < rlen:
            lb = band_width + max(0, qlen - rlen)
            rb = band_width + max(0, rlen - qlen)
            rows["banded"].append((q, ref, lb, rb))
        else:
            lb = rb = max(qlen, rlen) + 1
            rows["full"].append((q, ref, lb, rb))
    out = {}
    for kind, rs in rows.items():
        ql = _pow2(max(16, max(len(x[0]) for x in rs)))
        rl = _pow2(max(16, max(len(x[1]) for x in rs)))
        q = np.zeros((len(rs), ql), np.uint8)
        r = np.zeros((len(rs), rl), np.uint8)
        for k, (qk, rk, _, _) in enumerate(rs):
            q[k, :len(qk)] = qk
            r[k, :len(rk)] = rk
        lens = [np.array([len(x[i]) for x in rs], np.int64) for i in (0, 1)]
        lb, rb = (np.array([x[i] for x in rs], np.int64) for i in (2, 3))
        w = _pow2(int((lb + rb).max()) + 1) if kind == "banded" else rl + 1
        out[kind] = ((q, lens[0], r, lens[1], lb, rb), w)
    return out


def indel_reads(fasta, n, seed):
    """FASTA of n 1 kb reads from the first sequence of `fasta` with 5 %
    substitutions and short insertions/deletions: their gap fills put
    bands wider than the reference tier into the small buckets, which the
    full-width kernel serves."""
    rng = np.random.default_rng(seed)
    with open(fasta, "rb") as f:
        chrom = f.read().split(b">")[1].split(b"\n", 1)[1].replace(b"\n",
                                                                  b"")
    bases = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for k in range(n):
        p = int(rng.integers(0, len(chrom) - 1000))
        r = np.frombuffer(chrom[p:p + 1000], np.uint8).copy()
        m = rng.random(1000) < 0.05
        r[m] = bases[rng.integers(0, 4, int(m.sum()))]
        parts, j = [], 0
        for e in np.sort(rng.choice(1000, 8, replace=False)):
            parts.append(r[j:e])
            size = int(rng.integers(1, 30))
            if rng.random() < 0.5:
                parts.append(bases[rng.integers(0, 4, size)])
                j = e
            else:
                j = max(e + size, j)
        parts.append(r[j:])
        recs.append(b">indel%d\n%s\n" % (k, np.concatenate(parts).tobytes()))
    return b"".join(recs)


def long_gap_reads(fasta, n=4, seed=31):
    """FASTA of n reads from the first sequence of `fasta`: a left flank of
    7-8 kb, 30-45 inserted random bases, then a right flank of 7-8 kb
    that starts 3.0-3.5 kb past the left one's end (a deletion).  At -G
    3,600 the chain joins across the deletion and its gap fill has a
    reference of 3,000-3,500 bases in an unbanded plane: an RL 4,096
    bucket, wider than the anchored wide route takes."""
    rng = np.random.default_rng(seed)
    with open(fasta, "rb") as f:
        chrom = f.read().split(b">")[1].split(b"\n", 1)[1].replace(b"\n",
                                                                  b"")
    bases = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for k in range(n):
        left, right = (int(x) for x in rng.integers(7000, 8001, 2))
        gap = int(rng.integers(3000, 3501))
        ins = bases[rng.integers(0, 4, int(rng.integers(30, 46)))]
        p = int(rng.integers(0, len(chrom) - left - gap - right))
        seq = np.concatenate([
            np.frombuffer(chrom[p:p + left], np.uint8), ins,
            np.frombuffer(chrom[p + left + gap:p + left + gap + right],
                          np.uint8)])
        recs.append(b">longgap%d_%d_%d\n%s\n" % (k, p, gap, seq.tobytes()))
    return b"".join(recs)


def extension_inputs(seed, n, ql, bw, err=0.15):
    """Queries and references that share a prefix at `err` substitutions,
    RL = QL + 4*bw as the staged engine lays them out."""
    rng = np.random.default_rng(seed)
    bw2 = 2 * bw
    rl = ql + 2 * bw2
    q = rng.integers(0, 4, (n, ql)).astype(np.uint8)
    qlens = rng.integers(1, ql + 1, n).astype(np.int64)
    r = np.zeros((n, rl), np.uint8)
    for k in range(n):
        L = qlens[k]
        r[k, :L] = q[k, :L]
        m = rng.random(L) < err
        r[k, :L][m] = rng.integers(0, 4, int(m.sum()))
        r[k, L:] = rng.integers(0, 4, rl - L)
    rlens = np.minimum(qlens + bw2, rl).astype(np.int64)
    return q, qlens, r, rlens


def xdrop_extension_inputs(seed, n, ql, bw, diverge, err=0.05):
    """Queries of QL bases and references (RL = QL + 4*bw) that agree, at
    `err` substitutions, up to row diverge[k % len(diverge)] of problem k
    and are random past it, so that its X-drop exit comes a few rows
    later; a row at or past QL keeps them alike to the end, where the last
    row ends the problem."""
    rng = np.random.default_rng(seed)
    bw2 = 2 * bw
    rl = ql + 2 * bw2
    q = rng.integers(0, 4, (n, ql)).astype(np.uint8)
    qlens = np.full(n, ql, np.int64)
    r = rng.integers(0, 4, (n, rl)).astype(np.uint8)
    for k in range(n):
        d = min(int(diverge[k % len(diverge)]), ql)
        src = q[k, :d].copy()
        m = rng.random(d) < err
        src[m] = rng.integers(0, 4, int(m.sum()))
        r[k, :d] = src
    rlens = np.minimum(qlens + bw2, rl).astype(np.int64)
    return q, qlens, r, rlens


def indel_extension_inputs(seed, n, ql, bw, err=0.05):
    """Queries and references (RL = QL + 4*bw) that share a prefix, then
    differ by a deletion or an insertion of 1..2*bw bases (one base at
    bw 0), then go on alike, at `err` substitutions: the best path leaves
    the band's centre column and, past the indel, runs along a column up
    to 2*bw away from it, the band's outer columns at the largest."""
    rng = np.random.default_rng(seed)
    bw2 = 2 * bw
    rl = ql + 2 * bw2
    q = rng.integers(0, 4, (n, ql)).astype(np.uint8)
    qlens = rng.integers(ql // 2, ql + 1, n).astype(np.int64)
    r = rng.integers(0, 4, (n, rl)).astype(np.uint8)
    for k in range(n):
        L = int(qlens[k])
        a = int(rng.integers(1, max(2, L // 4)))
        d = int(rng.integers(1, max(bw2, 1) + 1))
        if k % 2:      # the read lacks d reference bases
            src = np.concatenate([q[k, :a], rng.integers(0, 4, d), q[k, a:L]])
        else:          # the read has d bases the reference lacks
            src = np.concatenate([q[k, :a], q[k, min(a + d, L):L]])
        m = rng.random(len(src)) < err
        src[m] = rng.integers(0, 4, int(m.sum()))
        src = src[:rl]
        r[k, :len(src)] = src
    rlens = np.minimum(qlens + bw2, rl).astype(np.int64)
    return q, qlens, r, rlens


GENOME = 5000
N_READS = 12
LPAD = 128


def _genome(rng):
    g = rng.integers(0, 4, GENOME).astype(np.uint8)
    g[rng.random(GENOME) < 0.02] = rng.integers(4, 16)   # N and IUPAC
    return g


def _chunk(rng):
    """Forward code rows of a chunk as _chunk_rows lays them out: 4 past
    each read, pow2 row count, int32 lengths."""
    lens = np.zeros(16, np.int32)
    lens[:N_READS] = rng.integers(1, LPAD + 1, N_READS)
    lens[0] = LPAD
    fwd = np.full((16, LPAD), 4, np.uint8)
    for k in range(N_READS):
        fwd[k, :lens[k]] = rng.integers(0, 16, lens[k])
    return fwd, lens


def gather_coords(seed, m, qg, rg, rev_share):
    """Problem coordinates with every edge the native export produces:
    copies shorter than the problem (the zero fill), reversed problems,
    sources at both ends of the genome and of the strand rows."""
    rng = np.random.default_rng(seed)
    qlen = rng.integers(1, qg + 1, m)
    rlen = rng.integers(1, rg + 1, m)
    q_row = rng.integers(0, 2 * N_READS, m)
    q_copy = np.where(rng.random(m) < 0.3,
                      rng.integers(0, qlen + 1), qlen)
    q_src = rng.integers(0, LPAD - q_copy + 1)
    r_copy = np.where(rng.random(m) < 0.3,
                      rng.integers(0, rlen + 1), rlen)
    r_src = rng.integers(0, GENOME - r_copy + 1)
    # The genome's last bases, and a copy cut short by its end.
    r_src[0], r_copy[0], rlen[0] = GENOME - rlen[0], rlen[0], rlen[0]
    r_src[1] = GENOME - r_copy[1] // 2 - 1
    r_copy[1] = GENOME - r_src[1]
    r_src[2], q_src[2] = 0, 0
    rev = (rng.random(m) < rev_share).astype(np.uint8)
    return [a.astype(t) for a, t in (
        (q_row, np.int32), (q_src, np.int32), (q_copy, np.int32),
        (qlen, np.int32), (r_src, np.int64), (r_copy, np.int32),
        (rlen, np.int32), (rev, np.uint8))]


def gather_aligned_coords(qg, rg, lpad, genome, nrows):
    """Whole copies (the gather kernel's 16-byte path) from every source
    alignment 0-15 in the strand rows and in the genome, forward and
    reversed, with lengths that are not multiples of 16; then the clamps:
    sources running past the end of a row and of the genome, a negative
    row source and the last strand row past its end.  Low-end genome and
    row clamps (negative r_src, q_row) are in gather_clamp_coords."""
    rows = []
    for rev in (0, 1):
        for a in range(16):
            qlen = qg - (a % 5)
            rlen = rg - (a % 7)
            rows.append((a % nrows, a, qlen, qlen, 16 * (a + 3) + a, rlen,
                         rlen, rev))
            # Copies shorter than the problem, from an offset source.
            rows.append(((a + 5) % nrows, 16 - a, qlen // 2 + a, qlen,
                         genome // 2 + a, rlen // 3 + a, rlen, rev))
    for rev in (0, 1):
        rows.append((nrows - 1, lpad - 4, min(qg, 10), min(qg, 10),
                     genome - 3, min(rg, 20), min(rg, 20), rev))
        rows.append((1, -3, min(qg, 12), min(qg, 12), genome - rg // 2, rg,
                     rg, rev))
        rows.append((nrows, lpad - 17, qg, qg, 0, rg, rg, rev))
    return [np.array(c, np.int64) for c in zip(*rows)]


def gather_clamp_coords(qg, rg, genome, nrows):
    """Sources before the start of the genome and rows outside the strand
    rows at both ends, forward and reversed."""
    rows = []
    for rev in (0, 1):
        rows.append((-1, 0, qg, qg, -5, rg, rg, rev))
        rows.append((nrows + 3, -20, qg, qg, -rg // 2, rg // 2, rg, rev))
        rows.append((nrows - 1, 2, qg - 1, qg, genome - 1, rg, rg, rev))
    return [np.array(c, np.int64) for c in zip(*rows)]


def long_run_inputs(event, length=260, seed=300):
    """One gap fill (q, qlen, r, rlen, lbw, rbw) with a `length`-base
    deletion ("D") or insertion ("I") between 8 matching bases on each
    side; at max_gap = max_intron >= length it is one run."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 4, length + 16).astype(np.uint8)
    if event == "D":
        q = np.concatenate([r[:8], r[length + 8:]])
        lbw, rbw = 2, length + 2
    else:
        q = np.concatenate([r[:8], rng.integers(0, 4, length).astype(
            np.uint8), r[8:16]])
        r = r[:16]
        lbw, rbw = length + 2, 2
    return (q[None], np.array([len(q)]), r[None], np.array([len(r)]),
            np.array([lbw]), np.array([rbw]))


def gather_case(seed):
    """(genome codes, forward chunk rows, lengths) for the assembly tests."""
    rng = np.random.default_rng(seed)
    g = _genome(rng)
    fwd, lens = _chunk(rng)
    return g, fwd, lens


def read_rows(corpus, fwd, lens):
    """The chunk's strand rows through corpus.read_rows, the engine's row
    builder, from the reads' sequence characters back to back
    (codec.FOUR_BIT_CHARS of the forward codes)."""
    chars = np.asarray(codec.FOUR_BIT_CHARS, np.uint8)[fwd]
    seq = chars[np.arange(fwd.shape[1])[None, :] < lens[:, None]]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return corpus.read_rows(seq, starts, lens, fwd.shape[1])


# ---- the seed phase ----

def golden_index():
    """(word_len, max_hits, SO, ROA) of the golden L11 test index
    (tests/golden/testgen.X11_01_65525S.gz), the tables as uint32 arrays."""
    with gzip.open(os.path.join(TESTS, "golden",
                                "testgen.X11_01_65525S.gz")) as f:
        data = np.frombuffer(bytearray(f.read()), np.uint32)
    wl = int(data[1])
    ht = 1 << (2 * wl)
    return wl, int(data[2]), data[4:4 + ht + 1], data[4 + ht + 1:]


def _fasta_codes(path):
    """4-bit code arrays of the records of a FASTA file."""
    with open(path, "rb") as f:
        recs = f.read().split(b">")[1:]
    tab = np.asarray(codec.FOUR_BIT_CODES, np.uint8)
    return [tab[np.frombuffer(r.split(b"\n", 1)[1].replace(b"\n", b""),
                              np.uint8)] for r in recs]


def seed_rows(seed, n_sampled=24, n_wrapped=8, lpad=1024):
    """Code rows [b, lpad] u8 (code 4 past each length) and lengths [b]
    int32 for the seed phase at L11: the 1 kb reads of
    tests/data/readsC_1kb.fasta (some overflow 1,024 hits, one 8,192);
    reads sampled from tests/data/testgen.fasta with 5 % substitutions and
    a few N and X codes, three of them shorter than the word length; and
    reads that end in the genome's first 100 bases, whose windows there
    wrap (every hit has ro < qo)."""
    rng = np.random.default_rng(seed)
    chrom = _fasta_codes(os.path.join(TESTS, "data", "testgen.fasta"))[0]
    reads = _fasta_codes(os.path.join(TESTS, "data", "readsC_1kb.fasta"))
    for k in range(n_sampled):
        ln = int(rng.integers(1, 11)) if k < 3 else int(rng.integers(60,
                                                                     lpad))
        p = int(rng.integers(0, len(chrom) - ln))
        r = chrom[p:p + ln].copy()
        m = rng.random(ln) < 0.05
        r[m] = rng.integers(0, 4, int(m.sum()))
        r[rng.random(ln) < 0.005] = 4
        r[rng.random(ln) < 0.002] = 14
        reads.append(r)
    for k in range(n_wrapped):
        pre = rng.integers(0, 4, int(rng.integers(20, 300))).astype(np.uint8)
        reads.append(np.concatenate([pre, chrom[:100]]))
    codes = np.full((len(reads), lpad), 4, np.uint8)
    lens = np.array([min(len(r), lpad) for r in reads], np.int32)
    for k, r in enumerate(reads):
        codes[k, :lens[k]] = r[:lpad]
    return codes, lens


def wrapped_case():
    """The synthetic index and row of tests/test_seeds_jax.py:76-124 (word
    length 4): hash 5 holds a 40-hit run at 10,000 and up, hash 9 a 2-hit
    run [1, 2]; windows 0, 2 and 4 hit hash 5, window 6 hash 9, so window
    6's run (wrapped: ro < qo) fills the last slots of a row of 122 hits.
    Returns (hashes [1, 8] int32, clean [1, 8] bool, SO, ROA uint32)."""
    ht = 1 << 8
    counts = np.zeros(ht, np.uint32)
    counts[5], counts[9] = 40, 2
    so = np.zeros(ht + 1, np.uint32)
    so[1:] = np.cumsum(counts)
    roa = np.zeros(int(so[-1]), np.uint32)
    roa[so[5]:so[5] + 40] = 10_000 + np.arange(40)
    roa[so[9]:so[9] + 2] = [1, 2]
    hashes = np.zeros((1, 8), np.int32)
    clean = np.zeros((1, 8), bool)
    for w, h in ((0, 5), (2, 5), (4, 5), (6, 9)):
        hashes[0, w], clean[0, w] = h, True
    return hashes, clean, so, roa


def unsigned_case():
    """A synthetic index (word length 4, max_hits 5) and four rows of 40
    windows whose hits have ro < qo (diag >= 2^31), ro = qo - 1 (diag =
    0xFFFFFFFF, a valid hit just below the sentinel), ro = qo (diag 0) and
    ro far above qo; a hash with 6 hits (past max_hits, not kept), a
    wrapped window, and a row with no clean window.  Returns (hashes,
    clean, SO, ROA, max_hits)."""
    runs = {3: [0, 5, 20, 100], 7: [30, 31], 11: [1, 2],
            13: [0, 1, 2, 3, 4, 5], 2: [4_000_000_000, 7]}
    ht = 1 << 8
    counts = np.zeros(ht, np.uint32)
    for h, run in runs.items():
        counts[h] = len(run)
    so = np.zeros(ht + 1, np.uint32)
    so[1:] = np.cumsum(counts)
    roa = np.zeros(int(so[-1]) + 3, np.uint32)
    roa[-3:] = [3, 50, 9]      # entries past the last run
    for h, run in runs.items():
        roa[so[h]:so[h] + len(run)] = run
    hashes = np.zeros((4, 40), np.int32)
    clean = np.zeros((4, 40), bool)
    for r, wins in enumerate((((10, 3), (31, 7), (25, 3), (35, 11)),
                              ((8, 13), (31, 7), (32, 7), (0, 2), (39, 2)),
                              ((5, 11), (6, 11), (30, 3), (31, 3)),
                              ())):
        for w, h in wins:
            hashes[r, w], clean[r, w] = h, True
    return hashes, clean, so, roa, 5


def _runs_index(runs, wl, extra=3):
    """SO and ROA (uint32) of a synthetic index of word length wl whose
    hash h holds the ROA run runs[h] (the others none), with `extra`
    entries past the last run."""
    ht = 1 << (2 * wl)
    counts = np.zeros(ht, np.uint32)
    for h, run in runs.items():
        counts[h] = len(run)
    so = np.zeros(ht + 1, np.uint32)
    so[1:] = np.cumsum(counts)
    roa = np.zeros(int(so[-1]) + extra, np.uint32)
    for h, run in runs.items():
        roa[so[h]:so[h] + len(run)] = run
    return so, roa


def longrun_case(seed=11, n=2600):
    """Rows of n windows (more than one expansion batch of 1,024) on a
    synthetic index (word length 6, max_hits 650): hash 5 holds a run of
    650 hits (ro random, some below qo), hash 6 one of 650 hits all below
    qo past window 700, hash 7 one of 651 (past max_hits, not kept), and
    hashes 16 up single hits.  Row 0: the 650-hit run at window 10 beside
    single hits; row 1: 600 single hits, then the 650 run straddling slot
    1,024; row 2: the all-below run straddling 1,024 from window 900 (its
    window is wrapped); row 3: two 650 runs and hits in the third batch of
    windows (past 8,192 slots at no capacity; slots of every batch below
    8,192); row 4: a run that starts exactly at slot 1,024; row 5: twenty
    650-hit runs among single hits (13,000 hits and more: the register
    sorts of 32 and 64 keys a thread at C = 8,192 and 16,384).  Returns
    (hashes, clean, SO, ROA, max_hits)."""
    rng = np.random.default_rng(seed)
    wl = 6
    runs = {5: rng.integers(0, 3000, 650).astype(np.uint32),
            6: rng.integers(0, 600, 650).astype(np.uint32),
            7: rng.integers(0, 3000, 651).astype(np.uint32)}
    singles = list(range(16, 1 << (2 * wl)))
    for h in singles:
        runs[h] = rng.integers(0, 4000, 1).astype(np.uint32)
    so, roa = _runs_index(runs, wl)
    hashes = np.zeros((6, n), np.int32)
    clean = np.zeros((6, n), bool)

    def put(r, w, h):
        hashes[r, w], clean[r, w] = h, True

    def single(r, ws):
        for w in ws:
            put(r, w, singles[int(rng.integers(len(singles)))])

    single(0, range(0, 10))
    put(0, 10, 5)
    single(0, range(11, 300))
    put(0, 400, 7)
    single(1, range(0, 1200, 2))
    put(1, 1300, 5)
    single(1, range(1400, 1500))
    single(2, range(0, 500))
    put(2, 900, 6)
    single(2, range(1000, 1100))
    put(3, 5, 5)
    single(3, range(100, 2600, 3))
    put(3, 2100, 5)
    put(3, 2500, 6)
    single(4, range(0, 1024))
    put(4, 1030, 5)
    single(4, range(1100, 1110))
    single(5, range(1, n, 7))
    for w in range(0, n, 130):
        put(5, w, 5 if w % 260 else 6)
    return hashes, clean, so, roa, 650


# The row totals of sizes_case: around the warp sort (32) and the
# register sorts of 256 and 1,024 keys.
SIZE_TOTALS = (0, 1, 31, 32, 33, 255, 256, 257, 1023, 1024, 1025)


def sizes_case(seed=12, n=1100):
    """One row per total of SIZE_TOTALS, n windows a row (two expansion
    batches), on a synthetic index of word length 6 whose every hash holds
    1 to 3 hits of random ro (ties in diag occur); the windows that carry
    hits are random, the last one sized to the total.  Returns (hashes,
    clean, SO, ROA, max_hits)."""
    rng = np.random.default_rng(seed)
    wl = 6
    ht = 1 << (2 * wl)
    runs = {h: rng.integers(0, 1500, int(rng.integers(1, 4))).astype(
        np.uint32) for h in range(ht)}
    by_len = {c: [h for h, r in runs.items() if len(r) == c]
              for c in (1, 2, 3)}
    so, roa = _runs_index(runs, wl)
    hashes = np.zeros((len(SIZE_TOTALS), n), np.int32)
    clean = np.zeros((len(SIZE_TOTALS), n), bool)
    for r, want in enumerate(SIZE_TOTALS):
        ws = np.sort(rng.choice(n, n, replace=False))
        left, k = want, 0
        while left:
            c = min(left, int(rng.integers(1, 4)))
            h = by_len[c][int(rng.integers(len(by_len[c])))]
            hashes[r, ws[k]], clean[r, ws[k]] = h, True
            left -= c
            k += 1
    return hashes, clean, so, roa, 3


# Seed-phase cases: the golden index's seed rows at capacities 64 to 16,384
# (rows overflow 64 and 1,024), the wrapped run at a tier's last slots (128)
# and past them (64), the unsigned-order edges with and without room for
# sentinels, 650-hit runs beside single hits and across C in rows of three
# expansion batches (longrun), and row totals around the sort's sizes
# (sizes).
SEED_CASES = ["golden64", "golden1024", "golden8192", "wrapped64",
              "wrapped128", "unsigned8", "unsigned16", "longrun1024",
              "longrun8192", "longrun16384", "sizes1024"]


def seed_case(case):
    """(source, SO, ROA, max_hits, capacity) of a SEED_CASES id (or one
    with another capacity): source is ("rows", codes, lens, word_len), the
    golden index's seed rows, or ("hashes", hashes, clean) over a synthetic
    index."""
    cap = int(case.lstrip("abcdefghijklmnopqrstuvwxyz"))
    if case.startswith("golden"):
        wl, _, so, roa = golden_index()
        return ("rows",) + seed_rows(5) + (wl,), so, roa, 650, cap
    if case.startswith("wrapped"):
        hashes, clean, so, roa = wrapped_case()
        return ("hashes", hashes, clean), so, roa, 650, cap
    make = {"unsigned": unsigned_case, "longrun": longrun_case,
            "sizes": sizes_case}[case.rstrip("0123456789")]
    hashes, clean, so, roa, max_hits = make()
    return ("hashes", hashes, clean), so, roa, max_hits, cap


# Hash rows: (word length, row length); N = L - wl + 1 is not a multiple of
# 16 in any, so 16-window runs cross row ends, and 6 rows of 20 codes at
# word length 15 have fewer windows (6) than a run.
HASH_SHAPES = [(11, 1024), (15, 1024), (15, 20), (4, 37)]
HASH_SHAPE_IDS = ["wl11_L1024", "wl15_L1024", "wl15_L20", "wl4_L37"]


def hash_rows(seed, wl, l, b=45):
    """[b, l] u8 code rows (N and X codes inside the reads, code 4 past
    each length) and lengths whose count of windows takes every residue
    mod 16 (lengths 0, 1, wl - 1, wl and l among them); b * N is not a
    multiple of 16, so the last 16-window run is short."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (b, l)).astype(np.uint8)
    bad = rng.random((b, l)) < 0.02
    codes[bad] = rng.choice(np.array([4, 14], np.uint8), int(bad.sum()))
    n = l - wl + 1
    lens = np.minimum(wl - 1 + rng.integers(1, n + 1, b) // 16 * 16 +
                      np.arange(b) % 16, l)
    lens[:4] = [0, 1, wl - 1, wl]
    lens[-1] = l
    codes[np.arange(l)[None, :] >= lens[:, None]] = 4
    return codes, lens.astype(np.int32)


# ---- fragment-chain DP (ops/chain.py) ----

# The chain DP's parameters (tests/test_chain_jax.py _AA).
CHAIN_KW = dict(max_gap=50, max_desert=200, m_score=1, go_cost=5, ge_cost=2)


def _chain_problem(rng, n, qspan):
    """test_chain_jax._random_problem with the SQO span as a parameter:
    fragment-like nodes sorted ascending (SQO, diag), a fifth of the ranges
    wrapping uint32 (RO < QO)."""
    sqo = np.sort(rng.integers(0, qspan, n))
    length = rng.integers(10, 60, n)
    eqo = sqo + length - 1
    base = 2**32 - 20 if rng.random() < 0.2 else rng.integers(0, 5000)
    diag = (base + rng.integers(0, 3000, n)) % 2**32
    order = np.lexsort((diag, sqo))
    return sqo[order], eqo[order], diag[order].astype(np.int64), \
        length[order]


def chain_case(seed, b, n_max, qspan=900):
    """B ranges of 1..n_max nodes drawn as tests/test_chain_jax.py draws
    them (the same generator calls in the same order: seeds 0-2 at b 16,
    n_max 48 give its problems), padded to n_max.  Returns (sqo, eqo, diag
    re-based per range as test_chain_jax re-bases it, length, valid, diag
    as drawn, counts), int64 but valid.  The re-base is (diag - min) mod
    2^32: in a range that wraps uint32 it leaves diagonals past 2^31,
    which reach the DP as negative int32 values."""
    rng = np.random.default_rng(seed)
    sqo, eqo, diag, length, diag_orig = (np.zeros((b, n_max), np.int64)
                                         for _ in range(5))
    valid = np.zeros((b, n_max), bool)
    counts = rng.integers(1, n_max + 1, b)
    for k in range(b):
        c = counts[k]
        s, e, d, ln = _chain_problem(rng, c, qspan)
        sqo[k, :c], eqo[k, :c], length[k, :c] = s, e, ln
        diag_orig[k, :c] = d
        diag[k, :c] = (d - d.min()) % 2**32   # the caller's re-base
        valid[k, :c] = True
    return sqo, eqo, diag, length, valid, diag_orig, counts


def chain_tie_case(seed, b=64, n=24):
    """Ranges dense in equal scores: SQO in 0..39, lengths 4..6, diagonals
    0..5, so that with go_cost = ge_cost = 0 (CHAIN_TIE_KW) many
    candidates tie with the stored edge (all three levels of the cascade)
    and many nodes tie in the fold (full ties included); a random half of
    the nodes of each range are pads (valid False) between valid ones."""
    rng = np.random.default_rng(seed)
    sqo = np.sort(rng.integers(0, 40, (b, n)), axis=1)
    diag = rng.integers(0, 6, (b, n))
    order = np.lexsort((diag, sqo), axis=1)
    sqo = np.take_along_axis(sqo, order, 1)
    diag = np.take_along_axis(diag, order, 1)
    length = rng.integers(4, 7, (b, n))
    valid = rng.random((b, n)) < 0.5
    return sqo, sqo + length - 1, diag, length, valid


CHAIN_TIE_KW = dict(CHAIN_KW, go_cost=0, ge_cost=0)


def native_chain(sqo, eqo, diag, length, valid, kw, rows=None):
    """The port's native chain_dp (the per-read engine's yt_chain_dp) on
    each range's valid nodes, in the outputs of ops/chain.batched_chain_dp
    (pads never relax nor win, so dropping them changes nothing): best
    and best_score [B] (-1 and -0x7FFFFF00 for a range with no valid
    node), prev and path_sqo [B, N] (a pad keeps prev -1 and its own SQO),
    int32.  diag as the native engine keeps it (uint32, not re-based);
    `rows` limits the ranges."""
    from yaha_tpu_torch.native import host
    b = sqo.shape[0] if rows is None else rows
    out = {"best": np.full(b, -1, np.int32),
           "best_score": np.full(b, -0x7FFFFF00, np.int32),
           "prev": np.full((b, sqo.shape[1]), -1, np.int32),
           "path_sqo": np.array(sqo[:b], np.int32)}
    for k in range(b):
        idx = np.nonzero(valid[k])[0]
        nb, nsc, nprev, _, npsqo = host.chain_dp(
            sqo[k, idx], eqo[k, idx], diag[k, idx], length[k, idx], **kw)
        if nb >= 0:
            out["best"][k], out["best_score"][k] = idx[nb], nsc[nb]
        out["prev"][k, idx] = np.where(nprev >= 0,
                                       idx[np.maximum(nprev, 0)], -1)
        out["path_sqo"][k, idx] = npsqo
    return out


def chain_candidates(sqo, eqo, diag, length, valid, kw):
    """[N, N] bool of one range: whether node i can relax node j (j > i,
    both valid, SQO, diagonal gap, SRO, desert and new-bases tests in int32
    arithmetic, chain_jax's candidate test), numpy."""
    def w32(x):
        return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31
    s, e, d = w32(sqo), w32(eqo), w32(diag)
    lw = (np.asarray(length, np.int64) + 0x8000) % 0x10000 - 0x8000
    n = len(s)
    m = (np.asarray(valid, bool)[:, None] & np.asarray(valid, bool)[None, :]
         & np.triu(np.ones((n, n), bool), 1) & (s[None, :] > s[:, None]))
    m &= np.abs(w32(d[None, :] - d[:, None])) <= kw["max_gap"]
    sro, ero = w32(d + s), w32(d + e)
    m &= sro[None, :] > sro[:, None]
    q_gap = np.maximum(w32(s[None, :] - e[:, None] - 1), 0)
    r_gap = np.maximum(w32(sro[None, :] - ero[:, None] - 1), 0)
    m &= np.minimum(q_gap, r_gap) <= kw["max_desert"]
    q_ov = np.maximum(w32(e[:, None] - s[None, :] + 1), 0)
    r_ov = np.maximum(w32(ero[:, None] - sro[None, :] + 1), 0)
    return m & (lw[None, :] - np.maximum(q_ov, r_ov) >= 1)


def chain_unsorted_case(seed=3, b=8, n_max=48):
    """chain_case's ranges with their valid nodes in reverse order: SQO
    falls from one valid node to the next, so the kernel's pair tests may
    not stop at the SQO window and scan every pair."""
    sqo, eqo, diag, length, valid = chain_case(seed, b, n_max)[:5]
    out = [a.copy() for a in (sqo, eqo, diag, length)]
    for k in range(b):
        c = int(valid[k].sum())
        for a, src in zip(out, (sqo, eqo, diag, length)):
            a[k, :c] = src[k, :c][::-1]
    return (*out, valid)


def chain_path_case(n, b=2):
    """Ranges of n nodes whose candidate DAG is one path through all of
    them: node i starts at query offset 12 i, 20 bases long (it overlaps
    the next node by 8), on diagonal 30 i, so that only node i + 1 is
    within max_gap (50) of it: every step has work, and the DAG is n - 1
    edges deep."""
    sqo = np.tile(np.arange(n, dtype=np.int64) * 12, (b, 1))
    length = np.full((b, n), 20, np.int64)
    diag = np.tile(np.arange(n, dtype=np.int64) * 30, (b, 1))
    return sqo, sqo + length - 1, diag, length, np.ones((b, n), bool)


def chain_edge_case():
    """(name, (sqo, eqo, diag, length, valid)) of edge ranges, each [b, n]
    int64 / bool: one node per range; a range with no valid node beside
    a full one; lengths whose length (and length * m_score) passes 32,767
    (the int16 wraps of the SINT stores); diagonal and query gaps at the
    pair tests' limits (CHAIN_KW's max_gap and max_desert) and one past
    them."""
    out = []
    out.append(("n1", (np.array([[3], [0], [7]]), np.array([[12], [9], [7]]),
                       np.array([[0], [0], [0]]), np.array([[10], [10], [1]]),
                       np.array([[True], [False], [True]]))))
    sqo = np.array([[0, 5, 9, 30], [0, 5, 9, 30]])
    eqo = sqo + 20
    diag = np.array([[0, 3, 1, 2], [0, 3, 1, 2]])
    length = np.full((2, 4), 21)
    out.append(("invalid_row", (sqo, eqo, diag, length,
                                np.array([[False] * 4, [True] * 4]))))
    # Long fragments: lengths 20,000-40,000 wrap to negative int16 scores
    # (and length * m_score at m_score 2 wraps too).
    rng = np.random.default_rng(5)
    sqo = np.sort(rng.integers(0, 60000, (8, 12)), axis=1)
    length = rng.integers(20000, 40000, (8, 12))
    diag = np.sort(rng.integers(0, 40, (8, 12)), axis=1)
    out.append(("int16_wrap", (sqo, sqo + length - 1, diag, length,
                               np.ones((8, 12), bool))))
    # The pair tests' edges: diagonal gaps of exactly max_gap (50, a
    # candidate) and max_gap + 1 (not), query gaps of exactly max_desert
    # (200) and max_desert + 1, and a candidate whose query gap is exactly
    # max_desert + max_gap (its reference gap max_desert), the last node
    # of the SQO window the kernel's pair tests scan, long enough that
    # its edge wins (and the next node one base past the window).
    sqo = np.array([[0, 10, 20, 30, 40, 50], [0, 210, 421, 632, 842, 1053],
                    [0, 310, 621, 0, 0, 0]])
    length = np.array([[12] * 6, [10] * 6, [60] * 6])
    diag = np.array([[0, 50, 101, 151, 202, 252], [0] * 6,
                     [50, 0, -50, 0, 0, 0]])
    valid = np.ones((3, 6), bool)
    valid[2, 3:] = False
    out.append(("gap_edges", (sqo, sqo + length - 1, diag, length, valid)))
    return out


# The index builders' genomes: (word_len, skip_dist, max_hits) with a
# max_hits low enough that the repeats' k-mers are down-sampled.
INDEX_CASES = [(8, 1, 6), (9, 2, 4), (10, 3, 3), (11, 1, 2), (11, 3, 65525)]
INDEX_CASE_IDS = ["L8S1H6", "L9S2H4", "L10S3H3", "L11S1H2", "L11S3"]


def index_genome(seed, n_seqs=4):
    """A yaha_tpu_torch.io.genome.Genome laid out as io/nib2.load lays one
    out: sequences of 2 to 9 kb, each padded with X (14) to a multiple of 8
    bases, and the 8,192 zero codes past the end.  Each holds runs of N (4) of 1-40
    bases, single IUPAC codes, a run of 2-5 bad codes at its start or end,
    and copies of a 40-base repeat, so that k-mers pass a small max_hits
    on every sequence."""
    from yaha_tpu_torch.io.genome import Genome
    rng = np.random.default_rng(seed)
    rep = rng.integers(0, 4, 40).astype(np.uint8)
    seqs = []
    for k in range(n_seqs):
        s = rng.integers(0, 4, int(rng.integers(2000, 9000))).astype(
            np.uint8)
        for _ in range(int(rng.integers(2, 7))):
            p = int(rng.integers(0, len(s) - 40))
            s[p:p + 40] = rep
        for _ in range(int(rng.integers(1, 5))):
            p = int(rng.integers(0, len(s) - 40))
            s[p:p + int(rng.integers(1, 41))] = 4
        bad = rng.random(len(s)) < 0.003
        s[bad] = rng.integers(5, 16, int(bad.sum()))
        end = int(rng.integers(2, 6))
        if k % 2:
            s[:end] = 4
        else:
            s[-end:] = 4
        seqs.append(s)
    starts, lens, parts, off = [], [], [], 0
    for s in seqs:
        starts.append(off)
        lens.append(len(s))
        pad = -len(s) % 8
        parts += [s, np.full(pad, 14, np.uint8)]
        off += len(s) + pad
    parts.append(np.zeros(8192, np.uint8))
    return Genome(names=["c%d" % k for k in range(n_seqs)],
                  starting_offsets=np.array(starts, np.int64),
                  lengths=np.array(lens, np.int64),
                  codes=np.concatenate(parts))


# tests/test_sam_parity.py's 21 golden runs (output, reads, index, flags),
# copied so that chip_smoke.py runs them where jax (which that module's
# conftest imports) is not installed; tests/test_torch_oracle.py holds the
# copy to the original.
GOLDEN_CASES = [
    ("A_default.sam", "readsA_100bp.fasta", "testgen.X11_01_65525S", ["-osh"]),
    ("A_soft.sam", "readsA_100bp.fasta", "testgen.X11_01_65525S", ["-oss"]),
    ("A_fbs.sam", "readsA_100bp.fasta", "testgen.X11_01_65525S",
     ["-FBS", "Y", "-osh"]),
    ("A_all.sam", "readsA_100bp.fasta", "testgen.X11_01_65525S",
     ["-OQC", "N", "-osh"]),
    ("A_edit.sam", "readsA_100bp.fasta", "testgen.X11_01_65525S",
     ["-AGS", "N", "-osh"]),
    ("A_blast8.out", "readsA_100bp.fasta", "testgen.X11_01_65525S", ["-o8"]),
    ("A_h20.sam", "readsA_100bp.fasta", "testgen.X11_01_00020S",
     ["-H", "20", "-osh"]),
    ("B_default.sam", "readsB_500bp.fasta", "testgen.X11_01_65525S", ["-osh"]),
    ("B_fbs.sam", "readsB_500bp.fasta", "testgen.X11_01_65525S",
     ["-FBS", "Y", "-osh"]),
    ("C_default.sam", "readsC_1kb.fasta", "testgen.X11_01_65525S", ["-osh"]),
    ("C_params.sam", "readsC_1kb.fasta", "testgen.X11_01_65525S",
     ["-BW", "3", "-G", "20", "-M", "15", "-X", "15", "-osh"]),
    ("D_default.sam", "readsD_sv.fasta", "testgen.X11_01_65525S", ["-osh"]),
    ("D_fbs.sam", "readsD_sv.fasta", "testgen.X11_01_65525S",
     ["-FBS", "Y", "-osh"]),
    ("D_all.sam", "readsD_sv.fasta", "testgen.X11_01_65525S",
     ["-OQC", "N", "-osh"]),
    ("E_fastq.sam", "readsE_150bp.fastq", "testgen.X11_01_65525S", ["-osh"]),
    ("F_edge.sam", "readsF_edge.fasta", "testgen.X11_01_65525S", ["-osh"]),
    ("B_scoring.sam", "readsB_500bp.fasta", "testgen.X11_01_65525S",
     ["-GOC", "6", "-GEC", "1", "-RC", "4", "-MS", "2", "-osh"]),
    ("D_bp.sam", "readsD_sv.fasta", "testgen.X11_01_65525S",
     ["-BP", "10", "-MGDP", "9", "-MNO", "10", "-osh"]),
    ("D_strict.sam", "readsD_sv.fasta", "testgen.X11_01_65525S",
     ["-P", "0.95", "-M", "40", "-osh"]),
    ("C_blast8.out", "readsC_1kb.fasta", "testgen.X11_01_65525S", ["-o8"]),
    ("D_fbs_loose.sam", "readsD_sv.fasta", "testgen.X11_01_65525S",
     ["-FBS", "Y", "-PRL", "0.5", "-PSS", "0.5", "-osh"]),
]


# ---- fragments-to-clumps on hit rows (csrc/clump_kernels.cu) ----

# Fragment-stage parameters (the AlignmentArgs fields the clump stage
# reads): the query defaults, readsC's -BW 3 -G 20 -M 15, and settings
# dense in equal scores (no gap costs) and in chops (short min_match and
# min_non_overlap), one with the --max-region-frags valve.
CLUMP_PARAMS = {
    "default": {},
    "params1kb": dict(band_width=3, max_gap=20, min_match=15),
    "ties": dict(go_cost=0, ge_cost=0, min_match=15, max_desert=200),
    "chops": dict(min_match=8, band_width=1, max_gap=8),
    "valve": dict(max_region_frags=4),
}


def parse_clump_record(rec):
    """A clump record (ops/clumps.py: int32 array) -> (skipped,
    [(matched, [(sqo, eqo, sro)])]) with sro as an unsigned value."""
    nc, _, skipped = (int(x) for x in rec[:3])
    pos, out = 3, []
    for _ in range(nc):
        n, matched = int(rec[pos]), int(rec[pos + 1])
        f = np.asarray(rec[pos + 2:pos + 2 + 3 * n]).reshape(n, 3).astype(
            np.int64)
        f[:, 2] &= 0xFFFFFFFF
        out.append((matched, [tuple(int(v) for v in x) for x in f]))
        pos += 2 + 3 * n
    return skipped, out


def _hit_rows(rows, cap=None):
    """Sorted (diag, qo) rows -> diag uint32 [B, C], qo int32 [B, C] with
    the seeder's sentinels past each row, and the counts."""
    n = np.array([len(r[0]) for r in rows], np.int32)
    c = max(int(n.max(initial=1)), 1) if cap is None else cap
    diag = np.full((len(rows), c), 0xFFFFFFFF, np.uint32)
    qo = np.full((len(rows), c), 0x7FFFFFFF, np.int32)
    for k, (d, q) in enumerate(rows):
        order = np.lexsort((q, d))
        diag[k, :len(d)] = np.asarray(d, np.uint32)[order]
        qo[k, :len(d)] = np.asarray(q, np.int32)[order]
    return diag, qo, n


def _kmer_hashes(codes, wl):
    n = len(codes) - wl + 1
    h = np.zeros(max(n, 0), np.int64)
    for t in range(wl):
        h = (h << 2) | codes[t:t + n].astype(np.int64)
    return h


def _read_hits(ref, ref_off, read, wl, rng, spurious):
    """Every (diag, qo) of an exact wl-mer match of `read` in `ref` (at
    genome offset ref_off), plus `spurious` random hits."""
    hr, hq = _kmer_hashes(ref, wl), _kmer_hashes(read, wl)
    order = np.argsort(hr, kind="stable")
    hs = hr[order]
    lo = np.searchsorted(hs, hq, "left")
    hi = np.searchsorted(hs, hq, "right")
    qo = np.repeat(np.arange(len(hq), dtype=np.int64), hi - lo)
    ro = order[np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)] +
                              [np.zeros(0, np.int64)])].astype(np.int64)
    ro = ro + ref_off
    sq = rng.integers(0, max(len(hq), 1), spurious)
    sr = rng.integers(0, 1 << 32, spurious)
    d = np.concatenate([(ro - qo) & 0xFFFFFFFF, (sr - sq) & 0xFFFFFFFF])
    q = np.concatenate([qo, sq])
    keep = np.unique(d * (1 << 32) + q, return_index=True)[1]
    return d[keep], q[keep]


def _mutate(rng, seq, sub, indel):
    out = []
    for b in seq:
        r = rng.random()
        if r < indel / 2:
            continue                        # deletion
        if r < indel:
            out.append(rng.integers(0, 4))  # insertion
        out.append(rng.integers(0, 4) if rng.random() < sub else b)
    return np.asarray(out, np.uint8)


def clump_read_rows(seed, wl=15, n=48, length=1000):
    """Hit rows of 1 kb reads against a random 64 kb reference (at a genome
    offset near 2^32, so diagonals wrap): substitution reads (5 %), indel
    reads (5 % and 0.75 % indel events a base), split reads (two pieces
    1-20 kb apart, either order), reads across copies of a 300-base repeat
    unit (many regions), each with random spurious hits; and reads whose
    true diagonal region holds more fragments than the kernel's rounds
    take (0.5 kb of 2-base repeats).  Returns (diag, qo, n_hits, q_len)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 64000).astype(np.uint8)
    unit = rng.integers(0, 4, 300).astype(np.uint8)
    for at in (5000, 21000, 40000, 52000):
        ref[at:at + 300] = unit
    ref[60000:60500] = np.tile(np.array([0, 1], np.uint8), 250)
    off = int(rng.integers((1 << 32) - 200000, (1 << 32) - 64000))
    rows, qlens = [], []
    for k in range(n):
        kind = k % 6
        p = int(rng.integers(0, 64000 - 2 * length))
        if kind == 0:
            read = _mutate(rng, ref[p:p + length], 0.05, 0.0)
        elif kind in (1, 2):
            read = _mutate(rng, ref[p:p + length], 0.05, 0.0075)[:length]
        elif kind == 3:
            a = int(rng.integers(200, length - 200))
            p2 = min(p + a + int(rng.integers(1000, 20000)),
                     64000 - length)
            parts = [ref[p:p + a], ref[p2:p2 + length - a]]
            read = _mutate(rng, np.concatenate(parts[::int(rng.choice(
                [-1, 1]))]), 0.02, 0.0)
        elif kind == 4:
            at = int(rng.choice([5000, 21000, 40000, 52000]))
            s = at - int(rng.integers(0, 700))
            read = _mutate(rng, ref[s:s + length], 0.01, 0.0)
        else:
            s = 60500 - int(rng.integers(300, 500)) if k % 12 == 5 else p
            read = _mutate(rng, ref[s:s + length], 0.03, 0.0)
        rows.append(_read_hits(ref, off, read, wl, rng,
                               int(rng.integers(0, 300))))
        qlens.append(len(read))
    diag, qo, nh = _hit_rows(rows)
    return diag, qo, nh, np.asarray(qlens, np.int32)


def clump_dense_rows(seed, n=64, q_len=400, regions=3):
    """Rows of a few dense regions each: random hits on diagonals a few
    apart, so regions hold tens of short overlapping fragments (equal
    scores, chops that persist into later rounds, clean-up erasures);
    region count and spacing vary, some regions 45-55 diagonals apart."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        d_all, q_all = [], []
        base = int(rng.integers(0, 1 << 32))
        for r in range(int(rng.integers(1, regions + 1))):
            width = int(rng.integers(2, 30))
            m = int(rng.integers(5, 120))
            d = base + rng.integers(0, width, m)
            q = rng.integers(0, q_len - 10, m)
            # runs of consecutive qo on a diagonal: fragments longer
            # than one word
            run = rng.integers(1, 12, m)
            d = np.repeat(d, run)
            q = np.repeat(q, run) + np.concatenate([np.arange(x)
                                                    for x in run])
            d_all.append(d)
            q_all.append(np.minimum(q, q_len - 15))   # windows inside
            base += width + int(rng.choice([45, 50, 51, 55, 3000]))
        d = np.concatenate(d_all) & 0xFFFFFFFF
        q = np.concatenate(q_all)
        keep = np.unique(d * (1 << 32) + q, return_index=True)[1]
        rows.append((d[keep], q[keep]))
    diag, qo, nh = _hit_rows(rows)
    return diag, qo, nh, np.full(n, q_len, np.int32)


def clump_edge_rows(max_gap=50, wl=15):
    """Rows at the stage's edges: no hits, one hit, one fragment of
    min_match - 1 and of min_match bases (the defaults' 25), two
    fragments max_gap and max_gap + 1 diagonals apart (one region or
    two), a qo step of exactly word_len and word_len + 1 on a diagonal
    (one fragment or two), hits at diagonal 0xFFFFFFFF, and a row served
    with fewer hits than it holds (n_hits 5 of 9).  q_len 200."""
    def frag(d, q0, length):
        return [d] * (length - wl + 1), list(range(q0, q0 + length - wl + 1))
    rows = [([], [])]
    rows.append(([1000], [7]))
    for length in (24, 25):
        rows.append(frag(5000, 10, length))
    for gap in (max_gap, max_gap + 1):
        d1, q1 = frag(9000, 10, 40)
        d2, q2 = frag(9000 + gap, 80, 40)
        rows.append((d1 + d2, q1 + q2))
    for step in (wl, wl + 1):
        rows.append(([7000] * 4, [10, 11, 11 + step, 12 + step]))
    d1, q1 = frag(0xFFFFFFFF, 3, 60)
    rows.append((d1, q1))
    d1, q1 = frag(300, 0, 23)
    rows.append((d1, q1))
    diag, qo, nh = _hit_rows(rows)
    nh[-1] = 5
    return diag, qo, nh, np.full(len(rows), 200, np.int32)


def clump_wrap_rows(seed=7, q_len=40000, n=4):
    """Reads of 40 kb (past 32,767: the stored scores wrap to int16 unless
    max_query_length > 32000) with long fragments on a few diagonals in
    one region."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        d, q = [], []
        pos, diag = 0, 100000 + int(rng.integers(0, 1000))
        while pos < q_len - 2000:
            length = int(rng.integers(500, 9000))
            stop = min(pos + length, q_len - 15)
            q += list(range(pos, stop))
            d += [diag] * (stop - pos)
            pos = stop + int(rng.integers(16, 40))
            diag += int(rng.integers(-3, 4))
        rows.append((np.asarray(d), np.asarray(q)))
    diag, qo, nh = _hit_rows(rows)
    return diag, qo, nh, np.full(n, q_len, np.int32)


def devidx_batch(device, seed=3000000017, n_reads=16384):
    """One batch of the devidx.1kb_mixed cell (yaha_bench): its genome and
    read pool from `seed`, the first n_reads reads as ParsedReads, the
    cell's L15 index built on `device` (index/build.py) as a NativeIndex,
    the genome as a NativeGenome and the cell's AlignmentArgs (query
    defaults, --seed device).  Returns (aa, pr, index, genome)."""
    from yaha_bench import harness
    from yaha_bench.traffic.generator import fasta, make_pool
    from yaha_bench.traffic.genome import make_genome
    from yaha_tpu_torch import cli, host
    from yaha_tpu_torch.index import build as ibuild
    from yaha_tpu_torch.io.genome import Genome
    cell = harness.load_cell("devidx.1kb_mixed")
    config, traffic = cell["config"], cell["traffic"]
    g = make_genome(dict(config["genome"], bases=config["genome_bases"]),
                    seed, device)
    pool = make_pool(traffic, g, seed)
    ix = config["index"]
    so, roa, total = ibuild.build_index(
        Genome(names=g.names, starting_offsets=g.starts, lengths=g.lengths,
               codes=np.ascontiguousarray(g.codes)),
        ix["word_len"], ix["skip_dist"], ix["max_hits"], device=device)
    index = harness.native_index(ix["word_len"], ix["max_hits"], so, roa,
                                 total)
    aa, _, _ = cli.parse_args(["-x", "genome.X15_01_65525S", "-q",
                               "pool.fasta", "--seed", "device", "-osh",
                               "out.sam"] + list(config["query_flags"]))
    cli._take_index_params(aa, index)
    pr = host.parse_queries_native(fasta(pool[:n_reads]), False,
                                   aa.max_query_length, aa.word_len)
    codes = np.ascontiguousarray(g.codes)
    return aa, pr, index, harness.native_genome(g, codes)
