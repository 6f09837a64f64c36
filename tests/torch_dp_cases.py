"""Numpy-seeded inputs shared by the port's tests.

tests/test_torch_sw.py holds the plain PyTorch versions to the JAX package
on these DP problems, and tests/test_torch_staged.py the engine to the
native one on these reads; tests/test_torch_cuda.py holds the CUDA
kernels and the engine to the same references on the card.  This module
imports neither jax nor torch, so the card tests run where jax is not
installed.
"""
import numpy as np

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
