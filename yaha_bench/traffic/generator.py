"""The one generator of read pools: a traffic mix's parameters in, reads out.

A mix (traffic/<name>.json) gives the pool's size, the batch the CLI
takes, the reads that the correctness check samples, and its parts, each a
share of the pool drawn by one of these kinds:

  "sampled"  reads of `length` bases from a uniform place on either strand,
             with `substitution` errors a base and, where `indel_events`
             is above 0, that many short insertion or deletion events a
             base at uniform places, of geometric length
             (`indel_geometric_p`), cut back to `length`; chip_smoke.py's
             sample_reads model (wgsim's), drawn for all reads at once on
             the genome's device;
  "sv_events" reads of `length` bases at `coverage` over contigs of
             DEL / DUP / INV / distal-INS events (`flank` bases each side,
             event sizes uniform in [event_min, event_max)), with
             `error` substitutions a base, on either strand; the event
             model of tools/make_sv_testdata.py (RandomSV_Events), each
             contig's reads drawn at once.

Every count is fixed by the mix, so every seed makes the same number of
reads of each part and length model, in another order and from other
places of the genome.  Reads are 4-bit codes; `fasta` renders them.
"""
from __future__ import annotations

import numpy as np

from .genome import CODE_CHARS, COMP_CODES, SynthGenome


def part_counts(mix: dict) -> list:
    """Reads of each part: the shares of `pool_reads`, rounded down, the
    last part taking the rest."""
    n = int(mix["pool_reads"])
    counts = [int(n * float(p["share"])) for p in mix["parts"][:-1]]
    return counts + [n - sum(counts)]


def _revcomp(r: np.ndarray) -> np.ndarray:
    return COMP_CODES[r][::-1]


def _strand(reads: np.ndarray, rng) -> list:
    """Each row as read, or reverse-complemented with probability 1/2."""
    flip = rng.random(len(reads)) < 0.5
    out = list(reads)
    for k in np.flatnonzero(flip):
        out[k] = _revcomp(reads[k])
    return out


def sampled(genome: SynthGenome, n: int, p: dict, g) -> list:
    """Drawn on the genome's device with the torch.Generator `g`."""
    import torch
    length = int(p["length"])
    sub = float(p["substitution"])
    ev_rate = float(p.get("indel_events", 0.0))
    geo = float(p.get("indel_geometric_p", 0.7))
    codes = genome.device_codes
    dev = codes.device

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def bases(*shape):
        return torch.randint(0, 4, shape, generator=g, device=dev,
                             dtype=torch.uint8)
    starts = torch.from_numpy(genome.starts).to(dev)
    room = torch.from_numpy(genome.lengths - length).to(dev)
    c = torch.randint(0, len(genome.names), (n,), generator=g, device=dev)
    pos = (rand(n).double() * room[c]).long()
    mat = codes[(starts[c] + pos)[:, None] +
                torch.arange(length, device=dev)[None, :]]
    mat = torch.where(rand(n, length) < sub, bases(n, length), mat)
    k = int(length * ev_rate)
    flip = (rand(n) < 0.5).cpu().numpy()
    if k == 0:
        return [(_revcomp(r) if f else r)
                for r, f in zip(mat.cpu().numpy(), flip)]
    # k events a read at uniform places; each an insertion of d random
    # bases before its place or a deletion of d bases from it (d
    # geometric); the read is cut back to `length`.
    e = torch.randint(0, length, (n * k,), generator=g, device=dev)
    d = torch.empty(n * k, device=dev).geometric_(geo, generator=g).long()
    ins = rand(n * k) < 0.5
    rows = torch.arange(n, device=dev).repeat_interleave(k)
    ins_len = torch.zeros((n, length), dtype=torch.int64, device=dev)
    ins_len.index_put_((rows[ins], e[ins]), d[ins], accumulate=True)
    keep = torch.ones((n, length), dtype=torch.bool, device=dev)
    for t in range(int(d.max())):
        sel = ~ins & (t < d) & (e + t < length)
        keep[rows[sel], e[sel] + t] = False
    counts = (ins_len + keep).flatten()
    ends = torch.cumsum(counts, 0)
    out = bases(int(ends[-1]))
    kf = keep.flatten()
    out[(ends - 1)[kf]] = mat.flatten()[kf]
    bounds = np.concatenate([[0], ends.view(n, length)[:, -1].cpu().numpy()])
    out = out.cpu().numpy()
    reads = [out[bounds[r]:min(bounds[r + 1], bounds[r] + length)]
             for r in range(n)]
    return [(_revcomp(r) if f else r) for r, f in zip(reads, flip)]


def _pick_locus(genome, rng, span, flank):
    while True:
        c = int(rng.integers(0, len(genome.names)))
        cl = int(genome.lengths[c])
        if cl < span + 2 * flank + 10:
            continue
        return genome.chrom(c), int(rng.integers(flank, cl - span - flank))


def _event_contig(genome, rng, kind, size, fl):
    if kind == "DEL":
        s, p = _pick_locus(genome, rng, size, fl)
        return np.concatenate([s[p - fl:p], s[p + size:p + size + fl]])
    if kind == "DUP":
        s, p = _pick_locus(genome, rng, size, fl)
        return np.concatenate([s[p - fl:p + size], s[p:p + size + fl]])
    if kind == "INV":
        s, p = _pick_locus(genome, rng, size, fl)
        return np.concatenate([s[p - fl:p], _revcomp(s[p:p + size]),
                               s[p + size:p + size + fl]])
    s, p = _pick_locus(genome, rng, 10, fl)          # distal insertion
    s2, p2 = _pick_locus(genome, rng, size, fl)
    return np.concatenate([s[p - fl:p], s2[p2:p2 + size], s[p:p + fl]])


def sv_events(genome: SynthGenome, n: int, p: dict, rng) -> list:
    length = int(p["length"])
    cov = int(p["coverage"])
    err = float(p["error"])
    fl = int(p["flank"])
    lo, hi = int(p["event_min"]), int(p["event_max"])
    kinds = ("DEL", "DUP", "INV", "INS")
    out = []
    i = 0
    while len(out) < n:
        contig = _event_contig(genome, rng, kinds[i % 4],
                               int(rng.integers(lo, hi)), fl)
        i += 1
        span = len(contig) - length
        if span <= 0:
            continue
        nr = max(1, len(contig) * cov // length)
        q = rng.integers(0, span + 1, nr)
        mat = contig[q[:, None] + np.arange(length)[None, :]]
        m = rng.random(mat.shape) < err
        mat[m] = rng.integers(0, 4, int(m.sum())).astype(np.uint8)
        out += _strand(mat, rng)
    return out[:n]


KINDS = {"sampled": sampled, "sv_events": sv_events}


def make_pool(mix: dict, genome: SynthGenome, seed: int) -> list:
    """The mix's pool from `seed`: a list of (name, codes), the parts
    shuffled together so that every batch holds them in their shares.
    "sampled" parts draw on the genome's device, the others on the host."""
    from .genome import generator
    rng = np.random.default_rng([int(seed), 1])
    reads = []
    for k, (p, n) in enumerate(zip(mix["parts"], part_counts(mix))):
        src = (generator(seed, genome.device_codes.device, 10 + k)
               if p["kind"] == "sampled" else rng)
        reads += [(p["prefix"], r) for r in KINDS[p["kind"]](genome, n, p,
                                                            src)]
    order = rng.permutation(len(reads))
    return [("%s%d" % (reads[k][0], i), reads[k][1])
            for i, k in enumerate(order)]


def fasta(pool) -> bytes:
    """The pool as FASTA, a line a sequence."""
    return b"".join(b">%s\n%s\n" % (name.encode(), CODE_CHARS[r].tobytes())
                    for name, r in pool)
