"""The benchmark's generators: the same seed gives the same bytes, the
mixes hold their shares, and the genome is laid out as nib2 lays it out.

    python -m pytest -q yaha_bench/test_bench_traffic.py
"""
import json
import os

import numpy as np
import pytest

from yaha_bench.traffic import generator, genome

HERE = os.path.dirname(os.path.abspath(__file__))
SPEC = {"bases": 400_000, "chromosomes": 3,
        "repeat_unit_lengths": [150, 320, 500], "repeat_every": 20_000,
        "n_runs_per_chromosome": 1, "n_run_length": [10, 1000]}
SEED = 2**31 + 977          # past 32 signed bits, as the driver's seeds go


def mix(name):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def small(name, pool=96):
    return dict(mix(name), pool_reads=pool)


@pytest.fixture(scope="module")
def gen():
    return genome.make_genome(SPEC, SEED, "cpu")


def test_genome_same_seed_same_bytes(gen):
    again = genome.make_genome(SPEC, SEED, "cpu")
    other = genome.make_genome(SPEC, SEED + 1, "cpu")
    assert np.array_equal(gen.codes, again.codes)
    assert not np.array_equal(gen.codes, other.codes)


def test_genome_layout(gen):
    per = SPEC["bases"] // SPEC["chromosomes"]
    assert list(gen.lengths) == [per] * SPEC["chromosomes"]
    assert all(s % 8 == 0 for s in gen.starts)
    for s in gen.starts:
        body = gen.codes[s:s + per]
        assert body.max() <= 4
        pad = gen.codes[s + per:s + (per + 7) // 8 * 8]
        assert (pad == genome.PAD_CODE).all()
    end = gen.starts[-1] + (per + 7) // 8 * 8
    assert len(gen.codes) == end + genome.TAIL_CODES
    assert (gen.codes[end:] == 0).all()
    n_codes = np.count_nonzero(gen.codes[:end] == 4)
    assert 10 * SPEC["chromosomes"] <= n_codes <= 1000 * SPEC["chromosomes"]


def test_genome_has_its_repeats(gen):
    """Some 40-mers recur, which random bases alone all but never do: the
    repeat units are placed."""
    flat = genome.CODE_CHARS[gen.codes].tobytes()
    per = SPEC["bases"] // SPEC["chromosomes"]
    n_rep = SPEC["chromosomes"] * (per // SPEC["repeat_every"])
    found = 0
    for k in range(0, len(flat) - 40, 997):
        probe = flat[k:k + 40]
        if b"N" not in probe and flat.count(probe) > 1:
            found += 1
    assert found > 0 and n_rep > 0


@pytest.mark.parametrize("name,pool", [("1kb_mixed", 48), ("10kb_long", 8)])
def test_pool_same_seed_same_bytes(gen, name, pool):
    m = small(name, pool)
    a = generator.fasta(generator.make_pool(m, gen, SEED))
    b = generator.fasta(generator.make_pool(m, gen, SEED))
    c = generator.fasta(generator.make_pool(m, gen, SEED + 1))
    assert a == b and a != c


@pytest.mark.parametrize("name,size", [("1kb_mixed", 160), ("10kb_long", 16)])
def test_pool_shares(gen, name, size):
    m = small(name, size)
    pool = generator.make_pool(m, gen, SEED)
    counts = generator.part_counts(m)
    assert sum(counts) == len(pool) == size
    for part, n in zip(m["parts"], counts):
        assert n == int(size * part["share"]) or part is m["parts"][-1]
        got = [r for name_, r in pool if name_.startswith(part["prefix"])]
        assert len(got) == n
        lens = [len(r) for r in got]
        assert max(lens) <= part["length"]
        if part["kind"] == "sampled" and not part.get("indel_events"):
            assert set(lens) == {part["length"]}
    assert len({n for n, _ in pool}) == len(pool)


def test_seed_draws_letters_not_layout(gen):
    """Another seed lays the repeats and N runs in the same places and
    makes reads of the same lengths in each part, of other letters and in
    another order: the work does not change with the seed."""
    other = genome.make_genome(SPEC, SEED + 1, "cpu")
    assert np.array_equal(gen.codes == 4, other.codes == 4)
    assert not np.array_equal(gen.codes, other.codes)
    for name, pool in (("1kb_mixed", 160), ("10kb_long", 16)):
        m = small(name, pool)
        a = generator.make_pool(m, gen, SEED)
        b = generator.make_pool(m, other, SEED + 1)
        for part in m["parts"]:
            la = sorted(len(r) for n, r in a if n.startswith(part["prefix"]))
            lb = sorted(len(r) for n, r in b if n.startswith(part["prefix"]))
            assert la == lb
        assert [n[0] for n, _ in a] != [n[0] for n, _ in b]
        assert generator.fasta(a) != generator.fasta(b)


def test_long_reads_are_10kb(gen):
    """The 10 kb mix's reads with substitutions alone are exactly 10,000
    bases; those with indel events are cut back to 10,000 and fall short
    of it by their deletions less their insertions, a few tens of bases."""
    m = small("10kb_long", 32)
    assert [p["length"] for p in m["parts"]] == [10_000, 10_000]
    lens = {"s": set(), "i": set()}
    for name, r in generator.make_pool(m, gen, SEED):
        lens[name[0]].add(len(r))
    assert lens["s"] == {10_000}
    assert 9_800 <= min(lens["i"]) and max(lens["i"]) == 10_000


def test_mixed_pool_proportions(gen):
    counts = generator.part_counts(mix("1kb_mixed"))
    assert counts == [28672, 28672, 8192]          # 7/16, 7/16, 1/8


def test_substitution_rate(gen):
    p = {"kind": "sampled", "share": 1.0, "prefix": "s", "length": 1000,
         "substitution": 0.05}
    reads = generator.sampled(gen, 200, p, genome.generator(3, "cpu", 10))
    # Each read lies on one strand of the genome; count its mismatches at
    # the best of the two orientations by an exact search of its middle.
    flat = genome.CODE_CHARS[gen.codes].tobytes()
    rates = []
    for r in reads[:40]:
        for s in (r, genome.COMP_CODES[r][::-1]):
            txt = genome.CODE_CHARS[s].tobytes()
            for k in range(0, 900, 50):
                at = flat.find(txt[k:k + 16])
                if at >= k and flat.count(txt[k:k + 16]) == 1:
                    ref = flat[at - k:at - k + 1000]
                    rates.append(np.mean(np.frombuffer(ref, np.uint8) !=
                                         np.frombuffer(txt, np.uint8)))
                    break
            else:
                continue
            break
    # 5 % drawn, a quarter of them redraw the same base
    assert 0.025 < float(np.median(rates)) < 0.055


def test_sv_reads_cross_events(gen):
    p = mix("1kb_mixed")["parts"][2]
    assert p["kind"] == "sv_events"
    rng = np.random.default_rng(4)
    reads = generator.sv_events(gen, 300, p, rng)
    assert len(reads) == 300 and {len(r) for r in reads} == {1000}
