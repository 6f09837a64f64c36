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


@pytest.mark.parametrize("name", ["1kb_mixed"])
def test_pool_same_seed_same_bytes(gen, name):
    m = small(name, 48)
    a = generator.fasta(generator.make_pool(m, gen, SEED))
    b = generator.fasta(generator.make_pool(m, gen, SEED))
    c = generator.fasta(generator.make_pool(m, gen, SEED + 1))
    assert a == b and a != c


@pytest.mark.parametrize("name", ["1kb_mixed"])
def test_pool_shares(gen, name):
    m = small(name, 160)
    pool = generator.make_pool(m, gen, SEED)
    counts = generator.part_counts(m)
    assert sum(counts) == len(pool) == 160
    for part, n in zip(m["parts"], counts):
        assert n == int(160 * part["share"]) or part is m["parts"][-1]
        got = [r for name_, r in pool if name_.startswith(part["prefix"])]
        assert len(got) == n
        lens = [len(r) for r in got]
        assert max(lens) <= part["length"]
        if part["kind"] == "sampled" and not part.get("indel_events"):
            assert set(lens) == {part["length"]}
    assert len({n for n, _ in pool}) == len(pool)


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
