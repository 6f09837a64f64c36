"""The synthetic genome of a configuration, made in memory from the seed.

Frozen copy of the model of tools/make_big_genome.py (uniform random
bases, interspersed copies of a few Alu-like repeat units, runs of N), in
4-bit codes and laid out as the port's FASTA-to-nib2 step lays a genome
out: each chromosome starts on an 8-base boundary, the gap before the next
padded with X (code 14), and 8,192 zero codes after the last one (the
reference's mmap zero page).  Bases are drawn on `device` with a
torch.Generator in a few large calls; the same seed on the same kind of
device gives the same bytes.  The seed draws the letters alone: the
layout (which unit each repeat slot holds, where it lies, where the N runs
lie and how long they are) comes from a stream that no seed changes, so
every seed lays out the same repeats and N runs in the same places, each
unit with the same number of copies, and a cell's work does not change
with the seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PAD_CODE = 14          # X, the nib2 pad nibble
TAIL_CODES = 8192      # zero codes past the last chromosome
CODE_CHARS = np.frombuffer(b"TCAGNBDHKMRSVWXY", np.uint8)   # code -> char
COMP_CODES = np.array([2, 3, 0, 1, 4, 12, 7, 6, 9, 8, 15, 11, 5, 13, 14,
                       10], np.uint8)                      # code -> complement


@dataclasses.dataclass
class SynthGenome:
    names: list
    starts: np.ndarray     # int64, first code of each chromosome
    lengths: np.ndarray    # int64, bases of each chromosome
    codes: np.ndarray      # uint8, the whole padded code array
    device_codes: object = None   # the same codes as a tensor on the device

    def chrom(self, c: int) -> np.ndarray:
        s = int(self.starts[c])
        return self.codes[s:s + int(self.lengths[c])]


# The seed of the layout streams (genome and pools): the same for every run.
LAYOUT_SEED = 0x59414841


def generator(seed: int, device, stream: int):
    """A torch.Generator on `device` for one of the benchmark's streams of
    `seed` (any whole number: it is folded into the 64 bits a generator
    takes)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def make_genome(spec: dict, seed: int, device="cuda") -> SynthGenome:
    """The genome of `spec` (a configuration's "genome" object and its
    top-level "genome_bases") from `seed`, built on `device`."""
    import torch
    total = int(spec["bases"])
    n_chrom = int(spec["chromosomes"])
    per = total // n_chrom
    units_len = [int(u) for u in spec["repeat_unit_lengths"]]
    every = int(spec["repeat_every"])
    n_runs = int(spec["n_runs_per_chromosome"])
    run_min, run_max = (int(x) for x in spec["n_run_length"])
    stride = (per + 7) // 8 * 8
    starts = np.arange(n_chrom, dtype=np.int64) * stride
    g = generator(seed, device, 0)
    lay = generator(LAYOUT_SEED, device, 0)
    codes = torch.randint(0, 4, (n_chrom * stride + TAIL_CODES,),
                          generator=g, device=device, dtype=torch.uint8)
    units = [torch.randint(0, 4, (n,), generator=g, device=device,
                           dtype=torch.uint8) for n in units_len]
    n_rep = per // every
    pick = torch.randint(0, len(units), (n_chrom, n_rep), generator=lay,
                         device=device).tolist()
    where = torch.rand((n_chrom, n_rep), generator=lay,
                       device=device).double().cpu().numpy()
    run_at = torch.rand((n_chrom, n_runs), generator=lay,
                        device=device).double().cpu().numpy()
    run_len = torch.randint(run_min, run_max + 1, (n_chrom, n_runs),
                            generator=lay, device=device).tolist()
    for c in range(n_chrom):
        s = int(starts[c])
        for k in range(n_rep):
            u = units[pick[c][k]]
            p = s + int(where[c, k] * (per - len(u)))
            codes[p:p + len(u)] = u
        for k in range(n_runs):
            n = run_len[c][k]
            p = s + int(run_at[c, k] * (per - n))
            codes[p:p + n] = 4
        codes[s + per:s + stride] = PAD_CODE
    codes[n_chrom * stride:] = 0
    return SynthGenome(names=["chr%d" % (c + 1) for c in range(n_chrom)],
                       starts=starts,
                       lengths=np.full(n_chrom, per, np.int64),
                       codes=codes.cpu().numpy(), device_codes=codes)
