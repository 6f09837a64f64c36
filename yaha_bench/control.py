#!/usr/bin/env python3
"""The control of the check: the reference put in the program's place with
one guarantee broken, which the comparison has to find.

The configurations state no precision (every score is an exact integer)
and guarantee yaha 0.1.83's records at its default flags, among them its
OQC pass (-OQC Y: the records of a read are chosen for the best coverage
of the query, with break-point costs, QueryMatch.c / OQC).  The control is
the reference's own aligner with that pass replaced by the plain duplicate
removal (-OQC N), the cut a faster host path would be tempted to take,
since the OQC path search is the heaviest host step of a split read.  Its
records for the check's sample of a cell (the same genome, reads, index,
kept batches and sample as a run of six passes) stand in the kept
batches' texts and go through the harness's comparison (check.judge), and
the readings are printed per seed:

    python3 yaha_bench/control.py --workload <cell> --seeds 1,2,3

The benchmark's own runs never run this.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BROKEN = ["-OQC", "N"]


def readings(cell: dict, seed: int, device: str = "cuda", passes: int = 6,
             log=sys.stderr):
    """(checks, correct) of the control for `cell` at `seed`, from the
    harness's own comparison (check.judge): `passes` passes of the cell's
    FASTA, one batch of each kept as the plan drawn from the seed keeps
    it, the sample drawn from them, and the control's records of the
    sampled reads in place of each kept batch's text."""
    from yaha_bench.check import file_reads, judge, keep_plan, pick_sample
    from yaha_bench.harness import copies_for
    from yaha_bench.reference import index as rindex, runner
    from yaha_bench.traffic.generator import fasta, make_pool
    from yaha_bench.traffic.genome import make_genome
    config, traffic = cell["config"], cell["traffic"]
    ic = config["index"]
    t0 = time.perf_counter()
    g = make_genome(dict(config["genome"], bases=config["genome_bases"]),
                    seed, device)
    reads = file_reads(make_pool(traffic, g, seed), copies_for(traffic))
    index = rindex.build(g.codes, g.starts, g.lengths, ic["word_len"],
                         ic["skip_dist"], ic["max_hits"], device=device)
    batch = int(traffic["batch_reads"])
    firsts = list(range(0, len(reads), batch))
    plan = keep_plan(seed, len(firsts))
    extents = [(firsts[s], min(batch, len(reads) - firsts[s]))
               for s in plan[:passes]]
    picks = pick_sample(extents, traffic["check_reads"], seed)
    sample = fasta([reads[k] for k in sorted({k for k, _ in picks})])
    rgenome = runner.genome(g.names, g.starts, g.lengths, g.codes)
    ref = runner.align(runner.alignment_args(config["query_flags"], index),
                       rgenome, index, sample)
    ctl = runner.align(runner.alignment_args(
        list(config["query_flags"]) + BROKEN, index), rgenome, index, sample)
    kept = [(first, n, "".join(ctl[reads[k][0]] for k, b in picks
                               if b == i).encode("latin-1"))
            for i, (first, n) in enumerate(extents)]
    checks, differ = judge(kept, picks, reads, ref)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    print("seed %d: correct %s; %s (%.1f s)" % (
        seed, correct, ", ".join("%s %d (limit %d)" % (
            k, c["value"], c["limit"]) for k, c in checks.items()),
        time.perf_counter() - t0), file=log)
    return checks, correct


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from yaha_bench import harness
    cell = harness.load_cell(args.workload)
    got = [readings(cell, int(s), args.device)
           for s in args.seeds.split(",")]
    print("control %s: reads_differing %s of %d sampled reads; correct %s"
          % (args.workload, [c["reads_differing"]["value"] for c, _ in got],
             cell["traffic"]["check_reads"], [ok for _, ok in got]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
