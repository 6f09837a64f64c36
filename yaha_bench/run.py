#!/usr/bin/env python3
"""The benchmark of yaha_tpu_torch, the port's streaming batch-cuda aligner.

    python3 yaha_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of BENCHMARK.json on this machine's card and prints, as the
last line of its standard output, one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 a breakdown, and last the checks,
each number compared beside its limit (also the last lines of standard
error).  It exits non-zero, printing no result, without a CUDA card, or
when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from yaha_bench import harness
    try:
        cell = harness.load_cell(args.workload)
    except harness.UsageError as e:
        print("error: %s" % e, file=sys.stderr)
        return 2
    import torch
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("error: the cell needs %d CUDA device(s); torch %s sees %d"
              % (chips, torch.__version__, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print("error: loaded in the measured process: %s" % ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print("check %s: %s (limit %s)" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
