"""Command line of the PyTorch/CUDA port: ``python -m yaha_tpu_torch.cli``.

Query runs (-x/-q) take the reference flag set of yaha_tpu.cli plus:

  --engine batch-cuda   the staged engine with its DP on the card (the
                        only engine here; the others are in yaha_tpu.cli):
                        the genome stays on the card, every DP problem is
                        assembled there, and the backtrack walk runs there,
                        so only run-length items come back (the JAX
                        package's default batch-pallas configuration).
                        YT_STAGED_DEVRES=0 fetches problems on the host and
                        YT_STAGED_RLE=0 brings the planes back to the
                        native walkers (A/B configurations).
  --device cuda|cpu     where the kernels run (default cuda); cpu runs
                        their plain PyTorch versions.  With cuda and no
                        card the run stops with an error.
  --prewarm             accepted and does nothing: nothing is cached

Compress, uncompress and index runs go to yaha_tpu.cli unchanged.
"""
from __future__ import annotations

import os
import sys

from yaha_tpu import cli as _ref

from . import host

ENGINES = ("batch-cuda",)
DEVICES = ("cuda", "cpu")

_INT_FLAGS = {
    "-t": "num_threads", "-H": "max_hits", "-BW": "band_width",
    "-G": "max_gap", "-M": "min_match", "-MD": "max_desert",
    "-X": "x_cutoff", "-GEC": "ge_cost", "-GOC": "go_cost",
    "-MS": "m_score", "-RC": "r_cost", "-BP": "bp_cost",
    "-MGDP": "max_bp_log", "-MNO": "oqc_min_non_overlap",
    "-I": "max_intron", "-R": "min_raw_score", "-L": "word_len",
    "-S": "skip_dist", "--batch-size": "batch_size",
    "--max-query-length": "max_query_length",
    "--max-region-frags": "max_region_frags",
}
_FLOAT_FLAGS = {"-P": "min_identity", "-PRL": "fbs_ps_length",
                "-PSS": "fbs_ps_score"}
_BOOL_FLAGS = {"-AGS": "affine_gap_scoring", "-OQC": "oqc", "-FBS": "fbs"}
_STR_FLAGS = {"-x": "xfile_name", "-q": "qfile_name", "-qs": "qs_file_name",
              "-g": "gfile_name"}
# Flags of yaha_tpu.cli whose paths are not ported yet.
_NOT_PORTED = ("--model-shards", "--coordinator", "--num-hosts",
               "--host-id", "--trace")

USAGE = """\
yaha_tpu_torch: split-read DNA aligner, DP phases on an NVIDIA GPU

Align queries:
  python -m yaha_tpu_torch.cli -x <indexFile> -q <queryFile (fa|fastq)>
           [-osh|-oss|-o8 <outFile>] [reference options]
           [--engine batch-cuda] [--device cuda|cpu] [--batch-size N]
           [--max-query-length N] [--max-region-frags N] [--resume]
--engine batch-cuda assembles the DP problems and walks their backtrack
planes on the device; YT_STAGED_DEVRES=0 / YT_STAGED_RLE=0 select the
host-fetch / plane-transfer A/B configurations.
Index, compress, uncompress: as python -m yaha_tpu.cli.
Not ported yet: --seed device, %s.""" % ", ".join(_NOT_PORTED)


def _fail(msg):
    print(msg, file=sys.stderr)
    sys.exit(1)


def parse_query_args(argv):
    """Parse a query command line into (AlignmentArgs, device name)."""
    aa = host.AlignmentArgs()
    device = "cuda"
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in _NOT_PORTED or (a == "--seed" and i + 1 < len(argv)
                                and argv[i + 1] == "device"):
            _fail("%s is not ported to yaha_tpu_torch yet (not ported: "
                  "--seed device, %s); use python -m yaha_tpu.cli."
                  % (a, ", ".join(_NOT_PORTED)))
        if a in ("-v", "--prewarm", "--resume"):
            setattr(aa, {"-v": "verbose", "--prewarm": "prewarm",
                         "--resume": "resume"}[a], True)
            i += 1
            continue
        if i + 1 >= len(argv):
            _fail("%s is not a valid option.\n" % a)
        val = argv[i + 1]
        if a in _INT_FLAGS:
            setattr(aa, _INT_FLAGS[a], _ref._parse_int(val, a))
        elif a in _FLOAT_FLAGS:
            setattr(aa, _FLOAT_FLAGS[a], _ref._parse_float(val, a))
        elif a in _BOOL_FLAGS:
            setattr(aa, _BOOL_FLAGS[a], _ref._parse_bool(val, a))
        elif a in _STR_FLAGS:
            setattr(aa, _STR_FLAGS[a], val)
        elif a in ("-osh", "-oss", "-o8"):
            aa.output_blast8 = a == "-o8"
            aa.output_sam = a != "-o8"
            if a != "-o8":
                aa.hard_clip = a == "-osh"
            aa.ofile_name = val
        elif a == "--engine":
            if val not in ENGINES:
                _fail("--engine must be one of: %s (the other engines are "
                      "in python -m yaha_tpu.cli)" % ", ".join(ENGINES))
        elif a == "--device":
            if val not in DEVICES:
                _fail("--device must be one of: %s" % ", ".join(DEVICES))
            device = val
        elif a == "--seed":
            if val != "host":
                _fail("--seed must be host or device")
        else:
            _fail("%s is not a valid option.\n" % a)
        i += 2
    if aa.xfile_name is None:
        _fail("Index file specification (-x) is required for query "
              "alignment.")
    aa.gfile_name = os.path.splitext(aa.xfile_name)[0] + ".nib2"
    if aa.ofile_name is None:
        aa.output_blast8 = False
        aa.output_sam = True
        aa.hard_clip = True
        aa.ofile_name = "stdout"
    aa.post_process(True)
    return aa, device


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if any(a in ("-h", "-?", "-xh") for a in argv):
        print(USAGE, file=sys.stderr)
        return 0
    if "-x" not in argv and "-q" not in argv:
        return _ref.main(argv)
    aa, device = parse_query_args(argv)
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        _fail("--device cuda: no CUDA device is available (torch %s); "
              "use --device cpu to run the DP on the host." %
              torch.__version__)
    if getattr(aa, "prewarm", False):
        return 0
    if not host.available():
        _fail("--engine batch-cuda requires the native host library "
              "(tools/build_native.sh).")
    genome = host.load_genome(aa.gfile_name)
    index = host.load_index(aa.xfile_name)
    aa.word_len = index.word_len
    if index.max_hits < aa.max_hits:
        print("WARNING: Index file made with maxHits of %d, while %d "
              "specified for this query run.\nMimimum of two (%d) will be "
              "used." % (index.max_hits, aa.max_hits, index.max_hits),
              file=sys.stderr)
        aa.max_hits = index.max_hits
    if not getattr(aa, "batch_size", 0):
        aa.batch_size = 16384
    from .models.staged import StagedAligner
    aligner = StagedAligner(aa, genome, index, device=device,
                            n_threads=aa.num_threads)

    def _align(pr, lo, hi, dist=None, want_stats=False):
        if want_stats:
            text, sm, nr, stats = aligner.align_chunk(
                pr, lo, hi, dist=dist, want_stats=True)
            return text, stats, sm, nr
        text, sm, nr = aligner.align_chunk(pr, lo, hi, dist=dist)
        return text, None, sm, nr
    _ref._run_native_engine(aa, genome, index, align_fn=_align,
                            dp_stats=aligner.stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
