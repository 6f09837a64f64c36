"""The reader of dispatch.launches_per_batch,
under a name of its own for the cells that bound no reads_per_s
(devidx.1kb_mixed): a metric's `moves` names an end-to-end metric that
each of its cells reports."""
from yaha_bench.harness import load_reader

read = load_reader("dispatch.launches_per_batch")
