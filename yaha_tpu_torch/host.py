"""Host layers the port shares with yaha_tpu, imported rather than copied.

These modules of the reference package load no jax: the run
configuration, the genome/index loaders, and the native C++ pipeline
(loaded with ctypes; built on first use by tools/build_native.sh).  The
port's entry points and scripts take them from here, so that this module
names the whole surface the port borrows.
"""
from yaha_tpu.config import AlignmentArgs
from yaha_tpu.io.native_loader import load_genome, load_index
from yaha_tpu.native.host import (align_batch_native, available,
                                  parse_queries_native)

__all__ = ["AlignmentArgs", "align_batch_native", "available",
           "load_genome", "load_index", "parse_queries_native"]
