"""The port's host layers in one place: the run configuration, the genome
and index loaders, and the native C++ pipeline (native/host.py, built
from the port's own sources at first use).  chip_smoke.py and the tests
take them from here.
"""
from .config import AlignmentArgs
from .io.native_loader import load_genome, load_index
from .native.host import (align_batch_native, available,
                          parse_queries_native)

__all__ = ["AlignmentArgs", "align_batch_native", "available",
           "load_genome", "load_index", "parse_queries_native"]
