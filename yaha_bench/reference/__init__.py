"""The benchmark's plain reference: frozen copies of the port's pure-Python
oracle (core/, the SAM writer, the FASTA reader, the RNG, the run
configuration) with their native delegation taken out, and an index
builder of its own (index.py).  It imports nothing of the port and nothing
of JAX: it re-derives the index from the genome that the benchmark made and
aligns the reads that the benchmark made."""
