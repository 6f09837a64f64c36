"""The read pools and genomes of the benchmark's traffic mixes."""
