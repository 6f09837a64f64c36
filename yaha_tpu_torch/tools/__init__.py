"""Measurement and checking tools of the port (counterparts of the JAX
package's tools/):

  device_replay     one staged chunk's DP launch sequence replayed as a
                    CUDA graph: the device term without the host around it
  decode_profile    the backtrack walk at a hot tier shape, by team size,
                    walk order and plane layout
  seedscan_scaling  phase 1's host seed scan by thread count, beside the
                    device seeder on the same reads
  fuzz_parity       differential fuzz of the port's engines against its
                    native engine over random genomes, reads and flags

Each runs as python -m yaha_tpu_torch.tools.<name> (on the card unless
--device cpu is given) and is driven by chip_smoke.py's phase 10.
"""
