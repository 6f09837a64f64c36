"""yaha_tpu_torch — the PyTorch/CUDA port of yaha_tpu's staged device engine.

  cli.py            python -m yaha_tpu_torch.cli (--engine batch-cuda)
  host.py           the jax-free host layers borrowed from yaha_tpu
  models/staged.py  StagedAligner: native host phases + DP on the card
  ops/sw_cuda.py    the DP entries, their plain PyTorch versions
  ops/_build.py     nvcc build of csrc/ at first use
  csrc/             hand-written CUDA kernels (sm_90a)

Imports torch and never jax.
"""
