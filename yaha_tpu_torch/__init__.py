"""yaha_tpu_torch — the PyTorch/CUDA port of yaha_tpu.

  cli.py            python -m yaha_tpu_torch.cli (--engine batch-cuda,
                    batch-torch, native, oracle; index, compress,
                    uncompress)
  host.py           the host layers in one place (config, loaders,
                    native pipeline)
  config.py, io/, utils/
                    the port's copies of the JAX package's host modules
  core/             --engine oracle: the reference-exact Python aligner
  index/build.py    the Python index builder, its passes as torch ops
  native/           the native C++ pipeline (copied sources; g++ build at
                    first use) and its ctypes bindings
  models/staged.py  StagedAligner: native host phases + DP on the card
  ops/sw_cuda.py    the DP entries, their plain PyTorch versions
  ops/gather_dp.py, ops/decode.py
                    device problem assembly and backtrack walk
  ops/_build.py     nvcc build of csrc/ at first use
  csrc/             hand-written CUDA kernels (sm_90a)
  entry.py          the driver entry points: entry() and
                    dryrun_multichip() (python -m yaha_tpu_torch.entry)
  tools/            device replay, walk profile, seed-scan scaling,
                    differential fuzz (python -m yaha_tpu_torch.tools.X)

Imports torch and never jax, and nothing of the JAX package.
"""
