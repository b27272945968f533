"""boda_tpu_torch — the PyTorch and CUDA port of boda_tpu, for one NVIDIA H100.

A self-contained second package beside ``boda_tpu`` (the JAX reference): it
imports ``torch`` and numpy, never ``jax``, ``ml_dtypes`` or ``boda_tpu``.
Its structure mirrors ``boda_tpu`` module for module, so each counterpart is
found by path. What ``boda_tpu`` wrote as Pallas kernels is written here by
hand for Hopper (``csrc/*.cu``, built at first use by ``ops/kernels/build``);
what it left to XLA is plain PyTorch.

Layer map (the slice ported so far):
  utils/        - lexp config values, named-dim arrays, weight carry-over
  config        - declarative config schema + registry + CLI
  ops/          - the tuning knobs and the kernel wrappers (GEMM, direct conv)
  graph/        - ConvPipe IR, NHWC lowering, the whole-net forward engine
  models/       - programmatic ResNet builders
  modes/        - run_cnet, cnet_ana
"""

__version__ = "0.1.0"
