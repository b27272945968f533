"""boda_tpu_torch — the PyTorch and CUDA port of boda_tpu, for one NVIDIA H100.

A self-contained second package beside ``boda_tpu`` (the JAX reference): it
imports ``torch`` and numpy, never ``jax``, ``ml_dtypes`` or ``boda_tpu``.
Its structure mirrors ``boda_tpu`` module for module, so each counterpart is
found by path. What ``boda_tpu`` wrote as Pallas kernels is written here by
hand for Hopper (``csrc/*.cu``, built at first use by ``ops/kernels/build``);
what it left to XLA is plain PyTorch.

Layer map (the slices ported so far):
  utils/        - lexp config values, named-dim arrays, digests, timers
  config        - declarative config schema + registry + CLI
  rtc/          - compute backends (cuda, interp): named device vars, calls
  ops/          - op signatures, tuning knobs, the generator registry and
                  the kernel wrappers (GEMM, conv, wgrad, block, pool,
                  eltwise, stem)
  prof/         - per-op profiling (ops_prof), paired A/B timing, wisdom
  graph/        - ConvPipe IR, autodiff, NHWC lowering, the engine
  models/       - programmatic ResNet builders
  modes/        - run_cnet, cnet_ana, test_compute, comp_ndas, rtc_test,
                  sgemm_run, ops_prof, gen_prof_ops, wis_merge, wis_ana
"""

__version__ = "0.1.0"
