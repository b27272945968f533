"""The benchmark of boda_tpu_torch: see run.py."""
