"""Data streams (counterpart of boda_tpu's stream/): the block pipelines and
their formats."""
from . import data_stream  # noqa: F401  (registers the "data_stream" base + types)
