"""Model FLOPs utilisation of the train cell's window against the bf16 peak."""

from portbench import readers as R


def read(reading):
    return R.mfu(reading, "train")
