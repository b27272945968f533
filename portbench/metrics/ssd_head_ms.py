"""Device ms of the SSD head: a replay of the whole detection graph minus a
replay of the same engine's graph cut at the head's inputs, both by CUDA
events."""

from portbench import readers as R


def read(reading):
    return R.head_ms(reading)
