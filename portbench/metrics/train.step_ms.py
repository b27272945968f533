"""Device ms per replay of the captured training step, by CUDA events."""

from portbench import readers as R


def read(reading):
    return R.timing(reading, "train", "step_ms")
