"""Device ms per replay of the detection graph (trunk and head), by CUDA
events over back-to-back replays."""

from portbench import readers as R


def read(reading):
    return R.timing(reading, "detect", "replay_ms")
