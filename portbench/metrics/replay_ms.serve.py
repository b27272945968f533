"""Device ms per replay of the served graph, by CUDA events over back-to-back replays."""

from portbench import readers as R


def read(reading):
    return R.timing(reading, "serve", "replay_ms")
