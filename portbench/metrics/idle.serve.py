"""Share of the profiled window in which no kernel ran on the device, in the serve cell."""

from portbench import readers as R


def read(reading):
    return R.idle(reading, "serve")
