"""The conv and fc work's roofline bound over the conv-class kernels'
device time, per unit, in the detect cell."""

from portbench import readers as R


def read(reading):
    return R.conv_roofline(reading, "detect")
