"""Device ms per step in kernels of the pytorch class (BN, Scale, ReLU,
loss, update), by the kernel_classes rules over the profiler's device
events."""

from portbench import readers as R


def read(reading):
    return R.class_ms(reading, "train", "pytorch")
