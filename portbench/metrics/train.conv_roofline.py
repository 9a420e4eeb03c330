"""The step's convolution FLOPs at the float32 peak over the convolution kernels' device time, percent."""

from portbench import readers


def read(reading):
    return readers.conv_roofline(reading)
