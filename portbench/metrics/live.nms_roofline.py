"""NMS kernel 1's least time over its device time on the live path, percent."""

from portbench import readers


def read(reading):
    return readers.nms_roofline(reading)
