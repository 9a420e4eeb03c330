"""NMS kernel 1's least time over its device time, percent (ops/cuda/nms.py)."""

from portbench import readers


def read(reading):
    return readers.nms_roofline(reading)
