"""Mish's least time (its elements read and written once, float32, at
HBM's rate: models/yolov4.py::mish_bound_s) over the device time of the
kernels launched inside the Mish activations, percent."""

from portbench.models import yolov4


def read(reading):
    device = reading['span_device_s'].get('mish')
    elements = reading['notes'].get('mish', [])
    if not device or not elements:
        return None
    return 100.0 * yolov4.mish_bound_s(sum(elements)) / device
