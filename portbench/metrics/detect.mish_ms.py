"""Device ms per detect_images call of the kernels launched inside the Mish activations of the compiled network (models/darknet_cfg.py::_activate)."""

from portbench import readers


def read(reading):
    return readers.span_device_ms(reading, 'mish')
