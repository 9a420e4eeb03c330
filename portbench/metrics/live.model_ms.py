"""Device ms per live window of the kernels inside the model's forward span."""

from portbench import readers


def read(reading):
    return readers.span_device_ms(reading, 'model')
