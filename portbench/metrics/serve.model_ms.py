"""Device ms per batched call of the kernels inside the model's forward span (models/)."""

from portbench import readers


def read(reading):
    return readers.span_device_ms(reading, 'model')
