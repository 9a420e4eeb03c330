"""Device ms per training step of BatchNorm's kernels, forward and backward (models/darknet19.py)."""

from portbench import readers


def read(reading):
    return readers.batch_norm_ms(reading)
