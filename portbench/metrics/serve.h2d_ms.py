"""Host-to-device copy, device ms per batched call (serving entry, inference.py)."""

from portbench import readers


def read(reading):
    return readers.h2d_ms(reading)
