"""Percent of the traced batched calls' window with no device operation."""

from portbench import readers


def read(reading):
    return readers.idle(reading)
