"""Percent of the live calls' own time with no device operation (camera waits left out)."""

from portbench import readers


def read(reading):
    return readers.idle_in_calls(reading)
