"""The model's FLOPs of mid-window live windows, timed without the profiler, over the calls' own time, percent of the float32 peak."""

from portbench import readers


def read(reading):
    return readers.mfu(reading, 'call')
