"""The model's FLOPs times the frames a second of mid-window batched calls, timed without the profiler, percent of the float32 peak."""

from portbench import readers


def read(reading):
    return readers.mfu(reading)
