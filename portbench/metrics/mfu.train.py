"""The training steps' FLOPs over the wall time of mid-window steps timed without the profiler, percent of the float32 peak."""

from portbench import readers


def read(reading):
    return readers.mfu(reading)
