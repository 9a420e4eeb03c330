"""Host ms per live window inside assign_tracks spans (ops/matching.py), timed without the profiler."""

from portbench import readers


def read(reading):
    return readers.span_host_ms(reading, 'assign_tracks')
