"""Utilities: profiling and tracing (`profiling.py`), and the frames' way
in: the device rule, the copy to the device and image reads
(`frames.py`)."""
