"""Device ms per detect_images call of the proposal layer: decode, clip, the size filter, the top-6,000 sort, kernel 1's NMS and the first 300 (models/faster_rcnn.py::FasterRCNN.propose)."""

from portbench import readers


def read(reading):
    return readers.span_device_ms(reading, 'proposals')
