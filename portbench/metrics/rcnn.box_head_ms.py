"""Device ms per detect_images call of the RoI head: fc6, fc7, cls_score with its softmax and bbox_pred over every RoI (models/faster_rcnn.py::FasterRCNN.box_head)."""

from portbench import readers


def read(reading):
    return readers.span_device_ms(reading, 'box_head')
