"""Device ms per detect_images call of the three heads' decode, merge, top-K cap and NMS (models/darknet_cfg.py::decode_cfg_outputs)."""

from portbench import readers


def read(reading):
    return readers.span_device_ms(reading, 'decode_nms')
