"""RoI pooling's least time (the pooled output written once and conv5_3
read once, float32, at HBM's rate: models/frcnn.py::roi_pool_bound_s)
over the device time of the kernels launched inside the RoI-pooling spans
(models/faster_rcnn.py::FasterRCNN.pool), percent."""

from portbench.models import frcnn


def read(reading):
    device = reading['span_device_s'].get('roi_pool')
    calls = reading['notes'].get('roi_pool', [])
    if not device or not calls:
        return None
    return 100.0 * sum(frcnn.roi_pool_bound_s(*c) for c in calls) / device
