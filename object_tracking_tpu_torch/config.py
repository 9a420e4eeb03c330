"""Constants and config fields of the serving and detector paths.

The port keeps its own copy of what it reads from the JAX package's
`object_tracking_tpu/config.py` (anchors, the track gate, the COCO and
MOT17 label sets, and the `DetectorConfig` / `JointConfig` fields the port
uses), so that importing it never imports the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# Anchor priors (grid-cell units) — YOLOv2 COCO anchors.
YOLOV2_ANCHORS: Tuple[float, ...] = (
    0.57273, 0.677385, 1.87446, 2.06253, 3.33843,
    5.47434, 7.88282, 3.52778, 9.77052, 9.16828,
)

# Track-association IoU gate shared by every identity-assignment layer
# (ops/matching.assign_tracks, TrackManager, inference.JointPredictor).
# NOT the NMS threshold and NOT the eval match threshold.
TRACK_GATE_IOU: float = 0.3

LABELS_COCO: Tuple[str, ...] = (
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus',
    'train', 'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse',
    'sheep', 'cow', 'elephant', 'bear', 'zebra', 'giraffe',
    'backpack', 'umbrella', 'handbag', 'tie', 'suitcase', 'frisbee',
    'skis', 'snowboard', 'sports ball', 'kite', 'baseball bat',
    'baseball glove', 'skateboard', 'surfboard', 'tennis racket', 'bottle',
    'wine glass', 'cup', 'fork', 'knife', 'spoon', 'bowl', 'banana',
    'apple', 'sandwich', 'orange', 'broccoli', 'carrot', 'hot dog',
    'pizza', 'donut', 'cake', 'chair', 'couch', 'potted plant', 'bed',
    'dining table', 'toilet', 'tv', 'laptop', 'mouse', 'remote',
    'keyboard', 'cell phone', 'microwave', 'oven', 'toaster', 'sink',
    'refrigerator', 'book', 'clock', 'vase', 'scissors', 'teddy bear',
    'hair drier', 'toothbrush',
)

LABELS_MOT17: Tuple[str, ...] = tuple(str(i) for i in range(1, 13))


@dataclass
class DetectorConfig:
    """YOLOv2 detector fields (the joint path's label set is
    JointConfig.labels)."""
    labels: Tuple[str, ...] = LABELS_COCO
    image_h: int = 416
    image_w: int = 416
    grid_h: int = 13
    grid_w: int = 13
    num_anchors: int = 5
    anchors: Tuple[float, ...] = YOLOV2_ANCHORS
    obj_threshold: float = 0.5
    nms_threshold: float = 0.45
    # darknet yolov2.weights to load at construction
    weights_path: Optional[str] = None
    # Backbone channel-width divisor (floor 4 channels); 1 = full width.
    width_div: int = 1

    @property
    def num_classes(self) -> int:
        return len(self.labels)


@dataclass
class JointConfig:
    """Joint detect+track model fields read by the serving path."""
    labels: Tuple[str, ...] = LABELS_MOT17
    sequence_length: int = 4
    convlstm_features: int = 512
    # 'bfloat16' activations (parameters stay float32) or 'float32'.
    compute_dtype: str = 'float32'
