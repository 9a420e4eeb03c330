"""Data layer: annotation parsing, sequence windows, augmentation, the
batch generators of the detector, joint and single-object pipelines, the
synthetic dataset, and the MOT17 / VisualTB → VOC converters
(`data/converters.py`).

Host side stays numpy (the native C++ decoder of `data/native_loader.py`
where its library builds, else cv2 for image files, imported at use); the
augmentation and target encoding that feed the loss are tensor ops that
run on the device inside the fused train step.
"""

from object_tracking_tpu_torch.data.voc import (  # noqa: F401
    Annotation, ObjectAnnotation, parse_annotation, parse_annotation_dir,
)
from object_tracking_tpu_torch.data.windows import make_sequence_windows  # noqa: F401
from object_tracking_tpu_torch.data.augment import (  # noqa: F401
    AugmentConfig, augment_frame, augment_sequence, apply_params,
    draw_params,
)
from object_tracking_tpu_torch.data.generators import (  # noqa: F401
    DetectionBatches, SequenceBatches, TrackerSequenceBatches,
)
from object_tracking_tpu_torch.data import native_loader  # noqa: F401
