"""Models of the joint detect+track serving path."""

from object_tracking_tpu_torch.models.convlstm import FusedConvLSTM  # noqa: F401
from object_tracking_tpu_torch.models.darknet19 import Darknet19  # noqa: F401
from object_tracking_tpu_torch.models.multi_obj_det_tracker import (  # noqa: F401
    MultiObjDetTracker,
)
