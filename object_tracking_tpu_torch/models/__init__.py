"""Models of the joint detect+track path, the detector path and the
single-object pipeline."""

from object_tracking_tpu_torch.models.convlstm import FusedConvLSTM  # noqa: F401
from object_tracking_tpu_torch.models.darknet19 import Darknet19  # noqa: F401
from object_tracking_tpu_torch.models.darknet_cfg import (  # noqa: F401
    CfgDetector, DarknetCfgNet,
)
from object_tracking_tpu_torch.models.fake_detector import FakeDetector  # noqa: F401
from object_tracking_tpu_torch.models.multi_obj_det_tracker import (  # noqa: F401
    MultiObjDetTracker,
)
from object_tracking_tpu_torch.models.tiny_tracker import TinyTracker  # noqa: F401
from object_tracking_tpu_torch.models.vgg16 import (  # noqa: F401
    VGG16, VGG16PriorSource,
)
from object_tracking_tpu_torch.models.yolov2 import YOLOv2Detector  # noqa: F401
