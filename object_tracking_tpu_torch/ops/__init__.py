"""Tensor ops: boxes, decode, NMS, track matching, target encoding and
the tracker's heatmap codec."""

from object_tracking_tpu_torch.ops.boxes import (  # noqa: F401
    iou_center, iou_corner, pairwise_iou_center, cxcywh_to_xyxy,
    xyxy_to_cxcywh, interval_overlap,
)
from object_tracking_tpu_torch.ops.nms import greedy_nms_scores  # noqa: F401
from object_tracking_tpu_torch.ops.decode import (  # noqa: F401
    decode_netout, decode_and_nms, boxes_to_list,
)
from object_tracking_tpu_torch.ops.heatmap import (  # noqa: F401
    heatmap_encode, heatmap_decode_rect,
)
