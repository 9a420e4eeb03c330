"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use.

Each kernel has its source under `csrc/`, a wrapper that checks its inputs,
launches on the current stream and counts its launches, and a plain
PyTorch twin that CPU tensors run. The identity-assignment kernel's
wrapper and twin are `ops/matching.py::assign_tracks` and
`assign_tracks_plain`; `assign.py` here holds its launch plan and launcher.
"""

from object_tracking_tpu_torch.ops.cuda.decode_nms import (  # noqa: F401
    decode_nms_fused, decode_nms_fused_plain,
)
from object_tracking_tpu_torch.ops.cuda.nms import (  # noqa: F401
    nms_scores, nms_scores_plain,
)
