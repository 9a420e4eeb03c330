"""Training layer: train state and Adam, the train/eval steps of the
joint model (plain and fused), the detector and the single-object
tracker, fit loop, callbacks, checkpoints and metric logging."""

from object_tracking_tpu_torch.training.state import (  # noqa: F401
    TrainState, make_optimizer,
)
from object_tracking_tpu_torch.training.steps import (  # noqa: F401
    make_joint_train_step, make_joint_eval_step,
    make_joint_train_step_fused, make_joint_eval_step_fused,
    make_detector_train_step, make_multihead_detector_train_step,
    make_tiny_train_step, make_tiny_eval_step,
)
from object_tracking_tpu_torch.training.callbacks import (  # noqa: F401
    EarlyStopping, ReduceLROnPlateau,
)
from object_tracking_tpu_torch.training.checkpoint import CheckpointManager  # noqa: F401
from object_tracking_tpu_torch.training.loop import fit  # noqa: F401
from object_tracking_tpu_torch.training.metrics import MetricLogger  # noqa: F401
