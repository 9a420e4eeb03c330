"""Training layer of the joint model: train state and Adam, train/eval
steps (plain and fused), fit loop, callbacks, checkpoints and metric
logging."""

from object_tracking_tpu_torch.training.state import (  # noqa: F401
    TrainState, make_optimizer,
)
from object_tracking_tpu_torch.training.steps import (  # noqa: F401
    make_joint_train_step, make_joint_eval_step,
    make_joint_train_step_fused, make_joint_eval_step_fused,
)
from object_tracking_tpu_torch.training.callbacks import (  # noqa: F401
    EarlyStopping, ReduceLROnPlateau,
)
from object_tracking_tpu_torch.training.checkpoint import CheckpointManager  # noqa: F401
from object_tracking_tpu_torch.training.loop import fit  # noqa: F401
from object_tracking_tpu_torch.training.metrics import MetricLogger  # noqa: F401
