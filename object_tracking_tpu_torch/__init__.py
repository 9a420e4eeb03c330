"""object_tracking_tpu_torch — the PyTorch/CUDA port of object_tracking_tpu.

The JAX package `object_tracking_tpu/` stays the reference; this package
imports nothing of it and nothing of JAX. Module layout mirrors it:

- `config.py`: anchors, the track gate, label sets, config fields;
- `ops/`: box math, decode, greedy NMS (with the hand-written CUDA kernel
  under `ops/cuda/`), track-identity assignment;
- `models/`: Darknet-19, the ConvLSTM and the joint detect+track model;
- `convert.py`: flax variables (as numpy) → torch state_dict;
- `inference.py`: `JointPredictor`, the serving entry point.

Entry points run on CUDA unless the caller passes `device='cpu'`.
"""

__version__ = "0.1.0"
