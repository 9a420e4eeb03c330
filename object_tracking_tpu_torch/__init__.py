"""object_tracking_tpu_torch — the PyTorch/CUDA port of object_tracking_tpu.

The JAX package `object_tracking_tpu/` stays the reference; this package
imports nothing of it and nothing of JAX. Module layout mirrors it:

- `config.py`: anchors, the track gate, label sets, config fields;
- `ops/`: box math, decode, greedy NMS (with the hand-written CUDA kernels
  under `ops/cuda/`), track-identity assignment, YOLO target encoding;
- `models/`: Darknet-19, the ConvLSTM layers (fused and stacked), the
  joint detect+track model, the detector surfaces, the single-object
  TinyTracker, the fake prior source and the losses;
- `data/`: annotations, windows, augmentation, batch generators (detector,
  joint and single-object), the synthetic dataset, the dataset converters;
- `training/`: train state and Adam, train/eval steps, the fit loop,
  callbacks, checkpoints, metric logging;
- `utils/`: the program's spans and counters (`profiling.py`), and the
  frames' way in that every serving surface shares (`frames.py`);
- `convert.py`: flax variables and train states (as numpy) ↔ torch;
- `inference.py`: `JointPredictor`, the in-process serving entry point;
- `serving.py`: the clip program exported with torch.export into one
  artifact, and `ServedJointPredictor`, which serves it without model code;
- `trainer.py`: the single-object, joint and detector training flows,
  evaluation, serving export, tracked video, dataset conversion, and the
  command line (`python -m object_tracking_tpu_torch.trainer`).

Entry points run on CUDA unless the caller passes `device='cpu'`.
"""

__version__ = "0.1.0"
