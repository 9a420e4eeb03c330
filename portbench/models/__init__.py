"""Kinds of model, found by name: a configuration's `builder` names
`models/<builder>.py`. A kind knows what differs from model to model:

- `weight_spec(cfg)`: (name, shape, init, fan_in) of every tensor, named
  by the program's state-dict keys (`weights.py` draws them);
- `conv_table(cfg)`: (name, forward FLOPs a frame, input gradient taken)
  of every convolution (`flops.py` counts from it);
- `program(cfg, dtype)`: the program's model, constructed in the compute
  dtype of the configuration's precision (the caller builds it on the
  meta device and loads the weights);
- for training: `program_step(cfg, mix, loss_cfg)`, the program's step;
  `train_batches(pool, cfg)`, the raw batches of `traffic.train_pool` in
  the form that step takes; `reference_batch(batch, cfg, device)` and
  `reference_loss(w, cfg, batch)`, the reference's.

A new kind of model is a new file here; no file changes.
"""

from __future__ import annotations

import importlib


def kind(cfg: dict):
    return importlib.import_module(f"portbench.models.{cfg['builder']}")
