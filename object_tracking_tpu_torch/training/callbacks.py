"""Val-loss-driven training callbacks as plain, testable state machines.

A copy of `object_tracking_tpu/training/callbacks.py` (framework-free; the
port imports nothing of the JAX package): Keras' EarlyStopping(patience 10)
and ReduceLROnPlateau(factor 0.5, patience 5 or 2, min_lr, min_delta 1e-4)
semantics.
"""

from __future__ import annotations

import math


class EarlyStopping:
    def __init__(self, patience: int = 10, min_delta: float = 1e-4):
        self.patience = patience
        self.min_delta = min_delta
        self.best = math.inf
        self.wait = 0

    def update(self, val_loss: float) -> bool:
        """Record one epoch's val loss; returns True to stop training."""
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.wait = 0
            return False
        self.wait += 1
        return self.wait >= self.patience


class ReduceLROnPlateau:
    def __init__(self, factor: float = 0.5, patience: int = 5,
                 min_lr: float = 1e-5, min_delta: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.min_delta = min_delta
        self.best = math.inf
        self.wait = 0

    def update(self, val_loss: float, lr: float) -> float:
        """Record one epoch's val loss; returns the (possibly reduced) lr."""
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.wait = 0
            return lr
        self.wait += 1
        if self.wait >= self.patience:
            self.wait = 0
            return max(lr * self.factor, self.min_lr)
        return lr
