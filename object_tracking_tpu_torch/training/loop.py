"""The fit loop: epochs × (train steps, val steps, callbacks).

Port of `object_tracking_tpu/training/loop.py`. The loop owns a TrainState
and step functions; checkpointing, early stopping, plateau LR and metric
logging are explicit components wired here.

- Host batches come from a background thread (`_prefetch`) that runs the
  generator; an exception there is raised again on the main thread. Most
  generators are host work only (decode, padding); `TrackerSequenceBatches`
  also runs its frozen prior on the device from that thread, on the same
  stream as the steps, which orders the two.
- `shard_fn` (JAX's: `parallel.shard_batch` bound to the mesh, which
  keeps this rank's slice of the global host batch; identity by default,
  as the steps move their batch themselves) runs in that thread.
- A step's metrics stay device tensors; `_MetricHistory` pulls them with
  one `torch.stack(...).cpu()` per epoch, so the step loop never waits for
  the card.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import torch

from object_tracking_tpu_torch.training.callbacks import (
    EarlyStopping, ReduceLROnPlateau)
from object_tracking_tpu_torch.training.checkpoint import CheckpointManager
from object_tracking_tpu_torch.training.metrics import MetricLogger


class _MetricHistory:
    """Per-step metrics kept as device scalars; `materialize` stacks the
    whole epoch and copies it to the host once."""

    def __init__(self):
        self._rows = []
        self._steps = []
        self._keys = None

    def add(self, metrics, step: int = 0) -> None:
        if self._keys is None:
            self._keys = list(metrics)
        self._rows.append([torch.as_tensor(metrics[k], dtype=torch.float32)
                           for k in self._keys])
        self._steps.append(step)

    def __len__(self):
        return len(self._rows)

    def materialize(self):
        """→ (per-step [(step, dict)], mean dict) with one pull."""
        if not self._rows:
            return [], {}
        mat = torch.stack([torch.stack(row) for row in self._rows]).cpu()
        rows = [(s, dict(zip(self._keys, map(float, r))))
                for s, r in zip(self._steps, mat)]
        mean = dict(zip(self._keys, map(float, mat.mean(dim=0))))
        return rows, mean


def _prefetch(make_iter, depth: int):
    """Run the host batch pipeline in a background thread, `depth` batches
    ahead of the consumer; the worker's exception is raised again here.
    depth <= 0 disables."""
    if depth <= 0:
        yield from make_iter()
        return
    import queue
    import threading
    q: 'queue.Queue' = queue.Queue(maxsize=depth)
    sentinel = object()
    failure = []

    def worker():
        try:
            for item in make_iter():
                q.put(item)
        except BaseException as e:          # raised again on the main thread
            failure.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            t.join()
            if failure:
                raise failure[0]
            return
        yield item


def fit(state,
        train_step: Callable,
        train_batches: Callable[[], Iterable],
        *,
        eval_step: Optional[Callable] = None,
        val_batches: Optional[Callable[[], Iterable]] = None,
        epochs: int = 100,
        initial_epoch: int = 0,
        shard_fn: Optional[Callable] = None,
        logger: Optional[MetricLogger] = None,
        checkpoints: Optional[CheckpointManager] = None,
        early_stopping: Optional[EarlyStopping] = None,
        reduce_lr: Optional[ReduceLROnPlateau] = None,
        log_every_steps: int = 10,
        prefetch: int = 2,
        checkpoint_every: int = 1,
        on_epoch_end: Optional[Callable] = None):
    """Run the training loop; returns the final TrainState.

    Args:
      train_batches / val_batches: zero-arg callables returning a fresh
        iterator of host batches each epoch.
      shard_fn: host batch → what the steps take (this rank's slice of
        it); identity if None.
      on_epoch_end: optional hook (epoch, state, train_metrics,
        val_metrics).
    """
    shard = shard_fn or (lambda b: b)
    step_count = int(state.step)
    for epoch in range(initial_epoch, epochs):
        t0 = time.time()
        train_hist = _MetricHistory()
        for batch in _prefetch(
                lambda: (shard(b) for b in train_batches()), prefetch):
            state, metrics = train_step(state, batch)
            step_count += 1
            train_hist.add(metrics, step_count)
        train_rows, train_metrics = train_hist.materialize()
        if logger:
            for s, row in train_rows:
                if s % log_every_steps == 0:
                    logger.log(s, row, prefix='train')

        val_metrics = {}
        if eval_step is not None and val_batches is not None:
            val_hist = _MetricHistory()
            for b in _prefetch(
                    lambda: (shard(b) for b in val_batches()), prefetch):
                val_hist.add(eval_step(state, b))
            _, val_metrics = val_hist.materialize()
            if logger and val_metrics:
                logger.log(step_count, val_metrics, prefix='val')

        dt = time.time() - t0
        print(f'epoch {epoch + 1}/{epochs} '
              f'loss={train_metrics.get("loss", float("nan")):.4f} '
              + (f'val_loss={val_metrics.get("loss", float("nan")):.4f} '
                 if val_metrics else '')
              + f'({dt:.1f}s, {len(train_hist)} steps)')

        monitored = val_metrics.get('loss', train_metrics.get('loss'))
        if checkpoints is not None and (
                (epoch + 1) % max(checkpoint_every, 1) == 0
                or epoch + 1 == epochs):
            checkpoints.save(epoch + 1, state,
                             metrics={'val_loss': float(monitored)})
        if reduce_lr is not None and monitored is not None:
            new_lr = reduce_lr.update(float(monitored),
                                      state.learning_rate)
            if new_lr != state.learning_rate:
                print(f'  reducing lr → {new_lr:.2e}')
                state = state.with_learning_rate(new_lr)
        if on_epoch_end is not None:
            on_epoch_end(epoch, state, train_metrics, val_metrics)
        if early_stopping is not None and monitored is not None:
            if early_stopping.update(float(monitored)):
                print(f'  early stopping at epoch {epoch + 1}')
                break
    if checkpoints is not None:
        checkpoints.wait()
    return state
