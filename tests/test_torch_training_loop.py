"""The port's training layer around the steps: callbacks, checkpoints,
metric logging, prefetch and the fit loop, mirroring tests/test_training.py
(callbacks, checkpoint round trip, variables_only, empty directory, fit
end to end and early stopping) on a small regression model."""

import json
import os

import numpy as np
import pytest
import torch

from object_tracking_tpu.training import ReduceLROnPlateau as JReduce
from object_tracking_tpu_torch.training import (CheckpointManager,
                                                EarlyStopping, MetricLogger,
                                                ReduceLROnPlateau,
                                                TrainState, fit,
                                                make_optimizer)
from object_tracking_tpu_torch.training.loop import _MetricHistory, _prefetch
from torch_ranks import late_save_world, run_world


# ---------------------------------------------------------------- callbacks
def test_early_stopping_patience():
    es = EarlyStopping(patience=3, min_delta=0.0)
    assert not es.update(1.0)
    assert not es.update(0.9)
    assert not es.update(0.95)
    assert not es.update(0.95)
    assert es.update(0.95)


def test_reduce_lr_on_plateau_matches_jax():
    port = ReduceLROnPlateau(factor=0.5, patience=2, min_lr=1e-5,
                             min_delta=0.0)
    ref = JReduce(factor=0.5, patience=2, min_lr=1e-5, min_delta=0.0)
    lr_p = lr_r = 1e-3
    for loss in [1.0, 1.0, 1.0, 0.5] + [0.5] * 20:
        lr_p, lr_r = port.update(loss, lr_p), ref.update(loss, lr_r)
        assert lr_p == lr_r
    assert lr_p == pytest.approx(1e-5)


# -------------------------------------------------------- a small model
class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.net = torch.nn.Sequential(torch.nn.Linear(3, 8), torch.nn.Tanh(),
                                       torch.nn.Linear(8, 1))
        self.register_buffer('seen', torch.zeros(()))


def _state(lr=1e-2, clip=None, seed=0):
    torch.manual_seed(seed)
    return TrainState.create(_MLP(), make_optimizer(lr, grad_clip_norm=clip))


def _train_step(state, batch):
    state.optimizer.zero_grad(set_to_none=True)
    loss = torch.mean((state.model.net(batch['x']) - batch['y']) ** 2)
    loss.backward()
    state.model.seen += 1
    state.apply_gradients()
    return state, {'loss': loss.detach()}


def _eval_step(state, batch):
    with torch.no_grad():
        return {'loss': torch.mean((state.model.net(batch['x'])
                                    - batch['y']) ** 2)}


BATCH = {'x': torch.ones(4, 3), 'y': torch.full((4, 1), 2.0)}


def test_apply_gradients_steps_and_descends():
    state = _state()
    losses = []
    for _ in range(20):
        state, m = _train_step(state, BATCH)
        losses.append(float(m['loss']))
    assert state.step == 20 and losses[-1] < losses[0]


# -------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    for _ in range(3):
        state, _ = _train_step(state, BATCH)
    mgr = CheckpointManager(str(tmp_path / 'ckpt'), max_to_keep=2)
    assert mgr.save(1, state, metrics={'val_loss': 0.5})
    mgr.wait()
    assert mgr.latest_step() == 1
    assert not [f for f in os.listdir(mgr.directory) if f.endswith('.tmp')]

    template = _state(seed=1)
    restored, step = mgr.restore(template)
    assert step == 1 and restored.step == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    # the restored optimizer continues exactly as the original
    _, m_a = _train_step(state, BATCH)
    _, m_b = _train_step(restored, BATCH)
    assert torch.equal(m_a['loss'], m_b['loss'])
    for a, b in zip(state.model.parameters(), restored.model.parameters()):
        assert torch.equal(a, b)
    mgr.close()


def test_checkpoint_variables_only_survives_optimizer_drift(tmp_path):
    """A checkpoint saved with grad-clip + Adam restores into a template
    built with a plain optimizer; the template's optimizer state is kept."""
    state = _state(clip=1.0)
    state, _ = _train_step(state, BATCH)
    mgr = CheckpointManager(str(tmp_path / 'ckpt'))
    mgr.save(1, state)
    template = _state(lr=5e-4, seed=1)
    restored, step = CheckpointManager(str(tmp_path / 'ckpt')).restore(
        template, variables_only=True)
    assert step == 1 and restored.step == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    assert restored.optimizer.state_dict()['state'] == {}
    assert restored.learning_rate == pytest.approx(5e-4)


def test_checkpoint_restore_empty_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path / 'none'))
    state = _state()
    restored, step = mgr.restore(state)
    assert step is None and restored is state


def test_checkpoint_policies(tmp_path):
    """max_to_keep keeps the latest; best_mode the lowest val_loss; a save
    at a step not above the latest is skipped (orbax's rules)."""
    state = _state()
    latest = CheckpointManager(str(tmp_path / 'latest'), max_to_keep=2)
    best = CheckpointManager(str(tmp_path / 'best'), max_to_keep=2,
                             best_mode=True)
    for step, loss in zip(range(1, 6), (0.5, 0.1, 0.9, 0.2, 0.7)):
        assert latest.save(step, state, metrics={'val_loss': loss})
        assert best.save(step, state, metrics={'val_loss': loss})
    assert latest.all_steps() == [4, 5]
    assert best.all_steps() == [2, 4]
    assert not latest.save(5, state) and latest.all_steps() == [4, 5]
    with open(os.path.join(best.directory, 'ckpt_2.json')) as f:
        assert json.load(f) == {'val_loss': 0.1}


def test_checkpoint_save_decides_alike_on_every_rank(tmp_path):
    """A save reads the directory on every rank before rank 0 writes to
    it: a rank that comes late must not see rank 0's file, skip the save
    and its barrier, and leave rank 0 waiting there."""
    ranks = run_world(late_save_world, 2, tmp_path, str(tmp_path / 'ckpt'),
                      timeout=120)
    assert ranks == [(True, [1]), (True, [1])]


# ---------------------------------------------------------------- logging
def test_metric_logger_jsonl(tmp_path):
    logger = MetricLogger(str(tmp_path / 'logs'), use_tensorboard=False)
    logger.log(3, {'loss': torch.tensor(0.25)}, prefix='train')
    logger.close()
    with open(tmp_path / 'logs' / 'metrics.jsonl') as f:
        rec = json.loads(f.readline())
    assert rec['step'] == 3 and rec['train/loss'] == 0.25


def test_metric_history_one_pull():
    hist = _MetricHistory()
    for i in range(4):
        hist.add({'a': torch.tensor(float(i)), 'b': torch.tensor(1.0)}, i)
    rows, mean = hist.materialize()
    assert len(hist) == 4 and rows[2] == (2, {'a': 2.0, 'b': 1.0})
    assert mean == {'a': 1.5, 'b': 1.0}
    assert _MetricHistory().materialize() == ([], {})


@pytest.mark.parametrize('depth', [0, 2])
def test_prefetch_yields_in_order_and_reraises(depth):
    assert list(_prefetch(lambda: iter(range(5)), depth)) == list(range(5))

    def broken():
        yield 1
        raise ValueError('decode failed')
    with pytest.raises(ValueError, match='decode failed'):
        list(_prefetch(broken, depth))


# -------------------------------------------------------------------- loop
def test_fit_loop_end_to_end(tmp_path):
    state = _state()
    logger = MetricLogger(str(tmp_path / 'logs'), use_tensorboard=False)
    ckpts = CheckpointManager(str(tmp_path / 'ckpt'))
    moved = []
    final = fit(state, _train_step, lambda: iter([BATCH, BATCH]),
                eval_step=_eval_step, val_batches=lambda: iter([BATCH]),
                epochs=2, logger=logger, checkpoints=ckpts,
                early_stopping=EarlyStopping(patience=5),
                reduce_lr=ReduceLROnPlateau(patience=3), log_every_steps=1,
                shard_fn=lambda b: moved.append(1) or b)
    assert final.step == 4 and float(final.model.seen) == 4
    assert len(moved) == 6                      # 4 train + 2 val batches
    assert ckpts.latest_step() == 2
    logger.close()
    with open(tmp_path / 'logs' / 'metrics.jsonl') as f:
        lines = [json.loads(line) for line in f]
    assert [r['step'] for r in lines if 'train/loss' in r] == [1, 2, 3, 4]
    assert len([r for r in lines if 'val/loss' in r]) == 2


def test_fit_early_stops():
    state = _state(lr=0.0)       # no improvement → stop after patience
    final = fit(state, _train_step, lambda: iter([BATCH]),
                eval_step=_eval_step, val_batches=lambda: iter([BATCH]),
                epochs=50,
                early_stopping=EarlyStopping(patience=2, min_delta=0.0))
    assert final.step <= 4


def test_fit_reduces_lr_on_plateau():
    state = _state(lr=0.0)
    final = fit(state, _train_step, lambda: iter([BATCH]), epochs=4,
                reduce_lr=ReduceLROnPlateau(factor=0.5, patience=1,
                                            min_lr=0.0, min_delta=0.0))
    assert final.learning_rate == 0.0 and final.step == 4
    state = _state(lr=1e-3)
    state.with_learning_rate(1e-3)
    final = fit(state, lambda s, b: (s, {'loss': torch.tensor(1.0)}),
                lambda: iter([BATCH]), epochs=4,
                reduce_lr=ReduceLROnPlateau(factor=0.5, patience=1,
                                            min_lr=1e-4, min_delta=0.0))
    assert final.learning_rate == pytest.approx(1.25e-4)
    assert np.isfinite(final.learning_rate)
