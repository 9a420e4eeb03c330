"""Training cells: the program's training step on a pool of distinct
batches, cycled, for `--seconds`.

The configuration's model kind (`models/<builder>.py`) names the step
and the form of its batches: the joint model's fused step on raw uint8
windows, the detector's step on images with targets the benchmark
encodes.

Set-up builds one train state from the benchmark's weights and drives it
through the step on the pool's first three batches: those steps are the
warm-up, and their readings are what `correct` judges. The same state then
runs the window. Once the window has closed the reference takes the same
three steps from the same weights and batches, and three numbers are
compared: the first step's loss (`loss`: |diff| over |reference|; the
later steps' are reported, see `compare`),
each leaf's first gradient as Adam holds it after step one (its first
moment over 1 - b1) and each leaf's change after the three steps (`grad`,
`change`: the worst leaf's |norm - reference norm| over the larger of the
reference's norm of that leaf and of the median leaf). Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of both: they move by rounding alone.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import flops, models, spans, traffic, weights
from portbench.drivers.common import (
    Context, Outcome, Phases, memory_peak, now, precision, program_model,
    release, sync)
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.trace import Traced

FIRST_STEPS = 3
QUIET_LEAF = 1e-3


class ProgramTrainer:
    """The program's train state and step."""

    def __init__(self, cfg: dict, mix: dict, w, device):
        from object_tracking_tpu_torch.config import LossConfig
        from object_tracking_tpu_torch.training import (
            TrainState, make_optimizer)
        loss = cfg['loss']
        loss_cfg = LossConfig(
            no_object_scale=loss['no_object_scale'],
            object_scale=loss['object_scale'],
            coord_scale=loss['coord_scale'], class_scale=loss['class_scale'],
            true_box_buffer=cfg['true_box_buffer'],
            best_iou_threshold=loss['best_iou_threshold'])
        self.model = program_model(cfg, w, device)
        self.state = TrainState.create(self.model,
                                       make_optimizer(mix['learning_rate']))
        self.fn = models.kind(cfg).program_step(cfg, mix, loss_cfg)

    def step(self, batch) -> torch.Tensor:
        self.state, metrics = self.fn(self.state, batch)
        return metrics['loss']

    def first_gradients(self) -> Dict[str, float]:
        """Each leaf's gradient norm of the first step, from Adam's first
        moment after it (b1·0 + (1 - b1)·g); 0 for a leaf it holds no
        moment of."""
        opt = self.state.optimizer
        b1 = opt.param_groups[0]['betas'][0]
        return {n: float(opt.state[p]['exp_avg'].norm()) / (1.0 - b1)
                if 'exp_avg' in opt.state.get(p, {}) else 0.0
                for n, p in self.model.named_parameters()}

    def parameters(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def run(ctx: Context) -> Outcome:
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    phase = Phases(ctx.t0)
    phase('imports')
    pool = train_pool(cfg, mix, ctx.seed)
    phase('batches')
    frames = mix['batch'] * mix['window']
    with precision(cfg):
        w = weights.make(cfg, ctx.seed, dev)
        trainer = (ctx.program or ProgramTrainer)(cfg, mix, w, dev)
        del w
        phase('program')
        losses, grads = [], None
        for i in range(FIRST_STEPS):
            losses.append(trainer.step(pool[i]))
            if i == 0:
                grads = trainer.first_gradients()
        start = weights.make(cfg, ctx.seed, dev)
        changes = {n: float((p.detach() - start[n]).norm())
                   for n, p in trainer.parameters().items()}
        del start
        losses = [float(x) for x in losses]
        sync(dev)
        phase('first_steps')
        setup_s = now() - ctx.t0
        steps, elapsed, traced = _train_loop(ctx, trainer, pool)
    peak = memory_peak(dev)
    reading = None
    if ctx.trace:
        reading = traced.reading(frames * flops.train_per_frame(
            cfg, mix['window']))
    del trainer, traced
    release(dev)
    program = {'losses': losses, 'grad_norms': grads,
               'change_norms': changes}
    ref = reference(cfg, mix, pool, ctx.seed, dev)
    numbers = compare(program, ref)
    e2e = {'setup_s': setup_s, 'train_frames_per_s': steps * frames / elapsed}
    lines = [{'setup_phases_s': phase.took},
             {'losses': losses, 'reference_losses': ref['losses'],
              'later_loss_gaps': later_losses(program, ref)}]
    return Outcome(e2e, steps, 0, numbers, peak, reading, lines)


def _train_loop(ctx: Context, trainer, pool: list):
    traced = Traced(ctx.trace, ctx.traffic['trace_steps'],
                    lambda tracer: spans.installed(tracer, trainer.model,
                                                   serving=False))
    steps = 0
    start = now()
    while True:
        t = now() - start
        if t >= ctx.seconds and steps >= ctx.min_units and traced.done():
            break
        if ctx.trace and traced.at is None and t >= ctx.seconds / 2:
            traced.at = steps
        traced.begin(steps)
        with traced.span('step'):
            trainer.step(pool[(FIRST_STEPS + steps) % len(pool)])
        steps += 1
        traced.end()
    sync(ctx.device)
    elapsed = now() - start
    traced.close()
    return steps, elapsed, traced


def train_pool(cfg: dict, mix: dict, seed: int) -> list:
    """The run's distinct batches, in the form the program's step takes."""
    return models.kind(cfg).train_batches(
        traffic.train_pool(mix, cfg, seed), cfg)


def reference(cfg: dict, mix: dict, pool: list, seed: int, device,
              lower: bool = False) -> dict:
    """The reference's first steps on the pool's first batches, in the
    configuration's precision (or the next below it, `lower`)."""
    kind = models.kind(cfg)
    with precision(cfg, lower):
        w = weights.make(cfg, seed, device)
        batches = [kind.reference_batch(b, cfg, device)
                   for b in pool[:FIRST_STEPS]]
        return ref_train.three_steps(
            w, ref_model.parameter_names(kind.weight_spec(cfg)),
            lambda w, batch: kind.reference_loss(w, cfg, batch), batches,
            mix['learning_rate'])


def _worst_leaf(got: Dict[str, float], want: Dict[str, float],
                counted) -> float:
    median = float(np.median(list(want.values())))
    return max(abs(got[n] - want[n]) / max(want[n], median, 1e-30)
               for n in counted)


def compare(program: dict, ref: dict) -> Dict[str, float]:
    """The three numbers of a training cell, the program's readings
    against the reference's. The loss compared is the first step's: the
    later steps' swing with rounding (Adam's first updates are near
    lr·sign(g), so a weight whose gradient is zero to rounding moves by
    ±lr either way) and are reported beside it, not compared."""
    p_loss, r_loss = program['losses'][0], ref['losses'][0]
    loss = abs(p_loss - r_loss) / max(abs(r_loss), 1e-30)
    if not np.all(np.isfinite(program['losses'])):
        loss = float('inf')
    g_ref = ref['grad_norms']
    median = float(np.median(list(g_ref.values())))
    counted = [n for n in g_ref if g_ref[n] >= QUIET_LEAF * median]
    return {'loss': loss,
            'grad': _worst_leaf(program['grad_norms'], g_ref, counted),
            'change': _worst_leaf(program['change_norms'],
                                  ref['change_norms'], counted)}


def later_losses(program: dict, ref: dict) -> list:
    """|diff| over |reference| of the losses after the first step."""
    return [abs(p - r) / max(abs(r), 1e-30)
            for p, r in zip(program['losses'][1:], ref['losses'][1:])]
