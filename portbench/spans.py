"""Spans of a traced run, installed from the benchmark's side.

The program records no span of its own, so a traced run installs them
around the calls into each layer, for each traced part (the calls timed
without the profiler, then those under it; `trace.Traced`), and takes
them away afterwards:

- forward pre/post hooks on the whole model (`model`), on its ConvLSTM
  head (`convlstm`) and on every BatchNorm module (`batch_norm`);
- wrappers around `inference.decode_and_nms` and `inference.assign_tracks`
  (`decode_and_nms`, `assign_tracks`), looked up in the serving module's
  namespace at call time;
- a wrapper around the NMS kernel's entry in `ops.nms` that keeps each
  call's output and shape for the kernel's bound (`nms_scores`).
"""

from __future__ import annotations

import contextlib

from portbench.trace import Tracer


def _hook_spans(tracer: Tracer, module, name: str) -> list:
    stack = []

    def enter(mod, args):
        stack.append(tracer.span(name))
        stack[-1].__enter__()

    def leave(mod, args, out):
        stack.pop().__exit__(None, None, None)
    return [module.register_forward_pre_hook(enter),
            module.register_forward_hook(leave)]


def _wrapped(tracer: Tracer, fn, name: str, keep=None):
    def call(*args, **kwargs):
        with tracer.span(name):
            out = fn(*args, **kwargs)
        if keep is not None and tracer.active:
            keep(args, out)
        return out
    return call


@contextlib.contextmanager
def installed(tracer: Tracer, model, serving: bool):
    """The spans of `model` (and, for `serving`, of the serving module's
    post-processing) for the duration of the block."""
    from object_tracking_tpu_torch import inference
    from object_tracking_tpu_torch.models.darknet19 import BatchNorm
    from object_tracking_tpu_torch.ops import nms as nms_module
    hooks = _hook_spans(tracer, model, 'model')
    lstm = getattr(model, 'tconv_lstm', None)
    if lstm is not None:
        hooks += _hook_spans(tracer, lstm, 'convlstm')
    for m in model.modules():
        if isinstance(m, BatchNorm):
            hooks += _hook_spans(tracer, m, 'batch_norm')
    saved = []
    if serving:
        def keep_nms(args, out):
            tracer.notes['nms'].append((out, args[1].shape))
        for owner, attr, keep in (
                (inference, 'decode_and_nms', None),
                (inference, 'assign_tracks', None),
                (nms_module, 'nms_scores', keep_nms)):
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, _wrapped(tracer, fn, attr, keep))
    try:
        yield
    finally:
        for hook in hooks:
            hook.remove()
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
