"""The benchmark's one traffic generator, driven by a mix's parameters.

A mix (`portbench/traffic/<name>.json`) says how many streams or windows,
of how many frames, how many objects a scene holds and how the load
arrives; the configuration says the image size and the class set. From
`--seed` this module makes the frames and their labels on the host: dark
noise with `objects` filled rectangles per stream, each of its class's
colour, drifting at a constant velocity and bouncing off the borders, so
that tracks persist across the windows of a stream. Every seed gives the
same sizes, the same number of objects and the same arrivals; only the
pixels, the boxes and the classes move.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def rng(seed: int, purpose: int) -> np.random.Generator:
    """A numpy generator for one purpose of one run's seed (any integer)."""
    return np.random.default_rng([seed % 2**64, purpose])


def torch_seed(seed: int, purpose: int) -> int:
    """A torch.Generator seed for one purpose of one run's seed."""
    return int(rng(seed, purpose).integers(0, 2**62))


def _bounce(start: np.ndarray, speed: np.ndarray, frames: np.ndarray,
            span: np.ndarray) -> np.ndarray:
    """Positions start + speed·f reflected into [0, span]."""
    pos = start[..., None] + speed[..., None] * frames
    period = 2 * np.maximum(span, 1)[..., None]
    pos = np.mod(pos, period)
    return np.where(pos > period / 2, period - pos, pos).astype(np.int64)


def scenes(gen: np.random.Generator, streams: int, frames: int, size: int,
           objects: int, classes: int, slots: int) -> Dict[str, np.ndarray]:
    """`streams` videos of `frames` frames: images (S, F, H, W, 3) uint8,
    boxes (S, F, slots, 4) pixel corners, cls (S, F, slots) and valid
    (S, F, slots), the first `objects` slots in use."""
    colours = np.random.default_rng(123).integers(80, 256, (classes, 3))
    images = gen.integers(0, 60, (streams, frames, size, size, 3),
                          dtype=np.uint8)
    boxes = np.zeros((streams, frames, slots, 4), np.float32)
    cls = np.zeros((streams, frames, slots), np.int32)
    valid = np.zeros((streams, frames, slots), bool)
    lo, hi = size // 16, size // 3
    wh = gen.integers(lo, hi, (streams, objects, 2))
    start = gen.integers(0, size - hi, (streams, objects, 2))
    speed = gen.integers(-6, 7, (streams, objects, 2))
    kinds = gen.integers(0, classes, (streams, objects))
    pos = _bounce(start, speed, np.arange(frames), size - wh)  # (S, O, 2, F)
    for s in range(streams):
        for o in range(objects):
            w, h = wh[s, o]
            for f in range(frames):
                x, y = pos[s, o, :, f]
                images[s, f, y:y + h, x:x + w] = colours[kinds[s, o]]
                boxes[s, f, o] = (x, y, x + w, y + h)
    cls[:, :, :objects] = kinds[:, None, :]
    valid[:, :, :objects] = True
    return {'images_u8': images, 'boxes': boxes, 'cls': cls,
            'valid': valid}


def serve_pool(mix: dict, cfg: dict, seed: int) -> np.ndarray:
    """The pool of windows a serving run cycles through: (P, B, T, H, W, 3)
    float32 in [0, 1]; window p of stream b continues window p - 1."""
    b, t, p = mix['streams'], mix['window'], mix['pool']
    made = scenes(rng(seed, 1), b, p * t, cfg['image'], mix['objects'],
                  cfg['num_classes'], cfg['true_box_buffer'])
    frames = made['images_u8'].reshape((b, p, t) + made['images_u8'].shape[2:])
    return np.ascontiguousarray(frames.transpose(1, 0, 2, 3, 4, 5),
                                dtype=np.float32) / np.float32(255.0)


def train_pool(mix: dict, cfg: dict, seed: int) -> list:
    """The distinct raw batches a training run cycles through, in
    SequenceBatches' raw form: {'images_u8' (B, T, H, W, 3), 'boxes',
    'cls', 'valid', 'aug_seeds' (B,)}. The model's kind turns them into
    the batches its step takes (`models/<builder>.py::train_batches`)."""
    b, t, p = mix['batch'], mix['window'], mix['pool']
    gen = rng(seed, 2)
    made = scenes(gen, p * b, t, cfg['image'], mix['objects'],
                  cfg['num_classes'], cfg['true_box_buffer'])
    seeds = gen.integers(0, 2**31 - 1, (p, b)).astype(np.uint32)
    return [{**{k: v[i * b:(i + 1) * b] for k, v in made.items()},
             'aug_seeds': seeds[i]} for i in range(p)]


def sample_calls(seed: int, count: int, span: int) -> list:
    """The calls whose outputs are checked: the first, and `count` more
    drawn from [1, span) by the seed."""
    picked = rng(seed, 3).choice(np.arange(1, span), size=count,
                                 replace=False)
    return [0] + sorted(int(i) for i in picked)
