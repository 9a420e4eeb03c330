"""Darknet `.weights` binary ingestion and export, in numpy.

The port's own copy of `object_tracking_tpu/ops/weights.py` (framework-free,
but the port imports nothing of the JAX package). Loaders return the flax
layout, {'params': ..., 'batch_stats': ...} with HWIO kernels, so that
`convert.from_flax` turns them into a torch state_dict; exporters take the
same layout (`convert.to_flax` of a state_dict).

- the file is a flat float32 stream behind a version-sized header
  (4 or 5 4-byte slots — see DarknetWeightReader);
- per conv block, BatchNorm params are stored in file order
  (beta, gamma, mean, var);
- conv kernels are stored OIHW;
- only the final head conv (conv_23) carries a bias, which precedes its
  kernel in the stream.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

# Darknet-19 YOLOv2 conv plan: (name, filters, kernel_size)
DARKNET19_CONV_PLAN = [
    ('conv_1', 32, 3), ('conv_2', 64, 3), ('conv_3', 128, 3),
    ('conv_4', 64, 1), ('conv_5', 128, 3), ('conv_6', 256, 3),
    ('conv_7', 128, 1), ('conv_8', 256, 3), ('conv_9', 512, 3),
    ('conv_10', 256, 1), ('conv_11', 512, 3), ('conv_12', 256, 1),
    ('conv_13', 512, 3), ('conv_14', 1024, 3), ('conv_15', 512, 1),
    ('conv_16', 1024, 3), ('conv_17', 512, 1), ('conv_18', 1024, 3),
    ('conv_19', 1024, 3), ('conv_20', 1024, 3), ('conv_21', 64, 1),
    ('conv_22', 1024, 3),
]
# Input channels per conv (conv_21 taps the conv_13 skip at 512ch; conv_22
# consumes concat(space_to_depth(64ch)·4, 1024ch) = 1280ch).
DARKNET19_IN_CHANNELS = [
    3, 32, 64, 128, 64, 128, 256, 128, 256, 512, 256, 512, 256,
    512, 1024, 512, 1024, 512, 1024, 1024, 512, 1280,
]


class DarknetWeightReader:
    """Sequential float32 reader over a darknet `.weights` stream.

    Files written by darknet with version major*10+minor >= 2 (stock
    `yolov2.weights` among them) store `seen` as a uint64, a 5-slot
    header; older ones as an int32, a 4-slot header. The skip is sized
    from the (major, minor) ints.
    """

    def __init__(self, path: str):
        self.all_weights = np.fromfile(path, dtype=np.float32)
        header = self.all_weights[:3].view(np.int32)
        major, minor = int(header[0]), int(header[1])
        self._header_floats = 5 if major * 10 + minor >= 2 else 4
        self.offset = self._header_floats

    def read(self, size: int) -> np.ndarray:
        self.offset += size
        return self.all_weights[self.offset - size:self.offset]

    def reset(self) -> None:
        self.offset = self._header_floats

    @property
    def remaining(self) -> int:
        return self.all_weights.size - self.offset


def _conv_kernel(reader: DarknetWeightReader, k: int, cin: int,
                 cout: int) -> np.ndarray:
    """Read an OIHW kernel block and return HWIO."""
    w = reader.read(cout * cin * k * k).reshape(cout, cin, k, k)
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def load_yolov2_weights(path: str, num_classes: int,
                        num_anchors: int = 5) -> Dict[str, Any]:
    """Parse a darknet yolov2.weights file into the flax layout.

    Returns {'params': {...}, 'batch_stats': {...}} named as the
    Darknet19 module's layers. The head conv_23 is only read when the
    file's class count matches `num_classes`; otherwise it is left absent
    and the caller keeps its random init.
    """
    reader = DarknetWeightReader(path)
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}

    for (name, cout, k), cin in zip(DARKNET19_CONV_PLAN,
                                    DARKNET19_IN_CHANNELS):
        norm = name.replace('conv', 'norm')
        beta = reader.read(cout)
        gamma = reader.read(cout)
        mean = reader.read(cout)
        var = reader.read(cout)
        batch_stats[norm] = {'mean': mean, 'var': var}
        params[norm] = {'scale': gamma, 'bias': beta}
        params[name] = {'kernel': _conv_kernel(reader, k, cin, cout)}

    head_out = num_anchors * (5 + num_classes)
    head_size = head_out + head_out * 1024  # bias + 1x1 kernel
    if reader.remaining >= head_size:
        bias = reader.read(head_out)
        kernel = _conv_kernel(reader, 1, 1024, head_out)
        params['conv_23'] = {'kernel': kernel, 'bias': bias}

    return {'params': params, 'batch_stats': batch_stats}


def write_darknet_header(f, seen: int = 0) -> None:
    """Write a modern darknet header: int32 (major=0, minor=2,
    revision=0) + uint64 `seen` — the 5-slot layout of stock
    yolov2.weights."""
    np.asarray([0, 2, 0], np.int32).tofile(f)
    np.asarray([seen], np.uint64).tofile(f)


def export_yolov2_weights(variables, path: str, seen: int = 0) -> None:
    """Serialize Darknet-19 variables (flax layout) to a darknet
    `.weights` binary — the exact inverse of `load_yolov2_weights`."""
    params = variables['params']
    stats = variables['batch_stats']
    with open(path, 'wb') as f:
        write_darknet_header(f, seen)
        for name, _cout, _k in DARKNET19_CONV_PLAN:
            norm = name.replace('conv', 'norm')
            for arr in (params[norm]['bias'], params[norm]['scale'],
                        stats[norm]['mean'], stats[norm]['var']):
                np.asarray(arr, np.float32).tofile(f)
            kern = np.asarray(params[name]['kernel'], np.float32)
            kern.transpose(3, 2, 0, 1).tofile(f)          # HWIO → OIHW
        if 'conv_23' in params:
            np.asarray(params['conv_23']['bias'], np.float32).tofile(f)
            np.asarray(params['conv_23']['kernel'],
                       np.float32).transpose(3, 2, 0, 1).tofile(f)
