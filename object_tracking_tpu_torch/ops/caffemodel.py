"""Caffe `.caffemodel` binary ingestion, in numpy.

The port's own copy of `object_tracking_tpu/ops/caffemodel.py`
(framework-free, but the port imports nothing of the JAX package): a
minimal protobuf wire-format walker that extracts every layer's learned
blobs, a writer for the same format, and the VGG16 mapping onto the flax
names of `models/vgg16.py` ('conv1_1/kernel' HWIO, 'fc6/bias', ...), which
`VGG16PriorSource.load_params` takes. `load_caffemodel_into` loads a file
into a prior source.

Format facts (caffe.proto, public):
- NetParameter: `name` = field 1 (string), new-style `layer`
  (LayerParameter) = field 100, old-style `layers` (V1LayerParameter)
  = field 2; both are supported and the container field number
  disambiguates them.
- LayerParameter: name = 1, type = 2 (string), blobs = 7.
- V1LayerParameter: name = 4, type = 5 (enum varint), blobs = 6.
- BlobProto: legacy dims num/channels/height/width = fields 1-4
  (varint), data = field 5 (packed float32), shape = field 7
  (BlobShape, whose `dim` = field 1, packed varint), double_data = 8.

Layout conventions:
- Caffe conv kernels are OIHW → transposed to HWIO;
- Caffe InnerProduct weights are (out, in); fc6 consumes the flattened
  (C, 7, 7) pool5 in C-major order, so its matrix reshapes to
  (out, C, 7, 7) and transposes to the (7, 7, C, out) kernel of the
  conv-formulated fc6; fc7 becomes a 1x1 conv kernel (1, 1, in, out).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

# ------------------------------------------------------------------ wire --

_WIRE_VARINT, _WIRE_64BIT, _WIRE_LEN, _WIRE_32BIT = 0, 1, 2, 5


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError('caffemodel: truncated varint')
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError('caffemodel: varint overflow')


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Walk one message's fields → (field_no, wire_type, value).
    Length-delimited values come back as memoryview slices."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _WIRE_64BIT:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                raise ValueError('caffemodel: truncated field')
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == _WIRE_32BIT:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f'caffemodel: unsupported wire type {wire}')
        yield field, wire, val


def _parse_blob(buf: memoryview) -> np.ndarray:
    """BlobProto → float32 ndarray with its declared shape."""
    data: List[np.ndarray] = []
    legacy = {}
    shape: List[int] = []
    for field, wire, val in _fields(buf):
        if field == 5:                                  # data
            if wire == _WIRE_LEN:                       # packed
                data.append(np.frombuffer(val, np.float32))
            else:                                       # unpacked f32
                data.append(np.frombuffer(val, np.float32))
        elif field == 8 and wire == _WIRE_LEN:          # double_data
            data.append(np.frombuffer(val, np.float64).astype(np.float32))
        elif field == 7 and wire == _WIRE_LEN:          # BlobShape
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    if w2 == _WIRE_LEN:                 # packed dims
                        pos = 0
                        while pos < len(v2):
                            d, pos = _read_varint(v2, pos)
                            shape.append(d)
                    else:
                        shape.append(int(v2))
        elif field in (1, 2, 3, 4) and wire == _WIRE_VARINT:
            legacy[field] = int(val)
    arr = (np.concatenate(data) if data
           else np.zeros((0,), np.float32))
    if not shape and legacy:
        # legacy num/channels/height/width, defaulting absent dims to 1
        shape = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
        # strip leading 1s the way caffe's Reshape does for vectors
        while len(shape) > 1 and shape[0] == 1:
            shape = shape[1:]
    if shape and int(np.prod(shape)) == arr.size:
        arr = arr.reshape(shape)
    return arr


def read_caffemodel(path: str) -> Dict[str, List[np.ndarray]]:
    """Parse a .caffemodel → {layer_name: [blob, ...]} (learned layers
    only — layers without blobs are skipped). Handles both new-style
    `layer` (field 100) and V1 `layers` (field 2) encodings."""
    with open(path, 'rb') as f:
        buf = memoryview(f.read())
    out: Dict[str, List[np.ndarray]] = {}
    for field, wire, val in _fields(buf):
        if wire != _WIRE_LEN or field not in (2, 100):
            continue
        name_field, blob_field = (4, 6) if field == 2 else (1, 7)
        name = None
        blobs: List[np.ndarray] = []
        for f2, w2, v2 in _fields(val):
            if f2 == name_field and w2 == _WIRE_LEN:
                name = bytes(v2).decode('utf-8', 'replace')
            elif f2 == blob_field and w2 == _WIRE_LEN:
                blobs.append(_parse_blob(v2))
        if name and blobs:
            out[name] = blobs
    if not out:
        raise ValueError(f'{path}: no learned layers found '
                         '(not a caffemodel?)')
    return out


# ----------------------------------------------------------------- writer --

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, _WIRE_LEN) + _varint(len(payload)) + payload


def _blob_bytes(arr: np.ndarray, legacy_dims: bool) -> bytes:
    arr = np.ascontiguousarray(arr, np.float32)
    out = bytearray()
    if legacy_dims:
        dims = list(arr.shape)
        dims = [1] * (4 - len(dims)) + dims       # left-pad to NCHW
        for field, d in zip((1, 2, 3, 4), dims):
            out += _tag(field, _WIRE_VARINT) + _varint(d)
    else:
        packed = b''.join(_varint(d) for d in arr.shape)
        out += _len_field(7, _len_field(1, packed))
    out += _len_field(5, arr.tobytes())
    return bytes(out)


def write_caffemodel(path: str,
                     layers: Sequence[Tuple[str, Sequence[np.ndarray]]],
                     v1: bool = True) -> None:
    """Write a minimal NetParameter with the given learned layers —
    the synthesis half of the format rehearsal (the mirror of
    ops/weights.py::export_yolov2_weights). `v1=True` emits the
    old-style `layers` field-2 encoding with legacy blob dims (what
    2015-era Faster-RCNN caffemodels use); False emits new-style
    `layer` field-100 with BlobShape."""
    container_field = 2 if v1 else 100
    name_field = 4 if v1 else 1
    blob_field = 6 if v1 else 7
    with open(path, 'wb') as f:
        f.write(_len_field(1, b'synthesized'))    # NetParameter.name
        for name, blobs in layers:
            msg = bytearray()
            msg += _len_field(name_field, name.encode())
            for b in blobs:
                msg += _len_field(blob_field, _blob_bytes(b, v1))
            f.write(_len_field(container_field, bytes(msg)))


# ---------------------------------------------------------- VGG16 mapping --

# Caffe layer name → stock output width; the 13-conv VGG16 backbone +
# fc6/fc7 of models/vgg16.py::VGG16 (the conv features and fc7 that a
# Faster-RCNN VGG16 caffemodel carries).
VGG16_CAFFE_LAYERS: Tuple[Tuple[str, int], ...] = (
    ('conv1_1', 64), ('conv1_2', 64),
    ('conv2_1', 128), ('conv2_2', 128),
    ('conv3_1', 256), ('conv3_2', 256), ('conv3_3', 256),
    ('conv4_1', 512), ('conv4_2', 512), ('conv4_3', 512),
    ('conv5_1', 512), ('conv5_2', 512), ('conv5_3', 512),
    ('fc6', 4096), ('fc7', 4096),
)


def caffemodel_to_vgg16_params(
        blobs: Dict[str, List[np.ndarray]],
        fc_features: int = 4096) -> Dict[str, np.ndarray]:
    """Map parsed caffemodel blobs onto models/vgg16.py::VGG16 param
    names ('conv1_1/kernel' HWIO, 'fc6/bias', ...) — the same npz-style
    dict VGG16PriorSource.load_params takes.

    Shapes are taken from the blobs themselves (so width-divided fixture
    variants map too): conv kernels OIHW → HWIO; fc6's InnerProduct
    matrix (out, C*7*7) over the C-major flattened pool5 → reshaped
    (out, C, 7, 7) → HWIO (7, 7, C, out), the conv-formulated fc6;
    fc7's (out, in) → a (1, 1, in, out) kernel.
    `fc_features` cross-checks the fc blobs' output width.
    """
    out: Dict[str, np.ndarray] = {}
    prev_width = 3
    for name, _stock_width in VGG16_CAFFE_LAYERS:
        if name not in blobs:
            raise KeyError(f'caffemodel missing layer {name!r}')
        w, b = blobs[name][0], blobs[name][1]
        if name.startswith('conv'):
            if w.ndim != 4:
                w = w.reshape(-1, prev_width, 3, 3)
            out[f'{name}/kernel'] = np.transpose(w, (2, 3, 1, 0))
            prev_width = w.shape[0]
        elif name == 'fc6':
            w = w.reshape(-1, prev_width, 7, 7)
            if w.shape[0] != fc_features:
                raise ValueError(
                    f'fc6 width {w.shape[0]} != fc_features '
                    f'{fc_features}')
            out['fc6/kernel'] = np.transpose(w, (2, 3, 1, 0))
            prev_width = w.shape[0]
        else:                                     # fc7
            w = w.reshape(-1, prev_width)
            out['fc7/kernel'] = np.transpose(w, (1, 0))[None, None]
        out[f'{name}/bias'] = b.reshape(-1)
    return out


def load_caffemodel_into(prior_source, path: str) -> None:
    """Ingest a .caffemodel directly into a VGG16PriorSource: every layer
    of the file must exist in the model with the same shape."""
    prior_source.load_params(caffemodel_to_vgg16_params(
        read_caffemodel(path), fc_features=prior_source.module.fc_features))
