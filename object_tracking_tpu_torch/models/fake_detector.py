"""Deterministic fake prior source for hermetic runs.

Port of `object_tracking_tpu/models/fake_detector.py`: the prior-source
protocol (`get_layer_dims(layer)`, `forward_batch(images, layer)`) with
analytic outputs. The features are the mean pixel of each image, the
detections one fixed box per image (label `label_id`, score 0.9). It
takes numpy arrays or tensors and returns numpy arrays; a tensor's mean
is taken where the tensor lies and pulled to the host once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class FakeDetector:
    def __init__(self, feat_shape: Tuple[int, int, int] = (4, 4, 8),
                 num_labels: int = 4, label_id: int = 0,
                 box=(0.5, 0.5, 0.4, 0.4), top_k: int = 16):
        self.feat_shape = feat_shape
        self.num_labels = num_labels
        self.label_id = label_id
        self.box = np.asarray(box, np.float32)
        self.top_k = top_k

    def get_layer_dims(self, layer: str = 'conv_feat'):
        return self.feat_shape

    def forward_batch(self, images, layer: str = 'conv_feat',
                      top_k: int = None):
        n = images.shape[0]
        k = top_k or self.top_k
        if isinstance(images, torch.Tensor):
            mean = images.reshape(n, -1).mean(dim=1).cpu().numpy()
        else:
            mean = images.reshape(n, -1).mean(axis=1)
        feats = np.ones((n,) + self.feat_shape, np.float32) \
            * mean[:, None, None, None]
        boxes = np.zeros((n, k, 4), np.float32)
        boxes[:, 0] = self.box
        labels = np.full((n, k), self.label_id, np.int32)
        scores = np.zeros((n, k), np.float32)
        scores[:, 0] = 0.9
        valid = np.zeros((n, k), bool)
        valid[:, 0] = True
        return feats, boxes, labels, scores, valid
