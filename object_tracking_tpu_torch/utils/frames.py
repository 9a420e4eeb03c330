"""The frames' way in, shared by the joint predictors (`inference.py`,
`serving.py`) and the detector wrappers of `models/`: the device rule,
the copy to the device and an image file read at a net's input size.
It sits below `models/`, which imports nothing of the serving layer.
`cv2` is imported only to read a file (the card's machine has none).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing a CUDA device this process lacks:
    the port never falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but CUDA is not '
                           'available; pass device="cpu" to run on the CPU')
    return device


def to_device(images, device: torch.device) -> torch.Tensor:
    """Frames (an array or a tensor, values in [0, 1]) as a float32
    tensor on `device`: from numpy, one pageable copy."""
    return torch.as_tensor(images, dtype=torch.float32, device=device)


def read_frame(path: str, size: Tuple[int, int]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """An image file → (its pixels (H, W, 3) uint8 RGB, the frame
    (h, w, 3) float32 in [0, 1] resized to `size` = (h, w))."""
    import cv2
    image = cv2.imread(path)
    if image is None:
        raise FileNotFoundError(path)
    image = image[:, :, ::-1]
    h, w = size
    return image, np.asarray(cv2.resize(image, (w, h)), np.float32) / 255.0
