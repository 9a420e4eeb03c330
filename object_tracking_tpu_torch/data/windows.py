"""Sequence windowing: overlapping stride-1, same-video windows.

A copy of `object_tracking_tpu/data/windows.py`: every length-T window of
consecutive frames that does not straddle a video (folder) boundary.
"""

from __future__ import annotations

from typing import List, Sequence

from object_tracking_tpu_torch.data.voc import Annotation


def make_sequence_windows(annotations: Sequence[Annotation],
                          sequence_length: int,
                          stride: int = 1) -> List[List[Annotation]]:
    """Windows of `sequence_length` consecutive same-folder annotations.

    `annotations` must be sorted (parse_annotation_dir sorts by path,
    which sorts frames within a video — the reference relies on the same
    sorted() walk).
    """
    if sequence_length <= 0:
        raise ValueError('sequence_length must be positive')
    windows: List[List[Annotation]] = []
    n = len(annotations)
    for start in range(0, n - sequence_length + 1, stride):
        window = annotations[start:start + sequence_length]
        folder = window[0].folder
        if all(a.folder == folder for a in window):
            windows.append(list(window))
    return windows
