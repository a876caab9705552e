"""Small roidb box utilities (port of ``mx_rcnn_tpu/data/ds_utils.py``;
reference ``rcnn/dataset/ds_utils.py``): ``unique_boxes`` and
``filter_small_boxes``, for proposal post-processing."""

from __future__ import annotations

import numpy as np


def unique_boxes(boxes: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Indices of the unique boxes of ``round(boxes · scale)``, the first
    occurrence of each, in their original order."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    v = np.round(np.asarray(boxes, np.float64) * scale).astype(np.int64)
    _, index = np.unique(v, axis=0, return_index=True)
    return np.sort(index)


def filter_small_boxes(boxes: np.ndarray, min_size: float) -> np.ndarray:
    """Indices of the boxes with both sides ≥ ``min_size`` (+1 widths)."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    w = boxes[:, 2] - boxes[:, 0] + 1
    h = boxes[:, 3] - boxes[:, 1] + 1
    return np.where((w >= min_size) & (h >= min_size))[0]
