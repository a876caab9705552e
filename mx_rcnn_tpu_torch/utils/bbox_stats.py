"""Host numpy box decode and clip (port of ``np_bbox_pred`` and
``np_clip_boxes`` in ``mx_rcnn_tpu/utils/bbox_stats.py``).

``core/tester.py::im_detect`` decodes one image's head outputs on the host,
as the reference's ``nonlinear_pred`` does: a device call there would cost
a launch and a fetch per image in the eval loop.  Same float32 arithmetic,
in the same order, as the JAX package's twins.
"""

from __future__ import annotations

import numpy as np

_BBOX_XFORM_CLIP = 4.135166556742356  # log(1000 / 16), as ops.boxes


def np_bbox_pred(boxes: np.ndarray, box_deltas: np.ndarray) -> np.ndarray:
    """(N, 4) boxes × (N, 4K) deltas → (N, 4K) decoded boxes."""
    n = boxes.shape[0]
    widths = boxes[:, 2] - boxes[:, 0] + 1.0
    heights = boxes[:, 3] - boxes[:, 1] + 1.0
    ctr_x = boxes[:, 0] + 0.5 * (widths - 1.0)
    ctr_y = boxes[:, 1] + 0.5 * (heights - 1.0)

    deltas = box_deltas.reshape(n, -1, 4).astype(np.float32)
    dx, dy = deltas[..., 0], deltas[..., 1]
    dw = np.minimum(deltas[..., 2], _BBOX_XFORM_CLIP)
    dh = np.minimum(deltas[..., 3], _BBOX_XFORM_CLIP)

    pred_cx = dx * widths[:, None] + ctr_x[:, None]
    pred_cy = dy * heights[:, None] + ctr_y[:, None]
    pred_w = np.exp(dw) * widths[:, None]
    pred_h = np.exp(dh) * heights[:, None]

    out = np.stack(
        [
            pred_cx - 0.5 * (pred_w - 1.0),
            pred_cy - 0.5 * (pred_h - 1.0),
            pred_cx + 0.5 * (pred_w - 1.0),
            pred_cy + 0.5 * (pred_h - 1.0),
        ],
        axis=-1,
    )
    return out.reshape(n, -1).astype(np.float32)


def np_clip_boxes(boxes: np.ndarray, im_shape) -> np.ndarray:
    """(N, 4K) boxes clipped into an ``im_shape`` = (h, w) image."""
    h, w = float(im_shape[0]), float(im_shape[1])
    n = boxes.shape[0]
    b = boxes.reshape(n, -1, 4)
    out = np.stack(
        [
            np.clip(b[..., 0], 0.0, w - 1.0),
            np.clip(b[..., 1], 0.0, h - 1.0),
            np.clip(b[..., 2], 0.0, w - 1.0),
            np.clip(b[..., 3], 0.0, h - 1.0),
        ],
        axis=-1,
    )
    return out.reshape(n, -1).astype(np.float32)
