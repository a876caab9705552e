"""Host numpy box geometry and roidb-wide regression target statistics
(port of ``mx_rcnn_tpu/utils/bbox_stats.py``).

``core/tester.py::im_detect`` decodes one image's head outputs on the host,
as the reference's ``nonlinear_pred`` does: a device call there would cost
a launch and a fetch per image in the eval loop.  ``np_overlaps`` (the IoU
matrix of proposal recall and of the statistics) and ``np_transform`` are
the host twins of ``ops/boxes.py``'s.  ``compute_bbox_stats`` walks a
proposal roidb once for the mean and std of the fg proposal → gt deltas
(the reference's ``add_bbox_regression_targets`` with
``BBOX_NORMALIZATION_PRECOMPUTED``), which Fast R-CNN training puts into
the config.  Same float32 arithmetic, in the same order, as the JAX
package's twins.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from mx_rcnn_tpu_torch.config import Config


def np_overlaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) × (K, 4) → (N, K) float32 IoU, +1 width convention; 0 where
    the union is not positive."""
    n, k = len(a), len(b)
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float32)
    bx = np.asarray(a, np.float32)[:, :4]
    qx = np.asarray(b, np.float32)[:, :4]
    ba = (bx[:, 2] - bx[:, 0] + 1) * (bx[:, 3] - bx[:, 1] + 1)
    qa = (qx[:, 2] - qx[:, 0] + 1) * (qx[:, 3] - qx[:, 1] + 1)
    iw = np.minimum(bx[:, None, 2], qx[None, :, 2]) - np.maximum(bx[:, None, 0], qx[None, :, 0]) + 1
    ih = np.minimum(bx[:, None, 3], qx[None, :, 3]) - np.maximum(bx[:, None, 1], qx[None, :, 1]) + 1
    inter = np.where((iw > 0) & (ih > 0), iw * ih, np.float32(0))
    union = ba[:, None] + qa[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0).astype(np.float32)

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


def np_transform(ex: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(N, 4) boxes × (N, 4) targets → (N, 4) deltas (dx, dy, dw, dh), with
    ``ops.boxes.bbox_transform``'s clamps on degenerate boxes."""
    ew = ex[:, 2] - ex[:, 0] + 1.0
    eh = ex[:, 3] - ex[:, 1] + 1.0
    ecx = ex[:, 0] + 0.5 * (ew - 1)
    ecy = ex[:, 1] + 0.5 * (eh - 1)
    gw = gt[:, 2] - gt[:, 0] + 1.0
    gh = gt[:, 3] - gt[:, 1] + 1.0
    gcx = gt[:, 0] + 0.5 * (gw - 1)
    gcy = gt[:, 1] + 0.5 * (gh - 1)
    return np.stack(
        [
            (gcx - ecx) / (ew + 1e-14),
            (gcy - ecy) / (eh + 1e-14),
            np.log(np.maximum(gw, 1.0) / np.maximum(ew, 1e-14)),
            np.log(np.maximum(gh, 1.0) / np.maximum(eh, 1e-14)),
        ],
        axis=1,
    )


# a coordinate whose fg deltas spread less than this fraction of the
# config's default std keeps the default mean and std (compute_bbox_stats)
STD_FLOOR = 0.1


def _floored(means: np.ndarray, stds: np.ndarray, cfg: Config) -> Tuple[np.ndarray, np.ndarray]:
    """(means, stds) with every coordinate whose std is below
    ``STD_FLOOR`` × the config's default std set to the defaults."""
    d_means = np.asarray(cfg.TRAIN.BBOX_MEANS, np.float64)
    d_stds = np.asarray(cfg.TRAIN.BBOX_STDS, np.float64)
    low = stds < STD_FLOOR * d_stds
    return np.where(low, d_means, means), np.where(low, d_stds, stds)


def compute_bbox_stats(roidb: List[Dict], cfg: Config, per_class: bool = False) -> Tuple[Tuple, Tuple]:
    """(means, stds) of the fg proposal → gt deltas over a proposal roidb,
    fg being a proposal whose best gt IoU is ≥ TRAIN.BBOX_REGRESSION_THRESH.

    ``per_class=False``: one (4,) pair over every fg delta.
    ``per_class=True``: (K, 4) tables keyed by the matched gt's class;
    class 0 (never regressed) and classes without a fg delta keep the
    config's class-agnostic defaults.  With no fg delta at all, the
    defaults (tiled to K rows when ``per_class``).

    A coordinate (of a class, or of the unsplit roidb) whose std falls
    below ``STD_FLOOR`` × the default std keeps the default mean and std:
    the targets are divided by the std, so a collapsed spread (a class seen
    once and in its flipped mirror, whose dy, dw and dh are equal; or a few
    proposals that share their vertical offsets) would scale them by up to
    ~1e7.  This is the one place where the port departs from the JAX
    package, which keeps such stds; elsewhere the two agree."""
    thresh = cfg.TRAIN.BBOX_REGRESSION_THRESH
    acc, cls_acc = [], []
    for rec in roidb:
        props = np.asarray(rec.get("proposals", ()), np.float32)
        gts = np.asarray(rec["boxes"], np.float32)
        if len(props) == 0 or len(gts) == 0:
            continue
        ov = np_overlaps(props, gts)
        best = ov.max(axis=1)
        arg = ov.argmax(axis=1)
        fg = best >= thresh
        if fg.any():
            acc.append(np_transform(props[fg], gts[arg[fg]]))
            cls_acc.append(np.asarray(rec["gt_classes"], np.int64)[arg[fg]])
    k = cfg.dataset.NUM_CLASSES
    if not acc:
        if per_class:
            return (tuple(tuple(cfg.TRAIN.BBOX_MEANS) for _ in range(k)),
                    tuple(tuple(cfg.TRAIN.BBOX_STDS) for _ in range(k)))
        return cfg.TRAIN.BBOX_MEANS, cfg.TRAIN.BBOX_STDS
    deltas = np.concatenate(acc, axis=0)
    if not per_class:
        means, stds = _floored(deltas.mean(axis=0), deltas.std(axis=0) + 1e-8, cfg)
        return tuple(float(x) for x in means), tuple(float(x) for x in stds)
    classes = np.concatenate(cls_acc, axis=0)
    means = np.tile(np.asarray(cfg.TRAIN.BBOX_MEANS, np.float64), (k, 1))
    stds = np.tile(np.asarray(cfg.TRAIN.BBOX_STDS, np.float64), (k, 1))
    for c in range(1, k):
        sel = deltas[classes == c]
        if len(sel):
            means[c], stds[c] = _floored(sel.mean(axis=0), sel.std(axis=0) + 1e-8, cfg)
    return (tuple(tuple(float(x) for x in row) for row in means),
            tuple(tuple(float(x) for x in row) for row in stds))
