"""Mask targets on the device (port of ``mx_rcnn_tpu/ops/mask_targets.py``),
batched over any leading dims (images, rois):

- ``rasterize_box_masks``: the gt mask is its rectangle (box-only
  datasets), a cell-centre inclusion test;
- ``crop_resize_masks``: each roi's S×S target resampled bilinearly from
  its matched gt's M×M box-frame bitmap (``data/masks.py``).  The bilinear
  sample separates per axis, so it is two batched products per roi,
  (S, M) @ (M, M) @ (M, S).

Both take the JAX functions' float32 operations in their order.  The grid
fractions ``(i + 0.5) / S`` are computed once per (size, device) on the
host, as numpy rounds them: CUDA divides a tensor by a Python scalar as a
multiplication by its reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch

from mx_rcnn_tpu_torch.ops.targets import device_constant


def _cell_fractions(size: int, device) -> torch.Tensor:
    """(S,) float32 ``(arange(S) + 0.5) / S``, built once per device
    (``device_constant``; float32 → Python float is exact, so the tensor
    holds numpy's rounding)."""
    fr = (np.arange(size, dtype=np.float32) + np.float32(0.5)) / np.float32(size)
    return device_constant(tuple(fr.tolist()), device)


def _extent(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """+1-convention width of inclusive pixel bounds, at least 1."""
    return torch.clamp_min(hi - lo + 1.0, 1.0)


def rasterize_box_masks(rois: torch.Tensor, gt_boxes: torch.Tensor, size: int) -> torch.Tensor:
    """(…, 4) rois × (…, 4) matched gt boxes → (…, S, S) {0, 1} float32
    targets: cell (i, j) of a roi's S×S grid is foreground iff its centre
    (pixel-centre coordinates) lies inside the matched gt box."""
    x1, y1, x2, y2 = rois.unbind(-1)
    fr = _cell_fractions(size, rois.device)
    cx = x1[..., None] + fr * _extent(x1, x2)[..., None] - 0.5
    cy = y1[..., None] + fr * _extent(y1, y2)[..., None] - 0.5
    inside_x = (cx >= gt_boxes[..., 0, None]) & (cx <= gt_boxes[..., 2, None])
    inside_y = (cy >= gt_boxes[..., 1, None]) & (cy <= gt_boxes[..., 3, None])
    return (inside_y[..., :, None] & inside_x[..., None, :]).float()


def _axis_weights(centers: torch.Tensor, box_lo: torch.Tensor, box_span: torch.Tensor,
                  m: int) -> torch.Tensor:
    """(…, S) cell centres → (…, S, M) hat-function weights over the M cells
    of the matched gt's bitmap along one axis; centres outside the gt box
    fade to zero weight."""
    u = (centers - box_lo[..., None]) / box_span[..., None] * m - 0.5
    idx = torch.arange(m, dtype=torch.float32, device=centers.device)
    return torch.clamp_min(1.0 - (u[..., None] - idx).abs(), 0.0)


def crop_resize_masks(rois: torch.Tensor, gt_boxes: torch.Tensor, gt_masks: torch.Tensor,
                      size: int) -> torch.Tensor:
    """(…, 4) rois × (…, 4) matched gt boxes × (…, M, M) matched box-frame
    bitmaps → (…, S, S) soft targets in [0, 1] (callers binarize at 0.5).

    Boxes are inclusive pixel indices; the bitmap lives in continuous
    coordinates (pixel p covers [p, p+1)), so a roi cell's centre is
    ``x1 + fr·w``."""
    x1, y1, x2, y2 = rois.unbind(-1)
    fr = _cell_fractions(size, rois.device)
    cx = x1[..., None] + fr * _extent(x1, x2)[..., None]             # (…, S)
    cy = y1[..., None] + fr * _extent(y1, y2)[..., None]
    gx1, gy1, gx2, gy2 = gt_boxes[..., :4].unbind(-1)
    m = gt_masks.shape[-1]
    wy = _axis_weights(cy, gy1, _extent(gy1, gy2), m)                 # (…, S, M)
    wx = _axis_weights(cx, gx1, _extent(gx1, gx2), m)
    lead = wy.shape[:-2]
    wy, wx = wy.reshape((-1,) + wy.shape[-2:]), wx.reshape((-1,) + wx.shape[-2:])
    masks = gt_masks.float().reshape((-1, m, m))
    rows = torch.bmm(wy, masks)                                       # (n, S, M)
    return torch.bmm(rows, wx.transpose(1, 2)).reshape(lead + (size, size))
