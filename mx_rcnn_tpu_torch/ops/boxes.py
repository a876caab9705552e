"""Box geometry: IoU, encode, decode, clipping (port of ``mx_rcnn_tpu/ops/boxes.py``).

Same legacy +1-pixel width convention and the same float32 op order as the
JAX functions.  Every function takes any number of leading batch dims, so
the per-image ``vmap`` of the JAX package becomes a batch dim written out.
"""

from __future__ import annotations

import torch

# guard against exp() overflow on garbage deltas of padded boxes
_BBOX_XFORM_CLIP = 4.135166556742356  # log(1000 / 16)


def bbox_overlaps(boxes: torch.Tensor, query_boxes: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (..., N, 4) and (..., K, 4) boxes → (..., N, K)."""
    boxes = boxes.float()
    query_boxes = query_boxes.float()
    bx1, by1, bx2, by2 = (boxes[..., i, None] for i in range(4))         # (...,N,1)
    qx1, qy1, qx2, qy2 = (query_boxes[..., None, :, i] for i in range(4))  # (...,1,K)

    iw = torch.minimum(bx2, qx2) - torch.maximum(bx1, qx1) + 1.0
    ih = torch.minimum(by2, qy2) - torch.maximum(by1, qy1) + 1.0
    inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)

    area_b = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
    area_q = (qx2 - qx1 + 1.0) * (qy2 - qy1 + 1.0)
    union = area_b + area_q - inter
    return inter / union.clamp_min(1e-12)


def bbox_transform(ex_rois: torch.Tensor, gt_rois: torch.Tensor) -> torch.Tensor:
    """Encode gt boxes w.r.t. example rois: (..., N, 4) × (..., N, 4) →
    (..., N, 4) ``[dx, dy, dw, dh]`` (the leading dims broadcast)."""
    ex_w = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    ex_h = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex_cx = ex_rois[..., 0] + 0.5 * (ex_w - 1.0)
    ex_cy = ex_rois[..., 1] + 0.5 * (ex_h - 1.0)

    gt_w = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gt_h = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gt_cx = gt_rois[..., 0] + 0.5 * (gt_w - 1.0)
    gt_cy = gt_rois[..., 1] + 0.5 * (gt_h - 1.0)

    dx = (gt_cx - ex_cx) / (ex_w + 1e-14)
    dy = (gt_cy - ex_cy) / (ex_h + 1e-14)
    dw = torch.log(gt_w.clamp_min(1.0) / ex_w.clamp_min(1e-14))
    dh = torch.log(gt_h.clamp_min(1.0) / ex_h.clamp_min(1e-14))
    return torch.stack([dx, dy, dw, dh], dim=-1)


def bbox_pred(boxes: torch.Tensor, box_deltas: torch.Tensor) -> torch.Tensor:
    """Decode (..., N, 4K) deltas against (..., N, 4) boxes → (..., N, 4K).

    ``boxes`` broadcasts against the deltas' leading dims (one anchor table
    for a batch of images)."""
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * (widths - 1.0)
    ctr_y = boxes[..., 1] + 0.5 * (heights - 1.0)

    deltas = box_deltas.reshape(box_deltas.shape[:-1] + (-1, 4))
    dx, dy = deltas[..., 0], deltas[..., 1]
    dw = deltas[..., 2].clamp_max(_BBOX_XFORM_CLIP)
    dh = deltas[..., 3].clamp_max(_BBOX_XFORM_CLIP)

    pred_cx = dx * widths[..., None] + ctr_x[..., None]
    pred_cy = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    out = torch.stack(
        [
            pred_cx - 0.5 * (pred_w - 1.0),
            pred_cy - 0.5 * (pred_h - 1.0),
            pred_cx + 0.5 * (pred_w - 1.0),
            pred_cy + 0.5 * (pred_h - 1.0),
        ],
        dim=-1,
    )
    return out.reshape(box_deltas.shape)


def clip_boxes(boxes: torch.Tensor, h, w) -> torch.Tensor:
    """Clip (..., N, 4K) boxes into the image: x∈[0, w-1], y∈[0, h-1].

    ``h``/``w`` are scalars or tensors of the boxes' leading (batch) shape.
    """
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    h = torch.as_tensor(h, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(w, dtype=boxes.dtype, device=boxes.device)
    h = h.reshape(h.shape + (1, 1))
    w = w.reshape(w.shape + (1, 1))
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(b[..., 0], zero), w - 1.0)
    y1 = torch.minimum(torch.maximum(b[..., 1], zero), h - 1.0)
    x2 = torch.minimum(torch.maximum(b[..., 2], zero), w - 1.0)
    y2 = torch.minimum(torch.maximum(b[..., 3], zero), h - 1.0)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)
