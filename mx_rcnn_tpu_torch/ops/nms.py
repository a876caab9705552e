"""Non-maximum suppression with fixed shapes and validity masks
(port of ``mx_rcnn_tpu/ops/nms.py``).

One contract, two implementations of its core, :func:`nms_mask_sorted`:

- the hand-written CUDA kernel ``csrc/nms.cu`` for CUDA tensors, one launch
  pair over a whole batch of independent problems;
- :func:`nms_mask_sorted_plain`, the plain PyTorch version, for CPU tensors.

Everything takes leading batch dims: the per-image and per-class ``vmap`` of
the JAX package becomes one batched call, so a batch of B images × (K−1)
classes is one kernel launch pair.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mx_rcnn_tpu_torch.utils.cuda_build import (
    CudaKernel,
    CudaLibrary,
    kernel_input,
    ptr,
    stream_of,
)

_NEG_INF = -1e10

library = CudaLibrary("nms.cu")
kernel = CudaKernel(
    library,
    "nms_keep_sorted",
    (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ),
)


def nms_mask_sorted_plain(
    boxes: torch.Tensor, valid: torch.Tensor, thresh: float, max_keep: int = 0
) -> torch.Tensor:
    """Plain PyTorch greedy NMS: (P, N, 4) boxes sorted by descending score
    + (P, N) valid → (P, N) bool keep mask, on any device.

    IoU with the op order of ``ops/pallas/nms.py`` (+1 widths, union
    floored at 1e-12, ``iou > thresh`` in float32).  With ``max_keep`` > 0
    only the first ``max_keep`` survivors stay set: exactly what the
    kernel's early-stopping sweep leaves."""
    n = boxes.shape[-2]
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    iw = torch.minimum(x2[:, :, None], x2[:, None, :]) - torch.maximum(
        x1[:, :, None], x1[:, None, :]
    ) + 1.0
    ih = torch.minimum(y2[:, :, None], y2[:, None, :]) - torch.maximum(
        y1[:, :, None], y1[:, None, :]
    ) + 1.0
    inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)
    union = area[:, :, None] + area[:, None, :] - inter
    iou = inter / union.clamp_min(1e-12)
    later = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (iou > thresh) & later
    alive = valid.clone()
    for i in range(n):
        alive &= ~(suppress[:, i, :] & alive[:, i, None])
    if max_keep > 0:
        alive &= torch.cumsum(alive, dim=-1) <= max_keep
    return alive


def _nms_mask_sorted_cuda(boxes, valid, thresh, max_keep):
    boxes = kernel_input("boxes", boxes, torch.float32, 3)
    # a bool mask is read as its bytes (a view, not a conversion)
    valid = kernel_input("valid", valid.view(torch.uint8) if valid.dtype == torch.bool else valid,
                         torch.uint8, 2)
    p, n = boxes.shape[0], boxes.shape[1]
    if boxes.shape[2] != 4 or tuple(valid.shape) != (p, n):
        raise ValueError(f"boxes {tuple(boxes.shape)} / valid {tuple(valid.shape)}")
    keep = torch.empty((p, n), dtype=torch.uint8, device=boxes.device)
    scratch = torch.empty((p, n, -(-n // 64)), dtype=torch.int64, device=boxes.device)
    with torch.cuda.device(boxes.device):
        kernel(
            ptr(boxes), ptr(valid), p, n, float(thresh), int(max_keep),
            ptr(scratch), ptr(keep), stream_of(boxes),
        )
    kernel.launches += 1
    return keep.view(torch.bool)


def nms_mask_sorted(
    boxes: torch.Tensor, valid: torch.Tensor, thresh: float, max_keep: int = 0
) -> torch.Tensor:
    """Keep mask for (..., N, 4) boxes ALREADY sorted by descending score.

    CUDA tensors launch ``csrc/nms.cu``; CPU tensors run
    :func:`nms_mask_sorted_plain`.  ``max_keep`` > 0: only the first
    ``max_keep`` survivors are set (all ``nms`` ever reads)."""
    lead, n = boxes.shape[:-2], boxes.shape[-2]
    b = boxes.reshape(-1, n, 4)
    v = valid.reshape(-1, n)
    if boxes.device.type == "cpu":
        keep = nms_mask_sorted_plain(b, v, thresh, max_keep)
    else:
        keep = _nms_mask_sorted_cuda(b, v, thresh, max_keep)
    return keep.reshape(lead + (n,))


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    thresh: float,
    valid: torch.Tensor | None = None,
    sorted_input: bool = False,
    max_keep: int = 0,
) -> torch.Tensor:
    """Greedy NMS → bool keep mask aligned with the *input* order.

    ``boxes`` (..., N, 4), ``scores``/``valid`` (..., N).  Invalid entries
    never survive and never suppress.  ``sorted_input`` promises descending
    score order (skips the sort); ``max_keep`` then stops the sweep at that
    many survivors.  Unsorted input is ordered by a stable descending sort,
    the order ``jnp.argsort(-scores)`` gives on ties."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    if sorted_input:
        return nms_mask_sorted(boxes, valid, thresh, max_keep)
    masked = torch.where(valid, scores, _NEG_INF)
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    v = torch.gather(valid, -1, order)
    keep_sorted = nms_mask_sorted(b, v, thresh)
    return torch.zeros_like(valid).scatter(-1, order, keep_sorted)


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    thresh: float,
    max_out: int,
    valid: torch.Tensor | None = None,
    sorted_input: bool = False,
    with_idx: bool = False,
):
    """NMS + the top ``max_out`` survivors by score, padded to a fixed shape.

    Returns ``(boxes (..., max_out, 4), scores (..., max_out), valid
    (..., max_out))`` and, with ``with_idx``, each row's source index in
    the input order.  Padding rows are zero boxes with score ``-1e10`` and
    ``valid=False``.  The selection is a stable descending sort, so ties
    and padding order as ``lax.top_k`` orders them."""
    keep = nms_mask(
        boxes, scores, thresh, valid, sorted_input=sorted_input,
        max_keep=max_out if sorted_input else 0,
    )
    masked = torch.where(keep, scores, _NEG_INF)
    n = masked.shape[-1]
    if n < max_out:  # pad so the selection is well-formed
        pad = max_out - n
        masked = torch.cat(
            [masked, masked.new_full(masked.shape[:-1] + (pad,), _NEG_INF)], -1
        )
        boxes = torch.cat([boxes, boxes.new_zeros(boxes.shape[:-2] + (pad, 4))], -2)
    top_scores, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[..., :max_out], idx[..., :max_out]
    out_valid = top_scores > _NEG_INF / 2
    picked = torch.gather(boxes, -2, idx[..., None].expand(idx.shape + (4,)))
    out_boxes = torch.where(out_valid[..., None], picked, 0.0)
    if with_idx:
        return out_boxes, top_scores, out_valid, idx
    return out_boxes, top_scores, out_valid


def batched_class_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    thresh: float,
    max_out: int,
    valid: torch.Tensor | None = None,
    with_idx: bool = False,
):
    """Per-class NMS over leading class (and image) dims: ``boxes``
    (..., C, N, 4), ``scores`` (..., C, N) → (..., C, max_out, ·) padded,
    one kernel launch pair for all of them."""
    return nms(boxes, scores, thresh, max_out, valid, with_idx=with_idx)


def nms_numpy(dets: np.ndarray, thresh: float) -> list:
    """Host greedy NMS on (N, 5) [x1, y1, x2, y2, score] → kept indices
    (the test oracle; same as the JAX package's ``nms_numpy``)."""
    if dets.size == 0:
        return []
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort(kind="stable")[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        inds = np.where(ovr <= thresh)[0]
        order = order[inds + 1]
    return keep
