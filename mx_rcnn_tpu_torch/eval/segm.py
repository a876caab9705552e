"""Mask post-processing: paste per-detection mask grids into image-space
RLEs (port of ``mx_rcnn_tpu/eval/segm.py``).

Per detection, the S×S mask probability grid is resized to the box extent,
thresholded, pasted into the full image and RLE-encoded for segm COCOeval
(``eval/coco_eval.py`` with ``iou_type='segm'``).  The resize is the port's
numpy twin of ``cv2.resize`` INTER_LINEAR (``data/image.py::resize_to``),
which rounds ~1e-7 away from OpenCV's on these grids: a pixel whose resized
probability lies that close to the threshold can flip.  The canvas paste is
int32 fixed point, bitwise equal to the device paste
(``ops/postprocess.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mx_rcnn_tpu_torch.data.image import resize_to
from mx_rcnn_tpu_torch.native import rle


def paste_mask(
    mask: np.ndarray, box: np.ndarray, h: int, w: int, thresh: float = 0.5
) -> np.ndarray:
    """(S, S) probability grid + [x1, y1, x2, y2] image box → (h, w) u8.

    Bilinear resize to the box's pixel extent (+1 convention), threshold,
    paste at the clipped location.
    """
    x1 = int(np.floor(box[0]))
    y1 = int(np.floor(box[1]))
    x2 = int(np.ceil(box[2]))
    y2 = int(np.ceil(box[3]))
    bw = max(x2 - x1 + 1, 1)
    bh = max(y2 - y1 + 1, 1)
    resized = resize_to(mask.astype(np.float32), bh, bw)
    binary = (resized >= thresh).astype(np.uint8)
    out = np.zeros((h, w), np.uint8)
    ox1, oy1 = max(x1, 0), max(y1, 0)
    ox2, oy2 = min(x2, w - 1), min(y2, h - 1)
    if ox2 >= ox1 and oy2 >= oy1:
        out[oy1 : oy2 + 1, ox1 : ox2 + 1] = binary[
            oy1 - y1 : oy2 - y1 + 1, ox1 - x1 : ox2 - x1 + 1
        ]
    return out


def paste_mask_canvas(
    logits: np.ndarray, box: np.ndarray, hc: int, wc: int
) -> np.ndarray:
    """(S, S) LOGIT grid + CANVAS-space box → (hc, wc) u8 binary mask.

    Numpy mirror of the device canvas paste
    (``ops/postprocess.py::make_test_postprocess(paste=True)``) —
    every arithmetic step matches op-for-op: clip box to the canvas,
    floor/ceil footprint (+1 convention), cv2-style half-pixel source
    mapping, then a bilinear blend in int32 FIXED POINT (logits
    quantized to 8 fractional bits, weights to 7) thresholded at logit
    0 (= probability 0.5).  Integer arithmetic is exact on every
    backend, so this function and the device canvas are bitwise equal
    by construction.
    """
    s = logits.shape[0]
    x1 = np.clip(np.float32(box[0]), 0.0, wc - 1.0)
    y1 = np.clip(np.float32(box[1]), 0.0, hc - 1.0)
    x2 = np.clip(np.float32(box[2]), 0.0, wc - 1.0)
    y2 = np.clip(np.float32(box[3]), 0.0, hc - 1.0)
    x1i = int(np.floor(x1))
    y1i = int(np.floor(y1))
    x2i = int(np.ceil(x2))
    y2i = int(np.ceil(y2))
    bw = max(x2i - x1i + 1, 1)
    bh = max(y2i - y1i + 1, 1)
    q = np.round(
        np.clip(logits.astype(np.float32), -60.0, 60.0) * np.float32(256.0)
    ).astype(np.int32)

    def axis(n):
        t = (np.arange(n, dtype=np.float32) + np.float32(0.5)) \
            * np.float32(s) / np.float32(n) - np.float32(0.5)
        sc = np.clip(t, 0.0, s - 1.0).astype(np.float32)
        i0 = np.floor(sc).astype(np.int32)
        i1 = np.minimum(i0 + 1, s - 1)
        w = np.round(
            (sc - i0.astype(np.float32)) * np.float32(128.0)
        ).astype(np.int32)
        return i0, i1, w

    x0, x1b, wx = axis(bw)
    y0, y1b, wy = axis(bh)
    val = (128 - wy)[:, None] * (
        (128 - wx)[None, :] * q[y0][:, x0] + wx[None, :] * q[y0][:, x1b]
    ) + wy[:, None] * (
        (128 - wx)[None, :] * q[y1b][:, x0] + wx[None, :] * q[y1b][:, x1b]
    )
    out = np.zeros((hc, wc), np.uint8)
    out[y1i : y2i + 1, x1i : x2i + 1] = (val >= 0).astype(np.uint8)
    return out


def canvas_rles(
    grids: np.ndarray, dets: np.ndarray, scale: float, hc: int, wc: int
) -> list:
    """One class's (n, S, S) LOGIT grids + (n, 5) ORIGINAL-coordinate
    detections → list of CANVAS-space RLEs (the host paste when the device
    canvas is off).  Boxes map to canvas coordinates by the image scale,
    exactly as on device."""
    return [
        rle.encode(
            paste_mask_canvas(
                g, np.asarray(d[:4], np.float32) * np.float32(scale), hc, wc
            )
        )
        for g, d in zip(grids, dets)
    ]


def mask_to_rle(mask_prob: np.ndarray, box: np.ndarray, h: int, w: int,
                thresh: float = 0.5) -> Dict:
    """Probability grid + box → image-space RLE dict."""
    return rle.encode(paste_mask(mask_prob, box, h, w, thresh))


def rles_for_detections(
    mask_probs: np.ndarray, dets: np.ndarray, h: int, w: int,
    thresh: float = 0.5,
) -> list:
    """One class's (n, S, S) probability grids + (n, 5) detections →
    list of image-space RLEs.  The unit of completion-pool work in
    ``pred_eval``: paste + threshold + RLE-encode dominates segm eval
    host cost, and this whole list is independent per (image, class)."""
    return [
        mask_to_rle(p, d[:4], h, w, thresh)
        for p, d in zip(mask_probs, dets)
    ]
