"""Image resizing, quantization and bucket padding (port of
``mx_rcnn_tpu/data/image.py``), with no OpenCV dependency.

:func:`resize_im` reproduces ``cv2.resize(..., INTER_LINEAR)`` with scale
factors: output size ``round(dim·scale)`` and the half-pixel source mapping
``src = (dst + 0.5)/scale − 0.5``, clamped to the image, interpolated along x
then along y with float32 weights and values, as OpenCV does for float
images.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _linear_taps(src: int, dst: int, scale: float):
    """cv2's INTER_LINEAR source taps and weights along one axis."""
    # positions and weights in float64, as OpenCV computes them
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / scale) - 0.5
    lo = np.floor(f).astype(np.int64)
    w = f - lo
    w[lo < 0] = 0.0
    lo = np.maximum(lo, 0)
    w[lo >= src - 1] = 0.0
    lo = np.minimum(lo, src - 1)
    hi = np.minimum(lo + 1, src - 1)
    return lo, hi, (1.0 - w).astype(np.float32), w.astype(np.float32)


def resize_linear(im: np.ndarray, scale: float) -> np.ndarray:
    """``cv2.resize(im, None, fx=scale, fy=scale, interpolation=INTER_LINEAR)``
    for an (H, W[, C]) image."""
    h, w = im.shape[:2]
    dh, dw = int(round(h * scale)), int(round(w * scale))
    src = im.astype(np.float32)
    if src.ndim == 2:
        src = src[:, :, None]
    x0, x1, wx0, wx1 = _linear_taps(w, dw, scale)
    y0, y1, wy0, wy1 = _linear_taps(h, dh, scale)
    rows = src[:, x0] * wx0[None, :, None] + src[:, x1] * wx1[None, :, None]
    out = rows[y0] * wy0[:, None, None] + rows[y1] * wy1[:, None, None]
    if im.ndim == 2:
        out = out[:, :, 0]
    if np.issubdtype(im.dtype, np.integer):
        info = np.iinfo(im.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(im.dtype)
    return out.astype(im.dtype)


def resize_im(im: np.ndarray, target_size: int, max_size: int) -> Tuple[np.ndarray, float]:
    """Short side → ``target_size`` capped so the long side ≤ ``max_size``."""
    h, w = im.shape[:2]
    short, long_ = min(h, w), max(h, w)
    scale = float(target_size) / short
    if round(scale * long_) > max_size:
        scale = float(max_size) / long_
    return resize_linear(im, scale), scale


def normalize(im: np.ndarray, pixel_means, pixel_stds) -> np.ndarray:
    """(H, W, 3) RGB → normalized float32."""
    return (im - np.asarray(pixel_means, np.float32)) / np.asarray(pixel_stds, np.float32)


def quantize_uint8(im: np.ndarray) -> np.ndarray:
    """Resized float RGB → rounded uint8 (TEST.UINT8_TRANSFER: the model
    normalizes on the device)."""
    return np.clip(np.rint(im), 0, 255).astype(np.uint8)


def pad_to_bucket(im: np.ndarray, bucket: Tuple[int, int]) -> np.ndarray:
    """Zero-pad bottom/right to the bucket shape (boxes stay valid)."""
    h, w = im.shape[:2]
    bh, bw = bucket
    if h > bh or w > bw:
        raise ValueError(
            f"image ({h}, {w}) exceeds bucket ({bh}, {bw}) — SCALES and "
            f"SHAPE_BUCKETS are inconsistent"
        )
    out = np.zeros((bh, bw) + im.shape[2:], dtype=im.dtype)
    out[:h, :w] = im
    return out


def pick_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest bucket that contains (h, w); else the largest-area bucket."""
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if fitting:
        return min(fitting, key=lambda b: b[0] * b[1])
    return max(buckets, key=lambda b: b[0] * b[1])


def prepare_image(
    im: np.ndarray,
    target_size: int,
    max_size: int,
    pixel_means,
    pixel_stds,
    buckets: Sequence[Tuple[int, int]],
    uint8_out: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """resize → normalize (or quantize, ``uint8_out``) → bucket-pad; returns
    (padded image, im_info = (resized h, resized w, scale))."""
    im, scale = resize_im(im, target_size, max_size)
    h, w = im.shape[:2]
    im = quantize_uint8(im) if uint8_out else normalize(im, pixel_means, pixel_stds)
    im = pad_to_bucket(im, pick_bucket(h, w, buckets))
    return im, np.array([h, w, scale], np.float32)
