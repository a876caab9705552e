"""Shared NN building blocks (port of ``mx_rcnn_tpu/models/layers.py``).

Inside the modules activations are NCHW tensors (kept ``channels_last`` in
memory by the Predictor); the image, the feature map into ROIAlign and its
pooled output stay NHWC at the public functions, as in the JAX package.
Every BN is frozen: an affine ``x·mul + add`` from stored moments, eps 2e-5.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 2e-5


class FrozenBatchNorm(nn.Module):
    """y = (x − mean)/sqrt(var + eps)·γ + β, folded into one multiply-add
    with ``mul = scale·rsqrt(var + eps)``, ``add = bias − mean·mul`` as in
    the JAX module.  The four tensors are buffers named like its params."""

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = self.scale * torch.rsqrt(self.var + self.eps)
        add = self.bias - self.mean * mul
        return x * mul[None, :, None, None] + add[None, :, None, None]


def conv(cin: int, cout: int, kernel: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    """k×k conv with explicit symmetric ``(k−1)//2`` padding (not SAME: at
    stride 2 SAME pads (0, 1), every public checkpoint family pads
    symmetrically)."""
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=bias)


_PIXEL_STATS: Dict = {}


def _pixel_stats(means, stds, device):
    """(means, 1 / stds) on ``device``, built once per (stats, device): a
    copy from host memory in every forward would make the host wait for the
    card."""
    key = (means, stds, device)
    if key not in _PIXEL_STATS:
        m = torch.tensor(means, dtype=torch.float32, device=device)
        _PIXEL_STATS[key] = (m, 1.0 / torch.tensor(stds, dtype=torch.float32, device=device))
    return _PIXEL_STATS[key]


def normalize_images(images: torch.Tensor, im_info: torch.Tensor, cfg) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB → normalized float32 with the bucket padding
    re-zeroed from ``im_info``; float batches pass through untouched."""
    if images.dtype != torch.uint8:
        return images
    dev = images.device
    means, inv_stds = _pixel_stats(tuple(cfg.network.PIXEL_MEANS), tuple(cfg.network.PIXEL_STDS),
                                   dev)
    out = (images.float() - means) * inv_stds
    bh, bw = images.shape[1], images.shape[2]
    rows = torch.arange(bh, dtype=torch.float32, device=dev)[None, :, None, None]
    cols = torch.arange(bw, dtype=torch.float32, device=dev)[None, None, :, None]
    mask = (rows < im_info[:, 0, None, None, None]) & (cols < im_info[:, 1, None, None, None])
    return out * mask


def make_pad_mask(im_info: torch.Tensor, canvas_hw):
    """→ ``fn(x)`` zeroing NCHW feature cells that sit on bucket padding.

    Cell (y, x) at stride s is valid iff ``s·y < h`` (and ``s·x < w``); the
    stride is the canvas/feature ratio snapped to a power of two."""
    ch, cw = float(canvas_hw[0]), float(canvas_hw[1])

    def snap(ratio: float) -> float:
        return float(2 ** round(math.log2(ratio))) if ratio > 1.0 else 1.0

    def apply(x: torch.Tensor) -> torch.Tensor:
        fh, fw = x.shape[2], x.shape[3]
        sy, sx = snap(ch / fh), snap(cw / fw)
        rows = torch.arange(fh, dtype=torch.float32, device=x.device) * sy
        cols = torch.arange(fw, dtype=torch.float32, device=x.device) * sx
        ok = (rows[None, :, None] < im_info[:, 0, None, None]) & (
            cols[None, None, :] < im_info[:, 1, None, None]
        )
        return x * ok[:, None].to(x.dtype)

    return apply


def pad_feat_to_ladder(feat: torch.Tensor, stride: int, shape_buckets) -> torch.Tensor:
    """Zero-pad a (B, H, W, C) feature map to the bucket ladder's max extent
    at this stride, so the second stage sees one shape on every bucket."""
    if not shape_buckets:
        return feat
    th = max(feat.shape[1], max(-(-bh // stride) for bh, _ in shape_buckets))
    tw = max(feat.shape[2], max(-(-bw // stride) for _, bw in shape_buckets))
    if (th, tw) == (feat.shape[1], feat.shape[2]):
        return feat
    return F.pad(feat, (0, 0, 0, tw - feat.shape[2], 0, th - feat.shape[1]))
