"""RCNN classification/regression head and Mask R-CNN mask head (port of
``RCNNHead`` and ``MaskHead`` of ``mx_rcnn_tpu/models/heads.py``).  A Flax Dense kernel (in, out) is the
transpose of ``nn.Linear.weight`` (out, in); the bridge transposes it.  Both
heads compute in ``dtype`` and return float32, as the JAX heads do."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from mx_rcnn_tpu_torch.models.layers import ConvTranspose2d, Linear, conv


class RCNNHead(nn.Module):
    def __init__(self, din: int, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls_score = Linear(din, num_classes, compute_dtype=dtype)
        self.bbox_pred = Linear(din, 4 * num_classes, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(R, D) trunk features → float32 cls logits (R, K), box deltas
        (R, 4K)."""
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class MaskHead(nn.Module):
    """Mask R-CNN head (port of ``MaskHead``): four 3×3 convs with bias and
    relu, a 2×2 stride-2 transposed conv with relu, a 1×1 ``mask_logits``
    conv: (R, C, 14, 14) pooled rois → (R, K, 28, 28) per-class logits,
    float32 (computed in ``dtype``).

    ``mask_deconv`` is torch's ``ConvTranspose2d(k=2, s=2)``: output cell
    (2i + t) takes input cell i times tap t.  Flax's ``ConvTranspose`` (SAME,
    no kernel transpose) gives cell 2i tap 1 and cell 2i + 1 tap 0, so the
    bridge flips the Flax kernel in both spatial axes."""

    def __init__(self, cin: int, num_classes: int, channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(4):
            self.add_module(f"mask_conv{i + 1}", conv(cin if i == 0 else channels, channels, 3,
                                                      bias=True, dtype=dtype))
        self.mask_deconv = ConvTranspose2d(channels, channels, 2, stride=2, compute_dtype=dtype)
        self.mask_logits = conv(channels, num_classes, 1, bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = torch.relu(getattr(self, f"mask_conv{i + 1}")(x))
        return self.mask_logits(torch.relu(self.mask_deconv(x))).float()
