"""Region Proposal Network head (port of ``mx_rcnn_tpu/models/rpn.py``): it
computes in ``dtype`` and returns float32 logits and deltas, as the JAX
head does."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mx_rcnn_tpu_torch.models.layers import conv


class RPNHead(nn.Module):
    def __init__(self, cin: int = 1024, num_anchors: int = 9, channels: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_anchors = num_anchors
        self.rpn_conv = conv(cin, channels, 3, bias=True, dtype=dtype)
        self.rpn_cls_score = conv(channels, 2 * num_anchors, 1, bias=True, dtype=dtype)
        self.rpn_bbox_pred = conv(channels, 4 * num_anchors, 1, bias=True, dtype=dtype)

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, C, H, W) → logits (B, H·W·A, 2), deltas (B, H·W·A, 4) in the
        (y, x, anchor) order of the anchor table: channel 2a+c of the JAX
        NHWC output is anchor a, column c."""
        b = feat.shape[0]
        x = F.relu(self.rpn_conv(feat))
        logits = self.rpn_cls_score(x).permute(0, 2, 3, 1).reshape(b, -1, 2).float()
        deltas = self.rpn_bbox_pred(x).permute(0, 2, 3, 1).reshape(b, -1, 4).float()
        return logits, deltas
