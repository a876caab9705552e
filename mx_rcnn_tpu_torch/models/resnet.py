"""ResNet-50/101 C4 backbone (or C2–C5 pyramid) + conv5 top head (port of
``mx_rcnn_tpu/models/resnet.py``).

Post-activation bottlenecks with the stride on the 1×1 ``conv1``
(MSRA-style, as the JAX package; torchvision's v1.5 puts it on the 3×3),
every BN frozen.  Module names follow the Flax tree (``conv0``, ``bn0``,
``stage1`` … ``unit1`` … ``conv1``/``bn1``/``sc``/``sc_bn``), so the
parameter bridge maps one tree onto the other by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm, conv

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _identity(x):
    return x


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1(×4) bottleneck with a projection shortcut where the
    shape changes."""

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(cin, filters, 1, stride)
        self.bn1 = FrozenBatchNorm(filters)
        self.conv2 = conv(filters, filters, 3)
        self.bn2 = FrozenBatchNorm(filters)
        self.conv3 = conv(filters, filters * 4, 1)
        self.bn3 = FrozenBatchNorm(filters * 4)
        if stride != 1 or cin != filters * 4:
            self.sc = conv(cin, filters * 4, 1, stride)
            self.sc_bn = FrozenBatchNorm(filters * 4)

    def forward(self, x: torch.Tensor, pad_mask=_identity) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        # the unit's only spatial (3×3) op: re-zero bucket padding first
        y = F.relu(self.bn2(self.conv2(pad_mask(y))))
        y = self.bn3(self.conv3(y))
        residual = self.sc_bn(self.sc(x)) if hasattr(self, "sc") else x
        return F.relu(y + residual)


class ResNetStage(nn.Module):
    def __init__(self, cin: int, filters: int, num_units: int, stride: int):
        super().__init__()
        for i in range(num_units):
            self.add_module(
                f"unit{i + 1}",
                Bottleneck(cin if i == 0 else filters * 4, filters, stride if i == 0 else 1),
            )

    def forward(self, x: torch.Tensor, pad_mask=_identity) -> torch.Tensor:
        for unit in self.children():
            x = unit(x, pad_mask)
        return x


class ResNetBackbone(nn.Module):
    """conv1..conv4: (B, 3, H, W) → C4 feature (B, 1024, H/16, W/16).

    With ``return_pyramid`` it also holds ``stage4`` and returns (C2, C3,
    C4, C5) for FPN, C5 computed convolutionally (the plain Faster R-CNN
    applies stage4 per roi in :class:`ResNetTopHead` instead)."""

    def __init__(self, depth: int = 101, return_pyramid: bool = False):
        super().__init__()
        blocks = BLOCKS[depth]
        self.return_pyramid = return_pyramid
        self.conv0 = conv(3, 64, 7, 2)
        self.bn0 = FrozenBatchNorm(64)
        self.stage1 = ResNetStage(64, 64, blocks[0], 1)
        self.stage2 = ResNetStage(256, 128, blocks[1], 2)
        self.stage3 = ResNetStage(512, 256, blocks[2], 2)
        if return_pyramid:
            self.stage4 = ResNetStage(1024, 512, blocks[3], 2)

    def forward(self, x: torch.Tensor, pad_mask=_identity):
        x = F.relu(self.bn0(self.conv0(x)))
        # re-zero bucket padding before the pool: relu output is ≥ 0 and
        # every valid window holds a valid cell, so zeros never win a max
        x = F.max_pool2d(pad_mask(x), 3, stride=2, padding=1)
        c2 = self.stage1(x, pad_mask)
        c3 = self.stage2(c2, pad_mask)
        c4 = self.stage3(c3, pad_mask)
        if not self.return_pyramid:
            return c4
        return c2, c3, c4, self.stage4(c4, pad_mask)


class ResNetTopHead(nn.Module):
    """conv5 stage on pooled rois: (R, 1024, 14, 14) → (R, 2048) vector."""

    def __init__(self, depth: int = 101):
        super().__init__()
        self.stage4 = ResNetStage(1024, 512, BLOCKS[depth][3], 2)

    def forward(self, rois_feat: torch.Tensor) -> torch.Tensor:
        return self.stage4(rois_feat).mean(dim=(2, 3))
