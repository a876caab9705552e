"""ResNet-50/101 C4 backbone (or C2–C5 pyramid) + conv5 top head (port of
``mx_rcnn_tpu/models/resnet.py``).

Post-activation bottlenecks with the stride on the 1×1 ``conv1``
(MSRA-style, as the JAX package; torchvision's v1.5 puts it on the 3×3),
every BN frozen.  ``dtype`` is the compute dtype (the backbone casts its
input to it; residual adds and ReLUs run in it) and ``fold_bn`` folds each
frozen BN into its conv (``layers.make_conv_bn``), as in the JAX modules.
Module names follow the Flax tree (``conv0``, ``bn0``,
``stage1`` … ``unit1`` … ``conv1``/``bn1``/``sc``/``sc_bn``), so the
parameter bridge maps one tree onto the other by name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mx_rcnn_tpu_torch.models.layers import ConvBNFolder, FrozenBatchNorm, conv, make_conv_bn

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _identity(x):
    return x


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1(×4) bottleneck with a projection shortcut where the
    shape changes."""

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = conv(cin, filters, 1, stride, dtype=dtype)
        self.bn1 = FrozenBatchNorm(filters, dtype=dtype)
        self.conv2 = conv(filters, filters, 3, dtype=dtype)
        self.bn2 = FrozenBatchNorm(filters, dtype=dtype)
        self.conv3 = conv(filters, filters * 4, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm(filters * 4, dtype=dtype)
        if stride != 1 or cin != filters * 4:
            self.sc = conv(cin, filters * 4, 1, stride, dtype=dtype)
            self.sc_bn = FrozenBatchNorm(filters * 4, dtype=dtype)

    def conv_bn_pairs(self):
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)]
        return pairs + ([(self.sc, self.sc_bn)] if hasattr(self, "sc") else [])

    def forward(self, x: torch.Tensor, pad_mask=_identity, cbn=None) -> torch.Tensor:
        cbn = cbn or make_conv_bn()
        y = F.relu(cbn(x, self.conv1, self.bn1))
        # the unit's only spatial (3×3) op: re-zero bucket padding first
        y = F.relu(cbn(pad_mask(y), self.conv2, self.bn2))
        y = cbn(y, self.conv3, self.bn3)
        residual = cbn(x, self.sc, self.sc_bn) if hasattr(self, "sc") else x
        return F.relu(y + residual)


class ResNetStage(nn.Module):
    def __init__(self, cin: int, filters: int, num_units: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(num_units):
            self.add_module(
                f"unit{i + 1}",
                Bottleneck(cin if i == 0 else filters * 4, filters, stride if i == 0 else 1,
                           dtype),
            )

    def conv_bn_pairs(self):
        return [p for unit in self.children() for p in unit.conv_bn_pairs()]

    def forward(self, x: torch.Tensor, pad_mask=_identity, cbn=None) -> torch.Tensor:
        for unit in self.children():
            x = unit(x, pad_mask, cbn)
        return x


def _folder(pairs, dtype: torch.dtype, fold_bn: bool) -> Optional[ConvBNFolder]:
    return ConvBNFolder(pairs, dtype) if fold_bn else None


def _cbn(folder: Optional[ConvBNFolder]):
    """This forward's conv → BN wiring: folded (from ``folder``'s kernels)
    or not."""
    return make_conv_bn(None if folder is None else folder.fold())


class ResNetBackbone(nn.Module):
    """conv1..conv4: (B, 3, H, W) → C4 feature (B, 1024, H/16, W/16).

    With ``return_pyramid`` it also holds ``stage4`` and returns (C2, C3,
    C4, C5) for FPN, C5 computed convolutionally (the plain Faster R-CNN
    applies stage4 per roi in :class:`ResNetTopHead` instead).  The input
    is cast to ``dtype``; with ``fold_bn`` every BN is folded into its conv
    (the kernels of one forward folded at once)."""

    def __init__(self, depth: int = 101, return_pyramid: bool = False,
                 dtype: torch.dtype = torch.float32, fold_bn: bool = False):
        super().__init__()
        blocks = BLOCKS[depth]
        self.return_pyramid = return_pyramid
        self.dtype = dtype
        self.conv0 = conv(3, 64, 7, 2, dtype=dtype)
        self.bn0 = FrozenBatchNorm(64, dtype=dtype)
        self.stage1 = ResNetStage(64, 64, blocks[0], 1, dtype)
        self.stage2 = ResNetStage(256, 128, blocks[1], 2, dtype)
        self.stage3 = ResNetStage(512, 256, blocks[2], 2, dtype)
        if return_pyramid:
            self.stage4 = ResNetStage(1024, 512, blocks[3], 2, dtype)
        stages = [self.stage1, self.stage2, self.stage3] + ([self.stage4] if return_pyramid else [])
        self._folder = _folder([(self.conv0, self.bn0)] + [p for st in stages
                                                           for p in st.conv_bn_pairs()],
                               dtype, fold_bn)

    def forward(self, x: torch.Tensor, pad_mask=_identity):
        cbn = _cbn(self._folder)
        x = F.relu(cbn(x.to(self.dtype), self.conv0, self.bn0))
        # re-zero bucket padding before the pool: relu output is ≥ 0 and
        # every valid window holds a valid cell, so zeros never win a max
        x = F.max_pool2d(pad_mask(x), 3, stride=2, padding=1)
        c2 = self.stage1(x, pad_mask, cbn)
        c3 = self.stage2(c2, pad_mask, cbn)
        c4 = self.stage3(c3, pad_mask, cbn)
        if not self.return_pyramid:
            return c4
        return c2, c3, c4, self.stage4(c4, pad_mask, cbn)


class ResNetTopHead(nn.Module):
    """conv5 stage on pooled rois: (R, 1024, 14, 14) → (R, 2048) vector, in
    ``dtype``."""

    def __init__(self, depth: int = 101, dtype: torch.dtype = torch.float32,
                 fold_bn: bool = False):
        super().__init__()
        self.stage4 = ResNetStage(1024, 512, BLOCKS[depth][3], 2, dtype)
        self._folder = _folder(self.stage4.conv_bn_pairs(), dtype, fold_bn)

    def forward(self, rois_feat: torch.Tensor) -> torch.Tensor:
        return self.stage4(rois_feat, _identity, _cbn(self._folder)).mean(dim=(2, 3))
