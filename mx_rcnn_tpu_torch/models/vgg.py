"""VGG-16 backbone and fc6/fc7 top head (port of ``mx_rcnn_tpu/models/vgg.py``).

Reference: ``rcnn/symbol/symbol_vgg.py :: get_vgg_conv`` (13 convs, four
2 × 2 pools → stride 16) and the fc6/fc7 (4096) head on 7 × 7 pooled rois
of ``get_vgg_train``.  Biases on, no BN: the config's FOLD_BN has nothing
to fold here.  Module names follow the Flax tree (``conv{b}_{i}``,
``fc6``, ``fc7``), so the parameter bridge maps it by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mx_rcnn_tpu_torch.models.layers import Linear, conv

# (number of convs, channels) per block; a pool after each of the first 4
VGG16 = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))

# the blocks in order; block b's convs are conv{b}_1 … (FIXED_PARAMS prefixes)
VGG_BLOCK_ORDER = ("conv1", "conv2", "conv3", "conv4", "conv5")


def _identity(x):
    return x


class VGGBackbone(nn.Module):
    """(B, 3, H, W) → (B, 512, H/16, W/16) in ``dtype``: block 5 runs at
    stride 16 with no pool after it (ROI pooling takes pool5's place).
    ``pad_mask`` re-zeroes the bucket padding before every conv and pool
    (the biases repaint it after each layer), as in the JAX module."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for b, (n_convs, ch) in enumerate(VGG16, start=1):
            for i in range(n_convs):
                self.add_module(f"conv{b}_{i + 1}", conv(cin, ch, 3, bias=True, dtype=dtype))
                cin = ch

    def forward(self, x: torch.Tensor, pad_mask=_identity) -> torch.Tensor:
        x = x.to(self.dtype)
        for b, (n_convs, _) in enumerate(VGG16, start=1):
            for i in range(n_convs):
                x = F.relu(getattr(self, f"conv{b}_{i + 1}")(pad_mask(x)))
            if b < 5:
                x = F.max_pool2d(pad_mask(x), 2, stride=2)
        return x


class VGGTopHead(nn.Module):
    """fc6/fc7 with ReLUs on pooled rois: an (R, C, ph, pw) view of the
    (R, ph, pw, C) pooled map → (R, 4096) in ``dtype``.  fc6 reads the rois
    flattened in (ph, pw, C) order, the JAX module's, whatever the view."""

    def __init__(self, dtype: torch.dtype = torch.float32, pooled=(7, 7), channels: int = 512):
        super().__init__()
        self.fc6 = Linear(pooled[0] * pooled[1] * channels, 4096, compute_dtype=dtype)
        self.fc7 = Linear(4096, 4096, compute_dtype=dtype)

    def forward(self, rois_feat: torch.Tensor) -> torch.Tensor:
        x = rois_feat.permute(0, 2, 3, 1).reshape(rois_feat.shape[0], -1)
        return F.relu(self.fc7(F.relu(self.fc6(x))))
