"""models of the PyTorch port (see the package docstring)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mx_rcnn_tpu_torch.config import Config


def build_model(cfg: Config, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The model the config names: the FPN graph when ``USE_FPN``, else the
    single-level C4 graph (the JAX package's ``models.build_model``)."""
    if cfg.network.USE_FPN:
        from mx_rcnn_tpu_torch.models.fpn import FPNFasterRCNN

        return FPNFasterRCNN(cfg, generator)
    from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN

    return FasterRCNN(cfg, generator)
