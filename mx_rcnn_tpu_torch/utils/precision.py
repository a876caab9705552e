"""Float32 means float32 on the card.

PyTorch runs a float32 convolution through cuDNN in TF32 (a 10-bit
mantissa) unless ``torch.backends.cudnn.allow_tf32`` is turned off, and may
do the same for matmuls.  The JAX package's float32 graph is full float32,
and the port's compute dtype (``COMPUTE_DTYPE``) is the one switch of
precision: every entry point that runs a model calls :func:`full_float32`.
"""

from __future__ import annotations

import torch


def full_float32() -> None:
    """Turn TF32 off for cuDNN convolutions and for matmuls, process-wide."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
