"""Loss primitives (port of ``mx_rcnn_tpu/ops/losses.py``).

MXNet's ``smooth_l1`` (``scalar`` = sigma) and ``SoftmaxOutput`` with
``ignore_label=-1``, as plain torch ops.  The divisor of every loss comes
from the caller through ``norm``: ``train_forward`` divides the RPN losses
by ``RPN_BATCH_SIZE·B`` and both RCNN losses by ``BATCH_ROIS·B``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, sigma: float) -> torch.Tensor:
    """Elementwise smooth-L1 with its transition at 1/sigma²:
    ``0.5·(sigma·x)²`` if ``|x| < 1/sigma²`` else ``|x| − 0.5/sigma²``."""
    sigma2 = sigma * sigma
    diff = pred - target
    adiff = diff.abs()
    return torch.where(adiff < 1.0 / sigma2, 0.5 * sigma2 * diff * diff, adiff - 0.5 / sigma2)


def weighted_smooth_l1(
    pred: torch.Tensor,
    target: torch.Tensor,
    weight: torch.Tensor,
    sigma: float,
    norm: Union[torch.Tensor, float],
) -> torch.Tensor:
    """sum(weight · smooth_l1) / norm."""
    return torch.sum(weight * smooth_l1(pred, target, sigma)) / norm


def softmax_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_label: int = -1,
    norm: Optional[Union[torch.Tensor, float]] = None,
) -> torch.Tensor:
    """Softmax CE summed over entries whose label != ``ignore_label``, over
    ``norm`` (default: the number of such entries, at least 1).  Ignored
    entries contribute zero loss and zero gradient."""
    logits = logits.float()
    valid = labels != ignore_label
    safe_labels = torch.where(valid, labels, 0).long()
    shifted = logits - logits.amax(-1, keepdim=True)
    logz = torch.log(torch.sum(torch.exp(shifted), -1))
    ll = torch.gather(shifted, -1, safe_labels[..., None])[..., 0]
    nll = (logz - ll) * valid
    if norm is None:
        norm = valid.sum().clamp_min(1)
    return torch.sum(nll) / norm


def accuracy(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = -1) -> torch.Tensor:
    """Classification accuracy over non-ignored entries (a metric, not a
    loss).  ``torch.argmax`` takes the first maximum, as ``jnp.argmax``."""
    valid = labels != ignore_label
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels) & valid
    return correct.sum() / valid.sum().clamp_min(1)
