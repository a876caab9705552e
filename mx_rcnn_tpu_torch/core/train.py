"""Trainer pieces: parameter freezing, MXNet-semantics SGD, the piecewise
learning-rate schedule and the train step (port of
``mx_rcnn_tpu/core/train.py``).

Optimizer semantics follow MXNet SGD, as the JAX package's optax chain:
each gradient clipped element-wise to ±CLIP_GRADIENT, weight decay added to
the gradient before the momentum, momentum 0.9 without dampening, then
``−lr·trace``; frozen tensors (FIXED_PARAMS) get no update and no decay.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.models.faster_rcnn import fold_in


def is_frozen_path(path: Tuple[str, ...], fixed_params: Sequence[str]) -> bool:
    """FIXED_PARAMS semantics on a dotted module path split into parts:
    whole subtrees frozen by name prefix (``conv0``, ``stage1``, …), every
    frozen-BN tensor network-wide for ``"bn"`` (modules whose name contains
    ``bn``), and running moments always."""
    for comp in path:
        for pat in fixed_params:
            if pat == "bn":
                if "bn" in comp:
                    return True
            elif comp == pat or comp.startswith(pat):
                return True
    return path[-1] in ("mean", "var")


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """Piecewise constant: LEARNING_RATE × LR_FACTOR for each boundary
    ``LR_STEP_EPOCHS·steps_per_epoch`` the update count has reached
    (``optax.piecewise_constant_schedule``: a boundary b scales the updates
    whose count, from 0, is ≥ b)."""
    t = cfg.TRAIN
    boundaries = {int(e * steps_per_epoch): t.LR_FACTOR for e in t.LR_STEP_EPOCHS}

    def schedule(count: int) -> float:
        lr = t.LEARNING_RATE
        for b in sorted(boundaries):
            if count >= b:
                lr *= boundaries[b]
        return lr

    return schedule


class MXNetSGD:
    """MXNet SGD over a model's trainable parameters.

    ``step()`` clamps every gradient in place to ±clip (one foreach clamp
    for all of them), then runs
    ``torch.optim.SGD(momentum, weight_decay, dampening=0)``, which computes
    ``g + wd·p`` → ``trace = momentum·trace + that`` (the first trace is the
    gradient itself, as from a zero trace) → ``p − lr·trace``: exactly the
    JAX package's ``clip → add_decayed_weights → trace → scale_by_schedule``
    chain.  The learning rate is the schedule at the update count (0 for
    the first update), as optax counts."""

    def __init__(self, params: Iterable[nn.Parameter], schedule: Callable[[int], float],
                 momentum: float, weight_decay: float, clip: float):
        self.params = list(params)
        self.schedule = schedule
        self.clip = clip
        self.count = 0
        self.sgd = torch.optim.SGD(
            self.params, lr=schedule(0), momentum=momentum, dampening=0.0,
            weight_decay=weight_decay, nesterov=False,
        )

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        torch.nn.utils.clip_grad_value_(self.params, self.clip)
        for group in self.sgd.param_groups:
            group["lr"] = self.schedule(self.count)
        self.sgd.step()
        self.count += 1


def make_optimizer(
    cfg: Config,
    model: nn.Module,
    lr_schedule: Callable[[int], float],
) -> MXNetSGD:
    """Freeze ``model``'s FIXED_PARAMS tensors (``requires_grad`` off, so no
    gradient is computed for them) and return the MXNet SGD over the rest.

    The frozen BN affines are buffers here (``models/layers.py``), never
    trained; a freeze set without ``"bn"`` would have the JAX package train
    them, so it raises."""
    t = cfg.TRAIN
    fixed = cfg.network.FIXED_PARAMS
    if "bn" not in fixed:
        raise NotImplementedError(
            "FIXED_PARAMS without 'bn' trains the BN affines, which the port keeps "
            "as frozen buffers"
        )
    trainable = []
    for name, p in model.named_parameters():
        frozen = is_frozen_path(tuple(name.split(".")), fixed)
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append(p)
    return MXNetSGD(trainable, lr_schedule, t.MOMENTUM, t.WD, t.CLIP_GRADIENT)


def make_train_step(model: nn.Module, optimizer: MXNetSGD, rng: int = 0):
    """``step(batch, draws=None) → (loss, aux)``: forward in train mode,
    backward, one optimizer update.  ``batch`` holds device tensors
    ``images``, ``im_info``, ``gt_boxes``, ``gt_valid`` and, optionally,
    host ``sample_seeds``; the samplers' seed is ``fold_in(rng, update
    count)``, as the JAX step folds its step into the sampling key, unless
    ``draws`` hands them their uniforms.  ``aux`` gains ``loss``; its values
    stay on the device."""

    def step(batch: Dict, draws: Optional[Dict[str, torch.Tensor]] = None):
        optimizer.zero_grad()
        loss, aux = model(
            batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
            train=True, sample_seeds=batch.get("sample_seeds"),
            rng=fold_in(rng, optimizer.count), draws=draws,
        )
        loss.backward()
        optimizer.step()
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        return loss.detach(), aux

    return step
