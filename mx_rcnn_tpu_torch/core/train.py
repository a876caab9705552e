"""Trainer pieces: parameter freezing, MXNet-semantics SGD, the piecewise
learning-rate schedule, the train state and the train step (port of
``mx_rcnn_tpu/core/train.py``).

Optimizer semantics follow MXNet SGD, as the JAX package's optax chain:
each gradient clipped element-wise to ±CLIP_GRADIENT, weight decay added to
the gradient before the momentum, momentum 0.9 without dampening, then
``−lr·trace``; frozen tensors (FIXED_PARAMS) get no update and no decay.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

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
    def step(self, lr_scale: Optional[float] = None) -> None:
        """One update; ``lr_scale`` multiplies this update's learning rate
        only (the guarded loop's LR backoff on a retry).  The JAX step scales
        the update ``−lr·trace`` after the momentum trace, so scaling the
        group's lr for one ``sgd.step()`` is the same arithmetic, and the
        momentum buffers are untouched by it."""
        torch.nn.utils.clip_grad_value_(self.params, self.clip)
        lr = self.schedule(self.count)
        if lr_scale is not None:
            lr = lr * lr_scale
        for group in self.sgd.param_groups:
            group["lr"] = lr
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


class TrainSnapshot:
    """An owned copy of everything a step changes: the trainable
    parameters, every momentum buffer (``None`` before a parameter's first
    update) and the update count, which the samplers' seed folds in.  The
    copies stay on the parameters' device."""

    def __init__(self, state: "TrainState"):
        self.state = state
        self.params = [torch.empty_like(p) for p in state.optimizer.params]
        self.momenta: List[Optional[torch.Tensor]] = [None] * len(self.params)
        self.count = 0

    @torch.no_grad()
    def fill(self) -> "TrainSnapshot":
        """Copy the live state in: one ``_foreach_copy_`` for the parameters
        and one for the momentum buffers, queued on the current stream (no
        synchronisation; a later step on the stream runs after them)."""
        opt = self.state.optimizer
        torch._foreach_copy_(self.params, opt.params)
        dst, src = [], []
        for i, p in enumerate(opt.params):
            buf = opt.sgd.state[p].get("momentum_buffer")
            if buf is None:
                self.momenta[i] = None
                continue
            if self.momenta[i] is None:
                self.momenta[i] = torch.empty_like(buf)
            dst.append(self.momenta[i])
            src.append(buf)
        if dst:
            torch._foreach_copy_(dst, src)
        self.count = opt.count
        return self

    @torch.no_grad()
    def restore(self) -> "TrainState":
        """Write the snapshot back into its live state and return the state:
        a replay from here draws the same samples as the first run did."""
        opt = self.state.optimizer
        torch._foreach_copy_(opt.params, self.params)
        dst, src = [], []
        for p, snap in zip(opt.params, self.momenta):
            st = opt.sgd.state[p]
            if snap is None:
                st.pop("momentum_buffer", None)
            elif st.get("momentum_buffer") is None:
                st["momentum_buffer"] = snap.clone()
            else:
                dst.append(st["momentum_buffer"])
                src.append(snap)
        if dst:
            torch._foreach_copy_(dst, src)
        opt.count = self.count
        return self.state

    def host(self) -> Dict:
        """The snapshot as a host tree (a watchdog dump reads this)."""
        names = self.state.names
        return {
            "params": {n: t.detach().cpu() for n, t in zip(names, self.params)},
            "momentum": {n: None if t is None else t.detach().cpu()
                         for n, t in zip(names, self.momenta)},
            "count": self.count,
        }


class TrainState:
    """The port's train state (the role of ``create_train_state``'s
    ``TrainState``): the model and its optimizer, mutated in place by
    :func:`train_step`.  ``snapshot(into)`` gives an owned copy of what a
    step changes, into ``into``'s buffers when it is a snapshot of this
    state (no new allocation, no synchronisation)."""

    def __init__(self, model: nn.Module, optimizer: MXNetSGD):
        self.model = model
        self.optimizer = optimizer
        ids = {id(p) for p in optimizer.params}
        self.names = [n for n, p in model.named_parameters() if id(p) in ids]

    @property
    def step(self) -> int:
        return self.optimizer.count

    def snapshot(self, into: Optional[TrainSnapshot] = None) -> TrainSnapshot:
        if into is None or into.state is not self:
            into = TrainSnapshot(self)
        return into.fill()


def create_train_state(model: nn.Module, optimizer: MXNetSGD) -> TrainState:
    return TrainState(model, optimizer)


def train_step(state: TrainState, batch: Dict, rng: int, lr_scale: Optional[float] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None):
    """One train step, the JAX step's contract: ``(state, aux)``, the state
    updated in place.  Forward in train mode, backward, one optimizer update
    (``lr_scale`` scales this update only).  ``batch`` holds device tensors
    ``images``, ``im_info``, ``gt_boxes``, ``gt_valid``, for a mask network
    ``gt_masks`` and, optionally, host ``sample_seeds``; the samplers' seed
    is ``fold_in(rng, update count)``, as the JAX step folds its step into
    the sampling key, unless ``draws`` hands them their uniforms.  ``aux``
    gains ``loss``; its values stay on the device."""
    model, optimizer = state.model, state.optimizer
    optimizer.zero_grad()
    # the batch's keys are the model's arguments, as in the JAX step
    masks = {"gt_masks": batch["gt_masks"]} if "gt_masks" in batch else {}
    loss, aux = model(
        batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
        train=True, sample_seeds=batch.get("sample_seeds"),
        rng=fold_in(rng, optimizer.count), draws=draws, **masks,
    )
    loss.backward()
    optimizer.step(lr_scale)
    aux = {k: v.detach() for k, v in aux.items()}
    aux["loss"] = loss.detach()
    return state, aux
