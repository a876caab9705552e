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
from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm


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
    fixed_params: Optional[Sequence[str]] = None,
    train_bn_affines: bool = False,
) -> MXNetSGD:
    """Freeze ``model``'s tensors of the freeze set (``requires_grad`` off,
    so no gradient is computed for them) and return the MXNet SGD over the
    rest.  The set is ``fixed_params`` when given (the later stages of
    alternate training freeze FIXED_PARAMS_SHARED), else
    ``cfg.network.FIXED_PARAMS``.

    The frozen BN affines are buffers here (``models/layers.py``): a freeze
    set that leaves one of the model's BNs out (a ResNet set without
    ``"bn"``) has the JAX package train its ``scale`` / ``bias``, so it
    raises, unless ``train_bn_affines`` makes those BNs' affines trainable
    parameters (``FrozenBatchNorm.thaw_affine``; the integration gate's
    empty freeze set).  A model with no BN (VGG-16) trains under any set."""
    t = cfg.TRAIN
    fixed = cfg.network.FIXED_PARAMS if fixed_params is None else tuple(fixed_params)
    thawed_bn = [name for name, m in model.named_modules() if isinstance(m, FrozenBatchNorm)
                 and not is_frozen_path(tuple(name.split(".")) + ("scale",), fixed)]
    if thawed_bn and train_bn_affines:
        modules = dict(model.named_modules())
        for name in thawed_bn:
            modules[name].thaw_affine()
    elif thawed_bn:
        raise NotImplementedError(
            f"FIXED_PARAMS {fixed} trains the BN affines of {thawed_bn[:3]} "
            f"(+{max(len(thawed_bn) - 3, 0)}), which the port keeps as frozen buffers"
        )
    trainable = []
    for name, p in model.named_parameters():
        frozen = is_frozen_path(tuple(name.split(".")), fixed)
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append(p)
    return MXNetSGD(trainable, lr_schedule, t.MOMENTUM, t.WD, t.CLIP_GRADIENT)


def _host(t: torch.Tensor) -> torch.Tensor:
    """An owned host copy of a tensor (from a card, a blocking copy)."""
    return t.detach().to("cpu", copy=True)


class _HostMirror:
    """One host copy of a snapshot: the trainable tensors and momentum
    buffers (pinned when they come from a card, so the copy is queued), the
    update count and the stream index the snapshot stands for.  The buffers
    are allocated once; ``has_momentum`` says which momenta this copy holds.
    ``seq`` numbers the copies, -1 while one is being queued; ``event``
    completes with the copy (None: it was made synchronously)."""

    def __init__(self):
        self.params: List[torch.Tensor] = []
        self.momenta: List[Optional[torch.Tensor]] = []
        self.has_momentum: List[bool] = []
        self.count = self.index = 0
        self.event = None
        self.seq = -1

    def complete(self) -> bool:
        return self.seq >= 0 and (self.event is None or self.event.query())


def _host_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(tuple(t.shape), t.stride(), dtype=t.dtype, device="cpu",
                               pin_memory=t.is_cuda)


class TrainSnapshot:
    """An owned copy of everything a step changes: the trainable
    parameters, every momentum buffer (``None`` before a parameter's first
    update) and the update count, which the samplers' seed folds in, with
    ``index``, the stream index of the first step it does not hold.  The
    copies stay on the parameters' device.

    When its state mirrors snapshots (:meth:`TrainState.mirror_snapshots`),
    every fill also queues a copy of the snapshot to the host, on a side
    stream on a card, into one of two mirrors: the one still being copied
    if there is one, else the older.  The newest complete mirror is never
    written, so :meth:`host` always has one to give while the card is
    hung."""

    def __init__(self, state: "TrainState"):
        self.state = state
        self.params = [torch.empty_like(p) for p in state.optimizer.params]
        self.momenta: List[Optional[torch.Tensor]] = [None] * len(self.params)
        self.count = self.index = 0
        self._mirrors = [_HostMirror(), _HostMirror()] if state.mirror else None
        self._seq = 0
        self._stream = None  # the side stream of the host copies (on a card)
        self._copied = None  # the newest host copy's event: it reads self.params

    @torch.no_grad()
    def fill(self, index: int = 0) -> "TrainSnapshot":
        """Copy the live state in: one ``_foreach_copy_`` for the parameters
        and one for the momentum buffers, queued on the current stream (no
        synchronisation; a later step on the stream runs after them).
        ``index`` is the stream index the snapshot stands for."""
        opt = self.state.optimizer
        if self._copied is not None:  # a host copy may still read the buffers
            torch.cuda.current_stream(self.params[0].device).wait_event(self._copied)
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
        self.index = index
        if self._mirrors is not None:
            self._mirror()
        return self

    def _mirror(self) -> None:
        busy = [m for m in self._mirrors if not m.complete()]
        m = busy[0] if busy else min(self._mirrors, key=lambda m: m.seq)
        m.seq = -1  # no reader takes it until this copy completes
        if not m.params:
            m.params = [_host_like(t) for t in self.params]
            m.momenta = [None] * len(self.params)
        for i, t in enumerate(self.momenta):
            if t is not None and m.momenta[i] is None:
                m.momenta[i] = _host_like(t)
        pairs = [(m.params[i], t) for i, t in enumerate(self.params)]
        pairs += [(m.momenta[i], t) for i, t in enumerate(self.momenta) if t is not None]
        if self.params and self.params[0].is_cuda:
            dev = self.params[0].device
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream):
                for d, t in pairs:
                    d.copy_(t, non_blocking=True)
                m.event = self._copied = torch.cuda.Event()
                m.event.record(self._stream)
        else:
            for d, t in pairs:
                d.copy_(t)
            m.event = None
        m.count, m.index = self.count, self.index
        m.has_momentum = [t is not None for t in self.momenta]
        self._seq += 1
        m.seq = self._seq

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

    def tree(self) -> Dict:
        """The snapshot as a whole checkpoint tree on the host (the layout
        of :meth:`TrainState.state_tree`), copied now: its trainable tensors
        and momenta, the live model's frozen tensors and buffers, which no
        step changes.  What an elastic shrink's emergency dump writes."""
        state = self.state
        model = {k: _host(v) for k, v in state.model.state_dict().items()}
        model.update((n, _host(t)) for n, t in zip(state.names, self.params))
        return {"model": model,
                "momentum": {n: None if t is None else _host(t)
                             for n, t in zip(state.names, self.momenta)},
                "count": self.count}

    def host(self) -> Optional[Tuple[int, Dict]]:
        """``(index, tree)`` of the newest complete host mirror, or None:
        the tree a whole checkpoint (the layout of
        :meth:`TrainState.state_tree`), its frozen tensors and buffers from
        the state's host copy of them.  What a watchdog dump writes, from
        its timer thread: it reads host memory only (a mirror's event is
        queried, never waited on), so it completes on a hung card."""
        if self._mirrors is None:
            return None
        names = self.state.names
        for _ in range(len(self._mirrors) + 1):
            done = [m for m in self._mirrors if m.complete()]
            if not done:
                return None
            m = max(done, key=lambda m: m.seq)
            seq = m.seq
            params = [t.clone() for t in m.params]
            momenta = [t.clone() if has else None for t, has in zip(m.momenta, m.has_momentum)]
            count, index = m.count, m.index
            if m.seq != seq:  # queued over while it was read: take the other
                continue
            model = dict(self.state.frozen_host)
            model.update(zip(names, params))
            return index, {"model": model, "momentum": dict(zip(names, momenta)),
                           "count": count}
        return None


class TrainState:
    """The port's train state (the role of ``create_train_state``'s
    ``TrainState``): the model and its optimizer, mutated in place by
    :func:`train_step`.  ``snapshot(into)`` gives an owned copy of what a
    step changes, into ``into``'s buffers when it is a snapshot of this
    state (no new allocation, no synchronisation).  ``state_tree`` /
    ``load_state_tree`` carry the whole state to and from a checkpoint."""

    def __init__(self, model: nn.Module, optimizer: MXNetSGD):
        self.model = model
        self.optimizer = optimizer
        ids = {id(p) for p in optimizer.params}
        self.names = [n for n, p in model.named_parameters() if id(p) in ids]
        self.mirror = False  # snapshots keep host copies (mirror_snapshots)
        self.frozen_host: Dict[str, torch.Tensor] = {}

    @property
    def step(self) -> int:
        return self.optimizer.count

    def state_tree(self) -> Dict:
        """The checkpoint's tree, copied to the host: ``model``, the whole
        ``state_dict`` (the frozen tensors and BN buffers too: a seeded or
        calibrated model cannot be rebuilt without them); ``momentum``, each
        trainable tensor's momentum buffer by name (None before its first
        update); ``count``, the update count (the learning-rate schedule's
        and the samplers' step)."""
        opt = self.optimizer
        return {
            "model": {k: _host(v) for k, v in self.model.state_dict().items()},
            "momentum": {n: None if (buf := opt.sgd.state[p].get("momentum_buffer")) is None
                         else _host(buf) for n, p in zip(self.names, opt.params)},
            "count": opt.count,
        }

    @torch.no_grad()
    def load_state_tree(self, tree: Dict) -> "TrainState":
        """Write a :meth:`state_tree` into the live model and optimizer, in
        place on their device: every ``state_dict`` tensor, the momentum
        buffers (recreated on the parameter's device, with the saved
        buffer's strides, where the tree has one; dropped where it has None)
        and the update count."""
        opt = self.optimizer
        momentum = tree["momentum"]
        if set(momentum) != set(self.names):
            raise ValueError(
                f"the tree's momentum names differ from the trainable tensors: "
                f"{sorted(set(momentum) ^ set(self.names))[:5]}")
        self.model.load_state_dict(tree["model"])
        for n, p in zip(self.names, opt.params):
            st, buf = opt.sgd.state[p], momentum[n]
            if buf is None:
                st.pop("momentum_buffer", None)
                continue
            if tuple(buf.shape) != tuple(p.shape):
                raise ValueError(f"{n}: momentum {tuple(buf.shape)} != parameter {tuple(p.shape)}")
            dst = st.get("momentum_buffer")
            if dst is None or dst.stride() != buf.stride():
                # the saved buffer's strides, which SGD chose: an update's
                # rounding can depend on whether its operands' layouts agree
                dst = st["momentum_buffer"] = torch.empty_strided(
                    tuple(buf.shape), buf.stride(), dtype=p.dtype, device=p.device)
            dst.copy_(buf)
        opt.count = int(tree["count"])
        if self.mirror:
            self._take_frozen()
        return self

    def _take_frozen(self) -> None:
        trainable = set(self.names)
        self.frozen_host = {k: _host(v) for k, v in self.model.state_dict().items()
                            if k not in trainable}

    def mirror_snapshots(self) -> None:
        """Have every snapshot made from now on keep a host copy of itself
        (:meth:`TrainSnapshot.host`), and copy the ``state_dict`` tensors
        no step changes (the frozen parameters and the buffers) to the host
        now, and again at each :meth:`load_state_tree`: a watchdog dump then
        reads no device memory."""
        self.mirror = True
        self._take_frozen()

    def snapshot(self, into: Optional[TrainSnapshot] = None, index: int = 0) -> TrainSnapshot:
        if into is None or into.state is not self:
            into = TrainSnapshot(self)
        return into.fill(index)


def create_train_state(model: nn.Module, optimizer: MXNetSGD) -> TrainState:
    return TrainState(model, optimizer)


def _loss_and_aux(model: nn.Module, batch: Dict, rng: int,
                  draws: Optional[Dict[str, torch.Tensor]]) -> Tuple[torch.Tensor, Dict]:
    # the batch's keys are the model's arguments, as in the JAX step
    extra = {k: batch[k] for k in ("gt_masks", "proposals", "prop_valid") if k in batch}
    return model(
        batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
        train=True, sample_seeds=batch.get("sample_seeds"), rng=rng, draws=draws, **extra,
    )


def train_step(state: TrainState, batch: Dict, rng: int, lr_scale: Optional[float] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None, accum_steps: int = 1,
               reduce: Optional[Callable[[List[torch.Tensor], Dict], Dict]] = None):
    """One train step, the JAX step's contract: ``(state, aux)``, the state
    updated in place.  Forward in train mode, backward, one optimizer update
    (``lr_scale`` scales this update only).  ``batch`` holds device tensors
    ``images``, ``im_info``, ``gt_boxes``, ``gt_valid``, for a mask network
    ``gt_masks``, from a proposal roidb ``proposals`` / ``prop_valid``
    (Fast R-CNN, FPN's frozen mode) and, optionally, host ``sample_seeds``; the samplers' seed
    is ``fold_in(rng, update count)``, as the JAX step folds its step into
    the sampling key, unless ``draws`` hands them their uniforms.  ``aux``
    gains ``loss``; its values stay on the device.

    ``accum_steps`` > 1 splits the batch's leading axis (and ``draws``')
    into that many microbatches, averages their gradients and their aux,
    then makes one update (JAX ``make_train_step(accum_steps=)``).  With
    per-image ``sample_seeds`` each microbatch draws as the unaccumulated
    step does; without them microbatch i folds i into the step's seed.

    ``reduce(params, aux) → aux``, the role of JAX's ``pmean_axis``, runs
    between the last backward and the update on the trainable tensors
    (their ``.grad``) and the aux with ``loss``: the data-parallel step's
    all-reduce (``parallel/mesh.py``).  Without it the step is unchanged."""
    model, optimizer = state.model, state.optimizer
    optimizer.zero_grad()
    seed = fold_in(rng, optimizer.count)
    if accum_steps == 1:
        loss, aux = _loss_and_aux(model, batch, seed, draws)
        loss.backward()
    else:
        b = batch["images"].shape[0]
        if b % accum_steps:
            raise ValueError(f"a batch of {b} images does not split into {accum_steps} microbatches")
        m = b // accum_steps
        losses, auxes = [], []
        for i in range(accum_steps):
            part = slice(i * m, (i + 1) * m)
            micro = {k: v[part] for k, v in batch.items()}
            mseed = seed if "sample_seeds" in batch else fold_in(seed, i)
            mdraws = None if draws is None else {k: v[part] for k, v in draws.items()}
            mloss, maux = _loss_and_aux(model, micro, mseed, mdraws)
            # the gradients add up in .grad: their mean is the sum of loss / n's
            (mloss / accum_steps).backward()
            losses.append(mloss.detach())
            auxes.append(maux)
        loss = torch.stack(losses).mean()
        aux = {k: torch.stack([a[k].detach().float() for a in auxes]).mean(0) for k in auxes[0]}
    if reduce is not None:
        aux = reduce(optimizer.params, {**aux, "loss": loss})
        optimizer.step(lr_scale)
        return state, {k: v.detach() for k, v in aux.items()}
    optimizer.step(lr_scale)
    aux = {k: v.detach() for k, v in aux.items()}
    aux["loss"] = loss.detach()
    return state, aux
