"""Elastic data parallelism: shrink onto the surviving ranks mid-run and
regrow later (port of ``mx_rcnn_tpu/parallel/elastic.py``).

A static data-parallel run (``parallel/mesh.py``) dies whole when one rank's
device is lost or its collective wedges.  Here the set of ranks is a
*membership*:

- :class:`MeshMonitor`: replica bookkeeping.  A dead or wedged replica
  surfaces as the step's dispatch raising: injected deterministically
  (``MX_RCNN_FAULTS`` ``device_lost@STEP.REPLICA`` /
  ``device_wedge@STEP.REPLICA:DUR``) or a real ``torch.distributed``
  backend error.  Health probes for regrow come from
  ``faults.down_replicas``, a pure function of (spec, step), and regrow is
  gated by a circuit breaker counted in checkpoint boundaries.
- :class:`ElasticLoop`: wraps the :class:`PipelinedLoop`.  On a device
  fault it discards the window's unverified aux, writes an **emergency
  committed checkpoint** from the window's anchor, rebuilds the execution
  context over the survivors (the step divides by the group's size read at
  call time), re-places the state from the anchor and replays the window,
  poison step included, at the same stream coordinates: bit-identical to a
  fresh run started on the survivors from that checkpoint, since the
  samplers fold the restored update count and :func:`take_replica_rows`
  makes the batch a function of the survivor COUNT.
- :func:`make_elastic_factory`: the real context for an active set: a group
  over the active ranks, the DP step over it, state placement as a
  broadcast and batch placement as this rank's rows of the kept prefix.

The port runs one process a rank.  Every rank runs the same loop: the
injected faults, the monitor's decisions and the survivor set
(:func:`distributed.agree_on_down`) are the same on every rank, and every
rank calls ``dist.new_group`` for each rebuilt set, in the same order.  A
rank the monitor marked down stays in its loop as a **spectator**: it
consumes the same batches, so its stream index stays in step, dispatches
nothing, counts nothing as diverged, takes part in the regrow decision and
the group rebuild at each checkpoint boundary, and on regrow receives the
state by broadcast from a rank that held it.

So a lost rank is one the injector marks down: its process lives on.  A
rank whose process really dies cannot be survived: the process group and
every group made from it keep the dead member, and only a new world could
drop it.  The survivors' next collective fails (over gloo as soon as the
dead peer's sockets close; over NCCL at the collective's timeout,
``distributed.TIMEOUT_S``), the agreement on the lost ranks fails with it,
and :class:`NoSurvivorsError` ends the run, as the JAX package's loop does
for a real fault whose victim it cannot identify.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

from mx_rcnn_tpu_torch.core.pipeline import PipelinedLoop
from mx_rcnn_tpu_torch.core.resilience import (
    DivergencePolicy,
    StepWatchdog,
    restore_snapshot,
    take_snapshot,
)
from mx_rcnn_tpu_torch.parallel import distributed
from mx_rcnn_tpu_torch.utils import faults

logger = logging.getLogger(__name__)


class NoSurvivorsError(RuntimeError):
    """A device fault left no replicas to shrink onto (or the victim could
    not be identified): the run cannot continue degraded."""


@dataclass(frozen=True)
class ElasticContext:
    """What executes one active set: the step, state placement (equal
    states on the set's ranks), batch placement (the kept prefix of the
    base-size global batch, then this rank's rows).  ``member`` is False on
    a spectator, which dispatches nothing."""

    active: Tuple[int, ...]
    step_fn: Optional[Callable]
    place_state: Callable[[Any], Any]
    place_batch: Callable[[Any], Any]
    mesh: Any = None
    member: bool = True


# words in a torch.distributed backend or network error that name what failed
_COLLECTIVE_WORDS = ("peer", "collective", "nccl", "gloo", "timed out", "timeout")


def classify_device_fault(exc: BaseException):
    """``(kind, victim_ordinal_or_None)`` when ``exc`` is a device-level
    failure the elastic loop absorbs, else None (divergence, the watchdog,
    another phase's injection: it propagates).  Recognised: the injector's
    :class:`~mx_rcnn_tpu_torch.utils.faults.InjectedDeviceFault`, and a
    ``torch.distributed`` backend or network error (a ``DistError``, or a
    gloo / NCCL ``RuntimeError``) whose message names a peer, a collective,
    NCCL, gloo or a timeout; a real one names no victim."""
    if isinstance(exc, faults.InjectedDeviceFault):
        return exc.fault_kind, exc.replica
    msg = str(exc).lower()
    backend_error = isinstance(exc, dist.DistError) or (
        isinstance(exc, RuntimeError) and any(t in msg for t in ("gloo", "nccl", "c10d")))
    if backend_error and any(t in msg for t in _COLLECTIVE_WORDS):
        return "device_lost", None
    return None


@dataclass(frozen=True)
class RegrowPolicy:
    """Circuit breaker for re-expansion, counted in checkpoint BOUNDARIES
    (deterministic run coordinates).  A "flap" is a shrink within
    ``flap_window`` boundaries of a regrow; each doubles the boundary
    cooldown, up to ``max_backoff``."""

    cooldown: int = 1
    flap_window: int = 8
    max_backoff: int = 8


class MeshMonitor:
    """Replica membership, health probing and the regrow breaker.
    ``probe_fn(step) -> iterable of down ordinals`` defaults to the
    deterministic ``faults.down_replicas``."""

    def __init__(
        self,
        n_replicas: int,
        policy: Optional[RegrowPolicy] = None,
        probe_fn: Optional[Callable[[int], Sequence[int]]] = None,
    ):
        self.base = tuple(range(int(n_replicas)))
        self.active = self.base
        self.policy = policy or RegrowPolicy()
        self._probe = probe_fn or (lambda step: faults.down_replicas(step))
        self.transitions: List[Dict[str, Any]] = []
        self.boundaries = 0
        self.shrinks = 0
        self.regrows = 0
        self.flaps = 0
        self._last_shrink_boundary: Optional[int] = None
        self._last_regrow_boundary: Optional[int] = None
        self._last_flap_boundary: Optional[int] = None
        self._backoff = self.policy.cooldown

    @property
    def degraded(self) -> bool:
        return len(self.active) < len(self.base)

    def probe_down(self, step: int) -> frozenset:
        """Base ordinals reported down at stream position ``step``."""
        return frozenset(int(r) for r in self._probe(step))

    def note_shrink(self, step: int, lost, kind: str) -> None:
        survivors = tuple(o for o in self.active if o not in lost)
        if not survivors:
            raise NoSurvivorsError(f"step {step}: {sorted(lost)} lost and no replicas remain")
        self.active = survivors
        self.shrinks += 1
        if (self._last_regrow_boundary is not None
                and self.boundaries - self._last_regrow_boundary <= self.policy.flap_window):
            # it rejoined at a boundary and died again: double the cooldown
            self.flaps += 1
            self._last_flap_boundary = self.boundaries
            self._backoff = min(self._backoff * 2, self.policy.max_backoff)
        self._last_shrink_boundary = self.boundaries
        self.transitions.append({"step": step, "event": "shrink", "kind": kind,
                                 "lost": sorted(int(o) for o in lost),
                                 "active": list(self.active)})

    def note_boundary(self) -> None:
        self.boundaries += 1
        if (self._last_flap_boundary is not None
                and self.boundaries - self._last_flap_boundary > self.policy.flap_window):
            # the flap history aged out: the breaker closes back down
            self._last_flap_boundary = None
            self._backoff = self.policy.cooldown

    def want_regrow(self, step: int) -> Optional[Tuple[int, ...]]:
        """The target active set when a regrow is allowed at this boundary,
        else None (still down, or the breaker is open)."""
        missing = set(self.base) - set(self.active)
        if not missing:
            return None
        back = missing - self.probe_down(step)
        if not back:
            return None
        if (self._last_shrink_boundary is not None
                and self.boundaries - self._last_shrink_boundary < self._backoff):
            return None
        return tuple(sorted(set(self.active) | back))

    def note_regrow(self, step: int, active: Tuple[int, ...]) -> None:
        self.active = tuple(sorted(active))
        self.regrows += 1
        self._last_regrow_boundary = self.boundaries
        self.transitions.append({"step": step, "event": "regrow", "active": list(self.active)})

    def stats(self) -> Dict[str, Any]:
        return {
            "base_replicas": len(self.base),
            "active_replicas": len(self.active),
            "shrinks": self.shrinks,
            "regrows": self.regrows,
            "flaps": self.flaps,
            "boundaries": self.boundaries,
            "transitions": list(self.transitions),
        }


class ElasticLoop:
    """A :class:`PipelinedLoop` that survives device loss (injected, in
    the port: see the module docstring).

    ``factory(active) -> ElasticContext`` builds the context for an active
    tuple; the loop rebuilds it at every membership change.
    ``checkpoint_fn(anchor, stream_step, meta)`` (optional) writes the
    emergency committed checkpoint on a shrink and returns its path; the
    anchor is the window's snapshot (a ``TrainSnapshot``, whose ``tree()``
    is the checkpoint's tree, or a host tree).

    Recovery: a fault at stream step S in a window anchored at W re-executes
    steps [W, S] on the survivors; at ``aux_interval=1`` the anchor is the
    poison step, so only it runs again.  Call :meth:`flush`, then
    :meth:`checkpoint_boundary`, wherever the trainer checkpoints: regrow
    happens only there, behind the monitor's breaker."""

    def __init__(
        self,
        factory: Callable[[Tuple[int, ...]], ElasticContext],
        n_replicas: int,
        *,
        policy: Optional[DivergencePolicy] = None,
        watchdog: Optional[StepWatchdog] = None,
        aux_interval: int = 1,
        regrow: Optional[RegrowPolicy] = None,
        monitor: Optional[MeshMonitor] = None,
        checkpoint_fn: Optional[Callable[[Any, int, Dict], Optional[str]]] = None,
        agree_fn: Optional[Callable[[Any], frozenset]] = None,
    ):
        self.factory = factory
        self.monitor = monitor or MeshMonitor(n_replicas, policy=regrow)
        self.ctx = factory(self.monitor.active)
        # snapshot_every=1: exact per-step snapshots keep the divergence
        # retry's rollback exact (the elastic anchor is the loop's own)
        self.pipe = PipelinedLoop(self.ctx.step_fn, policy=policy, watchdog=watchdog,
                                  snapshot_every=1, place_fn=self.ctx.place_state,
                                  aux_interval=aux_interval)
        self._ckpt = checkpoint_fn
        self._agree = agree_fn or (lambda down: distributed.agree_on_down(down, n_replicas))
        # dispatched but unverified (idx, host batch, rng): replayable
        # against the anchor
        self._window: List[Tuple[int, Any, Any]] = []
        self._anchor: Any = None
        self._anchor_buf: Any = None  # the buffers every anchor reuses
        self._anchor_idx = 0
        self.emergency_ckpts: List[str] = []
        self.replayed_steps = 0
        self.recovery_s = 0.0
        self.last_recovery_s = 0.0

    @property
    def active(self) -> Tuple[int, ...]:
        return self.monitor.active

    @property
    def degraded(self) -> bool:
        return self.monitor.degraded

    def _take_anchor(self, state, idx: int) -> None:
        self._anchor_buf = take_snapshot(state, self._anchor_buf, idx)
        self._anchor, self._anchor_idx = self._anchor_buf, idx

    # -- stepping
    def step(self, state, batch, rng):
        """One guarded elastic step, :class:`PipelinedLoop`'s ``(state,
        ready, ok)`` contract.  ``batch`` is the HOST global batch at the
        base size: it is placed here, so a replay places it against the
        current set."""
        if not self._window and self.ctx.member:
            # the anchor: an owned copy of the state BEFORE the window
            self._take_anchor(state, self.pipe.next_index)
        self._window.append((self.pipe.next_index, batch, rng))
        return self._drain(state, len(self._window) - 1)

    def flush(self, state):
        """Flush the pipeline window (epoch end, before a checkpoint)."""
        try:
            state, ready, ok = self.pipe.flush(state)
        except Exception as e:  # noqa: BLE001 — classified below
            got = classify_device_fault(e)
            if got is None:
                raise
            self.replayed_steps += len(self._window)
            state = self._shrink(state, got[0], got[1], at_step=self.pipe.next_index)
            state, ready, ok = self._drain(state, 0)
            state, r2, ok2 = self.pipe.flush(state)
            ready, ok = ready + r2, ok and ok2
        if self.pipe.pending == 0:
            self._window.clear()
        return state, ready, ok

    def _drain(self, state, start: int):
        """Dispatch window entries from position ``start``; on a device
        fault, shrink and restart from the anchor (position 0)."""
        ready_out: List[Tuple[int, Dict]] = []
        ok_out = True
        i = start
        while i < len(self._window):
            idx, batch, rng = self._window[i]
            try:
                # the injected heartbeat: a dead replica fails its step
                faults.device_fault(idx, active=self.monitor.active)
                if self.ctx.member:
                    state, ready, ok = self.pipe.step(state, self.ctx.place_batch(batch), rng)
                else:
                    # a spectator keeps its stream index in step
                    self.pipe.rewind(idx + 1)
                    ready, ok = [], True
            except Exception as e:  # noqa: BLE001 — classified below
                got = classify_device_fault(e)
                if got is None:
                    raise
                self.replayed_steps += i
                state = self._shrink(state, got[0], got[1], at_step=idx)
                i = 0
                continue
            ready_out.extend(ready)
            ok_out = ok_out and ok
            i += 1
        if self.pipe.pending == 0:
            self._window.clear()
        return state, ready_out, ok_out

    # -- membership changes
    def _rebuild(self, active: Tuple[int, ...]) -> None:
        self.ctx = self.factory(active)
        self.pipe.rebind(self.ctx.step_fn, self.ctx.place_state)

    def _shrink(self, state, kind: str, victim: Optional[int], at_step: int):
        t0 = time.perf_counter()
        down = ({victim} if victim is not None
                else set(self.monitor.probe_down(at_step)) & set(self.monitor.active))
        try:
            down = self._agree(down)
        except Exception as e:  # noqa: BLE001 — classified below
            if classify_device_fault(e) is None:
                raise
            # a rank that really died: its peers cannot agree without it
            raise NoSurvivorsError(
                f"step {at_step}: {kind}, and the ranks could not agree on the lost ones "
                f"({e}): a rank's process died, which a process group cannot survive") from e
        if not down:
            raise NoSurvivorsError(
                f"step {at_step}: {kind} with unidentifiable victim — cannot choose a survivor set")
        prev = self.monitor.active
        self.monitor.note_shrink(at_step, down, kind)
        logger.warning(
            "elastic: %s at step %d — lost replica(s) %s; shrinking %s -> %s and replaying the "
            "window from step %d", kind, at_step, sorted(down), list(prev),
            list(self.monitor.active), self._anchor_idx)
        # the emergency committed checkpoint, from the anchor: its stream
        # position is where a restarted run resumes
        if self._ckpt is not None:
            path = self._ckpt(self._anchor, self._anchor_idx,
                              {"event": "shrink", "kind": kind,
                               "lost": sorted(int(o) for o in down), "step": at_step,
                               "active": list(self.monitor.active)})
            if path:
                self.emergency_ckpts.append(path)
        self._rebuild(self.monitor.active)
        self.pipe.rewind(self._anchor_idx)
        state = self.ctx.place_state(self._anchor)
        dt = time.perf_counter() - t0
        self.last_recovery_s = dt
        self.recovery_s += dt
        return state

    def checkpoint_boundary(self, state, step: Optional[int] = None):
        """Count a checkpoint boundary and regrow when allowed.  Call AFTER
        :meth:`flush`.  Returns ``(state, regrown)``; on regrow every rank of
        the new set holds the state of a rank that held it."""
        if self.pipe.pending:
            raise RuntimeError("checkpoint_boundary called with a pending pipeline window — "
                               "flush first")
        self.monitor.note_boundary()
        step = self.pipe.next_index if step is None else step
        target = self.monitor.want_regrow(step)
        if target is None:
            return state, False
        t0 = time.perf_counter()
        self._take_anchor(state, step)
        prev = self.monitor.active
        self._rebuild(target)
        self.pipe.rewind(self.pipe.next_index)
        state = self.ctx.place_state(self._anchor)
        self.monitor.note_regrow(step, target)
        self._window.clear()
        dt = time.perf_counter() - t0
        self.last_recovery_s = dt
        self.recovery_s += dt
        logger.info("elastic: regrow at boundary %d (step %d): %s -> %s",
                    self.monitor.boundaries, step, list(prev), list(target))
        return state, True

    # -- reporting
    def stats(self) -> Dict[str, Any]:
        return {
            **self.monitor.stats(),
            "replayed_steps": self.replayed_steps,
            "emergency_checkpoints": len(self.emergency_ckpts),
            "recovery_s": round(self.recovery_s, 4),
            "pipeline": self.pipe.stats(),
        }


def make_elastic_factory(
    *,
    ranks: Optional[Sequence[int]] = None,
    device=None,
    accum_steps: int = 1,
) -> Callable[[Tuple[int, ...]], ElasticContext]:
    """The real context for :class:`ElasticLoop`.  ``ranks`` fixes the base
    ordinal → rank assignment (default: every rank); ``factory(active)``
    makes a group over those ranks (``dist.new_group``, called by every
    rank, in the same order), the DP step over it (its all-reduce divides by
    the group's size at call time), ``place_state`` (a snapshot or a state
    restored, then broadcast from the lowest rank that held the state: the
    lowest survivor after a shrink, the lowest rank of the old set after a
    regrow) and ``place_batch`` (:func:`take_replica_rows`, then this rank's
    rows by its position in ``active``)."""
    from mx_rcnn_tpu_torch.parallel.mesh import (
        make_mesh,
        make_parallel_train_step,
        replicate,
        shard_batch,
        take_replica_rows,
    )

    ranks = (tuple(range(distributed.process_count())) if ranks is None
             else tuple(int(r) for r in ranks))
    n_base = len(ranks)
    held: Dict[str, Optional[Tuple[int, ...]]] = {"active": None}

    def factory(active: Tuple[int, ...]) -> ElasticContext:
        active = tuple(int(o) for o in active)
        before = held["active"]
        source = ranks[min(active if before is None else [o for o in active if o in before])]
        held["active"] = active
        mesh = make_mesh(ranks=[ranks[o] for o in active], device=device)
        step_fn = make_parallel_train_step(mesh, accum_steps) if mesh.member else None

        def place_state(tree):
            return replicate(restore_snapshot(tree), mesh, src=source)

        def place_batch(batch):
            return shard_batch(take_replica_rows(batch, len(active), n_base), mesh)

        return ElasticContext(active=active, step_fn=step_fn, place_state=place_state,
                              place_batch=place_batch, mesh=mesh, member=mesh.member)

    return factory
