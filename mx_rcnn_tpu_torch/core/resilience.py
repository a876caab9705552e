"""Resilience layer: guarded train loop, retry policy, step watchdog (port
of ``mx_rcnn_tpu/core/resilience.py``).

- :class:`GuardedLoop`: wraps a train ``step_fn``; per-step finite-loss and
  loss-spike checks on the fetched aux, retry with exponential LR backoff,
  rollback to the last good snapshot and skip past the poison batch, with a
  bad-batch budget so silent divergence cannot pass for training.
- :class:`StepWatchdog`: wall-clock timer per step; on expiry it runs the
  caller's dump and aborts the process with :data:`WATCHDOG_EXIT_CODE`.
- :class:`RetryPolicy` / :func:`make_retry_policy`: the bounded
  deterministic retry and its per-site presets ("loader", "serve",
  "replica"), kept in ``utils/retry.py`` (free of torch, for the loader's
  assembly processes) and re-exported here as the JAX module does.

The loops are written for the JAX package's functional contract,
``step_fn(state, batch, rng[, lr_scale]) → (state, aux)``.  The port's
``TrainState`` (``core/train.py``) is mutated in place and returned, so a
rollback cannot reuse the caller's state: the loops keep a snapshot that
owns its memory.  A state with a ``snapshot(into)`` method (``TrainState``)
takes it on its device, into the buffers of the snapshot it replaces, with
no synchronisation; any other tree of tensors is copied to the host
(:func:`host_copy`).  A snapshot with a ``restore()`` method writes itself
back into its state; a host tree is handed to the step as it is.

Fault injection for all of these lives in ``utils/faults.py``.
"""

from __future__ import annotations

import faulthandler
import inspect
import logging
import os
import sys
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mx_rcnn_tpu_torch.models.faster_rcnn import fold_in
from mx_rcnn_tpu_torch.utils import faults
from mx_rcnn_tpu_torch.utils.retry import RETRY_PRESETS, RetryPolicy, make_retry_policy  # noqa: F401

logger = logging.getLogger(__name__)

# exit status of a watchdog abort: 75 = EX_TEMPFAIL ("try again later"),
# distinct from timeout(1)'s 124
WATCHDOG_EXIT_CODE = 75

# exit status of a run that finished, but degraded: an elastic run that ended
# on fewer ranks than it started with (parallel/elastic.py), so a scheduler
# can reschedule it at full size
DEGRADED_EXIT_CODE = 76


class TrainingDiverged(RuntimeError):
    """Raised when the bad-batch budget is exhausted: the run is not
    recovering by skipping, so continuing would silently train garbage."""


def host_copy(tree):
    """Host-side copy of a tree (dicts, lists, tuples) of tensors and arrays
    that owns its memory: a later in-place step cannot change it."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return np.array(tree)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def take_snapshot(state, reuse=None, index: int = 0):
    """An owned copy of ``state``: on its device into ``reuse``'s buffers
    when the state knows how (``TrainState.snapshot``, which notes the
    stream ``index`` it stands for), else on the host."""
    take = getattr(state, "snapshot", None)
    return take(reuse, index) if take is not None else host_copy(state)


def restore_snapshot(snap):
    """The state a snapshot stands for: written back into its live state
    when it can (``TrainSnapshot.restore``), else the host tree itself."""
    back = getattr(snap, "restore", None)
    return back() if back is not None else snap


def snapshot_on_host(snap, index: int):
    """``(stream index, host tree)`` of a snapshot, or None (what a watchdog
    dump reads): a snapshot with a host mirror gives its newest complete one
    and the index it was taken at (``TrainSnapshot.host``, None without a
    mirror); a host tree is its own, taken at ``index``."""
    if snap is None:
        return None
    host = getattr(snap, "host", None)
    return host() if host is not None else (index, snap)


def fetch_host(trees: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """One batched device → host copy of a list of aux dicts: every tensor
    value flattened into one float32 vector, one ``.cpu()``.  A value of one
    element comes back as a Python float, a larger one as a numpy array, a
    non-tensor value as it was."""
    tensors = [v.detach().reshape(-1).to(torch.float32) for t in trees for v in t.values()
               if isinstance(v, torch.Tensor)]
    host = torch.cat(tensors).cpu().numpy() if tensors else None
    out, pos = [], 0
    for t in trees:
        got = {}
        for k, v in t.items():
            if not isinstance(v, torch.Tensor):
                got[k] = v
                continue
            n = v.numel()
            got[k] = float(host[pos]) if n == 1 else host[pos:pos + n].reshape(tuple(v.shape))
            pos += n
        out.append(got)
    return out


class StepWatchdog:
    """Wall-clock guard for a single train step.

    Arm before the step, disarm after; if the step wedges, the timer thread
    runs the caller's ``dump_fn`` and ``os._exit``s with a distinct code
    instead of hanging until an external ``timeout -k``.  A thread timer,
    not SIGALRM: a signal is only delivered at a bytecode boundary, which
    never comes while the main thread waits inside native code.  ``dump_fn``
    runs in the timer thread and must not touch the (possibly wedged)
    device."""

    def __init__(
        self,
        timeout: float,
        dump_fn: Optional[Callable[[], Any]] = None,
        exit_code: int = WATCHDOG_EXIT_CODE,
        exit_fn: Optional[Callable[[int], None]] = None,
    ):
        self.timeout = float(timeout)
        self.dump_fn = dump_fn
        self.exit_code = exit_code
        self._exit = exit_fn if exit_fn is not None else os._exit
        self._timer: Optional[threading.Timer] = None

    def arm(self, tag: str = "") -> None:
        self.disarm()
        t = threading.Timer(self.timeout, self._expired, args=(tag,))
        t.daemon = True
        t.start()
        self._timer = t

    def disarm(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _expired(self, tag: str) -> None:
        sys.stderr.write(
            f"\n=== StepWatchdog: step {tag or '?'} exceeded {self.timeout:.1f}s — dumping "
            f"and aborting (exit {self.exit_code}) ===\n"
        )
        try:
            if self.dump_fn is not None:
                path = self.dump_fn()
                if path:
                    sys.stderr.write(f"watchdog dump -> {path}\n")
        except Exception as e:  # noqa: BLE001 — must still exit
            sys.stderr.write(f"watchdog dump failed: {e!r}\n")
        faulthandler.dump_traceback(file=sys.stderr)
        sys.stderr.flush()
        self._exit(self.exit_code)


@dataclass(frozen=True)
class DivergencePolicy:
    """What the guarded loop does when a step's loss is NaN/Inf or spikes
    above ``spike_factor ×`` the running EMA: retry ``retries`` times from
    the last snapshot, each with a fresh sampling rng and the step's LR
    scaled by ``lr_backoff**attempt``; then roll back and skip the batch.
    More than ``max_bad_batches`` skips raise :class:`TrainingDiverged`."""

    retries: int = 2
    lr_backoff: float = 0.5
    spike_factor: float = 20.0
    ema_decay: float = 0.9
    warmup_steps: int = 5
    max_bad_batches: int = 8


def supports_lr_scale(fn) -> bool:
    try:
        return "lr_scale" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


class GuardedLoop:
    """Wrap a train step with divergence recovery::

        guard = GuardedLoop(step_fn, policy=DivergencePolicy())
        for batch in loader:
            state, aux, ok = guard.step(state, batch, rng)
            if not ok:      # batch skipped after rollback
                continue

    The loop keeps a snapshot refreshed every ``snapshot_every`` accepted
    steps, taken before the step, and restores from it (``place_fn``, by
    default :func:`restore_snapshot`).  A rollback loses at most
    ``snapshot_every - 1`` steps of progress; the default 1 is exact."""

    def __init__(
        self,
        step_fn: Callable,
        policy: Optional[DivergencePolicy] = None,
        watchdog: Optional[StepWatchdog] = None,
        snapshot_every: int = 1,
        place_fn: Optional[Callable[[Any], Any]] = None,
    ):
        self._step_fn = step_fn
        self.policy = policy or DivergencePolicy()
        self.watchdog = watchdog
        self.snapshot_every = max(1, int(snapshot_every))
        self._place = place_fn or restore_snapshot
        self._lr_scale_ok = supports_lr_scale(step_fn)
        self._snapshot = None
        self._snapshot_index = 0  # the stream index of the step it precedes
        self._snap_buf = None  # the buffers every snapshot of this loop reuses
        self._since_snapshot = 0
        self._ema: Optional[float] = None
        self._seen = 0
        self.step_index = 0
        self.retried_steps = 0
        self.rollbacks = 0
        self.skipped_batches = 0
        self.last_loss = float("nan")

    @property
    def last_snapshot(self):
        """Newest good state as a host tree — what a watchdog dumps."""
        got = self.snapshot_for_dump()
        return None if got is None else got[1]

    def snapshot_for_dump(self):
        """``(index, host tree)`` of the newest good state, or None: the
        index is the stream index of the first step the tree does not hold,
        so a dump is named at the position it stands for and a resume
        consumes the steps since then again.  Reads no device memory."""
        return snapshot_on_host(self._snapshot, self._snapshot_index)

    def take_snapshot(self, state, index: int) -> None:
        self._snap_buf = take_snapshot(state, self._snap_buf, index)
        self._snapshot = self._snap_buf
        self._snapshot_index = index
        self._since_snapshot = 0

    def _is_bad(self, loss: float) -> Tuple[bool, str]:
        if not np.isfinite(loss):
            return True, "non-finite"
        if (
            self._ema is not None
            and self._seen >= self.policy.warmup_steps
            and loss > self.policy.spike_factor * self._ema
        ):
            return True, f"spike {loss:.4g} > {self.policy.spike_factor}x ema {self._ema:.4g}"
        return False, ""

    # public so core/pipeline.py's deferred flush applies the same policy
    def check_loss(self, loss: float) -> Tuple[bool, str]:
        """``(bad, reason)`` against the current EMA/warmup, mutating nothing."""
        return self._is_bad(loss)

    def note_good(self, loss: float) -> None:
        """Record an accepted loss: EMA, warmup count, snapshot age."""
        self._seen += 1
        self._since_snapshot += 1
        self._ema = (
            loss if self._ema is None
            else self.policy.ema_decay * self._ema + (1.0 - self.policy.ema_decay) * loss
        )
        self.last_loss = loss

    def step(self, state: Any, batch: Dict[str, Any], rng: Any) -> Tuple[Any, Dict[str, Any], bool]:
        """One guarded step: ``(state, host_aux, accepted)``; on a skipped
        (poison) batch ``state`` is the rolled-back state."""
        idx = self.step_index
        self.step_index += 1
        if self._snapshot is None or self._since_snapshot >= self.snapshot_every:
            self.take_snapshot(state, idx)  # BEFORE the step mutates the state

        aux_host: Dict[str, Any] = {}
        try:
            if self.watchdog is not None:
                self.watchdog.arm(tag=str(idx))
            for attempt in range(self.policy.retries + 1):
                if attempt == 0:
                    a_state, a_rng = state, rng
                else:
                    # fresh sampling draw, restarted from the snapshot
                    a_state = self._place(self._snapshot)
                    a_rng = fold_in(rng, 7919 + attempt)
                kwargs = {}
                if attempt > 0 and self._lr_scale_ok:
                    kwargs["lr_scale"] = self.policy.lr_backoff**attempt
                faults.stall(idx)
                new_state, aux = self._step_fn(a_state, batch, a_rng, **kwargs)
                aux_host = fetch_host([aux])[0]
                loss = float(np.mean(np.asarray(aux_host.get("loss", np.nan))))
                loss = faults.corrupt_loss(idx, loss)
                aux_host["loss"] = loss
                bad, why = self._is_bad(loss)
                if not bad:
                    self.note_good(loss)
                    return new_state, aux_host, True
                self.retried_steps += 1
                logger.warning(
                    "guarded step %d attempt %d diverged (%s)%s",
                    idx, attempt, why,
                    "" if attempt >= self.policy.retries
                    else f" — retrying with lr x{self.policy.lr_backoff**(attempt + 1):g}",
                )
        finally:
            if self.watchdog is not None:
                self.watchdog.disarm()

        self.rollbacks += 1
        self.skipped_batches += 1
        logger.error(
            "guarded step %d: retries exhausted — rolling back to the last snapshot and "
            "skipping the batch (%d/%d skips used)",
            idx, self.skipped_batches, self.policy.max_bad_batches,
        )
        if self.skipped_batches > self.policy.max_bad_batches:
            raise TrainingDiverged(
                f"{self.skipped_batches} batches skipped after rollback (budget "
                f"{self.policy.max_bad_batches}) — loss is not recovering; aborting instead of "
                f"silently training garbage"
            )
        return self._place(self._snapshot), aux_host, False
