"""Step pipeline: double-buffered host → device feed on a CUDA copy stream,
K-late aux fetch, and a guarded loop that keeps the card busy (port of
``mx_rcnn_tpu/core/pipeline.py``).

- :class:`DeviceFeed`: a worker thread places batch N+1 on the device while
  the consumer's step N runs, ``depth`` batches ahead.  On a card the host
  batch is pinned and copied ``non_blocking`` on the feed's own
  ``torch.cuda.Stream``, with an event recorded after the copy; the
  consumer's stream waits on that event, and every tensor handed out is
  ``record_stream``-ed on it, so the caching allocator never reuses a
  batch's memory while the step still reads it.
- :class:`AsyncAuxSink`: the metrics half.  Steps return ``aux`` as device
  tensors; the sink fetches a window of them in one batched device → host
  copy per flush, counting fetches and fetch *stalls* (a flush whose
  results were not ready: a CUDA event per entry, queried without
  blocking).
- :class:`PipelinedLoop`: :class:`~mx_rcnn_tpu_torch.core.resilience
  .GuardedLoop` semantics with the aux check deferred ``aux_interval``
  steps.  On a flagged step the loop rolls back to the window snapshot,
  replays the verified prefix (deterministic: the sampling seed folds the
  update count, which the rollback restores), retries the poison step
  through the guard (LR backoff → skip, budgets intact) and re-runs the
  suffix that ran on the poisoned lineage.  ``aux_interval=1`` delegates to
  the guard and is the synchronous path.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mx_rcnn_tpu_torch.core.resilience import (
    DivergencePolicy,
    GuardedLoop,
    StepWatchdog,
    fetch_host,
    snapshot_on_host,
    take_snapshot,
)
from mx_rcnn_tpu_torch.core.tester import resolve_device
from mx_rcnn_tpu_torch.utils import faults

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------- placement
def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Host batch → device tensors; ``sample_seeds`` stay host ints (they
    seed the samplers' generators).  To a card each array is pinned and
    copied ``non_blocking`` on the current stream; on the CPU it is a plain
    ``.to``."""
    dev = torch.device(device)
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if k == "sample_seeds":
            out[k] = [int(s) for s in v]
            continue
        t = torch.as_tensor(v)
        out[k] = t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t.to(dev)
    return out


def make_place_fn(device=None, mesh=None) -> Callable[[Any], Any]:
    """The placement of a host batch on ``device`` (default: the card, which
    must be present).  A mesh means data parallel, which is not ported."""
    if mesh is not None:
        raise NotImplementedError("data parallel is not ported: make_place_fn takes one device")
    dev = resolve_device(device)
    return lambda batch: batch_to_device(batch, dev)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


# ---------------------------------------------------------------- DeviceFeed
class DeviceFeed:
    """Double-buffered host → device staging iterator.

    A daemon worker drains ``source`` and runs ``place_fn`` (default
    :func:`make_place_fn` of ``device``) on each item ``depth`` items ahead
    of the consumer; on a card under its own copy stream (see the module
    docstring).  The worker sets its device before its first copy.

    Lifecycle: sentinel-based shutdown.  :meth:`close` (or the context
    manager, or GC) wakes the worker, drops staged items, joins the thread
    and closes the source; worker exceptions re-raise in the consumer.
    Counters:

    - ``fed``: items handed to the consumer;
    - ``staged_hits``: gets served from an already staged item;
    - ``feed_starved`` / ``feed_starved_after_first``: gets that had to wait
      on the worker (the first get always waits).
    """

    def __init__(
        self,
        source,
        place_fn: Optional[Callable[[Any], Any]] = None,
        depth: int = 2,
        name: str = "device-feed",
        device=None,
    ):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._source = source
        self._place = place_fn if place_fn is not None else make_place_fn(dev)
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.depth = max(1, int(depth))
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._closed = threading.Event()
        self._done = False
        self.fed = 0
        self.staged_hits = 0
        self.feed_starved = 0
        self.feed_starved_after_first = 0
        self._thread = threading.Thread(target=self._worker, name=name, daemon=True)
        self._thread.start()

    # -- worker side
    def _put(self, msg) -> bool:
        """Bounded put that gives up once the consumer is gone."""
        while not self._closed.is_set():
            try:
                self._q.put(msg, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _stage(self, item):
        if self._stream is None:
            return self._place(item), None
        with torch.cuda.stream(self._stream):
            staged = self._place(item)
            copied = torch.cuda.Event()
            copied.record(self._stream)
        return staged, copied

    def _worker(self):
        try:
            if self._stream is not None:
                torch.cuda.set_device(self.device)
            for item in self._source:
                if not self._put(("item", self._stage(item))):
                    return
            self._put(("stop", None))
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            self._put(("err", e))

    # -- consumer side
    def __iter__(self):
        return self

    def __next__(self):
        if self._closed.is_set() or self._done:
            raise StopIteration
        try:
            kind, payload = self._q.get_nowait()
            staged = True
        except queue.Empty:
            staged = False
            while True:
                try:
                    kind, payload = self._q.get(timeout=0.2)
                    break
                except queue.Empty:
                    if self._closed.is_set():
                        raise StopIteration from None
        if kind == "stop":
            self._done = True
            raise StopIteration
        if kind == "err":
            self._done = True
            raise payload
        if staged:
            self.staged_hits += 1
        else:
            self.feed_starved += 1
            if self.fed > 0:
                self.feed_starved_after_first += 1
        self.fed += 1
        item, copied = payload
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            for t in _tensors(item):
                t.record_stream(stream)
        return item

    def wait_staged(self, n: int = 1, timeout: float = 10.0) -> bool:
        """Block until ≥ ``n`` items are staged (or the stream ended or
        timed out): a deterministic head start for overlap checks."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._q.qsize() >= n or self._done or not self._thread.is_alive():
                return self._q.qsize() >= n
            time.sleep(0.005)
        return False

    def stats(self) -> Dict[str, Any]:
        fed = max(self.fed, 1)
        return {
            "fed": self.fed,
            "depth": self.depth,
            "staged_hits": self.staged_hits,
            "feed_starved": self.feed_starved,
            "feed_starved_after_first": self.feed_starved_after_first,
            "occupancy": round(self.staged_hits / fed, 4),
        }

    def close(self, timeout: float = 5.0) -> None:
        """Idempotent shutdown: signal the worker, drop staged references,
        join, close the source."""
        self._closed.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread.is_alive():
            self._thread.join(timeout)
        close = getattr(self._source, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 — best-effort source close
                pass

    def __enter__(self) -> "DeviceFeed":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # abandoned without close(): still reclaim
        try:
            self.close(timeout=0.2)
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass


# -------------------------------------------------------------- AsyncAuxSink
def ready_event(aux: Dict[str, Any]) -> Optional["torch.cuda.Event"]:
    """A CUDA event recorded after the step that produced ``aux`` (None for
    host tensors, which are ready when the step returns)."""
    for v in aux.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(v.device))
            return ev
    return None


class AsyncAuxSink:
    """Batched, non-blocking aux fetcher: a whole window of device aux
    trees in one device → host copy (:func:`fetch_host`) at flush points.
    ``fetch_stalls`` counts flushes that had to wait on results still being
    computed (an entry's event not yet reached) and ``fetch_stall_s`` the
    wait."""

    def __init__(self):
        self.pushes = 0  # aux trees deferred instead of fetched
        self.fetches = 0  # batched fetches
        self.fetched_trees = 0
        self.fetch_stalls = 0
        self.fetch_stall_s = 0.0

    def defer(self, n: int = 1) -> None:
        self.pushes += n

    @staticmethod
    def _ready(events) -> bool:
        return all(e.query() for e in events if e is not None)

    def fetch(self, trees: List[Any], events=()) -> List[Any]:
        """One batched device → host fetch of ``trees``; host copies in
        order.  ``events``: each tree's :func:`ready_event`."""
        if not trees:
            return []
        self.fetches += 1
        self.fetched_trees += len(trees)
        stalled = not self._ready(events)
        t0 = time.perf_counter()
        out = fetch_host(list(trees))
        dt = time.perf_counter() - t0
        if stalled:
            self.fetch_stalls += 1
            self.fetch_stall_s += dt
        return out

    def stats(self) -> Dict[str, Any]:
        return {
            "pushes": self.pushes,
            "fetches": self.fetches,
            "fetched_trees": self.fetched_trees,
            "fetch_stalls": self.fetch_stalls,
            "fetch_stall_ms": round(self.fetch_stall_s * 1e3, 3),
        }


# ------------------------------------------------------------- PipelinedLoop
@dataclass
class _Entry:
    idx: int
    batch: Any
    rng: Any
    aux: Any  # device aux tree, unfetched
    event: Any = None  # its ready_event


class PipelinedLoop:
    """Guarded training loop with the aux fetch deferred K steps.

    ``aux_interval=1`` delegates every step to the wrapped
    :class:`GuardedLoop`.  ``aux_interval=K>1`` dispatches K steps back to
    back (no host fetch between them), then flushes: one batched aux fetch,
    losses checked in stream order against the guard's EMA/NaN policy.  A
    flagged step triggers rollback to the window snapshot, replay of the
    verified prefix, a guarded retry of the poison step (LR backoff →
    rollback → skip, the usual budgets) and a fresh re-run of the suffix,
    so divergence recovery is K steps late, never weaker.

    Callers :meth:`flush` at epoch ends; ``step``/``flush`` return
    ``(state, ready, ok)``: ``ready`` lists ``(step_index, host_aux)`` of the
    newly verified steps (empty between flush points), ``ok`` is False when
    a poison batch was skipped."""

    def __init__(
        self,
        step_fn: Callable,
        policy: Optional[DivergencePolicy] = None,
        watchdog: Optional[StepWatchdog] = None,
        snapshot_every: int = 1,
        place_fn: Optional[Callable[[Any], Any]] = None,
        aux_interval: int = 1,
    ):
        self._step_fn = step_fn
        self.aux_interval = max(1, int(aux_interval))
        self.guard = GuardedLoop(step_fn, policy=policy, watchdog=watchdog,
                                 snapshot_every=snapshot_every, place_fn=place_fn)
        self._place = self.guard._place
        self.sink = AsyncAuxSink()
        self._entries: List[_Entry] = []
        self._win_snapshot = None
        self._win_index = 0  # the stream index of the window's first step
        self._win_buf = None  # the buffers every window snapshot reuses
        self._idx = 0
        self.window_rollbacks = 0
        self.replayed_steps = 0
        self.flushes = 0

    # -- delegated counters / snapshot surface
    @property
    def retried_steps(self) -> int:
        return self.guard.retried_steps

    @property
    def rollbacks(self) -> int:
        return self.guard.rollbacks + self.window_rollbacks

    @property
    def skipped_batches(self) -> int:
        return self.guard.skipped_batches

    @property
    def last_loss(self) -> float:
        return self.guard.last_loss

    @property
    def last_snapshot(self):
        got = self.snapshot_for_dump()
        return None if got is None else got[1]

    def snapshot_for_dump(self):
        """``(index, host tree)`` of the newest verified state, or None (see
        :meth:`GuardedLoop.snapshot_for_dump`): at ``aux_interval`` > 1 the
        window snapshot, which stands before the window's first step until
        the window is verified, also while it is being flushed."""
        if self.aux_interval > 1 and self._win_snapshot is not None:
            return snapshot_on_host(self._win_snapshot, self._win_index)
        return self.guard.snapshot_for_dump()

    @property
    def next_index(self) -> int:
        """Stream index the next ``step`` call will dispatch at."""
        return self._idx if self.aux_interval > 1 else self.guard.step_index

    # -- step execution
    def _window_snapshot(self, state, index: int) -> None:
        self._win_buf = take_snapshot(state, self._win_buf, index)
        self._win_snapshot = self._win_buf
        self._win_index = index

    def _dispatch(self, state, batch, rng, tag: str):
        wd = self.guard.watchdog
        if wd is not None:
            wd.arm(tag=tag)
        try:
            return self._step_fn(state, batch, rng)
        finally:
            if wd is not None:
                wd.disarm()

    def step(
        self, state: Any, batch: Dict[str, Any], rng: Any
    ) -> Tuple[Any, List[Tuple[int, Dict[str, Any]]], bool]:
        if self.aux_interval <= 1:
            idx = self.guard.step_index
            state, aux, ok = self.guard.step(state, batch, rng)
            return state, ([(idx, aux)] if ok else []), ok
        idx = self._idx
        self._idx += 1
        self.guard.step_index = self._idx  # shared step coordinate space
        if self._win_snapshot is None:
            self._window_snapshot(state, idx)  # BEFORE the window's first step
        faults.stall(idx)  # test injection, no-op in production
        state, aux = self._dispatch(state, batch, rng, tag=str(idx))
        self._entries.append(_Entry(idx, batch, rng, aux, ready_event(aux)))
        self.sink.defer()
        if len(self._entries) >= self.aux_interval:
            return self._flush(state)
        return state, [], True

    def flush(self, state: Any) -> Tuple[Any, List[Tuple[int, Dict[str, Any]]], bool]:
        """Fetch and verify every pending step (epoch end, explicit check)."""
        if self.aux_interval <= 1 or not self._entries:
            return state, [], True
        return self._flush(state)

    def _flush(self, state):
        self.flushes += 1
        ready: List[Tuple[int, Dict[str, Any]]] = []
        ok = True
        entries, self._entries = self._entries, []
        while entries:
            wd = self.guard.watchdog
            if wd is not None:
                wd.arm(tag=f"flush@{entries[0].idx}")
            try:
                hosts = self.sink.fetch([e.aux for e in entries], [e.event for e in entries])
            finally:
                if wd is not None:
                    wd.disarm()
            bad_at, why = -1, ""
            for i, (e, ah) in enumerate(zip(entries, hosts)):
                ah = dict(ah)
                loss = float(np.mean(np.asarray(ah.get("loss", np.nan))))
                loss = faults.corrupt_loss(e.idx, loss)
                ah["loss"] = loss
                bad, why = self.guard.check_loss(loss)
                if bad:
                    bad_at = i
                    break
                self.guard.note_good(loss)
                ready.append((e.idx, ah))
            if bad_at < 0:
                break
            e_bad = entries[bad_at]
            logger.warning(
                "pipelined flush: step %d diverged (%s) — rolling back the window, replaying %d "
                "verified step(s), retrying the poison step synchronously",
                e_bad.idx, why, bad_at,
            )
            self.window_rollbacks += 1
            state = self._place(self._win_snapshot)
            # replay of the verified prefix: the rollback restored the update
            # count the sampling seed folds, so the draws are the same
            for e in entries[:bad_at]:
                state, _ = self._dispatch(state, e.batch, e.rng, tag=f"replay@{e.idx}")
                self.replayed_steps += 1
            # guarded retry at the SAME step coordinate, so fault injection
            # and logging line up with the stream position
            self.guard.step_index = e_bad.idx
            self.guard._snapshot = None  # the guard snapshots the healthy state
            state, ah, step_ok = self.guard.step(state, e_bad.batch, e_bad.rng)
            self.guard.step_index = self._idx
            if step_ok:
                ready.append((e_bad.idx, ah))
            else:
                ok = False
            # the suffix ran on the poisoned lineage: dispatch it again
            redo, entries = entries[bad_at + 1:], []
            for e in redo:
                state, aux = self._dispatch(state, e.batch, e.rng, tag=f"redo@{e.idx}")
                self.replayed_steps += 1
                entries.append(_Entry(e.idx, e.batch, e.rng, aux, ready_event(aux)))
        # the window is verified: its end state anchors the next window
        self._window_snapshot(state, self._idx)
        return state, ready, ok

    def stats(self) -> Dict[str, Any]:
        return {
            "aux_interval": self.aux_interval,
            "steps": self._idx if self.aux_interval > 1 else self.guard.step_index,
            "flushes": self.flushes,
            "window_rollbacks": self.window_rollbacks,
            "replayed_steps": self.replayed_steps,
            "retried_steps": self.guard.retried_steps,
            "skipped_batches": self.guard.skipped_batches,
            **self.sink.stats(),
        }
