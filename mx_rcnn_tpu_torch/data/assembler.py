"""Parallel host data plane (port of ``mx_rcnn_tpu/data/assembler.py``):
worker pools for the two host-side stages that bracket the device, batch
ASSEMBLY (render / resize / pad, upstream of the step) and COMPLETION
(per-image postprocess, downstream of the fetch).

Both are sized pools with the same counter discipline as
``core/pipeline.py :: DeviceFeed``.  Determinism is structural:

* :meth:`AssemblyPool.imap` yields results in SUBMISSION order no matter
  which worker finishes first, and the work it runs (``TrainLoader``'s
  batch build) is pure per item, so a parallel assembly stream is
  bit-identical to the serial one for the same seed.
* :class:`CompletionPool` callers write results into index-addressed
  slots, so accumulation is order-free; ``drain`` is the only ordering
  point and re-raises the first worker error instead of swallowing it.

``workers == 0`` runs both pools inline on the caller thread: the serial
path, and the reference side of the equivalence tests.

The JAX package's assembly workers are threads.  Here they are processes
(``spawn``): on the card the train step's host side is Python launching
kernels, and assembly threads beside it, holding the interpreter lock for
their share of the render and resize, slowed a full-width step by half,
where as many processes left it as it was (``PERF.md`` §6;
``tools/host_contention.py``).  So ``AssemblyPool`` runs a picklable
module-level function in each worker, with the stream's shared state set
once per process by ``initializer``; results come back pickled, in
submission order.  The completion pool's tasks write into the caller's
slots, so its workers stay threads.
"""

from __future__ import annotations

import multiprocessing
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

__all__ = [
    "AssemblyPool",
    "CompletionPool",
    "default_assembly_workers",
]


def default_assembly_workers() -> int:
    """Pool size when the caller passes ``None``: the
    ``MX_RCNN_ASSEMBLY_WORKERS`` env var, else 0 (serial).  Multi-core
    hosts opt in per run or through the variable."""
    return max(0, int(os.environ.get("MX_RCNN_ASSEMBLY_WORKERS", "0")))


class _OrderedResults:
    """Closeable iterator over :meth:`AssemblyPool.imap` results.

    Same lifecycle contract as ``data/loader.py :: PrefetchIterator``:
    ``close()`` (also context manager and, as a GC backstop,
    ``__del__``) stops submission, drops pending work, and leaves no
    worker parked: an abandoned stream must not leak ``window`` in-flight
    batches.
    """

    def __init__(self, pool: "AssemblyPool", fn: Callable, items: Iterable,
                 window: int):
        self._pool = pool
        self._fn = fn
        self._items = iter(items)
        self._window = max(1, int(window))
        self._q: deque = deque()
        self._closed = False

    def _fill(self) -> None:
        while not self._closed and len(self._q) < self._window:
            try:
                item = next(self._items)
            except StopIteration:
                return
            self._q.append(self._pool._submit_counted(self._fn, item))

    def __iter__(self) -> "_OrderedResults":
        return self

    def __next__(self) -> Any:
        self._fill()
        if not self._q:
            raise StopIteration
        fut = self._q.popleft()
        t0 = time.perf_counter()
        ready = fut.done()
        out = fut.result()  # re-raises the worker exception in order
        self._pool._account_get(ready, time.perf_counter() - t0,
                                len(self._q))
        return out

    def close(self) -> None:
        """Idempotent: stop submitting, cancel queued work, drain the
        in-flight remainder so no worker outlives the consumer."""
        self._closed = True
        while self._q:
            fut = self._q.popleft()
            if not fut.cancel():
                try:
                    fut.result()
                except Exception:  # noqa: BLE001 — abandoned on purpose
                    pass

    def __enter__(self) -> "_OrderedResults":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass


class _InlineResults:
    """``workers == 0`` twin of :class:`_OrderedResults`: a plain lazy
    map on the caller thread, with the same close/ctx interface so
    consumers are pool-size agnostic."""

    def __init__(self, pool: "AssemblyPool", fn: Callable, items: Iterable):
        self._pool = pool
        self._fn = fn
        self._items = iter(items)
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = next(self._items)
        self._pool.submitted += 1
        t0 = time.perf_counter()
        out = self._fn(item)
        self._pool.completed += 1
        self._pool._account_get(False, time.perf_counter() - t0, 0)
        return out

    def close(self) -> None:
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AssemblyPool:
    """Sized pool of worker processes for host batch assembly.

    ``initializer(*initargs)`` runs once in each worker process (the
    train loader hands it the roidb and config there), and ``imap``'s
    function must be picklable: a module-level function, whose module the
    spawned worker imports.  With ``workers == 0`` the function runs inline
    on the caller's thread and ``initializer`` is not called.

    Counters follow ``DeviceFeed.stats()``'s vocabulary: ``ready_hits`` — results that
    were already finished when the consumer asked (the pool ran ahead);
    ``starved`` / ``starved_after_first`` — gets that had to wait on a
    worker (after the pipeline-fill get, each one is assembly time the
    consumer ate); ``occupancy`` — ready_hits / yields.
    """

    def __init__(self, workers: Optional[int] = None,
                 name: str = "assembly", initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        self.workers = (
            default_assembly_workers() if workers is None
            else max(0, int(workers))
        )
        self.name = name
        self._ex: Optional[ProcessPoolExecutor] = (
            ProcessPoolExecutor(
                max_workers=self.workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=initializer, initargs=initargs,
            )
            if self.workers else None
        )
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.yielded = 0
        self.ready_hits = 0
        self.starved = 0
        self.starved_after_first = 0
        self.wait_s = 0.0
        self.queue_depth_max = 0

    # ------------------------------------------------------------ internals
    def _submit_counted(self, fn: Callable, item: Any) -> Future:
        with self._lock:
            self.submitted += 1
        fut = self._ex.submit(fn, item)
        fut.add_done_callback(self._count_completed)
        return fut

    def _count_completed(self, fut: Future) -> None:
        if not fut.cancelled() and fut.exception() is None:
            with self._lock:
                self.completed += 1

    def _account_get(self, ready: bool, waited_s: float, depth: int) -> None:
        with self._lock:
            if ready:
                self.ready_hits += 1
            else:
                self.starved += 1
                if self.yielded > 0:
                    self.starved_after_first += 1
            self.yielded += 1
            self.wait_s += waited_s
            if depth > self.queue_depth_max:
                self.queue_depth_max = depth

    # ------------------------------------------------------------------ api
    def imap(self, fn: Callable[[Any], Any], items: Iterable,
             window: Optional[int] = None) -> Iterator:
        """Ordered streaming map: keeps up to ``window`` (default
        ``workers + 2``) items in flight and yields results in input
        order; the returned iterator is closeable (see
        :class:`_OrderedResults`).  With ``workers == 0`` this is a
        plain serial map with the same interface."""
        if self._ex is None:
            return _InlineResults(self, fn, items)
        return _OrderedResults(
            self, fn, items,
            self.workers + 2 if window is None else window,
        )

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            yielded = max(self.yielded, 1)
            return {
                "workers": self.workers,
                "submitted": self.submitted,
                "completed": self.completed,
                "yielded": self.yielded,
                "ready_hits": self.ready_hits,
                "starved": self.starved,
                "starved_after_first": self.starved_after_first,
                "occupancy": round(self.ready_hits / yielded, 4),
                "wait_s": round(self.wait_s, 4),
                "queue_depth_max": self.queue_depth_max,
            }

    def close(self) -> None:
        if self._ex is not None:
            self._ex.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "AssemblyPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class CompletionPool:
    """Bounded pool for the post-fetch stage (per-image detections,
    capping: work the dispatch thread would eat between predict calls).

    ``submit`` BLOCKS once ``depth`` tasks are in flight (a semaphore),
    so a slow postprocess applies backpressure instead of piling
    unbounded futures.  Submitted functions write
    their results into caller-owned index-addressed slots; the pool
    itself returns nothing.  ``drain`` waits for everything submitted
    so far and re-raises the FIRST worker error — a swallowed
    postprocess exception would silently corrupt mAP.

    ``workers == 0`` runs every submit inline on the caller thread (the
    serial path, bit-identical by construction).
    """

    def __init__(self, workers: int, depth: Optional[int] = None,
                 name: str = "completion"):
        self.workers = max(0, int(workers))
        self.depth = (
            max(1, int(depth)) if depth is not None
            else max(1, 2 * self.workers)
        )
        self._ex: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(
                max_workers=self.workers, thread_name_prefix=name
            )
            if self.workers else None
        )
        self._sem = threading.Semaphore(self.depth)
        self._lock = threading.Lock()
        self._pending: set = set()
        self._first_error: Optional[BaseException] = None
        self.submitted = 0
        self.completed = 0
        self.errors = 0
        self.inflight_max = 0
        self.block_s = 0.0

    def submit(self, fn: Callable, *args, **kwargs) -> None:
        if self._ex is None:
            with self._lock:
                self.submitted += 1
            try:
                fn(*args, **kwargs)
                with self._lock:
                    self.completed += 1
            except BaseException as e:  # noqa: BLE001 — kept for drain()
                with self._lock:
                    self.errors += 1
                    if self._first_error is None:
                        self._first_error = e
                raise
            return
        t0 = time.perf_counter()
        self._sem.acquire()
        blocked = time.perf_counter() - t0

        def run():
            try:
                fn(*args, **kwargs)
                with self._lock:
                    self.completed += 1
            except BaseException as e:  # noqa: BLE001 — re-raised by drain
                with self._lock:
                    self.errors += 1
                    if self._first_error is None:
                        self._first_error = e
            finally:
                self._sem.release()

        fut = self._ex.submit(run)
        with self._lock:
            self.submitted += 1
            self.block_s += blocked
            self._pending = {f for f in self._pending if not f.done()}
            self._pending.add(fut)
            if len(self._pending) > self.inflight_max:
                self.inflight_max = len(self._pending)

    def drain(self) -> None:
        """Wait for every submitted task; re-raise the first error."""
        with self._lock:
            pending = list(self._pending)
        for f in pending:
            f.result()
        with self._lock:
            self._pending = {f for f in self._pending if not f.done()}
            err = self._first_error
        if err is not None:
            raise err

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "workers": self.workers,
                "depth": self.depth,
                "submitted": self.submitted,
                "completed": self.completed,
                "errors": self.errors,
                "inflight_max": self.inflight_max,
                "block_s": round(self.block_s, 4),
            }

    def close(self, raise_errors: bool = False) -> None:
        """Shut the pool down after finishing in-flight work; with
        ``raise_errors`` re-raise the first worker error."""
        if self._ex is not None:
            self._ex.shutdown(wait=True, cancel_futures=False)
        if raise_errors:
            self.drain()

    def __enter__(self) -> "CompletionPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
