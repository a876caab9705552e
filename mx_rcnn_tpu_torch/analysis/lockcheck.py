"""Runtime lock-order assertion (port of the runtime half of
``mx_rcnn_tpu/analysis/lockcheck.py``; the static lint rules stay in the
JAX package).

The serve stack constructs every lock through :func:`make_lock` /
:func:`make_condition`.  By default these return the plain ``threading``
primitive (zero overhead, zero behavior change).  With
``MX_RCNN_LOCK_CHECK=1`` in the environment they return an
:class:`OrderedLock` proxy that maintains a process-wide
lock-*name* acquisition graph (edge ``A -> B`` = "B acquired while A
held") and raises :class:`LockOrderViolation` the moment any thread
tries to acquire in an order that closes a cycle — i.e. it turns a
maybe-someday deadlock into a deterministic test failure at the exact
acquire site.

Semantics:

* edges are keyed by lock NAME ("_ModelSlot.lock"), not instance, so an
  inversion between any two slots and a ModelRegistry is caught even if
  the specific instances differ across tests;
* nesting two locks of the SAME name (e.g. merging two
  LatencyHistograms) records no edge — cross-instance order within one
  name class is not tracked;
* re-entering an rlock-mode OrderedLock is allowed and records nothing;
  re-acquiring a non-reentrant one in the same thread raises instead of
  deadlocking.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple


class LockOrderViolation(RuntimeError):
    """A lock acquisition closed a cycle in the observed order graph."""


_graph_mu = threading.Lock()
_edges: Dict[str, Set[str]] = {}
_edge_sites: Dict[Tuple[str, str], str] = {}
_tls = threading.local()


def enabled() -> bool:
    return os.environ.get("MX_RCNN_LOCK_CHECK", "0") == "1"


def reset() -> None:
    """Clear the process-wide order graph (test isolation)."""
    with _graph_mu:
        _edges.clear()
        _edge_sites.clear()


def _held() -> List["OrderedLock"]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _reaches(src: str, dst: str) -> bool:
    # DFS over the recorded name graph; caller holds _graph_mu
    stack, seen = [src], set()
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_edges.get(n, ()))
    return False


class OrderedLock:
    def __init__(self, name: str, rlock: bool = False):
        self.name = name
        self.rlock = rlock
        self._lock = threading.RLock() if rlock else threading.Lock()

    def _check_before_acquire(self) -> bool:
        """Returns True when this is an rlock re-entry (no edge)."""
        held = _held()
        if any(h is self for h in held):
            if self.rlock:
                return True
            raise LockOrderViolation(
                f"re-acquisition of non-reentrant lock {self.name} "
                f"in the same thread (guaranteed deadlock)"
            )
        with _graph_mu:
            for h in held:
                if h.name == self.name:
                    continue
                if _reaches(self.name, h.name):
                    first = _edge_sites.get((self.name, h.name), "")
                    raise LockOrderViolation(
                        f"lock order inversion: acquiring {self.name} while "
                        f"holding {h.name}, but order {self.name} -> "
                        f"{h.name} was established earlier"
                        + (f" ({first})" if first else "")
                    )
        return False

    def _record(self) -> None:
        held = _held()
        with _graph_mu:
            for h in held:
                if h.name == self.name:
                    continue
                if self.name not in _edges.setdefault(h.name, set()):
                    _edges[h.name].add(self.name)
                    _edge_sites[(h.name, self.name)] = (
                        f"first observed in thread "
                        f"{threading.current_thread().name}"
                    )

    def acquire(self, blocking: bool = True, timeout: float = -1):
        reentry = self._check_before_acquire()
        if timeout == -1:
            ok = self._lock.acquire(blocking)
        else:
            ok = self._lock.acquire(blocking, timeout)
        if ok and not reentry:
            self._record()
            _held().append(self)
        return ok

    def release(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        inner = self._lock
        return inner.locked() if hasattr(inner, "locked") else False

    def _is_owned(self) -> bool:
        # Condition-protocol hook: without it, Condition falls back to a
        # probing acquire(False), which the proxy would report as a
        # same-thread re-acquisition
        return any(h is self for h in _held())


def make_lock(name: str, rlock: bool = False):
    """A threading.Lock/RLock, or an order-asserting proxy under
    MX_RCNN_LOCK_CHECK=1."""
    if enabled():
        return OrderedLock(name, rlock=rlock)
    return threading.RLock() if rlock else threading.Lock()


def make_condition(name: str):
    """A threading.Condition whose underlying lock participates in the
    order graph when the check is on."""
    return threading.Condition(make_lock(name))
