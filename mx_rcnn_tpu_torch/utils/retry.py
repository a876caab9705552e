"""Deterministic bounded retry (port of ``RetryPolicy``, ``RETRY_PRESETS``
and ``make_retry_policy`` of ``mx_rcnn_tpu/core/resilience.py``, which
re-exports them as the JAX module does).  Kept free of torch: the loader's
assembly processes import it."""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded deterministic retry: no jitter, so a replayed run retries at
    the same points.  ``tries`` is the total attempt count; ``delay`` sleeps
    ``delay * backoff**(k-1)`` seconds before retry ``k`` (0 = no sleep)."""

    tries: int = 3
    delay: float = 0.0
    backoff: float = 2.0

    def run(self, fn: Callable[[int], Any]) -> Any:
        """Call ``fn(attempt)`` until it returns; re-raise the last
        exception once ``tries`` attempts failed."""
        for attempt in range(max(1, self.tries)):
            try:
                return fn(attempt)
            except Exception:
                if attempt + 1 >= max(1, self.tries):
                    raise
                if self.delay:
                    time.sleep(self.delay * self.backoff**attempt)


RETRY_PRESETS: Dict[str, RetryPolicy] = {
    "loader": RetryPolicy(tries=3, delay=0.0),
    "serve": RetryPolicy(tries=3, delay=0.0),
    "replica": RetryPolicy(tries=2, delay=0.0),
}


def make_retry_policy(kind: str, **overrides) -> RetryPolicy:
    """Preset :class:`RetryPolicy` by site kind, with per-call overrides."""
    base = RETRY_PRESETS[kind]
    return dataclasses.replace(base, **overrides) if overrides else base
