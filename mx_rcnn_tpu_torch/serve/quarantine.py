"""Query-of-death containment for the request plane (port of
``mx_rcnn_tpu/serve/quarantine.py``; host code, no torch).

A single pathological input (a "query of death") that fails predict
would otherwise be retried on every attempt.  This module holds the
counter-measures, free of serve imports so every serve layer can use it:

* **admission control**: ``validate_image`` rejects malformed inputs
  (bad rank/dtype/size, non-finite pixels, per-model bounds) with a
  typed ``InvalidRequest`` in the *caller's* thread, before the batcher
  or assembler ever see them;
* **attribution + quarantine**: ``QuarantineTable`` records the digests
  of a failing batch as suspects.  A digest implicated in >= K
  *independent* trips is quarantined for a TTL and fails fast with
  ``PoisonRequest``; co-batched innocents are exonerated when they later
  complete, and entries age out so a transient coincidence cannot
  blacklist real traffic forever;
* **retry budgets**: every re-dispatch flows through
  ``RetryBudget.spend``; exhaustion resolves ``RetriesExhausted``
  instead of looping;
* **isolation probes**: ``top_suspect`` / ``probe_result`` replay the
  top suspect alone so attribution converges in O(1) extra trips.

The replica pool that records trips is a later slice of the port; the
engine already uses the validation, the digests and the budgets.
"""

import hashlib
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from mx_rcnn_tpu_torch.analysis.lockcheck import make_lock

__all__ = [
    "InvalidRequest",
    "PoisonRequest",
    "RetriesExhausted",
    "BatchImplicated",
    "PoisonBatch",
    "request_digest",
    "validate_image",
    "RetryBudget",
    "BatchBudget",
    "QuarantineTable",
]


class InvalidRequest(ValueError):
    """Request rejected at admission: malformed image or out of bounds."""


class PoisonRequest(RuntimeError):
    """Request digest is quarantined: implicated in >= K replica trips."""


class RetriesExhausted(RuntimeError):
    """Per-request retry budget spent; the request will not requeue again."""


class BatchImplicated(RuntimeError):
    """Routing-internal: the in-flight batch was implicated in a replica
    trip.  The engine splits it and resubmits each request solo so that
    exactly one more trip pins the poison instead of co-tripping the
    innocents to K alongside it.  Never client-visible."""

    def __init__(self, digests: Sequence[str], reason: str = ""):
        super().__init__(reason or "batch implicated in replica trip")
        self.digests = tuple(digests)


class PoisonBatch(RuntimeError):
    """Routing-internal: a quarantined digest reached dispatch.  The
    engine fails it with ``PoisonRequest`` and resubmits the rest."""

    def __init__(self, digest: str, digests: Sequence[str] = ()):
        super().__init__(f"quarantined digest in batch: {digest[:12]}")
        self.digest = digest
        self.digests = tuple(digests)


def request_digest(im: Any) -> str:
    """Stable identity of a raw input image: blake2b over shape, dtype
    and bytes (same construction as ``ResponseCache.digest``).  Computed
    on the *raw* submitted array so external tooling (bench, fault
    specs) can reproduce it without a runner."""
    arr = np.ascontiguousarray(im)
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((arr.shape, str(arr.dtype))).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


# Admission defaults; a model may tighten (never widen past sanity) via
# ``ModelRegistry.register(..., limits={"max_side": ..., "max_pixels": ...})``.
DEFAULT_MAX_SIDE = 8192
DEFAULT_MAX_PIXELS = 8192 * 8192


def validate_image(im: Any, limits: Optional[Dict[str, Any]] = None) -> np.ndarray:
    """Admission gate: return ``im`` as-is when acceptable, else raise
    ``InvalidRequest``.  Checks rank/channels, numeric dtype, nonzero
    dims, per-model size bounds, and (for float inputs) finiteness."""
    if im is None:
        raise InvalidRequest("image is None")
    if not isinstance(im, np.ndarray):
        try:
            im = np.asarray(im)
        except Exception as e:
            raise InvalidRequest(f"image not array-coercible: {e!r}")
    if im.dtype == object or im.dtype.kind not in "uif":
        raise InvalidRequest(f"non-numeric image dtype: {im.dtype}")
    if im.ndim != 3 or im.shape[-1] != 3:
        raise InvalidRequest(f"expected HxWx3 image, got shape {im.shape}")
    if min(im.shape[:2]) < 1:
        raise InvalidRequest(f"zero-sized image dimension: {im.shape}")
    lim = dict(limits or {})
    max_side = int(lim.get("max_side", DEFAULT_MAX_SIDE))
    max_pixels = int(lim.get("max_pixels", DEFAULT_MAX_PIXELS))
    h, w = int(im.shape[0]), int(im.shape[1])
    if max(h, w) > max_side:
        raise InvalidRequest(f"image side {max(h, w)} exceeds limit {max_side}")
    if h * w > max_pixels:
        raise InvalidRequest(f"image pixels {h * w} exceed limit {max_pixels}")
    if im.dtype.kind == "f" and not np.isfinite(im).all():
        raise InvalidRequest("non-finite pixel values in image")
    return im


def validate_request(req: Any) -> None:
    """Cheap structural gate for direct ``DynamicBatcher.submit`` callers:
    a zero-dim or dtype-object image must fail in the submitting thread,
    not crash the assembler.  (The engine runs the full ``validate_image``
    gate — including bounds and finiteness — before requests get here.)"""
    im = getattr(req, "image", None)
    if not isinstance(im, np.ndarray):
        raise InvalidRequest(f"request image must be ndarray, got {type(im)!r}")
    if im.dtype == object or im.dtype.kind not in "uif":
        raise InvalidRequest(f"non-numeric request image dtype: {im.dtype}")
    if im.ndim == 0 or im.size == 0:
        raise InvalidRequest(f"empty request image: shape {im.shape}")


class RetryBudget:
    """Per-request bound on re-dispatch.  Every requeue, hedge, failover
    and engine resubmit must flow through ``spend``;
    spending past zero raises ``RetriesExhausted``."""

    def __init__(self, budget: int = 8):
        self.total = int(budget)
        self.remaining = int(budget)
        self.spent: Dict[str, int] = {}

    def spend(self, kind: str = "requeue") -> None:
        if self.remaining <= 0:
            raise RetriesExhausted(
                f"retry budget of {self.total} exhausted (last spend: {kind})")
        self.remaining -= 1
        self.spent[kind] = self.spent.get(kind, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        return {"total": self.total, "remaining": self.remaining,
                "spent": dict(self.spent)}


class BatchBudget:
    """A batch re-dispatch re-runs *every* member request, so one spend
    at the router decrements each member's budget.  Exhaustion of any
    member fails the whole dispatch with ``RetriesExhausted`` (the
    engine then settles members individually)."""

    def __init__(self, budgets: Sequence[RetryBudget]):
        self.budgets = [b for b in budgets if b is not None]

    @property
    def remaining(self) -> int:
        return min((b.remaining for b in self.budgets), default=0)

    def spend(self, kind: str = "requeue") -> None:
        for b in self.budgets:
            b.spend(kind)


class _Suspect:
    __slots__ = ("trips", "payload", "first_t", "probing_t")

    def __init__(self, now: float):
        self.trips: set = set()
        self.payload: Optional[Dict[str, Any]] = None
        self.first_t = now
        self.probing_t = 0.0


class QuarantineTable:
    """Attribution ledger shared by one replica pool.

    ``note_trip`` records the tripping replica's in-flight digests as
    suspects (each trip gets a fresh id, so K means K *independent*
    trips, not K replays of one).  At >= ``k`` trips a digest moves to
    the TTL'd quarantine map and from then on fails fast.  Successful
    completion exonerates; isolation probes confirm or clear out of
    band via ``top_suspect``/``probe_result``."""

    def __init__(self, k: int = 2, ttl_s: float = 300.0,
                 max_suspects: int = 256):
        self.k = max(1, int(k))
        self.ttl_s = float(ttl_s)
        self.max_suspects = int(max_suspects)
        self._lock = make_lock("QuarantineTable._lock")
        self._suspects: "Dict[str, _Suspect]" = {}
        self._quarantined: Dict[str, Tuple[float, str]] = {}
        self._trip_seq = 0
        # counters (read without the lock; single-writer per field)
        self.trips = 0
        self.suspects_recorded = 0
        self.quarantined_total = 0
        self.exonerated = 0
        self.expired = 0
        self.probes = 0
        self.probes_confirmed = 0
        self.probes_cleared = 0
        self.fastfail_hits = 0
        self.suspects_dropped = 0  # ring-buffer evictions past max_suspects

    # ------------------------------------------------------------ internals
    def _purge_locked(self, now: float) -> None:
        dead = [d for d, (exp, _) in self._quarantined.items() if exp <= now]
        for d in dead:
            del self._quarantined[d]
            self.expired += 1
        stale = [d for d, s in self._suspects.items()
                 if now - s.first_t > self.ttl_s]
        for d in stale:
            del self._suspects[d]
        while len(self._suspects) > self.max_suspects:
            oldest = min(self._suspects, key=lambda d: self._suspects[d].first_t)
            del self._suspects[oldest]
            self.suspects_dropped += 1

    def _quarantine_locked(self, digest: str, reason: str, now: float) -> None:
        self._quarantined[digest] = (now + self.ttl_s, reason)
        self._suspects.pop(digest, None)
        self.quarantined_total += 1

    # ------------------------------------------------------------ attribution
    def note_trip(self, suspects: Iterable[Tuple[str, Optional[Dict[str, Any]]]],
                  replica: Optional[int] = None, reason: str = "") -> List[str]:
        """Record one trip's in-flight ``(digest, payload)`` pairs.
        Returns the digests this trip pushed over the K threshold."""
        now = time.monotonic()
        newly: List[str] = []
        with self._lock:
            self._purge_locked(now)
            self._trip_seq += 1
            self.trips += 1
            trip_id = self._trip_seq
            for digest, payload in suspects:
                if not digest or digest in self._quarantined:
                    continue
                s = self._suspects.get(digest)
                if s is None:
                    s = self._suspects[digest] = _Suspect(now)
                    self.suspects_recorded += 1
                s.trips.add(trip_id)
                if payload is not None and s.payload is None:
                    s.payload = payload
                if len(s.trips) >= self.k:
                    self._quarantine_locked(
                        digest, f"{len(s.trips)} trips ({reason})", now)
                    newly.append(digest)
        return newly

    def exonerate(self, digest: str) -> bool:
        """A suspect completed successfully elsewhere: drop suspicion."""
        with self._lock:
            if self._suspects.pop(digest, None) is not None:
                self.exonerated += 1
                return True
        return False

    def quarantined(self, digest: str) -> bool:
        now = time.monotonic()
        with self._lock:
            self._purge_locked(now)
            hit = digest in self._quarantined
            if hit:
                self.fastfail_hits += 1
            return hit

    def first_quarantined(self, digests: Iterable[str]) -> Optional[str]:
        now = time.monotonic()
        with self._lock:
            self._purge_locked(now)
            for d in digests:
                if d in self._quarantined:
                    self.fastfail_hits += 1
                    return d
        return None

    def quarantine(self, digest: str, reason: str) -> None:
        with self._lock:
            self._quarantine_locked(digest, reason, time.monotonic())

    def clear(self, digest: str) -> bool:
        """Drop a digest from both maps (probe passed / operator action)."""
        with self._lock:
            sus = self._suspects.pop(digest, None) is not None
            qua = self._quarantined.pop(digest, None) is not None
        return sus or qua

    # ------------------------------------------------------------ probes
    def top_suspect(self) -> Optional[Tuple[str, Optional[Dict[str, Any]]]]:
        """Most-implicated live suspect, marked as in-probe so two
        recovering replicas don't both replay it.  The probing mark ages
        out with the TTL in case the prober dies mid-replay."""
        now = time.monotonic()
        with self._lock:
            self._purge_locked(now)
            best = None
            for d, s in self._suspects.items():
                if s.probing_t and now - s.probing_t < self.ttl_s:
                    continue
                key = (-len(s.trips), s.first_t)
                if best is None or key < best[0]:
                    best = (key, d, s)
            if best is None:
                return None
            _, digest, s = best
            s.probing_t = now
            self.probes += 1
            return digest, s.payload

    def probe_result(self, digest: str, ok: Optional[bool]) -> None:
        """Settle an isolation probe: ``ok=True`` clears the suspect,
        ``ok=False`` confirms poison (quarantined immediately — the probe
        stands in for the remaining K trips), ``ok=None`` aborts."""
        now = time.monotonic()
        with self._lock:
            s = self._suspects.get(digest)
            if s is not None:
                s.probing_t = 0.0
            if ok is None:
                return
            if ok:
                if self._suspects.pop(digest, None) is not None:
                    self.probes_cleared += 1
            else:
                self._quarantine_locked(digest, "isolation probe", now)
                self.probes_confirmed += 1

    # ------------------------------------------------------------ reporting
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            suspects = {d[:12]: len(s.trips) for d, s in self._suspects.items()}
            quarantined = {d[:12]: reason
                           for d, (_, reason) in self._quarantined.items()}
        return {
            "k": self.k,
            "ttl_s": self.ttl_s,
            "trips": self.trips,
            "suspects": suspects,
            "quarantined": quarantined,
            "suspects_recorded": self.suspects_recorded,
            "quarantined_total": self.quarantined_total,
            "exonerated": self.exonerated,
            "expired": self.expired,
            "probes": self.probes,
            "probes_confirmed": self.probes_confirmed,
            "probes_cleared": self.probes_cleared,
            "fastfail_hits": self.fastfail_hits,
            "suspects_dropped": self.suspects_dropped,
        }
