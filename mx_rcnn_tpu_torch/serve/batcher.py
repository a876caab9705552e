"""Deadline-aware dynamic micro-batcher with SLO-tiered two-lane release.

Requests arrive one at a time; the device wants full fixed-shape batches.
Every request carries an SLO lane — ``"interactive"`` or ``"bulk"`` —
and the batcher holds a bounded per-(model, bucket, lane) queue.

Port of ``mx_rcnn_tpu/serve/batcher.py``.  Queues are also keyed by the
request's ``tenant`` tag, and a duck-typed ``fair=`` scheduler (``pick``,
``charge``, ``snapshot``) may choose WHICH tenant releases the next
device batch; the lane policy below then applies within that tenant's
groups.  The port's tenancy module is a later slice, so the engine passes
none: untagged traffic is one key and the policy is the lane policy alone.

Release policy (within the picked tenant), in priority order:

1. **bulk-aging guard** — when the bulk head has waited
   ``bulk_age_limit`` seconds AND the bulk lane has not released a batch
   for that long, bulk takes the next device slot unconditionally, so a
   sustained interactive stream can bound bulk's throughput but never
   starve it.  Both conditions matter: under a deep bulk backlog every
   head is old (queue wait alone exceeds any limit), so head age by
   itself would invert the priority exactly when the two-lane split is
   most needed — the release-gap condition keeps the guard about
   starvation, not backlog depth.
2. **interactive lane** — the oldest interactive head preempts bulk for
   the next slot, releasing with ``interactive_linger`` (default 0:
   batch-of-1 dispatch latency; a saturated interactive queue still
   releases full batches).
3. **bulk lane** — today's max-occupancy behavior: release when some
   group has ``max_batch`` requests waiting, when the oldest request has
   lingered ``max_linger`` seconds, or when its deadline is close enough
   that waiting longer would blow it.

Lanes choose WHICH group releases next; a released batch is still
homogeneous in (model, bucket) — one model family and one (H, W) canvas
per device batch — so every batch pads to a single input shape and the
runner's one-signature-per-rung invariant is untouched by lane scheduling.  (Batches are
also lane-pure, which is what makes per-lane occupancy attributable.)

Expired-request sweep: a request whose deadline has already passed would
otherwise occupy queue and batch slots until pickup.  ``submit`` and
``next_batch`` sweep such requests — skipping any group that is about to
release, whose expiry the engine's pickup check already owns — resolve
their futures with :class:`DeadlineExceeded` immediately (or hand them
to ``on_expired`` when the engine wires one), and count them in
``expired_swept``.  The submit-side sweep runs BEFORE the capacity
check, so backpressure admits fresh work exactly when the system is
overloaded with dead work.

Backpressure is a bounded total queue: ``submit`` raises
:class:`QueueFull` instead of buffering unboundedly (the caller — an RPC
edge in a real deployment — surfaces it as 429/503 and the client backs
off).  This mirrors GuardedLoop's philosophy in ``core/resilience.py``:
fail loudly at the boundary rather than degrade invisibly.
"""

from __future__ import annotations

import time
from collections import deque

from mx_rcnn_tpu_torch.analysis.lockcheck import make_condition
from mx_rcnn_tpu_torch.serve.quarantine import validate_request
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

#: SLO lanes, in preemption-priority order.
LANES = ("interactive", "bulk")
DEFAULT_LANE = "bulk"


class QueueFull(RuntimeError):
    """Bounded queue is at capacity — reject the request (backpressure)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before the device could run it.
    (Defined here so the batcher's expired-request sweep can resolve
    futures without importing the engine; ``serve.engine`` re-exports
    it, which is where most callers import it from.)"""


@dataclass
class Request:
    """One prepared image waiting for a device slot.

    ``image`` is already resized, (optionally) quantized, and padded to
    ``bucket`` — preparation happens in the submitting thread (see
    ``engine.submit``) so host preprocessing overlaps device execution
    of earlier batches.
    """

    image: "np.ndarray"                  # (bH, bW, 3) bucket-padded
    im_info: "np.ndarray"                # (3,) = (resized_h, resized_w, scale)
    orig_hw: Tuple[int, int]             # original image size, for final clip
    bucket: Tuple[int, int]
    enqueue_t: float = 0.0               # time.monotonic at submit
    deadline: Optional[float] = None     # absolute monotonic, or None
    future: Future = field(default_factory=Future)
    picked_t: float = 0.0                # set by next_batch (queue-wait metric)
    model: Optional[str] = None          # registry model id (None = default)
    lane: str = DEFAULT_LANE             # SLO class: "interactive" | "bulk"
    cache_key: Optional[Tuple] = None    # response-cache key (engine-set)
    digest: Optional[str] = None         # raw-input identity (containment)
    budget: Optional[object] = None      # quarantine.RetryBudget (engine-set)
    solo: bool = False                   # engine resubmit: release as batch-of-1
    tenant: Optional[str] = None         # fair-share identity (None = untagged)
    arm_version: Optional[int] = None    # rollout split arm (None = incumbent)
    # confidence-gated cascade (a later slice): `cascade` marks a cheap
    # first-pass request whose completion runs the gate; `escalated`
    # marks its flagship re-entry (already-admitted, like solo, but
    # batched normally); `raw_image` is the validated original pixels
    # kept so escalation can re-prepare for the flagship's config
    cascade: bool = False
    escalated: bool = False
    raw_image: Optional["np.ndarray"] = None
    # streaming mode (a later slice): frames of one stream are submitted in
    # order and DELIVERED in order (engine StreamTable gate); the
    # batcher additionally keeps them dispatch-ordered within a group —
    # a requeued earlier frame re-enters AHEAD of queued later frames
    # of the same stream (see submit)
    stream: Optional[str] = None
    frame: Optional[int] = None
    # streaming mask serving: resolve to (cls_dets, rles) via the
    # runner's canvas-RLE path instead of plain detections
    masks: bool = False

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline


class DynamicBatcher:
    """Thread-safe lane-scheduled micro-batcher (N producers, 1 consumer).

    ``next_batch`` blocks until a batch is ready per the release rules
    above, and returns ``None`` once closed and drained.
    """

    def __init__(
        self,
        max_batch: int,
        max_linger: float = 0.005,
        max_queue: int = 64,
        interactive_linger: float = 0.0,
        bulk_age_limit: float = 2.0,
        on_expired: Optional[Callable[[Request, float], None]] = None,
        fair=None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = int(max_batch)
        self.max_linger = float(max_linger)
        self.max_queue = int(max_queue)
        self.interactive_linger = float(interactive_linger)
        self.bulk_age_limit = float(bulk_age_limit)
        # engine hook: resolves a swept request's future + its metrics;
        # when unset the sweep resolves the future itself
        self.on_expired = on_expired
        # tenancy.WeightedFairScheduler (or None): picks which tenant
        # releases next; all its state is mutated under self._cond only
        self.fair = fair
        # keyed (model, bucket, lane, tenant): a batch is homogeneous in
        # all FOUR — tenant-pure batches are what make per-tenant service
        # attributable, and the tenant tag never reaches a runner signature
        self._queues: Dict[Tuple, deque] = {}
        self._count = 0
        self._closed = False
        self._cond = make_condition("DynamicBatcher._cond")
        self._last_bulk_release = time.monotonic()
        # scheduler counters (engine snapshot merges stats())
        self.preemptions = 0        # interactive released while bulk waited
        self.aged_releases = 0      # bulk released via the aging guard
        self.expired_swept = 0      # dead requests removed pre-pickup
        self.stream_reinserts = 0   # stream frames slotted ahead on re-entry
        self.released = {lane: 0 for lane in LANES}  # batches per lane
        self.released_by_tenant: Dict[Optional[str], int] = {}  # requests

    # ------------------------------------------------------------- producers
    def submit(self, req: Request) -> None:
        # structural gate in the *submitting* thread: a zero-dim or
        # dtype-object image must fail the caller, not crash the shared
        # assembler thread downstream
        validate_request(req)
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            # free dead capacity before judging fullness: under overload
            # with deadlines, expired requests must not hold live ones out
            self._sweep_expired(time.monotonic())
            # a solo resubmit is an already-admitted in-flight request
            # bouncing through containment; rejecting it here would turn
            # quarantine into request loss, so it re-enters above the cap
            # — a cascade escalation is the same in-flight re-entry
            # (admitted once at submit), just batched normally
            if self._count >= self.max_queue and not (req.solo or req.escalated):
                raise QueueFull(
                    f"serving queue at capacity ({self.max_queue}) — "
                    f"client should back off"
                )
            if not req.enqueue_t:
                req.enqueue_t = time.monotonic()
            if req.lane not in LANES:
                raise ValueError(f"unknown SLO lane {req.lane!r}")
            q = self._queues.setdefault(
                (req.model, req.bucket, req.lane, req.tenant), deque()
            )
            pos = None
            if req.stream is not None and req.frame is not None and q:
                # per-stream dispatch order: a re-entering
                # earlier frame (containment resubmit, cascade
                # escalation) slots in BEFORE queued later frames of
                # its stream, so the stream's delivery gate never has
                # to buffer behind a frame the scheduler put last
                pos = next(
                    (i for i, r in enumerate(q)
                     if r.stream == req.stream and r.frame is not None
                     and r.frame > req.frame),
                    None,
                )
            if pos is None:
                q.append(req)
            else:
                q.insert(pos, req)
                self.stream_reinserts += 1
            self._count += 1
            self._cond.notify()

    def pending(self) -> int:
        with self._cond:
            return self._count

    def queued_by_tenant(self) -> Dict[Optional[str], int]:
        """Queued request count per tenant — the engine's shed-first
        predicate reads this under pressure."""
        with self._cond:
            out: Dict[Optional[str], int] = {}
            for key, q in self._queues.items():
                if q:
                    out[key[3]] = out.get(key[3], 0) + len(q)
            return out

    def close(self) -> None:
        """Stop accepting; wake the consumer so it can drain and exit."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -------------------------------------------------------------- consumer
    def _release_time(self, head: Request, linger: float) -> float:
        """Latest moment worth waiting for more traffic on head's group."""
        cut = head.enqueue_t + linger
        if head.deadline is not None:
            # don't linger past the deadline itself; the engine budgets
            # execution time via its own expiry check at pickup
            cut = min(cut, head.deadline)
        return cut

    def _active_tenants(self) -> List[Optional[str]]:
        # caller holds self._cond
        seen: List[Optional[str]] = []
        for key, q in self._queues.items():
            if q and key[3] not in seen:
                seen.append(key[3])
        return seen

    def _select(self, now: float) -> Optional[Tuple[Tuple, float, Optional[str]]]:
        """Tenant-then-lane pick: (key, release_at, flag) for the group
        to serve next, or None when empty.  With a fair scheduler and
        more than one active tenant, the scheduler picks WHICH tenant
        gets the slot (pure pick — lingering re-selects don't skew
        credits) and the lane policy below runs over that tenant's
        groups only; otherwise it runs over everything.  ``flag`` is
        "aged" when the bulk-aging guard fired, "preempt" when
        interactive jumped a waiting bulk head, else None."""
        filtered = False
        tenant_filter = None
        if self.fair is not None:
            active = self._active_tenants()
            if len(active) > 1:
                tenant_filter = self.fair.pick(active)
                filtered = True
        oldest = {lane: None for lane in LANES}  # lane → (enqueue_t, key)
        for key, q in self._queues.items():
            if not q:
                continue
            if filtered and key[3] != tenant_filter:
                continue
            t = q[0].enqueue_t
            lane = key[2]
            if oldest[lane] is None or t < oldest[lane][0]:
                oldest[lane] = (t, key)
        bulk, inter = oldest["bulk"], oldest["interactive"]
        if (
            bulk is not None
            and now - bulk[0] >= self.bulk_age_limit
            and now - self._last_bulk_release >= self.bulk_age_limit
        ):
            return bulk[1], now, "aged"
        if inter is not None:
            head = self._queues[inter[1]][0]
            ready = self._release_time(head, self.interactive_linger)
            return inter[1], ready, ("preempt" if bulk is not None else None)
        if bulk is not None:
            head = self._queues[bulk[1]][0]
            return bulk[1], self._release_time(head, self.max_linger), None
        return None

    def _expire_one(self, req: Request, now: float) -> None:
        cb = self.on_expired
        if cb is not None:
            cb(req, now)
            return
        try:
            req.future.set_exception(
                DeadlineExceeded(
                    f"deadline passed {now - req.deadline:.3f}s before "
                    f"device pickup (swept from queue)"
                )
            )
        except InvalidStateError:
            pass

    def _sweep_expired(self, now: float, skip: Optional[Tuple] = None) -> int:
        """Drop every expired queued request (holding ``_cond``), resolve
        each future immediately, free its capacity.  ``skip`` exempts the
        group about to release — an expired head that is already
        releasable belongs to the engine's pickup-time expiry check (and
        to existing release semantics), not the sweep."""
        swept: List[Request] = []
        for key, q in self._queues.items():
            if key == skip or not q:
                continue
            if not any(r.deadline is not None and r.expired(now) for r in q):
                continue
            kept = deque()
            while q:
                r = q.popleft()
                if r.deadline is not None and r.expired(now):
                    swept.append(r)
                else:
                    kept.append(r)
            self._queues[key] = kept
        if swept:
            self._count -= len(swept)
            self.expired_swept += len(swept)
            for r in swept:
                self._expire_one(r, now)
            self._cond.notify_all()  # capacity freed: wake blocked producers
        return len(swept)

    def next_batch(self, poll: float = 0.05) -> Optional[List[Request]]:
        """Block for the next (model, bucket, lane)-homogeneous batch (≤
        ``max_batch`` requests, FIFO within the group).  ``None`` =
        closed + drained."""
        with self._cond:
            while True:
                now = time.monotonic()
                choice = self._select(now)
                if choice is None:
                    if self._closed:
                        return None
                    self._cond.wait(timeout=poll)
                    continue
                key, release_at, flag = choice
                q = self._queues[key]
                full = len(q) >= self.max_batch
                # a solo head (containment resubmit) releases immediately
                # as a batch-of-1: isolating it is the whole point
                head_solo = bool(q) and q[0].solo
                if full or head_solo or self._closed or now >= release_at:
                    n = 1 if head_solo else min(len(q), self.max_batch)
                    batch = [q.popleft() for _ in range(n)]
                    self._count -= n
                    for r in batch:
                        r.picked_t = now
                    if flag == "aged":
                        self.aged_releases += 1
                    elif flag == "preempt":
                        self.preemptions += 1
                    self.released[key[2]] += 1
                    self.released_by_tenant[key[3]] = (
                        self.released_by_tenant.get(key[3], 0) + n
                    )
                    if self.fair is not None:
                        # the one fairness-state mutation per release:
                        # cost = requests served, credit spread over the
                        # tenants that still had queued work
                        self.fair.charge(key[3], n, self._active_tenants())
                    if key[2] == "bulk":
                        self._last_bulk_release = now
                    # the released group's own expiry is pickup-checked by
                    # the engine; everything still queued gets swept here
                    self._sweep_expired(now)
                    self._cond.notify_all()
                    return batch
                if self._sweep_expired(now, skip=key):
                    continue  # queues changed: re-select before sleeping
                # sleep until the head's release time, a new arrival, or
                # close — whichever first (poll also bounds how stale the
                # aging-guard check can get)
                self._cond.wait(timeout=min(release_at - now, poll))

    # ---------------------------------------------------------- reporting
    def stats(self) -> Dict:
        with self._cond:
            out = {
                "preemptions": self.preemptions,
                "aged_releases": self.aged_releases,
                "expired_swept": self.expired_swept,
                "stream_reinserts": self.stream_reinserts,
                "batches_by_lane": dict(self.released),
            }
            if self.released_by_tenant:
                out["released_by_tenant"] = {
                    str(t): n for t, n in self.released_by_tenant.items()
                }
            if self.fair is not None:
                out["fair"] = self.fair.snapshot()
            return out
