"""Serving observability: latency histograms + engine counters, JSON-out.

Percentiles are computed from fixed log-spaced histograms rather than a
sample reservoir: recording is O(1) with no allocation on the request
path, memory is constant regardless of traffic, and two histograms merge
by adding counts (multi-worker aggregation later).  The cost is bounded
relative error — bins are geometric with ratio ``(hi/lo)^(1/bins)``
(≈9% per bin at the defaults), which is far below the run-to-run noise
of any latency measurement this layer reports.

Style follows ``core/metrics.py`` (reset/update/get), but serving
metrics are cumulative-by-default: a load test reads one snapshot at the
end, and a long-running server exports monotonic counters (the
Prometheus convention) instead of windowed rates.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional

import numpy as np

from mx_rcnn_tpu_torch.analysis.lockcheck import make_lock


def merge_snapshots(snaps) -> Dict:
    """Merge JSON-safe snapshot dicts from N workers into one fleet
    view: numeric leaves SUM (counters and accumulated seconds — the
    same additive convention :meth:`LatencyHistogram.merge` uses for
    bins), nested dicts merge recursively, and non-numeric leaves
    (ports, states, version strings) keep the first worker's value.
    Adds ``n_sources`` at the top level so a reader can turn sums back
    into per-worker means."""
    snaps = [s for s in snaps if isinstance(s, dict)]

    def _merge(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            out = dict(a)
            for k, v in b.items():
                out[k] = _merge(out[k], v) if k in out else v
            return out
        num_a = isinstance(a, (int, float)) and not isinstance(a, bool)
        num_b = isinstance(b, (int, float)) and not isinstance(b, bool)
        if num_a and num_b:
            return a + b
        return a  # shape mismatch or non-numeric: first worker wins

    merged: Dict = {}
    for s in snaps:
        merged = _merge(merged, s) if merged else dict(s)
    merged["n_sources"] = len(snaps)
    return merged


class LatencyHistogram:
    """Log-spaced latency histogram, milliseconds domain.

    ``record`` takes SECONDS (what ``time.monotonic`` subtraction gives);
    all reported figures are milliseconds.
    """

    def __init__(self, lo_ms: float = 0.05, hi_ms: float = 120_000.0,
                 bins: int = 96):
        # upper edges of `bins` geometric bins; one extra overflow bucket
        self._edges = np.geomspace(lo_ms, hi_ms, bins)
        self._counts = np.zeros(bins + 1, np.int64)
        self._lock = make_lock("LatencyHistogram._lock")
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0

    def record(self, seconds: float) -> None:
        ms = max(float(seconds) * 1000.0, 0.0)
        idx = int(np.searchsorted(self._edges, ms, side="left"))
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.total_ms += ms
            if ms > self.max_ms:
                self.max_ms = ms

    def percentile(self, p: float) -> float:
        """p in [0, 100] → latency in ms (upper edge of the bin where the
        CDF crosses p); NaN when empty."""
        with self._lock:
            if self.count == 0:
                return float("nan")
            target = self.count * p / 100.0
            cum = np.cumsum(self._counts)
            idx = int(np.searchsorted(cum, target, side="left"))
        if idx >= len(self._edges):          # overflow bucket
            return self.max_ms
        # bin upper edge, clamped so no percentile exceeds the true max
        return float(min(self._edges[idx], self.max_ms))

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Add ``other``'s counts into this histogram (the log-binned
        design exists for exactly this: pool-level percentiles are the
        bin-wise sum of per-replica histograms).  Requires identical bin
        edges; returns self for chaining."""
        if len(self._edges) != len(other._edges) or not np.array_equal(
            self._edges, other._edges
        ):
            raise ValueError("cannot merge histograms with different bins")
        with other._lock:
            counts = other._counts.copy()
            count, total, mx = other.count, other.total_ms, other.max_ms
        with self._lock:
            self._counts += counts
            self.count += count
            self.total_ms += total
            if mx > self.max_ms:
                self.max_ms = mx
        return self

    @property
    def mean_ms(self) -> float:
        with self._lock:
            return self.total_ms / self.count if self.count else float("nan")

    def snapshot(self) -> Dict:
        return {
            "count": self.count,
            "mean_ms": round(self.mean_ms, 3) if self.count else None,
            "p50_ms": round(self.percentile(50), 3) if self.count else None,
            "p95_ms": round(self.percentile(95), 3) if self.count else None,
            "p99_ms": round(self.percentile(99), 3) if self.count else None,
            "max_ms": round(self.max_ms, 3) if self.count else None,
        }


class OverlapStats:
    """Per-replica overlapped-execution counters.

    A replica with a split-capable runner keeps up to ``inflight_depth``
    dispatches outstanding; these counters are the evidence of what that
    window bought:

    * ``inflight_hw`` — high-water mark of the in-flight window;
    * ``fetch_stall_ms`` — total wall time the worker blocked in
      ``complete()`` (device finish + D2H);
    * ``overlap_hidden_host_ms`` — host time (H2D staging and output
      fetches) spent while ANOTHER dispatch was in flight, i.e. the host
      gap the window actually hid behind device compute;
    * ``device_busy_fraction`` — 1 minus the fraction of the activity
      window spent fetching with NOTHING else in flight.  A sole
      in-flight fetch is the serial loop's signature device-idle gap;
      with depth ≥ 2 a sibling dispatch covers it, so the fraction
      approaches 1.  (The device may still be computing the batch being
      fetched, so this is a conservative lower bound, not a device-side
      trace.)
    * ``fetch_bytes`` / ``fetch_bytes_by_model`` — total
      bytes the ``complete()`` host copies actually moved, per model.
      This is the measured counter behind the device-postprocess fetch
      reduction (mask families: selected ``det_masks`` grids instead of
      the raw ``(R, S, S, K)`` stack).
    * ``paste_ms`` / ``paste_bytes`` (+ ``_by_model``) —
      host wall spent in the mask paste+RLE stage and the mask payload
      it consumed (device canvas bytes vs host S×S grid bytes).  These
      are first-class pool-merged counters alongside ``fetch_bytes``:
      the measured evidence behind the streaming bench's device-paste
      host-cost reduction.

    All methods are O(1) and lock-protected; ``note_depth`` is called at
    every window size change, ``note_fetch`` once per ``complete()``,
    ``note_paste`` once per mask_rles_for.
    """

    def __init__(self):
        self._lock = make_lock("OverlapStats._lock")
        self.inflight_hw = 0
        self.fetches = 0
        self.fetch_stall_s = 0.0
        self.hidden_host_s = 0.0
        self.idle_fetch_s = 0.0   # fetch time with an otherwise-empty window
        self.fetch_bytes = 0
        self.fetch_bytes_by_model: Dict[str, int] = {}
        # per-request cost accounting: dispatch→complete wall
        # per batch attributed to the serving model — pool-merged like
        # fetch_bytes, the counter behind the cascade's cost claim
        self.device_ms_by_model: Dict[str, float] = {}
        # streaming mask paste: host paste+RLE wall and the
        # mask payload it consumed — pool-merged like fetch_bytes
        self.pastes = 0
        self.paste_s = 0.0
        self.paste_bytes = 0
        self.paste_ms_by_model: Dict[str, float] = {}
        self.paste_bytes_by_model: Dict[str, int] = {}
        self._t0: Optional[float] = None   # first dispatch ever
        self._t_last: Optional[float] = None

    def note_depth(self, depth: int) -> None:
        now = time.monotonic()
        with self._lock:
            if depth > 0 and self._t0 is None:
                self._t0 = now
            if self._t0 is not None:
                self._t_last = now
            if depth > self.inflight_hw:
                self.inflight_hw = depth

    def note_fetch(
        self,
        seconds: float,
        hidden: bool,
        nbytes: int = 0,
        model: Optional[str] = None,
        device_ms: float = 0.0,
    ) -> None:
        s = max(float(seconds), 0.0)
        with self._lock:
            self.fetches += 1
            self.fetch_stall_s += s
            if hidden:
                self.hidden_host_s += s
            else:
                self.idle_fetch_s += s
            key = model if model is not None else "default"
            if nbytes:
                self.fetch_bytes += int(nbytes)
                self.fetch_bytes_by_model[key] = (
                    self.fetch_bytes_by_model.get(key, 0) + int(nbytes)
                )
            if device_ms:
                self.device_ms_by_model[key] = (
                    self.device_ms_by_model.get(key, 0.0) + float(device_ms)
                )

    def note_hidden(self, seconds: float) -> None:
        with self._lock:
            self.hidden_host_s += max(float(seconds), 0.0)

    def note_paste(
        self,
        seconds: float,
        nbytes: int = 0,
        model: Optional[str] = None,
    ) -> None:
        s = max(float(seconds), 0.0)
        with self._lock:
            self.pastes += 1
            self.paste_s += s
            key = model if model is not None else "default"
            self.paste_ms_by_model[key] = (
                self.paste_ms_by_model.get(key, 0.0) + s * 1e3
            )
            if nbytes:
                self.paste_bytes += int(nbytes)
                self.paste_bytes_by_model[key] = (
                    self.paste_bytes_by_model.get(key, 0) + int(nbytes)
                )

    def snapshot(self) -> Dict:
        with self._lock:
            wall = (
                self._t_last - self._t0
                if self._t0 is not None and self._t_last is not None
                else 0.0
            )
            busy = (
                round(1.0 - self.idle_fetch_s / wall, 4)
                if wall > 0 else None
            )
            return {
                "inflight_hw": self.inflight_hw,
                "fetches": self.fetches,
                "fetch_stall_ms": round(self.fetch_stall_s * 1e3, 3),
                "overlap_hidden_host_ms": round(self.hidden_host_s * 1e3, 3),
                "device_busy_fraction": busy,
                "fetch_bytes": self.fetch_bytes,
                "fetch_bytes_by_model": dict(self.fetch_bytes_by_model),
                "device_ms_by_model": {
                    k: round(v, 3)
                    for k, v in self.device_ms_by_model.items()
                },
                "pastes": self.pastes,
                "paste_ms": round(self.paste_s * 1e3, 3),
                "paste_bytes": self.paste_bytes,
                "paste_ms_by_model": {
                    k: round(v, 3)
                    for k, v in self.paste_ms_by_model.items()
                },
                "paste_bytes_by_model": dict(self.paste_bytes_by_model),
            }


class ServeMetrics:
    """One bundle per engine: request counters, latency histograms, batch
    occupancy, queue-depth gauge, and (at snapshot time) the runner's
    compile counters."""

    def __init__(self):
        self._lock = make_lock("ServeMetrics._lock")
        # request-path histograms
        self.queue_wait = LatencyHistogram()    # enqueue → batch pickup
        self.service = LatencyHistogram()       # device dispatch → outputs
        self.e2e = LatencyHistogram()           # enqueue → result set
        # counters
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0      # backpressure (queue full) + oversize
        self.expired = 0       # deadline passed before execution
        self.retried = 0       # batch re-executions via RetryPolicy
        self.shed = 0          # rejected early on low healthy fraction
        self.stopped = 0       # resolved EngineStopped at teardown
        # tenant-fair front door
        self.over_budget = 0   # token-bucket rejections (TenantOverBudget)
        self.tenant_shed = 0   # over-share tenant shed under pressure
        # confidence-gated cascade: decisions of the
        # first-pass gate — together they count every gated cheap pass
        self.escalations = 0           # cheap pass uncertain → flagship
        self.first_pass_sufficient = 0  # cheap pass served the request
        # query-of-death containment stages
        self.invalid = 0       # rejected at the admission gate
        self.poisoned = 0      # failed fast on a quarantined digest
        self.exhausted = 0     # retry budget spent: RetriesExhausted
        self.resubmitted = 0   # split from an implicated batch, solo retry
        self.exonerated = 0    # suspects cleared by later success
        # streaming mask paste: engine-level mirror of the
        # replica OverlapStats paste counters — host paste+RLE wall and
        # mask payload per served mask frame, summed by merge_snapshots
        # across the fleet gateway like every other numeric leaf
        self.mask_frames = 0
        self.paste_ms = 0.0
        self.paste_bytes = 0
        # batch occupancy: real requests per padded device-batch slot
        self.batches = 0
        self.batch_real = 0
        self.batch_slots = 0
        # queue depth gauge
        self.queue_depth = 0
        self.queue_depth_max = 0
        # per-model breakdown (multi-tenancy): populated only
        # for requests that carried an explicit model id, so the
        # single-model deployment pays nothing and reports nothing extra
        self.by_model: Dict[str, Dict] = {}
        # per-lane breakdown (SLO tiers): every request lands in exactly
        # one lane ("bulk" when untagged), so lane histograms partition
        # the aggregate ones above
        self.by_lane: Dict[str, Dict] = {}
        # per-tenant breakdown: populated only for requests
        # that carried a tenant tag — the fairness-isolation evidence
        # (an aggressor's shed storm must not move the victim histogram)
        self.by_tenant: Dict[str, Dict] = {}
        # per-version breakdown: populated only while a
        # rollout controller is attached — the split-arm evidence
        # (candidate p99 and error rate held against the incumbent's)
        self.by_version: Dict[str, Dict] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def record_model(self, model: str, e2e_s: Optional[float] = None,
                     ok: bool = True) -> None:
        """Per-model completion/failure counters + e2e latency histogram
        — the tenancy-isolation evidence (model A's swap must not move
        model B's histogram)."""
        with self._lock:
            m = self.by_model.get(model)
            if m is None:
                m = self.by_model[model] = {
                    "completed": 0, "failed": 0, "e2e": LatencyHistogram(),
                }
            m["completed" if ok else "failed"] += 1
        if ok and e2e_s is not None:
            m["e2e"].record(e2e_s)

    def _lane(self, lane: str) -> Dict:
        # caller holds self._lock
        m = self.by_lane.get(lane)
        if m is None:
            m = self.by_lane[lane] = {
                "completed": 0, "failed": 0, "expired": 0,
                "batches": 0, "batch_real": 0, "batch_slots": 0,
                "queue_wait": LatencyHistogram(), "e2e": LatencyHistogram(),
            }
        return m

    def record_lane(self, lane: str, e2e_s: Optional[float] = None,
                    queue_wait_s: Optional[float] = None,
                    ok: bool = True, expired: bool = False) -> None:
        """Per-lane completion/failure/expiry counters + latency
        histograms — the SLO-tier evidence (a bulk backlog must not move
        the interactive histogram)."""
        with self._lock:
            m = self._lane(lane)
            if expired:
                m["expired"] += 1
            else:
                m["completed" if ok else "failed"] += 1
        if ok and not expired:
            if e2e_s is not None:
                m["e2e"].record(e2e_s)
            if queue_wait_s is not None:
                m["queue_wait"].record(queue_wait_s)

    def _tenant(self, tenant: str) -> Dict:
        # caller holds self._lock
        m = self.by_tenant.get(tenant)
        if m is None:
            m = self.by_tenant[tenant] = {
                "completed": 0, "failed": 0, "expired": 0,
                "shed": 0, "rejected": 0,
                "queue_wait": LatencyHistogram(), "e2e": LatencyHistogram(),
            }
        return m

    def record_tenant(self, tenant: Optional[str],
                      e2e_s: Optional[float] = None,
                      queue_wait_s: Optional[float] = None,
                      ok: bool = True, expired: bool = False,
                      shed: bool = False, rejected: bool = False) -> None:
        """Per-tenant counters + latency histograms — same partition
        shape as :meth:`record_lane` so the fairness bench can hold one
        tenant's p99 against another's shed count.  No-op for untagged
        requests (``tenant=None``): the single-tenant deployment pays
        and reports nothing extra."""
        if tenant is None:
            return
        with self._lock:
            m = self._tenant(tenant)
            if shed:
                m["shed"] += 1
                return
            if rejected:
                m["rejected"] += 1
                return
            if expired:
                m["expired"] += 1
            else:
                m["completed" if ok else "failed"] += 1
        if ok and not expired:
            if e2e_s is not None:
                m["e2e"].record(e2e_s)
            if queue_wait_s is not None:
                m["queue_wait"].record(queue_wait_s)

    def record_version(self, model: str, version: int,
                       e2e_s: Optional[float] = None,
                       ok: bool = True) -> None:
        """Per-(model, version) completion/failure counters + e2e
        latency histogram — the rollout's per-arm partition (same shape
        as :meth:`record_model`, keyed ``"<model>:v<version>"``)."""
        key = f"{model}:v{int(version)}"
        with self._lock:
            m = self.by_version.get(key)
            if m is None:
                m = self.by_version[key] = {
                    "completed": 0, "failed": 0, "e2e": LatencyHistogram(),
                }
            m["completed" if ok else "failed"] += 1
        if ok and e2e_s is not None:
            m["e2e"].record(e2e_s)

    def record_lane_batch(self, lane: str, real: int, slots: int) -> None:
        with self._lock:
            m = self._lane(lane)
            m["batches"] += 1
            m["batch_real"] += real
            m["batch_slots"] += slots

    def record_paste(self, ms: float, nbytes: int = 0) -> None:
        """One served mask frame's paste+RLE host wall + payload."""
        with self._lock:
            self.mask_frames += 1
            self.paste_ms += float(ms)
            self.paste_bytes += int(nbytes)

    def record_batch(self, real: int, slots: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_real += real
            self.batch_slots += slots

    def record_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = depth
            if depth > self.queue_depth_max:
                self.queue_depth_max = depth

    @property
    def occupancy(self) -> float:
        with self._lock:
            return (
                self.batch_real / self.batch_slots
                if self.batch_slots else float("nan")
            )

    def snapshot(self, compile_cache=None) -> Dict:
        with self._lock:
            out = {
                "requests": {
                    "submitted": self.submitted,
                    "completed": self.completed,
                    "failed": self.failed,
                    "rejected": self.rejected,
                    "expired": self.expired,
                    "retried": self.retried,
                    "shed": self.shed,
                    "stopped": self.stopped,
                    "over_budget": self.over_budget,
                    "tenant_shed": self.tenant_shed,
                    "invalid": self.invalid,
                    "poisoned": self.poisoned,
                    "exhausted": self.exhausted,
                    "resubmitted": self.resubmitted,
                    "exonerated": self.exonerated,
                    "escalations": self.escalations,
                    "first_pass_sufficient": self.first_pass_sufficient,
                },
                "batches": {
                    "count": self.batches,
                    "real_images": self.batch_real,
                    "slots": self.batch_slots,
                    "occupancy": (
                        round(self.batch_real / self.batch_slots, 4)
                        if self.batch_slots else None
                    ),
                },
                "queue": {
                    "depth": self.queue_depth,
                    "depth_max": self.queue_depth_max,
                },
                "paste": {
                    "mask_frames": self.mask_frames,
                    "paste_ms": round(self.paste_ms, 3),
                    "paste_bytes": self.paste_bytes,
                },
            }
        out["latency"] = {
            "queue_wait": self.queue_wait.snapshot(),
            "service": self.service.snapshot(),
            "e2e": self.e2e.snapshot(),
        }
        with self._lock:
            by_model = dict(self.by_model)
            by_lane = dict(self.by_lane)
            by_tenant = dict(self.by_tenant)
            by_version = dict(self.by_version)
        if by_model:
            out["models"] = {
                mid: {
                    "completed": m["completed"],
                    "failed": m["failed"],
                    "e2e": m["e2e"].snapshot(),
                }
                for mid, m in by_model.items()
            }
        if by_lane:
            out["lanes"] = {
                lane: {
                    "completed": m["completed"],
                    "failed": m["failed"],
                    "expired": m["expired"],
                    "batches": m["batches"],
                    "occupancy": (
                        round(m["batch_real"] / m["batch_slots"], 4)
                        if m["batch_slots"] else None
                    ),
                    "queue_wait": m["queue_wait"].snapshot(),
                    "e2e": m["e2e"].snapshot(),
                }
                for lane, m in by_lane.items()
            }
        if by_tenant:
            out["tenants"] = {
                t: {
                    "completed": m["completed"],
                    "failed": m["failed"],
                    "expired": m["expired"],
                    "shed": m["shed"],
                    "rejected": m["rejected"],
                    "queue_wait": m["queue_wait"].snapshot(),
                    "e2e": m["e2e"].snapshot(),
                }
                for t, m in by_tenant.items()
            }
        if by_version:
            out["versions"] = {
                k: {
                    "completed": m["completed"],
                    "failed": m["failed"],
                    "e2e": m["e2e"].snapshot(),
                }
                for k, m in by_version.items()
            }
        if compile_cache is not None:
            out["compile"] = compile_cache.snapshot()
        return out

    def to_json(self, compile_cache=None, path: Optional[str] = None) -> str:
        s = json.dumps(self.snapshot(compile_cache), indent=1)
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s
