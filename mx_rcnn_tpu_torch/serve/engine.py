"""Threaded serving loop: submit → batcher → device → per-request futures
(port of ``mx_rcnn_tpu/serve/engine.py`` over a single :class:`ServeRunner`).

Thread layout:

  * N client threads: ``submit`` validates and prepares the image
    (resize/quantize/pad) in the CALLER's thread, so host preparation of
    the next requests overlaps the device's work on earlier batches, then
    enqueues into the bounded batcher (``QueueFull`` → backpressure).
  * 1 assembler thread: pulls (model, bucket, lane)-homogeneous batches
    from the batcher, fails requests whose deadline already passed
    (cheaper than running them), pads to ``max_batch``, and hands the
    batch to…
  * ``in_flight`` completion threads of a
    :class:`~mx_rcnn_tpu_torch.data.assembler.CompletionPool`: each runs
    ``runner.run`` (its ``dispatch`` enqueues the forward, its
    ``complete`` waits for that batch's copy alone), wrapped in the
    engine's :class:`~mx_rcnn_tpu_torch.core.resilience.RetryPolicy`, then
    the per-request detections and the futures.  The pool's blocking
    submit keeps the assembler at most ``in_flight`` batches ahead, so one
    thread's forward is enqueued while another waits for its outputs.

Every request resolves exactly once: detections, or
:class:`DeadlineExceeded` / :class:`QueueFull` /
:class:`~mx_rcnn_tpu_torch.serve.buckets.BucketOverflow` / the predict
error after retries / :class:`EngineStopped` when the engine is torn down
first (``stop`` sweeps the live-request registry, so no submitter blocks
forever on a dead engine).

Containment without a replica pool: with a
:class:`~mx_rcnn_tpu_torch.serve.quarantine.QuarantineTable`
(``quarantine=``), every request is digested at admission and carries a
retry budget; a batch that fails past its retries counts as one trip of
its members, the members with budget left are resubmitted solo, and a
digest implicated in K independent trips fails fast as
:class:`PoisonRequest`.

The JAX engine's replica pool, tenants, autoscaler, rollout, cascade and
streams are later slices of the port (ROADMAP item 15): their arguments
and methods raise ``NotImplementedError`` instead of being ignored.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional

import numpy as np
import torch

from mx_rcnn_tpu_torch.analysis.lockcheck import make_lock
from mx_rcnn_tpu_torch.core.resilience import RetryPolicy, make_retry_policy
from mx_rcnn_tpu_torch.data.assembler import CompletionPool
from mx_rcnn_tpu_torch.serve.batcher import (
    DEFAULT_LANE,
    LANES,
    DeadlineExceeded,
    DynamicBatcher,
    QueueFull,
    Request,
)
from mx_rcnn_tpu_torch.serve.metrics import ServeMetrics
from mx_rcnn_tpu_torch.serve.quarantine import (
    InvalidRequest,
    PoisonRequest,
    RetriesExhausted,
    RetryBudget,
    request_digest,
    validate_image,
)
from mx_rcnn_tpu_torch.serve.registry import UnknownModel
from mx_rcnn_tpu_torch.serve.runner import ServeRunner

__all__ = [
    "DeadlineExceeded", "EngineStopped", "ServingEngine", "StreamTable",
    "InvalidRequest", "PoisonRequest", "QueueFull", "RetriesExhausted",
]


def _later_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is a later slice of the port (ROADMAP item 15); the port's "
        f"ServingEngine serves one ServeRunner")


class StreamTable:
    """The JAX engine's per-stream in-order delivery gate
    (``mx_rcnn_tpu/serve/streams.py``): a later slice of the port."""

    def __init__(self, *args, **kwargs):
        raise _later_slice("StreamTable (per-stream in-order delivery)")


class EngineStopped(RuntimeError):
    """The engine was torn down before this request completed: a terminal
    resolution, so no submitter is left blocked on a future the engine will
    never touch again."""


class ServingEngine:
    """Online inference front end over a :class:`ServeRunner`."""

    def __init__(
        self,
        runner: ServeRunner,
        max_linger: float = 0.005,
        max_queue: int = 64,
        in_flight: int = 2,
        retry: Optional[RetryPolicy] = None,
        interactive_linger: float = 0.0,
        bulk_age_limit: float = 2.0,
        response_cache=None,
        retry_budget: int = 8,
        tenants=None,
        quarantine=None,
    ):
        if hasattr(runner, "replicas"):
            raise _later_slice("a ReplicaPool runner (replicas, routing, hedging)")
        if tenants is not None:
            raise _later_slice("tenants= (token-bucket admission, weighted-fair release)")
        self.runner = runner
        self.tenants = None
        self.batcher = DynamicBatcher(
            runner.max_batch, max_linger=max_linger, max_queue=max_queue,
            interactive_linger=interactive_linger, bulk_age_limit=bulk_age_limit,
            on_expired=self._expire_swept,
        )
        # idempotent response cache, keyed by image digest per (model, live
        # version, precision); the registry's live-pointer hook invalidates
        # it on a swap, so a hit is never stale
        self.response_cache = response_cache
        if response_cache is not None:
            runner.registry.subscribe_live(response_cache.invalidate_model)
        self.metrics = ServeMetrics()
        self.retry = retry if retry is not None else make_retry_policy("serve")
        self._in_flight = max(1, int(in_flight))
        self._pool: Optional[CompletionPool] = None
        self._assembler: Optional[threading.Thread] = None
        self._started = False
        self._quarantine = quarantine if quarantine is not None else getattr(
            runner, "quarantine", None)
        self._retry_budget = max(1, int(retry_budget))
        self._aborting = False
        # every not-yet-resolved request, so stop() can sweep leftovers
        # with a terminal EngineStopped instead of stranding submitters
        self._live: Dict[int, Request] = {}
        self._live_lock = make_lock("ServingEngine._live_lock")

    # ---------------------------------------------------------- lifecycle
    def start(self, warmup: bool = True) -> "ServingEngine":
        """Warm the runner up (every rung, the parity gates, the kernels'
        builds), then start the assembler and the completion threads: no
        thread of the engine starts before the CUDA libraries are built."""
        if self._started:
            return self
        if warmup:
            self.runner.warmup()
        self._pool = CompletionPool(self._in_flight, depth=self._in_flight,
                                    name="serve-complete")
        self._assembler = threading.Thread(target=self._assemble_loop, name="serve-assemble",
                                           daemon=True)
        self._started = True
        self._assembler.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop accepting and join the threads.  ``drain=True`` finishes the
        queued work first; ``drain=False`` aborts: queued batches are failed
        instead of dispatched.  Either way every pending future is resolved
        (terminal :class:`EngineStopped`) before this returns.  An in-flight
        model swap is cancelled FIRST, and its controller thread joined, so
        no swap-side device work runs after stop returns."""
        if not self._started:
            return
        self.runner.registry.cancel_swaps(wait=True)
        if not drain:
            self._aborting = True
        self.batcher.close()
        if self._assembler is not None:
            self._assembler.join()
        # request futures already carry per-request failures; a drain must
        # not re-raise them at shutdown
        if self._pool is not None:
            self._pool.close(raise_errors=False)
        self._started = False
        with self._live_lock:
            leftovers = list(self._live.values())
            self._live.clear()
        stopped = EngineStopped("engine stopped before request completed")
        for r in leftovers:
            try:
                r.future.set_exception(stopped)
            except InvalidStateError:
                continue
            self.metrics.inc("stopped")

    def attach_autoscaler(self, policy=None, signal_fn=None, start=True):
        raise _later_slice("attach_autoscaler (elastic replica capacity)")

    def attach_rollout(self, policy=None):
        raise _later_slice("attach_rollout (progressive rollout)")

    def attach_cascade(self, policy):
        raise _later_slice("attach_cascade (confidence-gated cascade)")

    def _precision_tag(self, model: Optional[str]) -> str:
        """The serving precision of ``model`` on this engine's runner: part
        of the response-cache key, so rungs never share bytes."""
        return self.runner._precision_for(self._resolved_mid(model))

    def _resolved_mid(self, model: Optional[str]) -> str:
        return self.runner.default_model if model is None else model

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- client
    def _lane_for(self, model: Optional[str], lane: Optional[str]) -> str:
        """A request's SLO lane: an explicit tag wins, else the model's
        registry-declared SLO class."""
        if lane is not None:
            if lane not in LANES:
                raise ValueError(f"unknown SLO lane {lane!r}")
            return lane
        return self.runner.registry.slo_class(model) if self.runner.registry else DEFAULT_LANE

    def _live_version(self, model: Optional[str]) -> Optional[int]:
        try:
            return int(self.runner.registry.live(model).version)
        except Exception:  # noqa: BLE001 — no live version = no caching
            return None

    def submit(
        self,
        im: np.ndarray,
        deadline_s: Optional[float] = None,
        model: Optional[str] = None,
        lane: Optional[str] = None,
        tenant: Optional[str] = None,
        stream: Optional[str] = None,
        frame: Optional[int] = None,
        masks: bool = False,
    ) -> Future:
        """Enqueue one image; returns a Future resolving to the per-class
        detections list (``masks=True``: ``(cls_dets, rles)``, canvas-space
        mask RLEs from the runner's :meth:`ServeRunner.mask_rles_for`, for a
        mask family).  ``model`` selects a registry family (None = the
        default model); ``lane`` tags the SLO class (``"interactive"`` |
        ``"bulk"``, None = the model's registry default).  ``tenant`` and
        ``stream``/``frame`` belong to later slices and raise
        ``NotImplementedError``.  Raises
        :class:`~mx_rcnn_tpu_torch.serve.quarantine.InvalidRequest` (the
        admission gate),
        :class:`~mx_rcnn_tpu_torch.serve.quarantine.PoisonRequest` (a
        quarantined digest),
        :class:`~mx_rcnn_tpu_torch.serve.buckets.BucketOverflow` (oversize),
        :class:`~mx_rcnn_tpu_torch.serve.batcher.QueueFull` (backpressure)
        or :class:`~mx_rcnn_tpu_torch.serve.registry.UnknownModel`
        synchronously; all count as ``rejected``."""
        if tenant is not None:
            raise _later_slice("tenant= (multi-tenant admission)")
        if stream is not None or frame is not None:
            raise _later_slice("stream= / frame= (per-stream in-order delivery)")
        if not self._started:
            raise RuntimeError("engine not started")
        reg = self.runner.registry
        if model is not None and not reg.has(model):
            self.metrics.inc("rejected")
            raise UnknownModel(model)
        # admission gate: malformed work fails the CALLER with a typed
        # error before it can reach the batcher or the assembler thread;
        # registry-declared per-model bounds tighten the default limits
        try:
            im = validate_image(im, reg.limits(model))
        except InvalidRequest:
            self.metrics.inc("invalid")
            self.metrics.inc("rejected")
            raise
        digest = None
        if self._quarantine is not None:
            digest = request_digest(im)
            if self._quarantine.quarantined(digest):
                # a quarantined query of death costs no queue slot
                self.metrics.inc("poisoned")
                self.metrics.inc("rejected")
                raise PoisonRequest(f"digest {digest[:12]} is quarantined (query of death)")
        lane = self._lane_for(model, lane)
        cache_key = None
        # mask requests bypass the response cache: a (dets, rles) tuple must
        # never collide with a plain-detections entry for the same bytes
        if self.response_cache is not None and not masks:
            t0 = time.monotonic()
            version = self._live_version(model)
            if version is not None:
                mid = self._resolved_mid(model)
                cache_key = self.response_cache.key_for(im, mid, version,
                                                        self._precision_tag(mid))
                hit = self.response_cache.get(cache_key)
                if hit is not None:
                    # byte-identical by construction: the stored arrays ARE
                    # what the miss returned
                    return self._cached_future(hit, t0, lane, model)
        deadline = time.monotonic() + deadline_s if deadline_s is not None else None
        try:
            req = self.runner.make_request(im, deadline=deadline, model=model)
            req.lane = lane
            req.cache_key = cache_key
            req.masks = bool(masks)
            if digest is not None:
                req.digest = digest
                req.budget = RetryBudget(self._retry_budget)
            self.batcher.submit(req)
        except Exception:
            self.metrics.inc("rejected")
            raise
        with self._live_lock:
            self._live[id(req)] = req
            if req.future.done():
                # a concurrent sweep resolved it between batcher.submit and
                # here: no dead entry in the live set
                self._live.pop(id(req), None)
        self.metrics.inc("submitted")
        self.metrics.record_queue_depth(self.batcher.pending())
        return req.future

    def _cached_future(self, hit, t0: float, lane: str, model: Optional[str]) -> Future:
        """Resolve a response-cache hit: a completed Future plus the request
        accounting a recompute would have produced."""
        f: Future = Future()
        f.set_result(hit)
        self.metrics.inc("submitted")
        self.metrics.inc("completed")
        e2e = time.monotonic() - t0
        self.metrics.e2e.record(e2e)
        self.metrics.record_lane(lane, e2e_s=e2e)
        if model is not None:
            self.metrics.record_model(model, e2e)
        return f

    # ------------------------------------------------------------- device
    def _expire_swept(self, req: Request, now: float) -> None:
        """Batcher sweep hook: a queued request's deadline passed before any
        batch could take it; fail it now.  Runs under the batcher's
        condition lock; the callees take only leaf locks."""
        self.metrics.inc("expired")
        self.metrics.record_lane(req.lane, expired=True)
        self._resolve(req, exc=DeadlineExceeded(
            f"deadline passed {now - req.deadline:.3f}s before device pickup "
            f"(swept from queue)"))

    def _resolve(self, req: Request, result=None, exc: Optional[BaseException] = None) -> bool:
        """Resolve one request exactly once and retire it from the live
        registry; False when it already resolved elsewhere (e.g. swept by a
        concurrent ``stop``)."""
        with self._live_lock:
            self._live.pop(id(req), None)
        try:
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(result)
            return True
        except InvalidStateError:
            return False

    def _assemble_loop(self) -> None:
        while True:
            batch_reqs = self.batcher.next_batch()
            if batch_reqs is None:
                return
            if self._aborting:
                stopped = EngineStopped("engine aborted before dispatch")
                for r in batch_reqs:
                    if self._resolve(r, exc=stopped):
                        self.metrics.inc("stopped")
                continue
            now = time.monotonic()
            live: List[Request] = []
            for r in batch_reqs:
                if r.expired(now):
                    self.metrics.inc("expired")
                    self.metrics.record_lane(r.lane, expired=True)
                    self._resolve(r, exc=DeadlineExceeded(
                        f"deadline passed {now - r.deadline:.3f}s before device pickup"))
                else:
                    self.metrics.queue_wait.record(r.picked_t - r.enqueue_t)
                    live.append(r)
            self.metrics.record_queue_depth(self.batcher.pending())
            if not live:
                continue
            batch = self.runner.assemble(live)
            # pool submit blocks at depth=in_flight: at most in_flight
            # batches between dispatch and completion
            self._pool.submit(self._complete, live, batch)

    def _complete(self, reqs: List[Request], batch: Dict[str, np.ndarray]) -> None:
        # runs on a completion-pool worker; its depth slot frees when this
        # returns, unblocking the assembler.  Inference mode is per thread:
        # this worker's own forwards and host work run under it
        with torch.inference_mode():
            self._complete_batch(reqs, batch)

    def _complete_batch(self, reqs: List[Request], batch: Dict[str, np.ndarray]) -> None:
        t0 = time.monotonic()
        model = reqs[0].model
        lane = reqs[0].lane
        try:
            out = self._run_batch(batch, model)
        except Exception as e:
            self._settle_failed(reqs, e)
            return
        self.metrics.service.record(time.monotonic() - t0)
        self.metrics.record_batch(len(reqs), self.runner.max_batch)
        self.metrics.record_lane_batch(lane, len(reqs), self.runner.max_batch)
        for k, r in enumerate(reqs):
            # a request that expired while its batch ran reports
            # DeadlineExceeded, not a late success
            if r.expired():
                self.metrics.inc("expired")
                self.metrics.record_lane(r.lane, expired=True)
                self._resolve(r, exc=DeadlineExceeded("deadline passed while the batch was in flight"))
                continue
            try:
                if r.masks:
                    dets = self.runner.mask_rles_for(out, batch, k, orig_hw=r.orig_hw, model=model)
                    self.metrics.record_paste(self.runner.last_paste_ms,
                                              self.runner.last_paste_bytes)
                else:
                    dets = self.runner.detections_for(out, batch, k, orig_hw=r.orig_hw,
                                                      model=model)
            except Exception as e:  # postprocess bug: fail this request
                self._fail_one(r, e)
                continue
            if r.cache_key is not None and self.response_cache is not None:
                # store only if the version the key was minted against still
                # serves: a swap that landed mid-flight must not seed the
                # cache under a version that did not produce these bytes
                if self._live_version(model) == r.cache_key[1]:
                    self.response_cache.put(r.cache_key, dets)
            if self._quarantine is not None and r.digest is not None:
                # a suspect that completes cleanly was a co-batched
                # bystander: drop the suspicion
                if self._quarantine.exonerate(r.digest):
                    self.metrics.inc("exonerated")
            self.metrics.inc("completed")
            e2e_s = time.monotonic() - r.enqueue_t
            self.metrics.e2e.record(e2e_s)
            if model is not None:
                self.metrics.record_model(model, e2e_s)
            self.metrics.record_lane(r.lane, e2e_s, queue_wait_s=r.picked_t - r.enqueue_t)
            self._resolve(r, dets)

    def _run_batch(self, batch: Dict[str, np.ndarray], model: Optional[str]):
        """The live-version predict, under the engine's RetryPolicy (a
        transient fault reruns the whole batch)."""

        def attempt_run(attempt: int):
            if attempt:
                self.metrics.inc("retried")
            return self.runner.run(batch, model=model)

        return self.retry.run(attempt_run)

    # -------------------------------------------------- containment triage
    def _fail_one(self, req: Request, exc: BaseException) -> None:
        self.metrics.inc("failed")
        if req.model is not None:
            self.metrics.record_model(req.model, ok=False)
        self.metrics.record_lane(req.lane, ok=False)
        self._resolve(req, exc=exc)

    def _settle_failed(self, reqs: List[Request], exc: BaseException) -> None:
        """Batch-level failure triage.  Without a quarantine table, every
        member fails with the batch's error.  With one, the failure counts
        as one trip of the members' digests, and each member settles on its
        own: a quarantined digest fails fast as :class:`PoisonRequest`, a
        member with budget left is resubmitted solo (the next failure then
        names it alone), and a spent budget resolves
        :class:`RetriesExhausted`."""
        qt = self._quarantine
        if qt is not None:
            qt.note_trip([(r.digest, None) for r in reqs if r.digest is not None],
                         reason=repr(exc))
        for r in reqs:
            if qt is not None and r.digest is not None and qt.quarantined(r.digest):
                self.metrics.inc("poisoned")
                self._fail_one(r, PoisonRequest(
                    f"digest {r.digest[:12]} quarantined after failed batches"))
                continue
            budget = r.budget
            if (qt is not None and budget is not None and budget.remaining > 0
                    and self._started and not self._aborting):
                self._resubmit(r)
                continue
            if budget is not None and budget.remaining <= 0:
                e: BaseException = RetriesExhausted(
                    f"retry budget {budget.total} spent; last error: {exc!r}")
                e.__cause__ = exc
                self.metrics.inc("exhausted")
                self._fail_one(r, e)
                continue
            self._fail_one(r, exc)

    def _resubmit(self, req: Request) -> None:
        """Solo retry of one member of a failed batch; the budget's spend
        bounds the loop, and ``solo`` makes the batcher release it as a
        batch of 1."""
        try:
            req.budget.spend("resubmit")
        except RetriesExhausted as e:
            self.metrics.inc("exhausted")
            self._fail_one(req, e)
            return
        req.solo = True
        self.metrics.inc("resubmitted")
        try:
            self.batcher.submit(req)
        except Exception as e:  # noqa: BLE001 — closed batcher at stop
            self._fail_one(req, e)

    # ----------------------------------------------------------- lifecycle
    def swap(self, model: str, checkpoint: str, block: bool = False,
             timeout: Optional[float] = None):
        """Hot-swap ``model`` to ``checkpoint`` while serving: a background
        :class:`~mx_rcnn_tpu_torch.serve.registry.SwapController` (load →
        verify → warm → commit between batches → canary, with rollback) on
        this engine's runner.  Returns the controller, or its result dict
        with ``block=True`` (which raises ``SwapRolledBack`` /
        ``SwapCancelled`` inline)."""
        return self.runner.registry.swap(model, checkpoint, target=self.runner, block=block,
                                         timeout=timeout)

    def admin(self, line: str):
        """Operator command surface (``tools/serve.py`` wires it):

        * ``swap <model> <checkpoint_dir>``: blocking hot swap
        * ``models``: registry snapshot

        ``rollout ...`` is a later slice and raises ``NotImplementedError``."""
        parts = line.split()
        if len(parts) == 3 and parts[0] == "swap":
            return self.swap(parts[1], parts[2], block=True)
        if parts == ["models"]:
            return self.runner.registry.snapshot()
        if parts and parts[0] == "rollout":
            raise _later_slice("the rollout admin command")
        raise ValueError(f"unknown admin command: {line!r}")

    # ---------------------------------------------------------- reporting
    def snapshot(self) -> Dict:
        out = self.metrics.snapshot(self.runner.compile_cache)
        out["scheduler"] = self.batcher.stats()
        if self.response_cache is not None:
            out["response_cache"] = self.response_cache.snapshot()
        if self.runner.parity:
            out["parity"] = dict(self.runner.parity)
        if self._pool is not None:
            out["completion"] = self._pool.stats()
        if self._quarantine is not None:
            out["quarantine"] = self._quarantine.snapshot()
        r = self.runner
        out["runner"] = {
            "dispatches": r.split_dispatches,
            "completes": r.split_completes,
            "fetch_stall_ms": round(r.fetch_stall_s * 1e3, 3),
            "fetch_bytes": r.fetch_bytes_total,
            "fetch_bytes_by_model": dict(r.fetch_bytes_by_model),
            "swaps_applied": r.swaps_applied,
            "pastes": r.pastes,
            "paste_ms": round(r.paste_ms_total, 3),
            "paste_bytes": r.paste_bytes_total,
        }
        if r.device_ms_by_model:
            out["device_ms_by_model"] = {k: round(v, 3) for k, v in r.device_ms_by_model.items()}
        out["registry"] = r.registry.snapshot()
        return out
