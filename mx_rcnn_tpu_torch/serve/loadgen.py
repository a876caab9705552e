"""Deterministic synthetic load generator for the serving engine.

Closed-loop: ``concurrency`` client threads each submit a request and
block on its future before submitting the next — the standard way to
saturate a serving stack without modeling an arrival process.  All
randomness (per-request image size from a mixed-aspect menu, pixel
content) is derived from ``seed`` + request index BEFORE any thread
races, so two runs offer byte-identical traffic regardless of thread
scheduling; only timings differ.

Mixed sizes are the point: they exercise every ladder bucket and prove
(via the runner's CompileCache) that traffic adds no signature after
warmup.

Port of ``mx_rcnn_tpu/serve/loadgen.py``.  The tenant mix (``tenants=``)
and the streaming load generator (:func:`run_stream_load`) belong to later slices
of the port (tenancy, streams) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from mx_rcnn_tpu_torch.serve.batcher import QueueFull

# landscape / portrait / small — covers both default bucket orientations
DEFAULT_SIZES: Tuple[Tuple[int, int], ...] = (
    (480, 640),
    (640, 480),
    (300, 500),
)


def synthetic_image(index: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Deterministic RGB noise image for request ``index``."""
    rng = np.random.RandomState((seed * 1_000_003 + index) % (2**31 - 1))
    return rng.randint(0, 256, (h, w, 3)).astype(np.float32)


#: poison_mix flavors.  The malformed three must be rejected
#: at the admission gate; "qod" is a WELL-FORMED query of death — valid
#: pixels whose digest the bench wires to a ``poison_*`` fault injector.
POISON_FLAVORS = ("qod", "nan", "empty", "objdtype")


def qod_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """The deterministic query-of-death image for size ``(h, w)``.
    Depends on (h, w, seed) only — NOT the request index — so every qod
    request of one size shares a single digest, which is what lets the
    bench compute ``request_digest(qod_image(...))`` up front and key
    its fault spec on it."""
    rng = np.random.RandomState((seed * 7_777_777 + h * 10_007 + w)
                                % (2**31 - 1))
    return rng.randint(0, 256, (h, w, 3)).astype(np.float32)


def poison_image(flavor: str, index: int, h: int, w: int,
                 seed: int = 0) -> np.ndarray:
    """Materialize one poison_mix flavor for request ``index``."""
    if flavor == "qod":
        return qod_image(h, w, seed)
    if flavor == "nan":
        im = synthetic_image(index, h, w, seed)
        im[0, 0, 0] = np.nan
        return im
    if flavor == "empty":
        return np.zeros((0, 0, 3), np.float32)
    if flavor == "objdtype":
        return np.empty((2, 2, 3), dtype=object)
    raise ValueError(f"unknown poison flavor {flavor!r}")


def diurnal_arrivals(
    num_requests: int,
    lo_rps: float,
    hi_rps: float,
    cycles: float = 1.0,
    seed: int = 0,
) -> Tuple[float, ...]:
    """Trace-driven arrival offsets (seconds from start) following a
    diurnal ramp: the instantaneous rate sweeps sinusoidally between
    ``lo_rps`` and ``hi_rps`` over ``cycles`` full periods.  Built by
    integrating the rate curve and inverse-sampling uniform quantiles —
    fully deterministic for a given argument tuple (``seed`` only
    perturbs sub-slot jitter), so two runs replay the identical trace."""
    if num_requests < 1:
        return ()
    rng = np.random.RandomState(seed)
    # cumulative arrivals at fine time resolution, then invert
    steps = max(1024, num_requests * 8)
    # total duration such that the mean rate delivers num_requests
    mean_rps = (lo_rps + hi_rps) / 2.0
    duration = num_requests / mean_rps
    t = np.linspace(0.0, duration, steps)
    phase = 2.0 * np.pi * cycles * t / duration
    rate = lo_rps + (hi_rps - lo_rps) * 0.5 * (1.0 - np.cos(phase))
    cum = np.concatenate([[0.0], np.cumsum(rate[:-1] * np.diff(t))])
    targets = (np.arange(num_requests) + rng.uniform(0, 1, num_requests)) \
        * cum[-1] / num_requests
    offsets = np.interp(targets, cum, t)
    return tuple(float(x) for x in np.sort(offsets))


def flash_arrivals(
    num_requests: int,
    base_rps: float,
    flash_frac: float = 0.5,
    flash_at: float = 0.5,
    flash_rps: Optional[float] = None,
    seed: int = 0,
) -> Tuple[float, ...]:
    """Flash-crowd arrival offsets: steady ``base_rps`` background with
    ``flash_frac`` of all requests compressed into a spike at
    ``flash_at`` (fraction of the run) arriving at ``flash_rps``
    (default 10× base).  Deterministic like :func:`diurnal_arrivals`."""
    if num_requests < 1:
        return ()
    rng = np.random.RandomState(seed)
    n_flash = int(num_requests * flash_frac)
    n_base = num_requests - n_flash
    duration = max(n_base, 1) / base_rps
    base = np.sort(rng.uniform(0.0, duration, n_base))
    spike_rate = flash_rps if flash_rps is not None else base_rps * 10.0
    spike_t0 = duration * flash_at
    spike = spike_t0 + np.sort(rng.uniform(0, 1, n_flash)) \
        * (n_flash / spike_rate)
    return tuple(float(x) for x in np.sort(np.concatenate([base, spike])))


def run_load(
    engine,
    num_requests: int = 64,
    concurrency: int = 8,
    sizes: Sequence[Tuple[int, int]] = DEFAULT_SIZES,
    seed: int = 0,
    deadline_s: Optional[float] = None,
    queue_full_backoff: float = 0.002,
    collect: bool = False,
    models: Optional[Sequence[str]] = None,
    lanes: Optional[Sequence[Optional[str]]] = None,
    poison_mix: Optional[Sequence[Optional[str]]] = None,
    tenants: Optional[Sequence[Optional[str]]] = None,
    arrivals: Optional[Sequence[float]] = None,
    backoff_give_up: Optional[int] = None,
) -> Dict:
    """Drive ``engine`` with ``num_requests`` synthetic images; returns a
    report dict (wall/throughput/outcome counts + the engine's metrics
    snapshot).  ``QueueFull`` is the backpressure signal — the client
    backs off and resubmits, counting the rejection.

    ``models`` (optional) assigns each request a model id drawn
    deterministically from the sequence — the multi-tenancy traffic mix.
    The draw happens from ``seed`` before any thread starts (same rng
    stream discipline as sizes), so the (index → model) mapping is
    identical across runs.

    ``lanes`` (optional) does the same for SLO classes — each request's
    lane is drawn from the sequence (``None`` entries mean "let the
    engine default", i.e. the model's registry SLO class), producing a
    deterministic mixed-lane stream.  Drawn AFTER sizes and models, so
    adding lanes to an existing scenario leaves its size/model streams
    unchanged.  Per-lane outcome counts land under
    ``report["lane_outcomes"]``.

    ``poison_mix`` (optional) draws each request's poison flavor from
    the sequence the same way (``None`` entries mean healthy traffic —
    e.g. ``[None]*19 + ["qod"]`` is a ~5% poison mix).  Flavors are the
    :data:`POISON_FLAVORS`: the malformed three must be rejected at the
    engine's admission gate, while ``"qod"`` submits the deterministic
    :func:`qod_image` whose digest a fault spec can target.  Drawn AFTER
    lanes so existing scenarios keep their streams.  Per-flavor outcome
    counts land under ``report["poison_outcomes"]``.

    ``tenants`` (the multi-tenant client mix) needs the tenancy module,
    a later slice of the port (ROADMAP item 15): a non-empty sequence
    raises ``NotImplementedError``.

    ``arrivals`` (optional) switches the driver from closed-loop to
    trace-driven: entry ``i`` is request ``i``'s offset in seconds from
    load start (see :func:`diurnal_arrivals` / :func:`flash_arrivals`),
    and a client thread holding request ``i`` sleeps until that offset
    before submitting.  A client behind schedule submits immediately, so
    the trace is an arrival-time floor — exactly the open-loop shape an
    autoscaler must chase.

    ``backoff_give_up`` (optional) bounds QueueFull/over-budget retries
    per request: after that many rejections the request resolves as its
    last rejection kind instead of retrying forever — shed traffic must
    be COUNTABLE for the fairness bench, not retried into admission.

    ``collect=True`` additionally stores each request's resolution under
    ``report["_results"]`` — ``{index: ("ok", detections) | (kind, repr)}``
    — which is what lets a faulted run be compared byte-for-byte against
    an unfaulted one (pop the key before JSON-dumping the report), plus
    per-request submit/done monotonic timestamps under
    ``report["_times"]`` — ``{index: (t_submit, t_done)}`` — which is how
    the swap bench classifies requests as entirely-before / entirely-
    after / straddling a live swap window.  Because traffic is derived
    from ``seed + index`` alone, equal indices mean equal input images
    across runs."""
    if tenants:
        raise NotImplementedError(
            "run_load(tenants=...) needs the tenancy module, a later slice "
            "of the port (ROADMAP item 15)"
        )
    size_rng = np.random.RandomState(seed)
    req_sizes = [
        sizes[size_rng.randint(len(sizes))] for i in range(num_requests)
    ]
    req_models = (
        [models[size_rng.randint(len(models))] for _ in range(num_requests)]
        if models else None
    )
    req_lanes = (
        [lanes[size_rng.randint(len(lanes))] for _ in range(num_requests)]
        if lanes else None
    )
    req_poison = (
        [poison_mix[size_rng.randint(len(poison_mix))]
         for _ in range(num_requests)]
        if poison_mix else None
    )
    counter = iter(range(num_requests))
    lock = threading.Lock()
    outcomes = {"ok": 0, "deadline": 0, "error": 0, "queue_full_retries": 0,
                "invalid": 0, "poison": 0, "exhausted": 0,
                "over_budget": 0, "queue_full": 0}
    lane_outcomes: Dict[str, Dict[str, int]] = {}
    poison_outcomes: Dict[str, Dict[str, int]] = {}
    results: Dict[int, Tuple[str, object]] = {}
    times: Dict[int, Tuple[float, float]] = {}

    def classify(e: BaseException) -> str:
        name = type(e).__name__
        if "InvalidRequest" in name:
            return "invalid"
        if "OverBudget" in name:
            return "over_budget"
        if "QueueFull" in name:
            return "queue_full"
        if "Poison" in name:
            return "poison"
        if "Exhausted" in name:
            return "exhausted"
        return "deadline" if "Deadline" in name else "error"

    def note(key: str, lane: Optional[str] = None,
             flavor: Optional[str] = None) -> None:
        with lock:
            outcomes[key] += 1
            if lane is not None:
                per = lane_outcomes.setdefault(
                    lane, {"ok": 0, "deadline": 0, "error": 0}
                )
                if key in per:
                    per[key] += 1
            if flavor is not None:
                pf = poison_outcomes.setdefault(flavor, {})
                pf[key] = pf.get(key, 0) + 1

    def client(t_start: float) -> None:
        while True:
            with lock:
                i = next(counter, None)
            if i is None:
                return
            h, w = req_sizes[i]
            flavor = req_poison[i] if req_poison is not None else None
            if flavor is None:
                im = synthetic_image(i, h, w, seed)
            else:
                im = poison_image(flavor, i, h, w, seed)
            mkw = (
                {} if req_models is None or req_models[i] is None
                else {"model": req_models[i]}
            )
            lane = req_lanes[i] if req_lanes is not None else None
            if lane is not None:
                mkw["lane"] = lane
            if arrivals is not None:
                # trace-driven: hold request i until its scheduled
                # arrival offset (behind schedule = submit immediately)
                wait = t_start + arrivals[i] - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
            t_submit = time.monotonic()
            fut = None
            retries = 0
            while True:
                try:
                    fut = engine.submit(im, deadline_s=deadline_s, **mkw)
                    break
                except QueueFull as e:
                    retries += 1
                    if backoff_give_up is not None \
                            and retries >= backoff_give_up:
                        note("queue_full", lane, flavor)
                        if collect:
                            with lock:
                                results[i] = ("queue_full", repr(e))
                        break
                    note("queue_full_retries")
                    time.sleep(queue_full_backoff)
                except Exception as e:
                    # synchronous reject: admission gate (InvalidRequest)
                    # or quarantine fast-fail (PoisonRequest)
                    kind = classify(e)
                    note(kind, lane, flavor)
                    if collect:
                        with lock:
                            results[i] = (kind, repr(e))
                    break
            if fut is not None:
                try:
                    dets = fut.result()
                    note("ok", lane, flavor)
                    if collect:
                        with lock:
                            results[i] = ("ok", dets)
                except Exception as e:
                    kind = classify(e)
                    note(kind, lane, flavor)
                    if collect:
                        with lock:
                            results[i] = (kind, repr(e))
            if collect:
                with lock:
                    times[i] = (t_submit, time.monotonic())

    t0 = time.monotonic()
    threads = [
        threading.Thread(target=client, args=(t0,), name=f"loadgen-{t}",
                         daemon=True)
        for t in range(max(1, concurrency))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0

    snap = engine.snapshot()
    report = {
        "requests": num_requests,
        "concurrency": concurrency,
        "sizes": [list(s) for s in sizes],
        "seed": seed,
        "wall_s": round(wall, 4),
        "imgs_per_sec": round(outcomes["ok"] / wall, 3) if wall else None,
        "outcomes": outcomes,
        "engine": snap,
    }
    if models:
        report["models"] = list(models)
    if lanes:
        report["lanes"] = list(lanes)
        report["lane_outcomes"] = lane_outcomes
    if poison_mix:
        report["poison_mix"] = list(poison_mix)
        report["poison_flavors"] = (
            [req_poison[i] for i in range(num_requests)]
        )
        report["poison_outcomes"] = poison_outcomes
    if arrivals is not None:
        report["trace"] = {
            "arrivals": len(arrivals),
            "span_s": round(float(arrivals[-1]), 4) if len(arrivals) else 0.0,
        }
    if collect:
        report["_results"] = results
        report["_times"] = times
    return report


def run_stream_load(engine, *args, **kwargs) -> Dict:
    """The streaming load generator of the JAX package: its per-stream
    ordering gate is a later slice of the port (ROADMAP item 15)."""
    raise NotImplementedError(
        "run_stream_load needs the engine's per-stream ordering gate "
        "(serve/streams.py), a later slice of the port (ROADMAP item 15)"
    )
