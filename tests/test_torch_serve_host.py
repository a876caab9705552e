"""The port's host-side serving modules against the JAX package's copies, on
the same seeded inputs, exactly: the lane batcher (release order, lanes,
the bulk-aging guard, the expiry sweep, backpressure, with
``time.monotonic`` replaced by one scripted clock in both modules), the
latency histograms and metrics snapshots, the quarantine's digests,
admission gate, budgets and table, the response cache, ``quantize_tree``
bit for bit, the runtime lock-order check, and the load generator's images,
arrival traces and report.  None of these modules imports JAX or torch."""

import threading
import time
import types
from concurrent.futures import Future

import numpy as np
import pytest

from mx_rcnn_tpu.analysis import lockcheck as j_lockcheck
from mx_rcnn_tpu.core import quantize as j_quantize
from mx_rcnn_tpu.serve import batcher as j_batcher
from mx_rcnn_tpu.serve import loadgen as j_loadgen
from mx_rcnn_tpu.serve import metrics as j_metrics
from mx_rcnn_tpu.serve import quarantine as j_quarantine
from mx_rcnn_tpu.serve import respcache as j_respcache
from mx_rcnn_tpu_torch.analysis import lockcheck
from mx_rcnn_tpu_torch.core import quantize
from mx_rcnn_tpu_torch.serve import batcher, loadgen, metrics, quarantine, respcache

class ScriptedClock:
    """A monotonic clock that moves only by ``step`` a call and by
    ``advance``: each module's run sees the same sequence of readings."""

    def __init__(self, step: float = 1e-4):
        self.t = 1000.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _patch_clock(monkeypatch, module, clock):
    monkeypatch.setattr(module, "time", types.SimpleNamespace(monotonic=clock, sleep=time.sleep))


# ---------------------------------------------------------------- batcher
def _batcher_run(mod, monkeypatch, seed, bulk_age_limit):
    """A seeded mixed stream through ``mod``'s DynamicBatcher: submits at
    scripted times (two models, two buckets, two lanes, some deadlines that
    expire in the queue, a burst past the queue cap), picks between them,
    then a close and a drain.  → (batches as request ids with their lane,
    ids that raised QueueFull, ids swept by expiry, stats)."""
    clock = ScriptedClock()
    _patch_clock(monkeypatch, mod, clock)
    rng = np.random.RandomState(seed)
    b = mod.DynamicBatcher(max_batch=3, max_linger=0.01, max_queue=10,
                           interactive_linger=0.0, bulk_age_limit=bulk_age_limit)
    reqs, released, rejected = {}, [], []
    for i in range(40):
        clock.advance(float(rng.uniform(0, 0.006)))
        deadline = clock.t + 0.004 if rng.rand() < 0.15 else None
        r = mod.Request(
            image=np.zeros((2, 2, 3), np.uint8), im_info=np.zeros(3, np.float32),
            orig_hw=(2, 2), bucket=((64, 64), (96, 96))[rng.randint(2)],
            deadline=deadline, model=(None, "b")[rng.randint(2)],
            lane=mod.LANES[int(rng.rand() < 0.35)],
        )
        reqs[i] = r
        try:
            b.submit(r)
        except mod.QueueFull:
            rejected.append(i)
        if i % 4 == 3:
            batch = b.next_batch(poll=1e-4)
            released.append([next(k for k, v in reqs.items() if v is x) for x in batch]
                            + [batch[0].lane])
    b.close()
    while (batch := b.next_batch(poll=1e-4)) is not None:
        released.append([next(k for k, v in reqs.items() if v is x) for x in batch]
                        + [batch[0].lane])
    swept = sorted(i for i, r in reqs.items()
                   if r.future.done() and type(r.future.exception()).__name__ == "DeadlineExceeded")
    return released, rejected, swept, b.stats()


@pytest.mark.parametrize("seed,bulk_age_limit", [(0, 2.0), (1, 0.02), (2, 0.0)])
def test_batcher_releases_as_jax_does(monkeypatch, seed, bulk_age_limit):
    got = _batcher_run(batcher, monkeypatch, seed, bulk_age_limit)
    ref = _batcher_run(j_batcher, monkeypatch, seed, bulk_age_limit)
    assert got == ref
    released, rejected, swept, stats = got
    assert sum(len(x) - 1 for x in released) + len(rejected) + len(swept) == 40
    assert stats["batches_by_lane"]["interactive"] > 0 and stats["batches_by_lane"]["bulk"] > 0
    if seed == 0:
        assert rejected and swept
    if bulk_age_limit < 1:
        assert stats["aged_releases"] > 0
    if bulk_age_limit > 0:
        # at 0 the aging guard takes every slot a bulk head waits for
        assert stats["preemptions"] > 0


def test_batcher_validates_in_the_submitting_thread():
    b = batcher.DynamicBatcher(max_batch=2)
    with pytest.raises(quarantine.InvalidRequest):
        b.submit(batcher.Request(image=np.zeros((0, 3), np.uint8), im_info=np.zeros(3),
                                 orig_hw=(0, 0), bucket=(8, 8)))
    with pytest.raises(ValueError):
        b.submit(batcher.Request(image=np.zeros((2, 2, 3), np.uint8), im_info=np.zeros(3),
                                 orig_hw=(2, 2), bucket=(8, 8), lane="express"))


def test_request_is_one_dataclass_with_jax_fields():
    """The runner's Request is the batcher's (the JAX package's layout)."""
    from mx_rcnn_tpu_torch.serve import runner

    assert runner.Request is batcher.Request
    names = [f.name for f in batcher.Request.__dataclass_fields__.values()]
    assert names == [f.name for f in j_batcher.Request.__dataclass_fields__.values()]


# ---------------------------------------------------------------- metrics
def _metrics_run(mod, monkeypatch):
    clock = ScriptedClock(step=0.0)
    _patch_clock(monkeypatch, mod, clock)
    rng = np.random.RandomState(3)
    h = mod.LatencyHistogram()
    for x in rng.lognormal(-4, 1.5, 500):
        h.record(float(x))
    m = mod.ServeMetrics()
    for i in range(60):
        m.inc("submitted")
        lane = ("interactive", "bulk")[i % 3 == 0]
        if i % 7 == 0:
            m.inc("expired")
            m.record_lane(lane, expired=True)
            continue
        m.inc("completed")
        m.e2e.record(float(rng.uniform(0.001, 0.3)))
        m.queue_wait.record(float(rng.uniform(0.0, 0.01)))
        m.record_lane(lane, float(rng.uniform(0.001, 0.3)), queue_wait_s=0.002)
        m.record_model(("a", "b")[i % 2], float(rng.uniform(0.001, 0.3)))
    for real in (1, 2, 4, 3):
        m.record_batch(real, 4)
        m.record_lane_batch("bulk", real, 4)
    m.record_queue_depth(5)
    m.record_paste(1.5, 1024)
    o = mod.OverlapStats()
    for d in (1, 2, 1, 0):
        o.note_depth(d)
        clock.advance(0.01)
    o.note_fetch(0.004, hidden=True, nbytes=100, model="a", device_ms=3.0)
    o.note_fetch(0.002, hidden=False, nbytes=50)
    o.note_paste(0.001, nbytes=7, model="a")
    hists = [h.percentile(p) for p in (50, 90, 95, 99, 99.9)]
    h2 = mod.LatencyHistogram()
    h2.record(0.5)
    merged = h.merge(h2).snapshot()
    snap = m.snapshot()
    return hists, merged, snap, o.snapshot(), mod.merge_snapshots([snap, snap, {"x": 1}])


def test_metrics_match_jax(monkeypatch):
    got = _metrics_run(metrics, monkeypatch)
    ref = _metrics_run(j_metrics, monkeypatch)
    assert got == ref
    hists, _, snap, overlap, merged = got
    assert hists == sorted(hists) and hists[0] > 0
    assert set(snap) >= {"requests", "batches", "queue", "latency", "lanes", "models"}
    assert overlap["fetch_bytes"] == 150 and merged["n_sources"] == 3


# ------------------------------------------------------------- quarantine
_IMAGES = [
    np.random.RandomState(0).randint(0, 256, (5, 7, 3)).astype(np.uint8),
    np.random.RandomState(0).rand(5, 7, 3).astype(np.float32),
    np.zeros((7, 5, 3), np.float32),
    np.full((2, 2, 3), np.nan, np.float32),
    np.zeros((0, 4, 3), np.float32),
    np.zeros((4, 4), np.float32),
    np.empty((2, 2, 3), object),
    np.zeros((9000, 2, 3), np.uint8),
    [[[1, 2, 3]]],
]


@pytest.mark.parametrize("k", range(len(_IMAGES)))
def test_admission_gate_and_digest_match_jax(k):
    im = _IMAGES[k]
    outcome = []
    for mod in (quarantine, j_quarantine):
        try:
            mod.validate_image(im, {"max_side": 8192} if k == 7 else None)
            outcome.append(("ok", mod.request_digest(im)))
        except mod.InvalidRequest as e:
            outcome.append(("invalid", str(e)))
    assert outcome[0] == outcome[1]
    assert (outcome[0][0] == "ok") == (k in (0, 1, 2, 8))


def _quarantine_run(mod, monkeypatch):
    clock = ScriptedClock(step=0.0)
    _patch_clock(monkeypatch, mod, clock)
    t = mod.QuarantineTable(k=2, ttl_s=1.0, max_suspects=4)
    log = []
    digests = [f"{i:032x}" for i in range(6)]
    log.append(t.note_trip([(d, {"i": i}) for i, d in enumerate(digests[:3])], reason="a"))
    log.append(t.note_trip([(digests[0], None), (digests[3], None)], reason="b"))
    log.append((t.quarantined(digests[0]), t.quarantined(digests[1]), t.exonerate(digests[2])))
    log.append(t.top_suspect())
    t.probe_result(digests[1], False)
    log.append(t.first_quarantined(digests))
    log.append(t.note_trip([(d, None) for d in digests], reason="c"))
    clock.advance(2.0)
    log.append((t.quarantined(digests[0]), t.clear(digests[5])))
    budget = mod.RetryBudget(2)
    bb = mod.BatchBudget([budget, mod.RetryBudget(5), None])
    bb.spend("hedge")
    budget.spend()
    try:
        budget.spend("resubmit")
    except mod.RetriesExhausted as e:
        log.append(str(e))
    log.append((budget.snapshot(), bb.remaining))
    return log, t.snapshot()


def test_quarantine_table_and_budgets_match_jax(monkeypatch):
    got = _quarantine_run(quarantine, monkeypatch)
    ref = _quarantine_run(j_quarantine, monkeypatch)
    assert got == ref
    assert got[1]["quarantined_total"] >= 2 and got[1]["expired"] >= 1


# ---------------------------------------------------------- response cache
def _cache_run(mod):
    c = mod.ResponseCache(capacity=3)
    rng = np.random.RandomState(5)
    ims = [rng.randint(0, 256, (4, 6, 3)).astype(np.uint8) for _ in range(5)]
    keys = [c.key_for(im, ("a", "b")[i % 2], 1 + i % 2, ("f32", "int8")[i % 2])
            for i, im in enumerate(ims)]
    log = [keys, mod.ResponseCache.digest(ims[0].reshape(6, 4, 3))]
    for i, k in enumerate(keys):
        log.append(c.get(k))
        c.put(k, f"dets{i}")
    log += [c.get(keys[4]), c.get(keys[0]), len(c), c.invalidate_model("a"), len(c)]
    return log, c.snapshot()


def test_response_cache_matches_jax():
    got, ref = _cache_run(respcache), _cache_run(j_respcache)
    assert got == ref
    assert got[1]["evictions"] == 2 and got[1]["invalidations"] >= 1


# ------------------------------------------------------------------ quantize
def _tree(rng):
    return {
        "backbone": {"conv1": {"kernel": rng.randn(3, 3, 3, 8).astype(np.float32)},
                     "bn1": {k: rng.randn(8).astype(np.float32)
                             for k in ("scale", "bias", "mean", "var")},
                     "zero": {"kernel": np.zeros((1, 1, 8, 4), np.float32)}},
        "rcnn": {"cls_score": {"kernel": rng.randn(16, 5).astype(np.float32) * 1e-3,
                               "bias": rng.randn(5).astype(np.float32)}},
        "step": np.int32(3),
    }


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_tree_is_bitwise_jax(seed):
    params = _tree(np.random.RandomState(seed))
    got, ref = quantize.quantize_tree(params), j_quantize.quantize_tree(params)
    gl, rl = list(_leaves(got)), list(_leaves(ref))
    assert [p for p, _ in gl] == [p for p, _ in rl]
    for (path, g), (_, r) in zip(gl, rl):
        assert g.dtype == r.dtype and g.tobytes() == r.tobytes(), path
    assert quantize.is_quantized_leaf(got["backbone"]["conv1"]["kernel"])
    assert not quantize.is_quantized_leaf(got["backbone"]["bn1"])
    dq, jdq = quantize.dequantize_tree(got), j_quantize.dequantize_tree(ref)
    for (path, g), (_, r) in zip(_leaves(dq), _leaves(jdq)):
        assert g.tobytes() == np.asarray(r).tobytes(), path
    assert quantize.quantization_stats(params, got) == j_quantize.quantization_stats(params, ref)


# ----------------------------------------------------------------- lockcheck
@pytest.mark.parametrize("mod", [lockcheck, j_lockcheck], ids=["port", "jax"])
def test_lockcheck_catches_an_inversion(monkeypatch, mod):
    monkeypatch.setenv("MX_RCNN_LOCK_CHECK", "1")
    mod.reset()
    try:
        assert mod.enabled()
        a, b = mod.make_lock("A"), mod.make_lock("B")
        with a:
            with b:
                pass
        with b:
            with pytest.raises(mod.LockOrderViolation, match="inversion"):
                a.acquire()
        r = mod.make_lock("R", rlock=True)
        with r:
            with r:
                pass
        with pytest.raises(mod.LockOrderViolation, match="re-acquisition"):
            with a:
                a.acquire()
        cond = mod.make_condition("C")
        with cond:
            cond.notify_all()
    finally:
        mod.reset()
    monkeypatch.setenv("MX_RCNN_LOCK_CHECK", "0")
    assert type(mod.make_lock("X")) is type(threading.Lock())


# ------------------------------------------------------------------ loadgen
def test_loadgen_images_and_arrivals_match_jax():
    for args in ((3, 17, 23, 0), (0, 40, 30, 5)):
        assert loadgen.synthetic_image(*args).tobytes() == j_loadgen.synthetic_image(*args).tobytes()
    assert loadgen.qod_image(31, 29, 2).tobytes() == j_loadgen.qod_image(31, 29, 2).tobytes()
    for flavor in loadgen.POISON_FLAVORS:
        g, r = loadgen.poison_image(flavor, 4, 9, 11, 1), j_loadgen.poison_image(flavor, 4, 9, 11, 1)
        assert g.shape == r.shape and g.dtype == r.dtype
        if g.dtype != object:
            assert g.tobytes() == r.tobytes()
    assert loadgen.diurnal_arrivals(50, 2.0, 20.0, 1.5, 3) == \
        j_loadgen.diurnal_arrivals(50, 2.0, 20.0, 1.5, 3)
    assert loadgen.flash_arrivals(40, 5.0, 0.4, 0.3, None, 7) == \
        j_loadgen.flash_arrivals(40, 5.0, 0.4, 0.3, None, 7)


class _Engine:
    """Resolves each submit at once with the image's digest: QueueFull on
    every third first try, DeadlineExceeded on the poison image."""

    def __init__(self, qmod):
        self.qmod = qmod
        self.calls = 0
        self.lock = threading.Lock()

    def submit(self, im, deadline_s=None, model=None, lane=None):
        with self.lock:
            self.calls += 1
            full = self.calls % 3 == 0
        if full:
            raise batcher.QueueFull("full")
        im = self.qmod.validate_image(im)
        f = Future()
        if im.shape[0] == 13:
            f.set_exception(type("DeadlineExceeded", (RuntimeError,), {})("late"))
        else:
            f.set_result((self.qmod.request_digest(im), model, lane))
        return f

    def snapshot(self):
        return {}


def test_run_load_matches_jax(monkeypatch):
    """The same requests, models, lanes and poison flavors drawn from the
    seed; concurrency 1 keeps the engine's call order fixed."""
    monkeypatch.setattr(j_loadgen, "QueueFull", batcher.QueueFull)
    kw = dict(num_requests=24, concurrency=1, sizes=((13, 9), (8, 6), (10, 12)), seed=4,
              models=[None, "b"], lanes=["interactive", None],
              poison_mix=[None, None, "nan", "qod"], collect=True, queue_full_backoff=0.0)
    got = loadgen.run_load(_Engine(quarantine), **kw)
    ref = j_loadgen.run_load(_Engine(j_quarantine), **kw)
    for rep in (got, ref):
        rep.pop("wall_s"), rep.pop("imgs_per_sec"), rep.pop("_times")
    assert got == ref
    assert got["outcomes"]["ok"] > 0 and got["outcomes"]["invalid"] > 0
    assert got["outcomes"]["deadline"] > 0 and got["outcomes"]["queue_full_retries"] > 0


def test_unported_load_modes_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        loadgen.run_load(_Engine(quarantine), num_requests=1, tenants=["a"])
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        loadgen.run_stream_load(_Engine(quarantine))
