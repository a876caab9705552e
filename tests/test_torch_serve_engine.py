"""The port's ``ServingEngine`` on the CPU, mirroring the assertions of the
JAX package's ``tests/test_serve_runner.py::TestServingEngine`` (red here:
the JAX runner's deterministic compile option is not in this jaxlib) on the
port: mixed-size load through the batcher, the engine and the runner, each
request's detections against ``detect_single`` on the same weights at the
bars of ``tests/test_torch_serve_runner.py`` (same keep counts, scores
within 1e-4, boxes within 1e-3 px: a padded batch of 2 against a batch of
1); one signature a rung after the load; deadline expiry without a
forward; backpressure; the interactive lane preempting bulk; ``stop(drain=
False)``; response-cache hits byte-identical and dropped by a hot swap; the
later slices' arguments raising; and ``tools/serve.py --cpu --small`` end to
end."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from mx_rcnn_tpu_torch.core.checkpoint import save_checkpoint
from mx_rcnn_tpu_torch.core.tester import Predictor
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess
from mx_rcnn_tpu_torch.serve.batcher import QueueFull
from mx_rcnn_tpu_torch.serve.engine import (
    DeadlineExceeded,
    EngineStopped,
    ServingEngine,
    StreamTable,
)
from mx_rcnn_tpu_torch.serve.loadgen import run_load, synthetic_image
from mx_rcnn_tpu_torch.serve.quarantine import InvalidRequest
from mx_rcnn_tpu_torch.serve.respcache import ResponseCache
from mx_rcnn_tpu_torch.serve.runner import ServeRunner, detect_single
from mx_rcnn_tpu_torch.tools import serve as serve_cli
from tests.test_torch_serve_runner import BUCKETS, IMAGE_HW, _held, c4_cfgs, calibrated_c4

torch.set_num_threads(2)

K = 4
SEED = 0
NUM_REQUESTS = 8


def _load_images():
    """run_load's images for SEED: the sizes it draws, its synthetic_image."""
    rng = np.random.RandomState(SEED)
    sizes = [IMAGE_HW[rng.randint(len(IMAGE_HW))] for _ in range(NUM_REQUESTS)]
    return [synthetic_image(i, h, w, SEED) for i, (h, w) in enumerate(sizes)]


@pytest.fixture(scope="module")
def env():
    """(port cfg, model calibrated on the load's images, its Flax tree, the
    warmed-up runner, a batch-1 Predictor on the same weights)."""
    _, cfg = c4_cfgs()
    model, params_np = calibrated_c4(cfg, _load_images())
    runner = ServeRunner(model, params_np, cfg, max_batch=2, device="cpu")
    assert runner.warmup() == len(BUCKETS)
    pred = Predictor(model, make_test_postprocess(cfg, K, cfg.TEST.SCORE_THRESH,
                                                  max_out=cfg.TEST.DET_PER_CLASS), device="cpu")
    return cfg, model, params_np, runner, pred


def test_end_to_end_mixed_sizes_match_detect_single(env):
    cfg, _, _, runner, pred = env
    with ServingEngine(runner, max_linger=0.05, max_queue=16, in_flight=2) as eng:
        rep = run_load(eng, num_requests=NUM_REQUESTS, concurrency=4, sizes=IMAGE_HW,
                       seed=SEED, collect=True)
    assert rep["outcomes"]["ok"] == NUM_REQUESTS
    e = rep["engine"]
    assert e["requests"]["completed"] == NUM_REQUESTS
    assert e["compile"]["misses"] == len(BUCKETS)
    assert e["latency"]["e2e"]["p99_ms"] > 0
    # a saturating closed loop (4 clients, batch 2): decent occupancy
    assert e["batches"]["occupancy"] >= 0.5
    assert e["completion"]["inflight_max"] <= 2
    n = 0
    for i, im in enumerate(_load_images()):
        kind, dets = rep["_results"][i]
        assert kind == "ok"
        n += _held(dets, detect_single(pred, im, cfg, K), label=f"request {i}")
    assert n > NUM_REQUESTS


def test_deadline_expiry_fails_fast_without_forward(env):
    runner = env[3]
    with ServingEngine(runner, max_linger=0.2) as eng:
        dispatched = runner.split_dispatches  # after the start's warmup
        fut = eng.submit(synthetic_image(3, 64, 64), deadline_s=0.0)  # already expired
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=60)
        assert eng.metrics.expired == 1
    # the expired request never reached the device
    assert eng.metrics.failed == 0 and runner.split_dispatches == dispatched


def test_backpressure_counts_rejections(env):
    runner = env[3]
    eng = ServingEngine(runner, max_linger=5.0, max_queue=1)
    # not started: nothing drains, so the 2nd submit must bounce
    eng._started = True
    eng.submit(synthetic_image(4, 64, 64))
    with pytest.raises(QueueFull):
        eng.submit(synthetic_image(5, 64, 64))
    assert eng.metrics.rejected == 1 and eng.metrics.submitted == 1
    with pytest.raises(InvalidRequest):
        eng.submit(np.zeros((0, 4, 3), np.float32))
    assert eng.metrics.invalid == 1 and eng.metrics.rejected == 2
    eng.batcher.close()


def test_interactive_preempts_bulk(env):
    """A bulk request lingering for its batch and an interactive one
    queued behind it: the interactive lane takes the first device slot."""
    runner = env[3]
    eng = ServingEngine(runner, max_linger=5.0, interactive_linger=0.0, in_flight=1)
    eng._started = True  # queue both before the assembler runs
    order, lock = [], threading.Lock()

    def note(name):
        def cb(_):
            with lock:
                order.append(name)
        return cb

    eng.submit(synthetic_image(6, 64, 64), lane="bulk").add_done_callback(note("bulk"))
    eng.submit(synthetic_image(7, 64, 64), lane="interactive").add_done_callback(
        note("interactive"))
    eng._started = False
    eng.start(warmup=False)
    eng.stop(drain=True)  # the close releases the lingering bulk batch
    assert order == ["interactive", "bulk"]
    snap = eng.snapshot()
    assert snap["scheduler"]["preemptions"] == 1
    assert snap["scheduler"]["batches_by_lane"] == {"interactive": 1, "bulk": 1}
    assert snap["lanes"]["interactive"]["completed"] == 1


def test_stop_without_drain_resolves_every_future(env):
    runner = env[3]
    dispatched = runner.split_dispatches
    eng = ServingEngine(runner, max_linger=5.0, max_queue=8).start(warmup=False)
    # one request a bucket: neither group fills a batch, both linger
    futs = [eng.submit(synthetic_image(10 + i, h, w)) for i, (h, w) in enumerate(IMAGE_HW[:2])]
    eng.stop(drain=False)
    for f in futs:
        with pytest.raises(EngineStopped):
            f.result(timeout=60)
    assert eng.metrics.stopped == 2 and runner.split_dispatches == dispatched
    with pytest.raises(RuntimeError, match="not started"):
        eng.submit(synthetic_image(1, 64, 64))


def test_response_cache_hits_are_byte_identical_and_swap_invalidates(env, tmp_path):
    """A repeated image is answered from the cache (the same arrays); a hot
    swap through the admin command drops the family's entries, and the
    next answer is the new version's."""
    cfg, model, params_np, *_ = env
    runner = ServeRunner(model, params_np, cfg, max_batch=2, device="cpu")
    cache = ResponseCache(capacity=8)
    im = _load_images()[0]
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state["rcnn.cls_score.weight"] *= 1.5
    ckpt = save_checkpoint(str(tmp_path), {"model": state, "momentum": {}, "count": 1}, 1)
    with ServingEngine(runner, max_linger=0.0, response_cache=cache) as eng:
        v1 = eng.submit(im).result(timeout=120)
        dispatched = runner.split_dispatches
        hit = eng.submit(im).result(timeout=120)
        assert runner.split_dispatches == dispatched
        assert all(a is b for a, b in zip(v1, hit))
        assert cache.snapshot()["hits"] == 1
        misses = runner.compile_cache.misses
        res = eng.admin(f"swap default {ckpt}")
        assert res["version"] == 2 and cache.snapshot()["invalidations"] >= 1
        v2 = eng.submit(im).result(timeout=120)
        assert runner.compile_cache.misses == misses
        assert any(a.tobytes() != b.tobytes() for a, b in zip(v1[1:], v2[1:]))
        assert eng.snapshot()["registry"]["models"]["default"]["live_version"] == 2


def test_failed_batches_quarantine_a_digest_without_a_pool(env, monkeypatch):
    """Containment on a bare runner: with a QuarantineTable (K = 1) a batch
    that fails past the engine's retries counts as a trip of its digest,
    the request fails as PoisonRequest, and the same image is then refused
    at submit without a queue slot."""
    from mx_rcnn_tpu_torch.serve.quarantine import PoisonRequest, QuarantineTable, request_digest

    runner = env[3]
    calls = []

    def broken(batch, model=None):
        calls.append(1)
        raise RuntimeError("device fault")

    table = QuarantineTable(k=1)
    im = synthetic_image(20, 64, 64)
    with ServingEngine(runner, max_linger=0.0, quarantine=table) as eng:
        monkeypatch.setattr(runner, "run", broken)  # after the start's warmup
        with pytest.raises(PoisonRequest):
            eng.submit(im).result(timeout=60)
        with pytest.raises(PoisonRequest):
            eng.submit(im)
    assert len(calls) == 3  # the "serve" RetryPolicy's three tries, then the trip
    assert table.quarantined(request_digest(im))
    assert eng.metrics.poisoned == 2 and eng.metrics.rejected == 1
    assert eng.snapshot()["quarantine"]["trips"] == 1


def test_later_slices_raise(env):
    runner = env[3]
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        ServingEngine(runner, tenants=object())

    class _Pool:
        replicas = ()
        max_batch = 2

    with pytest.raises(NotImplementedError, match="ReplicaPool"):
        ServingEngine(_Pool())
    eng = ServingEngine(runner)
    for call in (eng.attach_autoscaler, eng.attach_rollout,
                 lambda: eng.attach_cascade({"cheap": "a", "flagship": "b"}),
                 lambda: eng.submit(synthetic_image(0, 64, 64), tenant="acme"),
                 lambda: eng.submit(synthetic_image(0, 64, 64), stream="cam0", frame=0),
                 lambda: eng.admin("rollout default /tmp/x"), StreamTable):
        with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
            call()
    with pytest.raises(ValueError, match="unknown admin"):
        eng.admin("reboot")
    assert eng.admin("models")["models"]["default"]["live_version"] >= 1


@pytest.mark.parametrize("flag", ["--replicas=2", "--tenant=a=1", "--fleet=2", "--cascade=a>b"])
def test_serve_cli_refuses_later_slice_flags(flag, capsys):
    with pytest.raises(SystemExit):
        serve_cli.main(["--cpu", flag])
    assert "ROADMAP item 15" in capsys.readouterr().err


def test_serve_cli_small_runs_on_the_cpu(tmp_path):
    out = tmp_path / "report.json"
    rep = serve_cli.main(["--cpu", "--small", "--requests", "4", "--concurrency", "2",
                          "--max_batch", "2", "--lane_mix", "2", "--out", str(out)])
    assert rep["device"] == "cpu" and rep["outcomes"]["ok"] == 4
    assert rep["engine"]["compile"]["misses"] == 2  # the two small buckets, once each
    assert out.exists() and torch.backends.cudnn.allow_tf32 is False
    cfg = serve_cli.small_config("resnet50")
    assert dataclasses.asdict(cfg.dataset)["NUM_CLASSES"] == 4
