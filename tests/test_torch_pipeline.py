"""The port's training loops (``core/resilience.py``, ``core/pipeline.py``)
against the JAX package's on the CPU: ``GuardedLoop`` and ``PipelinedLoop``
over a toy step of the same arithmetic in each framework, through the same
batches and the same ``MX_RCNN_FAULTS`` specs, must agree exactly on the
ready indices and losses, every recovery counter, the sink's fetches and the
final state.  Also ``DeviceFeed`` on the CPU, ``StepWatchdog``, the fault
registry's grammar and the train state's snapshot.

The toy batches hold multiples of 1/8, so every sum, LR-scaled update and
loss is exact in float32 and the two frameworks' reduction orders cannot
differ."""

import threading
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.core import pipeline as jpipeline
from mx_rcnn_tpu.core import resilience as jresilience
from mx_rcnn_tpu.utils import faults as jfaults
from mx_rcnn_tpu_torch.core import pipeline as tpipeline
from mx_rcnn_tpu_torch.core import resilience as tresilience
from mx_rcnn_tpu_torch.core.train import MXNetSGD, TrainState
from mx_rcnn_tpu_torch.utils import faults as tfaults


# ------------------------------------------------------------- toy steps
def jax_toy_step():
    """The JAX package's toy step (``tests/test_pipeline.py``) with the LR
    scale applied to the update: ``w += lr_scale · Σx``, loss ``|w| + 1``;
    the input state is donated."""

    @partial(jax.jit, donate_argnums=(0,))
    def _step(state, batch, s):
        w = state["w"] + s * batch["x"].sum()
        return {"w": w, "step": state["step"] + 1}, {"loss": jnp.abs(w) + 1.0}

    def step(state, batch, rng, lr_scale=1.0):
        return _step(state, batch, jnp.float32(lr_scale))

    return step


def torch_toy_step(state, batch, rng, lr_scale=1.0):
    """The same arithmetic in torch, float32 throughout."""
    w = state["w"] + lr_scale * batch["x"].sum()
    return {"w": w, "step": state["step"] + 1}, {"loss": w.abs() + 1.0}


def toy_batches(n):
    return [np.full((2, 2), (i + 1) / 8, np.float32) for i in range(n)]


def run_jax(xs, k, policy):
    jfaults.reset()
    state = jax.device_put({"w": jnp.float32(0.0), "step": jnp.int32(0)})
    loop = jpipeline.PipelinedLoop(jax_toy_step(), policy=policy, aux_interval=k)
    return _drive(loop, state, [{"x": x} for x in xs], jax.random.key(0))


def run_torch(xs, k, policy):
    tfaults.reset()
    state = {"w": torch.tensor(0.0), "step": torch.tensor(0, dtype=torch.int32)}
    loop = tpipeline.PipelinedLoop(torch_toy_step, policy=policy, aux_interval=k)
    return _drive(loop, state, [{"x": torch.from_numpy(x)} for x in xs], 0)


def _drive(loop, state, batches, rng):
    ready_all, raised = [], None
    try:
        for b in batches:
            state, ready, _ok = loop.step(state, b, rng)
            ready_all += ready
        state, ready, _ok = loop.flush(state)
        ready_all += ready
    except (jresilience.TrainingDiverged, tresilience.TrainingDiverged) as e:
        raised = type(e).__name__
    counters = {name: getattr(loop, name) for name in (
        "retried_steps", "rollbacks", "window_rollbacks", "replayed_steps", "skipped_batches")}
    counters["fetches"] = loop.sink.fetches
    final = None if raised else (float(np.asarray(state["w"])), int(np.asarray(state["step"])))
    return {"ready": [(i, float(a["loss"])) for i, a in ready_all], "counters": counters,
            "raised": raised, "final": final}


SCENARIOS = [
    ("clean", 1, "", {}),
    ("clean", 4, "", {}),
    ("nan_loss@5", 4, "nan_loss@5", {}),
    ("nan_loss@5", 1, "nan_loss@5", {}),
    ("transient spike", 3, "spike@6x1:1e9", {}),
    ("transient spike", 1, "spike@6x1:1e9", {}),
    ("budget overrun", 4, "nan_loss@1,nan_loss@2,nan_loss@3", {"max_bad_batches": 2}),
    ("budget overrun", 1, "nan_loss@1,nan_loss@2,nan_loss@3", {"max_bad_batches": 2}),
]


@pytest.mark.parametrize("name,k,spec,policy", SCENARIOS,
                         ids=[f"{s[0]}-K{s[1]}" for s in SCENARIOS])
def test_loops_match_jax_exactly(monkeypatch, name, k, spec, policy):
    monkeypatch.setenv("MX_RCNN_FAULTS", spec)
    xs = toy_batches(8)
    ref = run_jax(xs, k, jresilience.DivergencePolicy(**policy))
    got = run_torch(xs, k, tresilience.DivergencePolicy(**policy))
    assert got == ref
    if name == "nan_loss@5":
        assert [i for i, _ in got["ready"]] == [0, 1, 2, 3, 4, 6, 7]
        assert got["counters"]["skipped_batches"] == 1
        assert got["counters"]["window_rollbacks"] == (1 if k > 1 else 0)
    if name == "transient spike":
        assert got["counters"]["skipped_batches"] == 0 and len(got["ready"]) == 8
    if name == "budget overrun":
        assert got["raised"] == "TrainingDiverged"
    if name == "clean":
        assert got["counters"]["fetches"] == (2 if k == 4 else 0)


def test_guarded_loop_matches_jax_alone(monkeypatch):
    """``GuardedLoop`` on its own (the K = 1 path's core) under a poison
    batch and a transient spike: the same accept/skip decisions, losses and
    counters as JAX's."""
    monkeypatch.setenv("MX_RCNN_FAULTS", "nan_loss@2,spike@5x1:1e9")
    xs = toy_batches(7)
    out = []
    for res, step, state, wrap, rng in (
        (jresilience, jax_toy_step(), jax.device_put({"w": jnp.float32(0.0), "step": jnp.int32(0)}),
         lambda x: {"x": x}, jax.random.key(0)),
        (tresilience, torch_toy_step, {"w": torch.tensor(0.0), "step": torch.tensor(0)},
         lambda x: {"x": torch.from_numpy(x)}, 0),
    ):
        jfaults.reset()
        tfaults.reset()
        guard = res.GuardedLoop(step, policy=res.DivergencePolicy(warmup_steps=2))
        seen = []
        for x in xs:
            state, aux, ok = guard.step(state, wrap(x), rng)
            seen.append((ok, float(aux["loss"])) if ok else (ok,))
        out.append((seen, guard.retried_steps, guard.rollbacks, guard.skipped_batches,
                    float(np.asarray(state["w"]))))
    assert out[0] == out[1]
    assert out[1][3] == 1 and out[1][1] == 4  # 3 poison attempts + 1 spiked attempt


def test_snapshots_own_their_memory():
    """Host snapshots of a tree are copies: mutating the live tensors in
    place leaves the guard's and the window's snapshots as they were."""
    state = {"w": torch.tensor(1.0), "step": torch.tensor(0)}
    snap = tresilience.host_copy(state)
    state["w"].add_(5.0)
    assert float(snap["w"]) == 1.0

    def inplace_step(state, batch, rng):
        state["w"].add_(batch["x"].sum())
        return state, {"loss": state["w"].abs() + 1.0}

    guard = tresilience.GuardedLoop(inplace_step)
    state = {"w": torch.tensor(0.0)}
    guard.step(state, {"x": torch.ones(2)}, 0)
    assert float(guard.last_snapshot["w"]) == 0.0 and float(state["w"]) == 2.0
    pipe = tpipeline.PipelinedLoop(inplace_step, aux_interval=3)
    pipe.step(state, {"x": torch.ones(2)}, 0)
    assert float(pipe.last_snapshot["w"]) == 2.0 and float(state["w"]) == 4.0


# ------------------------------------------------------------ train state
def _tiny_state():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 1))
    opt = MXNetSGD(model.parameters(), lambda count: 0.1, momentum=0.9, weight_decay=1e-3,
                   clip=5.0)
    return model, opt, TrainState(model, opt)


def _sgd_step(model, opt, x):
    opt.zero_grad()
    model(x).square().sum().backward()
    opt.step()


def test_train_state_snapshot_restores_params_momentum_and_count():
    """Restore brings back the parameters, every momentum buffer (``None``
    before the first update) and the update count, and a replay from the
    restored state equals the first run bit for bit; a second snapshot
    reuses the first one's buffers."""
    model, opt, state = _tiny_state()
    state.mirror_snapshots()
    x = torch.randn(5, 3)
    before = state.snapshot()
    assert all(m is None for m in before.momenta) and before.count == 0
    _sgd_step(model, opt, x)
    after_one = [p.detach().clone() for p in model.parameters()]
    _sgd_step(model, opt, x)
    first = [p.detach().clone() for p in model.parameters()]
    assert before.restore() is state
    assert opt.count == 0 and all("momentum_buffer" not in opt.sgd.state[p]
                                  for p in opt.params)
    _sgd_step(model, opt, x)
    assert all(torch.equal(a, p) for a, p in zip(after_one, model.parameters()))
    mid = state.snapshot()
    buffers = [t.data_ptr() for t in mid.params + mid.momenta]
    _sgd_step(model, opt, x)
    assert all(torch.equal(a, p) for a, p in zip(first, model.parameters()))
    again = state.snapshot(mid, 5)
    assert again is mid and [t.data_ptr() for t in mid.params + mid.momenta] == buffers
    index, tree = mid.host()
    assert mid.count == 2 and tree["count"] == 2 and index == mid.index == 5
    assert set(tree["model"]) == set(model.state_dict())
    assert set(tree["momentum"]) == {n for n, _ in model.named_parameters()}


def test_lr_scale_scales_one_update_and_keeps_momentum():
    """``MXNetSGD.step(lr_scale)`` applies ``−lr·lr_scale·trace`` and leaves
    the momentum trace as the unscaled step computes it (lr 0.1 here)."""
    model, opt, state = _tiny_state()
    x = torch.randn(5, 3)
    snap = state.snapshot()
    p0 = [p.detach().clone() for p in model.parameters()]
    _sgd_step(model, opt, x)
    trace = [opt.sgd.state[p]["momentum_buffer"].clone() for p in opt.params]
    assert all(torch.equal(p, a.add(t, alpha=-0.1))
               for p, a, t in zip(model.parameters(), p0, trace))
    snap.restore()
    opt.zero_grad()
    model(x).square().sum().backward()
    opt.step(lr_scale=0.5)
    for p, a, t in zip(model.parameters(), p0, trace):
        assert torch.equal(p, a.add(t, alpha=-0.1 * 0.5))
        assert torch.equal(opt.sgd.state[p]["momentum_buffer"], t)


# ---------------------------------------------------------------- DeviceFeed
def test_device_feed_order_and_counters():
    batches = [{"x": np.full((2,), i, np.float32), "sample_seeds": np.asarray([i])}
               for i in range(6)]
    feed = tpipeline.DeviceFeed(iter(batches), depth=2, device="cpu")
    assert feed.wait_staged(2, timeout=10.0)
    got = [next(feed)]
    for _ in range(5):
        assert feed.wait_staged(1, timeout=10.0)
        got.append(next(feed))
    with pytest.raises(StopIteration):
        next(feed)
    feed.close()
    assert feed.stats() == {"fed": 6, "depth": 2, "staged_hits": 6, "feed_starved": 0,
                            "feed_starved_after_first": 0, "occupancy": 1.0}
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor) and float(b["x"][0]) == i
        assert b["sample_seeds"] == [i]


def test_device_feed_close_unblocks_worker_and_closes_source():
    closed = threading.Event()

    class Source:
        def __iter__(self):
            return self

        def __next__(self):
            return {"x": np.zeros((2,), np.float32)}  # endless

        def close(self):
            closed.set()

    feed = tpipeline.DeviceFeed(Source(), depth=2, device="cpu")
    assert feed.wait_staged(2, timeout=10.0)  # queue full, worker parked
    next(feed)
    feed.close()
    assert closed.is_set(), "source.close() not called"
    assert not feed._thread.is_alive(), "worker leaked past close()"
    with pytest.raises(StopIteration):
        next(feed)
    feed.close()  # idempotent


def test_device_feed_reraises_worker_error():
    def source():
        yield {"x": np.zeros((2,), np.float32)}
        raise RuntimeError("placement failed")

    feed = tpipeline.DeviceFeed(source(), depth=2, device="cpu")
    got = []
    with pytest.raises(RuntimeError, match="placement failed"):
        for b in feed:
            got.append(b)
    assert len(got) == 1
    feed.close()


def test_feed_needs_a_card_or_the_cpu_and_one_device():
    """A data-parallel mesh's placement puts this rank's rows (a row-sliced
    loader's batch) on the mesh's device; without one, the card or the
    CPU."""
    from mx_rcnn_tpu_torch.parallel.mesh import DataMesh

    rows = {"images": np.arange(12, dtype=np.float32).reshape(2, 2, 3, 1),
            "sample_seeds": np.asarray([4, 5], np.int32)}
    mesh = DataMesh(None, (0, 1), 1, torch.device("cpu"))
    placed = tpipeline.make_place_fn("cpu", mesh=mesh)(rows)
    assert placed["images"].device.type == "cpu" and placed["sample_seeds"] == [4, 5]
    np.testing.assert_array_equal(placed["images"].numpy(), rows["images"])
    # the same placement as the distributed module's globalize_batch
    from mx_rcnn_tpu_torch.parallel.distributed import globalize_batch

    again = globalize_batch(rows, mesh)
    assert again["sample_seeds"] == [4, 5] and torch.equal(again["images"], placed["images"])
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.DeviceFeed(iter([]))


# ------------------------------------------------------------ AsyncAuxSink
def test_aux_sink_fetches_a_window_in_one_copy():
    sink = tpipeline.AsyncAuxSink()
    trees = [{"loss": torch.tensor(1.5), "n": torch.tensor(3, dtype=torch.int32),
              "v": torch.arange(3.0)} for _ in range(2)]
    out = sink.fetch(trees, [None, None])
    assert out[0]["loss"] == 1.5 and out[1]["n"] == 3.0
    np.testing.assert_array_equal(out[1]["v"], [0.0, 1.0, 2.0])
    assert sink.fetches == 1 and sink.fetched_trees == 2 and sink.fetch_stalls == 0
    assert sink.fetch([]) == [] and sink.fetches == 1


# ------------------------------------------------------------ StepWatchdog
def test_watchdog_fires_on_a_stalled_step(monkeypatch):
    """``stall@1`` holds guarded step 1 past the watchdog's deadline: the
    injected ``exit_fn`` gets exit code 75 after the dump ran, once."""
    monkeypatch.setenv("MX_RCNN_FAULTS", "stall@1:0.6")
    tfaults.reset()
    fired = []
    guard = tresilience.GuardedLoop(torch_toy_step)
    guard.watchdog = tresilience.StepWatchdog(
        0.15, dump_fn=lambda: fired.append(("dump", float(guard.last_snapshot["w"]))) or "",
        exit_fn=fired.append)
    state = {"w": torch.tensor(0.0), "step": torch.tensor(0)}
    for x in toy_batches(3):
        state, _aux, ok = guard.step(state, {"x": torch.from_numpy(x)}, 0)
        assert ok
    assert fired == [("dump", 0.5), tresilience.WATCHDOG_EXIT_CODE]
    fired.clear()
    guard.watchdog.arm("9")
    guard.watchdog.disarm()
    time.sleep(0.3)
    assert fired == []


# ------------------------------------------------------------ fault grammar
def test_fault_grammar_matches_jax(monkeypatch):
    """The same spec fires the same faults in both registries: NaN at every
    attempt of step 3, two ×50 spikes at step 4 then clean, one failed read
    of record 7."""
    monkeypatch.setenv("MX_RCNN_FAULTS", "nan_loss@3,spike@4x2:50,record_fail@7x1")
    tfaults.reset()
    jfaults.reset()
    got = [[str(m.corrupt_loss(s, 2.0)) for s in (0, 3, 3, 4, 4, 4)] for m in (jfaults, tfaults)]
    assert got[0] == got[1] == ["2.0", "nan", "nan", "100.0", "100.0", "2.0"]
    for m in (jfaults, tfaults):
        with pytest.raises(m.InjectedFault):
            m.fail_record(7)
        m.fail_record(7)  # x1: fired once


@pytest.mark.parametrize("spec,exc", [("predict_fail@0.1", NotImplementedError),
                                      ("replica_wedge@0.1", NotImplementedError),
                                      ("nan_los@3", ValueError)])
def test_fault_kinds_the_port_lacks_raise(monkeypatch, spec, exc):
    monkeypatch.setenv("MX_RCNN_FAULTS", spec)
    tfaults.reset()
    with pytest.raises(exc, match=spec.split("@")[0]):
        tfaults.corrupt_loss(0, 1.0)
