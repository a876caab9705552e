"""The port's elastic data parallel (``parallel/elastic.py``) against the
JAX package's: every ``tests/test_elastic.py`` scenario that runs on its
numpy stand-in factory runs here through both packages' ``ElasticLoop`` /
``MeshMonitor`` (delivered steps, transitions, replays, emergency
checkpoints, stats and final state must be identical); the device-fault
injector and the classifier; and a real 2 → 1 shrink of a small C4 on the
CPU through ``train_end2end --cpu 2 --elastic``, bit-identical to a fresh
one-rank run restored from its emergency checkpoint."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mx_rcnn_tpu.parallel import distributed as jdistributed
from mx_rcnn_tpu.parallel import elastic as jelastic
from mx_rcnn_tpu.utils import faults as jfaults
from mx_rcnn_tpu_torch.core import checkpoint as tckpt
from mx_rcnn_tpu_torch.core.pipeline import batch_to_device
from mx_rcnn_tpu_torch.core.train import (
    create_train_state,
    make_lr_schedule,
    make_optimizer,
    train_step,
)
from mx_rcnn_tpu_torch.data.loader import TrainLoader
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.parallel import distributed as tdistributed
from mx_rcnn_tpu_torch.parallel import elastic as telastic
from mx_rcnn_tpu_torch.parallel.mesh import take_replica_rows
from mx_rcnn_tpu_torch.utils import faults as tfaults
from mx_rcnn_tpu_torch.utils.load_data import load_gt_roidb

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": jelastic, "port": telastic}


def set_faults(monkeypatch, spec):
    if spec:
        monkeypatch.setenv(tfaults.ENV_VAR, spec)
    else:
        monkeypatch.delenv(tfaults.ENV_VAR, raising=False)
    tfaults.reset()
    jfaults.reset()


# ------------------------------------------------- the numpy stand-in
def fake_factory(mod, n_base, built, broken=False):
    """``tests/test_elastic.py::fake_factory`` for package ``mod``: the step
    adds the kept rows' sum to ``w``, ``place_batch`` keeps the survivor
    fraction of the rows."""
    def factory(active):
        active = tuple(active)
        built.append(active)
        n = len(active)

        def step_fn(state, batch, rng, lr_scale=1.0):
            if broken:
                raise ValueError("not a device fault")
            w = state["w"] + float(np.sum(batch["x"]))
            return {"w": w, "step": state["step"] + 1}, {"loss": abs(w) + 1.0}

        def place_batch(batch):
            return {"x": batch["x"][: batch["x"].shape[0] * n // n_base]}

        return mod.ElasticContext(
            active=active, step_fn=step_fn,
            place_state=lambda t: {k: np.array(v) for k, v in t.items()},
            place_batch=place_batch,
        )

    return factory


def batches(n, rows=8):
    return [{"x": np.arange(rows, dtype=np.float32) + 10.0 * i} for i in range(n)]


# the scenarios of tests/test_elastic.py that use fake_factory
SCENARIOS = {
    "shrink_replays_poison_step": dict(spec="device_lost@3.2", steps=6, flush=True),
    "wedge_as_loss": dict(spec="device_wedge@3.2:2", steps=6),
    "emergency_checkpoint": dict(spec="device_lost@2.1", steps=4, ckpt=True),
    "window_replay_deferred_aux": dict(spec="device_lost@3.1", steps=6, aux_interval=2,
                                       flush=True),
    "cascading_faults": dict(spec="device_lost@3.2,device_lost@3.5", steps=6),
    "regrow_after_wedge_clears": dict(spec="device_wedge@2.1:3", steps=8, boundary_at=6),
    "regrow_blocked_while_down": dict(spec="device_lost@2.1", steps=6, boundary_at=6),
    "boundary_refuses_pending_window": dict(spec="", steps=2, aux_interval=4, boundary_at=1,
                                            flush_before_boundary=False),
    "no_survivors": dict(spec="device_lost@0.0", steps=1, n=1, rows=1),
    "unrelated_exception": dict(spec="", steps=1, broken=True),
    "stats": dict(spec="device_lost@1.3", steps=3),
}


def run_scenario(mod, sc):
    n = sc.get("n", 8)
    built, ckpts, delivered = [], [], []

    def ckpt(host_state, idx, meta):
        ckpts.append((idx, dict(meta), float(host_state["w"]), int(host_state["step"])))
        return f"ckpt-{idx}"

    loop = mod.ElasticLoop(fake_factory(mod, n, built, sc.get("broken", False)), n,
                           aux_interval=sc.get("aux_interval", 1),
                           checkpoint_fn=ckpt if sc.get("ckpt") else None)
    state = loop.ctx.place_state({"w": np.float32(0.0), "step": np.int32(0)})
    outcome = regrown = None
    try:
        for i, b in enumerate(batches(sc["steps"], sc.get("rows", 8))):
            if sc.get("boundary_at") == i:
                if sc.get("flush_before_boundary", True):
                    state, ready, _ok = loop.flush(state)
                    delivered += [(idx, aux["loss"]) for idx, aux in ready]
                state, regrown = loop.checkpoint_boundary(state)
            state, ready, ok = loop.step(state, b, None)
            assert ok
            delivered += [(idx, aux["loss"]) for idx, aux in ready]
        if sc.get("flush"):
            state, ready, _ok = loop.flush(state)
            delivered += [(idx, aux["loss"]) for idx, aux in ready]
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        outcome = type(e).__name__
    stats = loop.stats()
    stats.pop("recovery_s")
    stats["pipeline"].pop("fetch_stall_ms")
    return {
        "outcome": outcome, "delivered": [(int(i), float(v)) for i, v in delivered],
        "built": built, "ckpts": ckpts, "regrown": regrown, "active": loop.active,
        "degraded": loop.degraded, "replayed": loop.replayed_steps,
        "w": float(state["w"]), "step": int(state["step"]), "stats": stats,
        "recovered": loop.recovery_s >= 0,
    }


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_elastic_loop_scenarios_match_jax(monkeypatch, name):
    sc = SCENARIOS[name]
    got = {}
    for pkg, mod in PACKAGES.items():
        set_faults(monkeypatch, sc["spec"])
        got[pkg] = run_scenario(mod, sc)
    assert got["port"] == got["jax"]
    expected_outcome = {"boundary_refuses_pending_window": "RuntimeError",
                        "no_survivors": "NoSurvivorsError",
                        "unrelated_exception": "ValueError"}.get(name)
    assert got["port"]["outcome"] == expected_outcome
    if name == "regrow_after_wedge_clears":
        assert got["port"]["regrown"] and got["port"]["step"] == 8
        assert got["port"]["built"] == [tuple(range(8)), tuple(o for o in range(8) if o != 1),
                                        tuple(range(8))]
    if name == "emergency_checkpoint":
        idx, meta, _w, step = got["port"]["ckpts"][0]
        assert (idx, step, meta["lost"], meta["event"]) == (2, 2, [1], "shrink")


MONITOR_SEQUENCES = {
    # (n, probe down set, calls): the tests/test_elastic.py monitor cases
    "bookkeeping": (4, (), [("shrink", 5, {1}), ("boundary",), ("want", 6), ("regrow", 6)]),
    "no_survivors": (2, None, [("shrink", 0, {0, 1})]),
    "blocked_while_down": (4, (1,), [("shrink", 5, {1}), ("boundary",), ("want", 6)]),
    "breaker": (2, (), [("shrink", 0, {1}), ("boundary",), ("want", 1), ("regrow", 1),
                        ("shrink", 2, {1}), ("boundary",), ("want", 3), ("boundary",),
                        ("want", 4), ("regrow", 4), ("shrink", 5, {1})]
                + [("boundary",), ("want", 6)] * 3 + [("boundary",), ("want", 7)]),
}


@pytest.mark.parametrize("name", sorted(MONITOR_SEQUENCES))
def test_mesh_monitor_matches_jax(monkeypatch, name):
    set_faults(monkeypatch, "")
    n, down, calls = MONITOR_SEQUENCES[name]
    out = {}
    for pkg, mod in PACKAGES.items():
        policy = mod.RegrowPolicy(cooldown=1, flap_window=3, max_backoff=4)
        m = mod.MeshMonitor(n, policy=policy,
                            probe_fn=None if down is None else (lambda step, d=down: d))
        trace, target = [], None
        try:
            for call in calls:
                if call[0] == "shrink":
                    m.note_shrink(call[1], call[2], "device_lost")
                elif call[0] == "boundary":
                    m.note_boundary()
                elif call[0] == "want":
                    target = m.want_regrow(call[1])
                    trace.append(target)
                else:
                    m.note_regrow(call[1], target)
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            trace.append(type(e).__name__)
        out[pkg] = (trace, m.stats(), m.degraded, m.active)
    assert out["port"] == out["jax"]


# ------------------------------------------------ injector and classifier
DEVICE_SPECS = ["device_lost@3.2", "device_wedge@3.5", "device_wedge@2.1:3",
                "device_lost@1.0:2,device_lost@4.1", "device_lost@2.1x1"]


@pytest.mark.parametrize("spec", DEVICE_SPECS)
def test_device_injector_matches_jax(monkeypatch, spec):
    set_faults(monkeypatch, spec)
    for mod in (tfaults, jfaults):
        mod.reset()
    for step in range(12):
        assert tfaults.down_replicas(step) == jfaults.down_replicas(step), step
        for active in (None, (0, 1, 2, 3, 4, 5), (0, 3, 4)):
            got = []
            for mod in (tfaults, jfaults):
                try:
                    mod.device_fault(step, active=active)
                    got.append(None)
                except (tfaults.InjectedDeviceFault, jfaults.InjectedDeviceFault) as e:
                    got.append((str(e), e.replica, e.fault_kind))
            assert got[0] == got[1], (step, active)


def test_device_kinds_parse_and_others_stay_unported(monkeypatch):
    set_faults(monkeypatch, "device_wedge@3.5")
    assert tfaults.down_replicas(3) == {5} and tfaults.down_replicas(11) == frozenset()
    set_faults(monkeypatch, "replica_wedge@0.1")
    with pytest.raises(NotImplementedError, match="replica_wedge"):
        tfaults.device_fault(0)


@pytest.mark.parametrize("exc, expected", [
    (tfaults.InjectedDeviceFault("x", replica=3, fault_kind="device_wedge"), ("device_wedge", 3)),
    (dist.DistNetworkError("Connection closed by peer [127.0.0.1]:29500"), ("device_lost", None)),
    (dist.DistBackendError("NCCL error in: ProcessGroupNCCL.cpp, unhandled system error"),
     ("device_lost", None)),
    (RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Connection closed by "
                  "peer"), ("device_lost", None)),
    (RuntimeError("Gloo allreduce timed out after 300000ms"), ("device_lost", None)),
    (RuntimeError("collective timed out"), None),  # no backend named
    (dist.DistStoreError("bad argument"), None),
    (ValueError("device lost"), None),
])
def test_classify_device_fault(exc, expected):
    assert telastic.classify_device_fault(exc) == expected


def test_agree_on_down_in_one_process():
    for mod in (tdistributed, jdistributed):
        assert mod.agree_on_down({2, "5"}, 8) == frozenset({2, 5})
        assert mod.agree_on_down(set(), 8) == frozenset()


# --------------------------------------------- a real shrink on the CPU
WRAPPER = '''
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
import mx_rcnn_tpu_torch.tools.train_end2end as cli
from mx_rcnn_tpu_torch.config import generate_config


def small(network, dataset):
    cfg = generate_config("resnet50", dataset)
    return cfg.replace(
        network=dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4, 8), POOLED_SIZE=(7, 7)),
        dataset=dataclasses.replace(cfg.dataset, SCALES=((64, 96),)),
        SHAPE_BUCKETS=((64, 96), (96, 64)),
        TRAIN=dataclasses.replace(cfg.TRAIN, BATCH_ROIS=4, RPN_PRE_NMS_TOP_N=100,
                                  RPN_POST_NMS_TOP_N=16))


cli.generate_config = small
if __name__ == "__main__":
    out = cli.main(rank_command=[sys.executable, __file__])
    print("REPORT " + json.dumps(out, default=str), flush=True)
'''

# added to the wrapper: rank 1's process is killed in its second DP step,
# before that step's all-reduce
KILL_RANK_1 = '''
import os, signal
import torch.distributed as dist
from mx_rcnn_tpu_torch.parallel import mesh

_make_step = mesh.make_parallel_train_step


def make_parallel_train_step(m, accum_steps=1):
    step = _make_step(m, accum_steps)

    def dying_step(*args, **kwargs):
        dying_step.calls += 1
        if dist.get_rank() == 1 and dying_step.calls == 2:
            os.kill(os.getpid(), signal.SIGKILL)
        return step(*args, **kwargs)

    dying_step.calls, dying_step.comm, dying_step.mesh = 0, step.comm, step.mesh
    return dying_step


mesh.make_parallel_train_step = make_parallel_train_step
'''


def write_wrapper(tmp_path, extra: str = "") -> str:
    """A script that trains ``train_end2end`` at a small config on one
    thread (``extra``: more patches); the ``--cpu N`` launcher runs it again
    in every rank (``main(rank_command=)``)."""
    path = tmp_path / "train_small.py"
    path.write_text(WRAPPER.replace('if __name__ == "__main__":', extra + '\nif __name__ == "__main__":'))
    return str(path)


def run_wrapper(wrapper, args, env_extra=None, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop(tfaults.ENV_VAR, None)
    env.update(env_extra or {})
    r = subprocess.run([sys.executable, wrapper, *args], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=timeout)
    # the last report is the launching process's (each rank prints its own first)
    reports = [json.loads(line[len("REPORT "):]) for line in r.stdout.splitlines()
               if line.startswith("REPORT ")]
    return r, reports[-1] if reports else None


def start_ranks(wrapper, args_of, n, env_extra=None, timeout=240):
    """Start ``n`` ranks of the wrapper by hand (``--dist_*``, at a
    rendezvous this process hosts) under one deadline; → (return codes,
    outputs, seconds until the last exited)."""
    store, coordinator = tdistributed.host_rendezvous(n)
    env = dict(os.environ, PYTHONPATH=str(ROOT), **{tdistributed.HOSTED_STORE_ENV: "1"})
    env.pop(tfaults.ENV_VAR, None)
    env.update(env_extra or {})
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, wrapper, *args_of(i), "--dist_coordinator", coordinator,
         "--dist_nprocs", str(n), "--dist_procid", str(i)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(n)]
    try:
        outs = [p.communicate(timeout=max(t0 + timeout - time.monotonic(), 1.0))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store
    return [p.returncode for p in procs], outs, time.monotonic() - t0


def small_cfg():
    """The wrapper's config, in this process."""
    ns = {}
    exec(compile(WRAPPER.split("cli.generate_config = small")[0].replace(
        "torch.set_num_threads(1)", ""), "wrapper", "exec"), ns)
    return ns["small"]("resnet50", "PascalVOC")


def test_cli_elastic_shrink_matches_a_fresh_run_from_its_emergency_checkpoint(tmp_path):
    """``--cpu 2 --elastic`` with ``device_lost@1.1:1`` (4 synthetic images,
    a global batch of 2, 2 steps an epoch, 2 epochs): rank 1 is lost at
    stream step 1 and back at the epoch boundary.  Rank 0 writes the
    emergency dump at step 1 and the degraded epoch's dump; one rank
    restored from the emergency dump and stepped over the same batches'
    kept rows must write that epoch dump's checksum bit for bit; after the
    regrow both ranks end with the same state and the run exits 0."""
    prefix = tmp_path / "E"
    r, report = run_wrapper(write_wrapper(tmp_path), [
        "--cpu", "2", "--elastic", "--synthetic", "4", "--no_flip", "--epochs", "2",
        "--prefix", str(prefix), "--frequent", "1"], {tfaults.ENV_VAR: "device_lost@1.1:1"})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    el = report["elastic"]
    assert (el["shrinks"], el["regrows"], el["replayed_steps"], el["emergency_checkpoints"]) \
        == (1, 1, 0, 1)
    assert [t["event"] for t in el["transitions"]] == ["shrink", "regrow"]
    assert el["transitions"][0]["lost"] == [1] and not report["degraded"]
    assert report["steps"] == 4 and len(report["ranks"]) == 2
    assert report["ranks"][0]["state_checksum"] == report["ranks"][1]["state_checksum"]
    emergency = prefix / "step_0000_000001"
    assert tckpt.is_committed(str(emergency))
    assert tckpt.read_manifest(str(emergency))["meta"]["event"] == "shrink"

    # a fresh one-rank run from the emergency dump over the same batches
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = small_cfg()
        _, roidb = load_gt_roidb(cfg, None, flip=False, synthetic_size=4)
        model = build_model(cfg, generator=torch.Generator().manual_seed(9))
        model.to(memory_format=torch.channels_last).train()
        loader = TrainLoader(roidb, cfg, 2, shuffle=cfg.TRAIN.SHUFFLE, seed=0, prefetch=0)
        state = create_train_state(model, make_optimizer(cfg, model,
                                                          make_lr_schedule(cfg, len(loader))))
        tckpt.load_checkpoint(str(prefix), 0, state, 1)
        loader.skip_batches = 1
        for b in loader:
            # fit's step seed: --seed 0 + 123
            train_step(state, batch_to_device(take_replica_rows(b, 1, 2), "cpu"), 123)
        assert tckpt.tree_checksum(state.state_tree()) == tckpt.read_manifest(
            str(prefix / "epoch_0001"))["checksum"]
    finally:
        torch.set_num_threads(threads)


def test_a_rank_that_dies_ends_the_run_with_no_survivors(tmp_path):
    """A real loss, not an injected one: rank 1's process is killed in its
    second step of a two-rank ``--elastic`` run.  The process group cannot
    drop it, so rank 0's all-reduce fails, the agreement on the lost ranks
    fails with it, and rank 0 exits with ``NoSurvivorsError`` at once,
    long before a collective's timeout (``distributed.TIMEOUT_S``)."""
    wrapper = write_wrapper(tmp_path, KILL_RANK_1)
    codes, outs, seconds = start_ranks(wrapper, lambda i: [
        "--cpu", "1", "--elastic", "--synthetic", "8", "--no_flip", "--epochs", "1",
        "--prefix", str(tmp_path / f"K{i}")], 2, timeout=tdistributed.TIMEOUT_S / 2)
    assert codes[1] == -signal.SIGKILL, outs[1][-3000:]
    assert codes[0] not in (0, None) and "NoSurvivorsError" in outs[0], outs[0][-3000:]
    assert seconds < tdistributed.TIMEOUT_S / 4, seconds
