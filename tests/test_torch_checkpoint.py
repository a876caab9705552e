"""The port's checkpoints on the CPU (``core/checkpoint.py``), against the
JAX package where both can run:

- dump names, and the directory logic (committed, restorable, latest,
  prune) of both packages on the same directory of the port's dumps;
- save → load bitwise for the whole train state, the checksum gate and the
  fallback past corrupt, truncated and uncommitted dumps (``save_crash``),
  and the refusal of an Orbax dump;
- the preemption guard's flag and escalation;
- a JAX train state carried across by the bridge and a port checkpoint
  trains its next step as JAX's does, and ``accum_steps = 2`` as JAX's
  ``make_train_step(accum_steps=2)``;
- ``fit`` stopped by a real SIGTERM (at aux_interval 1 with the assembly
  pool's workers signalled too, and at 3) or from an epoch-boundary dump,
  then resumed: the batch stream and the final state equal an
  uninterrupted run's bit for bit; the watchdog's dump, made from the
  snapshot's host mirror while device reads hang, resumes with no batch
  lost (a stall in a step, and in an aux fetch at aux_interval 3);
- the CLI cycle: ``train_end2end --prefix`` → ``--resume`` →
  ``tools/test.py --prefix [--epoch]``, equal to ``--params``.

The CPU convolutions' backward splits its sums over threads, and a split
can change from run to run, so the runs compared bit for bit hold torch to
one thread.
"""

import copy
import dataclasses
import json
import math
import multiprocessing
import os
import pickle
import shutil
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mx_rcnn_tpu.core import checkpoint as jckpt
from mx_rcnn_tpu.core.metrics import MetricTracker as JMetricTracker
from mx_rcnn_tpu.core.metrics import Speedometer as JSpeedometer
from mx_rcnn_tpu.core.train import create_train_state as j_create_train_state
from mx_rcnn_tpu.core.train import make_lr_schedule as j_make_lr_schedule
from mx_rcnn_tpu.core.train import make_optimizer as j_make_optimizer
from mx_rcnn_tpu.core.train import make_train_step as j_make_train_step
from mx_rcnn_tpu.models import FasterRCNN as JFasterRCNN
from mx_rcnn_tpu.utils.run_meta import save_run_meta as j_save_run_meta
from mx_rcnn_tpu_torch.core import checkpoint as tckpt
from mx_rcnn_tpu_torch.core import pipeline as tpipeline
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.core.resilience import DivergencePolicy
from mx_rcnn_tpu_torch.core.metrics import METRIC_NAMES
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models import faster_rcnn as tfr
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.utils import faults
from mx_rcnn_tpu_torch.utils.bridge import (
    flax_state_to_torch,
    torch_state_to_flax,
    torch_to_flax,
)
from mx_rcnn_tpu_torch.utils.combine_model import save_params
from mx_rcnn_tpu_torch.utils.run_meta import save_run_meta
from tests.test_model import tiny_batch, tiny_cfg
from tests.test_torch_fit import small_cfg
from tests.test_torch_model import _perturb, _tame_rpn, port_cfg
from tests.test_torch_train import _Mini, _leaves, train_cfg


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Module-scoped, so the module's fixtures (the golden run) run at one
    thread too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_faults():
    faults.reset()
    yield
    faults.reset()


def T(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ names
@pytest.mark.parametrize("name", [
    "epoch_0001", "epoch_12", "epoch_0000", "step_0001_000002", "step_3_4", "step_0001",
    "step_0001_000002_3", "epoch_0001.tmp", "step_0001_000002.tmp", "epoch_x", "step_a_1",
    "run_meta.json", "epoch_", "epoch_0001_000000", "",
])
def test_checkpoint_names_parse_as_in_jax(name):
    assert tckpt._parse_ckpt_name(name) == jckpt._parse_ckpt_name(name)


@pytest.mark.parametrize("epoch,batch", [(0, 0), (1, 0), (12, 0), (0, 1), (3, 250), (9999, 999999)])
def test_checkpoint_names_format_as_in_jax(epoch, batch):
    name = tckpt._ckpt_name(epoch, batch)
    assert name == jckpt._ckpt_name(epoch, batch)
    assert tckpt._parse_ckpt_name(name) == (epoch, batch)


# ------------------------------------------------------------- a tiny state
def mini_state(seed=0):
    """``_Mini`` (a frozen conv0 and BN, a trainable conv and head) under
    MXNet SGD, its weights from ``seed``."""
    torch.manual_seed(seed)
    model = _Mini()
    with torch.no_grad():
        model.backbone.bn0.mean.uniform_(-1, 1)
        model.backbone.bn0.var.uniform_(0.5, 2)
    cfg = port_cfg(tiny_cfg())
    opt = ttrain.make_optimizer(cfg, model, lambda count: 0.1)
    return ttrain.create_train_state(model, opt)


def mini_step(state, seed):
    gen = torch.Generator().manual_seed(seed)
    state.optimizer.zero_grad()
    for p in state.optimizer.params:
        p.grad = torch.randn(p.shape, generator=gen)
    state.optimizer.step()


class _Pending:
    """A host copy's event that has not completed (a copy still queued)."""

    def query(self):
        return False


def test_snapshot_host_mirror_is_the_newest_complete_copy():
    """``TrainSnapshot.host`` gives the newest mirror whose copy completed,
    with the stream index it stands for, as a whole checkpoint tree; while
    a copy is pending it gives the older one, and the next fill is queued
    over the pending copy, never over the complete one.  A fill at count 0
    leaves no momentum in the tree, though the mirror's buffers exist."""
    state = mini_state(0)
    assert state.snapshot().host() is None  # no mirror: nothing on the host
    state.mirror_snapshots()
    snap = state.snapshot(None, 3)
    for index in (4, 5):
        mini_step(state, index)
        state.snapshot(snap, index)
        got, tree = snap.host()
        assert got == index and tree["count"] == index - 3
        assert tckpt.tree_checksum(tree) == tckpt.tree_checksum(state.state_tree())
    newest = max(snap._mirrors, key=lambda m: m.seq)
    newest.event = _Pending()
    assert snap.host()[0] == 4
    mini_step(state, 6)
    state.snapshot(snap, 6)
    assert newest.event is None and newest.index == 6  # queued over the pending one
    newest.event = _Pending()
    assert snap.host()[0] == 4
    newest.event = None
    got, tree = snap.host()
    assert got == 6 and tree["count"] == 3
    fresh = mini_state(0)
    fresh.mirror_snapshots()
    state.load_state_tree(fresh.state_tree())  # count 0: no momentum
    state.snapshot(snap, 0)
    got, tree = snap.host()
    assert got == 0 and all(v is None for v in tree["momentum"].values())
    assert tckpt.tree_checksum(tree) == tckpt.tree_checksum(fresh.state_tree())


def assert_same_state(a, b):
    ta, tb = a.state_tree(), b.state_tree()
    assert ta["count"] == tb["count"]
    assert ta["model"].keys() == tb["model"].keys()
    for k in ta["model"]:
        assert torch.equal(ta["model"][k], tb["model"][k]), k
    assert ta["momentum"].keys() == tb["momentum"].keys()
    for k, v in ta["momentum"].items():
        assert (v is None) == (tb["momentum"][k] is None), k
        assert v is None or torch.equal(v, tb["momentum"][k]), k


def test_save_load_is_bitwise_for_the_whole_state(tmp_path):
    """Weights, frozen tensors and BN buffers, momentum and count; a load at
    count 0 leaves no momentum buffer, and both copies train alike."""
    prefix = str(tmp_path / "ckpt")
    state = mini_state(0)
    tckpt.save_checkpoint(prefix, state, 0, 1)
    fresh = mini_state(1)
    mini_step(fresh, 5)
    tckpt.load_checkpoint(prefix, 0, fresh, 1)
    assert_same_state(state, fresh)
    assert all("momentum_buffer" not in fresh.optimizer.sgd.state[p]
               for p in fresh.optimizer.params)
    mini_step(state, 1)
    mini_step(state, 2)
    path = tckpt.save_checkpoint(prefix, state, 1)
    man = tckpt.read_manifest(path)
    assert man["step"] == 2 and man["epoch"] == 1 and man["batch_in_epoch"] == 0
    assert set(man) == {"format", "epoch", "batch_in_epoch", "step", "checksum", "files"}
    assert man["files"] == {"state.pt": os.path.getsize(os.path.join(path, "state.pt"))}
    assert man["checksum"] == tckpt.tree_checksum(state.state_tree())
    fresh = mini_state(1)
    assert tckpt.load_checkpoint(prefix, 1, fresh) is fresh
    assert_same_state(state, fresh)
    assert fresh.optimizer.count == 2
    mini_step(state, 3)
    mini_step(fresh, 3)
    assert_same_state(state, fresh)
    # an nn.Module takes the weights only
    model = mini_state(2).model
    tckpt.load_checkpoint(prefix, 1, model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, tckpt.restore_tree(path)["model"][k]), k


def test_checksum_names_dtype_shape_and_bytes():
    a = {"model": {"w": torch.arange(6.0)}, "count": 1}
    ref = tckpt.tree_checksum(a)
    assert tckpt.tree_checksum({"count": 1, "model": {"w": torch.arange(6.0)}}) == ref
    for other in ({"model": {"w": torch.arange(6.0).reshape(2, 3)}, "count": 1},
                  {"model": {"w": torch.arange(6, dtype=torch.float64)}, "count": 1},
                  {"model": {"v": torch.arange(6.0)}, "count": 1},
                  {"model": {"w": torch.arange(6.0)}, "count": 2}):
        assert tckpt.tree_checksum(other) != ref
    # the memory format does not enter
    x = torch.randn(2, 3, 4, 5)
    assert (tckpt.tree_checksum({"x": x})
            == tckpt.tree_checksum({"x": x.to(memory_format=torch.channels_last)}))


def test_checksum_mismatch_raises_and_restorable_falls_back(tmp_path):
    prefix = str(tmp_path / "ckpt")
    state = mini_state(0)
    tckpt.save_checkpoint(prefix, state, 1)
    mini_step(state, 1)
    newer = tckpt.save_checkpoint(prefix, state, 2)
    mpath = os.path.join(newer, tckpt.MANIFEST)
    man = json.load(open(mpath))
    man["checksum"] = "0" * 64
    with open(mpath, "w") as f:
        json.dump(man, f)
    assert tckpt.latest_checkpoint(prefix) == (2, 0)  # the size check alone passes
    with pytest.raises(tckpt.CheckpointCorrupt, match="checksum"):
        tckpt.load_checkpoint(prefix, 2, mini_state(1))
    pos, restored = tckpt.load_restorable(prefix, mini_state(1))
    assert pos == (1, 0) and restored.optimizer.count == 0
    assert_same_state(restored, mini_state(0))


def test_crash_mid_save_leaves_an_uncommitted_tmp(tmp_path, monkeypatch):
    prefix = str(tmp_path / "ckpt")
    state = mini_state(0)
    tckpt.save_checkpoint(prefix, state, 1)
    monkeypatch.setenv(faults.ENV_VAR, "save_crash@1")
    faults.reset()
    mini_step(state, 1)
    with pytest.raises(faults.SimulatedCrash):
        tckpt.save_checkpoint(prefix, state, 2)
    assert os.path.isdir(os.path.join(prefix, "epoch_0002.tmp"))
    assert not os.path.isdir(os.path.join(prefix, "epoch_0002"))
    assert tckpt.latest_checkpoint(prefix) == jckpt.latest_checkpoint(prefix) == (1, 0)
    pos, restored = tckpt.load_restorable(prefix, mini_state(1))
    assert pos == (1, 0) and restored.optimizer.count == 0
    tckpt.prune_step_checkpoints(prefix, up_to_epoch=0)
    assert not os.path.isdir(os.path.join(prefix, "epoch_0002.tmp"))
    # the second save is #2: no crash
    tckpt.save_checkpoint(prefix, state, 2)
    assert tckpt.latest_checkpoint(prefix) == (2, 0)


def _dump_dir(root):
    """A directory of the port's dumps: committed epoch and step dumps, an
    orphaned .tmp, a truncated dump and one with no manifest."""
    prefix = str(root)
    state = mini_state(0)
    for epoch, batch in [(1, 0), (1, 3), (2, 0), (2, 1), (2, 5), (3, 0), (3, 2)]:
        mini_step(state, epoch * 10 + batch)
        tckpt.save_checkpoint(prefix, state, epoch, batch)
    os.makedirs(os.path.join(prefix, "epoch_0004.tmp"))
    shutil.copy(os.path.join(prefix, "epoch_0003", "state.pt"),
                os.path.join(prefix, "epoch_0004.tmp", "state.pt"))
    with open(os.path.join(prefix, "step_0003_000002", "state.pt"), "r+b") as f:
        f.truncate(100)                               # truncated: newest step dump
    os.remove(os.path.join(prefix, "step_0002_000005", tckpt.MANIFEST))  # never committed
    save_run_meta(prefix, small_cfg())
    return prefix


def test_directory_logic_agrees_with_jax(tmp_path):
    prefix = _dump_dir(tmp_path / "ckpt")
    for d in sorted(os.listdir(prefix)):
        path = os.path.join(prefix, d)
        assert tckpt.is_committed(path) == jckpt.is_committed(path), d
        assert tckpt.read_manifest(path) == jckpt.read_manifest(path), d
    assert tckpt.restorable_checkpoints(prefix) == jckpt.restorable_checkpoints(prefix)
    assert tckpt.restorable_checkpoints(prefix) == [(3, 0), (2, 1), (2, 0), (1, 3), (1, 0)]
    assert tckpt.latest_checkpoint(prefix) == jckpt.latest_checkpoint(prefix) == (3, 0)
    assert tckpt.latest_epoch(prefix) == jckpt.latest_epoch(prefix) == 3
    # a dump with no manifest is never loaded unverified
    with pytest.raises(tckpt.CheckpointCorrupt, match="manifest"):
        tckpt.load_checkpoint(prefix, 2, mini_state(1), 5)


@pytest.mark.parametrize("up_to_epoch", [0, 1, 2, 3])
def test_prune_leaves_the_names_jax_leaves(tmp_path, up_to_epoch):
    prefix = _dump_dir(tmp_path / "ckpt")
    twin = str(tmp_path / "twin")
    shutil.copytree(prefix, twin)
    tckpt.prune_step_checkpoints(prefix, up_to_epoch)
    jckpt.prune_step_checkpoints(twin, up_to_epoch)
    left = sorted(os.listdir(prefix))
    assert left == sorted(os.listdir(twin))
    assert "epoch_0004.tmp" not in left and "step_0002_000001" in left  # the newest committed


def test_an_orbax_dump_is_refused_by_name(tmp_path):
    """A dump of the JAX package (Orbax data, its manifest) under a port
    prefix: committed to both packages' readers, refused on load with a
    message naming Orbax, and skipped by ``load_restorable``."""
    prefix = str(tmp_path / "ckpt")
    state = mini_state(0)
    tckpt.save_checkpoint(prefix, state, 1)
    tx = optax.sgd(0.1)
    jstate = j_create_train_state({"w": jnp.ones(3)}, tx)
    path = jckpt.save_checkpoint(prefix, jstate, 2)
    assert tckpt.is_committed(path) and tckpt.latest_checkpoint(prefix) == (2, 0)
    with pytest.raises(tckpt.CheckpointCorrupt, match="Orbax"):
        tckpt.load_checkpoint(prefix, 2, mini_state(1))
    with pytest.raises(tckpt.CheckpointCorrupt, match="Orbax"):
        tckpt.restore_tree(path)
    pos, restored = tckpt.load_restorable(prefix, mini_state(1))
    assert pos == (1, 0)
    assert_same_state(restored, state)


# ----------------------------------------------------------------- the guard
def test_preemption_guard_sets_its_flag_once_then_escalates():
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        guard = tckpt.PreemptionGuard(signals=(signal.SIGUSR1,))
        try:
            assert not guard.should_stop
            os.kill(os.getpid(), signal.SIGUSR1)
            assert guard.should_stop and seen == []
            os.kill(os.getpid(), signal.SIGUSR1)   # second: the previous handler
            assert seen == [signal.SIGUSR1]
        finally:
            guard.uninstall()
    finally:
        signal.signal(signal.SIGUSR1, prev)


# ------------------------------------------------ a JAX state, resumed here
N_ANCHORS = 8 * 8 * 9       # tiny_cfg at 128 × 128: stride 16, 3 ratios × 3 scales


@pytest.fixture(scope="module")
def jax_run():
    """Three steps of JAX ``make_train_step`` on ``tiny_batch`` (sample seed
    0) from the port's seeded weights, and the port's draws for any JAX step
    and image seed."""
    jcfg = train_cfg()
    tcfg = port_cfg(jcfg)
    batch = tiny_batch(np.random.RandomState(0))
    batch["sample_seeds"] = jnp.asarray([0], jnp.int32)
    model = FasterRCNN(tcfg, generator=torch.Generator().manual_seed(0))
    params_np = _tame_rpn(_perturb(torch_to_flax(model), np.random.RandomState(1)))
    jmodel = JFasterRCNN(jcfg)
    params = jax.tree.map(jnp.asarray, params_np)
    tx = j_make_optimizer(jcfg, j_make_lr_schedule(jcfg, 10))
    rng = jax.random.key(7)
    step = j_make_train_step(jmodel, tx, donate=False)
    states, auxes = [j_create_train_state(params, tx)], []
    for _ in range(3):
        s, aux = step(states[-1], batch, rng)
        states.append(s)
        auxes.append(aux)
    def draws_of(step_k, seeds=(0,), n_anchors=N_ANCHORS,
                 n_cand=jcfg.TRAIN.RPN_POST_NMS_TOP_N + batch["gt_boxes"].shape[1]):
        """The uniforms JAX's train_forward draws at step ``step_k`` for each
        image seed, under :data:`tfr.DRAW_NAMES`."""
        k = jmodel.apply({"params": params}, method=lambda m: m.make_rng("sampling"),
                         rngs={"sampling": jax.random.fold_in(rng, step_k)})
        rows = {name: [] for name in tfr.DRAW_NAMES}
        for s in seeds:
            k_anchor, k_roi = jax.random.split(jax.random.fold_in(k, s), 2)
            u = [jax.random.uniform(kk, (n_anchors,)) for kk in jax.random.split(k_anchor)]
            u += [jax.random.uniform(kk, (n_cand,)) for kk in jax.random.split(k_roi, 3)]
            for name, x in zip(tfr.DRAW_NAMES, u):
                rows[name].append(np.asarray(x))
        return {name: T(np.stack(v)) for name, v in rows.items()}

    return {"states": [jax.tree.map(np.asarray, jax.device_get(s)) for s in states],
            "aux": auxes, "draws_of": draws_of, "cfg": tcfg, "jcfg": jcfg, "jmodel": jmodel,
            "tx": tx, "rng": rng, "batch": batch,
            "port_batch": {k: T(v) for k, v in batch.items() if k != "sample_seeds"}}


@pytest.fixture(scope="module")
def c4_model():
    return FasterRCNN(port_cfg(train_cfg()), generator=torch.Generator().manual_seed(3))


def port_state(cfg, model):
    """A train state of a copy of ``model`` (its weights unlike the JAX
    run's, which a load overwrites)."""
    model = copy.deepcopy(model)
    opt = ttrain.make_optimizer(cfg, model, ttrain.make_lr_schedule(cfg, 10))
    return ttrain.create_train_state(model, opt)


def jax_trace(state_np):
    chain = state_np.opt_state.inner_states["train"].inner_state
    return next(s.trace for s in chain if hasattr(s, "trace"))


def test_bridged_state_round_trips(jax_run, c4_model):
    """JAX → port → JAX gives the weights, the trace and the step back bit
    for bit (the trace's frozen leaves are optax MaskedNodes); port → JAX →
    port the whole state; at step 0 the port has no momentum buffers and
    JAX's zero trace comes back."""
    for k in (0, 2):
        js = jax_run["states"][k]
        st = port_state(jax_run["cfg"], c4_model)
        flax_state_to_torch(js, st)
        assert st.optimizer.count == k
        assert all((st.optimizer.sgd.state[p].get("momentum_buffer") is None) == (k == 0)
                   for p in st.optimizer.params)
        back = torch_state_to_flax(st)
        assert int(back["step"]) == k
        got_p, got_t = dict(_leaves(back["params"])), dict(_leaves(back["trace"]))
        ref_p = dict(_leaves(js.params))
        assert got_p.keys() == ref_p.keys()
        for path, ref in ref_p.items():
            np.testing.assert_array_equal(got_p[path], ref, err_msg="/".join(path))
        ref_t = {tuple(str(getattr(e, "key", e)) for e in path): np.asarray(leaf)
                 for path, leaf in jax.tree_util.tree_flatten_with_path(jax_trace(js))[0]}
        assert got_t.keys() == ref_t.keys() and len(ref_t) == len(st.names)
        for path, ref in ref_t.items():
            np.testing.assert_array_equal(got_t[path], ref, err_msg="/".join(path))
        again = port_state(jax_run["cfg"], c4_model)
        flax_state_to_torch(back, again)
        assert_same_state(st, again)


def test_a_jax_state_resumes_through_a_port_checkpoint_as_in_jax(jax_run, c4_model, tmp_path):
    """JAX's state after 2 steps → the bridge → a port checkpoint → a fresh
    model and optimizer; one port step with JAX's step-2 draws matches JAX's
    third step within ``tests/test_torch_train.py``'s bars for a step: the
    loss and aux 1e-4 relative, the parameters 1e-5 relative (1e-7 absolute)
    and the momentum trace's gradient part 2e-3 of its largest value."""
    j = jax_run
    st = port_state(j["cfg"], c4_model)
    flax_state_to_torch(j["states"][2], st)
    prefix = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(prefix, st, 0, 2)
    fresh = port_state(j["cfg"], c4_model)
    tckpt.load_checkpoint(prefix, 0, fresh, 2)
    assert_same_state(st, fresh)
    _, aux = ttrain.train_step(fresh, j["port_batch"], 0, draws=j["draws_of"](2))
    assert fresh.optimizer.count == 3
    ref_aux = j["aux"][2]
    np.testing.assert_allclose(float(aux["loss"]), float(ref_aux["loss"]), rtol=1e-4)
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), float(ref_aux[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    got = torch_state_to_flax(fresh)
    got_p = dict(_leaves(got["params"]))
    for path, ref in _leaves(j["states"][3].params):
        np.testing.assert_allclose(got_p[path], ref, rtol=1e-5, atol=1e-7, err_msg="/".join(path))
    wd, mom = j["cfg"].TRAIN.WD, j["cfg"].TRAIN.MOMENTUM
    st3 = port_state(j["cfg"], c4_model)
    flax_state_to_torch(j["states"][3], st3)
    trace2 = dict(_leaves(torch_state_to_flax(st)["trace"]))
    trace3 = dict(_leaves(torch_state_to_flax(st3)["trace"]))
    params2 = dict(_leaves(j["states"][2].params))
    for path, t in dict(_leaves(got["trace"])).items():
        grad_part = trace3[path] - mom * trace2[path] - wd * params2[path]
        err = float(np.abs(t - trace3[path]).max())
        assert err <= 2e-3 * float(np.abs(grad_part).max()) + 1e-6, "/".join(path)


def test_accumulated_step_matches_jax(jax_run):
    """``accum_steps = 2`` over 2 images with sample seeds 0 and 1 and JAX's
    draws for each, from the same weights, against JAX's
    ``make_train_step(accum_steps=2)``: the averaged loss and aux, and the
    updated parameters, within the bars of one step.  At 64 × 64 with 16
    proposals: XLA runs the scan of microbatches on the CPU ~40× slower
    than the unrolled step at tiny_cfg's 400, most of it in the NMS."""
    j = jax_run
    jcfg = train_cfg()
    jcfg = jcfg.replace(TRAIN=dataclasses.replace(jcfg.TRAIN, RPN_PRE_NMS_TOP_N=16,
                                                  RPN_POST_NMS_TOP_N=8, BATCH_ROIS=8,
                                                  RPN_BATCH_SIZE=16))
    tcfg = port_cfg(jcfg)
    batch = tiny_batch(np.random.RandomState(3), b=2, h=64, w=64)
    gt = np.zeros((2, 4, 5), np.float32)
    gt[:, 0] = [4, 4, 36, 36, 1]
    gt[:, 1] = [28, 24, 60, 58, 2]
    batch["gt_boxes"] = jnp.asarray(gt)
    batch["sample_seeds"] = jnp.asarray([0, 1], jnp.int32)
    tx = j_make_optimizer(jcfg, j_make_lr_schedule(jcfg, 10))
    step = j_make_train_step(JFasterRCNN(jcfg), tx, donate=False, accum_steps=2)
    params = jax.tree.map(jnp.asarray, j["states"][0].params)
    new, ref_aux = step(j_create_train_state(params, tx), batch, j["rng"])
    st = port_state(tcfg, FasterRCNN(tcfg))
    flax_state_to_torch(j["states"][0], st)
    tb = {k: T(v) for k, v in batch.items() if k != "sample_seeds"}
    draws = j["draws_of"](0, seeds=(0, 1), n_anchors=4 * 4 * 9, n_cand=8 + 4)
    _, aux = ttrain.train_step(st, tb, 0, draws=draws, accum_steps=2)
    assert st.optimizer.count == 1 and float(ref_aux["num_fg_rois"]) > 0
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), float(ref_aux[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    got_p = dict(_leaves(torch_state_to_flax(st)["params"]))
    for path, ref in _leaves(jax.tree.map(np.asarray, new.params)):
        np.testing.assert_allclose(got_p[path], ref, rtol=1e-5, atol=1e-7, err_msg="/".join(path))
    with pytest.raises(ValueError, match="microbatches"):
        ttrain.train_step(st, tb, 0, accum_steps=3)


# --------------------------------------------------- fit, stopped and resumed
SCHEDULE = {"aux_interval": 1, "feed_depth": 1, "prefetch": 0, "assembly_workers": 0,
            # the guard's loss average is not part of a checkpoint (in either
            # package): a resumed run checks for spikes afresh, and a random
            # model's loss jumps 10x from batch to batch
            "guard_policy": DivergencePolicy(spike_factor=1e6)}


def ckpt_cfg():
    """``small_cfg`` at 64 × 96 with 4 rois pooled 7 × 7: ~0.5 s a step on
    one CPU thread."""
    cfg = small_cfg()
    return cfg.replace(dataset=dataclasses.replace(cfg.dataset, SCALES=((64, 96),)),
                       SHAPE_BUCKETS=((64, 96), (96, 64)),
                       network=dataclasses.replace(cfg.network, POOLED_SIZE=(7, 7)),
                       TRAIN=dataclasses.replace(cfg.TRAIN, BATCH_ROIS=4))


@pytest.fixture
def sigterm_safety():
    """A SIGTERM that lands after ``fit`` has uninstalled its guard must
    not kill the test process: the guard restores this handler."""
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    yield seen
    signal.signal(signal.SIGTERM, prev)


@pytest.fixture(scope="module")
def pristine():
    return FasterRCNN(ckpt_cfg(), generator=torch.Generator().manual_seed(5))


def roidb4():
    return SyntheticDataset(num_images=4, image_size=(160, 200)).gt_roidb()


def run(pristine, prefix, log, **kw):
    model = copy.deepcopy(pristine)
    out = fit(model, ckpt_cfg(), roidb4(), epochs=kw.pop("epochs", 2), device="cpu",
              prefix=prefix, stream_log=log, **{**SCHEDULE, **kw})
    return out


@pytest.fixture(scope="module")
def golden(pristine, tmp_path_factory):
    """The uninterrupted run: 2 epochs of 4 batches."""
    root = tmp_path_factory.mktemp("golden")
    prev = signal.getsignal(signal.SIGTERM)
    out = run(pristine, str(root / "A"), str(root / "golden.log"))
    assert signal.getsignal(signal.SIGTERM) is prev  # the guard uninstalled
    return {"lines": (root / "golden.log").read_text().splitlines(),
            "tree": out["state"].state_tree(), "prefix": str(root / "A"), "out": out}


def assert_tree_equals(tree, ref):
    assert tree["count"] == ref["count"]
    for k in ref["model"]:
        assert torch.equal(tree["model"][k], ref["model"][k]), k
    for k, v in ref["momentum"].items():
        assert torch.equal(tree["momentum"][k], v), k


def test_golden_run_saves_each_epoch(golden):
    out, prefix = golden["out"], golden["prefix"]
    assert len(golden["lines"]) == 8 and out["steps"] == 8 and not out["preempted"]
    assert tckpt.restorable_checkpoints(prefix) == [(2, 0), (1, 0)]
    assert [(s["epoch"], s["batch"]) for s in out["saves"]] == [(1, 0), (2, 0)]
    assert all(s["bytes"] > 0 and s["seconds"] > 0 for s in out["saves"])
    assert tckpt.read_manifest(os.path.join(prefix, "epoch_0002"))["step"] == 8
    assert_tree_equals(tckpt.restore_tree(os.path.join(prefix, "epoch_0002")), golden["tree"])


def sigterm_after(log, k, children=False):
    """A thread that sends this process SIGTERM once ``log`` has ``k``
    lines (and first each live multiprocessing child, as a signal to the
    process group would); returns it and the children it signalled."""
    signalled = []

    def send():
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if os.path.exists(log):
                with open(log) as f:
                    if len(f.read().splitlines()) >= k:
                        break
            time.sleep(0.005)
        if children:
            for p in multiprocessing.active_children():
                signalled.append(p)
                os.kill(p.pid, signal.SIGTERM)
        os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=send, daemon=True)
    t.start()
    return t, signalled


@pytest.mark.parametrize("knobs", [
    {"aux_interval": 1, "assembly_workers": 2},
    {"aux_interval": 3, "feed_depth": 2, "prefetch": 2},
], ids=["aux1-pool", "aux3"])
def test_sigterm_then_resume_consumes_the_golden_stream(pristine, golden, tmp_path, monkeypatch,
                                                         sigterm_safety, knobs):
    """A real SIGTERM once the stream log has 6 lines; a 2 s stall at step
    5 holds the run there, so the signal lands in that step: a committed
    ``step_0001_000002`` dump, then ``fit(resume=True)`` continues.  The
    concatenated log equals the golden run's, so do ``epoch_0002``'s
    checksum and the final state, bit for bit.  Pool workers signalled with
    the process outlive the dump and exit cleanly."""
    prefix, log = str(tmp_path / "B"), str(tmp_path / "stream.log")
    monkeypatch.setenv(faults.ENV_VAR, "stall@5:2")
    faults.reset()
    thread, signalled = sigterm_after(log, 6, children=knobs.get("assembly_workers", 0) > 0)
    out = run(pristine, prefix, log, **knobs)
    thread.join(timeout=60)
    assert not thread.is_alive() and sigterm_safety == []
    assert out["preempted"] and out["stopped_at"] == (1, 2) and out["steps"] == 6
    assert tckpt.latest_checkpoint(prefix) == (1, 2)
    assert out["saves"][-1]["path"].endswith("step_0001_000002")
    if knobs.get("assembly_workers"):
        assert signalled
        for p in signalled:
            p.join(timeout=30)
            assert p.exitcode == 0, p
    monkeypatch.delenv(faults.ENV_VAR)
    faults.reset()
    again = run(pristine, prefix, log, resume=True, **knobs)
    assert again["begin"] == (1, 2) and again["steps"] == 2 and not again["preempted"]
    with open(log) as f:
        assert f.read().splitlines() == golden["lines"]
    man = tckpt.read_manifest(os.path.join(prefix, "epoch_0002"))
    assert man["checksum"] == tckpt.read_manifest(
        os.path.join(golden["prefix"], "epoch_0002"))["checksum"]
    assert_tree_equals(again["state"].state_tree(), golden["tree"])
    # the boundary save pruned nothing it must keep: the newest step dump stays
    assert tckpt.restorable_checkpoints(prefix) == [(2, 0), (1, 2), (1, 0)]


def test_resume_from_an_epoch_boundary_consumes_the_golden_stream(pristine, golden, tmp_path):
    """The golden run's ``epoch_0001`` alone under a new prefix: the resumed
    run consumes the golden run's second epoch and ends in its state; a
    resume of the finished run trains nothing."""
    prefix, log = str(tmp_path / "B"), str(tmp_path / "stream.log")
    os.makedirs(prefix)
    shutil.copytree(os.path.join(golden["prefix"], "epoch_0001"),
                    os.path.join(prefix, "epoch_0001"))
    again = run(pristine, prefix, log, resume=True)
    assert again["begin"] == (1, 0) and again["steps"] == 4
    with open(log) as f:
        assert f.read().splitlines() == golden["lines"][4:]
    assert_tree_equals(again["state"].state_tree(), golden["tree"])
    done = run(pristine, prefix, str(tmp_path / "none.log"), resume=True)
    assert done["begin"] == (2, 0) and done["steps"] == 0


@pytest.mark.parametrize("knobs,stall,at", [
    ({"snapshot_every": 2}, "step", (0, 2)),
    ({"aux_interval": 3, "feed_depth": 2, "prefetch": 2}, "flush", (0, 0)),
], ids=["aux1", "aux3-flush"])
def test_watchdog_dump_resumes_with_no_batch_lost(pristine, golden, tmp_path, monkeypatch,
                                                  knobs, stall, at):
    """A 4.5 s stall past a 3 s ``step_timeout``, while every read of device
    memory from another thread hangs, as on a hung card: the watchdog saves
    the loop's snapshot from its host mirror, at the position that snapshot
    stands for, and exits 75 (``os._exit`` patched) before the stall ends.
    At aux_interval 1 the stall is at step 3 and the guard's snapshot (every
    2 steps) was taken before step 2; at 3 the stall is in the first
    window's aux fetch and the window snapshot stands before step 0.  A
    resume from the dump consumes the unsaved batches again and ends the
    epoch in the golden run's ``epoch_0001`` state."""
    prefix, log = str(tmp_path / "W"), str(tmp_path / "stream.log")
    exited = []
    done = threading.Event()
    main = threading.main_thread()
    real_host = ttrain._host

    def fake_exit(code):
        exited.append(code)
        done.set()

    def hung_device_read(t):
        if threading.current_thread() is not main:
            time.sleep(120)
        return real_host(t)

    monkeypatch.setattr(os, "_exit", fake_exit)
    monkeypatch.setattr(ttrain, "_host", hung_device_read)
    if stall == "step":
        monkeypatch.setenv(faults.ENV_VAR, "stall@3:4.5")
        faults.reset()
    else:
        fetch = tpipeline.AsyncAuxSink.fetch
        calls = []

        def stalled_fetch(self, *a, **kw):
            calls.append(1)
            if len(calls) == 1:
                time.sleep(4.5)
            return fetch(self, *a, **kw)

        monkeypatch.setattr(tpipeline.AsyncAuxSink, "fetch", stalled_fetch)
    out = run(pristine, prefix, log, epochs=1, step_timeout=3.0, max_steps=4, **knobs)
    assert done.wait(timeout=60) and exited == [75]
    assert out["steps"] == 4 and tckpt.restorable_checkpoints(prefix) == [at]
    dump = tckpt.restore_tree(os.path.join(prefix, tckpt._ckpt_name(*at)))
    assert dump["count"] == at[1] and set(dump["model"]) == set(pristine.state_dict())
    monkeypatch.undo()
    faults.reset()
    log2 = str(tmp_path / "resumed.log")
    again = run(pristine, prefix, log2, epochs=1, resume=True)
    assert again["begin"] == at and again["steps"] == 4 - at[1]
    with open(log) as f1, open(log2) as f2:
        assert f1.read().splitlines()[:at[1]] + f2.read().splitlines() == golden["lines"][:4]
    assert_tree_equals(again["state"].state_tree(),
                       tckpt.restore_tree(os.path.join(golden["prefix"], "epoch_0001")))


# --------------------------------------------------------------- the CLI
def test_cli_cycle_trains_resumes_and_evaluates(tmp_path, monkeypatch):
    """``train_end2end --prefix D --synthetic 4 --no_flip --epochs 2`` writes
    run_meta.json (the JAX trainer's keys) and two epoch dumps, ``--resume
    --epochs 3`` continues, a torch.profiler trace is written (ending
    inside its window too) and the metrics JSON lines carry JAX's
    Speedometer keys; ``tools/test.py --prefix D`` evaluates the newest
    dump, ``--epoch 1`` the first, and the newest's mAP and detections
    equal ``--params`` with the bridged pickle of its weights."""
    from mx_rcnn_tpu_torch.core import fit as fit_mod
    from mx_rcnn_tpu_torch.tools import test as test_cli
    from mx_rcnn_tpu_torch.tools import train_end2end as train_cli

    monkeypatch.setattr(train_cli, "generate_config", lambda network, dataset: ckpt_cfg())
    monkeypatch.setattr(test_cli, "generate_config", lambda network, dataset: ckpt_cfg())
    monkeypatch.setattr(fit_mod, "PROFILE_STEPS", (2, 6))  # the resumed run ends inside
    prefix, jsonl = str(tmp_path / "D"), str(tmp_path / "metrics.jsonl")
    args = ["--cpu", "1", "--synthetic", "4", "--no_flip", "--prefix", prefix, "--frequent", "2",
            "--metrics_jsonl", jsonl]
    first = train_cli.main(args + ["--epochs", "2", "--profile", str(tmp_path / "prof1")])
    assert first["steps"] == 8 and tckpt.restorable_checkpoints(prefix) == [(2, 0), (1, 0)]
    assert os.path.getsize(tmp_path / "prof1" / "trace.json") > 0
    meta = json.load(open(os.path.join(prefix, "run_meta.json")))
    j_save_run_meta(str(tmp_path / "J"), tiny_cfg())
    assert set(meta) == set(json.load(open(tmp_path / "J" / "run_meta.json")))
    again = train_cli.main(args + ["--epochs", "3", "--resume", "--profile",
                                   str(tmp_path / "prof2")])
    assert again["begin"] == (2, 0) and again["steps"] == 4
    assert os.path.getsize(tmp_path / "prof2" / "trace.json") > 0  # ended inside the window
    assert tckpt.latest_checkpoint(prefix) == (3, 0)

    recs = [json.loads(line) for line in open(jsonl)]
    assert len(recs) == 6
    JSpeedometer(1, 1, jsonl_path=str(tmp_path / "j.jsonl"))(0, 1, JMetricTracker())
    ref_keys = set(json.loads(open(tmp_path / "j.jsonl").readline()))
    assert all(set(r) == ref_keys for r in recs) and ref_keys >= set(METRIC_NAMES)

    assert test_cli.pick_checkpoint(prefix, None) == (3, 0)
    assert test_cli.pick_checkpoint(prefix, 1) == (1, 0)
    base = ["--cpu", "1", "--synthetic", "2"]
    latest = test_cli.main(base + ["--prefix", prefix, "--dump", str(tmp_path / "latest.pkl")])
    first_epoch = test_cli.main(base + ["--prefix", prefix, "--epoch", "1"])
    model = FasterRCNN(ckpt_cfg())
    model.load_state_dict(tckpt.restore_tree(os.path.join(prefix, "epoch_0003"))["model"])
    params = str(tmp_path / "P" / "params.pkl")
    os.makedirs(os.path.dirname(params))
    save_params(params, torch_to_flax(model))
    shutil.copy(os.path.join(prefix, "run_meta.json"), tmp_path / "P" / "run_meta.json")
    by_params = test_cli.main(base + ["--params", params, "--dump", str(tmp_path / "params.pkl")])
    assert latest["mAP"] == by_params["mAP"] and math.isfinite(first_epoch["mAP"])
    with open(tmp_path / "latest.pkl", "rb") as f1, open(tmp_path / "params.pkl", "rb") as f2:
        a, b = pickle.load(f1), pickle.load(f2)
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        for da, db in zip(ca, cb):
            np.testing.assert_array_equal(da, db)


def test_cli_no_dump_evaluates_the_seeded_model(tmp_path, monkeypatch, caplog):
    import logging

    from mx_rcnn_tpu_torch.tools import test as test_cli

    monkeypatch.setattr(test_cli, "generate_config", lambda network, dataset: ckpt_cfg())
    with caplog.at_level(logging.WARNING):
        out = test_cli.main(["--cpu", "1", "--synthetic", "1", "--prefix", str(tmp_path / "none")])
    assert "no checkpoint found" in caplog.text and math.isfinite(out["mAP"])


def test_cli_grad_accum_takes_microbatches(tmp_path, monkeypatch):
    """``--grad_accum 2``: the loader's batches hold 2 images and the step
    splits them in two."""
    from mx_rcnn_tpu_torch.core import fit as fit_mod
    from mx_rcnn_tpu_torch.tools import train_end2end as train_cli

    seen = []
    orig = ttrain.train_step

    def spy(state, batch, *a, **k):
        seen.append((batch["images"].shape[0], k.get("accum_steps")))
        return orig(state, batch, *a, **k)

    monkeypatch.setattr(train_cli, "generate_config", lambda network, dataset: ckpt_cfg())
    monkeypatch.setattr(fit_mod, "train_step", spy)
    out = train_cli.main(["--cpu", "1", "--synthetic", "2", "--no_flip", "--grad_accum", "2",
                          "--max_steps", "1", "--prefix", str(tmp_path / "e2e")])
    assert out["steps"] == 1 and seen == [(2, 2)]
    assert all(math.isfinite(v) for v in out["history"][0].values())
