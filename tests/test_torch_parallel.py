"""The port's data parallel (``parallel/mesh.py``, ``parallel/distributed.py``,
``parallel/dist_smoke.py``, the CLI's ``--cpu N`` and ``--dist_*``) on the
CPU over gloo, in rank processes of the port.

- Two ranks, one image each of ``tests/test_torch_train.py``'s 2-image
  batch with per-image ``sample_seeds`` and JAX's draws injected: after one
  DP step the parameters match JAX's ``make_train_step`` on the whole batch
  (that file's parity bar), the loss within 1e-5, the ranks bit for bit
  equal, and the port's own ``train_step`` on the whole batch within
  1e-5 / 1e-6.
- World size 1 (gloo, in this process) is ``train_step`` bit for bit; a
  seedless batch folds the rank's position into the seed.
- The host arithmetic (``take_replica_rows``, ``process_slice``,
  ``local_global_batch_sizes``) equals JAX's; the row-sliced loader.
- ``train_end2end --cpu 2``, its resume as two ``--dist_*`` processes
  (only rank 0 writes, ``--resume`` takes rank 0's dump on both ranks), and
  the two-process smoke.
"""

import copy
import json
import os
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.core.train import create_train_state as j_create_train_state
from mx_rcnn_tpu.core.train import make_lr_schedule as j_make_lr_schedule
from mx_rcnn_tpu.core.train import make_optimizer as j_make_optimizer
from mx_rcnn_tpu.core.train import make_train_step as j_make_train_step
from mx_rcnn_tpu.data.loader import TrainLoader as JTrainLoader
from mx_rcnn_tpu.models import FasterRCNN as JFasterRCNN
from mx_rcnn_tpu.parallel import distributed as jdistributed
from mx_rcnn_tpu.parallel.mesh import take_replica_rows as j_take_replica_rows
from mx_rcnn_tpu_torch.core import checkpoint as tckpt
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.pipeline import batch_to_device
from mx_rcnn_tpu_torch.data.loader import TrainLoader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models import faster_rcnn as tfr
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.parallel import distributed
from mx_rcnn_tpu_torch.parallel.dist_smoke import free_port, run_case, run_two_process_smoke
from mx_rcnn_tpu_torch.parallel.mesh import (
    DataMesh,
    make_mesh,
    make_parallel_train_step,
    take_replica_rows,
)
from mx_rcnn_tpu_torch.tools import train_end2end as cli
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, torch_to_flax
from tests.test_model import tiny_batch
from tests.test_torch_elastic import run_wrapper, small_cfg, start_ranks, write_wrapper
from tests.test_torch_model import _perturb, _tame_rpn, port_cfg
from tests.test_torch_train import _leaves, train_cfg


def _draws(jmodel, params, rng, seeds, n_anchors, n_cand):
    """The uniforms JAX's train_forward draws for each image of a step-0
    batch with ``sample_seeds`` ``seeds``, stacked over the images."""
    k = jmodel.apply({"params": params}, method=lambda m: m.make_rng("sampling"),
                     rngs={"sampling": jax.random.fold_in(rng, 0)})
    per_image = []
    for s in seeds:
        k_anchor, k_roi = jax.random.split(jax.random.fold_in(k, int(s)), 2)
        u = [jax.random.uniform(kk, (n_anchors,)) for kk in jax.random.split(k_anchor)]
        u += [jax.random.uniform(kk, (n_cand,)) for kk in jax.random.split(k_roi, 3)]
        per_image.append(u)
    return {name: torch.from_numpy(np.stack([np.asarray(u[j]) for u in per_image]))
            for j, name in enumerate(tfr.DRAW_NAMES)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One step of JAX's ``make_train_step`` on a 2-image batch, the same
    step as two port ranks (one image each), and the port's ``train_step``
    on the whole batch, from the same bridged weights and draws."""
    jcfg = train_cfg()
    tcfg = port_cfg(jcfg)
    batch = tiny_batch(np.random.RandomState(0), b=2)
    batch["sample_seeds"] = jnp.asarray([0, 1], jnp.int32)
    model = FasterRCNN(tcfg, generator=torch.Generator().manual_seed(0))
    params_np = _tame_rpn(_perturb(torch_to_flax(model), np.random.RandomState(1)))
    flax_to_torch(params_np, model)
    jmodel = JFasterRCNN(jcfg)
    params = jax.tree.map(jnp.asarray, params_np)
    tx = j_make_optimizer(jcfg, j_make_lr_schedule(jcfg, 10))
    rng = jax.random.key(7)
    j_new, j_aux = j_make_train_step(jmodel, tx, donate=False)(
        j_create_train_state(params, tx), batch, rng)
    h = batch["images"].shape[1]
    n_anchors = model._anchors(-(-h // 16), -(-h // 16), "cpu").shape[0]
    draws = _draws(jmodel, params, rng, [0, 1], n_anchors,
                   jcfg.TRAIN.RPN_POST_NMS_TOP_N + batch["gt_boxes"].shape[1])
    host = {k: np.asarray(v) for k, v in batch.items()}

    ranks = run_case({"cfg": tcfg, "weights": model.state_dict(), "batches": [host],
                      "draws": [draws], "threads": 2,
                      "variants": [{"reduce": "mean", "steps": 1, "params_after": 0}]},
                     str(tmp_path_factory.mktemp("case") / "two.pt"), 2, timeout=240)

    whole = copy.deepcopy(model)
    opt = ttrain.make_optimizer(tcfg, whole, ttrain.make_lr_schedule(tcfg, 10))
    state, aux = ttrain.train_step(ttrain.create_train_state(whole, opt),
                                   batch_to_device(host, "cpu"), 0, draws=draws)
    return {"jax": (j_new, j_aux), "ranks": ranks, "port": (whole, aux), "cfg": tcfg,
            "model": model, "params": params_np}


def test_dp_step_matches_jax_on_the_global_batch(two_ranks):
    """Each trainable leaf within ``test_torch_train.py``'s updated-params
    bar (rtol 1e-5, atol 1e-7), frozen leaves untouched, the loss within
    1e-5 and the counts those of the whole batch."""
    j_new, j_aux = two_ranks["jax"]
    cfg = two_ranks["cfg"]
    rank0 = two_ranks["ranks"][0]["variants"][0]
    np.testing.assert_allclose(rank0["losses"][0], float(j_aux["loss"]), rtol=1e-5)
    # the counts are sums over a rank's images: meaned over the ranks (as
    # JAX's pmean reports them) they are half the whole batch's
    for k in ("num_fg_rois", "num_valid_props", "num_fg_anchors"):
        assert 2 * rank0["aux"][0][k] == float(j_aux[k]), k
    got = FasterRCNN(cfg)
    got.load_state_dict(two_ranks["model"].state_dict())
    with torch.no_grad():
        for n, p in got.named_parameters():
            if n in rank0["params"]:
                p.copy_(rank0["params"][n])
    got = dict(_leaves(torch_to_flax(got)))
    new = dict(_leaves(jax.tree.map(np.asarray, j_new.params)))
    old = dict(_leaves(two_ranks["params"]))
    moved = 0
    for path, ref in new.items():
        if ttrain.is_frozen_path(path, cfg.network.FIXED_PARAMS):
            np.testing.assert_array_equal(got[path], old[path], err_msg="/".join(path))
        else:
            np.testing.assert_allclose(got[path], ref, rtol=1e-5, atol=1e-7,
                                       err_msg="/".join(path))
            moved += not np.array_equal(got[path], old[path])
    assert moved > 0


def test_dp_ranks_are_bit_identical_and_match_the_ports_whole_batch_step(two_ranks):
    r0, r1 = (r["variants"][0] for r in two_ranks["ranks"])
    assert r0["checksums"] == r1["checksums"] and r0["losses"] == r1["losses"]
    assert all(torch.equal(r0["params"][n], r1["params"][n]) for n in r0["params"])
    assert two_ranks["ranks"][0]["backend"] == "gloo"
    whole, aux = two_ranks["port"]
    np.testing.assert_allclose(r0["losses"][0], float(aux["loss"]), rtol=1e-5)
    for n, p in whole.named_parameters():
        if n in r0["params"]:
            np.testing.assert_allclose(r0["params"][n].numpy(), p.detach().numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=n)
    # one all-reduce a step: the trainable gradients and the aux in one buffer
    n_grad = sum(t.numel() for t in r0["params"].values())
    assert r0["comm"]["all_reduces"] == 1
    assert r0["comm"]["bytes"] == 4 * (n_grad + len(r0["aux"][0]))


@pytest.fixture(scope="module")
def small():
    """The CLI wrapper's small C4 (64 × 96 images, 4 rois pooled 7 × 7)."""
    cfg = small_cfg()
    return cfg, FasterRCNN(cfg, generator=torch.Generator().manual_seed(2)).train()


def small_batch(seed, seeds=None):
    rng = np.random.RandomState(seed)
    batch = {"images": rng.rand(1, 64, 96, 3).astype(np.float32),
             "im_info": np.asarray([[64, 96, 1.0]], np.float32),
             "gt_boxes": np.zeros((1, 4, 5), np.float32), "gt_valid": np.zeros((1, 4), bool)}
    batch["gt_boxes"][0, :2] = [[8, 8, 40, 40, 1], [30, 20, 90, 60, 2]]
    batch["gt_valid"][0, :2] = True
    if seeds is not None:
        batch["sample_seeds"] = np.asarray(seeds, np.int32)
    return batch


def fresh_state(cfg, model):
    model = copy.deepcopy(model)
    opt = ttrain.make_optimizer(cfg, model, ttrain.make_lr_schedule(cfg, 10))
    return ttrain.create_train_state(model, opt)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_world_size_one_is_train_step_bit_for_bit(small, one_thread):
    """A gloo group of one rank in this process: two DP steps equal two
    ``train_step``s exactly (the all-reduce of one rank and the division by
    1 change no bit), loss and aux included."""
    cfg, model = small
    placed = batch_to_device(small_batch(3, seeds=[5]), "cpu")
    runs = []
    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, cpu=True)
    try:
        assert distributed.backend() == "gloo"
        mesh = make_mesh()
        assert (mesh.size, mesh.position, mesh.live_size()) == (1, 0, 1)
        for step in (make_parallel_train_step(mesh), ttrain.train_step):
            state = fresh_state(cfg, model)
            losses = [step(state, placed, 11)[1] for _ in range(2)]
            runs.append((state.state_tree(), losses))
    finally:
        distributed.shutdown()
    (a, la), (b, lb) = runs
    assert tckpt.tree_checksum(a) == tckpt.tree_checksum(b)
    for x, y in zip(la, lb):
        assert set(x) == set(y) and all(float(x[k]) == float(y[k]) for k in x)


def test_seedless_batches_fold_the_rank_into_the_seed(small):
    """Without ``sample_seeds`` rank p draws from ``fold_in(rng, p)``: the
    same image on positions 0 and 1 samples differently (and equals
    ``train_step`` at the folded seed); with them both draw alike."""
    cfg, model = small
    out = {}
    for seeded in (False, True):
        batch = batch_to_device(small_batch(4, seeds=[0] if seeded else None), "cpu")
        for pos in (0, 1):
            mesh = DataMesh(None, (0, 1), pos, torch.device("cpu"))
            _, aux = make_parallel_train_step(mesh)(fresh_state(cfg, model), batch, 21)
            out[seeded, pos] = {k: float(v) for k, v in aux.items()}
            if not seeded:
                _, raux = ttrain.train_step(fresh_state(cfg, model), batch, tfr.fold_in(21, pos))
                assert float(raux["loss"]) == out[seeded, pos]["loss"]
    assert out[False, 0] != out[False, 1]
    assert out[True, 0] == out[True, 1]


# ------------------------------------------------------ host arithmetic
@pytest.mark.parametrize("n_active, n_base, rows", [(7, 8, 8), (1, 2, 4), (2, 2, 6), (3, 4, 6)])
def test_take_replica_rows_matches_jax(n_active, n_base, rows):
    b = {"x": np.arange(rows * 2).reshape(rows, 2), "y": np.arange(rows)}
    try:
        ref = j_take_replica_rows(b, n_active, n_base)
    except ValueError as e:
        with pytest.raises(ValueError, match="not divisible"):
            take_replica_rows(b, n_active, n_base)
        assert "not divisible" in str(e)
        return
    got = take_replica_rows(b, n_active, n_base)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("world, global_batch", [(1, 8), (2, 4), (4, 8), (3, 7)])
def test_process_slice_and_batch_sizes_match_jax(monkeypatch, world, global_batch):
    """JAX with ``world`` processes of one device each against the port's
    ``world`` ranks: every rank's rows and the (local, global) sizes."""
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    monkeypatch.setattr(jax, "device_count", lambda: world)
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        try:
            ref = jdistributed.process_slice(global_batch)
        except ValueError:
            with pytest.raises(ValueError):
                distributed.process_slice(global_batch, rank=rank, world=world)
            continue
        assert distributed.process_slice(global_batch, rank=rank, world=world) == ref
    assert distributed.local_global_batch_sizes(2, world=world) == \
        jdistributed.local_global_batch_sizes(2)


def test_row_sliced_loader_yields_its_rows_of_the_global_batches():
    """``TrainLoader(row_slice=)`` gives each rank its rows of the full
    loader's batches, as the JAX loader does (same plan, same seeds)."""
    cfg = port_cfg(train_cfg())
    roidb = SyntheticDataset(num_images=8, num_classes=21, image_size=(128, 128)).gt_roidb()
    full = list(TrainLoader(roidb, cfg, 4, seed=3, prefetch=0))
    parts = [list(TrainLoader(roidb, cfg, 4, seed=3, prefetch=0,
                              row_slice=distributed.process_slice(4, rank=r, world=2)))
             for r in range(2)]
    jfull = list(JTrainLoader(roidb, train_cfg(), 4, seed=3, prefetch=0))
    assert len(full) == len(jfull) == 2
    for i, fb in enumerate(full):
        np.testing.assert_array_equal(fb["sample_seeds"], jfull[i]["sample_seeds"])
        for r in range(2):
            for k in fb:
                np.testing.assert_array_equal(parts[r][i][k], fb[k][2 * r:2 * r + 2])


# --------------------------------------------------------------- the CLI
def run_dist(wrapper, args_of, n, report_dir):
    """Start ``n`` ranks of the wrapper by hand (``--dist_*``); → reports."""
    codes, outs, _ = start_ranks(wrapper, args_of, n, {"MX_RCNN_RANK_REPORT": report_dir})
    for code, out in zip(codes, outs):
        assert code == 0, out[-3000:]
    reports = []
    for i in range(n):
        with open(os.path.join(report_dir, f"rank{i}.json")) as f:
            reports.append(json.load(f))
    return reports


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``--cpu 2`` (the launcher) for one epoch under ``--prefix A``, then
    its resume for a second epoch as two ``--dist_*`` processes whose
    prefixes are A (rank 0) and B1 (rank 1, empty): 4 synthetic images, a
    global batch of 2, at the wrapper's small config on one thread a
    rank."""
    tmp = tmp_path_factory.mktemp("cli")
    wrapper = write_wrapper(tmp)
    common = ["--synthetic", "4", "--no_flip", "--frequent", "1"]
    r, launched = run_wrapper(wrapper, ["--cpu", "2", *common, "--epochs", "1",
                                        "--prefix", str(tmp / "A")])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    resumed = run_dist(wrapper, lambda i: [
        "--cpu", "1", *common, "--epochs", "2", "--resume",
        "--prefix", str(tmp / ("A" if i == 0 else f"B{i}")),
        "--metrics_jsonl", str(tmp / f"B{i}.jsonl")], 2, tempfile.mkdtemp(dir=tmp))
    return {"tmp": tmp, "launched": launched, "resumed": resumed}


def test_cli_cpu_2_trains_two_ranks(cli_runs):
    rep = cli_runs["launched"]
    assert rep["steps"] == 2 and rep["rank"] == 0 and len(rep["ranks"]) == 2
    assert rep["ranks"][0]["state_checksum"] == rep["ranks"][1]["state_checksum"]
    assert [h["loss"] for h in rep["ranks"][0]["history"]] == \
        [h["loss"] for h in rep["ranks"][1]["history"]]
    assert (cli_runs["tmp"] / "A" / "run_meta.json").exists()
    assert [s["epoch"] for s in rep["saves"]] == [1] and not rep["ranks"][1]["saves"]


def test_cli_dist_ranks_write_only_on_rank_0(cli_runs):
    """Rank 1's ``--prefix`` and ``--metrics_jsonl`` are never written."""
    tmp = cli_runs["tmp"]
    r0, r1 = cli_runs["resumed"]
    assert r0["saves"] and not r1["saves"]
    assert tckpt.restorable_checkpoints(str(tmp / "A")) == [(2, 0), (1, 0)]
    assert (tmp / "B0.jsonl").exists()
    assert not (tmp / "B1").exists() and not (tmp / "B1.jsonl").exists()


def test_cli_dist_resume_takes_rank_0s_dump_on_both_ranks(cli_runs):
    """Rank 1's prefix holds no dump; both resume at rank 0's (1, 0) and
    end equal."""
    r0, r1 = cli_runs["resumed"]
    assert tuple(r0["begin"]) == tuple(r1["begin"]) == (1, 0)
    assert r0["steps"] == r1["steps"] == 2
    assert r0["state_checksum"] == r1["state_checksum"]
    assert [h["loss"] for h in r0["history"]] == [h["loss"] for h in r1["history"]]


def test_cli_ranks_run_the_module_not_the_calling_script(monkeypatch):
    """``main`` called from a script that does not ask for itself
    (``rank_command``) starts its ranks as ``python -m
    mx_rcnn_tpu_torch.tools.train_end2end``, never as that script, at a
    rendezvous the launcher hosts.  The ranks are stand-ins that exit with
    code 3: the launch fails naming rank 0."""
    script = types.ModuleType("__main__")
    script.__file__, script.__spec__ = "/elsewhere/drive_training.py", None
    monkeypatch.setitem(sys.modules, "__main__", script)
    started = []

    class Exited:
        returncode = 3

        def __init__(self, cmd, env=None, **_):
            started.append((cmd, env))

        def poll(self):
            return self.returncode

    monkeypatch.setattr(cli.subprocess, "Popen", Exited)
    with pytest.raises(RuntimeError, match="rank 0 exited with code 3"):
        cli.main(["--cpu", "2", "--synthetic", "2"])
    assert len(started) == 2
    for i, (cmd, env) in enumerate(started):
        assert cmd[:3] == [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.train_end2end"]
        assert cmd[3:-6] == ["--cpu", "2", "--synthetic", "2"]
        assert cmd[-6] == "--dist_coordinator" and cmd[-5].startswith("127.0.0.1:")
        assert cmd[-4:] == ["--dist_nprocs", "2", "--dist_procid", str(i)]
        assert env[distributed.HOSTED_STORE_ENV] and env["LOCAL_WORLD_SIZE"] == "2"


def test_two_process_smoke():
    codes, outs = run_two_process_smoke(timeout=240)
    assert codes == [0, 0]
    assert sum("loss=" in out for out in outs) == 2
