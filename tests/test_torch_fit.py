"""The port's pipelined ``fit`` and the trainer CLI on the CPU, at
``tiny_cfg`` size: the pooled, prefetched, K-late loop trains bit for bit
as the serial K = 1 loop, through the same batches; a poison batch is
skipped and the run ends where the guarded K = 1 run ends; the CLI's
pipeline flags train a step.

The CPU convolutions' backward splits its sums over threads, and a split
can change from run to run, so these runs hold torch to one thread."""

import copy
import dataclasses
import math

import pytest
import torch

from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.utils import faults
from tests.test_torch_model import port_cfg
from tests.test_torch_train import train_cfg

SERIAL = {"aux_interval": 1, "feed_depth": 1, "prefetch": 0, "assembly_workers": 0}
PIPELINED = {"aux_interval": 3, "feed_depth": 2, "prefetch": 2, "assembly_workers": 2}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.reset()
    yield
    torch.set_num_threads(threads)
    faults.reset()


def small_cfg():
    cfg = port_cfg(train_cfg())
    return cfg.replace(dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
                       SHAPE_BUCKETS=((96, 128), (128, 96)),
                       TRAIN=dataclasses.replace(cfg.TRAIN, BATCH_ROIS=8, RPN_PRE_NMS_TOP_N=100,
                                                 RPN_POST_NMS_TOP_N=16))


@pytest.fixture(scope="module")
def pristine():
    return FasterRCNN(small_cfg(), generator=torch.Generator().manual_seed(5))


def run_fit(pristine, tmp_path, name, **kw):
    cfg = small_cfg()
    model = copy.deepcopy(pristine)
    roidb = SyntheticDataset(num_images=4, image_size=(160, 200)).gt_roidb()
    log = tmp_path / f"{name}.log"
    out = fit(model, cfg, roidb, epochs=2, max_steps=5, device="cpu", stream_log=str(log), **kw)
    out["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    out["digests"] = log.read_text().splitlines()
    return out


def assert_same_training(a, b):
    assert a["digests"] == b["digests"]
    assert [h["index"] for h in a["history"]] == [h["index"] for h in b["history"]]
    assert [h["loss"] for h in a["history"]] == [h["loss"] for h in b["history"]]
    for n, p in a["params"].items():
        assert torch.equal(p, b["params"][n]), n


def test_pipelined_fit_trains_bitwise_as_the_serial_loop(pristine, tmp_path):
    serial = run_fit(pristine, tmp_path, "serial", **SERIAL)
    piped = run_fit(pristine, tmp_path, "piped", **PIPELINED)
    assert_same_training(serial, piped)
    assert serial["steps"] == piped["steps"] == 5 and len(piped["digests"]) == 5
    assert all(math.isfinite(h["loss"]) for h in piped["history"])
    assert "step_ms" in serial["history"][0] and "step_ms" not in piped["history"][0]
    # K = 3 over a 4-step epoch then 1 step: flushes at 3, epoch end, run end
    assert piped["pipeline"]["fetches"] == 3 and piped["pipeline"]["fetched_trees"] == 5
    assert serial["pipeline"]["fetches"] == 0
    assert [s["fed"] for s in piped["feed"]] == [4, 1]
    assert piped["loader"]["assembly"]["workers"] == 2
    assert piped["loader"]["assembly"]["yielded"] >= 5 and "assembly" not in serial["loader"]
    assert piped["dispatched_steps"] == serial["dispatched_steps"] == 5
    clock = serial["clock"]
    assert len(clock["step_start"]) == 5 and clock["end"] >= clock["step_start"][-1]
    assert all(h["wait_ms"] >= 0 and h["step_ms"] > 0 for h in serial["history"])
    assert serial["loader"] == {"record_failures": 0, "substituted_records": 0,
                                "dropped_batches": 0}


def test_poison_batch_is_skipped_as_in_the_guarded_loop(pristine, tmp_path, monkeypatch):
    monkeypatch.setenv("MX_RCNN_FAULTS", "nan_loss@1")
    faults.reset()
    guarded = run_fit(pristine, tmp_path, "guarded", **SERIAL)
    faults.reset()
    piped = run_fit(pristine, tmp_path, "piped", **PIPELINED)
    assert_same_training(guarded, piped)
    assert [h["index"] for h in piped["history"]] == [0, 2, 3, 4]
    for out in (guarded, piped):
        assert out["pipeline"]["skipped_batches"] == 1 and out["pipeline"]["retried_steps"] == 3
    assert piped["pipeline"]["window_rollbacks"] == 1
    # K = 1: 4 good steps + 3 poisoned attempts; K = 3: 5 dispatches, the
    # replay of step 0, 3 guarded attempts at step 1, the redo of step 2
    assert (guarded["dispatched_steps"], piped["dispatched_steps"]) == (7, 10)


def test_cli_pipeline_flags_train_one_cpu_step(monkeypatch, tmp_path):
    from mx_rcnn_tpu_torch.tools import train_end2end as cli

    monkeypatch.setattr(cli, "generate_config", lambda network, dataset: small_cfg())
    out = cli.main(["--cpu", "1", "--synthetic", "2", "--max_steps", "1", "--aux_interval", "2",
                    "--feed_depth", "2", "--spike_factor", "10", "--max_bad_batches", "2",
                    "--snapshot_every", "1", "--step_timeout", "600",
                    "--loader_failure_budget", "4", "--prefix", str(tmp_path / "e2e")])
    assert out["steps"] == 1 and len(out["history"]) == 1
    assert out["pipeline"]["aux_interval"] == 2 and out["pipeline"]["fetches"] == 1
    assert out["feed"][0]["depth"] == 2
    assert all(math.isfinite(v) for v in out["history"][0].values())
    assert cli.parse_args([]).aux_interval == 0  # auto: 1 on the CPU, 8 on the card

