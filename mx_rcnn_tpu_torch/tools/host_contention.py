"""How much host batch assembly running beside the train step slows the
step on the card, and why: the interpreter lock, the host's cores, or
torch's CPU thread pool.

    python -m mx_rcnn_tpu_torch.tools.host_contention [--network resnet_fpn]

For each network (full width, seeded random weights, learning rate 0 so
every step does the same work) it places 8 synthetic 480 × 640 batches on
the card, then times train steps (host clock from the call to the aux
fetched on the host, as the guarded loop's step ends) while the host runs,
beside the step, nothing; the assembly of synthetic batches (render,
resize, pad: the loader's work) in 1 or 4 threads; the same in 1 or 4
processes (no interpreter lock shared with the step); 1 thread with torch
held to one CPU thread; 1 thread with a 0.5 ms interpreter switch interval.
Conditions run in turns, "alone" first and last.  Card only.  The last
line is one JSON object of every number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import threading
import time

import torch

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.pipeline import batch_to_device
from mx_rcnn_tpu_torch.core.resilience import fetch_host
from mx_rcnn_tpu_torch.core.train import (
    create_train_state,
    make_lr_schedule,
    make_optimizer,
    train_step,
)
from mx_rcnn_tpu_torch.data.loader import _orientation_bucket, make_batch
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset, synthetic_image
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.utils.precision import full_float32

STEPS, WARMUP = 12, 2


def _records():
    return SyntheticDataset(num_images=8, image_size=(480, 640)).gt_roidb()


def assemble_forever(network: str, stop, count, ready) -> None:
    """Assemble batches (a fresh render each, as an uncached epoch does)
    until ``stop`` is set, adding one to ``count`` per batch."""
    cfg = generate_config(network, "PascalVOC")
    roidb = _records()
    ready.set()
    i = 0
    while not stop.is_set():
        rec = roidb[i % len(roidb)]
        im = synthetic_image(rec, rec["synthetic_seed"])
        make_batch([rec], cfg, _orientation_bucket(rec, cfg.SHAPE_BUCKETS), seeds=[i], images=[im])
        with count.get_lock():
            count.value += 1
        i += 1


def time_steps(state, batches):
    out = []
    for i in range(STEPS):
        t0 = time.perf_counter()
        _, aux = train_step(state, batches[i % len(batches)], 7)
        fetch_host([aux])
        out.append((time.perf_counter() - t0) * 1e3)
    return out[WARMUP:]


def run_condition(name, network, state, batches, kind, n, torch_threads=None, switch=None):
    ctx = multiprocessing.get_context("spawn")
    stop, count = ctx.Event(), ctx.Value("l", 0)
    workers, readies = [], []
    for _ in range(n):
        ready = ctx.Event()
        if kind == "process":
            w = ctx.Process(target=assemble_forever, args=(network, stop, count, ready), daemon=True)
        else:
            w = threading.Thread(target=assemble_forever, args=(network, stop, count, ready),
                                 daemon=True)
        w.start()
        workers.append(w)
        readies.append(ready)
    for r in readies:
        if not r.wait(120):
            raise RuntimeError(f"{name}: an assembly worker did not start")
    old_threads, old_switch = torch.get_num_threads(), sys.getswitchinterval()
    try:
        if torch_threads is not None:
            torch.set_num_threads(torch_threads)
        if switch is not None:
            sys.setswitchinterval(switch)
        c0, t0 = count.value, time.perf_counter()
        steps = time_steps(state, batches)
        rate = (count.value - c0) / (time.perf_counter() - t0)
    finally:
        torch.set_num_threads(old_threads)
        sys.setswitchinterval(old_switch)
        stop.set()
        for w in workers:
            w.join(30)
    res = {"step_ms_median": statistics.median(steps), "step_ms_mean": statistics.fmean(steps),
           "step_ms": steps, "assembled_per_s": rate}
    print(f"  {name}: step median {res['step_ms_median']:.3f} ms, mean {res['step_ms_mean']:.3f} "
          f"ms; {rate:.2f} batches assembled a second beside it", flush=True)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", action="append", choices=["resnet", "resnet_fpn"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("host_contention: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"{smi} | nproc {os.cpu_count()} | torch CPU threads {torch.get_num_threads()} | "
          f"switch interval {sys.getswitchinterval() * 1e3:.1f} ms", flush=True)
    full_float32()
    dev = torch.device("cuda")
    out = {"card": smi, "nproc": os.cpu_count(), "torch_threads": torch.get_num_threads()}
    for network in args.network or ["resnet", "resnet_fpn"]:
        cfg = generate_config(network, "PascalVOC")
        cfg = cfg.replace(TRAIN=dataclasses.replace(cfg.TRAIN, LEARNING_RATE=0.0))
        model = build_model(cfg, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            for layer in (model.rpn.rpn_cls_score, model.rpn.rpn_bbox_pred):
                layer.weight.mul_(1e-3)
        model.to(dev, memory_format=torch.channels_last).train()
        state = create_train_state(model, make_optimizer(cfg, model, make_lr_schedule(cfg, 8)))
        roidb = _records()
        t0 = time.perf_counter()
        host = [make_batch([r], cfg, _orientation_bucket(r, cfg.SHAPE_BUCKETS), seeds=[i])
                for i, r in enumerate(roidb)]
        alone_ms = (time.perf_counter() - t0) * 1e3 / len(roidb)
        batches = [batch_to_device(b, dev) for b in host]
        print(f"[{network}] assembly alone: {alone_ms:.3f} ms a batch", flush=True)
        res = {"assembly_alone_ms": alone_ms}
        for name, kind, n, kw in (
            ("alone", "thread", 0, {}),
            ("1 assembly thread", "thread", 1, {}),
            ("4 assembly threads", "thread", 4, {}),
            ("1 assembly process", "process", 1, {}),
            ("4 assembly processes", "process", 4, {}),
            ("1 assembly thread, torch 1 CPU thread", "thread", 1, {"torch_threads": 1}),
            ("1 assembly thread, switch interval 0.5 ms", "thread", 1, {"switch": 5e-4}),
            ("alone again", "thread", 0, {}),
        ):
            res[name] = run_condition(name, network, state, batches, kind, n, **kw)
        out[network] = res
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
