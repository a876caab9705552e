"""Rank processes for the data-parallel checks, and the two-process smoke
(port of ``mx_rcnn_tpu/parallel/dist_smoke.py``).

:func:`run_two_process_smoke`: two port workers join a gloo group at a
rendezvous their parent hosts on ``127.0.0.1``, each runs one DP train
step of a small ResNet-50 C4 on its rows of a 2-image global batch (the DP
step of ``parallel/mesh.py``), and both must report the same loss.  One shared
deadline; a wedged worker is killed.  Each builds its model from its own
seed, so the equal losses and states also show ``replicate`` at work.

:func:`run_case` runs a *case* in ``world`` rank processes of this module
(``python -m mx_rcnn_tpu_torch.parallel.dist_smoke case FILE``): a
``torch.save`` dict with the config (``cfg``), the start weights
(``weights``, a ``state_dict``, which
:func:`~mx_rcnn_tpu_torch.parallel.mesh.replicate` broadcasts from rank 0
too), the host global ``batches`` (and ``draws``, their
samplers' uniforms), ``rng``, ``device`` ("cpu" or "cuda"),
``deterministic`` (cuDNN's), ``threads`` and ``variants``: each a dict
``{"reduce": "mean" | "sum", "steps": n, "params_after": k | None}`` run
from the start weights.  "sum" is a sum-reduced (× world) step, a fault the
checks must see.  Each rank writes ``FILE.rank<i>``: per variant the losses,
the aux, the state's checksum after every step, the trainable tensors and
momentum buffers after step ``params_after``, the kernel launches, the
all-reduce bytes; and the
backend, the peak device memory and one all-reduce's time at the
gradients' size.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

MODULE = "mx_rcnn_tpu_torch.parallel.dist_smoke"


def free_port() -> int:
    """A free localhost port (a fixed one collides with stale listeners or
    parallel jobs on the same host)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(args: Sequence[str], world: int, timeout: float,
              env: Optional[Dict[str, str]] = None) -> List[str]:
    """Start ``world`` rank processes of this module with ``args`` and
    ``--rank i --world n --port P`` (P: a rendezvous this process hosts,
    ``distributed.host_rendezvous``), under ONE shared deadline (a
    per-process wait would let the worst case take ``world`` × the budget);
    → their outputs.  Raises on a non-zero exit;
    ``subprocess.TimeoutExpired`` past the deadline.  A worker still running
    at the end (wedged on a peer that died) is killed."""
    from mx_rcnn_tpu_torch.parallel import distributed

    store, coordinator = distributed.host_rendezvous(world)
    port = coordinator.rsplit(":", 1)[1]
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    run_env = dict(os.environ if env is None else env)
    run_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo_root, run_env.get("PYTHONPATH")) if p)
    run_env["LOCAL_WORLD_SIZE"] = str(world)
    run_env[distributed.HOSTED_STORE_ENV] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", MODULE, *args, "--rank", str(i), "--world", str(world),
             "--port", port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=run_env, cwd=repo_root,
        )
        for i in range(world)
    ]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {i} of {world} exited with code {p.returncode}:\n{out}")
    return outs


def run_two_process_smoke(timeout: float = 300) -> Tuple[List[int], List[str]]:
    """Two workers, one DP step each → (return codes, outputs).  Raises on
    a failed worker or when their losses or states differ."""
    outs = run_ranks(["smoke"], 2, timeout)
    losses = sorted(line.split("loss=")[1] for out in outs for line in out.splitlines()
                    if "loss=" in line)
    if len(losses) != 2 or losses[0] != losses[1]:
        raise RuntimeError(f"dist smoke loss or state mismatch: {losses}")
    return [0, 0], outs


def run_case(case: Dict, path: str, world: int, timeout: float,
             env: Optional[Dict[str, str]] = None) -> List[Dict]:
    """Write ``case`` to ``path``, run it in ``world`` rank processes and
    return each rank's results (see the module docstring)."""
    import torch

    torch.save(case, path)
    run_ranks(["case", path], world, timeout, env)
    return [torch.load(f"{path}.rank{i}", weights_only=False) for i in range(world)]


# ------------------------------------------------------------------ workers
def _kernel_counts() -> Dict[str, int]:
    from mx_rcnn_tpu_torch.ops import nms, roi_align, roi_align_stream

    kernels = {"nms": nms.kernel, "roi_align_fwd": roi_align.kernel,
               "roi_align_bwd": roi_align.bwd_kernel,
               "roi_align_stream_fwd": roi_align_stream.fwd_kernel,
               "roi_align_stream_bwd": roi_align_stream.bwd_kernel}
    return {name: k.launches for name, k in kernels.items()}


def small_c4_cfg():
    """ResNet-50 C4 at a 64 × 64 image's size: 128 → 16 proposals, 8 rois."""
    import dataclasses

    from mx_rcnn_tpu_torch.config import generate_config

    cfg = generate_config("resnet50", "PascalVOC")
    return cfg.replace(TRAIN=dataclasses.replace(
        cfg.TRAIN, RPN_PRE_NMS_TOP_N=128, RPN_POST_NMS_TOP_N=16, BATCH_ROIS=8,
        RPN_BATCH_SIZE=16))


def _smoke(rank: int, world: int, port: int) -> None:
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch.core.train import create_train_state, make_optimizer
    from mx_rcnn_tpu_torch.models import build_model
    from mx_rcnn_tpu_torch.parallel import distributed
    from mx_rcnn_tpu_torch.parallel.mesh import make_mesh, make_parallel_train_step, replicate
    from mx_rcnn_tpu_torch.parallel.mesh import shard_batch
    from mx_rcnn_tpu_torch.utils.precision import full_float32

    torch.set_num_threads(2)
    full_float32()  # a rank is an entry point: TF32 off
    distributed.initialize(f"127.0.0.1:{port}", world, rank, cpu=True)
    try:
        assert distributed.backend() == "gloo" and distributed.process_count() == world
        cfg = small_c4_cfg()
        g = world  # one image a rank
        rng = np.random.RandomState(0)
        batch = {
            "images": rng.rand(g, 64, 64, 3).astype(np.float32),
            "im_info": np.tile([64, 64, 1.0], (g, 1)).astype(np.float32),
            "gt_boxes": np.zeros((g, 4, 5), np.float32),
            "gt_valid": np.zeros((g, 4), bool),
            "sample_seeds": np.arange(g, dtype=np.int32),
        }
        batch["gt_boxes"][:, 0] = [8, 8, 40, 40, 1]
        batch["gt_valid"][:, 0] = True
        # a seed a rank: replicate makes the states equal
        model = build_model(cfg, generator=torch.Generator().manual_seed(rank)).train()
        mesh = make_mesh()
        state = replicate(create_train_state(model, make_optimizer(cfg, model, lambda s: 0.001)),
                          mesh)
        step = make_parallel_train_step(mesh)
        state, aux = step(state, shard_batch(batch, mesh), 7)
        loss = float(aux["loss"])
        assert np.isfinite(loss) and state.step == 1, (loss, state.step)
        # the states too: replicate made the seeds' weights one
        print(f"rank {rank}: loss={loss!r} state={_state_checksum(state)}", flush=True)
    finally:
        distributed.shutdown()


def _state_checksum(state) -> str:
    from mx_rcnn_tpu_torch.core.checkpoint import tree_checksum

    tree = state.state_tree()
    names = set(state.names)
    return tree_checksum({"trainable": {k: v for k, v in tree["model"].items() if k in names},
                          "momentum": tree["momentum"], "count": tree["count"]})


def _case(path: str, rank: int, world: int, port: int) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from mx_rcnn_tpu_torch.core.train import create_train_state, make_optimizer, train_step
    from mx_rcnn_tpu_torch.models import build_model
    from mx_rcnn_tpu_torch.parallel import distributed
    from mx_rcnn_tpu_torch.parallel.mesh import (
        all_reduce_sum_,
        make_mesh,
        make_parallel_train_step,
        replicate,
        shard_batch,
    )
    from mx_rcnn_tpu_torch.utils.precision import full_float32

    case = torch.load(path, weights_only=False)
    full_float32()  # a rank is an entry point: TF32 off
    if case.get("threads"):
        torch.set_num_threads(case["threads"])
    cpu = case.get("device", "cpu") == "cpu"
    if case.get("deterministic"):
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    distributed.initialize(f"127.0.0.1:{port}", world, rank, cpu=cpu)
    try:
        cfg = case["cfg"]
        mesh = make_mesh()
        dev = mesh.device
        out = {"backend": distributed.backend(), "world": world, "variants": []}

        model = build_model(cfg)
        model.load_state_dict(case["weights"])
        model.to(dev, memory_format=torch.channels_last).train()
        start = {}

        def fresh_state():
            # every variant from the start weights, with no momentum yet
            opt = make_optimizer(cfg, model, lambda s: cfg.TRAIN.LEARNING_RATE)
            state = create_train_state(model, opt)
            if start:
                model.load_state_dict(start)
                return state
            state = replicate(state, mesh)
            start.update((k, v.clone()) for k, v in model.state_dict().items())
            return state

        def sum_step(state, batch, rng, draws=None):
            # the sum-reduced fault: the gradients summed, never divided
            def reduce(params, aux):
                all_reduce_sum_([p.grad for p in params if p.grad is not None], mesh.group)
                return aux
            return train_step(state, batch, rng, draws=draws, reduce=reduce)

        draws = case.get("draws")
        for var in case.get("variants", [{"reduce": "mean"}]):
            state = fresh_state()
            step = make_parallel_train_step(mesh) if var["reduce"] == "mean" else sum_step
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            before = _kernel_counts()
            res = {"losses": [], "aux": [], "checksums": [], "params": None, "momenta": None}
            for k in range(var.get("steps", len(case["batches"]))):
                batch = shard_batch(case["batches"][k], mesh)
                kw = {}
                if draws is not None:
                    rows = distributed.process_slice(len(case["batches"][k]["images"]),
                                                     rank=mesh.position, world=mesh.size)
                    kw["draws"] = {n: t[rows].to(dev) for n, t in draws[k].items()}
                state, aux = step(state, batch, case.get("rng", 0), **kw)
                res["losses"].append(float(aux["loss"]))
                res["aux"].append({n: float(v) for n, v in aux.items()})
                res["checksums"].append(_state_checksum(state))
                if var.get("params_after") == k:
                    opt = state.optimizer
                    res["params"] = {n: p.detach().cpu().clone()
                                     for n, p in zip(state.names, opt.params)}
                    res["momenta"] = {n: opt.sgd.state[p]["momentum_buffer"].cpu().clone()
                                      for n, p in zip(state.names, opt.params)
                                      if opt.sgd.state[p].get("momentum_buffer") is not None}
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                res["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
            after = _kernel_counts()
            res["launches"] = {n: after[n] - before[n] for n in after}
            res["comm"] = dict(getattr(step, "comm", {}))
            out["variants"].append(res)
        # one all-reduce at the trainable gradients' size, timed
        n = sum(p.numel() for p in state.optimizer.params)
        flat = torch.zeros(n, dtype=torch.float32, device=dev)
        times = []
        for _ in range(case.get("time_all_reduce", 0)):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            dist.all_reduce(flat, group=mesh.group)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        out["all_reduce_ms"] = float(np.median(times)) if times else None
        out["all_reduce_bytes"] = n * 4
        torch.save(out, f"{path}.rank{rank}")
    finally:
        distributed.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="a rank process of the data-parallel checks")
    ap.add_argument("mode", choices=["smoke", "case"])
    ap.add_argument("path", nargs="?")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    a = ap.parse_args(argv)
    if a.mode == "smoke":
        _smoke(a.rank, a.world, a.port)
    else:
        _case(a.path, a.rank, a.world, a.port)


if __name__ == "__main__":
    main()
