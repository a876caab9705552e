"""Decompose the flagship train step's cost component by component (port of
``mx_rcnn_tpu/tools/profile_step.py``).

Times each stage of the Faster R-CNN step (backbone, RPN, proposal / NMS,
targets, ROI feature extraction, top head, the full train step) on its own,
on the flagship configuration: ResNet-101 C4, ``generate_config("resnet",
"PascalVOC")``, its first shape bucket, random images and two gt boxes an
image.

Usage: python -m mx_rcnn_tpu_torch.tools.profile_step [--dtype bfloat16]
       python -m mx_rcnn_tpu_torch.tools.profile_step --ablate [--batch 8]
       (add --cpu to run on the CPU)

Each row's wall time is taken as the JAX tool takes it: ``warmup`` calls,
then ``iters`` calls between two synchronisations of the card, over
``iters``.  In eager PyTorch the host launches every op, so a wall time is
not the device's time: on the card every row also gets the device time of
its kernels, summed from a ``torch.profiler`` pass over the same call.
The gap between the two columns is the host's share of that component.
``--ablate`` times each component as a self-chained update (its output
feeds the next call's input) at ``--batch`` images, plus the optimizer
update alone and the full train step, both at the bench configuration
(bf16 + FOLD_BN).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.pipeline import batch_to_device
from mx_rcnn_tpu_torch.core.tester import resolve_device
from mx_rcnn_tpu_torch.core.train import create_train_state, make_optimizer, train_step
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.models.faster_rcnn import init_weights
from mx_rcnn_tpu_torch.models.resnet import ResNetBackbone, ResNetTopHead
from mx_rcnn_tpu_torch.models.rpn import RPNHead
from mx_rcnn_tpu_torch.ops.anchors import shifted_anchors
from mx_rcnn_tpu_torch.ops.proposal import propose
from mx_rcnn_tpu_torch.ops.roi_align import extract_roi_features_batched
from mx_rcnn_tpu_torch.ops.targets import assign_anchor, sample_rois
from mx_rcnn_tpu_torch.utils.precision import full_float32


def flagship_cfg():
    return generate_config("resnet", "PascalVOC")  # ResNet-101 Faster R-CNN


def flagship_batch(cfg, b: int, h: int, w: int, g: int = 8,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """``b`` random (h, w) images, each with two gt boxes of classes 1 and 2
    (``__graft_entry__.py::_batch``'s batch), as numpy arrays."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((b, g, 5), np.float32)
    gt_valid = np.zeros((b, g), bool)
    for i in range(b):
        # [x1, y1, x2, y2, cls]: x bounded by width, y by height
        gt[i, 0] = [10, 10, w * 0.5, h * 0.5, 1]
        gt[i, 1] = [w * 0.3, h * 0.3, w * 0.8 - 1, h * 0.8 - 1, 2]
        gt_valid[i, :2] = True
    return {
        "images": rng.rand(b, h, w, 3).astype(np.float32),
        "im_info": np.tile([h, w, 1.0], (b, 1)).astype(np.float32),
        "gt_boxes": gt,
        "gt_valid": gt_valid,
    }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn: Callable, dev: torch.device, iters: int = 10, warmup: int = 2) -> float:
    """Seconds a call: ``warmup`` calls, a sync, then ``iters`` calls and a
    sync (the JAX tool's ``block_until_ready``)."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / iters


def timeit_chained(step: Callable, state, dev: torch.device, iters: int = 20) -> float:
    """Seconds a call of a self-chained ``state = step(state)``: one warm-up
    call, a sync, ``iters`` calls and a sync."""
    state = step(state)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state)
    _sync(dev)
    return (time.perf_counter() - t0) / iters


# a profiler pass over a few calls of well under a millisecond can come
# back without device events (seen after many passes in one process): a
# pass covers at least PROFILE_WINDOW_MS of calls, and a pass that sees no
# device time is retried
PROFILE_REPS = 5
PROFILE_WINDOW_MS = 20.0
PROFILE_MAX_REPS = 500
PROFILE_ATTEMPTS = 3


def device_ms(fn: Callable, dev: torch.device, wall_ms: float = 0.0) -> Optional[float]:
    """Device time (ms) of the kernels one call of ``fn`` runs, summed from a
    ``torch.profiler`` pass over enough calls to cover
    :data:`PROFILE_WINDOW_MS` at ``wall_ms`` a call (at least
    :data:`PROFILE_REPS`; up to :data:`PROFILE_ATTEMPTS` passes until one
    sees device time); None off the card, or when no pass saw device time."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    window = math.ceil(PROFILE_WINDOW_MS / max(wall_ms, 1e-3))
    reps = max(PROFILE_REPS, min(PROFILE_MAX_REPS, window))

    for _ in range(PROFILE_ATTEMPTS):
        _sync(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            _sync(dev)
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type.name == "CUDA")
        if us > 0:
            return us / 1e3 / reps
    return None


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _seeded(make: Callable[[], torch.nn.Module], dev: torch.device,
            seed: int = 0) -> torch.nn.Module:
    """``make()`` built on ``dev`` with seeded random weights drawn there (on
    the card in a fraction of the CPU's time)."""
    with torch.device(dev):
        module = make()
    init_weights(module, torch.Generator(device=dev).manual_seed(seed))
    return module.to(dev, memory_format=torch.channels_last)


def _seeded_model(cfg, dev: torch.device) -> torch.nn.Module:
    with torch.device(dev):
        model = build_model(cfg, generator=torch.Generator(device=dev).manual_seed(0))
    return model.to(dev, memory_format=torch.channels_last).train()


def _row(report: Dict, name: str, fn: Callable, dev: torch.device, iters: int,
         warmup: int = 2) -> None:
    wall = timeit(fn, dev, iters, warmup) * 1e3
    report[name] = {"wall_ms": wall, "device_ms": device_ms(fn, dev, wall)}


def _chained_row(report: Dict, name: str, step: Callable, state, dev: torch.device,
                 iters: int) -> None:
    wall = timeit_chained(step, state, dev, iters) * 1e3
    report[name] = {"wall_ms": wall, "device_ms": device_ms(lambda: step(state), dev, wall)}


def profile(cfg=None, device=None, iters: int = 10, dtype: str = "bfloat16",
            warmup: int = 2) -> Dict[str, Dict[str, Optional[float]]]:
    """The component rows of the JAX tool's ``main`` on ``cfg`` (default the
    flagship) at ``cfg.TRAIN.BATCH_IMAGES`` images of its first bucket, on
    ``device`` (default the card): → ``{row: {"wall_ms", "device_ms"}}``
    (``device_ms`` None off the card) and ``"imgs/sec (full step)"``."""
    cfg = flagship_cfg() if cfg is None else cfg
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, COMPUTE_DTYPE=dtype))
    dev = resolve_device(device)
    full_float32()
    net, t = cfg.network, cfg.TRAIN
    dt = _dtype(dtype)
    h, w = cfg.SHAPE_BUCKETS[0]
    b = t.BATCH_IMAGES
    batch = batch_to_device(flagship_batch(cfg, b, h, w), dev)
    images = batch["images"].permute(0, 3, 1, 2)
    fh, fw = h // 16, w // 16
    report: Dict = {}

    # --- backbone fwd + fwd/bwd
    bb = _seeded(lambda: ResNetBackbone(depth=net.depth, dtype=dt), dev)
    bb_params = [p for p in bb.parameters()]

    def bb_fwd():
        with torch.no_grad():
            return bb(images)

    def bb_fwdbwd():
        return torch.autograd.grad(bb(images).float().sum(), bb_params)

    _row(report, "backbone_fwd", bb_fwd, dev, iters, warmup)
    _row(report, "backbone_fwdbwd", bb_fwdbwd, dev, iters, warmup)
    feat = bb_fwd()

    # --- rpn head
    rpn = _seeded(lambda: RPNHead(num_anchors=net.NUM_ANCHORS, channels=512, dtype=dt), dev)

    def rpn_fwd():
        with torch.no_grad():
            return rpn(feat)

    _row(report, "rpn_fwd", rpn_fwd, dev, iters, warmup)

    # --- proposal (train-size NMS: 12000 -> 2000), one image
    anchors = torch.as_tensor(shifted_anchors(fh, fw, 16, ratios=net.ANCHOR_RATIOS,
                                              scales=net.ANCHOR_SCALES), device=dev)
    n = anchors.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    scores = torch.rand((1, n), generator=gen, device=dev)
    deltas = torch.randn((1, n, 4), generator=gen, device=dev) * 0.1
    info = batch["im_info"][:1]

    def prop():
        return propose(scores, deltas, anchors, info, t.RPN_PRE_NMS_TOP_N,
                       t.RPN_POST_NMS_TOP_N, t.RPN_NMS_THRESH, t.RPN_MIN_SIZE)

    _row(report, "propose_train_nms", prop, dev, iters, warmup)

    # --- assign_anchor + sample_rois, one image
    gtb, gtv = batch["gt_boxes"][:1], batch["gt_valid"][:1]
    _row(report, "assign_anchor",
         lambda: assign_anchor(anchors, gtb, gtv, info, cfg, generator=gen), dev, iters, warmup)
    props = prop()
    _row(report, "sample_rois",
         lambda: sample_rois(props.rois, props.valid, gtb, gtv, cfg, generator=gen),
         dev, iters, warmup)

    # --- roi feature extraction (BATCH_ROIS rois an image) + top head
    xy = torch.rand((b, t.BATCH_ROIS, 2), generator=gen, device=dev) * 500
    rois = torch.cat([xy, xy + 100], dim=-1)
    feat_nhwc = feat.permute(0, 2, 3, 1)

    def pool(f, r):
        return extract_roi_features_batched(f, r, net.ROI_MODE, net.POOLED_SIZE,
                                            1.0 / net.RCNN_FEAT_STRIDE, net.ROI_SAMPLE_RATIO)

    def roi_fwd():
        with torch.no_grad():
            return pool(feat_nhwc, rois)

    leaf = feat_nhwc.detach().requires_grad_(True)

    def roi_fwdbwd():
        return torch.autograd.grad(pool(leaf, rois).float().sum(), leaf)

    _row(report, "roi_extract_fwd", roi_fwd, dev, iters, warmup)
    _row(report, "roi_extract_fwdbwd", roi_fwdbwd, dev, iters, warmup)

    pooled = roi_fwd()[0].permute(0, 3, 1, 2)
    th = _seeded(lambda: ResNetTopHead(depth=net.depth, dtype=dt), dev)
    th_params = [p for p in th.parameters()]

    def th_fwd():
        with torch.no_grad():
            return th(pooled)

    def th_fwdbwd():
        return torch.autograd.grad(th(pooled).float().sum(), th_params)

    _row(report, "top_head_fwd", th_fwd, dev, iters, warmup)
    _row(report, "top_head_fwdbwd", th_fwdbwd, dev, iters, warmup)
    del bb, rpn, th, feat, feat_nhwc, leaf, pooled

    # --- full model
    model = _seeded_model(cfg, dev)
    state = create_train_state(model, make_optimizer(cfg, model, lambda s: t.LEARNING_RATE))
    _row(report, "full_train_step", lambda: train_step(state, batch, 0), dev, iters, warmup)
    report["imgs/sec (full step)"] = b / (report["full_train_step"]["wall_ms"] / 1e3)
    return report


def ablate(cfg=None, device=None, iters: int = 10, dtype: str = "bfloat16",
           batch: int = 8) -> Dict[str, Dict[str, Optional[float]]]:
    """The JAX tool's chained per-component ablation at ``batch`` images:
    → ``{row: {"wall_ms", "device_ms"}}`` under the JAX tool's row labels."""
    cfg = flagship_cfg() if cfg is None else cfg
    dev = resolve_device(device)
    full_float32()
    dt = _dtype(dtype)
    net, t = cfg.network, cfg.TRAIN
    h, w = cfg.SHAPE_BUCKETS[0]
    b = batch
    hb = batch_to_device(flagship_batch(cfg, b, h, w), dev)
    imgs, info = hb["images"].permute(0, 3, 1, 2), hb["im_info"]
    fh, fw = h // 16, w // 16
    report: Dict = {}

    bb = _seeded(lambda: ResNetBackbone(depth=net.depth, dtype=dt), dev)
    rpn = _seeded(lambda: RPNHead(num_anchors=net.NUM_ANCHORS, channels=512, dtype=dt), dev)
    th = _seeded(lambda: ResNetTopHead(depth=net.depth, dtype=dt), dev)
    with torch.no_grad():
        feat0 = bb(imgs).permute(0, 2, 3, 1)
    rois = torch.tensor([[10.0, 10.0, 300.0, 300.0]], device=dev).repeat(b, t.BATCH_ROIS, 1)

    def pool(f, r):
        return extract_roi_features_batched(f, r, net.ROI_MODE, net.POOLED_SIZE,
                                            1.0 / net.RCNN_FEAT_STRIDE, net.ROI_SAMPLE_RATIO)

    def sgd(params, grads):
        with torch.no_grad():
            torch._foreach_add_(params, grads, alpha=-1e-6)
        return params

    bb_rpn = list(bb.parameters()) + list(rpn.parameters())

    def step_bb(ps):
        f = bb(imgs)
        lg, dl = rpn(f)
        loss = (f.float().pow(2).mean() + lg.float().pow(2).mean() + dl.float().pow(2).mean())
        return sgd(ps, list(torch.autograd.grad(loss, ps)))

    _chained_row(report, "backbone+rpn fwd/bwd/update", step_bb, bb_rpn, dev, iters)

    th_params = list(th.parameters())

    def step_roi(ps):
        x = pool(feat0, rois)
        out = th(x.reshape((-1,) + x.shape[2:]).permute(0, 3, 1, 2))
        return sgd(ps, list(torch.autograd.grad(out.float().pow(2).mean(), ps)))

    _chained_row(report, "roi_extract+top_head f/b", step_roi, th_params, dev, iters)

    def step_pool_only(f):
        f = f.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(pool(f, rois).float().pow(2).mean(), f)
        return (f - 1e-6 * g).detach()

    _chained_row(report, "of which roi_extract f/b", step_pool_only, feat0, dev, iters)

    anchors = torch.as_tensor(shifted_anchors(fh, fw, 16, ratios=net.ANCHOR_RATIOS,
                                              scales=net.ANCHOR_SCALES), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    scores0 = torch.rand((b, anchors.shape[0]), generator=gen, device=dev)
    deltas = torch.randn((b, anchors.shape[0], 4), generator=gen, device=dev) * 0.1

    def step_prop(s):
        pr = propose(s, deltas, anchors, info, t.RPN_PRE_NMS_TOP_N, t.RPN_POST_NMS_TOP_N,
                     t.RPN_NMS_THRESH, t.RPN_MIN_SIZE)
        return s + 1e-9 * pr.scores.sum()

    _chained_row(report, f"propose train-NMS x{b}", step_prop, scores0, dev, iters)

    gtv = hb["gt_valid"]
    pr_rois = torch.tensor([[10.0, 10.0, 300.0, 300.0]], device=dev).repeat(
        b, t.RPN_POST_NMS_TOP_N, 1)
    pr_valid = torch.ones((b, t.RPN_POST_NMS_TOP_N), dtype=torch.bool, device=dev)

    def step_tgt(g):
        at = assign_anchor(anchors, g, gtv, info, cfg, generator=gen)
        sm = sample_rois(pr_rois, pr_valid, g, gtv, cfg, generator=gen)
        return g + 1e-9 * (at.bbox_targets.sum() + sm.bbox_targets.sum())

    _chained_row(report, f"anchor+roi targets x{b}", step_tgt, hb["gt_boxes"], dev, iters)
    del bb, rpn, th, feat0

    # the optimizer update alone and the full step, at the bench config
    bcfg = cfg.replace(
        network=dataclasses.replace(cfg.network, COMPUTE_DTYPE=dtype, FOLD_BN=True),
        TRAIN=dataclasses.replace(cfg.TRAIN, BATCH_IMAGES=b),
    )
    bmodel = _seeded_model(bcfg, dev)
    opt = make_optimizer(bcfg, bmodel, lambda s: bcfg.TRAIN.LEARNING_RATE)

    def step_opt(o):
        for p in o.params:
            p.grad = torch.full_like(p, 1e-6)
        o.step()
        return o

    _chained_row(report, "optimizer update only", step_opt, opt, dev, iters)
    state = create_train_state(bmodel, opt)

    def full_step(st):
        st, _ = train_step(st, hb, 0)
        return st

    _chained_row(report, "FULL bench-config step", full_step, state, dev, iters)
    return report


def _fmt(v: Optional[float]) -> str:
    return "not measured" if v is None else f"{v:9.2f} ms"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Per-component cost of the flagship train step")
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8,
                    help="--ablate batch size (bench flagship = 8)")
    ap.add_argument("--ablate", action="store_true",
                    help="chained per-component ablation")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.ablate:
        report = ablate(device=device, iters=args.iters, dtype=args.dtype, batch=args.batch)
        for k, v in report.items():
            print(f"{k:28s}: {v['wall_ms']:8.1f} ms wall, device {_fmt(v['device_ms'])}")
        return 0
    report = profile(device=device, iters=args.iters, dtype=args.dtype)
    rate = report.pop("imgs/sec (full step)")
    platform = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    print(f"\n=== profile ({args.dtype}, {platform}) ===")
    print(f"{'':24s} {'wall':>12s} {'device':>12s}")
    for k, v in sorted(report.items(), key=lambda kv: -kv[1]["wall_ms"]):
        print(f"{k:24s} {v['wall_ms']:9.2f} ms {_fmt(v['device_ms']):>12s}")
    print(f"{'imgs/sec (full step)':24s} {rate:9.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
