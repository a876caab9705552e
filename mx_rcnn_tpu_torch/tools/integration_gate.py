"""Train→eval integration gate: overfit tiny synthetic data to high mAP (port
of ``mx_rcnn_tpu/tools/integration_gate.py``).

Trains a small model of one family on synthetic images from seeded random
weights, then runs the full inference and evaluation stack (``Predictor`` →
device postprocess → per-class NMS → ``evaluate_detections``) on the same
images and demands that the detections score.  ``--network`` gates every
family: resnet50 (C4 flagship shape), resnet_fpn, mask_resnet_fpn, vgg.  The
mask gate trains on synthetic polygon gts and must also reach segm AP50 ≥
target through the mask stack.

Usage:
  python -m mx_rcnn_tpu_torch.tools.integration_gate [--network resnet50]
      [--steps 400] [--target 0.8] [--dp N] [--cpu N]

Runs on the card; ``--cpu`` runs on the CPU (the kernels' plain PyTorch
versions).  ``--dp N`` trains data parallel over N rank processes (one
image a rank, ``BATCH_IMAGES = N``) that this process starts
(``tools/train_end2end.py::launch_ranks``, a rendezvous it hosts): over
gloo on the CPU with ``--cpu N``, and over gloo on a card that the ranks
share when the machine has fewer cards than ranks.  Only rank 0 evaluates;
its result is the run's.  Exit code 0 iff the gate metric ≥ target.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import logging
import os
import sys
from typing import Dict, List, Optional, Sequence

import torch

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.pipeline import batch_to_device
from mx_rcnn_tpu_torch.core.resilience import host_copy
from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval, resolve_device
from mx_rcnn_tpu_torch.core.train import create_train_state, make_optimizer, train_step
from mx_rcnn_tpu_torch.data.loader import TestLoader, TrainLoader, make_batch
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.parallel import distributed
from mx_rcnn_tpu_torch.utils.precision import full_float32

logger = logging.getLogger(__name__)

# what a launched rank runs, before its arguments
RANK_COMMAND = (sys.executable, "-m", "mx_rcnn_tpu_torch.tools.integration_gate")


def gate_cfg(
    network: str = "resnet50",
    num_classes: int = 4,
    compute_dtype: Optional[str] = None,
    fold_bn: Optional[bool] = None,
):
    """Small-shape config of the requested family: one 128×128 bucket,
    reduced proposal / roi budgets.  ``compute_dtype`` / ``fold_bn``
    override the family defaults, so the gate can run at the bench
    configuration (bf16 + FOLD_BN)."""
    cfg = generate_config(network, "PascalVOC")
    # freezing conv0 / stage1 only makes sense with pretrained weights:
    # frozen random features cap the overfit capacity this gate measures
    net_over = dict(FIXED_PARAMS=())
    if compute_dtype is not None:
        net_over["COMPUTE_DTYPE"] = compute_dtype
    if fold_bn is not None:
        net_over["FOLD_BN"] = fold_bn
    if not cfg.network.USE_FPN:
        # anchors of 32-128 px: the flagship scales (8, 16, 32) give 128-512
        # px anchors, none inside a 128×128 image, so no RPN label is live
        net_over["ANCHOR_SCALES"] = (2, 4, 8)
    if cfg.network.depth > 50 and cfg.network.name == "resnet":
        net_over["depth"] = 50
    # FPN's stride-4 anchors saturate the fg/bg boundary at the C4 budget: a
    # wider proposal pool and roi batch keep background diversity
    post_nms = 192 if cfg.network.USE_FPN else 64
    batch_rois = 64 if cfg.network.USE_FPN else 32
    return cfg.replace(
        SHAPE_BUCKETS=((128, 128),),
        network=dataclasses.replace(cfg.network, **net_over),
        dataset=dataclasses.replace(
            cfg.dataset, NUM_CLASSES=num_classes, SCALES=((128, 128),), MAX_GT_BOXES=8,
        ),
        TRAIN=dataclasses.replace(
            cfg.TRAIN,
            RPN_PRE_NMS_TOP_N=400,
            RPN_POST_NMS_TOP_N=post_nms,
            BATCH_ROIS=batch_rois,
            RPN_BATCH_SIZE=64,
            BATCH_IMAGES=2,
            # small data + short schedule: no flip (run_gate decays the lr
            # 10x halfway through its step budget)
            FLIP=False,
        ),
        TEST=dataclasses.replace(
            cfg.TEST,
            RPN_PRE_NMS_TOP_N=200,
            RPN_POST_NMS_TOP_N=64 if cfg.network.USE_FPN else 32,
            SCORE_THRESH=0.05,
        ),
    )


def kernel_launches() -> Dict[str, int]:
    """This process's launch counts of the kernels a gate's paths run: NMS
    and ROIAlign forward / backward, float32 and bf16 (resident and
    streamed)."""
    from mx_rcnn_tpu_torch.ops import nms as nms_mod
    from mx_rcnn_tpu_torch.ops import roi_align as roi_mod
    from mx_rcnn_tpu_torch.ops import roi_align_stream as stream_mod

    kernels = {
        "nms": nms_mod.kernel, "roi_align_fwd": roi_mod.kernel,
        "roi_align_bwd": roi_mod.bwd_kernel, "roi_align_stream_fwd": stream_mod.fwd_kernel,
        "roi_align_stream_bwd": stream_mod.bwd_kernel,
        "roi_align_fwd_bf16": roi_mod.kernel_bf16, "roi_align_bwd_bf16": roi_mod.bwd_kernel_bf16,
        "roi_align_stream_fwd_bf16": stream_mod.fwd_kernel_bf16,
        "roi_align_stream_bwd_bf16": stream_mod.bwd_kernel_bf16,
    }
    return {k: v.launches for k, v in kernels.items()}


@torch.no_grad()
def mask_iou_eval(model, params, cfg, roidb, device=None) -> float:
    """Mean decoupled mask IoU over a roidb: masks predicted at the gt boxes
    for the gt classes (``mask_iou_probe``) against the polygon gt bitmaps,
    mask-head shape quality without the detection stack.  ``params``, a
    ``state_dict`` (host or device tensors), is loaded into ``model`` first;
    None probes the model's own weights.  ``device`` defaults to the
    model's."""
    if params is not None:
        model.load_state_dict(params)
    dev = next(model.parameters()).device if device is None else torch.device(device)
    total, count = 0.0, 0
    bucket = tuple(cfg.SHAPE_BUCKETS[0])
    for rec in roidb:
        b = batch_to_device(make_batch([rec], cfg, bucket, with_masks=True), dev)
        iou, valid = model.mask_iou_probe(b["images"], b["im_info"], b["gt_boxes"],
                                          b["gt_valid"], b["gt_masks"])
        iou, v = iou.cpu().numpy(), valid.cpu().numpy().astype(bool)
        total += float(iou[v].sum())
        count += int(v.sum())
    return total / max(count, 1)


def _rank_argv(network, num_images, steps, lr, eval_every, target, seed, dp, compute_dtype,
               fold_bn, cpu, params_out) -> List[str]:
    argv = ["--network", network, "--num_images", str(num_images), "--steps", str(steps),
            "--lr", repr(lr), "--eval_every", str(eval_every), "--target", repr(target),
            "--seed", str(seed), "--dp", str(dp)]
    if compute_dtype == "bfloat16":
        argv.append("--bf16")
    if fold_bn:
        argv.append("--fold_bn")
    if cpu:
        argv += ["--cpu", str(dp)]
    if params_out:
        argv += ["--params_out", params_out]
    return argv


def launch_gate_ranks(argv: Sequence[str], n: int, command: Sequence[str] = RANK_COMMAND,
                      timeout: Optional[float] = None) -> Dict:
    """Run the gate as ``n`` rank processes (``command`` + ``argv``) at a
    rendezvous this process hosts; → rank 0's result, with every rank's
    report (its ``launches`` too) under ``ranks``.  ``timeout`` seconds
    bound the ranks' run."""
    from mx_rcnn_tpu_torch.tools.train_end2end import launch_ranks

    report = launch_ranks(list(argv), n, command, timeout=timeout)
    for r in [report] + report["ranks"]:
        r["per_eval"] = [tuple(e) for e in r["per_eval"]]
    return report


def run_gate(
    network: str = "resnet50",
    num_images: int = 8,
    steps: int = 400,
    lr: float = 2e-3,
    eval_every: int = 100,
    target: float = 0.8,
    seed: int = 0,
    dp: int = 0,
    compute_dtype: Optional[str] = None,
    fold_bn: Optional[bool] = None,
    device=None,
    params_out: Optional[str] = None,
    rank_command: Sequence[str] = RANK_COMMAND,
    rank_timeout: Optional[float] = None,
    accum_steps: int = 1,
) -> dict:
    """Train on ``num_images`` synthetic images, eval on the same images.

    Returns ``{"mAP": best, "gate": best gate metric, "steps": steps run,
    "per_eval": [(step, gate metric)], ...}``.  The gate metric is VOC mAP
    for box models and min(mAP, segm AP50) for Mask R-CNN.  Stops early once
    ``target`` is reached.  ``device``: the card by default, ``"cpu"`` for
    the CPU.  ``params_out`` names a file that receives the final
    ``state_dict`` (rank 0's under ``dp``).  ``accum_steps`` > 1 splits each
    batch into that many microbatches and averages their gradients
    (``train_step(accum_steps=)``): with ``accum_steps = BATCH_IMAGES`` one
    process computes the data-parallel step's arithmetic, one image a
    microbatch as one image a rank.

    ``dp`` ≥ 2 in a process outside a process group starts ``dp`` ranks of
    ``rank_command`` (within ``rank_timeout`` seconds, when given) and
    returns rank 0's result (with ``ranks``); inside
    one (a rank), this process trains its image of each global batch with
    the data-parallel step, and rank 0 evaluates and broadcasts whether to
    stop, so every rank leaves the loop at the same step."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if dp > 1 and distributed.process_count() == 1:
        return launch_gate_ranks(
            _rank_argv(network, num_images, steps, lr, eval_every, target, seed, dp,
                       compute_dtype, fold_bn, cpu, params_out), dp, rank_command,
            rank_timeout)
    cfg = gate_cfg(network, compute_dtype=compute_dtype, fold_bn=fold_bn)
    if dp:
        # one image a rank: the global batch is dp images
        cfg = cfg.replace(TRAIN=dataclasses.replace(cfg.TRAIN, BATCH_IMAGES=dp))
    imdb = SyntheticDataset(
        num_images=num_images,
        num_classes=cfg.dataset.NUM_CLASSES,
        image_size=(128, 128),
        max_boxes=2,
        seed=seed,
        with_masks=cfg.network.USE_MASK,
    )
    roidb = imdb.gt_roidb()
    mesh = None
    if distributed.process_count() > 1:
        from mx_rcnn_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
        dev = mesh.device
    else:
        dev = resolve_device(device)
    main_rank = distributed.is_main()
    full_float32()

    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    model.to(dev, memory_format=torch.channels_last).train()
    rows = (distributed.process_slice(dp, rank=mesh.position, world=mesh.size)
            if mesh is not None else None)
    loader = TrainLoader(roidb, cfg, cfg.TRAIN.BATCH_IMAGES, shuffle=True, seed=seed,
                         row_slice=rows)
    if len(loader) == 0:
        raise ValueError(
            f"num_images={num_images} yields zero batches at "
            f"BATCH_IMAGES={cfg.TRAIN.BATCH_IMAGES}"
        )
    first = iter(loader)
    batch0 = next(first)
    first.close()
    # random-init frozen-BN networks start unnormalized; FPN diverges at any
    # workable lr without calibrated moments (utils/bn_calibrate.py).  C4
    # stays uncalibrated on purpose, as in the JAX gate: its oversized
    # activations ride the gradient clip to a fast overfit, and normalizing
    # them shrinks the gradients below what the step budget needs
    if cfg.network.USE_FPN:
        from mx_rcnn_tpu_torch.utils.bn_calibrate import calibrate_frozen_bn

        calibrate_frozen_bn(model, batch_to_device(batch0, dev))
    # FIXED_PARAMS () trains the BN affines too, as the JAX gate does
    optimizer = make_optimizer(cfg, model, lambda count: lr, train_bn_affines=True)
    state = create_train_state(model, optimizer)
    if mesh is not None:
        from mx_rcnn_tpu_torch.parallel.mesh import make_parallel_train_step, replicate

        replicate(state, mesh)
        step_fn = make_parallel_train_step(mesh, accum_steps)
    else:
        step_fn = functools.partial(train_step, accum_steps=accum_steps)
    rng = seed + 123

    def eval_gate():
        predictor = Predictor(model, device=dev)
        try:
            _, results = pred_eval(predictor, TestLoader(roidb, cfg), imdb, cfg)
        finally:
            model.train()
        logger.info("per-class AP: %s", {k: round(v, 3) for k, v in results.items()})
        m = float(results["mAP"])
        if cfg.network.USE_MASK:
            # the mask gate must prove segmentation quality, not ride on
            # box mAP: min() forces both stacks to converge
            return min(m, float(results.get("segm_AP50", 0.0))), results
        return m, results

    per_eval = []
    best, best_results, best_params = 0.0, {}, None
    done = 0
    it = iter(loader)
    try:
        while done < steps:
            try:
                batch = next(it)
            except StopIteration:
                it.close()
                it = iter(loader)
                continue
            # 10x lr decay halfway: the constant-lr run overfits noisily
            lr_scale = 0.1 if state.step >= steps // 2 else None
            state, aux = step_fn(state, batch_to_device(batch, dev), rng, lr_scale)
            done += 1
            if done % eval_every == 0 or done == steps:
                loss = float(aux["loss"])
                stop = 0
                if main_rank:
                    m, results = eval_gate()
                    per_eval.append((done, m))
                    if m > best:
                        best, best_results = m, results
                        # the checkpoint the reported metrics describe, so
                        # the mask IoU below measures the best params
                        best_params = host_copy(model.state_dict())
                    logger.info("step %d loss %.3f gate %.3f", done, loss, m)
                    stop = int(best >= target)
                if distributed.broadcast_ints([stop], src=0)[0]:
                    break
    finally:
        it.close()
        loader.close()
    out = {
        "mAP": float(best_results.get("mAP", best)),
        "segm_AP50": float(best_results["segm_AP50"]) if "segm_AP50" in best_results else None,
        "gate": best,
        "network": network,
        "steps": done,
        "per_eval": per_eval,
    }
    if params_out and main_rank:
        torch.save(host_copy(model.state_dict()), params_out)
    if cfg.network.USE_MASK and main_rank:
        # decoupled shape quality, measured on the best checkpoint
        out["mask_iou"] = round(mask_iou_eval(model, best_params, cfg, roidb, dev), 4)
        logger.info("decoupled mask IoU at gt boxes: %.4f", out["mask_iou"])
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train->eval integration gate (PyTorch port)")
    p.add_argument("--network", default="resnet50",
                   choices=["resnet50", "resnet_fpn", "mask_resnet_fpn", "vgg"])
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--num_images", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--eval_every", type=int, default=100)
    p.add_argument("--target", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", type=int, default=0,
                   help="run on the CPU (with --dp N: N gloo ranks on the CPU)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel gate over N rank processes, one image a rank")
    p.add_argument("--bf16", action="store_true",
                   help="gate at COMPUTE_DTYPE=bfloat16 (the bench dtype)")
    p.add_argument("--fold_bn", action="store_true",
                   help="gate with FOLD_BN=True (the bench BN folding)")
    p.add_argument("--params_out", default=None,
                   help="write the final state_dict (torch.save) to this file")
    p.add_argument("--dist_coordinator", default=None, help=argparse.SUPPRESS)
    p.add_argument("--dist_nprocs", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--dist_procid", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, rank_command: Sequence[str] = RANK_COMMAND) -> int:
    """Run the gate: prints the result and returns the exit code (0 iff the
    gate metric ≥ target).  As a launched rank (``--dist_*``) it writes its
    report, with this process's kernel launches, for the launcher and
    returns 0."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    rank = f"[rank {args.dist_procid}] " if args.dist_procid is not None else ""
    logging.basicConfig(level=logging.INFO, format=f"%(asctime)s {rank}%(message)s",
                        stream=sys.stdout)
    full_float32()
    backend = distributed.initialize(args.dist_coordinator, args.dist_nprocs, args.dist_procid,
                                     cpu=bool(args.cpu))
    try:
        out = run_gate(
            network=args.network,
            num_images=args.num_images,
            steps=args.steps,
            lr=args.lr,
            eval_every=args.eval_every,
            target=args.target,
            seed=args.seed,
            dp=args.dp,
            compute_dtype="bfloat16" if args.bf16 else None,
            fold_bn=True if args.fold_bn else None,
            device="cpu" if args.cpu else None,
            params_out=args.params_out,
            rank_command=rank_command,
        )
    finally:
        if backend is not None:
            distributed.shutdown()
    if backend is not None:
        from mx_rcnn_tpu_torch.tools.train_end2end import REPORT_ENV

        report_dir = os.environ.get(REPORT_ENV)
        if report_dir:
            with open(os.path.join(report_dir, f"rank{args.dist_procid}.json"), "w") as f:
                json.dump(dict(out, launches=kernel_launches()), f)
        return 0
    print(out)
    return 0 if out["gate"] >= args.target else 1


if __name__ == "__main__":
    sys.exit(main())
