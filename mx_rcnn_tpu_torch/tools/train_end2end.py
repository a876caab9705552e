"""End-to-end Faster R-CNN training CLI (port of
``mx_rcnn_tpu/tools/train_end2end.py``, the flags this slice supports, under
the same names).

    python -m mx_rcnn_tpu_torch.tools.train_end2end --network resnet \\
        --dataset PascalVOC --synthetic 64 --epochs 2 --prefix model/e2e

``--network resnet_fpn`` trains ResNet-50 FPN and ``--network
mask_resnet_fpn`` (with ``--dataset coco``) Mask R-CNN ResNet-101 FPN, whose
batches carry the gt masks, through the same loop.  The roidb comes from
``utils/load_data.py::load_gt_roidb`` (``--image_set``) with flipped copies
(TRAIN.FLIP, unless ``--no_flip``).  Runs on the card; ``--cpu 1`` runs the
plain PyTorch versions of the kernels on the CPU instead.  Every step runs
through ``fit``'s pipeline: the device feed (``--feed_depth``), the deferred
aux check (``--aux_interval``) and the divergence guard (``--spike_factor``,
``--max_bad_batches``, ``--snapshot_every``, ``--step_timeout``), over a
loader with a failure budget (``--loader_failure_budget``;
``MX_RCNN_ASSEMBLY_WORKERS`` sizes its assembly pool); ``--grad_accum N``
averages N microbatches' gradients into each update.

Checkpoints go under ``--prefix`` (``core/checkpoint.py``): ``run_meta.json``
before training, ``epoch_EEEE`` at each epoch end, ``step_EEEE_BBBBBB`` when
SIGTERM/SIGINT stops the run mid-epoch or the watchdog aborts a hung step
(exit code 75); ``--resume`` continues from the newest restorable dump, and
``tools/test.py --prefix`` evaluates one.  The log, the Speedometer lines
included, goes to standard output (``--metrics_jsonl`` also writes them as
JSON lines); ``--profile DIR`` writes a ``torch.profiler`` trace of steps
10–20.  Without ``--synthetic N`` it reads the config's dataset (VOC or COCO
annotations, JPEG images through the port's decoder); the weights start
seeded random (``--seed``).  ``--compute_dtype
bfloat16`` trains the bf16 graph (COMPUTE_DTYPE; FOLD_BN comes from the
config, as in the JAX CLI, which has no flag for it).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Dict

import torch

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.core.resilience import DivergencePolicy
from mx_rcnn_tpu_torch.data.loader import load_record_image
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.utils.load_data import load_gt_roidb
from mx_rcnn_tpu_torch.utils.run_meta import save_run_meta
from mx_rcnn_tpu_torch.utils.precision import full_float32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Faster R-CNN end-to-end (PyTorch port)")
    p.add_argument("--network", default="resnet",
                   choices=["resnet", "resnet50", "resnet152", "resnet_fpn", "mask_resnet_fpn"])
    p.add_argument("--dataset", default="PascalVOC", choices=["PascalVOC", "PascalVOC0712", "coco"])
    p.add_argument("--image_set", default=None)
    p.add_argument("--prefix", default="model/e2e", help="checkpoint dir")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--batch_images", type=int, default=None, help="images per microbatch")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer update (gradient accumulation for big "
                        "effective batches)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--compute_dtype", default=None, choices=["float32", "bfloat16"],
                   help="override network COMPUTE_DTYPE (bfloat16 activations, float32 "
                        "parameters, gradients and optimizer state)")
    p.add_argument("--no_flip", action="store_true")
    p.add_argument("--no_shuffle", action="store_true")
    p.add_argument("--frequent", type=int, default=20, help="logging interval")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic images (no dataset needed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop after N steps (smoke runs; the unfinished epoch is not saved)")
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="run on the CPU (the plain versions of the kernels) instead of the "
                        "card; N > 1 devices needs data parallel, which is not ported")
    p.add_argument("--metrics_jsonl", default=None, metavar="PATH",
                   help="append one JSON line of metrics per logging interval (structured twin "
                        "of the Speedometer log)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of steps 10-20 to DIR/trace.json")
    # resilience (core/resilience.py): divergence recovery + hang watchdog
    p.add_argument("--step_timeout", type=float, default=0.0, metavar="SECS",
                   help="wall-clock watchdog per train step: a step that exceeds this dumps a "
                        "resumable checkpoint and exits with code 75 instead of hanging (0 = off)")
    p.add_argument("--snapshot_every", type=int, default=10, metavar="N",
                   help="refresh the guarded loop's rollback snapshot every N accepted steps "
                        "(1 = exact rollback)")
    p.add_argument("--spike_factor", type=float, default=20.0,
                   help="treat a step as diverged when its loss exceeds this multiple of the "
                        "running EMA")
    p.add_argument("--max_bad_batches", type=int, default=8,
                   help="abort (TrainingDiverged) after this many batches are skipped via "
                        "rollback")
    p.add_argument("--loader_failure_budget", type=int, default=None,
                   help="abort after this many records fail to load (default: max(32, 1%% of "
                        "the roidb))")
    # step pipeline (core/pipeline.py): device feed + K-late aux fetch
    p.add_argument("--feed_depth", type=int, default=2, metavar="N",
                   help="device-feed depth: batches staged on the device ahead of the step")
    p.add_argument("--aux_interval", type=int, default=0, metavar="K",
                   help="fetch train aux every K steps instead of every step (divergence "
                        "checks run K late against the retained window snapshot); 0 = auto: "
                        "1 on the CPU, 8 on the card")
    return p.parse_args(argv)


def train_net(args) -> Dict:
    if args.cpu > 1:
        raise NotImplementedError(f"--cpu {args.cpu}: data-parallel training is not ported")
    cfg = generate_config(args.network, args.dataset)
    overrides = {}
    if args.lr is not None:
        overrides["LEARNING_RATE"] = args.lr
    if args.batch_images is not None:
        overrides["BATCH_IMAGES"] = args.batch_images
    if args.no_shuffle:
        overrides["SHUFFLE"] = False
    if overrides:
        cfg = cfg.replace(TRAIN=dataclasses.replace(cfg.TRAIN, **overrides))
    if args.compute_dtype:
        cfg = cfg.replace(network=dataclasses.replace(cfg.network,
                                                      COMPUTE_DTYPE=args.compute_dtype))
    _, roidb = load_gt_roidb(cfg, args.image_set, flip=cfg.TRAIN.FLIP and not args.no_flip,
                             synthetic_size=args.synthetic)
    logging.getLogger(__name__).info("roidb size: %d", len(roidb))
    if not args.synthetic:
        # an unreadable dataset (missing files, another format) fails at its
        # first image here rather than spend the loader's failure budget
        load_record_image(roidb[0])
    model = build_model(cfg, generator=torch.Generator().manual_seed(args.seed))
    save_run_meta(args.prefix, cfg)
    return fit(
        model, cfg, roidb, epochs=args.epochs, seed=args.seed, max_steps=args.max_steps,
        frequent=args.frequent, device="cpu" if args.cpu else None,
        guard_policy=DivergencePolicy(spike_factor=args.spike_factor,
                                      max_bad_batches=args.max_bad_batches),
        step_timeout=args.step_timeout, snapshot_every=args.snapshot_every,
        aux_interval=args.aux_interval or (1 if args.cpu else 8),
        feed_depth=args.feed_depth, loader_failure_budget=args.loader_failure_budget,
        prefix=args.prefix, resume=args.resume, accum_steps=args.grad_accum,
        metrics_jsonl=args.metrics_jsonl, profile=args.profile,
    )


def main(argv=None) -> Dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", stream=sys.stdout)
    full_float32()
    return train_net(parse_args(argv))


if __name__ == "__main__":
    main()
