"""End-to-end Faster R-CNN training CLI (port of
``mx_rcnn_tpu/tools/train_end2end.py``, the flags this slice supports, under
the same names).

    python -m mx_rcnn_tpu_torch.tools.train_end2end --network resnet \\
        --dataset PascalVOC --synthetic 64 --epochs 1 --max_steps 20

Runs on the card; ``--cpu 1`` runs the plain PyTorch versions of the kernels
on the CPU instead.  The log, the Speedometer lines included, goes to
standard output.  Only synthetic data is ported (``--synthetic N``), and
the weights are seeded random (``--seed``): no checkpoint is written yet.
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
from mx_rcnn_tpu_torch.data.imdb import IMDB, filter_roidb
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Faster R-CNN end-to-end (PyTorch port)")
    p.add_argument("--network", default="resnet", choices=["resnet", "resnet50", "resnet152"])
    p.add_argument("--dataset", default="PascalVOC", choices=["PascalVOC", "PascalVOC0712", "coco"])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--batch_images", type=int, default=None, help="images per step")
    p.add_argument("--no_shuffle", action="store_true")
    p.add_argument("--frequent", type=int, default=20, help="logging interval")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic images (no dataset needed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=0, help="stop after N steps (smoke runs)")
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="run on the CPU (the plain versions of the kernels) instead of the "
                        "card; N > 1 devices needs data parallel, which is not ported")
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
    if not args.synthetic:
        raise NotImplementedError("only --synthetic data is ported; the dataset readers are not")
    roidb = SyntheticDataset(num_images=args.synthetic, num_classes=cfg.dataset.NUM_CLASSES).gt_roidb()
    if cfg.TRAIN.FLIP:
        roidb = IMDB.append_flipped_images(roidb)
    roidb = filter_roidb(roidb)
    logging.getLogger(__name__).info("roidb size: %d", len(roidb))
    model = FasterRCNN(cfg, generator=torch.Generator().manual_seed(args.seed))
    return fit(
        model, cfg, roidb, epochs=args.epochs, seed=args.seed, max_steps=args.max_steps,
        frequent=args.frequent, device="cpu" if args.cpu else None,
    )


def main(argv=None) -> Dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", stream=sys.stdout)
    return train_net(parse_args(argv))


if __name__ == "__main__":
    main()
