"""Evaluation CLI: mAP of a detector on VOC or synthetic data, and for a mask
network the COCO segm stats (port of ``mx_rcnn_tpu/tools/test.py``, the
routes the port supports, under the same flags).

    python -m mx_rcnn_tpu_torch.tools.test --network resnet --dataset PascalVOC \\
        --synthetic 32 --prefix model/e2e --epoch 10
    python -m mx_rcnn_tpu_torch.tools.test --network mask_resnet_fpn --dataset coco \\
        --synthetic 32 --params params.pkl

Builds the test graph and loads its weights: with ``--params``, a pickle of
a Flax parameter tree with numpy leaves (bridged by
``utils/bridge.py::flax_to_torch``); else the checkpoint under ``--prefix``
that ``tools/train_end2end.py`` wrote, ``epoch_EEEE`` with ``--epoch E``,
else the newest committed dump, mid-epoch step dumps included (with none, it
warns and evaluates the seeded random model).  It applies the run's
``run_meta.json`` (beside the pickle, or in the prefix), runs ``pred_eval``
over the test set and logs each class's AP and the mAP to standard output.
Runs on the card; ``--cpu 1`` runs the plain PyTorch versions of the
kernels on the CPU.  Every network of the JAX CLI is ported: VGG-16, ResNet
C4, ResNet FPN and Mask R-CNN FPN (``--synthetic`` COCO runs read polygon
records); ``--vis DIR``
writes each image's detection overlay to ``DIR/det_%06d.png``.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.checkpoint import latest_checkpoint, load_checkpoint
from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval, resolve_device
from mx_rcnn_tpu_torch.data.loader import TestLoader
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch
from mx_rcnn_tpu_torch.utils.load_data import get_imdb
from mx_rcnn_tpu_torch.utils.precision import full_float32

logger = logging.getLogger(__name__)

def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate Faster R-CNN (PyTorch port)")
    p.add_argument("--network", default="resnet",
                   choices=["vgg", "resnet", "resnet50", "resnet152", "resnet_fpn",
                            "mask_resnet_fpn"])
    p.add_argument("--dataset", default="PascalVOC",
                   choices=["PascalVOC", "PascalVOC0712", "coco"])
    p.add_argument("--image_set", default=None, help="defaults to the test split")
    p.add_argument("--prefix", default="model/e2e")
    p.add_argument("--epoch", type=int, default=None, help="default: latest")
    p.add_argument("--thresh", type=float, default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--max_images", type=int, default=0)
    p.add_argument("--params", default=None,
                   help="params pickle (a Flax parameter tree with numpy leaves) instead of a "
                        "checkpoint")
    p.add_argument("--dump", default=None, help="save the all_boxes pickle")
    p.add_argument("--vis", default=None, metavar="DIR",
                   help="render detection overlays into DIR (det_%%06d.png per image)")
    p.add_argument("--test_batch", type=int, default=1,
                   help="images per device forward (same-bucket batching)")
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="run on the CPU (the plain versions of the kernels) instead of the "
                        "card; N > 1 devices is not ported")
    return p.parse_args(argv)


def load_flax_params(path: str) -> Dict:
    """The params pickle at ``path``, whose leaves must be numpy arrays: a
    pickle of ``jax.Array`` leaves needs JAX to read, which the port does
    not import (write it after ``jax.device_get``)."""
    from mx_rcnn_tpu_torch.utils.combine_model import load_params

    hint = (f"{path}: the params pickle holds jax.Array leaves; write it with numpy "
            f"leaves (jax.device_get the tree first)")
    try:
        params = load_params(path)
    except ImportError as e:
        if "jax" in str(e):
            raise ValueError(hint) from e
        raise

    def check(tree):
        for v in tree.values():
            if isinstance(v, dict):
                check(v)
            elif not isinstance(v, np.ndarray):
                raise ValueError(hint if type(v).__module__.startswith("jax")
                                 else f"{path}: a leaf is {type(v).__name__}, not a numpy array")

    check(params)
    return params


def pick_checkpoint(prefix: str, epoch: Optional[int]) -> Optional[Tuple[int, int]]:
    """The (epoch, batch) of the dump an evaluation loads: ``epoch_EEEE`` for
    ``--epoch E``, else the newest committed dump; a run preempted after its
    last boundary save evaluates its step dump."""
    return (epoch, 0) if epoch is not None else latest_checkpoint(prefix)


def test_rcnn(args) -> Dict:
    from mx_rcnn_tpu_torch.utils.run_meta import apply_run_meta, load_run_meta

    if args.cpu > 1:
        raise NotImplementedError(f"--cpu {args.cpu}: data parallel is not ported")
    device = resolve_device("cpu" if args.cpu else None)
    cfg = generate_config(args.network, args.dataset)
    # the training run's preprocessing and normalization stats
    meta = load_run_meta(args.params if args.params else args.prefix)
    if meta:
        cfg = apply_run_meta(cfg, meta)
        logger.info("applied run_meta overrides: %s", meta)
    imdb = get_imdb(cfg, args.image_set or cfg.dataset.test_image_set, args.synthetic)[0]
    roidb = imdb.gt_roidb()
    if args.max_images:
        # truncate the imdb's index too: evaluate_detections iterates it
        roidb = roidb[: args.max_images]
        imdb.image_set_index = imdb.image_set_index[: args.max_images]

    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    if args.params:
        flax_to_torch(load_flax_params(args.params), model)
        logger.info("loaded params pickle %s", args.params)
    elif (found := pick_checkpoint(args.prefix, args.epoch)) is not None:
        epoch, batch_in_epoch = found
        load_checkpoint(args.prefix, epoch, model, batch_in_epoch)
        logger.info("loaded checkpoint epoch %d%s", epoch,
                    f" batch {batch_in_epoch}" if batch_in_epoch else "")
    else:
        logger.warning("no checkpoint found at %s: evaluating the seeded random model",
                       args.prefix)
    predictor = Predictor(model, device=device)
    loader = TestLoader(roidb, cfg, batch_size=args.test_batch)
    _, results = pred_eval(predictor, loader, imdb, cfg, thresh=args.thresh, vis=args.vis,
                           dump_path=args.dump)
    for k, v in results.items():
        logger.info("%s: %.4f", k, v)
    return results


def main(argv=None) -> Dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", stream=sys.stdout)
    full_float32()
    return test_rcnn(parse_args(argv))


if __name__ == "__main__":
    main()
