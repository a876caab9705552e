"""Single-image detection demo with visualization (port of
``mx_rcnn_tpu/tools/demo.py``): an RGB image in, ``{class name: (n, 5)
dets}`` out, through the same ``detect_single`` that serves requests.

    python -m mx_rcnn_tpu_torch.tools.demo --network resnet --params final.pkl \
        --image photo.jpg --out demo_out.png

:func:`main` reads a JPEG (``data/image.py::load_image``), loads the weights
as ``tools/test.py`` does (``--params`` pickle, else the checkpoint under
``--prefix``, else it warns and runs the seeded random model), logs the
detections scoring ``--vis_thresh`` or more and writes their overlay as a
PNG to ``--out``.  Runs on the card; ``--cpu 1`` runs the plain PyTorch
versions of the kernels on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import Config, generate_config
from mx_rcnn_tpu_torch.core.tester import Predictor, resolve_device
from mx_rcnn_tpu_torch.serve.runner import detect_single
from mx_rcnn_tpu_torch.utils.precision import full_float32

logger = logging.getLogger(__name__)

# VOC class names for the default 21-class config (demo labels)
VOC_CLASSES = (
    "__background__", "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor",
)


def demo_net(
    predictor: Predictor,
    im: np.ndarray,
    cfg: Config,
    class_names=VOC_CLASSES,
    vis_thresh: float = 0.7,
):
    """One RGB HWC uint8/float image → ``{class_name: (n, 5) dets}`` for
    the classes with a detection scoring ``vis_thresh`` or more (each with
    all its detections)."""
    cls_dets = detect_single(predictor, im, cfg, len(class_names), thresh=cfg.TEST.SCORE_THRESH)
    dets_by_class = {}
    for j in range(1, len(class_names)):
        if (cls_dets[j][:, 4] >= vis_thresh).any():
            dets_by_class[class_names[j]] = cls_dets[j]
    return dets_by_class


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Single-image demo (PyTorch port)")
    p.add_argument("--network", default="resnet",
                   choices=["vgg", "resnet", "resnet50", "resnet152", "resnet_fpn",
                            "mask_resnet_fpn"])
    p.add_argument("--dataset", default="PascalVOC",
                   choices=["PascalVOC", "PascalVOC0712", "coco"])
    p.add_argument("--image", required=True)
    p.add_argument("--out", default="demo_out.png")
    p.add_argument("--prefix", default="model/e2e")
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--params", default=None, help="params pickle")
    p.add_argument("--vis_thresh", type=float, default=0.7)
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="run on the CPU (the plain versions of the kernels) instead of the "
                        "card; N > 1 devices is not ported")
    return p.parse_args(argv)


def main(argv=None):
    """The demo CLI → ``{class name: (n, 5) dets}`` of the image (the
    overlay is written to ``--out``)."""
    from mx_rcnn_tpu_torch.core.checkpoint import load_checkpoint
    from mx_rcnn_tpu_torch.data.image import load_image
    from mx_rcnn_tpu_torch.models import build_model
    from mx_rcnn_tpu_torch.tools.test import _UNPORTED, load_flax_params, pick_checkpoint
    from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch
    from mx_rcnn_tpu_torch.utils.run_meta import apply_run_meta, load_run_meta
    from mx_rcnn_tpu_torch.utils.visualize import draw_detections, save_image

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", stream=sys.stdout)
    full_float32()
    args = parse_args(argv)
    if args.cpu > 1:
        raise NotImplementedError(f"--cpu {args.cpu}: data parallel is not ported")
    if args.network in _UNPORTED:
        raise NotImplementedError(f"--network {args.network} is not ported: ROADMAP queue 1 "
                                  f"{_UNPORTED[args.network]}")
    device = resolve_device("cpu" if args.cpu else None)
    cfg = generate_config(args.network, args.dataset)
    meta = load_run_meta(args.params if args.params else args.prefix)
    if meta:
        cfg = apply_run_meta(cfg, meta)
        logger.info("applied run_meta overrides: %s", meta)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    if args.params:
        flax_to_torch(load_flax_params(args.params), model)
    elif (found := pick_checkpoint(args.prefix, args.epoch)) is not None:
        load_checkpoint(args.prefix, found[0], model, found[1])
    else:
        logger.warning("no checkpoint — running random init")

    predictor = Predictor(model, device=device)
    im = load_image(args.image)
    names = (
        VOC_CLASSES if cfg.dataset.NUM_CLASSES == len(VOC_CLASSES)
        else tuple(f"class{i}" for i in range(cfg.dataset.NUM_CLASSES))
    )
    dets = demo_net(predictor, im, cfg, names, args.vis_thresh)
    for name, d in dets.items():
        for row in d:
            if row[4] >= args.vis_thresh:
                logger.info("%s %.3f @ (%.0f, %.0f, %.0f, %.0f)", name, row[4], *row[:4])
    save_image(args.out, draw_detections(im, dets, args.vis_thresh))
    logger.info("wrote %s", args.out)
    return dets


if __name__ == "__main__":
    main()
