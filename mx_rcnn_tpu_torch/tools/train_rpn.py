"""Stage tool: RPN-only training (port of ``mx_rcnn_tpu/tools/train_rpn.py``;
reference ``rcnn/tools/train_rpn.py``), alone or as stages 1 and 4 of
``tools/train_alternate.py``.

    python -m mx_rcnn_tpu_torch.tools.train_rpn --synthetic 8 --epochs 1 \\
        --out model/rpn.pkl

Trains :class:`~mx_rcnn_tpu_torch.models.stage_models.RPNOnly` through
``core/fit.py::fit`` on the gt roidb (with flipped copies under TRAIN.FLIP)
and writes its Flax-layout parameter tree ``{backbone, rpn}`` (numpy
leaves, ``utils/bridge.py::torch_to_flax``) to ``--out`` with a
``run_meta.json`` beside it.  Runs on the card; ``--cpu 1`` runs the plain
PyTorch versions of the kernels on the CPU.  ``--prefix``, ``--resume`` and
``--stream_log`` are ``fit``'s checkpoints, resume and batch digests.  The
weights start seeded random (``--seed``); ``--pretrained CKPT`` seeds the
backbone from a torchvision checkpoint (``utils/pretrained.py``) and sets
the torchvision pixel statistics, which the ``run_meta.json`` records.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Dict, Optional, Tuple

import torch

from mx_rcnn_tpu_torch.config import Config, generate_config
from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.models.stage_models import RPNOnly
from mx_rcnn_tpu_torch.utils.bridge import torch_to_flax
from mx_rcnn_tpu_torch.utils.combine_model import save_params
from mx_rcnn_tpu_torch.utils.load_data import load_gt_roidb
from mx_rcnn_tpu_torch.utils.pretrained import (
    import_tree,
    load_state_dict,
    torchvision_pixel_stats,
)
from mx_rcnn_tpu_torch.utils.run_meta import save_run_meta
from mx_rcnn_tpu_torch.utils.precision import full_float32

logger = logging.getLogger(__name__)

NETWORKS = ["vgg", "resnet", "resnet50", "resnet152"]
DATASETS = ["PascalVOC", "PascalVOC0712", "coco"]


def train_rpn(
    cfg: Config,
    roidb,
    *,
    epochs: int,
    init_donor: Optional[Dict] = None,
    frozen_shared: bool = False,
    seed: int = 0,
    max_steps: int = 0,
    frequent: int = 20,
    prefix: Optional[str] = None,
    resume: bool = False,
    stream_log: Optional[str] = None,
    device=None,
    report: Optional[Dict] = None,
) -> Dict:
    """Train an RPN; returns its Flax-layout tree ``{backbone, rpn}``.

    ``init_donor``: a tree whose shared subtrees seed the init.
    ``frozen_shared`` freezes FIXED_PARAMS_SHARED (stage 4: the shared
    convolutions stay the donor's).  ``report``, if given, receives
    ``fit``'s result."""
    fixed = cfg.network.FIXED_PARAMS_SHARED if frozen_shared else None
    model = RPNOnly(cfg, generator=torch.Generator().manual_seed(seed))
    out = fit(model, cfg, roidb, epochs=epochs, seed=seed, init_donor=init_donor,
              fixed_params=fixed, max_steps=max_steps, frequent=frequent, prefix=prefix,
              resume=resume, stream_log=stream_log, device=device)
    if report is not None:
        report.update(out)
    return torch_to_flax(model)


def add_common_flags(p: argparse.ArgumentParser) -> None:
    """The flags every stage CLI takes, as the JAX package's do."""
    p.add_argument("--network", default="resnet", choices=NETWORKS)
    p.add_argument("--dataset", default="PascalVOC", choices=DATASETS)
    p.add_argument("--image_set", default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="N synthetic images (no dataset needed)")
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="run on the CPU (the plain versions of the kernels) instead of the "
                        "card; one device at any N, as the JAX stage CLIs")


def add_train_flags(p: argparse.ArgumentParser, checkpoints: bool = True) -> None:
    """The training flags; ``checkpoints``: a single stage's ``--prefix``,
    ``--resume`` and ``--stream_log`` (the alternate CLI has none)."""
    p.add_argument("--pretrained", default=None, metavar="CKPT",
                   help="torchvision checkpoint (.pth/.pt/.npz/pickle) for the backbone and "
                        "top head; sets the torchvision pixel statistics")
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    if not checkpoints:
        return
    p.add_argument("--prefix", default=None,
                   help="checkpoint dir (enables preemption-safe saves)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint under --prefix")
    p.add_argument("--stream_log", default=None,
                   help="append per-batch digests here (resume audits)")


def device_of(args) -> Optional[str]:
    """The device a stage CLI runs on: the CPU under ``--cpu N`` for any N
    (the JAX stage CLIs build no mesh and train on one device), else the
    card."""
    return "cpu" if args.cpu else None


def with_pretrained(cfg: Config, path: Optional[str]) -> Tuple[Config, Optional[Dict]]:
    """``--pretrained``: (the config with the torchvision pixel statistics,
    the imported ``{backbone, top_head}`` tree as an init donor); without
    it (``cfg``, None), as the JAX stage CLIs."""
    if not path:
        return cfg, None
    means, stds = torchvision_pixel_stats()
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, PIXEL_MEANS=means,
                                                  PIXEL_STDS=stds))
    logger.info("importing pretrained %s from %s", cfg.network.name, path)
    return cfg, import_tree(load_state_dict(path), cfg.network.name, cfg.network.depth)


def main(argv=None) -> Dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", stream=sys.stdout)
    full_float32()
    p = argparse.ArgumentParser(description="Train RPN only (PyTorch port)")
    add_common_flags(p)
    add_train_flags(p)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--out", default="model/rpn_params.pkl")
    args = p.parse_args(argv)
    device = device_of(args)
    cfg, donor = with_pretrained(generate_config(args.network, args.dataset), args.pretrained)
    _, roidb = load_gt_roidb(cfg, args.image_set, flip=cfg.TRAIN.FLIP,
                             synthetic_size=args.synthetic)
    params = train_rpn(cfg, roidb, epochs=args.epochs, init_donor=donor, seed=args.seed,
                       max_steps=args.max_steps, prefix=args.prefix, resume=args.resume,
                       stream_log=args.stream_log, device=device)
    save_params(args.out, params)
    save_run_meta(args.out, cfg)
    logger.info("saved RPN params -> %s", args.out)
    return params


if __name__ == "__main__":
    main()
