"""Stage tool: Fast R-CNN training on dumped proposals (port of
``mx_rcnn_tpu/tools/train_rcnn.py``; reference ``rcnn/tools/train_rcnn.py``),
alone or as stages 3 and 5 of ``tools/train_alternate.py``.

    python -m mx_rcnn_tpu_torch.tools.train_rcnn --synthetic 8 \\
        --proposals model/proposals.pkl --init model/rpn.pkl --out model/rcnn.pkl

Attaches the ``.pkl`` dump (``tools/test_rpn.py``, of either package) to the
unflipped gt roidb, then flips (the flip mirrors the proposals), computes
the per-class regression target statistics of the proposal roidb into the
config (``utils/bbox_stats.py::compute_bbox_stats``) and trains
:class:`~mx_rcnn_tpu_torch.models.stage_models.FastRCNN` through
``core/fit.py::fit`` on batches padded to TRAIN.RPN_POST_NMS_TOP_N
proposals.  ``--init`` seeds the shared subtrees from a params pickle (and
applies its ``run_meta.json``).  Writes the tree ``{backbone, top_head,
rcnn}`` to ``--out`` and a ``run_meta.json`` with the statistics beside
it.  Runs on the card; ``--cpu 1`` on the CPU; ``--pretrained`` raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Dict, List, Optional, Tuple

import torch

from mx_rcnn_tpu_torch.config import Config, generate_config
from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.models.stage_models import FastRCNN
from mx_rcnn_tpu_torch.tools.train_rpn import add_common_flags, add_train_flags, device_of
from mx_rcnn_tpu_torch.utils.bbox_stats import compute_bbox_stats
from mx_rcnn_tpu_torch.utils.bridge import torch_to_flax
from mx_rcnn_tpu_torch.utils.combine_model import load_params, save_params
from mx_rcnn_tpu_torch.utils.load_data import load_gt_roidb, load_proposal_roidb
from mx_rcnn_tpu_torch.utils.run_meta import apply_run_meta, load_run_meta, save_run_meta
from mx_rcnn_tpu_torch.utils.precision import full_float32

logger = logging.getLogger(__name__)


def train_rcnn(
    cfg: Config,
    proposal_roidb: List[Dict],
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
) -> Tuple[Dict, Config]:
    """Train Fast R-CNN on a proposal roidb → (its Flax-layout tree
    ``{backbone, top_head, rcnn}``, the config it trained with).

    Under TRAIN.BBOX_NORMALIZATION_PRECOMPUTED that config carries the
    roidb's per-class BBOX_MEANS/STDS tables (the reference's
    ``add_bbox_regression_targets``), which evaluation needs to
    de-normalize the deltas.  ``init_donor``, ``frozen_shared`` and
    ``report`` as in ``train_rpn``."""
    if cfg.TRAIN.BBOX_NORMALIZATION_PRECOMPUTED:
        means, stds = compute_bbox_stats(proposal_roidb, cfg, per_class=True)
        logger.info("per-class bbox target stats: fg classes=%d",
                    sum(1 for row in stds if tuple(row) != tuple(cfg.TRAIN.BBOX_STDS)))
        cfg = cfg.replace(TRAIN=dataclasses.replace(
            cfg.TRAIN, BBOX_MEANS_PER_CLASS=means, BBOX_STDS_PER_CLASS=stds))
    fixed = cfg.network.FIXED_PARAMS_SHARED if frozen_shared else None
    model = FastRCNN(cfg, generator=torch.Generator().manual_seed(seed))
    out = fit(model, cfg, proposal_roidb, epochs=epochs, seed=seed, init_donor=init_donor,
              fixed_params=fixed, max_steps=max_steps, frequent=frequent,
              proposal_count=cfg.TRAIN.RPN_POST_NMS_TOP_N, prefix=prefix, resume=resume,
              stream_log=stream_log, device=device)
    if report is not None:
        report.update(out)
    return torch_to_flax(model), cfg


def main(argv=None) -> Tuple[Dict, Config]:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", stream=sys.stdout)
    full_float32()
    p = argparse.ArgumentParser(description="Train Fast R-CNN on proposals (PyTorch port)")
    add_common_flags(p)
    add_train_flags(p)
    p.add_argument("--proposals", required=True, help="proposal .pkl dump")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--out", default="model/rcnn_params.pkl")
    p.add_argument("--init", default=None, help="donor params pickle")
    args = p.parse_args(argv)
    device = device_of(args)
    cfg = generate_config(args.network, args.dataset)
    if args.init:
        # the donor's preprocessing stats
        meta = load_run_meta(args.init)
        if meta:
            cfg = apply_run_meta(cfg, meta)
            logger.info("applied run_meta overrides from %s", args.init)
    # the dump aligns with the unflipped filtered roidb: attach, then flip
    _, roidb = load_gt_roidb(cfg, args.image_set, flip=False, synthetic_size=args.synthetic)
    roidb = load_proposal_roidb(roidb, args.proposals)
    if cfg.TRAIN.FLIP:
        roidb = IMDB.append_flipped_images(roidb)
    donor = load_params(args.init) if args.init else None
    params, cfg_used = train_rcnn(
        cfg, roidb, epochs=args.epochs, init_donor=donor, seed=args.seed,
        max_steps=args.max_steps, prefix=args.prefix, resume=args.resume,
        stream_log=args.stream_log, device=device,
    )
    save_params(args.out, params)
    save_run_meta(args.out, cfg_used)
    logger.info("saved RCNN params -> %s", args.out)
    return params, cfg_used


if __name__ == "__main__":
    main()
