"""Four-stage alternate training (port of
``mx_rcnn_tpu/tools/train_alternate.py``; Ren et al., NIPS 2015, the
reference's ``train_alternate.py``):

1. train RPN-1 (from the donor, else seeded random weights);
2. proposals of RPN-1 over the unflipped roidb (``proposals1.pkl``);
3. train Fast R-CNN-1 on them (from the donor);
4. train RPN-2 from Fast R-CNN-1's backbone, FIXED_PARAMS_SHARED frozen;
5. proposals of RPN-2 (``proposals2.pkl``), then train Fast R-CNN-2 from
   RPN-2's backbone, the shared convolutions frozen;
6. ``combine_model(RPN-2, Fast R-CNN-2)`` → the joint detector.

    python -m mx_rcnn_tpu_torch.tools.train_alternate --synthetic 8 \\
        --max_steps 10 --out_dir model/alternate

The stages are library calls that hand Flax-layout trees to each other in
memory; the artifacts are the JAX package's: ``rpn1/rcnn1/rpn2/rcnn2/
final.pkl``, ``proposals{1,2}.pkl`` and a ``run_meta.json`` with Fast
R-CNN-2's per-class statistics, which ``tools/test.py --params
<out_dir>/final.pkl`` applies.  Runs on the card; ``--cpu 1`` on the CPU.
``--pretrained CKPT`` imports a torchvision checkpoint's backbone and top
head as the donor of stages 1 and 3 (``utils/pretrained.py``) and sets the
torchvision pixel statistics.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict, Optional

from mx_rcnn_tpu_torch.config import Config, generate_config
from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.tools.test_rpn import test_rpn
from mx_rcnn_tpu_torch.tools.train_rcnn import train_rcnn
from mx_rcnn_tpu_torch.tools.train_rpn import (
    add_common_flags,
    add_train_flags,
    device_of,
    train_rpn,
    with_pretrained,
)
from mx_rcnn_tpu_torch.utils.combine_model import combine_model, save_params
from mx_rcnn_tpu_torch.utils.load_data import attach_proposals, load_gt_roidb
from mx_rcnn_tpu_torch.utils.run_meta import save_run_meta
from mx_rcnn_tpu_torch.utils.precision import full_float32

logger = logging.getLogger(__name__)


def alternate_train(
    cfg: Config,
    roidb,
    *,
    epochs_rpn: int = 8,
    epochs_rcnn: int = 8,
    pretrained_donor: Optional[Dict] = None,
    out_dir: str = "model/alternate",
    seed: int = 0,
    max_steps: int = 0,
    frequent: int = 20,
    device=None,
) -> Dict:
    """Run the four stages and the combine; returns the FasterRCNN tree.

    ``roidb`` is the unflipped filtered gt roidb (each training stage flips
    its own, after the proposals are attached).  ``max_steps`` caps each
    stage's steps, ``frequent`` is their logging interval."""
    os.makedirs(out_dir, exist_ok=True)

    def flipped(rdb):
        return IMDB.append_flipped_images(rdb) if cfg.TRAIN.FLIP else rdb

    common = dict(max_steps=max_steps, frequent=frequent, device=device)
    logger.info("=== stage 1: train RPN-1 ===")
    rpn1 = train_rpn(cfg, flipped(roidb), epochs=epochs_rpn, init_donor=pretrained_donor,
                     seed=seed, **common)
    save_params(os.path.join(out_dir, "rpn1.pkl"), rpn1)

    logger.info("=== stage 2: RPN-1 proposals ===")
    props1, rec1 = test_rpn(cfg, roidb, rpn1, dump_path=os.path.join(out_dir, "proposals1.pkl"),
                            device=device)

    logger.info("=== stage 3: train Fast R-CNN-1 ===")
    rcnn1, _ = train_rcnn(cfg, flipped(attach_proposals(roidb, props1)), epochs=epochs_rcnn,
                          init_donor=pretrained_donor, seed=seed + 1, **common)
    save_params(os.path.join(out_dir, "rcnn1.pkl"), rcnn1)

    logger.info("=== stage 4: train RPN-2 (shared convolutions frozen) ===")
    rpn2 = train_rpn(cfg, flipped(roidb), epochs=epochs_rpn, init_donor=rcnn1,
                     frozen_shared=True, seed=seed + 2, **common)
    save_params(os.path.join(out_dir, "rpn2.pkl"), rpn2)

    logger.info("=== stage 5: RPN-2 proposals, train Fast R-CNN-2 ===")
    props2, rec2 = test_rpn(cfg, roidb, rpn2, dump_path=os.path.join(out_dir, "proposals2.pkl"),
                            device=device)
    rcnn2, cfg_rcnn2 = train_rcnn(cfg, flipped(attach_proposals(roidb, props2)),
                                  epochs=epochs_rcnn, init_donor=rpn2, frozen_shared=True,
                                  seed=seed + 3, **common)
    save_params(os.path.join(out_dir, "rcnn2.pkl"), rcnn2)

    logger.info("=== stage 6: combine ===")
    final = combine_model(rpn2, rcnn2)
    save_params(os.path.join(out_dir, "final.pkl"), final)
    # evaluation must de-normalize with the statistics Fast R-CNN-2 trained
    # with: tools/test.py --params <out_dir>/final.pkl reads this sidecar
    save_run_meta(out_dir, cfg_rcnn2)
    logger.info("alternate training done; recalls stage 2 %s, stage 5 %s", rec1, rec2)
    return final


def main(argv=None) -> Dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", stream=sys.stdout)
    full_float32()
    p = argparse.ArgumentParser(description="4-stage alternate training (PyTorch port)")
    add_common_flags(p)
    add_train_flags(p, checkpoints=False)
    p.add_argument("--epochs_rpn", type=int, default=8)
    p.add_argument("--epochs_rcnn", type=int, default=8)
    p.add_argument("--out_dir", default="model/alternate")
    args = p.parse_args(argv)
    device = device_of(args)
    cfg, donor = with_pretrained(generate_config(args.network, args.dataset), args.pretrained)
    _, roidb = load_gt_roidb(cfg, args.image_set, flip=False, synthetic_size=args.synthetic)
    return alternate_train(cfg, roidb, epochs_rpn=args.epochs_rpn, epochs_rcnn=args.epochs_rcnn,
                           out_dir=args.out_dir, pretrained_donor=donor, seed=args.seed,
                           max_steps=args.max_steps, device=device)


if __name__ == "__main__":
    main()
