"""Stage tool: RPN proposals over a dataset and their recall (port of
``mx_rcnn_tpu/tools/test_rpn.py``; reference ``rcnn/tools/test_rpn.py``).

    python -m mx_rcnn_tpu_torch.tools.test_rpn --synthetic 8 \\
        --params model/rpn.pkl --dump model/proposals.pkl

Runs :class:`~mx_rcnn_tpu_torch.models.stage_models.RPNOnly`'s test
forward over the unflipped gt roidb with the TEST.PROPOSAL_* budgets
(20000 → 2000 at IoU 0.7), dumps the proposals (``core/tester.py::
generate_proposals``: one (n, 5) array per image in original image
coordinates) and logs recall@300/1000/2000.  Runs on the card; ``--cpu 1``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from mx_rcnn_tpu_torch.config import Config, generate_config
from mx_rcnn_tpu_torch.core.tester import Predictor, generate_proposals
from mx_rcnn_tpu_torch.data.loader import TestLoader
from mx_rcnn_tpu_torch.eval.recall import proposal_recall
from mx_rcnn_tpu_torch.models.stage_models import RPNOnly
from mx_rcnn_tpu_torch.tools.train_rpn import add_common_flags, device_of
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch
from mx_rcnn_tpu_torch.utils.combine_model import load_params
from mx_rcnn_tpu_torch.utils.load_data import load_gt_roidb
from mx_rcnn_tpu_torch.utils.precision import full_float32

logger = logging.getLogger(__name__)


def proposal_cfg(cfg: Config) -> Config:
    """The config with the proposal dump's budgets as the test budgets:
    TEST.PROPOSAL_PRE_NMS_TOP_N → RPN_PRE_NMS_TOP_N, and so on."""
    te = cfg.TEST
    return cfg.replace(TEST=dataclasses.replace(
        te, RPN_PRE_NMS_TOP_N=te.PROPOSAL_PRE_NMS_TOP_N,
        RPN_POST_NMS_TOP_N=te.PROPOSAL_POST_NMS_TOP_N, RPN_NMS_THRESH=te.PROPOSAL_NMS))


def test_rpn(
    cfg: Config,
    roidb: List[Dict],
    rpn_params: Dict,
    dump_path: Optional[str] = None,
    device=None,
) -> Tuple[List[np.ndarray], Dict[str, float]]:
    """Proposals of the RPN tree ``rpn_params`` over ``roidb`` (optionally
    dumped to ``dump_path``) and their recall against the gt boxes →
    (proposals, recalls).  The budgets are TEST.PROPOSAL_* (post-NMS 2000,
    the reference's dump settings), not the detection budget of 300: Fast
    R-CNN trains on this pool and pads its batches to
    TRAIN.RPN_POST_NMS_TOP_N."""
    dump_cfg = proposal_cfg(cfg)
    model = flax_to_torch(rpn_params, RPNOnly(dump_cfg))
    predictor = Predictor(model, device=device)
    proposals = generate_proposals(predictor, TestLoader(roidb, dump_cfg), dump_cfg,
                                   dump_path=dump_path)
    post = cfg.TEST.PROPOSAL_POST_NMS_TOP_N
    budgets = [n for n in (300, 1000, 2000) if n <= post] or [post]
    recalls = proposal_recall(proposals, roidb, top_ns=budgets)
    for k, v in recalls.items():
        logger.info("%s = %.4f", k, v)
    return proposals, recalls


def main(argv=None) -> Tuple[List[np.ndarray], Dict[str, float]]:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", stream=sys.stdout)
    full_float32()
    p = argparse.ArgumentParser(description="RPN proposal dump + recall eval (PyTorch port)")
    add_common_flags(p)
    p.add_argument("--params", required=True, help="RPN params pickle")
    p.add_argument("--dump", default=None, help="proposal .pkl output")
    args = p.parse_args(argv)
    device = device_of(args)
    cfg = generate_config(args.network, args.dataset)
    _, roidb = load_gt_roidb(cfg, args.image_set, flip=False, synthetic_size=args.synthetic)
    return test_rpn(cfg, roidb, load_params(args.params), dump_path=args.dump, device=device)


if __name__ == "__main__":
    main()
