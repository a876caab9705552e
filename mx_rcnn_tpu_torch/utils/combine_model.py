"""Params pickles and the merge of alternate training's stage models (port
of ``mx_rcnn_tpu/utils/combine_model.py``; reference
``rcnn/utils/combine_model.py``).

A params pickle is a Flax parameter tree of nested dicts with numpy leaves
(``utils/bridge.py::torch_to_flax`` writes one, ``flax_to_torch`` reads
one), so the JAX package and the port read each other's.  After alternate
training the joint detector takes the shared convolutions and the RPN head
from the second RPN stage and the RCNN head from the second Fast R-CNN
stage (their shared convolutions are equal: that stage freezes
FIXED_PARAMS_SHARED).
"""

from __future__ import annotations

import pickle
from typing import Dict


def combine_model(rpn_params: Dict, rcnn_params: Dict) -> Dict:
    """RPNOnly tree {backbone, rpn} + FastRCNN tree {backbone, top_head,
    rcnn} → FasterRCNN tree {backbone, rpn, top_head, rcnn}.  The backbone
    is the RPN's: the proposals the RCNN trained on came from it."""
    return {
        "backbone": rpn_params["backbone"],
        "rpn": rpn_params["rpn"],
        "top_head": rcnn_params["top_head"],
        "rcnn": rcnn_params["rcnn"],
    }


def save_params(path: str, params: Dict) -> None:
    with open(path, "wb") as f:
        pickle.dump(params, f, pickle.HIGHEST_PROTOCOL)


def load_params(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)
