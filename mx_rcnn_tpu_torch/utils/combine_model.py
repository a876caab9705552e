"""Params pickles (port of ``load_params`` and ``save_params`` in
``mx_rcnn_tpu/utils/combine_model.py``).

A params pickle is a Flax parameter tree of nested dicts; the port reads
one whose leaves are numpy arrays (``tools/test.py --params`` hands it to
``utils/bridge.py::flax_to_torch``).  ``combine_model``, which merges the
stage models of alternate training, is ROADMAP queue 1 item 14.
"""

from __future__ import annotations

import pickle
from typing import Dict


def save_params(path: str, params: Dict) -> None:
    with open(path, "wb") as f:
        pickle.dump(params, f, pickle.HIGHEST_PROTOCOL)


def load_params(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)
