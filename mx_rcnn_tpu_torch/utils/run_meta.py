"""Run metadata sidecar: the config facts eval must reuse (port of
``mx_rcnn_tpu/utils/run_meta.py``).

A trained model is only decodable with the preprocessing and target
normalization it was trained with (PIXEL_MEANS/STDS and BBOX_MEANS/STDS).
The trainers write them to a ``run_meta.json`` next to their checkpoints
and params pickles; ``tools/test.py`` reads it and applies it to the
config.  The file is the JAX package's, key for key.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

from mx_rcnn_tpu_torch.config import Config

META_NAME = "run_meta.json"


def meta_path_for(prefix_or_file: str) -> str:
    """Checkpoint dir prefix → ``{prefix}/run_meta.json``; params pickle
    → sibling ``run_meta.json``."""
    if os.path.isdir(prefix_or_file) or not os.path.splitext(prefix_or_file)[1]:
        return os.path.join(prefix_or_file, META_NAME)
    return os.path.join(os.path.dirname(prefix_or_file) or ".", META_NAME)


def save_run_meta(prefix_or_file: str, cfg: Config) -> str:
    path = meta_path_for(prefix_or_file)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {
        "PIXEL_MEANS": list(cfg.network.PIXEL_MEANS),
        "PIXEL_STDS": list(cfg.network.PIXEL_STDS),
        "BBOX_MEANS": list(cfg.TRAIN.BBOX_MEANS),
        "BBOX_STDS": list(cfg.TRAIN.BBOX_STDS),
        "COMPUTE_DTYPE": cfg.network.COMPUTE_DTYPE,
    }
    if cfg.TRAIN.BBOX_STDS_PER_CLASS is not None:
        meta["BBOX_MEANS_PER_CLASS"] = [list(row) for row in cfg.TRAIN.BBOX_MEANS_PER_CLASS]
        meta["BBOX_STDS_PER_CLASS"] = [list(row) for row in cfg.TRAIN.BBOX_STDS_PER_CLASS]
    with open(path, "w") as f:
        json.dump(meta, f, indent=1)
    return path


def load_run_meta(prefix_or_file: str) -> Optional[Dict]:
    path = meta_path_for(prefix_or_file)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def apply_run_meta(cfg: Config, meta: Optional[Dict]) -> Config:
    """Override the eval-relevant fields from a loaded meta dict."""
    if not meta:
        return cfg
    net = dataclasses.replace(
        cfg.network,
        PIXEL_MEANS=tuple(meta["PIXEL_MEANS"]),
        PIXEL_STDS=tuple(meta["PIXEL_STDS"]),
    )
    train = dataclasses.replace(
        cfg.TRAIN,
        BBOX_MEANS=tuple(meta["BBOX_MEANS"]),
        BBOX_STDS=tuple(meta["BBOX_STDS"]),
        BBOX_MEANS_PER_CLASS=(
            tuple(tuple(r) for r in meta["BBOX_MEANS_PER_CLASS"])
            if "BBOX_MEANS_PER_CLASS" in meta else None
        ),
        BBOX_STDS_PER_CLASS=(
            tuple(tuple(r) for r in meta["BBOX_STDS_PER_CLASS"])
            if "BBOX_STDS_PER_CLASS" in meta else None
        ),
    )
    return cfg.replace(network=net, TRAIN=train)
