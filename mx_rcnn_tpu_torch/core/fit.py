"""The training loop: loader → train step → metrics (port of the core of
``mx_rcnn_tpu/core/fit.py``).

Synchronous: the next batch is assembled on the host after the step's
metrics came back.  Divergence recovery, the device feed, checkpoints and
resume are not ported yet.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.metrics import MetricTracker, Speedometer
from mx_rcnn_tpu_torch.core.tester import resolve_device
from mx_rcnn_tpu_torch.core.train import make_lr_schedule, make_optimizer, make_train_step
from mx_rcnn_tpu_torch.data.loader import TrainLoader
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch

logger = logging.getLogger(__name__)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict:
    """Host batch → device tensors; ``sample_seeds`` stay on the host (they
    seed the samplers' generators)."""
    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items() if k != "sample_seeds"}
    if "sample_seeds" in batch:
        out["sample_seeds"] = [int(s) for s in batch["sample_seeds"]]
    return out


def fit(
    model: nn.Module,
    cfg: Config,
    roidb: List[Dict],
    *,
    epochs: int,
    seed: int = 0,
    max_steps: int = 0,
    frequent: int = 20,
    device=None,
    init_params: Optional[Dict] = None,
) -> Dict:
    """Train ``model`` in place on ``device`` (default: the card, which must
    be present) and return ``{"steps": n, "history": [...]}``: one dict per
    step with the aux metrics, ``loss``, ``load_ms`` (host batch assembly)
    and ``step_ms`` (host clock from the host batch to the metrics back on
    the host, so it ends in a synchronisation).

    The model starts from its own weights (``init_weights``) or, with
    ``init_params``, from a Flax parameter tree (numpy leaves)."""
    dev = resolve_device(device)
    if init_params is not None:
        flax_to_torch(init_params, model)
    # channels_last: the NHWC images and pooled rois enter the convs as views
    model.to(dev, memory_format=torch.channels_last).train()
    loader = TrainLoader(roidb, cfg, cfg.TRAIN.BATCH_IMAGES, shuffle=cfg.TRAIN.SHUFFLE, seed=seed)
    optimizer = make_optimizer(cfg, model, make_lr_schedule(cfg, max(len(loader), 1)))
    step = make_train_step(model, optimizer, rng=seed + 123)
    tracker = MetricTracker()
    speedo = Speedometer(cfg.TRAIN.BATCH_IMAGES, frequent)

    history: List[Dict[str, float]] = []
    for epoch in range(epochs):
        batches = iter(loader)
        while not (max_steps and len(history) >= max_steps):
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t1 = time.perf_counter()
            _, aux = step(batch_to_device(batch, dev))
            # one device → host copy for all metrics
            vals = dict(zip(aux, torch.stack([v.float() for v in aux.values()]).tolist()))
            t2 = time.perf_counter()
            vals.update(load_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3)
            history.append(vals)
            tracker.update(vals)
            speedo(epoch, len(history), tracker)
        if max_steps and len(history) >= max_steps:
            break
    if history:
        logger.info("fit done: %d steps, last loss %.4f", len(history), history[-1]["loss"])
        if not math.isfinite(history[-1]["loss"]):
            logger.warning("fit finished with a non-finite loss")
    return {"steps": len(history), "history": history}
