"""Running metric aggregation and throughput logging (port of
``mx_rcnn_tpu/core/metrics.py``).

The metric values come from ``FasterRCNN.train_forward``'s aux dict (the
reference's six metric names); this module accumulates host scalars and logs
in the reference's Speedometer format.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, Iterable, Optional

logger = logging.getLogger(__name__)

METRIC_NAMES = (
    "RPNAcc",
    "RPNLogLoss",
    "RPNL1Loss",
    "RCNNAcc",
    "RCNNLogLoss",
    "RCNNL1Loss",
)


class MetricTracker:
    """Running means, reset per logging interval."""

    def __init__(self, names: Iterable[str] = METRIC_NAMES):
        self.names = tuple(names)
        self.reset()

    def reset(self) -> None:
        self._sums = {n: 0.0 for n in self.names}
        self._count = 0

    def update(self, aux: Dict[str, float]) -> None:
        for n in self.names:
            if n in aux:
                self._sums[n] += float(aux[n])
        self._count += 1

    def get(self) -> Dict[str, float]:
        c = max(self._count, 1)
        return {n: self._sums[n] / c for n in self.names}

    def format(self) -> str:
        return ",\t".join(f"{n}={v:.6f}" for n, v in self.get().items())


class Speedometer:
    """Images/s and the running metrics, logged every ``frequent`` steps.
    ``jsonl_path`` also appends one JSON line per log event, with the JAX
    package's keys (``time``, ``epoch``, ``step``, ``samples_per_sec`` and
    the metric names)."""

    def __init__(self, batch_size: int, frequent: int = 20, jsonl_path: Optional[str] = None):
        self.batch_size = batch_size
        self.frequent = frequent
        self.jsonl_path = jsonl_path
        self._tic = time.time()
        self._last = 0

    def __call__(self, epoch: int, step: int, tracker: MetricTracker) -> None:
        if step % self.frequent != 0 or step == self._last:
            return
        elapsed = time.time() - self._tic
        speed = self.frequent * self.batch_size / max(elapsed, 1e-9)
        logger.info(
            "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s",
            epoch, step, speed, tracker.format(),
        )
        if self.jsonl_path:
            rec = {
                "time": time.time(), "epoch": epoch, "step": step,
                "samples_per_sec": round(speed, 3),
                **{k: round(v, 6) for k, v in tracker.get().items()},
            }
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        tracker.reset()
        self._tic = time.time()
        self._last = step
