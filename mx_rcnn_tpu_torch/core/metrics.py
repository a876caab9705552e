"""Running metric aggregation and throughput logging (port of
``mx_rcnn_tpu/core/metrics.py``).

The metric values come from ``FasterRCNN.train_forward``'s aux dict (the
reference's six metric names); this module accumulates host scalars and logs
in the reference's Speedometer format.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterable

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
    """Images/s and the running metrics, logged every ``frequent`` steps."""

    def __init__(self, batch_size: int, frequent: int = 20):
        self.batch_size = batch_size
        self.frequent = frequent
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
        tracker.reset()
        self._tic = time.time()
        self._last = step
