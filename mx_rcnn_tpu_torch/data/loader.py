"""Train batches: roidb → padded numpy batches (the synchronous core of
``mx_rcnn_tpu/data/loader.py``).

Images are resized into shape buckets and gt boxes padded to MAX_GT_BOXES;
anchor targets and roi sampling happen in the model.  Batches are drawn
from one orientation bucket at a time (the reference's aspect grouping), in
a plan that depends only on (seed, epoch), so the batch order equals the
JAX loader's for the same seed.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.data.image import prepare_image
from mx_rcnn_tpu_torch.data.synthetic import synthetic_image


def load_record_image(rec: Dict) -> np.ndarray:
    """The record's RGB float32 pixels.  Synthetic records render from their
    own (already flipped) geometry; image files need a decoder, which the
    port does not have yet."""
    if str(rec["image"]).startswith("synthetic://"):
        return synthetic_image(rec, rec["synthetic_seed"])
    raise NotImplementedError(f"{rec['image']}: only synthetic records are ported")


def make_batch(
    records: Sequence[Dict],
    cfg: Config,
    bucket: Tuple[int, int],
    seeds: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """One padded train batch: normalized images in ``bucket``, im_info,
    gt boxes scaled by the resize factor and padded to MAX_GT_BOXES, and,
    with ``seeds``, the per-image sampling seeds."""
    target, max_size = cfg.dataset.SCALES[0]
    g = cfg.dataset.MAX_GT_BOXES
    n = len(records)
    bh, bw = bucket
    out_images = np.zeros((n, bh, bw, 3), np.float32)
    im_info = np.zeros((n, 3), np.float32)
    gt_boxes = np.zeros((n, g, 5), np.float32)
    gt_valid = np.zeros((n, g), bool)
    for i, rec in enumerate(records):
        padded, info = prepare_image(
            load_record_image(rec), target, max_size, cfg.network.PIXEL_MEANS,
            cfg.network.PIXEL_STDS, [bucket],
        )
        out_images[i] = padded
        im_info[i] = info
        boxes = rec["boxes"] * info[2]
        k = min(len(boxes), g)
        gt_boxes[i, :k, :4] = boxes[:k]
        gt_boxes[i, :k, 4] = rec["gt_classes"][:k]
        gt_valid[i, :k] = True
    out = {"images": out_images, "im_info": im_info, "gt_boxes": gt_boxes, "gt_valid": gt_valid}
    if seeds is not None:
        out["sample_seeds"] = np.asarray(seeds, np.int32)
    return out


def _orientation_bucket(rec: Dict, buckets) -> Tuple[int, int]:
    """The bucket a record lands in after the resize (h ≤ w → wide)."""
    wide = rec["width"] >= rec["height"]
    for b in buckets:
        if (b[1] >= b[0]) == wide:
            return tuple(b)
    return tuple(buckets[0])


class TrainLoader:
    """Shuffled, orientation-grouped, bucket-padded batches, built on the
    caller's thread.  ``epoch`` advances at each ``iter()``."""

    def __init__(self, roidb: List[Dict], cfg: Config, batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        self.roidb = roidb
        self.cfg = cfg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.roidb) // self.batch_size

    def _epoch_plan(self, epoch: int) -> List[Tuple[Tuple[int, int], List[int]]]:
        """Group indices by orientation bucket, shuffle within groups, emit
        whole batches (the ragged tail of each group is dropped), then
        shuffle the batches."""
        rng = np.random.RandomState(self.seed + epoch)
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, rec in enumerate(self.roidb):
            groups.setdefault(_orientation_bucket(rec, self.cfg.SHAPE_BUCKETS), []).append(i)
        plan = []
        for b, idxs in groups.items():
            idxs = np.asarray(idxs)
            if self.shuffle:
                rng.shuffle(idxs)
            for s in range(0, len(idxs) - self.batch_size + 1, self.batch_size):
                plan.append((b, idxs[s : s + self.batch_size].tolist()))
        if self.shuffle:
            order = rng.permutation(len(plan))
            plan = [plan[i] for i in order]
        return plan

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        plan = self._epoch_plan(self.epoch)
        self.epoch += 1
        return (
            make_batch([self.roidb[i] for i in idxs], self.cfg, bucket, seeds=idxs)
            for bucket, idxs in plan
        )
