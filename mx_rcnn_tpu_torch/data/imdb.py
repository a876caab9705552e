"""Dataset base and the roidb record format (port of
``mx_rcnn_tpu/data/imdb.py``).

A roidb record holds ``image`` (a path or ``synthetic://<i>``), ``height``,
``width``, ``boxes`` (n, 4) float32 inclusive pixel corners, ``gt_classes``
(n,) int32 and ``flipped``, and optionally ``segmentation`` (one entry per
box: polygons, an RLE dict or None; ``data/masks.py``) and ``proposals``
(m, 4).  An IMDB has a name, a root path whose
``cache/`` holds pickled roidbs (``{name}_{tag}.pkl``), classes, an image
index and ``evaluate_detections(detections)`` with ``detections[cls][img]``
an (n, 5) [x1, y1, x2, y2, score] array.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

from mx_rcnn_tpu_torch.data.masks import flip_segmentations


class IMDB:
    def __init__(self, name: str, root_path: str):
        self.name = name
        self.root_path = root_path
        self.classes: List[str] = []
        self.image_set_index: List = []

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def num_images(self) -> int:
        return len(self.image_set_index)

    @property
    def cache_path(self) -> str:
        path = os.path.join(self.root_path, "cache")
        os.makedirs(path, exist_ok=True)
        return path

    def gt_roidb(self) -> List[Dict]:
        raise NotImplementedError

    def load_cached(self, tag: str, build_fn):
        """``build_fn()``, pickled to ``cache/{name}_{tag}.pkl`` and read
        from there when the file exists."""
        cache_file = os.path.join(self.cache_path, f"{self.name}_{tag}.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as f:
                return pickle.load(f)
        data = build_fn()
        with open(cache_file, "wb") as f:
            pickle.dump(data, f, pickle.HIGHEST_PROTOCOL)
        return data

    def evaluate_detections(self, detections, **kwargs):
        """``detections[cls][img]`` = (n, 5) [x1, y1, x2, y2, score]."""
        raise NotImplementedError

    @staticmethod
    def append_flipped_images(roidb: List[Dict]) -> List[Dict]:
        """The roidb followed by x-flipped copies of its records: boxes,
        ``segmentation`` (``data/masks.py::flip_segmentations``) and
        ``proposals``, where a record has them."""
        flipped = []
        for rec in roidb:
            boxes = _flip_boxes(rec["boxes"], rec["width"])
            if len(boxes) and not (boxes[:, 2] >= boxes[:, 0]).all():
                raise ValueError(f"flipping {rec['image']} inverted a box")
            new_rec = dict(rec, boxes=boxes, flipped=True)
            if rec.get("segmentation") is not None:
                new_rec["segmentation"] = flip_segmentations(rec["segmentation"], rec["width"])
            if "proposals" in rec and len(rec["proposals"]):
                new_rec["proposals"] = _flip_boxes(rec["proposals"], rec["width"])
            flipped.append(new_rec)
        return list(roidb) + flipped


def _flip_boxes(boxes, width: int):
    """x-flip (n, ≥4) inclusive-pixel boxes in an image ``width`` wide."""
    boxes = boxes.copy()
    if len(boxes):
        oldx1 = boxes[:, 0].copy()
        oldx2 = boxes[:, 2].copy()
        boxes[:, 0] = width - oldx2 - 1
        boxes[:, 2] = width - oldx1 - 1
    return boxes


def filter_roidb(roidb: List[Dict]) -> List[Dict]:
    """Drop records without any gt box."""
    return [r for r in roidb if len(r["boxes"]) > 0]


def merge_roidbs(roidbs: List[List[Dict]]) -> List[Dict]:
    """Concatenate the roidbs of several image sets (07+12 training)."""
    out: List[Dict] = []
    for r in roidbs:
        out.extend(r)
    return out
