"""Dataset base and the roidb record format (the part of
``mx_rcnn_tpu/data/imdb.py`` the synthetic training path uses).

A roidb record holds ``image`` (a path or ``synthetic://<i>``), ``height``,
``width``, ``boxes`` (n, 4) float32 inclusive pixel corners, ``gt_classes``
(n,) int32 and ``flipped``.
"""

from __future__ import annotations

from typing import Dict, List


class IMDB:
    def __init__(self):
        self.classes: List[str] = []
        self.image_set_index: List = []

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def gt_roidb(self) -> List[Dict]:
        raise NotImplementedError

    @staticmethod
    def append_flipped_images(roidb: List[Dict]) -> List[Dict]:
        """The roidb followed by x-flipped copies of its records."""
        flipped = []
        for rec in roidb:
            boxes = rec["boxes"].copy()
            if len(boxes):
                oldx1 = boxes[:, 0].copy()
                oldx2 = boxes[:, 2].copy()
                boxes[:, 0] = rec["width"] - oldx2 - 1
                boxes[:, 2] = rec["width"] - oldx1 - 1
                if not (boxes[:, 2] >= boxes[:, 0]).all():
                    raise ValueError(f"flipping {rec['image']} inverted a box")
            flipped.append(dict(rec, boxes=boxes, flipped=True))
        return list(roidb) + flipped


def filter_roidb(roidb: List[Dict]) -> List[Dict]:
    """Drop records without any gt box."""
    return [r for r in roidb if len(r["boxes"]) > 0]
