"""Synthetic dataset: deterministic random images and boxes, no files (the
box-only path of ``mx_rcnn_tpu/data/synthetic.py``).

Images are colored rectangles on noise, so a detector can learn them; the
boxes are the rectangles.  Records and pixels equal the JAX package's for the
same arguments.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from mx_rcnn_tpu_torch.data.imdb import IMDB


def class_color(cls: int) -> np.ndarray:
    """Saturated class color, golden-ratio hue spacing: distinct from the
    90–150 gray noise background and from every other class."""
    hue = ((cls - 1) * 0.61803398875) % 1.0
    i = int(hue * 6.0)
    f = hue * 6.0 - i
    v, s = 235.0, 0.85
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    rgb = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i % 6]
    return np.asarray(rgb, np.float32)


def synthetic_image(rec: Dict, seed: int) -> np.ndarray:
    """Render a record: noise background and filled class-colored boxes,
    from the record's own (possibly flipped) geometry."""
    if rec.get("segmentation") is not None:
        raise NotImplementedError("polygon (mask) records are not ported")
    rng = np.random.RandomState(seed)
    h, w = rec["height"], rec["width"]
    im = rng.rand(h, w, 3).astype(np.float32) * 60.0 + 90.0
    for box, cls in zip(rec["boxes"], rec["gt_classes"]):
        x1, y1, x2, y2 = box.astype(int)
        color = class_color(int(cls))
        im[y1 : y2 + 1, x1 : x2 + 1] = (
            color + rng.rand(y2 - y1 + 1, x2 - x1 + 1, 3).astype(np.float32) * 10.0
        )
    return im


class SyntheticDataset(IMDB):
    def __init__(
        self,
        num_images: int = 32,
        num_classes: int = 21,
        image_size=(480, 640),
        max_boxes: int = 4,
        seed: int = 0,
    ):
        super().__init__()
        self.classes = ["__background__"] + [f"class{i}" for i in range(1, num_classes)]
        self.image_set_index = list(range(num_images))
        self.seed = seed
        self.image_size = image_size
        self.max_boxes = max_boxes

    def gt_roidb(self) -> List[Dict]:
        rng = np.random.RandomState(self.seed)
        h, w = self.image_size
        roidb = []
        for i in self.image_set_index:
            n = rng.randint(1, self.max_boxes + 1)
            boxes, classes = [], []
            for _ in range(n):
                bw = rng.randint(60, w // 2)
                bh = rng.randint(60, h // 2)
                x1 = rng.randint(0, w - bw)
                y1 = rng.randint(0, h - bh)
                boxes.append([x1, y1, x1 + bw - 1, y1 + bh - 1])
                classes.append(rng.randint(1, self.num_classes))
            roidb.append({
                "image": f"synthetic://{i}",
                "height": h,
                "width": w,
                "boxes": np.asarray(boxes, np.float32),
                "gt_classes": np.asarray(classes, np.int32),
                "flipped": False,
                "synthetic_seed": self.seed + 1000 + i,
            })
        return roidb
