"""Synthetic dataset: deterministic random images and boxes, no files (port
of ``mx_rcnn_tpu/data/synthetic.py``).

Images are colored shapes on noise, so a detector can learn them; the boxes
are the shapes' bounding boxes.  ``with_masks=True`` adds COCO-style polygon
``segmentation`` gts (ellipses, triangles, rectangles inscribed in each box)
and renders the polygon, not the box.  Records and pixels equal the JAX
package's for the same arguments; ``evaluate_detections`` scores box mAP
against them and, given ``all_masks``, the COCO segm protocol.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.eval.voc_eval import voc_eval


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


def shape_polygon(kind: str, box, t: float = 0.5) -> List[float]:
    """One polygon ([x1, y1, x2, y2, ...], continuous coordinates) of
    ``kind`` ("rect", "triangle" or "ellipse", a 24-gon) inscribed in
    ``box`` (inclusive pixel indices) with a tight bbox; ``t`` ∈ (0, 1) is
    the triangle apex's position."""
    x1, y1, x2, y2 = (float(v) for v in box[:4])
    # continuous extents: pixel p covers [p, p+1)
    cx2, cy2 = x2 + 1.0, y2 + 1.0
    if kind == "rect":
        return [x1, y1, cx2, y1, cx2, cy2, x1, cy2]
    if kind == "triangle":
        apex_x = x1 + t * (cx2 - x1)
        return [x1, cy2, cx2, cy2, apex_x, y1]
    mx, my = (x1 + cx2) / 2.0, (y1 + cy2) / 2.0
    rx, ry = (cx2 - x1) / 2.0, (cy2 - y1) / 2.0
    th = np.linspace(0.0, 2.0 * np.pi, 24, endpoint=False)
    pts = np.stack([mx + rx * np.cos(th), my + ry * np.sin(th)], axis=1)
    return pts.reshape(-1).tolist()


def synthetic_image(rec: Dict, seed: int) -> np.ndarray:
    """Render a record: noise background and filled class-colored shapes
    (each box, or its polygon where the record has ``segmentation``), from
    the record's own (possibly flipped) geometry."""
    rng = np.random.RandomState(seed)
    h, w = rec["height"], rec["width"]
    im = rng.rand(h, w, 3).astype(np.float32) * 60.0 + 90.0
    segms = rec.get("segmentation")
    for i, (box, cls) in enumerate(zip(rec["boxes"], rec["gt_classes"])):
        x1, y1, x2, y2 = box.astype(int)
        color = class_color(int(cls))
        block = color + rng.rand(y2 - y1 + 1, x2 - x1 + 1, 3).astype(np.float32) * 10.0
        if segms is None:
            im[y1 : y2 + 1, x1 : x2 + 1] = block
        else:
            from mx_rcnn_tpu_torch.native import rle

            m = rle.decode(rle.from_polygons(segms[i], h, w))[y1 : y2 + 1, x1 : x2 + 1].astype(bool)
            region = im[y1 : y2 + 1, x1 : x2 + 1]
            region[m] = block[m]
    return im


class SyntheticDataset(IMDB):
    def __init__(
        self,
        num_images: int = 32,
        num_classes: int = 21,
        image_size=(480, 640),
        max_boxes: int = 4,
        seed: int = 0,
        with_masks: bool = False,
    ):
        super().__init__(f"synthetic_{num_images}", root_path="/tmp")
        self.classes = ["__background__"] + [f"class{i}" for i in range(1, num_classes)]
        self.image_set_index = list(range(num_images))
        self.seed = seed
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.with_masks = with_masks

    def gt_roidb(self) -> List[Dict]:
        rng = np.random.RandomState(self.seed)
        h, w = self.image_size
        roidb = []
        for i in self.image_set_index:
            n = rng.randint(1, self.max_boxes + 1)
            boxes, classes, segms = [], [], []
            for _ in range(n):
                bw = rng.randint(60, w // 2)
                bh = rng.randint(60, h // 2)
                x1 = rng.randint(0, w - bw)
                y1 = rng.randint(0, h - bh)
                box = [x1, y1, x1 + bw - 1, y1 + bh - 1]
                boxes.append(box)
                classes.append(rng.randint(1, self.num_classes))
                if self.with_masks:
                    kind = ("ellipse", "triangle", "rect")[rng.randint(3)]
                    segms.append([shape_polygon(kind, box, t=rng.uniform(0.25, 0.75))])
            rec = {
                "image": f"synthetic://{i}",
                "height": h,
                "width": w,
                "boxes": np.asarray(boxes, np.float32),
                "gt_classes": np.asarray(classes, np.int32),
                "flipped": False,
                "synthetic_seed": self.seed + 1000 + i,
            }
            if self.with_masks:
                rec["segmentation"] = segms
            roidb.append(rec)
        return roidb

    def as_coco_dict(self) -> Dict:
        """The gt as a COCO instances dict (images, annotations with polygon
        segmentations, categories) for the segm protocol; a polygon gt's
        ``area`` is its mask's, as the protocol's area ranges want."""
        from mx_rcnn_tpu_torch.native import rle

        images, annotations = [], []
        ann_id = 1
        for i, rec in enumerate(self.gt_roidb()):
            images.append({"id": i, "height": rec["height"], "width": rec["width"]})
            segms = rec.get("segmentation")
            for j, (box, cls) in enumerate(zip(rec["boxes"], rec["gt_classes"])):
                x1, y1, x2, y2 = (float(v) for v in box)
                ann = {
                    "id": ann_id,
                    "image_id": i,
                    "category_id": int(cls),
                    "bbox": [x1, y1, x2 - x1 + 1.0, y2 - y1 + 1.0],
                    "area": (x2 - x1 + 1.0) * (y2 - y1 + 1.0),
                    "iscrowd": 0,
                }
                if segms is not None:
                    ann["segmentation"] = segms[j]
                    ann["area"] = rle.area(rle.from_polygons(segms[j], rec["height"], rec["width"]))
                annotations.append(ann)
                ann_id += 1
        return {
            "images": images,
            "annotations": annotations,
            "categories": [{"id": c, "name": self.classes[c]} for c in range(1, self.num_classes)],
        }

    def evaluate_detections(self, detections, all_masks=None, **kw):
        """VOC-style box mAP against the synthetic gt (integral metric):
        ``{"class<j>": AP, ..., "mAP": mean}``.  Classes absent from the gt
        have no AP and are skipped; a class with gt and no detections scores
        0.  With ``all_masks`` (``all_masks[cls][img]``: one RLE per
        detection, row for row) the COCO segm protocol's 12 stats are added
        under ``segm_*`` keys."""
        roidb = self.gt_roidb()
        annots = {
            i: {"boxes": r["boxes"], "gt_classes": r["gt_classes"]}
            for i, r in enumerate(roidb)
        }
        aps = {}
        for cls_idx in range(1, self.num_classes):
            if not any((r["gt_classes"] == cls_idx).any() for r in roidb):
                continue
            dets_by_img = {i: detections[cls_idx][i] for i in range(len(roidb))}
            _, _, ap = voc_eval(dets_by_img, annots, cls_idx, 0.5, False)
            aps[f"class{cls_idx}"] = ap
        vals = list(aps.values())
        aps["mAP"] = float(np.mean(vals)) if vals else 0.0

        if all_masks is not None:
            from mx_rcnn_tpu_torch.eval.coco_eval import COCOEvalBbox

            results = []
            for cls_idx in range(1, self.num_classes):
                for i in range(len(roidb)):
                    dets = np.asarray(detections[cls_idx][i]).reshape(-1, 5)
                    for d, (x1, y1, x2, y2, score) in enumerate(dets):
                        results.append({
                            "image_id": i,
                            "category_id": cls_idx,
                            "bbox": [float(x1), float(y1), float(x2 - x1 + 1), float(y2 - y1 + 1)],
                            "score": float(score),
                            "segmentation": all_masks[cls_idx][i][d],
                        })
            segm_stats = COCOEvalBbox(self.as_coco_dict(), results,
                                      iou_type="segm").evaluate(verbose=False)
            aps.update({f"segm_{k}": v for k, v in segm_stats.items()})
        return aps
