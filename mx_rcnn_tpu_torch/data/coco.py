"""MS COCO instances reader (port of ``mx_rcnn_tpu/data/coco.py``): the
annotations through the standard library's JSON parser (no pycocotools);
the JPEG files are read by ``data/loader.py::load_record_image`` with the
port's decoder.

Crowd regions (``iscrowd`` 1) are left out of the training roidb and are
ignore regions in evaluation, as upstream.  ``evaluate_detections`` runs the
12-statistic bbox protocol and, given masks, the segm protocol through
``eval/coco_eval.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.eval.coco_eval import COCOEvalBbox


class COCO(IMDB):
    """``image_set`` like 'train2017' / 'val2017'; the instances JSON is
    ``{data_path}/annotations/instances_{image_set}.json``."""

    def __init__(self, image_set: str, root_path: str, data_path: str):
        super().__init__(f"coco_{image_set}", root_path)
        self.image_set = image_set
        self.data_path = data_path
        ann_file = os.path.join(data_path, "annotations", f"instances_{image_set}.json")
        with open(ann_file) as f:
            self._dataset = json.load(f)

        cats = sorted(self._dataset["categories"], key=lambda c: c["id"])
        self.classes = ["__background__"] + [c["name"] for c in cats]
        self._cat_id_to_class = {c["id"]: i + 1 for i, c in enumerate(cats)}
        self._class_to_cat_id = {v: k for k, v in self._cat_id_to_class.items()}

        self._images = {im["id"]: im for im in self._dataset["images"]}
        self.image_set_index = sorted(self._images.keys())
        self._anns_by_image: Dict[int, List[dict]] = {i: [] for i in self._images}
        for ann in self._dataset["annotations"]:
            if ann["image_id"] in self._anns_by_image:
                self._anns_by_image[ann["image_id"]].append(ann)

    def image_path(self, index: int) -> str:
        return os.path.join(self.data_path, self.image_set, self._images[index]["file_name"])

    def _load_annotation(self, index: int) -> Dict:
        im = self._images[index]
        width, height = im["width"], im["height"]
        boxes, classes, segms = [], [], []
        for ann in self._anns_by_image[index]:
            if ann.get("iscrowd", 0):
                continue
            # xywh → clipped inclusive x1y1x2y2, as the reference reader
            x, y, w, h = ann["bbox"]
            x1 = max(0.0, x)
            y1 = max(0.0, y)
            x2 = min(width - 1.0, x1 + max(0.0, w - 1.0))
            y2 = min(height - 1.0, y1 + max(0.0, h - 1.0))
            if ann.get("area", 1) > 0 and x2 >= x1 and y2 >= y1:
                boxes.append([x1, y1, x2, y2])
                classes.append(self._cat_id_to_class[ann["category_id"]])
                # polygons (a list) or an RLE dict; absent, empty or malformed
                # → None, which trains as the box's rectangle
                segm = ann.get("segmentation")
                if not (isinstance(segm, (list, dict)) and segm):
                    segm = None
                segms.append(segm)
        return {
            "image": self.image_path(index),
            "height": height,
            "width": width,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "gt_classes": np.asarray(classes, np.int32),
            "segmentation": segms,
            "flipped": False,
        }

    def gt_roidb(self) -> List[Dict]:
        return self.load_cached(
            "gt_roidb", lambda: [self._load_annotation(ix) for ix in self.image_set_index])

    def evaluate_detections(self, detections, save_json: Optional[str] = None, all_masks=None):
        """``detections[cls][img]`` = (n, 5) → the 12 COCO bbox statistics
        (mAP@[.5:.95] under ``AP``); with ``all_masks[cls][img]`` (image-space
        RLE dicts, row for row) the segm protocol's too, under ``segm_*``.
        ``save_json`` writes the results list."""
        results = []
        for cls_idx in range(1, self.num_classes):
            cat_id = self._class_to_cat_id[cls_idx]
            for i, img_id in enumerate(self.image_set_index):
                dets = np.asarray(detections[cls_idx][i]).reshape(-1, 5)
                for d, (x1, y1, x2, y2, score) in enumerate(dets):
                    res = {
                        "image_id": int(img_id),
                        "category_id": int(cat_id),
                        "bbox": [float(x1), float(y1), float(x2 - x1 + 1), float(y2 - y1 + 1)],
                        "score": float(score),
                    }
                    if all_masks is not None:
                        res["segmentation"] = all_masks[cls_idx][i][d]
                    results.append(res)
        if save_json:
            with open(save_json, "w") as f:
                json.dump(results, f)
        stats = COCOEvalBbox(self._dataset, results).evaluate()
        if all_masks is not None:
            segm = COCOEvalBbox(self._dataset, results, iou_type="segm").evaluate(verbose=False)
            stats.update({f"segm_{k}": v for k, v in segm.items()})
        return stats
