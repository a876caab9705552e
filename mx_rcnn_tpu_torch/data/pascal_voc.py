"""Pascal VOC dataset (port of ``mx_rcnn_tpu/data/pascal_voc.py``).  The
XML goes through the standard library; the JPEG files are read by
``data/loader.py::load_record_image`` with the port's decoder.

Reference: ``rcnn/dataset/pascal_voc.py :: PascalVOC`` — XML annotation
parsing → gt_roidb; detection writing + ``voc_eval`` mAP in
``evaluate_detections`` (the selective-search legacy path is intentionally
dropped; it was dead weight even upstream).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.eval.voc_eval import voc_eval

CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class PascalVOC(IMDB):
    """``image_set`` like '2007_trainval' / '2007_test'."""

    def __init__(self, image_set: str, root_path: str, devkit_path: str):
        year, split = image_set.split("_")
        super().__init__(f"voc_{year}_{split}", root_path)
        self.year = year
        self.split = split
        self.devkit_path = devkit_path
        self.data_path = os.path.join(devkit_path, f"VOC{year}")
        self.classes = list(CLASSES)
        self.image_set_index = self._load_image_set_index()

    def _load_image_set_index(self) -> List[str]:
        index_file = os.path.join(
            self.data_path, "ImageSets", "Main", f"{self.split}.txt"
        )
        with open(index_file) as f:
            return [line.strip() for line in f if line.strip()]

    def image_path(self, index: str) -> str:
        return os.path.join(self.data_path, "JPEGImages", f"{index}.jpg")

    def annotation_path(self, index: str) -> str:
        return os.path.join(self.data_path, "Annotations", f"{index}.xml")

    def _load_annotation(self, index: str) -> Dict:
        tree = ET.parse(self.annotation_path(index))
        size = tree.find("size")
        width = int(size.find("width").text)
        height = int(size.find("height").text)
        boxes, classes = [], []
        for obj in tree.findall("object"):
            cls_name = obj.find("name").text.lower().strip()
            if cls_name not in self.classes:
                continue
            diff = obj.find("difficult")
            is_diff = int(diff.text) if diff is not None else 0
            if is_diff:
                continue  # difficult boxes train nothing; eval reloads them
            bb = obj.find("bndbox")
            # VOC is 1-indexed; reference subtracts 1
            boxes.append(
                [
                    float(bb.find("xmin").text) - 1,
                    float(bb.find("ymin").text) - 1,
                    float(bb.find("xmax").text) - 1,
                    float(bb.find("ymax").text) - 1,
                ]
            )
            classes.append(self.classes.index(cls_name))
        return {
            "image": self.image_path(index),
            "height": height,
            "width": width,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "gt_classes": np.asarray(classes, np.int32),
            "flipped": False,
        }

    def gt_roidb(self) -> List[Dict]:
        return self.load_cached(
            "gt_roidb",
            lambda: [self._load_annotation(ix) for ix in self.image_set_index],
        )

    # -- evaluation -------------------------------------------------------
    def evaluate_detections(self, detections, use_07_metric: bool | None = None):
        """detections[cls][img] = (n, 5).  Returns {class: AP, 'mAP': m}.

        Reference: ``pascal_voc.py :: evaluate_detections`` → write
        ``comp4_det_*`` files → ``voc_eval`` per class; here the handoff
        is in-memory but the AP math is the same (07 11-point metric for
        year 2007 unless overridden).
        """
        if use_07_metric is None:
            use_07_metric = self.year == "2007"
        annots = {
            ix: self._load_annotation_with_difficult(ix)
            for ix in self.image_set_index
        }
        aps = {}
        for cls_idx, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            dets_by_img = {
                ix: detections[cls_idx][i]
                for i, ix in enumerate(self.image_set_index)
            }
            rec, prec, ap = voc_eval(
                dets_by_img, annots, cls_idx, ovthresh=0.5, use_07_metric=use_07_metric
            )
            aps[cls] = ap
        aps["mAP"] = float(np.mean([v for k, v in aps.items() if k != "mAP"]))
        return aps

    def _load_annotation_with_difficult(self, index: str) -> Dict:
        """Gt + difficult flags for eval (difficult boxes don't count
        against precision — ``pascal_voc_eval.py`` semantics)."""
        tree = ET.parse(self.annotation_path(index))
        boxes, classes, difficult = [], [], []
        for obj in tree.findall("object"):
            cls_name = obj.find("name").text.lower().strip()
            if cls_name not in self.classes:
                continue
            diff = obj.find("difficult")
            bb = obj.find("bndbox")
            boxes.append(
                [
                    float(bb.find("xmin").text) - 1,
                    float(bb.find("ymin").text) - 1,
                    float(bb.find("xmax").text) - 1,
                    float(bb.find("ymax").text) - 1,
                ]
            )
            classes.append(self.classes.index(cls_name))
            difficult.append(int(diff.text) if diff is not None else 0)
        return {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "gt_classes": np.asarray(classes, np.int32),
            "difficult": np.asarray(difficult, bool),
        }
