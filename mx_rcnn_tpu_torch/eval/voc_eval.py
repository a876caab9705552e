"""Pascal VOC detection AP (the port's copy of
``mx_rcnn_tpu/eval/voc_eval.py``, numpy only).

Reference: ``rcnn/dataset/pascal_voc_eval.py :: voc_eval`` — per-class PR
curve with greedy one-to-one matching at IoU ≥ 0.5, difficult-box
handling (matches to difficult gt count as neither TP nor FP), and both
the 2007 11-point metric and the later continuous integral metric.  The
math is identical; the interface is in-memory (dets/annots dicts) instead
of files on disk.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = float(np.max(prec[rec >= t])) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def voc_eval(
    dets_by_img: Dict[str, np.ndarray],
    annots: Dict[str, Dict],
    cls_idx: int,
    ovthresh: float = 0.5,
    use_07_metric: bool = False,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """dets_by_img[img] = (n, 5) [x1, y1, x2, y2, score] for one class;
    annots[img] = {boxes, gt_classes, difficult}.  → (recall, precision, AP).
    """
    # per-image gt for this class
    class_gt = {}
    npos = 0
    for img, ann in annots.items():
        mask = ann["gt_classes"] == cls_idx
        boxes = ann["boxes"][mask]
        difficult = (
            ann["difficult"][mask]
            if "difficult" in ann
            else np.zeros(mask.sum(), bool)
        )
        class_gt[img] = {
            "boxes": boxes,
            "difficult": difficult,
            "matched": np.zeros(len(boxes), bool),
        }
        npos += int((~difficult).sum())

    # flatten detections, sort by confidence
    all_imgs, all_dets = [], []
    for img, d in dets_by_img.items():
        d = np.asarray(d).reshape(-1, 5)
        all_imgs.extend([img] * len(d))
        all_dets.append(d)
    if not all_dets or sum(len(d) for d in all_dets) == 0:
        return np.array([]), np.array([]), 0.0
    all_dets = np.concatenate(all_dets, axis=0)
    order = np.argsort(-all_dets[:, 4])
    all_dets = all_dets[order]
    all_imgs = [all_imgs[i] for i in order]

    nd = len(all_dets)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for i in range(nd):
        gt = class_gt.get(all_imgs[i])
        bb = all_dets[i, :4]
        ovmax, jmax = -np.inf, -1
        if gt is not None and len(gt["boxes"]):
            g = gt["boxes"]
            ixmin = np.maximum(g[:, 0], bb[0])
            iymin = np.maximum(g[:, 1], bb[1])
            ixmax = np.minimum(g[:, 2], bb[2])
            iymax = np.minimum(g[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inter = iw * ih
            union = (
                (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                + (g[:, 2] - g[:, 0] + 1.0) * (g[:, 3] - g[:, 1] + 1.0)
                - inter
            )
            overlaps = inter / union
            jmax = int(np.argmax(overlaps))
            ovmax = overlaps[jmax]
        if ovmax > ovthresh:
            if gt["difficult"][jmax]:
                continue  # neither tp nor fp
            if not gt["matched"][jmax]:
                tp[i] = 1.0
                gt["matched"][jmax] = True
            else:
                fp[i] = 1.0
        else:
            fp[i] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / max(float(npos), np.finfo(np.float64).eps)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)
