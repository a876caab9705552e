"""Proposal recall (port of ``mx_rcnn_tpu/eval/recall.py``; the recall
printout of the reference's ``rcnn/tools/test_rpn.py``): the share of gt
boxes that some proposal covers at IoU ≥ a threshold, for several proposal
budgets."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from mx_rcnn_tpu_torch.utils.bbox_stats import np_overlaps


def proposal_recall(
    proposals: List[np.ndarray],
    roidb: List[Dict],
    top_ns: Sequence[int] = (300, 1000, 2000),
    iou_thresh: float = 0.5,
) -> Dict[str, float]:
    """``{"recall@N": covered / total}`` over a dataset.  ``proposals[i]``
    is image i's (P, 5) [x1, y1, x2, y2, score] in original image
    coordinates, score-descending (the ``generate_proposals`` dump);
    ``roidb[i]["boxes"]`` its gt boxes."""
    assert len(proposals) == len(roidb)
    out = {}
    for n in top_ns:
        covered = total = 0
        for props, rec in zip(proposals, roidb):
            gts = np.asarray(rec["boxes"], np.float32)
            if len(gts) == 0:
                continue
            total += len(gts)
            boxes = np.asarray(props, np.float32)[:n, :4]
            if len(boxes) == 0:
                continue
            ov = np_overlaps(gts, boxes)                          # (G, P)
            covered += int((ov.max(axis=1) >= iou_thresh).sum())
        out[f"recall@{n}"] = covered / max(total, 1)
    return out
