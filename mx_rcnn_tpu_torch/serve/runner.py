"""The predict path's host half: request preparation, per-image detections
from a forward's outputs, the cross-class cap and one-shot detection (port
of ``prepare_request``, ``detections_from_output``, ``cap_detections`` and
``detect_single`` in ``mx_rcnn_tpu/serve/runner.py``).  Eval
(``core/tester.py::pred_eval``), the demo and serving share these, so they
give the same detections for the same outputs."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.tester import Predictor, im_detect
from mx_rcnn_tpu_torch.data.image import normalize, pad_to_bucket, quantize_uint8, resize_im
from mx_rcnn_tpu_torch.native.hostops import nms_host
from mx_rcnn_tpu_torch.ops.postprocess import MASK_FILL
from mx_rcnn_tpu_torch.serve.buckets import BucketLadder

# per class (n, 5) [x1 y1 x2 y2 score]; index 0 (background) is None
ClsDets = List[Optional[np.ndarray]]


@dataclasses.dataclass
class Request:
    image: np.ndarray           # bucket-padded (H, W, 3), uint8 or normalized f32
    im_info: np.ndarray         # (3,) resized h, w, scale
    orig_hw: Tuple[int, int]    # pre-resize size
    bucket: Tuple[int, int]


def prepare_request(im: np.ndarray, cfg: Config, ladder: BucketLadder) -> Request:
    """Original RGB image → bucket-padded :class:`Request`: resize to the
    dataset SCALES, uint8-quantize (TEST.UINT8_TRANSFER) or normalize, pad
    into the smallest bucket; an oversize image raises ``BucketOverflow``."""
    im = np.asarray(im, np.float32)
    orig_hw = (int(im.shape[0]), int(im.shape[1]))
    target, max_size = cfg.dataset.SCALES[0]
    im, scale = resize_im(im, target, max_size)
    h, w = im.shape[:2]
    bucket = ladder.select(h, w)
    if cfg.TEST.UINT8_TRANSFER:
        im = quantize_uint8(im)
    else:
        im = normalize(im, cfg.network.PIXEL_MEANS, cfg.network.PIXEL_STDS)
    return Request(
        image=pad_to_bucket(im, bucket),
        im_info=np.array([h, w, scale], np.float32),
        orig_hw=orig_hw,
        bucket=bucket,
    )


def detections_from_output(
    out: Dict[str, np.ndarray],
    im_info_row: np.ndarray,
    orig_hw: Tuple[float, float],
    cfg: Config,
    num_classes: int,
    index: int = 0,
    thresh: Optional[float] = None,
    with_rows: bool = False,
):
    """One image's forward outputs (host numpy) → ``(cls_dets,
    mask_probs)``: per-class (n, 5) [x1 y1 x2 y2 score] arrays, ``cls_dets[0]``
    None (background), and for a mask model ``mask_probs[j]`` (n, S, S), the
    kept detections' mask probabilities row for row (else None).

    Both output flavors: the device-postprocess dict (``det_boxes`` /
    ``det_scores`` / ``det_valid``: decode, unscale, clip and per-class NMS
    already ran on the device) and raw head outputs (host decode through
    :func:`~mx_rcnn_tpu_torch.core.tester.im_detect`, then per-class
    ``score > thresh`` and the host NMS at TEST.NMS, the reference's
    ``pred_eval`` inner loop).  On the device flavor a mask model ships the
    selected survivors' LOGIT grids (``det_masks``, ``det_mask_idx``): each
    kept row finds its grid by its flat det-grid index, rows past the
    device's ``max_det`` budget (only past the MAX_PER_IMAGE cut) get the
    −80 fill, and the sigmoid is the reference ``im_detect``'s numpy
    expression, so the probabilities equal the host flavor's bit for bit.
    ``with_rows=True`` also returns each kept detection's det-grid row
    (device flavor; None on the host flavor)."""
    te = cfg.TEST
    thresh = te.SCORE_THRESH if thresh is None else thresh
    cls_dets: ClsDets = [None] * num_classes
    mask_probs: Optional[Dict[int, np.ndarray]] = None
    det_rows: Optional[Dict[int, np.ndarray]] = None
    if "det_boxes" in out:
        det_rows = {}
        lut = None
        if "det_masks" in out:
            mask_probs = {}
            grids = np.asarray(out["det_masks"][index])
            lut = {int(f): p for p, f in enumerate(np.asarray(out["det_mask_idx"][index]))
                   if f >= 0}
        max_out = out["det_boxes"].shape[2]
        for j in range(1, num_classes):
            m = np.asarray(out["det_valid"][index][j - 1]).astype(bool)
            b = np.asarray(out["det_boxes"][index][j - 1][m])
            s = np.asarray(out["det_scores"][index][j - 1][m])
            cls_dets[j] = np.hstack([b, s[:, None]]).astype(np.float32)
            det_rows[j] = np.where(m)[0]
            if lut is not None:
                g = np.full((len(det_rows[j]),) + grids.shape[1:], MASK_FILL, np.float32)
                for t, row in enumerate(det_rows[j]):
                    p = lut.get((j - 1) * max_out + int(row))
                    if p is not None:
                        g[t] = grids[p]
                mask_probs[j] = 1.0 / (1.0 + np.exp(-g))
    else:
        det = im_detect(out, im_info_row, orig_hw, index=index)
        scores, boxes = det["scores"], det["boxes"]
        if "mask_probs" in det:
            mask_probs = {}
        for j in range(1, num_classes):
            keep = np.where(scores[:, j] > thresh)[0]
            cd = np.hstack(
                [boxes[keep, j * 4 : (j + 1) * 4], scores[keep, j : j + 1]]
            ).astype(np.float32)
            keep_nms = nms_host(cd, te.NMS)
            cls_dets[j] = cd[keep_nms]
            if mask_probs is not None:
                mask_probs[j] = det["mask_probs"][keep][keep_nms, :, :, j]
    if with_rows:
        return cls_dets, mask_probs, det_rows
    return cls_dets, mask_probs


def cap_detections(
    cls_dets: ClsDets,
    max_per_image: int,
    mask_probs: Optional[Dict[int, np.ndarray]] = None,
    rows: Optional[Dict[int, np.ndarray]] = None,
):
    """Cross-class per-image cap (the reference's ``max_per_image``): keep
    the top ``max_per_image`` detections by score across classes (every
    detection scoring at least the cut); a no-op when ``max_per_image`` <= 0.
    ``mask_probs`` and ``rows`` (``detections_from_output``'s side
    channels) are filtered in lockstep; ``rows`` comes back as a third
    element when given."""
    num_classes = len(cls_dets)
    if max_per_image > 0:
        all_scores = np.concatenate([cls_dets[j][:, 4] for j in range(1, num_classes)])
        if len(all_scores) > max_per_image:
            cut = np.sort(all_scores)[-max_per_image]
            for j in range(1, num_classes):
                keep = cls_dets[j][:, 4] >= cut
                cls_dets[j] = cls_dets[j][keep]
                if mask_probs is not None:
                    mask_probs[j] = mask_probs[j][keep]
                if rows is not None and rows.get(j) is not None:
                    rows[j] = rows[j][keep]
    if rows is not None:
        return cls_dets, mask_probs, rows
    return cls_dets, mask_probs


def detect_single(
    predictor: Predictor,
    im: np.ndarray,
    cfg: Config,
    num_classes: int,
    thresh: Optional[float] = None,
) -> ClsDets:
    """One-shot detection of one RGB image with a caller-owned
    :class:`Predictor`; the entry point that serves a request.  Batch of 1,
    no cross-class cap.  ``thresh`` applies on the host flavor (a Predictor
    without the device postprocess); the device postprocess carries its
    own."""
    req = prepare_request(im, cfg, BucketLadder(cfg.SHAPE_BUCKETS))
    batch = {
        "images": req.image[None],
        "im_info": req.im_info[None],
        "orig_hw": np.asarray([req.orig_hw], np.float32),
    }
    out = predictor.predict(batch)
    cls_dets, _ = detections_from_output(
        out, batch["im_info"][0], req.orig_hw, cfg, num_classes, thresh=thresh
    )
    return cls_dets
