"""Host-side gt mask rasterization into box-frame bitmaps (port of
``mx_rcnn_tpu/data/masks.py``).

Each gt is rasterized once, at batch assembly, into a small M×M bitmap over
its own gt box (the "box frame"); the in-graph target op
(``ops/mask_targets.py::crop_resize_masks``) resamples that bitmap under
each matched roi's S×S grid.  A (B, G, M, M) uint8 tensor goes to the card
instead of (B, G, H, W) full-image masks.

``segmentation`` formats (the COCO instance formats):
- a list of polygons ``[[x1, y1, x2, y2, ...], ...]`` in continuous image
  coordinates (pixel p covers [p, p+1));
- an RLE dict ``{"size": [h, w], "counts": [...]}`` (crowd regions, which
  ``data/coco.py`` leaves out of training), optionally tagged ``hflip``.

This module imports no torch: the loader's assembly processes run it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from mx_rcnn_tpu_torch.native import rle as rlelib


def polygons_to_box_frame(segm, box: Sequence[float], m: int) -> np.ndarray:
    """One gt's ``segmentation`` → (m, m) uint8 bitmap over its own box.

    ``box`` = [x1, y1, x2, y2], inclusive pixel indices (+1 widths).  Cell
    (r, c) covers [x1 + c/m·w, x1 + (c+1)/m·w) × [y1 + r/m·h, …): the
    polygons' vertices are mapped affinely into that frame and filled on
    cell centres by the even-odd scanline rasterizer.  A segmentation
    whose polygons all have fewer than 3 vertices gives the rectangle (all
    ones); an RLE dict is decoded, cropped and nearest-resized."""
    x1, y1, x2, y2 = (float(v) for v in box[:4])
    w = max(x2 - x1 + 1.0, 1.0)
    h = max(y2 - y1 + 1.0, 1.0)
    if isinstance(segm, dict):
        return _crop_resize_bitmap(rle_to_bitmap(segm), (x1, y1, x2, y2), m)
    polys = []
    for poly in segm:
        p = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(p) < 3:
            continue
        q = np.empty_like(p)
        q[:, 0] = (p[:, 0] - x1) / w * m
        q[:, 1] = (p[:, 1] - y1) / h * m
        polys.append(q.reshape(-1))
    if not polys:
        return np.ones((m, m), np.uint8)
    return rlelib.decode(rlelib.from_polygons(polys, m, m))


def rle_to_bitmap(segm: Dict) -> np.ndarray:
    """RLE dict → (h, w) uint8 bitmap: compressed string counts decoded,
    the lazy ``hflip`` tag of :func:`flip_segmentations` applied."""
    full = rlelib.decode(rlelib.ensure_list_counts({"size": segm["size"],
                                                    "counts": segm["counts"]}))
    if segm.get("hflip"):
        full = full[:, ::-1]
    return full


def _crop_resize_bitmap(full: np.ndarray, box, m: int) -> np.ndarray:
    """Nearest-neighbour crop-resize of a full-image bitmap to the box
    frame (the RLE path; polygons never take it)."""
    x1, y1, x2, y2 = box
    hh, ww = full.shape
    w = max(x2 - x1 + 1.0, 1.0)
    h = max(y2 - y1 + 1.0, 1.0)
    cols = np.clip((x1 + (np.arange(m) + 0.5) / m * w).astype(int), 0, ww - 1)
    rows = np.clip((y1 + (np.arange(m) + 0.5) / m * h).astype(int), 0, hh - 1)
    return full[np.ix_(rows, cols)].astype(np.uint8)


def record_gt_masks(rec: Dict, max_gt: int, m: int) -> Optional[np.ndarray]:
    """roidb record → (max_gt, m, m) uint8 box-frame bitmaps, or None when
    the record has no ``segmentation`` (a box-only dataset: the model then
    trains on rectangle targets).  A gt whose segmentation is None gets
    the rectangle.  Boxes and polygons are stored flipped by
    ``append_flipped_images``, and the box frame is relative, so neither
    the flip nor the loader's resize touches the bitmaps."""
    segms = rec.get("segmentation")
    if segms is None:
        return None
    out = np.zeros((max_gt, m, m), np.uint8)
    for i, (segm, box) in enumerate(zip(segms, rec["boxes"])):
        if i >= max_gt:
            break
        out[i] = 1 if segm is None else polygons_to_box_frame(segm, box, m)
    return out


def flip_segmentations(segms, width: int):
    """x-flip a record's segmentation list: polygons eagerly (x ↦ width − x
    in continuous coordinates), RLE dicts lazily through an ``hflip`` tag
    that :func:`rle_to_bitmap` applies (no decode and re-encode at roidb
    time); None entries stay None.  The even-odd fill ignores the reversed
    winding."""
    if segms is None:
        return None
    out = []
    for segm in segms:
        if segm is None:
            out.append(None)
        elif isinstance(segm, dict):
            out.append({"size": segm["size"], "counts": segm["counts"],
                        "hflip": not segm.get("hflip", False)})
        else:
            flipped = []
            for poly in segm:
                p = np.asarray(poly, np.float64).copy()
                p[0::2] = width - p[0::2]
                flipped.append(p)
            out.append(flipped)
    return out
