"""COCO bbox and segm evaluation protocol in pure numpy (port of
``mx_rcnn_tpu/eval/coco_eval.py``, the reimplementation of pycocotools'
``COCOeval`` evaluate / accumulate / summarize):

- 10 IoU thresholds 0.50:0.05:0.95, 101 recall points,
- area ranges all/small/medium/large, maxDets 1/10/100,
- greedy score-descending matching, crowd gts as ignore regions with
  intersection-over-det-area IoU, unmatched dets on ignored gt ignored,
- 12 summary statistics in the standard order.

``iou_type="segm"`` matches RLE masks through ``native/rle.py``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from mx_rcnn_tpu_torch.native import rle as rle_api

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU between (D, 4) and (G, 4) xywh boxes; crowd gt → inter/det_area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :])
    ih = np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(iscrowd[None, :], d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-12)


class COCOEvalBbox:
    def __init__(self, dataset: Dict, results: List[Dict], iou_type: str = "bbox"):
        """``dataset``: the loaded instances json (images/annotations/
        categories); ``results``: list of {image_id, category_id, bbox
        (xywh), score} detection dicts — for ``iou_type='segm'`` each
        result additionally carries ``segmentation`` (RLE dict) and gt
        annotations carry polygon or RLE ``segmentation`` (matched with
        the native RLE library, ``native/rle.py``)."""
        assert iou_type in ("bbox", "segm")
        self.iou_type = iou_type
        self._img_hw = {
            im["id"]: (im.get("height", 0), im.get("width", 0))
            for im in dataset["images"]
        }
        self.img_ids = sorted({im["id"] for im in dataset["images"]})
        self.cat_ids = sorted({c["id"] for c in dataset["categories"]})
        self._gts: Dict = {(i, c): [] for i in self.img_ids for c in self.cat_ids}
        for ann in dataset["annotations"]:
            key = (ann["image_id"], ann["category_id"])
            if key in self._gts:
                self._gts[key].append(ann)
        self._dts: Dict = {(i, c): [] for i in self.img_ids for c in self.cat_ids}
        for det in results:
            key = (det["image_id"], det["category_id"])
            if key in self._dts:
                self._dts[key].append(det)

    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        """Match one (image, category) pair under one area range.

        Greedy score-descending matching; the threshold axis (T=10) runs
        vectorized — only the det axis is a Python loop (the greedy
        sequential dependency).  Truncation to ``max_det`` happens here
        for the standalone call; ``_accumulate`` instead slices cached
        max-budget results (valid because the match of det *i* never
        depends on later dets).
        """
        out = self._match_pair(img_id, cat_id, area_rng)
        if out is None or max_det >= out["dt_matches"].shape[1]:
            return out
        return {
            "dt_matches": out["dt_matches"][:, :max_det],
            "dt_scores": out["dt_scores"][:max_det],
            "dt_ignore": out["dt_ignore"][:, :max_det],
            "gt_ignore": out["gt_ignore"],
            "num_gt": out["num_gt"],
        }

    def _match_pair(self, img_id, cat_id, area_rng):
        gts = self._gts[(img_id, cat_id)]
        dts = sorted(self._dts[(img_id, cat_id)], key=lambda d: -d["score"])
        dts = dts[: max(MAX_DETS)]
        if not gts and not dts:
            return None

        g_boxes = np.array([g["bbox"] for g in gts]).reshape(-1, 4)
        g_crowd = np.array([g.get("iscrowd", 0) for g in gts], bool)
        g_area = np.array(
            [g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gts]
        )
        g_ignore = g_crowd | (g_area < area_rng[0]) | (g_area > area_rng[1])
        # sort gts: non-ignored first (protocol requirement)
        g_order = np.argsort(g_ignore, kind="stable")
        g_boxes, g_crowd, g_ignore = (
            g_boxes[g_order], g_crowd[g_order], g_ignore[g_order]
        )

        d_boxes = np.array([d["bbox"] for d in dts]).reshape(-1, 4)
        d_scores = np.array([d["score"] for d in dts])
        if self.iou_type == "segm":
            ious, d_area = self._segm_iou(img_id, cat_id, dts, gts)
            ious = ious[:, g_order]
        else:
            ious = _iou_xywh(d_boxes, g_boxes, g_crowd)
            d_area = d_boxes[:, 2] * d_boxes[:, 3]

        T, D, G = len(IOU_THRS), len(dts), len(gts)
        thr = np.minimum(IOU_THRS, 1 - 1e-10)                       # (T,)
        dt_m = -np.ones((T, D), int)
        dt_ig = np.zeros((T, D), bool)
        if G:
            avail = np.ones((T, G), bool)
            ni = ~g_ignore[None, :]                                 # (1, G)
            for di in range(D):
                r = ious[di]                                        # (G,)
                cand = avail & (r[None, :] >= thr[:, None])         # (T, G)
                # a non-ignored match (any iou) outranks every ignored gt;
                # within a class, max iou wins — LAST gt on ties, matching
                # the pycocotools loop's >= update (argmax on the reversed
                # axis picks the last maximum)
                r_ni = np.where(cand & ni, r[None, :], -1.0)
                r_ig = np.where(cand & ~ni, r[None, :], -1.0)
                has_ni = r_ni.max(axis=1) > -1.0
                has_ig = r_ig.max(axis=1) > -1.0
                last_ni = G - 1 - r_ni[:, ::-1].argmax(axis=1)
                last_ig = G - 1 - r_ig[:, ::-1].argmax(axis=1)
                best = np.where(
                    has_ni, last_ni, np.where(has_ig, last_ig, -1)
                )                                                   # (T,)
                matched = best >= 0
                dt_m[:, di] = best
                dt_ig[matched, di] = g_ignore[best[matched]]
                # matched non-crowd gts leave the pool (crowds absorb many)
                take = matched & ~g_crowd[np.clip(best, 0, G - 1)]
                avail[take, best[take]] = False
        # unmatched dets outside the area range are ignored
        d_out = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ig |= (dt_m == -1) & d_out[None, :]
        return {
            "dt_matches": dt_m,
            "dt_scores": d_scores,
            "dt_ignore": dt_ig,
            "gt_ignore": g_ignore,
            "num_gt": int((~g_ignore).sum()),
        }

    def _gt_rle(self, ann, img_id):
        """gt segmentation → RLE dict (polygons rasterized via the native
        library, compressed crowd strings decoded; cached on the ann)."""
        if "_rle" not in ann:
            seg = ann["segmentation"]
            h, w = self._img_hw[img_id]
            if isinstance(seg, dict):
                ann["_rle"] = rle_api.ensure_list_counts(seg)
            else:
                ann["_rle"] = rle_api.from_polygons(seg, h, w)
        return ann["_rle"]

    def _segm_iou(self, img_id, cat_id, dts, gts):
        """(ious (D, G) in ORIGINAL gt order, det mask areas (D,)) —
        area-range independent, cached per (img, cat) since _match_pair
        runs once per area range."""
        if not hasattr(self, "_segm_cache"):
            self._segm_cache = {}
        key = (img_id, cat_id)
        if key not in self._segm_cache:
            crowd = [int(g.get("iscrowd", 0)) for g in gts]
            gt_rles = [self._gt_rle(g, img_id) for g in gts]
            dt_rles = [d["segmentation"] for d in dts]
            ious = rle_api.iou(dt_rles, gt_rles, crowd)
            d_area = np.array([rle_api.area(r) for r in dt_rles])
            self._segm_cache[key] = (ious, d_area)
        return self._segm_cache[key]

    def _pair_evals(self, area_rng_key):
        """Cached per-(img, cat) match results at the max det budget for
        one area range — shared by every maxDet setting."""
        if not hasattr(self, "_pair_cache"):
            self._pair_cache = {}
        if area_rng_key not in self._pair_cache:
            area_rng = AREA_RNGS[area_rng_key]
            by_cat = {c: [] for c in self.cat_ids}
            for (img_id, cat_id), dts in self._dts.items():
                if not dts and not self._gts[(img_id, cat_id)]:
                    continue
                e = self._match_pair(img_id, cat_id, area_rng)
                if e is not None:
                    by_cat[cat_id].append(e)
            self._pair_cache[area_rng_key] = by_cat
        return self._pair_cache[area_rng_key]

    def _accumulate(self, area_rng_key, max_det):
        """→ precision (T, R, K), recall (T, K) over categories K."""
        T, R, K = len(IOU_THRS), len(REC_THRS), len(self.cat_ids)
        precision = -np.ones((T, R, K))
        recall = -np.ones((T, K))
        by_cat = self._pair_evals(area_rng_key)
        for ki, cat_id in enumerate(self.cat_ids):
            evals = by_cat[cat_id]
            if not evals:
                continue
            # top-max_det slice per image, then merge score-descending
            scores = np.concatenate([e["dt_scores"][:max_det] for e in evals])
            order = np.argsort(-scores, kind="mergesort")
            dt_m = np.concatenate(
                [e["dt_matches"][:, :max_det] for e in evals], axis=1
            )[:, order]
            dt_ig = np.concatenate(
                [e["dt_ignore"][:, :max_det] for e in evals], axis=1
            )[:, order]
            npig = sum(e["num_gt"] for e in evals)
            if npig == 0:
                continue
            tps = (dt_m >= 0) & ~dt_ig
            fps = (dt_m == -1) & ~dt_ig
            tp_sum = np.cumsum(tps, axis=1).astype(float)
            fp_sum = np.cumsum(fps, axis=1).astype(float)
            nd = tp_sum.shape[1]
            if nd == 0:
                recall[:, ki] = 0.0
                precision[:, :, ki] = 0.0
                continue
            rc = tp_sum / npig                                       # (T, nd)
            pr = tp_sum / np.maximum(
                tp_sum + fp_sum, np.finfo(np.float64).eps
            )
            recall[:, ki] = rc[:, -1]
            # precision envelope (monotone decreasing), vectorized over T
            env = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
            for ti in range(T):
                inds = np.searchsorted(rc[ti], REC_THRS, side="left")
                valid = inds < nd
                q = np.zeros(R)
                q[valid] = env[ti, inds[valid]]
                precision[ti, :, ki] = q
        return precision, recall

    @staticmethod
    def _mean_valid(x: np.ndarray) -> float:
        valid = x[x > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def evaluate(self, verbose: bool = True) -> Dict[str, float]:
        """Run the full protocol; returns the 12 standard stats."""
        cache: Dict = {}

        def acc(name: str, md: int):
            key = (name, md)
            if key not in cache:
                cache[key] = self._accumulate(name, md)
            return cache[key]

        p_all, r_all = acc("all", 100)
        stats = {
            "AP": self._mean_valid(p_all),
            "AP50": self._mean_valid(p_all[np.isclose(IOU_THRS, 0.5)]),
            "AP75": self._mean_valid(p_all[np.isclose(IOU_THRS, 0.75)]),
        }
        for name in ("small", "medium", "large"):
            stats[f"AP_{name}"] = self._mean_valid(acc(name, 100)[0])
        for md in MAX_DETS:
            stats[f"AR_{md}"] = self._mean_valid(acc("all", md)[1])
        for name in ("small", "medium", "large"):
            stats[f"AR_{name}"] = self._mean_valid(acc(name, 100)[1])
        if verbose:
            for k, v in stats.items():
                print(f" {k:<10s} = {v:.3f}")
        return stats
