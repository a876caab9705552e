"""COCOeval throughput benchmark on a synthetic 5k-image × 80-class set
(port of ``mx_rcnn_tpu/tools/bench_coco_eval.py``): the full 12-stat box
evaluation (``eval/coco_eval.py::COCOEvalBbox``) of a val2017-sized
detection dump, on the host.

Usage: python -m mx_rcnn_tpu_torch.tools.bench_coco_eval [--images 5000]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from mx_rcnn_tpu_torch.eval.coco_eval import COCOEvalBbox


def synthetic_coco(n_img: int, n_cat: int, gt_per_img: int, noise_dets: int, seed=0):
    """(instances dataset, detection results): ``gt_per_img`` boxes an image,
    each detected with a few pixels of noise at a random score, and
    ``noise_dets`` low-scoring false positives an image."""
    rng = np.random.RandomState(seed)
    images = [{"id": i} for i in range(n_img)]
    cats = [{"id": c + 1} for c in range(n_cat)]
    anns, results = [], []
    aid = 0
    for i in range(n_img):
        for _ in range(gt_per_img):
            c = int(rng.randint(1, n_cat + 1))
            x, y = rng.rand() * 500, rng.rand() * 400
            w, h = 10 + rng.rand() * 100, 10 + rng.rand() * 100
            anns.append({
                "id": aid, "image_id": i, "category_id": c,
                "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0,
            })
            aid += 1
            results.append({
                "image_id": i, "category_id": c,
                "bbox": [x + rng.randn() * 3, y + rng.randn() * 3, w, h],
                "score": float(rng.rand()),
            })
        for _ in range(noise_dets):
            c = int(rng.randint(1, n_cat + 1))
            results.append({
                "image_id": i, "category_id": c,
                "bbox": [rng.rand() * 500, rng.rand() * 400,
                         20 + rng.rand() * 60, 20 + rng.rand() * 60],
                "score": float(rng.rand() * 0.5),
            })
    return {"images": images, "annotations": anns, "categories": cats}, results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="COCOeval throughput on synthetic detections")
    p.add_argument("--images", type=int, default=5000)
    p.add_argument("--cats", type=int, default=80)
    p.add_argument("--gt_per_img", type=int, default=6)
    p.add_argument("--noise_dets", type=int, default=14)
    args = p.parse_args(argv)
    dataset, results = synthetic_coco(args.images, args.cats, args.gt_per_img, args.noise_dets)
    t0 = time.time()
    ev = COCOEvalBbox(dataset, results)
    t1 = time.time()
    stats = ev.evaluate(verbose=True)
    t2 = time.time()
    print(f"index {t1 - t0:.1f}s  evaluate {t2 - t1:.1f}s  "
          f"({args.images} imgs × {args.cats} cats, {len(results)} dets)")
    assert t2 - t1 < 120, "evaluate exceeded the 2-minute budget"
    return {"index_s": t1 - t0, "evaluate_s": t2 - t1, "stats": stats}


if __name__ == "__main__":
    main()
