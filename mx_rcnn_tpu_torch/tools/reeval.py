"""Re-score a saved detection dump without running inference again (port
of ``mx_rcnn_tpu/tools/reeval.py``; reference ``rcnn/tools/reeval.py``):
reads the ``all_boxes`` pickle that ``tools/test.py --dump`` writes (either
package's) and calls ``imdb.evaluate_detections`` on it.

    python -m mx_rcnn_tpu_torch.tools.reeval --synthetic 8 --detections dets.pkl
"""

from __future__ import annotations

import argparse
import logging
import pickle
import sys
from typing import Dict

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.tools.train_rpn import DATASETS, NETWORKS
from mx_rcnn_tpu_torch.utils.load_data import get_imdb
from mx_rcnn_tpu_torch.utils.precision import full_float32

logger = logging.getLogger(__name__)


def reeval(imdb, detections_path: str) -> Dict:
    with open(detections_path, "rb") as f:
        all_boxes = pickle.load(f)
    assert len(all_boxes) == imdb.num_classes, (
        f"detection dump has {len(all_boxes)} classes, imdb has {imdb.num_classes}")
    results = imdb.evaluate_detections(all_boxes)
    logger.info("reeval results: %s", results)
    return results


def main(argv=None) -> Dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", stream=sys.stdout)
    full_float32()
    p = argparse.ArgumentParser(description="Re-score saved detections (PyTorch port)")
    p.add_argument("--network", default="resnet", choices=NETWORKS)
    p.add_argument("--dataset", default="PascalVOC", choices=DATASETS)
    p.add_argument("--image_set", default=None, help="defaults to the test set")
    p.add_argument("--detections", required=True, help="all_boxes pickle")
    p.add_argument("--synthetic", type=int, default=0)
    args = p.parse_args(argv)
    cfg = generate_config(args.network, args.dataset)
    imdb = get_imdb(cfg, args.image_set or cfg.dataset.test_image_set,
                    synthetic_size=args.synthetic)[0]
    return reeval(imdb, args.detections)


if __name__ == "__main__":
    main()
