"""Single-image detection (port of ``demo_net`` in
``mx_rcnn_tpu/tools/demo.py``): an RGB image in, ``{class name: (n, 5)
dets}`` out, through the same ``detect_single`` that serves requests.

The CLI (read an image file, draw the overlay, write it) needs an image
decoder and writer, which the port does not have: :func:`main` raises
(ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import numpy as np

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.tester import Predictor
from mx_rcnn_tpu_torch.serve.runner import detect_single
from mx_rcnn_tpu_torch.utils.precision import full_float32

# VOC class names for the default 21-class config (demo labels)
VOC_CLASSES = (
    "__background__", "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor",
)


def demo_net(
    predictor: Predictor,
    im: np.ndarray,
    cfg: Config,
    class_names=VOC_CLASSES,
    vis_thresh: float = 0.7,
):
    """One RGB HWC uint8/float image → ``{class_name: (n, 5) dets}`` for
    the classes with a detection scoring ``vis_thresh`` or more (each with
    all its detections)."""
    cls_dets = detect_single(predictor, im, cfg, len(class_names), thresh=cfg.TEST.SCORE_THRESH)
    dets_by_class = {}
    for j in range(1, len(class_names)):
        if (cls_dets[j][:, 4] >= vis_thresh).any():
            dets_by_class[class_names[j]] = cls_dets[j]
    return dets_by_class


def main(argv=None):
    full_float32()
    raise NotImplementedError(
        "the demo CLI reads an image file and writes an overlay, which needs an image "
        "decoder and writer the port does not have: ROADMAP queue 1 item 7; call demo_net"
    )


if __name__ == "__main__":
    main()
