"""The port's overlays (``utils/visualize.py``) against the JAX package's
cv2 renderer: rectangles equal ``cv2.rectangle(..., 2)`` exactly,
``draw_detections`` equals JAX's pixel for pixel outside the label
rectangles, whose bitmap-font text stays inside the box
``cv2.getTextSize(label, FONT_HERSHEY_SIMPLEX, 0.5, 1)`` gives at
``(x1, max(y1 - 4, 10))``; ``save_image``'s PNG reads back with cv2;
``pred_eval(vis=...)`` and the demo CLI write their PNGs."""

import dataclasses
import logging
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.utils.visualize import class_color as j_class_color
from mx_rcnn_tpu.utils.visualize import draw_detections as j_draw_detections
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval
from mx_rcnn_tpu_torch.data import loader as tloader
from mx_rcnn_tpu_torch.data.coco import COCO
from mx_rcnn_tpu_torch.data.pascal_voc import CLASSES
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.tools import demo
from mx_rcnn_tpu_torch.utils.visualize import (class_color, draw_detections, draw_rectangle,
                                               draw_text, save_image)
from tests.test_model import tiny_cfg
from tests.test_torch_images import write_coco_tree
from tests.test_torch_model import port_cfg

torch.set_num_threads(2)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
FONT = cv2.FONT_HERSHEY_SIMPLEX
COCO_NAMES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck", "boat",
    "traffic light", "fire hydrant", "stop sign", "parking meter", "bench", "bird", "cat", "dog",
    "horse", "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard", "tennis racket", "bottle",
    "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich",
    "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair", "couch",
    "potted plant", "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink", "refrigerator", "book",
    "clock", "vase", "scissors", "teddy bear", "hair drier", "toothbrush")


def test_class_color_is_jaxs():
    assert [class_color(k) for k in range(100)] == [j_class_color(k) for k in range(100)]


@pytest.mark.parametrize("seed", range(4))
def test_rectangle_equals_cv2_thickness_2(seed):
    """Random, reversed, degenerate and partly off-image corners."""
    rng = np.random.default_rng(seed)
    for _ in range(500):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        x1, y1, x2, y2 = (int(v) for v in rng.integers(-5, 45, 4))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        want = np.zeros((h, w, 3), np.uint8)
        got = want.copy()
        cv2.rectangle(want, (x1, y1), (x2, y2), color, 2)
        draw_rectangle(got, (x1, y1), (x2, y2), color)
        np.testing.assert_array_equal(got, want, err_msg=str((h, w, x1, y1, x2, y2)))


def label_box(label: str, x1: int, y1: int):
    """cv2's text box of the label JAX draws at box corner (x1, y1):
    columns x0..x0+w-1, rows y-h..y+baseline-1."""
    (w, h), base = cv2.getTextSize(label, FONT, 0.5, 1)
    y = max(y1 - 4, 10)
    return x1, y - h, x1 + w - 1, y + base - 1


@pytest.mark.parametrize("names", ["voc", "coco", "numbered"])
def test_labels_stay_inside_cv2s_text_box(names):
    pool = {"voc": CLASSES[1:], "coco": COCO_NAMES,
            "numbered": tuple(f"class{i}" for i in range(100))}[names]
    for name in pool:
        for score in (0.7, 0.873, 0.999, 1.0, 0.05):
            label = f"{name} {score:.3f}"
            im = np.zeros((60, 420, 3), np.uint8)
            draw_text(im, label, (10, 30), (255, 255, 255))
            ys, xs = np.nonzero(im.any(2))
            bx0, by0, bx1, by1 = label_box(label, 10, 34)
            assert xs.min() >= bx0 and xs.max() <= bx1, label
            assert ys.min() >= by0 and ys.max() <= by1, label


def _scene_dets(rng, h, w, n):
    x1 = rng.uniform(0, w * 0.7, n)
    y1 = rng.uniform(0, h * 0.7, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(8, w * 0.3, n), y1 + rng.uniform(8, h * 0.3, n),
                      rng.uniform(0.3, 1.0, n)], 1)
    return np.minimum(boxes, [w - 1, h - 1, w - 1, h - 1, 1.0]).astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_draw_detections_equals_jax_outside_the_labels(seed):
    rng = np.random.default_rng(seed)
    im = cv2.cvtColor(cv2.imread(str(FIXTURES / "voc_420_baseline.jpg")), cv2.COLOR_BGR2RGB)
    im = im.astype(np.float32)
    h, w = im.shape[:2]
    dets = {name: _scene_dets(rng, h, w, 4) for name in ("dog", "person", "car")}
    got = draw_detections(im, dets, 0.5)
    want = j_draw_detections(im, dets, 0.5)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    outside = np.ones((h, w), bool)
    drawn = 0
    for name, d in dets.items():
        for det in d:
            if det[4] < 0.5:
                continue
            drawn += 1
            x1, y1 = int(round(det[0])), int(round(det[1]))
            bx0, by0, bx1, by1 = label_box(f"{name} {float(det[4]):.3f}", x1, y1)
            outside[max(by0, 0): by1 + 1, max(bx0, 0): bx1 + 1] = False
    assert drawn >= 3
    np.testing.assert_array_equal(got[outside], want[outside])
    assert (got != im.astype(np.uint8)).any(2)[~outside].any(), "labels drawn"


def test_save_image_png_reads_back_with_cv2(tmp_path):
    rng = np.random.default_rng(0)
    for h, w in ((1, 1), (17, 23), (375, 500)):
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        path = tmp_path / f"{h}x{w}.png"
        save_image(str(path), a)
        back = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(cv2.cvtColor(back, cv2.COLOR_BGR2RGB), a)
    with pytest.raises(ValueError, match="RGB"):
        save_image(str(tmp_path / "gray.png"), np.zeros((4, 4), np.uint8))


def _tiny_cfgs():
    jcfg = tiny_cfg()
    jcfg = jcfg.replace(
        SHAPE_BUCKETS=((128, 128),),
        TEST=dataclasses.replace(jcfg.TEST, SCORE_THRESH=0.0),
        dataset=dataclasses.replace(jcfg.dataset, NUM_CLASSES=4, SCALES=((128, 128),),
                                    MAX_GT_BOXES=8),
    )
    return port_cfg(jcfg)


def test_pred_eval_vis_writes_an_overlay_per_image(tmp_path):
    cfg = _tiny_cfgs()
    tree = write_coco_tree(tmp_path / "coco")
    imdb = COCO("val2017", str(tmp_path / "root"), str(tree))
    roidb = imdb.gt_roidb()
    vis = tmp_path / "vis"
    model = FasterRCNN(cfg, torch.Generator().manual_seed(0)).eval()
    all_boxes, _ = pred_eval(Predictor(model, device="cpu"), tloader.TestLoader(roidb, cfg),
                             imdb, cfg, vis=str(vis), vis_thresh=0.0)
    assert sorted(p.name for p in vis.iterdir()) == [f"det_{i:06d}.png" for i in range(3)]
    for i, rec in enumerate(roidb):
        back = cv2.cvtColor(cv2.imread(str(vis / f"det_{i:06d}.png")), cv2.COLOR_BGR2RGB)
        dets = {imdb.classes[j]: all_boxes[j][i] for j in range(1, 4)}
        np.testing.assert_array_equal(
            back, draw_detections(tloader.load_record_image(rec), dets, 0.0))


def test_demo_cli_writes_the_overlay_on_the_cpu(tmp_path, monkeypatch, caplog):
    """``tools/demo.py main`` through its normal path on a tiny config: no
    checkpoint under the prefix (a warning, the seeded random model), the
    fixture decoded, the overlay written to ``--out``."""
    cfg = _tiny_cfgs()
    monkeypatch.setattr(demo, "generate_config", lambda network, dataset: cfg)
    out = tmp_path / "demo_out.png"
    image = FIXTURES / "coco_444_restart.jpg"
    with caplog.at_level(logging.INFO):
        dets = demo.main(["--network", "resnet", "--cpu", "1", "--image", str(image),
                          "--out", str(out), "--prefix", str(tmp_path / "none"),
                          "--vis_thresh", "0.0"])
    assert "no checkpoint" in caplog.text and f"wrote {out}" in caplog.text
    back = cv2.cvtColor(cv2.imread(str(out)), cv2.COLOR_BGR2RGB)
    im = cv2.cvtColor(cv2.imread(str(image)), cv2.COLOR_BGR2RGB)
    assert back.shape == im.shape
    assert set(dets) <= {"class1", "class2", "class3"}
    np.testing.assert_array_equal(back, draw_detections(im.astype(np.float32), dets, 0.0))
    # the default config's names are VOC's
    assert generate_config("resnet", "PascalVOC").dataset.NUM_CLASSES == len(demo.VOC_CLASSES)
