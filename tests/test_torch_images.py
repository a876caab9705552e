"""Real image files through the port against the JAX package: a Pascal VOC
and a COCO fixture tree of the committed JPEG fixtures
(``tests/fixtures/jpeg/``).  ``load_record_image`` (flipped and not) equals
JAX's bit for bit; ``make_batch`` equals JAX's within the loader tests'
resize tolerance; a tiny-config ``pred_eval`` on 2 real images agrees with
JAX's on the same bridged weights within the eval parity tests' bars (same
keep counts, scores within 1e-5, boxes within 1e-3 px, statistics within
1e-6)."""

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core.tester import Predictor as JPredictor
from mx_rcnn_tpu.core.tester import pred_eval as j_pred_eval
from mx_rcnn_tpu.data import loader as jloader
from mx_rcnn_tpu.data.coco import COCO as JCOCO
from mx_rcnn_tpu.data.imdb import IMDB as JIMDB
from mx_rcnn_tpu.data.pascal_voc import PascalVOC as JPascalVOC
from mx_rcnn_tpu.models import FasterRCNN as JFasterRCNN
from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval
from mx_rcnn_tpu_torch.data import image as timage
from mx_rcnn_tpu_torch.data import loader as tloader
from mx_rcnn_tpu_torch.data.coco import COCO
from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.data.pascal_voc import PascalVOC
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, torch_to_flax
from tests.test_model import tiny_cfg
from tests.test_torch_model import _perturb, _tame_rpn, port_cfg

torch.set_num_threads(2)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
MANIFEST = {e["name"]: e for e in json.loads((FIXTURES / "manifest.json").read_text())["files"]}

VOC_IMAGES = ("voc_420_baseline.jpg", "coco_422_progressive.jpg", "exif_rotated_6.jpg")
COCO_IMAGES = ("coco_444_restart.jpg", "gray.jpg", "odd_411.jpg")


def boxes_in(h: int, w: int, k: int):
    """``k`` boxes (x1, y1, x2, y2) inside an h × w image."""
    return [(w * (i + 1) // (2 * k + 2), h * (i + 1) // (2 * k + 3),
             w * (k + i + 2) // (2 * k + 2) - 1, h * (k + i + 3) // (2 * k + 3) - 1)
            for i in range(k)]


def write_voc_tree(root: Path) -> Path:
    """``VOCdevkit/VOC2007`` with the VOC fixtures as test images 000001..,
    an annotation per image (size from the decoded shape, 2 objects)."""
    base = root / "VOCdevkit" / "VOC2007"
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (base / d).mkdir(parents=True)
    names = []
    for i, fixture in enumerate(VOC_IMAGES, 1):
        name = f"{i:06d}"
        names.append(name)
        shutil.copy(FIXTURES / fixture, base / "JPEGImages" / f"{name}.jpg")
        h, w = MANIFEST[fixture]["shape"][:2]
        objs = "".join(
            f"<object><name>{cls}</name><difficult>0</difficult><bndbox><xmin>{x1}</xmin>"
            f"<ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>"
            for cls, (x1, y1, x2, y2) in zip(("dog", "person"), boxes_in(h, w, 2)))
        (base / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth></size>"
            f"{objs}</annotation>")
    (base / "ImageSets" / "Main" / "test.txt").write_text("\n".join(names) + "\n")
    return root / "VOCdevkit"


def write_coco_tree(root: Path) -> Path:
    """``annotations/instances_val2017.json`` and ``val2017/`` with the COCO
    fixtures: 3 categories, 2 polygon objects an image."""
    (root / "annotations").mkdir(parents=True)
    (root / "val2017").mkdir()
    images, anns = [], []
    for i, fixture in enumerate(COCO_IMAGES, 1):
        shutil.copy(FIXTURES / fixture, root / "val2017" / fixture)
        h, w = MANIFEST[fixture]["shape"][:2]
        images.append(dict(id=i, file_name=fixture, height=h, width=w))
        for k, (x1, y1, x2, y2) in enumerate(boxes_in(h, w, 2)):
            bw, bh = x2 - x1 + 1, y2 - y1 + 1
            anns.append(dict(id=len(anns) + 1, image_id=i, category_id=(i + k) % 3 + 1,
                             bbox=[x1, y1, bw, bh], area=float(bw * bh), iscrowd=0,
                             segmentation=[[x1, y1, x2, y1, x2, y2, x1, y2]]))
    cats = [dict(id=1, name="person"), dict(id=2, name="car"), dict(id=3, name="cat")]
    (root / "annotations" / "instances_val2017.json").write_text(
        json.dumps({"images": images, "categories": cats, "annotations": anns}))
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    return {"voc": str(write_voc_tree(root / "voc")), "coco": str(write_coco_tree(root / "coco"))}


def roidbs(trees, kind, tmp_path):
    """(port roidb, JAX roidb) of the tree, flipped records appended."""
    if kind == "voc":
        port = PascalVOC("2007_test", str(tmp_path / "port"), trees["voc"])
        ref = JPascalVOC("2007_test", str(tmp_path / "jax"), trees["voc"])
        return IMDB.append_flipped_images(port.gt_roidb()), JIMDB.append_flipped_images(ref.gt_roidb())
    port = COCO("val2017", str(tmp_path / "port"), trees["coco"])
    ref = JCOCO("val2017", str(tmp_path / "jax"), trees["coco"])
    return IMDB.append_flipped_images(port.gt_roidb()), JIMDB.append_flipped_images(ref.gt_roidb())


@pytest.mark.parametrize("kind", ["voc", "coco"])
def test_load_record_image_equals_jax_bit_for_bit(trees, kind, tmp_path):
    got_roidb, ref_roidb = roidbs(trees, kind, tmp_path)
    assert len(got_roidb) == len(ref_roidb) == 6
    assert [r["flipped"] for r in got_roidb] == [False] * 3 + [True] * 3
    for rec, jrec in zip(got_roidb, ref_roidb):
        assert rec["image"] == jrec["image"]
        got, want = tloader.load_record_image(rec), jloader._load_record_image(jrec)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert (rec["height"], rec["width"]) == got.shape[:2]
        assert got.tobytes() == np.ascontiguousarray(want).tobytes(), rec["image"]
    # a flipped record is the mirror of its image
    np.testing.assert_array_equal(tloader.load_record_image(got_roidb[3]),
                                  tloader.load_record_image(got_roidb[0])[:, ::-1])


def test_prepared_cache_keys_file_records_by_image_and_flip(trees, tmp_path):
    roidb, _ = roidbs(trees, "voc", tmp_path)
    scales, bucket = ((128, 160),), (128, 160)
    keys = {tloader._prepared_key(r, scales, bucket, True, None, None) for r in roidb}
    assert len(keys) == 6
    assert tloader._prepared_key(roidb[0], scales, bucket, True, None, None)[:2] == (
        roidb[0]["image"], False)


def _batch_cfgs():
    jcfg = j_generate_config("resnet50", "PascalVOC")
    jcfg = jcfg.replace(dataset=dataclasses.replace(jcfg.dataset, SCALES=((128, 160),)),
                        SHAPE_BUCKETS=((128, 160), (160, 128)))
    return jcfg, port_cfg(jcfg)


@pytest.mark.parametrize("uint8", [False, True])
@pytest.mark.parametrize("kind", ["voc", "coco"])
def test_make_batch_matches_jax(trees, kind, uint8, tmp_path):
    """Two records and a flipped one of the same bucket: im_info and the gt
    arrays equal, the images within the loader tests' resize bar (the port's
    numpy resize against cv2's: 1e-3 normalized, 1 LSB quantized)."""
    jcfg, cfg = _batch_cfgs()
    got_roidb, ref_roidb = roidbs(trees, kind, tmp_path)
    wide = [i for i, r in enumerate(got_roidb) if r["width"] >= r["height"]][:3]
    assert len(wide) == 3
    recs, jrecs = [got_roidb[i] for i in wide], [ref_roidb[i] for i in wide]
    got = tloader.make_batch(recs, cfg, (128, 160), seeds=wide, uint8_images=uint8)
    ref = jloader.make_batch(jrecs, jcfg, (128, 160), seeds=wide, uint8_images=uint8)
    assert got.keys() == ref.keys()
    for k in ("im_info", "gt_boxes", "gt_valid", "sample_seeds"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["images"].dtype == ref["images"].dtype
    if uint8:
        diff = got["images"].astype(np.int16) - ref["images"].astype(np.int16)
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 1e-3
    else:
        np.testing.assert_allclose(got["images"], ref["images"], atol=1e-3)


# ------------------------------------------------------------ pred_eval
@pytest.fixture(scope="module")
def real_eval(trees, tmp_path_factory):
    """JAX's and the port's pred_eval on the first 2 COCO fixture images,
    ``tiny_cfg`` at one 128 × 128 bucket and the tree's 3 classes, the same
    bridged weights (seeded, perturbed BN and biases, tamed RPN).  JAX's
    loader runs the port's resize (the loader tests' ``same_resize``), so
    both forwards see the same pixels."""
    jcfg = tiny_cfg()
    jcfg = jcfg.replace(
        SHAPE_BUCKETS=((128, 128),),
        TEST=dataclasses.replace(jcfg.TEST, SCORE_THRESH=0.0),
        dataset=dataclasses.replace(jcfg.dataset, NUM_CLASSES=4, SCALES=((128, 128),),
                                    MAX_GT_BOXES=8),
    )
    cfg = port_cfg(jcfg)
    model = FasterRCNN(cfg, torch.Generator().manual_seed(0))
    params_np = _tame_rpn(_perturb(torch_to_flax(model), np.random.RandomState(1)))
    model = flax_to_torch(params_np, model).eval()
    root = tmp_path_factory.mktemp("eval")
    imdb = COCO("val2017", str(root / "port"), trees["coco"])
    jimdb = JCOCO("val2017", str(root / "jax"), trees["coco"])
    for d in (imdb, jimdb):
        d.image_set_index = d.image_set_index[:2]
    roidb, jroidb = imdb.gt_roidb()[:2], jimdb.gt_roidb()[:2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloader, "prepare_image", timage.prepare_image)
        ref = j_pred_eval(JPredictor(JFasterRCNN(jcfg), params_np),
                          jloader.TestLoader(jroidb, jcfg), jimdb, jcfg)
    got = pred_eval(Predictor(model, device="cpu"), tloader.TestLoader(roidb, cfg), imdb, cfg)
    return {"port": got, "jax": ref, "cfg": cfg, "model": model, "imdb": imdb, "roidb": roidb}


def test_pred_eval_on_real_images_matches_jax(real_eval):
    (got, results), (ref, ref_results) = real_eval["port"], real_eval["jax"]
    kept = 0
    for j in range(1, 4):
        for i in range(2):
            g, r = got[j][i], np.asarray(ref[j][i])
            assert g.shape == r.shape, f"class {j} image {i}"
            np.testing.assert_allclose(g[:, 4], r[:, 4], atol=1e-5, err_msg=f"class {j} image {i}")
            np.testing.assert_allclose(g[:, :4], r[:, :4], atol=1e-3, err_msg=f"class {j} image {i}")
            kept += len(g)
    assert kept >= 10
    assert set(results) == set(ref_results)
    for k, v in ref_results.items():
        assert abs(results[k] - v) <= 1e-6, k
