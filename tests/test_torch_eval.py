"""The PyTorch port's evaluation side on the CPU against the JAX package, on
the same numpy-seeded inputs: VOC AP (float for float), the Pascal VOC
reader on ``tests/test_datasets.py``'s devkit fixture, the synthetic
dataset's mAP, the host decode and clip (bit for bit), the C host NMS
(identical keep lists, ties included), the test batches (uint8 images bit
for bit), and the ``tools/test.py`` CLI."""

import dataclasses
import logging
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data import loader as jloader
from mx_rcnn_tpu.data.pascal_voc import PascalVOC as JPascalVOC
from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from mx_rcnn_tpu.eval.voc_eval import voc_ap as j_voc_ap
from mx_rcnn_tpu.eval.voc_eval import voc_eval as j_voc_eval
from mx_rcnn_tpu.native.hostops import nms_host as j_nms_host
from mx_rcnn_tpu.utils.bbox_stats import np_bbox_pred as j_np_bbox_pred
from mx_rcnn_tpu.utils.bbox_stats import np_clip_boxes as j_np_clip_boxes
from mx_rcnn_tpu.utils.run_meta import save_run_meta as j_save_run_meta
from mx_rcnn_tpu_torch.data import image as timage
from mx_rcnn_tpu_torch.data import loader as tloader
from mx_rcnn_tpu_torch.data.imdb import IMDB, merge_roidbs
from mx_rcnn_tpu_torch.data.pascal_voc import PascalVOC
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.eval.voc_eval import voc_ap, voc_eval
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.native import hostops, rle
from mx_rcnn_tpu_torch.ops.nms import nms_numpy
from mx_rcnn_tpu_torch.tools import test as test_cli
from mx_rcnn_tpu_torch.utils import load_data
from mx_rcnn_tpu_torch.utils.bbox_stats import np_bbox_pred, np_clip_boxes
from mx_rcnn_tpu_torch.utils.bridge import torch_to_flax
from mx_rcnn_tpu_torch.utils.combine_model import load_params, save_params
from tests.test_datasets import voc_devkit  # noqa: F401 — the fixture
from tests.test_torch_model import port_cfg

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def clean_render_cache():
    """The JAX render LRU keys renders without their size: start without
    another file's renders, and drop this file's."""
    jloader._RENDER_CACHE.clear()
    yield
    jloader._RENDER_CACHE.clear()


# ------------------------------------------------------------------ VOC AP
def _random_annots(rng, n_img=6, k=4):
    annots = {}
    for i in range(n_img):
        n = rng.randint(0, 6)
        xy = rng.rand(n, 2).astype(np.float32) * 200
        wh = rng.rand(n, 2).astype(np.float32) * 80 + 10
        annots[f"img{i}"] = {
            "boxes": np.hstack([xy, xy + wh]).astype(np.float32),
            "gt_classes": rng.randint(1, k, n).astype(np.int32),
            "difficult": rng.rand(n) < 0.25,
        }
    return annots


def _random_dets(rng, annots, cls_idx):
    """Jittered copies of the class's gts (some matched twice) and random
    false positives, scores with ties."""
    dets = {}
    for img, ann in annots.items():
        gts = ann["boxes"][ann["gt_classes"] == cls_idx]
        near = np.repeat(gts, rng.randint(1, 3, len(gts)), axis=0)
        near = near + rng.randn(*near.shape).astype(np.float32) * 6
        far = rng.rand(rng.randint(0, 4), 4).astype(np.float32) * 150
        far[:, 2:] += far[:, :2] + 5
        boxes = np.vstack([near.reshape(-1, 4), far]).astype(np.float32)
        scores = np.round(rng.rand(len(boxes)), 1).astype(np.float32)
        dets[img] = np.hstack([boxes, scores[:, None]])
    return dets


@pytest.mark.parametrize("use_07", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voc_eval_matches_jax_float_for_float(seed, use_07):
    """Recall, precision and AP bit-identical (difficult gts, repeated
    matches and tied scores included)."""
    rng = np.random.RandomState(seed)
    annots = _random_annots(rng)
    for cls_idx in range(1, 4):
        dets = _random_dets(rng, annots, cls_idx)
        got = voc_eval(dets, annots, cls_idx, 0.5, use_07)
        ref = j_voc_eval(dets, annots, cls_idx, 0.5, use_07)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]
    rec = np.sort(rng.rand(20))
    prec = rng.rand(20)
    assert voc_ap(rec, prec, use_07) == j_voc_ap(rec, prec, use_07)


def test_voc_eval_without_detections_scores_zero():
    annots = _random_annots(np.random.RandomState(3))
    got, ref = voc_eval({}, annots, 1), j_voc_eval({}, annots, 1)
    assert got[2] == ref[2] == 0.0 and got[0].size == ref[0].size == 0


# ----------------------------------------------------------------- datasets
def test_pascal_voc_matches_jax(voc_devkit, tmp_path):  # noqa: F811
    """The roidb, its pickle cache (the second reader loads the first's
    file) and evaluate_detections (difficult boxes neither TP nor FP)."""
    ref_imdb = JPascalVOC("2007_trainval", str(tmp_path / "jax_root"), voc_devkit)
    imdb = PascalVOC("2007_trainval", str(tmp_path / "port_root"), voc_devkit)
    assert (imdb.name, imdb.classes, imdb.image_set_index, imdb.num_images) == (
        ref_imdb.name, ref_imdb.classes, ref_imdb.image_set_index, 2)
    got, ref = imdb.gt_roidb(), ref_imdb.gt_roidb()
    assert os.path.exists(tmp_path / "port_root" / "cache" / "voc_2007_trainval_gt_roidb.pkl")
    cached = PascalVOC("2007_trainval", str(tmp_path / "port_root"), voc_devkit).gt_roidb()
    for a, b, c in zip(got, ref, cached):
        assert set(a) == set(b) == set(c)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            np.testing.assert_array_equal(c[key], b[key], err_msg=key)
    assert imdb._load_annotation_with_difficult("000001")["difficult"].tolist() == [False, True]

    rng = np.random.RandomState(4)
    dets = [[np.zeros((0, 5), np.float32) for _ in range(2)] for _ in imdb.classes]
    for cls in ("dog", "cat", "person", "bird"):
        j = imdb.classes.index(cls)
        for i in range(2):
            d = np.array([[9, 19, 109, 119], [0, 0, 29, 29], [50, 60, 150, 160]], np.float32)
            d = d + rng.randn(3, 4).astype(np.float32) * 3
            dets[j][i] = np.hstack([d, rng.rand(3, 1).astype(np.float32)])
    for use_07 in (None, False):
        assert imdb.evaluate_detections(dets, use_07) == ref_imdb.evaluate_detections(dets, use_07)
    assert imdb.evaluate_detections(dets)["dog"] > 0


def test_synthetic_evaluate_detections_matches_jax():
    """Same records (classes absent from the gt skipped) and mAP; the gt as
    detections scores 1.0, and with polygon records and the gt masks as
    detections the segm stats are JAX's, AP 1.0."""
    ds = SyntheticDataset(num_images=6, num_classes=8, image_size=(160, 200), max_boxes=3)
    ref_ds = JSyntheticDataset(num_images=6, num_classes=8, image_size=(160, 200), max_boxes=3)
    assert (ds.name, ds.root_path, ds.num_images) == (ref_ds.name, ref_ds.root_path, 6)
    roidb = ds.gt_roidb()
    rng = np.random.RandomState(5)
    dets = [[None] * 6] + [
        [np.hstack([r["boxes"] + rng.randn(*r["boxes"].shape).astype(np.float32) * 8,
                    rng.rand(len(r["boxes"]), 1).astype(np.float32)])
         for r in roidb] for _ in range(1, 8)
    ]
    got = ds.evaluate_detections(dets)
    assert got == ref_ds.evaluate_detections(dets)
    present = {f"class{c}" for r in roidb for c in r["gt_classes"]}
    assert set(got) == present | {"mAP"}
    gt_dets = [[None] * 6] + [
        [np.hstack([r["boxes"][r["gt_classes"] == j], np.ones(((r["gt_classes"] == j).sum(), 1),
                                                               np.float32)])
         for r in roidb] for j in range(1, 8)
    ]
    assert ds.evaluate_detections(gt_dets)["mAP"] == 1.0
    masked = SyntheticDataset(num_images=6, num_classes=8, image_size=(160, 200), max_boxes=3,
                              with_masks=True)
    ref_masked = JSyntheticDataset(num_images=6, num_classes=8, image_size=(160, 200),
                                   max_boxes=3, with_masks=True)
    roidb = masked.gt_roidb()
    gt_dets = [[None] * 6] + [
        [np.hstack([r["boxes"][r["gt_classes"] == j], np.ones(((r["gt_classes"] == j).sum(), 1),
                                                               np.float32)])
         for r in roidb] for j in range(1, 8)
    ]
    gt_masks = [[]] + [
        [[rle.from_polygons(seg, r["height"], r["width"])
          for seg, c in zip(r["segmentation"], r["gt_classes"]) if c == j]
         for r in roidb] for j in range(1, 8)
    ]
    got = masked.evaluate_detections(gt_dets, all_masks=gt_masks)
    assert got == ref_masked.evaluate_detections(gt_dets, all_masks=gt_masks)
    assert got["mAP"] == 1.0 and got["segm_AP"] == 1.0


def test_imdb_base_and_load_data(tmp_path):
    imdb = IMDB("x", str(tmp_path))
    assert imdb.load_cached("t", lambda: [1, 2]) == [1, 2]
    assert imdb.load_cached("t", lambda: [3]) == [1, 2]  # from the pickle
    assert merge_roidbs([[1], [2, 3]]) == [1, 2, 3]
    cfg = port_cfg(j_generate_config("resnet50", "PascalVOC"))
    imdbs, roidb = load_data.load_gt_roidb(cfg, flip=True, synthetic_size=3)
    assert len(imdbs) == 1 and imdbs[0].num_classes == 21 and len(roidb) == 6
    assert [r["flipped"] for r in roidb] == [False] * 3 + [True] * 3
    # the coco branch reaches the COCO reader (tests/test_torch_mask_train.py
    # holds it against JAX's)
    (tmp_path / "annotations").mkdir()
    (tmp_path / "annotations" / "instances_val2017.json").write_text(
        '{"images": [], "annotations": [], "categories": [{"id": 1, "name": "a"}]}')
    coco = cfg.replace(dataset=dataclasses.replace(cfg.dataset, name="coco",
                                                   dataset_path=str(tmp_path)))
    (reader,) = load_data.get_imdb(coco, "val2017")
    assert type(reader).__name__ == "COCO" and reader.classes == ["__background__", "a"]


# ------------------------------------------------------------ host decode
@pytest.mark.parametrize("seed", [0, 1])
def test_np_bbox_pred_and_clip_bit_identical(seed):
    rng = np.random.RandomState(seed)
    boxes = rng.rand(50, 4).astype(np.float32) * 300
    boxes[:, 2:] += boxes[:, :2]
    deltas = (rng.randn(50, 4 * 6) * 2).astype(np.float32)
    deltas[0, 2] = 20.0  # past the log(1000/16) clip
    got = np_bbox_pred(boxes, deltas)
    ref = j_np_bbox_pred(boxes, deltas)
    assert got.dtype == ref.dtype == np.float32
    assert got.tobytes() == ref.tobytes()
    assert np_clip_boxes(got, (333, 500)).tobytes() == j_np_clip_boxes(ref, (333, 500)).tobytes()


# --------------------------------------------------------------- host NMS
def _tied_dets(rng, n):
    boxes = rng.rand(n, 4).astype(np.float32) * 100
    boxes[:, 2:] = boxes[:, :2] + rng.rand(n, 2).astype(np.float32) * 50 + 1
    if n:
        boxes[n // 2:n // 2 + 3] = boxes[0]  # identical boxes
    scores = np.round(rng.rand(n) * 4) / 4  # few distinct scores: ties
    return np.hstack([boxes, scores[:, None]]).astype(np.float32)


@pytest.mark.parametrize("thresh", [0.3, 0.7])
@pytest.mark.parametrize("n", [0, 1, 17, 300])
def test_nms_host_keeps_what_jax_and_nms_numpy_keep(n, thresh):
    """The C path's keep list equals JAX's C ``nms_host`` and the port's
    ``nms_numpy`` index for index, ties in score included; the numpy path
    (no compiler) keeps the same list."""
    dets = _tied_dets(np.random.RandomState(n), n)
    got = hostops.nms_host(dets, thresh)
    assert hostops.backend() == "c"
    assert got == j_nms_host(dets, thresh) == nms_numpy(dets, thresh)


def test_nms_host_without_a_compiler_uses_nms_numpy(monkeypatch, caplog):
    monkeypatch.setattr(hostops, "_LIB", None)
    monkeypatch.setattr(hostops, "_TRIED", False)
    monkeypatch.setenv("CC", "no-such-compiler")
    monkeypatch.setattr(hostops, "BUILD_DIR", hostops.BUILD_DIR.parent / "build_missing")
    monkeypatch.setattr(hostops.shutil, "which", lambda cc: None)
    dets = _tied_dets(np.random.RandomState(9), 40)
    with caplog.at_level(logging.WARNING, logger=hostops.__name__):
        assert hostops.nms_host(dets, 0.3) == nms_numpy(dets, 0.3)
    assert hostops.backend() == "numpy"
    assert "nms_numpy" in caplog.text
    assert not hostops.BUILD_DIR.exists()


# ------------------------------------------------------------ test batches
@pytest.fixture(scope="module")
def loader_setup():
    jcfg = j_generate_config("resnet50", "PascalVOC")
    jcfg = jcfg.replace(
        dataset=dataclasses.replace(jcfg.dataset, SCALES=((128, 160),)),
        SHAPE_BUCKETS=((128, 160), (160, 128)),
    )
    wide = SyntheticDataset(num_images=3, image_size=(124, 150), max_boxes=2).gt_roidb()
    tall = SyntheticDataset(num_images=2, image_size=(150, 124), max_boxes=2, seed=50).gt_roidb()
    roidb = [wide[0], tall[0], wide[1], wide[2], tall[1]]
    return jcfg, port_cfg(jcfg), roidb


def _same_batch(got, ref):
    assert set(got) == set(ref)
    assert got["images"].dtype == ref["images"].dtype == np.uint8
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.fixture
def same_resize(monkeypatch):
    """JAX's loader with the port's resize: the JAX package resizes with
    cv2, whose float INTER_LINEAR rounds differently from the port's numpy
    twin (``data/image.py``; the SIMD path cv2 dispatches to depends on the
    host), so the loaders are compared on the same pixels and the resize is
    held to cv2 in ``test_test_batches_against_cv2``."""
    monkeypatch.setattr(jloader, "prepare_image", timage.prepare_image)


def test_test_loader_one_at_a_time_matches_jax(loader_setup, same_resize):
    jcfg, cfg, roidb = loader_setup
    got = list(tloader.TestLoader(roidb, cfg))
    ref = list(jloader.TestLoader(roidb, jcfg))
    assert len(got) == len(ref) == 5
    for (grec, gb), (rrec, rb) in zip(got, ref):
        assert grec is rrec
        _same_batch(gb, rb)
    assert got[1][1]["images"].shape == (1, 160, 128, 3)


@pytest.mark.parametrize("workers", [0, 2])
def test_test_loader_batched_matches_jax(loader_setup, same_resize, workers):
    """Batches of 2 by orientation bucket (ragged tails at their own size),
    assembled on a prefetch thread or in 2 spawned processes, equal JAX's
    serial stream: indices, records, uint8 images bitwise, im_info,
    orig_hw."""
    jcfg, cfg, roidb = loader_setup
    stream = tloader.TestLoader(roidb, cfg, batch_size=2).iter_batched(assembly_workers=workers)
    got = list(stream)
    stream.close()
    ref = list(jloader.TestLoader(roidb, jcfg, batch_size=2).iter_batched(assembly_workers=0))
    assert [g[0] for g in got] == [r[0] for r in ref] == [[0, 2], [3], [1, 4]]
    for (gi, grecs, gb), (ri, rrecs, rb) in zip(got, ref):
        assert [r["image"] for r in grecs] == [r["image"] for r in rrecs]
        _same_batch(gb, rb)
    if workers:
        assert stream.stats()["yielded"] == 3


def test_test_batches_against_cv2(loader_setup):
    """With JAX's own cv2 resize the uint8 images differ by at most 1 LSB,
    and only where the port's float resize lies within 1e-4 of a rounding
    boundary (the two float resizes agree to ~3e-5)."""
    jcfg, cfg, roidb = loader_setup
    for (rec, gb), (_, rb) in zip(tloader.TestLoader(roidb, cfg), jloader.TestLoader(roidb, jcfg)):
        np.testing.assert_array_equal(gb["im_info"], rb["im_info"])
        diff = gb["images"].astype(np.int16) - rb["images"].astype(np.int16)
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 1e-3
        h, w = int(gb["im_info"][0, 0]), int(gb["im_info"][0, 1])
        resized, _ = timage.resize_im(tloader.load_record_image(rec), *cfg.dataset.SCALES[0])
        off = np.abs(resized - np.floor(resized) - 0.5)
        assert (off[diff[0, :h, :w] != 0] < 1e-4).all()


def test_test_loader_refuses_proposals(loader_setup):
    """``proposal_count`` > 0 (Fast R-CNN test batches) no longer raises:
    each batch carries the records' proposals scaled by the resize factor
    and cut or padded to the count, with ``prop_valid``, bitwise as the
    JAX TestLoader's, one image at a time and batched."""
    jcfg, cfg, roidb = loader_setup
    rng = np.random.RandomState(3)
    roidb = [dict(r, proposals=(rng.rand(n, 4) * 60 + [0, 0, 60, 60]).astype(np.float32))
             for r, n in zip(roidb, (4, 15, 10, 0, 7))]
    pairs = zip(tloader.TestLoader(roidb, cfg, proposal_count=10),
                jloader.TestLoader(roidb, jcfg, proposal_count=10))
    for (_, got), (_, ref) in pairs:
        np.testing.assert_array_equal(got["im_info"], ref["im_info"])
        for key in ("proposals", "prop_valid"):
            assert got[key].dtype == ref[key].dtype and got[key].shape[1] == 10, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    got = list(tloader.TestLoader(roidb, cfg, proposal_count=10, batch_size=2)
               .iter_batched(prefetch=0, assembly_workers=0))
    ref = list(jloader.TestLoader(roidb, jcfg, proposal_count=10, batch_size=2)
               .iter_batched(prefetch=0, assembly_workers=0))
    assert [g[0] for g in got] == [r[0] for r in ref]
    for (_, _, gb), (_, _, rb) in zip(got, ref):
        for key in ("proposals", "prop_valid"):
            np.testing.assert_array_equal(gb[key], rb[key], err_msg=key)
    assert sum(int(b["prop_valid"].sum()) for _, _, b in got) == 4 + 10 + 10 + 0 + 7


# --------------------------------------------------------------------- CLI
def _cli_cfg(network, dataset):
    """The CLI's config cut to a CPU size: ResNet-50 C4 at 128 × 128, 200 →
    32 test proposals (``tests/test_model.py::tiny_cfg``)."""
    jcfg = j_generate_config("resnet50", dataset)
    jcfg = jcfg.replace(
        dataset=dataclasses.replace(jcfg.dataset, SCALES=((128, 128),)),
        SHAPE_BUCKETS=((128, 128),),
        TEST=dataclasses.replace(jcfg.TEST, RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=32),
    )
    return port_cfg(jcfg)


@pytest.fixture
def params_pickle(tmp_path, monkeypatch):
    monkeypatch.setattr(test_cli, "generate_config", _cli_cfg)
    model = FasterRCNN(_cli_cfg("resnet50", "PascalVOC"), torch.Generator().manual_seed(1))
    path = str(tmp_path / "params.pkl")
    save_params(path, torch_to_flax(model))
    return path


def test_cli_evaluates_on_the_cpu(params_pickle, tmp_path, caplog):
    """``--synthetic 2 --params <pickle> --cpu 1`` evaluates and logs the
    mAP; the dump round-trips; the JAX trainer's run_meta.json beside the
    pickle applies."""
    j_save_run_meta(params_pickle, j_generate_config("resnet50", "PascalVOC"))
    assert load_params(params_pickle)["rcnn"]["cls_score"]["kernel"].shape == (2048, 21)
    dump = str(tmp_path / "dets.pkl")
    with caplog.at_level(logging.INFO):
        results = test_cli.main(["--synthetic", "2", "--params", params_pickle, "--cpu", "1",
                                 "--dump", dump])
    assert "mAP" in results and 0.0 <= results["mAP"] <= 1.0
    assert f"mAP: {results['mAP']:.4f}" in caplog.text
    assert "applied run_meta overrides" in caplog.text
    with open(dump, "rb") as f:
        all_boxes = pickle.load(f)
    assert len(all_boxes) == 21 and len(all_boxes[1]) == 2


def test_cli_refuses_what_is_not_ported(params_pickle, tmp_path, monkeypatch, caplog):
    """No card: the CLI raises rather than fall back to the CPU.  A pickle
    of jax.Array leaves raises.  ``--network vgg`` is ported: the seeded
    VGG-16 (ROIPooling) evaluates on the CPU at a 96 × 128 canvas."""
    base = ["--synthetic", "2", "--params", params_pickle]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            test_cli.main(base)

    def vgg_cfg(network, dataset):
        assert network == "vgg"
        cfg = j_generate_config("vgg", dataset)
        return port_cfg(cfg.replace(
            dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
            SHAPE_BUCKETS=((96, 128),),
            TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16)))

    monkeypatch.setattr(test_cli, "generate_config", vgg_cfg)
    with caplog.at_level(logging.INFO):
        results = test_cli.main(["--cpu", "1", "--synthetic", "2", "--network", "vgg",
                                 "--prefix", str(tmp_path / "no_checkpoint")])
    assert "mAP" in results and 0.0 <= results["mAP"] <= 1.0
    # a pickle of jax.Array leaves needs JAX to read
    jax_path = str(tmp_path / "jax_params.pkl")
    save_params(jax_path, {"rpn": {"bias": jnp.zeros(3)}})
    with pytest.raises(ValueError, match="jax.device_get"):
        test_cli.load_flax_params(jax_path)
