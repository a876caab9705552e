"""The PyTorch port's Mask R-CNN inference slice on the CPU against the JAX
package, on the same numpy-seeded inputs and bridged weights: the mask head
(and the parameter bridge's flipped ``mask_deconv`` kernel), the mask
model's ``test_forward``, the device mask selection and the fixed-point
canvas paste of ``ops/postprocess.py``, both mask branches of
``detections_from_output``, RLE (``native/rle.py``), the mask paste and RLEs
of ``eval/segm.py``, COCO bbox / segm evaluation, the synthetic polygon
records, and ``tools/test.py --network mask_resnet_fpn`` against JAX's
``pred_eval``.

The model is ``generate_config("mask_resnet_fpn", "coco")`` (the 256-channel
neck, 14 × 14 pooling, the 28 × 28 mask head) at ResNet-50 depth, 5 classes
and CPU size (``tests/test_torch_fpn_infer.py::small_cfgs``)."""

import dataclasses
import logging
import pickle

import cv2
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.core.tester import Predictor as JPredictor
from mx_rcnn_tpu.core.tester import pred_eval as j_pred_eval
from mx_rcnn_tpu.data import loader as jloader
from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from mx_rcnn_tpu.data.synthetic import synthetic_image as j_synthetic_image
from mx_rcnn_tpu.eval import segm as jsegm
from mx_rcnn_tpu.eval.coco_eval import COCOEvalBbox as JCOCOEvalBbox
from mx_rcnn_tpu.models.fpn import FPNFasterRCNN as JFPNFasterRCNN
from mx_rcnn_tpu.models.heads import MaskHead as JMaskHead
from mx_rcnn_tpu.native import rle as jrle
from mx_rcnn_tpu.ops.postprocess import make_test_postprocess as j_make_postprocess
from mx_rcnn_tpu.serve.runner import cap_detections as j_cap_detections
from mx_rcnn_tpu.serve.runner import detections_from_output as j_detections_from_output
from mx_rcnn_tpu_torch.core.tester import Predictor, fetch_outputs, im_detect
from mx_rcnn_tpu_torch.data import loader as tloader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset, synthetic_image
from mx_rcnn_tpu_torch.eval import segm as tsegm
from mx_rcnn_tpu_torch.eval.coco_eval import COCOEvalBbox
from mx_rcnn_tpu_torch.models.heads import MaskHead
from mx_rcnn_tpu_torch.native import rle
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess
from mx_rcnn_tpu_torch.serve.runner import cap_detections, detections_from_output
from mx_rcnn_tpu_torch.tools import test as test_cli
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, torch_to_flax
from tests.test_postprocess import _fake_mask_outputs
from tests.test_torch_fpn_infer import (
    NUM_CLASSES,
    NUM_IMAGES,
    calibrated_model,
    cli_params,  # noqa: F401 — the fixture
    clean_render_cache,  # noqa: F401 — the fixture
    dataset,
    first_batch,
    small_cfgs,
)
from tests.test_torch_model import _perturb

torch.set_num_threads(2)

K = NUM_CLASSES


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# ------------------------------------------------------------- mask head
@pytest.fixture(scope="module")
def mask_head():
    """(JAX MaskHead, its perturbed Flax params, input, JAX output)."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 14, 14, 8).astype(np.float32)
    jhead = JMaskHead(num_classes=5, channels=16)
    params = jhead.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = _perturb(jax.tree.map(np.asarray, dict(params)), np.random.RandomState(1))
    params = {k: {n: (a + rng.randn(*a.shape).astype(np.float32) * 0.1 if n == "bias" else a)
                  for n, a in v.items()} for k, v in params.items()}
    return jhead, params, x, np.asarray(jhead.apply({"params": params}, jnp.asarray(x)))


def _port_head(params):
    holder = torch.nn.Module()
    holder.mask_head = MaskHead(8, 5, 16)
    return flax_to_torch({"mask_head": params}, holder)


def test_mask_head_matches_jax(mask_head):
    """(R, 14, 14, C) → (R, 28, 28, K) logits within 1e-5 (relative and
    absolute): four 3 × 3 convs, the 2 × 2 stride-2 transposed conv, the
    1 × 1 logits."""
    _, params, x, ref = mask_head
    holder = _port_head(params)
    with torch.inference_mode():
        got = holder.mask_head(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (3, 28, 28, 5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_deconv_bridge_flips_the_kernel(mask_head):
    """Flax's ConvTranspose (SAME, no kernel transpose) writes output cell
    2i with tap 1 and 2i + 1 with tap 0: torch's ConvTranspose2d with the
    kernel flipped.  Without the flip the forward is wrong although the
    round trip would still be exact; with it the round trip is exact layer
    by layer."""
    _, params, x, _ = mask_head
    xj = jnp.asarray(np.random.RandomState(2).randn(1, 3, 3, 16).astype(np.float32))
    deconv = fnn.ConvTranspose(16, (2, 2), strides=(2, 2), name="mask_deconv")
    p = params["mask_deconv"]
    ref = np.asarray(deconv.apply({"params": p}, xj))
    holder = _port_head(params)
    t = holder.mask_head.mask_deconv
    with torch.inference_mode():
        got = t(torch.from_numpy(np.array(xj)).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        unflipped = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(np.array(xj)).permute(0, 3, 1, 2),
            torch.from_numpy(p["kernel"].transpose(2, 3, 0, 1).copy()), t.bias, stride=2,
        ).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert np.abs(unflipped - ref).max() > 1e-2
    back = dict(_leaves(torch_to_flax(holder)["mask_head"]))
    assert set(back) == set(dict(_leaves(params)))
    for path, a in _leaves(params):
        assert back[path].tobytes() == a.tobytes(), "/".join(path)


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def mask_setup():
    """(port cfg, JAX cfg, port model, Flax tree, JAX model, a test batch of
    2 synthetic masked COCO-sized images, both forwards' outputs)."""
    cfg, jcfg = small_cfgs("mask_resnet_fpn")
    assert cfg.network.USE_MASK and cfg.dataset.NUM_CLASSES == K
    roidb = dataset(JSyntheticDataset, with_masks=True).gt_roidb()
    jloader._RENDER_CACHE.clear()
    batch = first_batch(cfg, roidb)
    model, params_np = calibrated_model(cfg, batch, seed=1)
    jmodel = JFPNFasterRCNN(jcfg)
    raw = {k: v for k, v in batch.items() if k != "orig_hw"}
    ref = jax.tree.map(np.asarray, JPredictor(jmodel, params_np).predict(raw))
    got = Predictor(model, device="cpu").predict(raw)
    return cfg, jcfg, model, params_np, jmodel, batch, ref, got


def test_mask_test_forward_matches_jax(mask_setup):
    """The box outputs at ``tests/test_torch_fpn_infer.py``'s bars and
    ``mask_logits`` (B, R, 28, 28, K) within 1e-4 of the largest logit on
    the valid rois.  The bar scales with the logits: the two packages'
    float32 backbones drift apart by depth in this calibrated random
    ResNet-50 (C2 ~2e-5, C5 ~5e-4 absolute on unit-deviation maps; the mask
    head alone agrees to ~1e-6 relative at full width), so the unit-scale
    logits (largest ~9) differ by up to ~2e-4.  The logits are O(1), so the
    masks are neither all empty nor all full."""
    *_, ref, got = mask_setup
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["roi_valid"], ref["roi_valid"])
    v = ref["roi_valid"].astype(bool)
    assert got["mask_logits"].shape == ref["mask_logits"].shape == (2, 24, 28, 28, K)
    largest = float(np.abs(ref["mask_logits"][v]).max())
    for k, tol in (("rois", 1e-4), ("roi_scores", 1e-4), ("cls_prob", 1e-4),
                   ("bbox_deltas", 1e-3), ("mask_logits", 1e-4 * largest)):
        np.testing.assert_allclose(got[k][v], ref[k][v], atol=tol, rtol=0, err_msg=k)
    frac = (ref["mask_logits"][v] >= 0).mean()
    assert 0.05 < frac < 0.95, frac


def _run(pp, out, batch, canvas_hw, jax_side):
    """``pp`` on host outputs → host outputs; ``canvas_hw`` only for a
    ``paste`` postprocess."""
    extra = () if canvas_hw is None else (canvas_hw,)
    if jax_side:
        return jax.tree.map(np.asarray, pp(
            {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(batch["im_info"]),
            jnp.asarray(batch["orig_hw"]), *extra))
    return fetch_outputs(pp({k: torch.from_numpy(v) for k, v in out.items()},
                            torch.from_numpy(batch["im_info"]),
                            torch.from_numpy(batch["orig_hw"]), *extra))


def test_device_postprocess_after_the_forward_matches_jax(mask_setup):
    """Each package's postprocess on its own forward: ``det_valid`` and
    ``det_mask_idx`` equal, ``det_boxes`` within 1e-3 px, ``det_masks``
    within 1e-4 of the largest logit (the forward's bar)."""
    cfg, jcfg, *_, batch, ref, got = mask_setup
    te = cfg.TEST
    jpp = jax.jit(j_make_postprocess(jcfg, K, te.SCORE_THRESH, max_out=te.DET_PER_CLASS))
    pp = make_test_postprocess(cfg, K, te.SCORE_THRESH, max_out=te.DET_PER_CLASS)
    r, g = _run(jpp, ref, batch, None, True), _run(pp, got, batch, None, False)
    np.testing.assert_array_equal(g["det_valid"], r["det_valid"])
    np.testing.assert_array_equal(g["det_mask_idx"], r["det_mask_idx"])
    np.testing.assert_array_equal(g["det_mask_valid"], r["det_mask_valid"])
    m = r["det_valid"]
    assert m.sum() > 10 and r["det_mask_valid"].sum() > 10
    np.testing.assert_allclose(g["det_boxes"][m], r["det_boxes"][m], atol=1e-3, rtol=0)
    largest = float(np.abs(r["det_masks"][r["det_mask_valid"]]).max())
    np.testing.assert_allclose(g["det_masks"], r["det_masks"], atol=1e-4 * largest, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_selection_and_canvas_bitwise_on_identical_inputs(seed):
    """The same raw outputs (``tests/test_postprocess.py``'s fake mask head)
    into both postprocesses with ``paste=True``: the selection and the fill
    bit for bit, boxes within 1e-4 px (decode rounding), and the int32
    fixed-point canvas bitwise equal to JAX's and to
    ``paste_mask_canvas`` on every survivor."""
    cfg, jcfg = small_cfgs("mask_resnet_fpn")
    cfg = cfg.replace(TEST=dataclasses.replace(cfg.TEST, MAX_PER_IMAGE=12))
    jcfg = jcfg.replace(TEST=dataclasses.replace(jcfg.TEST, MAX_PER_IMAGE=12))
    te = cfg.TEST
    out, im_info = _fake_mask_outputs(np.random.RandomState(seed), k=5, s=28)
    orig_hw = np.floor(im_info[:, :2] / im_info[:, 2:3]).astype(np.float32)
    batch = {"im_info": im_info, "orig_hw": orig_hw}
    canvas_hw = (416, 512)
    jpp = jax.jit(j_make_postprocess(jcfg, 5, 0.05, max_out=te.DET_PER_CLASS, paste=True),
                  static_argnums=3)
    pp = make_test_postprocess(cfg, 5, 0.05, max_out=te.DET_PER_CLASS, paste=True)
    assert pp.wants_canvas
    r, g = _run(jpp, out, batch, canvas_hw, True), _run(pp, out, batch, canvas_hw, False)
    for k in ("det_valid", "det_mask_idx", "det_mask_valid", "det_masks", "det_canvas"):
        assert g[k].dtype == r[k].dtype and g[k].tobytes() == r[k].tobytes(), k
    np.testing.assert_allclose(g["det_boxes"], r["det_boxes"], atol=1e-4, rtol=0)
    assert g["det_canvas"].shape == (2, 12) + canvas_hw
    assert not g["det_mask_valid"].all() or g["det_canvas"].any()
    assert (g["det_masks"][~g["det_mask_valid"]] == -80.0).all()
    pasted = 0
    for b in range(2):
        flat = g["det_boxes"][b].reshape(-1, 4)
        for p in np.where(g["det_mask_valid"][b])[0]:
            box = flat[g["det_mask_idx"][b, p]] * im_info[b, 2]
            expect = tsegm.paste_mask_canvas(g["det_masks"][b, p], box, *canvas_hw)
            assert g["det_canvas"][b, p].tobytes() == expect.tobytes()
            assert expect.tobytes() == jsegm.paste_mask_canvas(
                g["det_masks"][b, p], box, *canvas_hw).tobytes()
            pasted += int(expect.any())
    assert pasted > 5


def test_predictor_passes_the_bucket_canvas(mask_setup):
    """A ``paste`` postprocess gets the batch's padded extent: the device
    canvas is (B, max_det, Hc, Wc) and equals ``paste_mask_canvas``."""
    cfg, _, model, *_, batch, _, _ = mask_setup
    te = cfg.TEST
    pp = make_test_postprocess(cfg, K, te.SCORE_THRESH, max_out=te.DET_PER_CLASS, paste=True)
    out = Predictor(model, pp, device="cpu").predict(batch)
    hc, wc = batch["images"].shape[1:3]
    assert out["det_canvas"].shape == (2, cfg.TEST.MAX_PER_IMAGE, hc, wc)
    flat = out["det_boxes"][0].reshape(-1, 4)
    for p in np.where(out["det_mask_valid"][0])[0][:10]:
        box = flat[out["det_mask_idx"][0, p]] * batch["im_info"][0, 2]
        expect = tsegm.paste_mask_canvas(out["det_masks"][0, p], box, hc, wc)
        assert out["det_canvas"][0, p].tobytes() == expect.tobytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_detections_from_output_mask_branches_bit_identical(seed):
    """Both branches against JAX's on the same host outputs, bit for bit:
    the device flavor's ``det_mask_idx`` lookup, −80 fill and host sigmoid,
    the host flavor's ``mask_probs[keep][keep_nms, :, :, j]``; then the cap
    with ``mask_probs`` and the image-space RLEs."""
    cfg, jcfg = small_cfgs("mask_resnet_fpn")
    cfg = cfg.replace(TEST=dataclasses.replace(cfg.TEST, MAX_PER_IMAGE=10))
    jcfg = jcfg.replace(TEST=dataclasses.replace(jcfg.TEST, MAX_PER_IMAGE=10))
    out, im_info = _fake_mask_outputs(np.random.RandomState(seed), k=5)
    orig_hw = np.floor(im_info[:, :2] / im_info[:, 2:3]).astype(np.float32)
    dev = fetch_outputs(make_test_postprocess(cfg, 5, 0.05, max_out=32)(
        {k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(im_info),
        torch.from_numpy(orig_hw)))
    for b in range(2):
        h, w = int(orig_hw[b][0]), int(orig_hw[b][1])
        det = im_detect(out, im_info[b], tuple(orig_hw[b]), index=b)
        assert det["mask_probs"].shape[1:] == (14, 14, 5)
        for flavor in (dev, out):
            dets, probs = detections_from_output(flavor, im_info[b], tuple(orig_hw[b]), cfg, 5,
                                                 index=b, thresh=0.05)
            rdets, rprobs = j_detections_from_output(flavor, im_info[b], tuple(orig_hw[b]),
                                                     jcfg, 5, index=b, thresh=0.05)
            dets, probs = cap_detections(dets, cfg.TEST.MAX_PER_IMAGE, probs)
            rdets, rprobs = j_cap_detections(rdets, jcfg.TEST.MAX_PER_IMAGE, rprobs)
            assert sum(len(d) for d in dets[1:]) == 10
            for j in range(1, 5):
                assert dets[j].tobytes() == rdets[j].tobytes(), j
                assert probs[j].dtype == rprobs[j].dtype
                assert probs[j].tobytes() == rprobs[j].tobytes(), j
                assert tsegm.rles_for_detections(probs[j], dets[j], h, w) == \
                    jsegm.rles_for_detections(rprobs[j], rdets[j], h, w)


# ------------------------------------------------------------------ RLE
def _random_masks(rng, n, h, w):
    return [(rng.rand(h, w) < rng.uniform(0.1, 0.7)).astype(np.uint8) for _ in range(n)]


@pytest.fixture(params=["c", "numpy"])
def backend(request, monkeypatch):
    """The port's RLE on its C library and on its numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(rle, "_LIB", None)
        monkeypatch.setattr(rle, "_TRIED", True)
    else:
        assert rle.backend() == "c"
    return request.param


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_matches_jax(backend, seed):
    """encode, decode, area, merge, iou (crowd included), from_polygons and
    the compressed counts string: byte- or float-identical to JAX's
    (``mx_rcnn_tpu/native/rle.py``, its C library)."""
    rng = np.random.RandomState(seed)
    h, w = 37, 53
    masks = _random_masks(rng, 5, h, w) + [np.ones((h, w), np.uint8), np.zeros((h, w), np.uint8)]
    rles = [rle.encode(m) for m in masks]
    for m, r in zip(masks, rles):
        assert r == jrle.encode(m)
        assert rle.decode(r).tobytes() == jrle.decode(r).tobytes() == m.tobytes()
        assert rle.area(r) == jrle.area(r) == float(m.sum())
    assert rle.merge(rles[:4]) == jrle.merge(rles[:4])
    crowd = [0, 1, 0, 0]
    got, ref = rle.iou(rles[:3], rles[3:], crowd), jrle.iou(rles[:3], rles[3:], crowd)
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    polys = [[10.5, 3.0, 40.0, 8.25, 30.0, 30.0, 5.0, 25.5], [0.0, 0.0, 12.0, 0.0, 6.0, 9.5]]
    assert rle.from_polygons(polys, h, w) == jrle.from_polygons(polys, h, w)
    for p in ([-5.0, -9.0, 60.0, -2.0, 30.0, 50.0], list(rng.rand(16) * 50)):
        assert rle.from_polygons([p], h, w) == jrle.from_polygons([p], h, w)
    s = "ZhX14f1P00002N1O1O1N2O"
    assert rle.counts_from_string(s) == jrle.counts_from_string(s)
    assert rle.ensure_list_counts({"size": [h, w], "counts": s}) == \
        jrle.ensure_list_counts({"size": [h, w], "counts": s})


# -------------------------------------------------------------- paste
def test_paste_mask_matches_cv2_but_for_threshold_pixels():
    """``paste_mask`` resizes with the port's numpy INTER_LINEAR
    (``data/image.py::resize_to``) where JAX's calls ``cv2.resize``: the
    pasted masks are equal except where the resized probability lies within
    1e-4 of the 0.5 threshold; those pixels are counted."""
    rng = np.random.RandomState(0)
    flipped, total = 0, 0
    for _ in range(60):
        prob = rng.rand(28, 28).astype(np.float32)
        # grids with exact 0.5 plateaus put pixels on the threshold
        prob[rng.rand(28, 28) < 0.2] = 0.5
        x1, y1 = rng.uniform(-20, 200, 2)
        box = np.array([x1, y1, x1 + rng.uniform(0, 150), y1 + rng.uniform(0, 150)], np.float32)
        got = tsegm.paste_mask(prob, box, 240, 260)
        ref = jsegm.paste_mask(prob, box, 240, 260)
        total += int(ref.sum())
        diff = got != ref
        if diff.any():
            bw = max(int(np.ceil(box[2])) - int(np.floor(box[0])) + 1, 1)
            bh = max(int(np.ceil(box[3])) - int(np.floor(box[1])) + 1, 1)
            resized = cv2.resize(prob, (bw, bh))
            ys, xs = np.nonzero(diff)
            near = resized[ys - int(np.floor(box[1])), xs - int(np.floor(box[0]))]
            assert (np.abs(near - 0.5) <= 1e-4).all()
            flipped += int(diff.sum())
    assert total > 10000
    assert flipped <= 1e-3 * total, (flipped, total)


# ----------------------------------------------------- COCO segm / bbox
@pytest.fixture(scope="module")
def masked_sets():
    return (SyntheticDataset(num_images=3, num_classes=5, image_size=(140, 180), with_masks=True),
            JSyntheticDataset(num_images=3, num_classes=5, image_size=(140, 180), with_masks=True))


def test_synthetic_polygon_records_match_jax(masked_sets):
    """``with_masks`` records (polygon segmentations), their renders and the
    COCO dict equal JAX's."""
    ds, jds = masked_sets
    got, ref = ds.gt_roidb(), jds.gt_roidb()
    for g, r in zip(got, ref):
        assert g.keys() == r.keys() and g["segmentation"] == r["segmentation"]
        np.testing.assert_array_equal(g["boxes"], r["boxes"])
        assert synthetic_image(g, 5).tobytes() == j_synthetic_image(r, 5).tobytes()
    assert ds.as_coco_dict() == jds.as_coco_dict()


def test_render_cache_tells_polygon_records_from_box_records():
    """A box-only and a polygon record of one uri, seed and size render
    differently, and the port's render cache keeps them apart."""
    box = SyntheticDataset(num_images=1, num_classes=5, image_size=(140, 180)).gt_roidb()[0]
    masked = SyntheticDataset(num_images=1, num_classes=5, image_size=(140, 180),
                              with_masks=True).gt_roidb()[0]
    assert (box["image"], box["synthetic_seed"]) == (masked["image"], masked["synthetic_seed"])
    first = tloader.load_record_image(box)
    got = tloader.load_record_image(masked)
    assert got.tobytes() == synthetic_image(masked, masked["synthetic_seed"]).tobytes()
    assert got.tobytes() != first.tobytes()


def _coco_results(ds, rng, segm=True):
    """Detections near the gt (jittered boxes, masks of jittered polygons,
    random scores) plus false positives: one list per class and image, and
    the matching RLEs."""
    roidb = ds.gt_roidb()
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in roidb] for _ in range(ds.num_classes)]
    all_masks = [[[] for _ in roidb] for _ in range(ds.num_classes)]
    for i, rec in enumerate(roidb):
        h, w = rec["height"], rec["width"]
        for box, cls, seg in zip(rec["boxes"], rec["gt_classes"], rec["segmentation"]):
            for _ in range(2):
                jit = rng.randn(4).astype(np.float32) * 4
                b = np.clip(box + jit, 0, [w - 1, h - 1, w - 1, h - 1])
                poly = [list(np.asarray(seg[0]) + rng.randn(len(seg[0])) * 3)]
                all_boxes[cls][i] = np.vstack([all_boxes[cls][i],
                                               np.r_[b, rng.rand()][None].astype(np.float32)])
                all_masks[cls][i].append(rle.from_polygons(poly, h, w))
    return all_boxes, all_masks


def test_coco_eval_and_segm_stats_match_jax(masked_sets):
    """``COCOEvalBbox`` bbox and segm stats equal JAX's on identical
    results; ``evaluate_detections(all_masks=...)`` gives the same mAP and
    ``segm_*`` stats."""
    ds, jds = masked_sets
    all_boxes, all_masks = _coco_results(ds, np.random.RandomState(3))
    results = []
    for c in range(1, 5):
        for i in range(3):
            for d, (x1, y1, x2, y2, s) in enumerate(all_boxes[c][i]):
                results.append({"image_id": i, "category_id": c, "score": float(s),
                                "bbox": [float(x1), float(y1), float(x2 - x1 + 1),
                                         float(y2 - y1 + 1)],
                                "segmentation": all_masks[c][i][d]})
    for iou_type in ("bbox", "segm"):
        got = COCOEvalBbox(ds.as_coco_dict(), results, iou_type).evaluate(verbose=False)
        ref = JCOCOEvalBbox(jds.as_coco_dict(), results, iou_type).evaluate(verbose=False)
        assert got == ref, iou_type
        assert 0.05 < got["AP50"] <= 1.0
    got = ds.evaluate_detections(all_boxes, all_masks=all_masks)
    assert got == jds.evaluate_detections(all_boxes, all_masks=all_masks)
    assert {"mAP", "segm_AP", "segm_AP50", "segm_AR_100"} <= set(got)


# ------------------------------------------------------------- the CLI
def test_cli_mask_resnet_fpn_matches_jax_pred_eval(cli_params, caplog):
    """``--network mask_resnet_fpn --dataset coco --synthetic 4 --cpu 1``
    against JAX's ``pred_eval`` with the same weights on the same masked
    images: the detections at ``tests/test_torch_fpn_infer.py``'s bars, box
    mAP within 1e-6, one RLE per detection, and the segm stats within 1e-6
    apart from the pasted pixels that differ.  Those are counted: a pixel
    flips where its probability lies within the forward's logit bar (or
    cv2's rounding, ``test_paste_mask_matches_cv2_but_for_threshold_pixels``)
    of 0.5.  The port's evaluation on JAX's RLEs gives JAX's stats within
    1e-6, so the counted pixels are the only difference, and each moves an
    IoU by one pixel over a mask's area."""
    path, jcfg, params_np, roidb = cli_params("mask_resnet_fpn")
    kept_masks = {}

    def keeping(cls, key):
        orig = cls.evaluate_detections

        def evaluate(self, detections, all_masks=None, **kw):
            kept_masks[key] = all_masks
            return orig(self, detections, all_masks=all_masks, **kw)
        return evaluate

    dump = path + ".dets"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SyntheticDataset, "evaluate_detections", keeping(SyntheticDataset, "port"))
        mp.setattr(JSyntheticDataset, "evaluate_detections", keeping(JSyntheticDataset, "jax"))
        with caplog.at_level(logging.INFO):
            results = test_cli.main(["--network", "mask_resnet_fpn", "--dataset", "coco",
                                     "--synthetic", str(NUM_IMAGES), "--params", path,
                                     "--cpu", "1", "--dump", dump])
        ref, ref_results = j_pred_eval(JPredictor(JFPNFasterRCNN(jcfg), params_np),
                                       jloader.TestLoader(roidb, jcfg),
                                       dataset(JSyntheticDataset, with_masks=True), jcfg)
    assert f"mAP: {results['mAP']:.4f}" in caplog.text
    with open(dump, "rb") as f:
        got = pickle.load(f)
    masks, jmasks = kept_masks["port"], kept_masks["jax"]
    kept = differing = pixels = 0
    for j in range(1, K):
        for i in range(NUM_IMAGES):
            g, r = got[j][i], np.asarray(ref[j][i])
            assert g.shape == r.shape, f"class {j} image {i}"
            np.testing.assert_allclose(g[:, 4], r[:, 4], atol=1e-4, err_msg=f"class {j} image {i}")
            np.testing.assert_allclose(g[:, :4], r[:, :4], atol=1e-3, err_msg=f"class {j} image {i}")
            assert len(masks[j][i]) == len(jmasks[j][i]) == len(g)
            for a, b in zip(masks[j][i], jmasks[j][i]):
                differing += int((rle.decode(a) != jrle.decode(b)).sum())
                pixels += int(rle.area(b))
            kept += len(g)
    assert kept >= 20 and pixels > 10000
    segm = [k for k in ref_results if k.startswith("segm_")]
    assert set(results) == set(ref_results) and len(segm) == 12
    assert abs(results["mAP"] - ref_results["mAP"]) <= 1e-6
    on_jax_masks = dataset(SyntheticDataset, with_masks=True).evaluate_detections(
        got, all_masks=jmasks)
    for k in segm:
        assert abs(on_jax_masks[k] - ref_results[k]) <= 1e-6, k
        assert abs(results[k] - ref_results[k]) <= (1e-6 if differing == 0 else 1e-3), (
            k, differing)
    assert differing <= 1e-3 * pixels, (differing, pixels)
