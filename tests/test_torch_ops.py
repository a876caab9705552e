"""The PyTorch port's ops on the CPU against their JAX counterparts, on the
same numpy-seeded inputs: anchors (bitwise), boxes (1e-6), the plain NMS
(bool-identical masks), the plain ROIAlign (1e-5), proposals, the device
postprocess and the cv2-free resize."""

import dataclasses
import importlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config
from mx_rcnn_tpu.data import image as jimage
from mx_rcnn_tpu.ops import anchors as janchors
from mx_rcnn_tpu.ops import boxes as jboxes
from mx_rcnn_tpu.ops.pallas.nms import nms_mask_pallas, nms_mask_sorted_pallas
from mx_rcnn_tpu.ops.pallas.roi_align import roi_align_pallas
from mx_rcnn_tpu.ops.postprocess import make_test_postprocess as j_make_postprocess
from mx_rcnn_tpu.ops.proposal import propose as j_propose
from mx_rcnn_tpu.ops.roi_align import roi_align as j_roi_align
from mx_rcnn_tpu_torch.config import generate_config as t_generate_config
from mx_rcnn_tpu_torch.data import image as timage
from mx_rcnn_tpu_torch.ops import anchors as tanchors
from mx_rcnn_tpu_torch.ops import boxes as tboxes
from mx_rcnn_tpu_torch.ops import nms as tnms
from mx_rcnn_tpu_torch.ops import roi_align as troi
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess as t_make_postprocess
from mx_rcnn_tpu_torch.ops.proposal import propose as t_propose
from tests.test_nms import random_dets
from tests.test_pallas_roi_align import random_rois
from tests.test_postprocess import _fake_outputs

# the package re-exports the function ``nms`` under the module's name
jnms = importlib.import_module("mx_rcnn_tpu.ops.nms")

# xdist runs several workers on the same cores
torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------- config
@pytest.mark.parametrize("network", ["vgg", "resnet", "resnet50", "resnet_fpn", "mask_resnet_fpn"])
@pytest.mark.parametrize("dataset", ["PascalVOC", "coco"])
def test_generate_config_same_values(network, dataset):
    a = dataclasses.asdict(generate_config(network, dataset))
    b = dataclasses.asdict(t_generate_config(network, dataset))
    assert a == b


# ------------------------------------------------------------- geometry
@pytest.mark.parametrize(
    "base,ratios,scales",
    [(16, (0.5, 1.0, 2.0), (8, 16, 32)), (16, (0.5, 1.0, 2.0), (8,)), (8, (1.0,), (2, 4))],
)
def test_anchors_bitwise(base, ratios, scales):
    np.testing.assert_array_equal(
        tanchors.generate_anchors(base, ratios, scales),
        janchors.generate_anchors(base, ratios, scales),
    )
    np.testing.assert_array_equal(
        tanchors.shifted_anchors(5, 7, base, ratios=ratios, scales=scales),
        janchors.shifted_anchors(5, 7, base, ratios=ratios, scales=scales),
    )


def test_boxes_match(rng):
    a, _ = random_dets(rng, 40)
    q, _ = random_dets(rng, 30)
    np.testing.assert_allclose(
        tboxes.bbox_overlaps(T(a), T(q)).numpy(),
        np.asarray(jboxes.bbox_overlaps(jnp.asarray(a), jnp.asarray(q))),
        rtol=1e-6, atol=1e-6,
    )
    deltas = (rng.randn(40, 4 * 5) * 2).astype(np.float32)  # exercises the exp clip
    tp = tboxes.bbox_pred(T(a), T(deltas)).numpy()
    jp = np.asarray(jboxes.bbox_pred(jnp.asarray(a), jnp.asarray(deltas)))
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tboxes.clip_boxes(T(jp), 60.0, 80.0).numpy(),
        np.asarray(jboxes.clip_boxes(jnp.asarray(jp), (60.0, 80.0))),
    )


# -------------------------------------------------------------------- NMS
def _plain_sorted(boxes, valid, thresh, max_keep=0):
    return tnms.nms_mask_sorted(T(boxes)[None], T(valid)[None], thresh, max_keep)[0].numpy()


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("n", [1, 64, 128, 300])
def test_nms_mask_matches_pallas_fori_and_numpy(rng, thresh, n):
    boxes, scores = random_dets(rng, n)
    got = tnms.nms_mask(T(boxes), T(scores), thresh).numpy()
    pallas = np.asarray(nms_mask_pallas(jnp.asarray(boxes), jnp.asarray(scores), thresh, interpret=True))
    fori = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thresh))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, fori)
    dets = np.hstack([boxes, scores[:, None]])
    oracle = tnms.nms_numpy(dets, thresh)
    assert oracle == jnms.nms_numpy(dets, thresh)
    assert set(np.where(got)[0]) == set(oracle)


def test_nms_invalid_rows_match_fori(rng):
    boxes, scores = random_dets(rng, 200)
    valid = rng.rand(200) > 0.3
    got = tnms.nms_mask(T(boxes), T(scores), 0.5, T(valid)).numpy()
    ref = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), 0.5, jnp.asarray(valid)))
    np.testing.assert_array_equal(got, ref)
    assert not got[~valid].any()


def test_nms_sorted_matches_pallas_sorted_with_invalid(rng):
    # N not a multiple of the kernel tile (64) nor of the Pallas block (128)
    boxes, scores = random_dets(rng, 333)
    order = np.argsort(-scores, kind="stable")
    boxes = boxes[order]
    valid = rng.rand(333) > 0.2
    got = _plain_sorted(boxes, valid, 0.4)
    ref = np.asarray(nms_mask_sorted_pallas(jnp.asarray(boxes), jnp.asarray(valid), 0.4, interpret=True))
    np.testing.assert_array_equal(got, ref)


def test_nms_cross_block_suppression(rng):
    n = 300
    boxes, _ = random_dets(rng, n, span=10000.0)
    scores = np.linspace(1.0, 0.1, n).astype(np.float32)
    boxes[250] = boxes[3] + 0.5  # IoU ~ 1 with a first-tile box
    got = tnms.nms_mask(T(boxes), T(scores), 0.5).numpy()
    ref = np.asarray(nms_mask_pallas(jnp.asarray(boxes), jnp.asarray(scores), 0.5, interpret=True))
    np.testing.assert_array_equal(got, ref)
    assert got[3] and not got[250]


@pytest.mark.parametrize("max_keep", [16, 64, 200])
def test_nms_truncated_exactness(rng, max_keep):
    # clustered sorted boxes: the max_keep mask holds exactly the first
    # max_keep survivors of the full sweep (what nms() reads)
    n = 1024
    ctr = rng.rand(n, 2).astype(np.float32) * 60
    half = (rng.rand(n, 2).astype(np.float32) * 30 + 6) / 2
    boxes = np.hstack([ctr - half, ctr + half])
    valid = np.ones(n, bool)
    full = np.asarray(jnms.nms_mask(jnp.asarray(boxes), None, 0.5, jnp.asarray(valid), sorted_input=True))
    assert full.sum() > max_keep
    trunc = _plain_sorted(boxes, valid, 0.5, max_keep)
    np.testing.assert_array_equal(np.where(trunc)[0], np.where(full)[0][:max_keep])
    np.testing.assert_array_equal(_plain_sorted(boxes, valid, 0.5), full)
    # the Pallas early-exit sweep agrees on the survivors nms() reads
    pallas = np.asarray(nms_mask_sorted_pallas(
        jnp.asarray(boxes), jnp.asarray(valid), 0.5, interpret=True, max_keep=max_keep))
    np.testing.assert_array_equal(np.where(trunc)[0], np.where(pallas)[0][:max_keep])


@pytest.mark.parametrize("shape", ["FPN union", "C4 proposals"])
def test_nms_plain_matches_fori_on_anchor_like_boxes(shape):
    # the kernel bench's inputs (jittered anchors, top-k by a smooth score,
    # so neighbours suppress each other), cut to their first 1200 rows
    from mx_rcnn_tpu_torch.tools import kernel_bench

    rng = np.random.RandomState(0)
    boxes = (kernel_bench.fpn_union(rng) if shape == "FPN union"
             else kernel_bench.c4_proposals(rng, 1, 3000))[0, :1200]
    valid = np.ones(len(boxes), bool)
    got = _plain_sorted(boxes, valid, 0.7)
    ref = np.asarray(jnms.nms_mask(jnp.asarray(boxes), None, 0.7, jnp.asarray(valid), sorted_input=True))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < len(boxes)


@pytest.mark.parametrize("sorted_input", [False, True])
def test_nms_select_matches_on_valid_rows(rng, sorted_input):
    n, max_out = 150, 40
    boxes, scores = random_dets(rng, n)
    if sorted_input:
        order = np.argsort(-scores, kind="stable")
        boxes, scores = boxes[order], scores[order]
    valid = rng.rand(n) > 0.1
    tb, ts, tv, ti = tnms.nms(T(boxes), T(scores), 0.5, max_out, T(valid), sorted_input, with_idx=True)
    jb, js, jv, ji = jnms.nms(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, max_out, jnp.asarray(valid), sorted_input,
        with_idx=True,
    )
    tv, jv = tv.numpy(), np.asarray(jv)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tb.numpy()[tv], np.asarray(jb)[jv])
    np.testing.assert_array_equal(ts.numpy()[tv], np.asarray(js)[jv])
    np.testing.assert_array_equal(ti.numpy()[tv], np.asarray(ji)[jv])


def test_batched_class_nms_matches(rng):
    c, n, max_out = 4, 80, 20
    boxes = np.stack([random_dets(rng, n)[0] for _ in range(c)])
    scores = rng.rand(c, n).astype(np.float32)
    valid = rng.rand(c, n) > 0.2
    tb, ts, tv = tnms.batched_class_nms(T(boxes), T(scores), 0.3, max_out, T(valid))
    jb, js, jv = jnms.batched_class_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.3, max_out, jnp.asarray(valid))
    tv, jv = tv.numpy(), np.asarray(jv)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tb.numpy()[tv], np.asarray(jb)[jv])
    np.testing.assert_array_equal(ts.numpy()[tv], np.asarray(js)[jv])


def test_nms_cuda_tensor_never_takes_the_plain_path():
    # the wrapper dispatches on the tensor's device; a non-CPU tensor that
    # is not a CUDA tensor is refused rather than run through the plain path
    boxes = torch.zeros((1, 4, 4), device="meta")
    valid = torch.ones((1, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tnms.nms_mask_sorted(boxes, valid, 0.5)


# --------------------------------------------------------------- ROIAlign
@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_roi_align_valid_hw_matches_gather(rng, pooled):
    b, h, w, c = 2, 20, 30, 16
    feat = rng.randn(b, h, w, c).astype(np.float32)
    rois = np.stack([random_rois(rng, 10, h * 16, w * 16) for _ in range(b)])
    valid_hw = np.array([[200.0, 330.0], [h * 16, 150.0]], np.float32)
    got = troi.roi_align(T(feat), T(rois), pooled, 1.0 / 16, 2, T(valid_hw)).numpy()
    for i in range(b):
        ref = j_roi_align(jnp.asarray(feat[i]), jnp.asarray(rois[i]), pooled, 1.0 / 16, 2,
                          valid_hw=jnp.asarray(valid_hw[i]))
        np.testing.assert_allclose(got[i], np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_roi_align_canvas_matches_pallas(rng, pooled):
    b, h, w, c = 2, 12, 16, 128
    feat = rng.randn(b, h, w, c).astype(np.float32)
    rois = np.stack([random_rois(rng, 6, h * 16, w * 16) for _ in range(b)])
    got = troi.roi_align(T(feat), T(rois), pooled, 1.0 / 16, 2).numpy()
    ref = roi_align_pallas(jnp.asarray(feat), jnp.asarray(rois), pooled, 1.0 / 16, 2, True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_roi_align_chunking_is_invisible(rng):
    feat = T(rng.randn(1, 9, 11, 8).astype(np.float32))
    rois = T(random_rois(rng, 13, 9 * 16, 11 * 16)[None])
    a = troi.roi_align_plain(feat, rois, (7, 7), 1.0 / 16, 2, chunk=4)
    b = troi.roi_align_plain(feat, rois, (7, 7), 1.0 / 16, 2, chunk=32)
    assert torch.equal(a, b)


# -------------------------------------------------------------- proposals
def test_propose_matches(rng):
    fh, fw, a = 6, 8, 9
    anchors = janchors.shifted_anchors(fh, fw, 16)
    n = anchors.shape[0]
    b = 2
    fg = rng.rand(b, n).astype(np.float32)
    deltas = (rng.randn(b, n, 4) * 0.2).astype(np.float32)
    im_info = np.array([[90.0, 120.0, 1.0], [96.0, 100.0, 1.5]], np.float32)
    tp = t_propose(T(fg), T(deltas), T(anchors), T(im_info), 300, 50, 0.7, 16)
    for i in range(b):
        jp = j_propose(jnp.asarray(fg[i]), jnp.asarray(deltas[i]), jnp.asarray(anchors),
                       jnp.asarray(im_info[i]), 300, 50, 0.7, 16)
        tv, jv = tp.valid[i].numpy(), np.asarray(jp.valid)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_allclose(tp.rois[i].numpy()[tv], np.asarray(jp.rois)[jv], rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(tp.scores[i].numpy()[tv], np.asarray(jp.scores)[jv])


# ------------------------------------------------------------ postprocess
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_postprocess_matches(seed):
    cfg = generate_config("resnet50", "PascalVOC")
    k = 5
    out, im_info = _fake_outputs(np.random.RandomState(seed), k=k)
    orig_hw = np.floor(im_info[:, :2] / im_info[:, 2:3]).astype(np.float32)
    jres = j_make_postprocess(cfg, k, 0.05, max_out=32)(
        {kk: jnp.asarray(v) for kk, v in out.items()}, jnp.asarray(im_info), jnp.asarray(orig_hw)
    )
    tres = t_make_postprocess(t_generate_config("resnet50", "PascalVOC"), k, 0.05, max_out=32)(
        {kk: T(v) for kk, v in out.items()}, T(im_info), T(orig_hw)
    )
    tv, jv = tres["det_valid"].numpy(), np.asarray(jres["det_valid"])
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tres["det_boxes"].numpy()[tv], np.asarray(jres["det_boxes"])[jv], atol=1e-3)
    np.testing.assert_allclose(tres["det_scores"].numpy()[tv], np.asarray(jres["det_scores"])[jv], rtol=1e-5)


# ------------------------------------------------------------------ image
@pytest.mark.parametrize("hw", [(375, 500), (500, 333), (61, 47), (1, 5)])
def test_resize_matches_cv2(rng, hw):
    im = (rng.rand(*hw, 3) * 255).astype(np.float32)
    got, scale = timage.resize_im(im, 600, 1000)
    ref, ref_scale = jimage.resize_im(im, 600, 1000)
    assert scale == ref_scale and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    im8 = im.astype(np.uint8)
    got8 = timage.resize_linear(im8, scale)
    ref8 = cv2.resize(im8, None, fx=scale, fy=scale, interpolation=cv2.INTER_LINEAR)
    assert np.abs(got8.astype(int) - ref8.astype(int)).max() <= 1


def test_bucket_ladder_matches():
    from mx_rcnn_tpu.serve.buckets import BucketLadder as JLadder
    from mx_rcnn_tpu.serve.buckets import BucketOverflow as JOverflow
    from mx_rcnn_tpu_torch.serve.buckets import BucketLadder, BucketOverflow

    buckets = ((608, 1024), (1024, 608), (608, 1024), (320, 320))
    t, j = BucketLadder(buckets), JLadder(buckets)
    assert t.buckets == j.buckets
    for hw in [(600, 800), (800, 600), (300, 300), (320, 321), (608, 1024)]:
        assert t.select(*hw) == j.select(*hw)
    with pytest.raises(BucketOverflow):
        t.select(1025, 100)
    with pytest.raises(JOverflow):
        j.select(1025, 100)


@pytest.mark.parametrize("hw", [(375, 500), (500, 333)])
def test_prepare_request_matches(rng, hw):
    from mx_rcnn_tpu.serve.buckets import BucketLadder as JLadder
    from mx_rcnn_tpu.serve.runner import prepare_request as j_prepare
    from mx_rcnn_tpu_torch.serve.buckets import BucketLadder
    from mx_rcnn_tpu_torch.serve.runner import prepare_request

    im = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    jcfg = generate_config("resnet", "PascalVOC")
    tcfg = t_generate_config("resnet", "PascalVOC")
    j = j_prepare(im, jcfg, JLadder(jcfg.SHAPE_BUCKETS))
    t = prepare_request(im, tcfg, BucketLadder(tcfg.SHAPE_BUCKETS))
    assert t.bucket == j.bucket and t.orig_hw == j.orig_hw
    np.testing.assert_array_equal(t.im_info, j.im_info)
    assert t.image.shape == j.image.shape and t.image.dtype == j.image.dtype == np.uint8
    # float resize within 1e-3 of cv2, then rounding: at most 1 LSB apart
    assert np.abs(t.image.astype(int) - j.image.astype(int)).max() <= 1


def test_prepare_image_pieces_match(rng):
    im = (rng.rand(40, 60, 3) * 255).astype(np.float32)
    np.testing.assert_array_equal(timage.quantize_uint8(im), jimage.quantize_uint8(im))
    np.testing.assert_array_equal(
        timage.pad_to_bucket(im, (64, 64)), jimage.pad_to_bucket(im, (64, 64))
    )
    with pytest.raises(ValueError):
        timage.pad_to_bucket(im, (32, 64))
