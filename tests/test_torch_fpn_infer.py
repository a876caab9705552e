"""The PyTorch port's FPN inference slice on the CPU against the JAX package,
on the same numpy-seeded inputs and bridged weights: ``FPNFasterRCNN``'s
``test_forward`` (the pad mask through the backbone, the neck and every
level, the per-level anchor grid mask, the levels' top-k union NMS, the
ladder-padded P2..P5 pooled with ``valid_hw``), the device postprocess after
it, the forward's invariance across two buckets, its cached constants and
kernel routing, and ``tools/test.py --network resnet_fpn`` against JAX's
``pred_eval`` on the same synthetic images.

The model is ``generate_config("resnet_fpn", "coco")`` (ResNet-50, the
256-channel neck, 14 × 14 pooling) cut to CPU size: 5 classes, buckets
128 × 192 and 192 × 128 (sides divisible by P6's stride, 64), 200 → 24 test
proposals.  A few classes keep every detection far from the score threshold
and the cross-class cap, decisions that float32 rounding would otherwise
flip between the packages (the cap's cut is held on identical inputs in
``tests/test_torch_mask.py``).  Its seeded random weights are calibrated on
the test images (``calibrated_model``), as ``chip_smoke.py`` and
``tests/test_torch_fullwidth.py`` calibrate theirs."""

import dataclasses
import logging
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core.tester import Predictor as JPredictor
from mx_rcnn_tpu.core.tester import pred_eval as j_pred_eval
from mx_rcnn_tpu.data import loader as jloader
from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from mx_rcnn_tpu.models.fpn import FPNFasterRCNN as JFPNFasterRCNN
from mx_rcnn_tpu.ops.postprocess import make_test_postprocess as j_make_postprocess
from mx_rcnn_tpu_torch.core.tester import Predictor
from mx_rcnn_tpu_torch.data import image as timage
from mx_rcnn_tpu_torch.data import loader as tloader
from mx_rcnn_tpu_torch.models import fpn as tfpn
from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm
from mx_rcnn_tpu_torch.ops import roi_align as troi
from mx_rcnn_tpu_torch.ops import roi_align_stream as tstream
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess
from mx_rcnn_tpu_torch.tools import test as test_cli
from mx_rcnn_tpu_torch.utils.bridge import torch_to_flax
from mx_rcnn_tpu_torch.utils.combine_model import save_params
from tests.test_torch_model import port_cfg

torch.set_num_threads(2)

BUCKETS = ((128, 192), (192, 128))
NUM_CLASSES = 5
NUM_IMAGES = 4


def small_cfgs(network):
    """(port cfg, JAX cfg) of ``generate_config(network, "coco")`` at CPU
    size and NUM_CLASSES classes; the mask network at ResNet-50 depth (its
    published depth is 101, which only makes the CPU compile slower)."""
    jcfg = j_generate_config(network, "coco")
    jcfg = jcfg.replace(
        network=dataclasses.replace(jcfg.network, depth=50),
        dataset=dataclasses.replace(jcfg.dataset, SCALES=((128, 192),),
                                    NUM_CLASSES=NUM_CLASSES),
        SHAPE_BUCKETS=BUCKETS,
        TEST=dataclasses.replace(jcfg.TEST, RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=24),
    )
    return port_cfg(jcfg), jcfg


def calibrated_model(cfg, batch, seed=0):
    """Seeded ``FPNFasterRCNN`` calibrated in one inference forward on
    ``batch``, as pretrained weights would be: each frozen BN's moments set
    to the mean and variance of its input, and each layer that no BN follows
    (the neck's convs, the 2-fc head, the mask head) scaled to unit output
    deviation (LSUV, layer by layer in forward order); then the RPN output
    layers scaled by 1e-3.  The mask logits are then O(1): masks neither
    all empty nor all full.  → (model, its Flax tree)."""

    def set_moments(bn, args):
        bn.mean.copy_(args[0].mean(dim=(0, 2, 3)))
        bn.var.copy_(args[0].var(dim=(0, 2, 3), unbiased=False))

    def scale_to(std):
        def hook(layer, args, out):
            k = std / float(out.std())
            layer.weight.mul_(k)
            layer.bias.mul_(k)
            return out * k
        return hook

    model = tfpn.FPNFasterRCNN(cfg, torch.Generator().manual_seed(seed)).eval()
    hooks = [m.register_forward_pre_hook(set_moments) for m in model.modules()
             if isinstance(m, FrozenBatchNorm)]
    hooks += [m.register_forward_hook(scale_to(1.0)) for n, m in model.named_modules()
              if n.startswith(("neck.", "mask_head.")) or n in ("top_head.fc1", "top_head.fc2")]
    try:
        with torch.no_grad():
            model(torch.from_numpy(np.asarray(batch["images"])),
                  torch.from_numpy(np.asarray(batch["im_info"])))
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        for layer in (model.rpn.rpn_cls_score, model.rpn.rpn_bbox_pred):
            layer.weight.mul_(1e-3)
    model._constants.clear()
    return model, torch_to_flax(model)


def dataset(cls, with_masks=False):
    """The synthetic COCO-sized set the CLI builds (``--synthetic``):
    480 × 640 images."""
    return cls(num_images=NUM_IMAGES, num_classes=NUM_CLASSES, with_masks=with_masks)


def first_batch(cfg, roidb, n=2):
    """The first batch of ``n`` same-bucket test images (uint8)."""
    _, _, batch = next(iter(tloader.TestLoader(roidb, cfg, batch_size=n).iter_batched()))
    return batch


@pytest.fixture(autouse=True)
def clean_render_cache():
    """The JAX render LRU keys renders without their size: start without
    another file's renders, and drop this file's."""
    jloader._RENDER_CACHE.clear()
    yield
    jloader._RENDER_CACHE.clear()


@pytest.fixture(scope="module")
def fpn_setup():
    """(port cfg, JAX cfg, port model, Flax tree, JAX model, the first test
    batch of 2, the outputs of both forwards on it)."""
    cfg, jcfg = small_cfgs("resnet_fpn")
    roidb = dataset(JSyntheticDataset).gt_roidb()
    batch = first_batch(cfg, roidb)
    model, params_np = calibrated_model(cfg, batch)
    jmodel = JFPNFasterRCNN(jcfg)
    raw = {k: v for k, v in batch.items() if k != "orig_hw"}
    ref = jax.tree.map(np.asarray, JPredictor(jmodel, params_np).predict(raw))
    got = Predictor(model, device="cpu").predict(raw)
    return cfg, jcfg, model, params_np, jmodel, batch, ref, got


def test_test_forward_matches_jax(fpn_setup):
    """``roi_valid`` equal; rois, roi_scores and cls_prob within 1e-4,
    bbox_deltas within 1e-3 (``tests/test_torch_model.py``'s C4 bars)."""
    *_, batch, ref, got = fpn_setup
    assert set(got) == set(ref) == {"rois", "roi_scores", "roi_valid", "cls_prob", "bbox_deltas"}
    assert batch["images"].shape[1:3] == (128, 192) and (batch["im_info"][:, 1] < 192).all()
    np.testing.assert_array_equal(got["roi_valid"], ref["roi_valid"])
    v = ref["roi_valid"].astype(bool)
    assert v.sum() > 20
    for k, tol in (("rois", 1e-4), ("roi_scores", 1e-4), ("cls_prob", 1e-4),
                   ("bbox_deltas", 1e-3)):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k][v], ref[k][v], atol=tol, rtol=0, err_msg=k)


def test_device_postprocess_after_the_forward_matches_jax(fpn_setup):
    """Each package's postprocess on its own forward: ``det_valid`` equal,
    ``det_boxes`` within 1e-3 px, ``det_scores`` within 1e-4."""
    cfg, jcfg, *_, batch, ref, got = fpn_setup
    te = cfg.TEST
    jpp = jax.jit(j_make_postprocess(jcfg, NUM_CLASSES, te.SCORE_THRESH,
                                     max_out=te.DET_PER_CLASS))
    r = jax.tree.map(np.asarray, jpp({k: jnp.asarray(v) for k, v in ref.items()},
                                     jnp.asarray(batch["im_info"]), jnp.asarray(batch["orig_hw"])))
    pp = make_test_postprocess(cfg, NUM_CLASSES, te.SCORE_THRESH, max_out=te.DET_PER_CLASS)
    g = {k: v.numpy() for k, v in pp({k: torch.from_numpy(v) for k, v in got.items()},
                                     torch.from_numpy(batch["im_info"]),
                                     torch.from_numpy(batch["orig_hw"])).items()}
    np.testing.assert_array_equal(g["det_valid"], r["det_valid"])
    m = r["det_valid"]
    assert m.sum() > 10
    np.testing.assert_allclose(g["det_boxes"][m], r["det_boxes"][m], atol=1e-3, rtol=0)
    np.testing.assert_allclose(g["det_scores"][m], r["det_scores"][m], atol=1e-4, rtol=0)


def test_forward_is_bucket_invariant(fpn_setup):
    """One image in the 128 × 192 and the 192 × 128 canvas: the pad mask,
    the anchor grid mask and the ladder padding make the forward the same
    up to the convolutions' rounding (cuDNN and the CPU pick their sums per
    shape, so it is a tolerance claim, the bars of the JAX comparison)."""
    cfg, _, model, *_ = fpn_setup
    rng = np.random.RandomState(4)
    im = (rng.rand(110, 120, 3) * 255).astype(np.uint8)
    info = np.array([[110.0, 120.0, 1.0]], np.float32)
    pred = Predictor(model, device="cpu")
    outs = []
    for hw in BUCKETS:
        canvas = np.zeros((1,) + hw + (3,), np.uint8)
        canvas[0, :110, :120] = im
        outs.append(pred.predict({"images": canvas, "im_info": info}))
    a, b = outs
    np.testing.assert_array_equal(a["roi_valid"], b["roi_valid"])
    v = a["roi_valid"].astype(bool)
    assert v.sum() > 10
    for k, tol in (("rois", 1e-4), ("roi_scores", 1e-4), ("cls_prob", 1e-4),
                   ("bbox_deltas", 1e-3)):
        np.testing.assert_allclose(a[k][v], b[k][v], atol=tol, rtol=0, err_msg=k)


def test_constants_are_built_once_and_every_level_pools_with_kernel_2(fpn_setup, monkeypatch):
    """A second forward on the same shapes builds no new anchor table; the
    canonical scale of ``roi_levels`` is one tensor per device; the four
    levels pool through ``roi_align`` (kernel 2's wrapper) with ``valid_hw``
    and never through the streamed kernel 4."""
    cfg, _, model, *_, batch, _, _ = fpn_setup
    calls = []
    orig = troi.roi_align
    monkeypatch.setattr(troi, "roi_align", lambda feat, *a, **k: calls.append(
        (tuple(feat.shape), a[-1] is not None)) or orig(feat, *a, **k))
    monkeypatch.setattr(tstream, "roi_align_stream", None)
    raw = {k: torch.from_numpy(v) for k, v in batch.items() if k != "orig_hw"}
    model._constants.clear()
    with torch.inference_mode():
        model(raw["images"], raw["im_info"])
        keys = set(model._constants)
        canon = dict(tfpn._CANONICAL)
        model(raw["images"], raw["im_info"])
    assert set(model._constants) == keys and len([k for k in keys if k[0] == "anchors"]) == 1
    assert tfpn._CANONICAL == canon and len(canon) == 1
    assert [c[0][1:3] for c in calls[:4]] == [(48, 48), (24, 24), (12, 12), (6, 6)]
    assert len(calls) == 8 and all(valid for _, valid in calls)


@pytest.fixture
def cli_params(tmp_path, monkeypatch):
    """The CLI's ``generate_config`` cut to :func:`small_cfgs`; a params
    pickle of :func:`calibrated_model`'s weights."""

    def small(network, ds):
        assert ds == "coco"
        return small_cfgs(network)[0]

    monkeypatch.setattr(test_cli, "generate_config", small)
    monkeypatch.setattr(jloader, "prepare_image", timage.prepare_image)

    def make(network):
        cfg, jcfg = small_cfgs(network)
        roidb = dataset(JSyntheticDataset, cfg.network.USE_MASK).gt_roidb()
        model, params_np = calibrated_model(cfg, first_batch(cfg, roidb))
        path = str(tmp_path / f"{network}.pkl")
        save_params(path, params_np)
        return path, jcfg, params_np, roidb

    return make


def test_cli_resnet_fpn_matches_jax_pred_eval(cli_params, caplog):
    """``--network resnet_fpn --dataset coco --synthetic 4 --cpu 1`` against
    JAX's ``pred_eval`` with the same weights on the same images (JAX's
    loader on the port's resize, whose cv2 rounding is held apart in
    ``tests/test_torch_eval.py``): same keep counts, scores within 1e-4 (the
    forward's ``cls_prob`` bar: the 50176-input ``fc1`` sums in another
    order in torch and XLA), boxes within 1e-3 px, mAP within 1e-6."""
    path, jcfg, params_np, roidb = cli_params("resnet_fpn")
    dump = path + ".dets"
    with caplog.at_level(logging.INFO):
        results = test_cli.main(["--network", "resnet_fpn", "--dataset", "coco", "--synthetic",
                                 str(NUM_IMAGES), "--params", path, "--cpu", "1", "--dump", dump])
    assert f"mAP: {results['mAP']:.4f}" in caplog.text
    ref, ref_results = j_pred_eval(JPredictor(JFPNFasterRCNN(jcfg), params_np),
                                   jloader.TestLoader(roidb, jcfg), dataset(JSyntheticDataset),
                                   jcfg)
    with open(dump, "rb") as f:
        got = pickle.load(f)
    kept = 0
    for j in range(1, NUM_CLASSES):
        for i in range(NUM_IMAGES):
            g, r = got[j][i], np.asarray(ref[j][i])
            assert g.shape == r.shape, f"class {j} image {i}"
            np.testing.assert_allclose(g[:, 4], r[:, 4], atol=1e-4, err_msg=f"class {j} image {i}")
            np.testing.assert_allclose(g[:, :4], r[:, :4], atol=1e-3, err_msg=f"class {j} image {i}")
            kept += len(g)
    assert kept >= 20
    assert set(results) == set(ref_results)
    for k, v in ref_results.items():
        assert abs(results[k] - v) <= 1e-6, k
