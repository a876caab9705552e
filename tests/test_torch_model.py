"""The PyTorch port's model and serving slice on the CPU against the JAX
package, on the same bridged weights and numpy-seeded inputs: the parameter
bridge (exact round trip), backbone / RPN / heads (1e-4), ``test_forward``
end to end, and the slice (forward + device postprocess, identical keep
masks)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.models import FasterRCNN as JFasterRCNN
from mx_rcnn_tpu.models.heads import RCNNHead as JRCNNHead
from mx_rcnn_tpu.models.layers import make_pad_mask as j_make_pad_mask
from mx_rcnn_tpu.models.resnet import ResNetBackbone as JBackbone
from mx_rcnn_tpu.models.resnet import ResNetTopHead as JTopHead
from mx_rcnn_tpu.models.rpn import RPNHead as JRPNHead
from mx_rcnn_tpu.ops.postprocess import make_test_postprocess as j_make_postprocess
from mx_rcnn_tpu_torch.config import generate_config as t_generate_config
from mx_rcnn_tpu_torch.core.tester import Predictor
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.models.layers import make_pad_mask
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess as t_make_postprocess
from mx_rcnn_tpu_torch.serve.runner import detect_single, detections_from_output, prepare_request
from mx_rcnn_tpu_torch.serve.buckets import BucketLadder
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, torch_to_flax
from tests.test_model import tiny_cfg

torch.set_num_threads(2)

NUM_CLASSES = 21


def T(a):
    return torch.from_numpy(np.array(a))


def port_cfg(jcfg):
    """The port's Config with every value of the JAX one."""
    t = t_generate_config("resnet50", "PascalVOC")
    return t.replace(
        network=dataclasses.replace(t.network, **dataclasses.asdict(jcfg.network)),
        dataset=dataclasses.replace(t.dataset, **dataclasses.asdict(jcfg.dataset)),
        TRAIN=dataclasses.replace(t.TRAIN, **dataclasses.asdict(jcfg.TRAIN)),
        TEST=dataclasses.replace(t.TEST, **dataclasses.asdict(jcfg.TEST)),
        SHAPE_BUCKETS=jcfg.SHAPE_BUCKETS,
    )


def _as_dicts(tree):
    return {k: _as_dicts(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


def _perturb(tree, rng):
    """Random BN moments/affines and biases, so the bridge and the frozen
    BN arithmetic are exercised (Flax's init leaves BN the identity)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k in ("scale", "var"):
            tree[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            tree[k] = (rng.randn(*v.shape) * 0.05).astype(np.float32)
    return tree


def _tame_rpn(params_np):
    """Scale the RPN output layers down 1000×.  On raw-pixel inputs the
    lecun-initialized head emits deltas of ~75, so nearly every proposal
    clips to the whole image and float32 rounding moves box edges by
    ~1e-3 px; scaled, the proposals stay near their anchors (the regime of
    the reference's Normal(0.01) RPN init) and rounding stays far inside
    the tolerances."""
    for name in ("rpn_cls_score", "rpn_bbox_pred"):
        params_np["rpn"][name]["kernel"] = params_np["rpn"][name]["kernel"] * np.float32(1e-3)
    return params_np


def uint8_batch(rng, b=2, h=128, w=128):
    images = (rng.rand(b, h, w, 3) * 255).astype(np.uint8)
    im_info = np.array([[128.0, 128.0, 1.0], [100.0, 120.0, 0.8]], np.float32)[:b]
    orig_hw = np.floor(im_info[:, :2] / im_info[:, 2:3]).astype(np.float32)
    return images, im_info, orig_hw


@pytest.fixture(scope="module")
def bridged():
    """(JAX cfg, JAX model, Flax params, port model with the same weights)."""
    jcfg = tiny_cfg()
    jmodel = JFasterRCNN(jcfg)
    images, im_info, _ = uint8_batch(np.random.RandomState(0))
    params = jmodel.init(jax.random.key(0), jnp.asarray(images), jnp.asarray(im_info))["params"]
    params_np = _tame_rpn(_perturb(_as_dicts(params), np.random.RandomState(1)))
    model = flax_to_torch(params_np, FasterRCNN(port_cfg(jcfg))).eval()
    return jcfg, jmodel, params_np, model


@pytest.fixture(scope="module")
def jax_forward(bridged):
    jcfg, jmodel, params_np, _ = bridged
    return jax.jit(lambda p, x, info: jmodel.apply({"params": p}, x, info))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_bridge_round_trip_is_exact(bridged):
    _, _, params_np, model = bridged
    back = dict(_leaves(torch_to_flax(model)))
    ref = dict(_leaves(params_np))
    assert set(back) == set(ref)
    assert set(p[0] for p in ref) == {"backbone", "top_head", "rpn", "rcnn"}
    for path, a in ref.items():
        np.testing.assert_array_equal(back[path], a, err_msg="/".join(path))


def test_bridge_rejects_a_missing_leaf(bridged):
    _, _, params_np, model = bridged
    partial = {k: v for k, v in params_np.items() if k != "rcnn"}
    with pytest.raises(KeyError, match="no Flax leaf"):
        flax_to_torch(partial, FasterRCNN(model.cfg))


def test_backbone_matches(bridged, rng):
    _, _, params_np, model = bridged
    x = rng.randn(2, 96, 128, 3).astype(np.float32)
    im_info = np.array([[96.0, 128.0, 1.0], [70.0, 90.0, 1.0]], np.float32)
    ref = JBackbone(depth=50).apply(
        {"params": params_np["backbone"]}, jnp.asarray(x),
        pad_mask=j_make_pad_mask(jnp.asarray(im_info), (96, 128)),
    )
    with torch.inference_mode():
        got = model.backbone(T(x).permute(0, 3, 1, 2), make_pad_mask(T(im_info), (96, 128)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_rpn_head_matches(bridged, rng):
    _, _, params_np, model = bridged
    feat = rng.randn(2, 6, 8, 1024).astype(np.float32)
    jl, jd = JRPNHead(num_anchors=9, channels=512).apply({"params": params_np["rpn"]}, jnp.asarray(feat))
    with torch.inference_mode():
        tl, td = model.rpn(T(feat).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)


def test_top_and_rcnn_heads_match(bridged, rng):
    _, _, params_np, model = bridged
    pooled = rng.randn(3, 14, 14, 1024).astype(np.float32)
    jv = JTopHead(depth=50).apply({"params": params_np["top_head"]}, jnp.asarray(pooled))
    with torch.inference_mode():
        tv = model.top_head(T(pooled).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
    trunk = rng.randn(5, 2048).astype(np.float32)
    jc, jb = JRCNNHead(num_classes=NUM_CLASSES).apply({"params": params_np["rcnn"]}, jnp.asarray(trunk))
    with torch.inference_mode():
        tc, tb = model.rcnn(T(trunk))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-4)


def test_test_forward_matches(bridged, jax_forward):
    _, _, params_np, model = bridged
    images, im_info, _ = uint8_batch(np.random.RandomState(2))
    ref = jax_forward(params_np, jnp.asarray(images), jnp.asarray(im_info))
    with torch.inference_mode():
        got = model(T(images), T(im_info))
    assert set(got) == {"rois", "roi_scores", "roi_valid", "cls_prob", "bbox_deltas"}
    tv, jv = got["roi_valid"].numpy(), np.asarray(ref["roi_valid"])
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() >= tv.size // 4
    np.testing.assert_allclose(got["rois"].numpy()[tv], np.asarray(ref["rois"])[jv], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got["roi_scores"].numpy()[tv], np.asarray(ref["roi_scores"])[jv], atol=1e-4)
    np.testing.assert_allclose(got["cls_prob"].numpy()[tv], np.asarray(ref["cls_prob"])[jv], atol=1e-4)
    np.testing.assert_allclose(got["bbox_deltas"].numpy()[tv], np.asarray(ref["bbox_deltas"])[jv], atol=1e-3)


def test_slice_matches(bridged, jax_forward):
    jcfg, _, params_np, model = bridged
    images, im_info, orig_hw = uint8_batch(np.random.RandomState(3))
    thresh = jcfg.TEST.SCORE_THRESH
    jout = jax_forward(params_np, jnp.asarray(images), jnp.asarray(im_info))
    ref = j_make_postprocess(jcfg, NUM_CLASSES, thresh, max_out=jcfg.TEST.DET_PER_CLASS)(
        jout, jnp.asarray(im_info), jnp.asarray(orig_hw)
    )
    pred = Predictor(
        model, t_make_postprocess(model.cfg, NUM_CLASSES, thresh, max_out=jcfg.TEST.DET_PER_CLASS),
        device="cpu",
    )
    got = pred.predict({"images": images, "im_info": im_info, "orig_hw": orig_hw})
    jv = np.asarray(ref["det_valid"])
    np.testing.assert_array_equal(got["det_valid"], jv)
    assert jv.sum() > 0
    np.testing.assert_allclose(got["det_boxes"][jv], np.asarray(ref["det_boxes"])[jv], atol=1e-3)
    np.testing.assert_allclose(got["det_scores"][jv], np.asarray(ref["det_scores"])[jv], atol=1e-5)


def test_detect_single_serves_a_request(bridged):
    _, _, _, model = bridged
    cfg = model.cfg.replace(
        dataset=dataclasses.replace(model.cfg.dataset, SCALES=((128, 160),)),
        SHAPE_BUCKETS=((128, 160), (160, 128)),
    )
    pp = t_make_postprocess(cfg, NUM_CLASSES, cfg.TEST.SCORE_THRESH, cfg.TEST.DET_PER_CLASS)
    pred = Predictor(FasterRCNN(cfg), pp, device="cpu")
    pred.model.load_state_dict(model.state_dict())
    im = (np.random.RandomState(4).rand(90, 120, 3) * 255).astype(np.uint8)
    dets = detect_single(pred, im, cfg, NUM_CLASSES)
    assert dets[0] is None and len(dets) == NUM_CLASSES
    assert sum(len(d) for d in dets[1:]) > 0
    for d in dets[1:]:
        assert d.shape[1] == 5 and np.isfinite(d).all()
        assert (d[:, [0, 2]] <= 119).all() and (d[:, [1, 3]] <= 89).all()
    # the same request through prepare_request + Predictor directly
    req = prepare_request(im, cfg, BucketLadder(cfg.SHAPE_BUCKETS))
    assert req.bucket == (128, 160) and req.image.dtype == np.uint8
    out = pred.predict({"images": req.image[None], "im_info": req.im_info[None],
                        "orig_hw": np.asarray([req.orig_hw], np.float32)})
    got, _ = detections_from_output(out, req.im_info, req.orig_hw, cfg, NUM_CLASSES)
    for a, b in zip(dets[1:], got[1:]):
        np.testing.assert_array_equal(a, b)


def test_predictor_defaults_to_the_card(bridged):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(bridged[3])


def test_unported_configs_raise():
    cfg = t_generate_config("resnet_fpn", "PascalVOC")
    with pytest.raises(NotImplementedError):
        FasterRCNN(cfg)
    with pytest.raises(NotImplementedError):
        FasterRCNN(t_generate_config("vgg", "PascalVOC"))
