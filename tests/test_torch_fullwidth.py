"""The port's main-path model at full width against the JAX package, on the
CPU: ResNet-101 C4 Faster R-CNN as ``generate_config("resnet", "PascalVOC")``
builds it (21 classes, 14 × 14 pooling, 1024-channel conv4 map), one uint8
image on the 608 × 1024 bucket canvas, smaller than the canvas so the bucket
padding is exercised.  Only the test-time proposal counts are cut (1000 →
32), so that the conv5 head runs on 32 rois.

Both packages run ``test_forward`` on the same Flax-initialised weights,
bridged by ``utils/bridge.py::flax_to_torch``, with the BN affines and
biases perturbed and the RPN output layers tamed as in
``tests/test_torch_model.py``; the bars are those of its
``test_test_forward_matches``.  At this depth and size the random
network needs the unit-scale activations that pretrained weights give, as
``chip_smoke.py`` gives them (``calibrate_bn``, ``calibrate_scales``): with
near-identity BN moments the 101 layers grow the conv4 map to ~500 on
average (~3700 at most).  So the frozen BN moments are set to the mean and
variance of each layer's input on this image, and each RPN layer that no BN
follows to a set output deviation.

Those deviations also set how far float32 rounding moves the proposals.
The two packages' conv4 maps agree to ~2e-6 relative (their convolutions
sum in other orders), the RPN deltas carry that as an absolute error of
~2e-6 of their own size, and a proposal edge moves by that times the
box's width, up to ~730 px here.  An edge near 0 of such a box has only
the 1e-4 atol of the rois' bar: less than two float32 steps (6.1e-5) of a
width over 512 px.  With the deltas' std at 0.069 (what the 1e-3 taming
alone gives here), the worst roi error over image seeds 0-5 and 1, 2 and 4
torch threads reached 1.56 of its bound; at 0.03, 1.15; at 0.01, 0.30
(0.12 on this test's image).  So the 3 × 3 conv's output is set
to unit deviation, the delta layer's to 0.01, and the objectness logits'
to 1, which spreads the top proposals' scores apart so that rounding does
not swap two of them.  The tree then goes back to Flax through
``torch_to_flax`` (an exact round trip), so both packages hold the same
weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.models import FasterRCNN as JFasterRCNN
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, torch_to_flax
from tests.test_torch_model import _as_dicts, _perturb, _tame_rpn, port_cfg

torch.set_num_threads(2)

CANVAS = (608, 1024)
IMAGE_HW = (562, 1000)  # the resized image inside the canvas: (600, 1000) scale of a 337 × 600 photo


def full_width_cfg():
    cfg = j_generate_config("resnet", "PascalVOC")
    return cfg.replace(
        TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=1000, RPN_POST_NMS_TOP_N=32)
    )


@pytest.fixture(scope="module")
def full_width():
    """(JAX model, bridged Flax params, port model, images, im_info)."""
    jcfg = full_width_cfg()
    assert (jcfg.network.depth, jcfg.dataset.NUM_CLASSES, jcfg.network.POOLED_SIZE) == (
        101, 21, (14, 14))
    assert CANVAS in jcfg.SHAPE_BUCKETS
    jmodel = JFasterRCNN(jcfg)
    rng = np.random.RandomState(0)
    h, w = IMAGE_HW
    images = np.zeros((1,) + CANVAS + (3,), np.uint8)
    images[0, :h, :w] = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    im_info = np.array([[h, w, 600.0 / 337.0]], np.float32)
    # the parameters do not depend on the image size: initialise on a small one
    small = jnp.zeros((1, 64, 64, 3), jnp.uint8)
    params = jax.jit(jmodel.init)(jax.random.key(0), small, jnp.asarray([[64.0, 64.0, 1.0]]))
    params_np = _tame_rpn(_perturb(_as_dicts(params["params"]), np.random.RandomState(1)))
    model = flax_to_torch(params_np, FasterRCNN(port_cfg(jcfg))).eval()
    calibrate(model, torch.from_numpy(images), torch.from_numpy(im_info))
    return jmodel, torch_to_flax(model), model, images, im_info


# RPN layer -> the standard deviation calibrate() gives its output
RPN_SCALES = (("rpn_conv", 1.0), ("rpn_cls_score", 1.0), ("rpn_bbox_pred", 0.01))


def calibrate(model, images, im_info):
    """Each frozen BN's moments := the per-channel mean and variance of its
    input in one forward on the image (a pre-hook sets them before the layer
    runs, so each later layer sees calibrated inputs); then each RPN layer
    of ``RPN_SCALES`` scaled to its output deviation, one forward each."""

    def set_moments(bn, args):
        bn.mean.copy_(args[0].mean(dim=(0, 2, 3)))
        bn.var.copy_(args[0].var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_moments) for m in model.modules()
             if isinstance(m, FrozenBatchNorm)]
    try:
        with torch.no_grad():
            model(images, im_info)
    finally:
        for h in hooks:
            h.remove()
    assert len(hooks) > 100
    for name, std in RPN_SCALES:
        layer, seen = getattr(model.rpn, name), []
        hook = layer.register_forward_hook(lambda m, i, o: seen.append(float(o.std())))
        try:
            with torch.no_grad():
                model(images, im_info)
        finally:
            hook.remove()
        with torch.no_grad():
            layer.weight.mul_(std / seen[0])
            layer.bias.mul_(std / seen[0])


def test_full_width_test_forward_matches(full_width):
    """roi_valid equal; rois within 1e-4 (and 1e-5 relative), roi scores and
    cls_prob within 1e-4, de-normalised deltas within 1e-3."""
    jmodel, params_np, model, images, im_info = full_width
    ref = jax.jit(lambda p, x, info: jmodel.apply({"params": p}, x, info))(
        params_np, jnp.asarray(images), jnp.asarray(im_info))
    with torch.inference_mode():
        got = model(torch.from_numpy(images), torch.from_numpy(im_info))
    assert got["cls_prob"].shape == (1, 32, 21) and got["bbox_deltas"].shape == (1, 32, 84)
    tv, jv = got["roi_valid"].numpy(), np.asarray(ref["roi_valid"])
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() == 32
    rois = got["rois"].numpy()[tv]
    np.testing.assert_allclose(rois, np.asarray(ref["rois"])[jv], atol=1e-4, rtol=1e-5)
    # proposals inside the image, not only on the padding
    assert (rois[:, 2] <= IMAGE_HW[1] - 1).all() and (rois[:, 3] <= IMAGE_HW[0] - 1).all()
    np.testing.assert_allclose(got["roi_scores"].numpy()[tv], np.asarray(ref["roi_scores"])[jv],
                               atol=1e-4)
    np.testing.assert_allclose(got["cls_prob"].numpy()[tv], np.asarray(ref["cls_prob"])[jv],
                               atol=1e-4)
    np.testing.assert_allclose(got["bbox_deltas"].numpy()[tv], np.asarray(ref["bbox_deltas"])[jv],
                               atol=1e-3)
