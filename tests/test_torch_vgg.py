"""The VGG-16 family of the PyTorch port on the CPU against the JAX package:
``ops/roi_pool.py`` (ROIPooling) against ``roi_pool`` and its VJP, and the
VGG-16 ``FasterRCNN``, ``RPNOnly`` and ``FastRCNN`` through the bridge on
``tests/test_vgg.py``'s config (4 classes, 192 × 192, BATCH_ROIS 32): the
test forwards, one train step each with JAX's draws injected, the bf16
graph, the frozen sets and the optimizer.

Tolerances: the ROIPooling forward is pure selection, so bitwise; its
backward is JAX's VJP (ties split evenly among the tied rows, then among the
tied columns) and bitwise where every cell takes one contribution, else
within 1e-6 of the largest gradient (sums of several contributions in
another order).  The models: as ``tests/test_torch_train.py`` and
``tests/test_torch_bf16.py`` (float32 convolutions sum in another order in
torch and XLA; bf16 at the JAX package's bf16 bar).

fc6 alone is 411 MB in float32, so the port's VGG models are built on the
meta device and take seeded numpy weights (:func:`vgg_model`), and each
graph is built once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.core.train import make_optimizer as j_make_optimizer
from mx_rcnn_tpu.models import FasterRCNN as JFasterRCNN
from mx_rcnn_tpu.models.stage_models import FastRCNN as JFastRCNN
from mx_rcnn_tpu.models.stage_models import RPNOnly as JRPNOnly
from mx_rcnn_tpu.models.vgg import VGGBackbone as JVGGBackbone
from mx_rcnn_tpu.ops.roi_align import extract_roi_features_batched as j_extract
from mx_rcnn_tpu.ops.roi_align import roi_pool as j_roi_pool
from mx_rcnn_tpu_torch.config import generate_config as t_generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.models import stage_models as tsm
from mx_rcnn_tpu_torch.models.faster_rcnn import _DENSE_STD, DRAW_NAMES, FasterRCNN
from mx_rcnn_tpu_torch.models.stage_models import FastRCNN, RPNOnly
from mx_rcnn_tpu_torch.models.vgg import VGG16, VGG_BLOCK_ORDER, VGGBackbone
from mx_rcnn_tpu_torch.ops import roi_pool as trp
from mx_rcnn_tpu_torch.ops.roi_align import extract_roi_features_batched
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, grads_to_flax, torch_to_flax
from tests.test_model import tiny_batch
from tests.test_torch_alternate import proposal_batch
from tests.test_torch_bf16 import BF16_TOL, _hold_step, _jax_step, bf16, rel_max
from tests.test_torch_frozen import KINK_BAND
from tests.test_torch_model import port_cfg
from tests.test_vgg import vgg_cfg

torch.set_num_threads(2)

SCALE = 1.0 / 16


def T(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# --------------------------------------------------------------- roi_pool
def edge_rois(h, w):
    """Rois on the rounding and clipping edges of a (h, w) map at stride 16:
    corners at x ≡ 8 (mod 16) (×1/16 lands on .5: round half to even),
    inverted, one-pixel, off the map, the whole map and past it, and rois
    narrower than the pooled grid (overlapping floor/ceil bins)."""
    hs, ws = 16.0 * h, 16.0 * w
    return np.array([
        [8, 8, 40, 24], [24, 40, 56, 72], [40, 8, 8, 40],          # .5 corners, inverted
        [17, 17, 17, 17], [0, 0, 0, 0],                             # one pixel
        [-64, -64, -8, -8], [ws + 8, hs + 8, ws + 80, hs + 40],    # off the map
        [0, 0, ws - 1, hs - 1], [-200, -300, ws + 500, hs + 90],   # whole map, past it
        [30, 30, 50, 38], [ws - 20, 4, ws + 30, 20],                # narrower than the grid
    ], np.float32)


def roi_case(rng, h=11, w=13, c=3, r=24, ties=False):
    """A (h, w, c) map and rois (the edge rois, then random ones); with
    ``ties`` the map holds only a few values, so most bins tie."""
    feat = rng.randn(h, w, c).astype(np.float32)
    if ties:
        feat = np.round(feat).astype(np.float32)
    x1, y1 = rng.uniform(-40, 16 * w, r), rng.uniform(-40, 16 * h, r)
    rois = np.stack([x1, y1, x1 + rng.uniform(-20, 16 * w, r),
                     y1 + rng.uniform(-20, 16 * h, r)], 1).astype(np.float32)
    return feat, np.concatenate([edge_rois(h, w), rois])


@pytest.mark.parametrize("valid", [False, True], ids=["canvas", "valid_hw"])
@pytest.mark.parametrize("pooled", [(1, 1), (2, 2), (7, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_pool_forward_is_jax_bitwise(rng, dtype, pooled, valid):
    """Every bin of every roi equal to JAX's, in both dtypes, clamped to the
    canvas or to a ``valid_hw`` smaller than it."""
    feat, rois = roi_case(rng)
    vhw = np.array([100.0, 150.0], np.float32) if valid else None
    jf = jnp.asarray(feat).astype(getattr(jnp, dtype))
    ref = j_roi_pool(jf, jnp.asarray(rois), pooled, SCALE,
                     valid_hw=None if vhw is None else jnp.asarray(vhw))
    got = trp.roi_pool(T(feat).to(getattr(torch, dtype))[None], T(rois)[None], pooled, SCALE,
                       None if vhw is None else T(vhw)[None])
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got[0].float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_roi_pool_edges_hit_every_case():
    """The edge rois give empty bins (zeros), overlapping bins and the .5
    rounding: the cases the bitwise test is there for."""
    rows, cols = trp.bin_edges(T(edge_rois(11, 13)), (7, 7), SCALE, (11, 13))
    lo, hi = rows
    assert bool((hi <= lo).any())                       # empty bins
    assert bool((lo[:, 1:] < hi[:, :-1]).any())         # overlapping bins
    # x1 = 8 → 0.5 → 0 (half to even); x1 = 24 → 1.5 → 2
    assert cols[0][0, 0] == 0 and cols[0][1, 0] == 2


def _vjp_case(rng, pooled, ties, vhw):
    feat, rois = roi_case(rng, ties=ties)
    g = rng.randn(rois.shape[0], *pooled, feat.shape[2]).astype(np.float32)
    jv = None if vhw is None else jnp.asarray(vhw)
    _, vjp = jax.vjp(lambda f: j_roi_pool(f, jnp.asarray(rois), pooled, SCALE, valid_hw=jv),
                     jnp.asarray(feat))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    ft = T(feat)[None].requires_grad_(True)
    out = trp.roi_pool(ft, T(rois)[None], pooled, SCALE, None if vhw is None else T(vhw)[None])
    out.backward(T(g)[None])
    return ft.grad[0].numpy(), ref


@pytest.mark.parametrize("valid", [False, True], ids=["canvas", "valid_hw"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("pooled", [(2, 2), (7, 7)])
def test_roi_pool_backward_matches_jax_vjp(rng, pooled, ties, valid):
    """The gradient of 35 rois against ``jax.vjp``, within 1e-6 of its
    largest element; with ``ties`` the map holds ~7 distinct values, so
    nearly every bin splits its gradient in JAX's two stages."""
    vhw = np.array([100.0, 150.0], np.float32) if valid else None
    got, ref = _vjp_case(rng, pooled, ties, vhw)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_roi_pool_backward_is_bitwise_where_each_cell_takes_one_term():
    """One roi on a map without ties, bins that do not overlap: each cell
    takes at most one term, so the gradient is JAX's bit for bit."""
    rng = np.random.RandomState(3)
    feat = rng.permutation(9 * 14 * 2).reshape(9, 14, 2).astype(np.float32) / 7.0
    rois = np.array([[0.0, 0.0, 16 * 13.0, 16 * 6.0]], np.float32)     # 14 × 7 cells
    g = rng.randn(1, 7, 7, 2).astype(np.float32)
    _, vjp = jax.vjp(lambda f: j_roi_pool(f, jnp.asarray(rois), (7, 7), SCALE), jnp.asarray(feat))
    ft = T(feat)[None].requires_grad_(True)
    trp.roi_pool(ft, T(rois)[None], (7, 7), SCALE).backward(T(g)[None])
    np.testing.assert_array_equal(ft.grad[0].numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_roi_pool_splits_ties_in_two_stages():
    """Three cells tied at 2.0 in a 1 × 1 bin, at (0,0), (0,1) and (1,0):
    rows first (column 0 splits between rows 0 and 1), then columns."""
    feat = np.zeros((4, 4, 1), np.float32)
    feat[0, 0] = feat[0, 1] = feat[1, 0] = 2.0
    ft = T(feat)[None].requires_grad_(True)
    rois = T(np.array([[[0.0, 0.0, 16.0, 16.0]]], np.float32))
    trp.roi_pool(ft, rois, (1, 1), SCALE).sum().backward()
    np.testing.assert_array_equal(ft.grad[0, :2, :2, 0].numpy(), [[0.25, 0.5], [0.25, 0.0]])


@pytest.mark.parametrize("fwd_only", [False, True], ids=["train", "fwd_only"])
def test_batched_roi_pool_dispatch_matches_jax(rng, fwd_only):
    """``extract_roi_features_batched(mode='roi_pool')`` over two images,
    with and without ``valid_hw``: JAX's sequential train branch and its
    vmapped forward-only branch, bitwise; the train route's gradient."""
    feats = rng.randn(2, 9, 12, 4).astype(np.float32)
    rois = np.stack([roi_case(rng, 9, 12, 4, r=12)[1] for _ in range(2)])
    vhw = np.array([[144.0, 192.0], [90.0, 120.0]], np.float32)
    g = rng.randn(*rois.shape[:2], 7, 7, 4).astype(np.float32)
    for valid in (None, vhw):
        jv = None if valid is None else jnp.asarray(valid)
        ref, vjp = jax.vjp(lambda f: j_extract(f, jnp.asarray(rois), "roi_pool", (7, 7), SCALE,
                                               fwd_only=fwd_only, valid_hw=jv), jnp.asarray(feats))
        ft = T(feats).requires_grad_(not fwd_only)
        got = extract_roi_features_batched(ft, T(rois), "roi_pool", (7, 7), SCALE,
                                           fwd_only=fwd_only,
                                           valid_hw=None if valid is None else T(valid))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
        if not fwd_only:
            got.backward(T(g))
            jg = np.asarray(vjp(jnp.asarray(g))[0])
            np.testing.assert_allclose(ft.grad.numpy(), jg, rtol=0, atol=1e-6 * np.abs(jg).max())


def test_roi_pool_graph_saves_no_masked_tensor(rng):
    """The autograd graph keeps the map, the rois and ``valid_hw`` only:
    nothing near the JAX form's (R, ph, H, W, C) masked tensor."""
    feat = T(rng.randn(2, 20, 24, 16).astype(np.float32)).requires_grad_(True)
    rois = T(np.stack([roi_case(rng, 20, 24, 16, r=30)[1] for _ in range(2)]))
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = trp.roi_pool(feat, rois, (7, 7), SCALE,
                           T(np.array([[320.0, 384.0], [200.0, 300.0]], np.float32)))
    masked = rois.shape[1] * 7 * 20 * 24 * 16 * 4
    assert saved and sum(saved) <= feat.numel() * 4 + rois.numel() * 4 + 16
    assert max(saved) < masked / 100
    out.sum().backward()
    assert torch.isfinite(feat.grad).all() and feat.grad.abs().sum() > 0


# --------------------------------------------------------- the VGG models
def vgg_model(cls, tcfg, seed=0):
    """A port VGG model built on the meta device, then given seeded numpy
    weights: normal kernels at Flax's fan-in scale (the RCNN head's at its
    init stds, the RPN's output layers 1000× smaller, as ``_tame_rpn``) and
    small random biases."""
    with torch.device("meta"):
        model = cls(tcfg)
    model = model.to_empty(device="cpu")
    gen = np.random.default_rng(seed)
    state = {}
    for name, t in model.state_dict().items():
        shape, layer = tuple(t.shape), name.rsplit(".", 2)[-2]
        a = gen.standard_normal(shape, dtype=np.float32)
        if name.endswith("weight"):
            std = _DENSE_STD.get(layer, 1.0 / np.sqrt(np.prod(shape[1:])))
            a *= np.float32(std * (1e-3 if layer in ("rpn_cls_score", "rpn_bbox_pred") else 1.0))
        else:
            a *= np.float32(0.05)
        state[name] = torch.from_numpy(a)
    model.load_state_dict(state)
    return model


@torch.no_grad()
def _clear_backbone_kinks(backbone, x):
    """Move the bias of every VGG conv channel that has a pre-activation
    within ``KINK_BAND`` of its ReLU's kink on the images ``x`` (NCHW) by
    the least amount that puts the nearest gap of its values around 0
    (``tests/test_torch_frozen.py::_clear_mask_head_kinks``, the same rule):
    among the backbone's ~5 M pre-activations a few land within float32
    rounding of 0, where the two packages' forwards take opposite sides and
    the gradients below differ by ~4e-3 of their largest.  Returns the
    number of channels moved."""
    moved = 0
    for b, (n_convs, _) in enumerate(VGG16, start=1):
        for i in range(n_convs):
            layer = getattr(backbone, f"conv{b}_{i + 1}")
            pre = layer(x)
            band = KINK_BAND * float(pre.abs().max())
            vals = pre.transpose(0, 1).reshape(pre.shape[1], -1).double()
            for c in (vals.abs() < band).any(dim=1).nonzero().flatten().tolist():
                v = vals[c].sort().values
                v = torch.cat([v.new_tensor([-1e30]), v, v.new_tensor([1e30])])
                mids, wide = (v[1:] + v[:-1]) / 2, (v[1:] - v[:-1]) > 4 * band
                layer.bias[c] -= mids[wide][mids[wide].abs().argmin()].float()
                moved += 1
            pre = layer(x)
            assert not (pre.abs() < band).any(), (b, i)
            x = torch.relu(pre)
        if b < 5:
            x = torch.nn.functional.max_pool2d(x, 2, stride=2)
    return moved


@pytest.fixture(scope="module")
def vgg():
    """(JAX cfg, port cfg, port FasterRCNN, its Flax tree as jnp arrays),
    the backbone's kinks cleared on the step's image."""
    jcfg = vgg_cfg()
    tcfg = port_cfg(jcfg)
    model = vgg_model(FasterRCNN, tcfg)
    x = T(tiny_batch(np.random.RandomState(1), h=192, w=192)["images"]).permute(0, 3, 1, 2)
    assert _clear_backbone_kinks(model.backbone, x) > 0
    return jcfg, tcfg, model, jax.tree.map(jnp.asarray, torch_to_flax(model))


def test_vgg_tree_round_trips_through_the_bridge(vgg):
    """The port's VGG-16 tree is JAX's leaf for leaf, shape for shape
    (``backbone/conv{b}_{i}``, ``top_head/fc6``, ``fc7``, the heads), and
    Flax → port → Flax is exact."""
    jcfg, tcfg, model, params = vgg
    batch = tiny_batch(np.random.RandomState(0), h=192, w=192)
    shapes = jax.eval_shape(lambda: JFasterRCNN(jcfg).init(
        {"params": jax.random.key(0), "sampling": jax.random.key(1)}, train=True,
        **batch))["params"]
    ref = {p: s.shape for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    ref = {tuple(k.key for k in p): s for p, s in ref.items()}
    got = dict(_leaves(jax.tree.map(np.asarray, params)))
    assert {p: a.shape for p, a in got.items()} == ref
    assert ("top_head", "fc6", "kernel") in got and got[("top_head", "fc6", "kernel")].shape == (
        25088, 4096)
    back = dict(_leaves(torch_to_flax(flax_to_torch(jax.tree.map(np.asarray, params), model))))
    for p, a in got.items():
        np.testing.assert_array_equal(back[p], a)


def test_vgg_test_forward_matches_jax(vgg):
    """``test_forward``: rois within 1e-4 px, class probabilities and
    de-normalized deltas within float32 rounding of the convolutions."""
    jcfg, _, model, params = vgg
    batch = tiny_batch(np.random.RandomState(1), h=192, w=192)
    ref = jax.jit(lambda p, i, ii: JFasterRCNN(jcfg).apply({"params": p}, i, ii, train=False))(
        params, batch["images"], batch["im_info"])
    with torch.no_grad():
        got = model(T(batch["images"]), T(batch["im_info"]))
    np.testing.assert_array_equal(got["roi_valid"].numpy(), np.asarray(ref["roi_valid"]))
    assert int(got["roi_valid"].sum()) > 0
    np.testing.assert_allclose(got["rois"].numpy(), np.asarray(ref["rois"]), atol=1e-4)
    np.testing.assert_allclose(got["cls_prob"].numpy(), np.asarray(ref["cls_prob"]), atol=1e-5)
    np.testing.assert_allclose(got["bbox_deltas"].numpy(), np.asarray(ref["bbox_deltas"]),
                               atol=1e-5)


def _draws(key, n_anchors, n_cand, names):
    """The draws JAX's samplers take from the image key ``key``
    (``fold_in(sampling key, 0)``), under the port's names."""
    k_anchor, k_roi = jax.random.split(key, 2) if len(names) == 5 else (key, key)
    u = []
    if "anchor_fg" in names:
        u += [jax.random.uniform(k, (n_anchors,)) for k in jax.random.split(k_anchor)]
    if "roi_fg" in names:
        u += [jax.random.uniform(k, (n_cand,)) for k in jax.random.split(k_roi, 3)]
    return {name: T(np.asarray(x))[None] for name, x in zip(names, u)}


def _port_step(model, tcfg, batch, draws, fixed=None):
    """(loss, aux, Flax-layout gradients) of one port step with ``draws``,
    under ``make_optimizer``'s freeze set."""
    ttrain.make_optimizer(tcfg, model, ttrain.make_lr_schedule(tcfg, 10), fixed_params=fixed)
    model.zero_grad(set_to_none=True)
    tb = {k: T(v) for k, v in batch.items() if k != "sample_seeds"}
    extra = {k: tb[k] for k in ("proposals", "prop_valid") if k in tb}
    loss, aux = model(tb["images"], tb["im_info"], tb["gt_boxes"], tb["gt_valid"], train=True,
                      draws=draws, **extra)
    loss.backward()
    return float(loss.detach()), {k: float(v.detach()) for k, v in aux.items()}, \
        grads_to_flax(model)


def _hold_f32(port, jax_step, fixed, count):
    """Loss and aux within 1e-4; each trainable leaf's gradient within 2e-3
    of its largest; frozen leaves take no gradient."""
    loss, aux, grads = port
    j_loss, j_aux, j_grads = jax_step[:3]
    np.testing.assert_allclose(loss, j_loss, rtol=1e-4)
    for k, v in aux.items():
        np.testing.assert_allclose(v, j_aux[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert int(aux[count]) == int(j_aux[count]) > 0
    got, ref = dict(_leaves(grads)), dict(_leaves(j_grads))
    trainable = {p for p in ref if not ttrain.is_frozen_path(p, fixed)}
    assert set(got) == trainable
    for path in trainable:
        scale = float(np.abs(ref[path]).max())
        err = float(np.abs(got[path] - ref[path]).max())
        assert err <= 2e-3 * scale + 1e-6, ("/".join(path), err, scale)


def test_vgg_train_step_matches_jax(vgg):
    """One FasterRCNN step with JAX's draws: the four losses and the aux,
    and every trainable leaf's gradient; conv1/conv2 (FIXED_PARAMS) take
    none, as JAX's stop after its frozen prefix."""
    jcfg, tcfg, model, params = vgg
    batch = {k: np.asarray(v) for k, v in tiny_batch(np.random.RandomState(1), h=192,
                                                     w=192).items()}
    batch["sample_seeds"] = np.asarray([0], np.int32)
    ref = _jax_step(JFasterRCNN(jcfg), jax.tree.map(np.asarray, params), batch)
    n_anchors = 12 * 12 * jcfg.network.NUM_ANCHORS
    draws = _draws(ref[3], n_anchors, jcfg.TRAIN.RPN_POST_NMS_TOP_N + 4, DRAW_NAMES)
    port = _port_step(model, tcfg, batch, draws)
    _hold_f32(port, ref, jcfg.network.FIXED_PARAMS, "num_fg_rois")
    assert not any(k[1].startswith(("conv1", "conv2")) for k, _ in _leaves(port[2])
                   if k[0] == "backbone")
    for name, p in model.named_parameters():
        assert (p.grad is None) == name.startswith(("backbone.conv1_", "backbone.conv2_"))


@pytest.fixture(scope="module")
def stage_params():
    """The stage graphs' port models and Flax trees (RPNOnly, FastRCNN)."""
    tcfg = port_cfg(vgg_cfg())
    return {kind: vgg_model(cls, tcfg, seed=2 + i)
            for i, (kind, cls) in enumerate((("rpn", RPNOnly), ("rcnn", FastRCNN)))}


@pytest.mark.parametrize("fixed_name", ["FIXED_PARAMS", "FIXED_PARAMS_SHARED"])
def test_vgg_rpn_only_step_matches_jax(stage_params, fixed_name):
    """RPNOnly's train step with JAX's anchor draws; under
    FIXED_PARAMS_SHARED the whole backbone is frozen."""
    jcfg = vgg_cfg()
    tcfg = port_cfg(jcfg)
    model = stage_params["rpn"]
    batch = {k: np.asarray(v) for k, v in tiny_batch(np.random.RandomState(1), h=192,
                                                     w=192).items()}
    batch["sample_seeds"] = np.asarray([0], np.int32)
    ref = _jax_step(JRPNOnly(jcfg), torch_to_flax(model), batch)
    draws = _draws(ref[3], 12 * 12 * jcfg.network.NUM_ANCHORS, 0, tsm.ANCHOR_DRAWS)
    fixed = getattr(jcfg.network, fixed_name)
    port = _port_step(model, tcfg, batch, draws, fixed)
    _hold_f32(port, ref, fixed, "num_fg_anchors")
    if fixed_name == "FIXED_PARAMS_SHARED":
        assert {k[0] for k, _ in _leaves(port[2])} == {"rpn"}


def test_vgg_stage_test_forwards_match_jax(stage_params):
    """RPNOnly's proposals and FastRCNN's probabilities and deltas on the
    batch's proposals (the canvas clamp), against JAX's."""
    jcfg = vgg_cfg()
    rpn, rcnn = stage_params["rpn"], stage_params["rcnn"]
    batch = tiny_batch(np.random.RandomState(1), h=192, w=192)
    ref = jax.jit(lambda p, i, ii: JRPNOnly(jcfg).apply({"params": p}, i, ii, train=False))(
        jax.tree.map(jnp.asarray, torch_to_flax(rpn)), batch["images"], batch["im_info"])
    with torch.no_grad():
        got = rpn(T(batch["images"]), T(batch["im_info"]))
    np.testing.assert_array_equal(got["roi_valid"].numpy(), np.asarray(ref["roi_valid"]))
    np.testing.assert_allclose(got["rois"].numpy(), np.asarray(ref["rois"]), atol=1e-4)
    pb = proposal_batch(np.random.RandomState(1))
    ref = jax.jit(lambda p, b: JFastRCNN(jcfg).apply({"params": p}, b["images"], b["im_info"],
                                                     proposals=b["proposals"],
                                                     prop_valid=b["prop_valid"]))(
        jax.tree.map(jnp.asarray, torch_to_flax(rcnn)), {k: jnp.asarray(v) for k, v in pb.items()})
    with torch.no_grad():
        got = rcnn(T(pb["images"]), T(pb["im_info"]), proposals=T(pb["proposals"]),
                   prop_valid=T(pb["prop_valid"]))
    for k in ("cls_prob", "bbox_deltas"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def rcnn_steps(stage_params):
    """One FastRCNN step on fixed proposals with JAX's roi draws: JAX's
    float32 and bf16 steps, the port's float32 step, and its bf16 step."""
    jcfg = vgg_cfg().replace(TRAIN=dataclasses.replace(vgg_cfg().TRAIN, BATCH_IMAGES=1))
    tcfg = port_cfg(jcfg)
    params_np = torch_to_flax(stage_params["rcnn"])
    batch = proposal_batch(np.random.RandomState(1))
    batch["sample_seeds"] = np.asarray([0], np.int32)
    jax32 = _jax_step(JFastRCNN(jcfg), params_np, batch)
    jax16 = _jax_step(JFastRCNN(bf16(jcfg)), params_np, batch)
    draws = _draws(jax32[3], 0, batch["proposals"].shape[1] + batch["gt_boxes"].shape[1],
                   tsm.ROI_DRAWS)
    port32 = _port_step(stage_params["rcnn"], tcfg, batch, draws)
    model16 = flax_to_torch(params_np, vgg_model(FastRCNN, port_cfg(bf16(jcfg)), seed=9))
    port16 = _port_step(model16, port_cfg(bf16(jcfg)), batch, draws)
    return dict(jcfg=jcfg, jax32=jax32, jax16=jax16, port32=port32, port16=port16,
                model16=model16)


def test_vgg_fast_rcnn_step_matches_jax(rcnn_steps):
    """FastRCNN's float32 step: the RCNN losses and every trainable
    leaf's gradient through ROIPooling's backward."""
    s = rcnn_steps
    _hold_f32(s["port32"], s["jax32"], s["jcfg"].network.FIXED_PARAMS, "num_fg_rois")


def test_vgg_bf16_step_matches_jax(rcnn_steps):
    """The bf16 graph (FOLD_BN on: nothing to fold in VGG): the loss within
    2e-2 of JAX's bf16 step, each group's gradient as near the float32
    step's as JAX's bf16 gradient is; parameters and gradients float32."""
    s = rcnn_steps
    port16 = s["port16"] + (s["model16"], None)
    _hold_step(port16, s["port32"], s["jax16"], "num_fg_rois")
    for p in s["model16"].parameters():
        assert p.dtype == torch.float32
        assert p.grad is None or p.grad.dtype == torch.float32


def test_vgg_bf16_backbone_matches_jax(vgg):
    """The VGG backbone in bf16 (conv5_3 out in bf16) within BF16_TOL of
    JAX's bf16 backbone's largest output."""
    _, _, model, params = vgg
    x = np.random.RandomState(0).rand(1, 64, 96, 3).astype(np.float32) * 50
    ref = jax.jit(lambda p, v: JVGGBackbone(dtype=jnp.bfloat16).apply({"params": p}, v))(
        params["backbone"], jnp.asarray(x))
    bb = VGGBackbone(torch.bfloat16)
    bb.load_state_dict(model.backbone.state_dict())
    with torch.no_grad():
        got = bb(T(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert rel_max(got.float().permute(0, 2, 3, 1), ref) < BF16_TOL


@pytest.mark.parametrize("cls", ["FasterRCNN", "RPNOnly", "FastRCNN"])
@pytest.mark.parametrize("fixed_name", ["FIXED_PARAMS", "FIXED_PARAMS_SHARED"])
def test_vgg_frozen_sets_equal_jax_mask(vgg, stage_params, cls, fixed_name):
    """The tensors ``make_optimizer`` freezes are the leaves JAX's optax
    mask sets to zero: conv1_*/conv2_* (FIXED_PARAMS) or every conv
    (FIXED_PARAMS_SHARED), nothing of the RPN or RCNN heads or fc6/fc7."""
    jcfg, tcfg = vgg[0], vgg[1]
    model = {"FasterRCNN": vgg[2], "RPNOnly": stage_params["rpn"],
             "FastRCNN": stage_params["rcnn"]}[cls]
    fixed = getattr(jcfg.network, fixed_name)
    paths = [tuple(n.split(".")[:-1]) + ("kernel" if n.endswith("weight") else "bias",)
             for n, _ in model.named_parameters()]
    tree = {}
    for p in paths:
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = jnp.ones(())
    tx = j_make_optimizer(jcfg, lambda s: 0.1, fixed_params=fixed)
    updates, _ = tx.update(tree, tx.init(tree), tree)
    j_frozen = {p for p, u in _leaves(jax.tree.map(np.asarray, updates)) if u == 0}
    ttrain.make_optimizer(tcfg, model, ttrain.make_lr_schedule(tcfg, 10), fixed_params=fixed)
    frozen = {p for p, (_, t) in zip(paths, model.named_parameters()) if not t.requires_grad}
    assert frozen == j_frozen
    blocks = VGG_BLOCK_ORDER[:2] if fixed_name == "FIXED_PARAMS" else VGG_BLOCK_ORDER
    assert frozen == {p for p in paths if p[0] == "backbone" and p[1].startswith(blocks)}


def test_make_optimizer_trains_vgg_and_refuses_thawed_bn():
    """A VGG-16 model (no BN) trains under its freeze sets, which hold no
    ``"bn"``; a ResNet freeze set without ``"bn"`` still raises."""
    tcfg = port_cfg(vgg_cfg())
    model = torch.nn.Module()
    model.backbone = VGGBackbone()
    opt = ttrain.make_optimizer(tcfg, model, lambda k: 0.1)
    assert len(opt.params) == 26 - 8
    rcfg = t_generate_config("resnet50", "PascalVOC")
    rcfg = rcfg.replace(network=dataclasses.replace(rcfg.network, FIXED_PARAMS=("conv0",)))
    with torch.device("meta"):
        resnet = FasterRCNN(rcfg)
    with pytest.raises(NotImplementedError, match="BN"):
        ttrain.make_optimizer(rcfg, resnet, lambda k: 0.1)
