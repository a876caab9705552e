"""The PyTorch port's FPN training slice on the CPU against the JAX package,
on the same numpy-seeded inputs and bridged weights: ``roi_levels``, the
neck, the streamed ROIAlign's plain forward and backward (against the gather
``roi_align`` and the streaming Pallas kernel in interpret mode), the
ROIAlign routing, the parameter bridge and the optimizer on the FPN tree,
``_propose_multilevel``, and one ``fpn_cfg`` train step with JAX's sampling
draws injected (losses, aux, sampled rois and labels, every gradient, the
updated parameters)."""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mx_rcnn_tpu.core.train import is_frozen_path as j_is_frozen_path
from mx_rcnn_tpu.core.train import make_lr_schedule as j_make_lr_schedule
from mx_rcnn_tpu.core.train import make_optimizer as j_make_optimizer
from mx_rcnn_tpu.models.fpn import FPNFasterRCNN as JFPNFasterRCNN
from mx_rcnn_tpu.models.fpn import FPNNeck as JFPNNeck
from mx_rcnn_tpu.models.fpn import roi_levels as j_roi_levels
from mx_rcnn_tpu.models.layers import normalize_images as j_normalize_images
from mx_rcnn_tpu.ops import targets as jtargets
from mx_rcnn_tpu.ops.pallas import roi_align as j_pallas_roi
from mx_rcnn_tpu.ops.pallas import roi_align_stream as j_stream
from mx_rcnn_tpu.ops.roi_align import roi_align as j_roi_align
from mx_rcnn_tpu_torch.config import generate_config as t_generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.models import faster_rcnn as tfr
from mx_rcnn_tpu_torch.models import fpn as tfpn
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.ops import roi_align as troi
from mx_rcnn_tpu_torch.ops import roi_align_stream as tstream
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, grads_to_flax, torch_to_flax
from tests.test_fpn import fpn_batch, fpn_cfg
from tests.test_pallas_roi_align import random_rois
from tests.test_torch_model import _perturb, _tame_rpn, port_cfg

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# ---------------------------------------------------------------- levels
def test_roi_levels_match(rng):
    """Bitwise: the canonical cases of tests/test_fpn.py sit exactly on level
    boundaries (224 → P4, 112 → P3, 448 → P5), the random rois span every
    level and the clamps."""
    canonical = np.array([[0, 0, 31, 31], [0, 0, 111, 111], [0, 0, 223, 223],
                          [0, 0, 447, 447], [0, 0, 2000, 2000]], np.float32)
    rand = random_rois(rng, 400, 1200, 1600)
    for rois in (canonical, rand, rand[None].repeat(2, 0)):
        got = tfpn.roi_levels(T(rois)).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_roi_levels(jnp.asarray(rois))))
    np.testing.assert_array_equal(tfpn.roi_levels(T(canonical)).numpy(), [2, 3, 4, 5, 5])
    assert set(tfpn.roi_levels(T(rand)).numpy().tolist()) == {2, 3, 4, 5}


# ------------------------------------------------------------------ neck
@pytest.mark.parametrize("c2_hw", [(32, 24), (25, 19)])   # 25×19: not a multiple of 8
def test_neck_matches(rng, c2_hw):
    """Bridged weights, 1e-5 relative (and 1e-5 absolute).  C2..C5 halve
    with ceil as the backbone's stride-2 convs do, so a 25×19 C2 leaves
    7×5 → 4×3 from C4 to C5, where ``nearest`` and ``nearest-exact`` pick
    different cells."""
    chans = (8, 16, 32, 64)
    h, w = c2_hw
    feats = []
    for c in chans:
        feats.append(rng.randn(2, h, w, c).astype(np.float32))
        h, w = -(-h // 2), -(-w // 2)
    jneck = JFPNNeck(channels=16)
    params = jneck.init(jax.random.key(0), [jnp.asarray(f) for f in feats])["params"]
    params_np = _perturb(jax.tree.map(np.asarray, dict(params)), np.random.RandomState(3))
    ref = jneck.apply({"params": params_np}, [jnp.asarray(f) for f in feats])
    neck = tfpn.FPNNeck(chans, 16)
    holder = torch.nn.Module()
    holder.neck = neck
    flax_to_torch({"neck": params_np}, holder)
    with torch.inference_mode():
        got = neck([T(f).permute(0, 3, 1, 2) for f in feats])
    assert len(got) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------- streamed ROIAlign
def _stream_case(rng, b, h, w, c, r, scale):
    """P2-like inputs: random rois over the canvas plus the edge cases of
    random_rois, one inverted roi and one fully off the map per image."""
    feat = rng.randn(b, h, w, c).astype(np.float32)
    rois = np.stack([random_rois(rng, r, h / scale, w / scale) for _ in range(b)])
    rois[:, 4] = [300.0, 40.0, 200.0, 90.0]            # inverted: x2 < x1
    rois[:, 5] = [-80.0, -60.0, -20.0, -10.0]          # above and left of the map
    return feat, rois


@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_roi_align_stream_plain_matches_gather_on_valid_rois(rng, pooled):
    """The gather ``roi_align`` of the JAX package (canvas clamp) on every
    roi with x2 ≥ x1: within 1e-5; the inverted roi pools to zeros."""
    feat, rois = _stream_case(rng, 2, 24, 20, 32, 9, 0.25)
    got = tstream.roi_align_stream_plain(T(feat), T(rois), pooled, 0.25, 2).numpy()
    for i in range(2):
        ref = np.asarray(j_roi_align(jnp.asarray(feat[i]), jnp.asarray(rois[i]), pooled, 0.25, 2))
        valid = rois[i, :, 2] >= rois[i, :, 0]
        assert valid.sum() == 8
        np.testing.assert_allclose(got[i][valid], ref[valid], rtol=1e-5, atol=1e-5)
        assert not got[i][~valid].any()


@pytest.fixture
def small_row_blocks(monkeypatch):
    """8-row blocks in the JAX streaming kernel, so its rois straddle
    several blocks, the last one ragged."""
    monkeypatch.setattr(j_stream, "_pick_hblk", lambda w, cblk, budget=0: 8)


@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_roi_align_stream_plain_matches_pallas_interpret(rng, small_row_blocks, pooled):
    """``roi_align_stream(..., interpret=True)`` on 27 rows (4 blocks of 8),
    inverted and off-map rois included: within 1e-4, the bar of
    tests/test_pallas_roi_align.py for the interpret-mode one-hot matmuls."""
    feat, rois = _stream_case(rng, 1, 27, 16, 16, 7, 0.25)
    ref = j_stream.roi_align_stream(jnp.asarray(feat), jnp.asarray(rois), pooled, 0.25, 2, True)
    got = tstream.roi_align_stream_plain(T(feat), T(rois), pooled, 0.25, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    assert not got[0, 4].any() and not np.asarray(ref)[0, 4].any()


def test_roi_align_stream_bwd_plain_matches_pallas_vjp(rng, small_row_blocks):
    """The plain backward against ``jax.vjp`` of the streaming kernel
    (interpret mode, 8-row blocks): within 1e-4; the inverted roi adds
    nothing."""
    feat, rois = _stream_case(rng, 1, 26, 20, 16, 7, 0.25)
    cot = rng.randn(1, 7, 7, 7, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda f: j_stream.roi_align_stream(f, jnp.asarray(rois), (7, 7), 0.25, 2, True),
                     jnp.asarray(feat))
    (ref,) = vjp(jnp.asarray(cot))
    got = tstream.roi_align_stream_bwd_plain(T(cot), T(rois), feat.shape, (7, 7), 0.25, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    only_inverted = np.zeros_like(cot)
    only_inverted[0, 4] = cot[0, 4]
    assert not tstream.roi_align_stream_bwd_plain(
        T(only_inverted), T(rois), feat.shape, (7, 7), 0.25, 2).any()


def test_roi_align_stream_bwd_plain_matches_autograd(rng):
    """The plain backward is the adjoint of the plain forward (torch
    autograd through it): within 1e-4, the C4 backward's bar (a cell's sum
    of ~100 terms, taken in another order)."""
    feat, rois = _stream_case(rng, 2, 18, 22, 8, 6, 0.125)
    f = T(feat).requires_grad_()
    out = tstream.roi_align_stream_plain(f, T(rois), (14, 14), 0.125, 2)
    cot = T(rng.randn(*out.shape).astype(np.float32))
    (ref,) = torch.autograd.grad((out * cot).sum(), f)
    got = tstream.roi_align_stream_bwd_plain(cot, T(rois), feat.shape, (14, 14), 0.125, 2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_roi_align_stream_function_wires_both_kernels(rng, monkeypatch):
    """RoIAlignStreamFunction's forward and backward call the two launchers
    with the arguments the plain versions take (routed to the plain versions
    here, where no card is present); rois get no gradient."""
    calls = []
    monkeypatch.setattr(tstream, "_roi_align_stream_cuda",
                        lambda *a: calls.append("fwd") or tstream.roi_align_stream_plain(*a))
    monkeypatch.setattr(tstream, "_roi_align_stream_bwd_cuda",
                        lambda *a: calls.append("bwd") or tstream.roi_align_stream_bwd_plain(*a))
    feat, rois = _stream_case(rng, 2, 12, 14, 8, 6, 0.25)
    f1, f2 = T(feat).requires_grad_(), T(feat).requires_grad_()
    r = T(rois).requires_grad_()
    cot = T(rng.randn(2, 6, 7, 7, 8).astype(np.float32))
    (tstream.RoIAlignStreamFunction.apply(f1, r, (7, 7), 0.25, 2) * cot).sum().backward()
    (tstream.roi_align_stream_plain(f2, T(rois), (7, 7), 0.25, 2) * cot).sum().backward()
    assert calls == ["fwd", "bwd"] and r.grad is None
    np.testing.assert_allclose(f1.grad.numpy(), f2.grad.numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- routing
def test_fits_vmem_matches_jax():
    hs = (10, 19, 38, 50, 76, 100, 152, 256)
    ws = (16, 32, 64, 100, 128, 256)
    for h in hs:
        for w in ws:
            for c in (64, 256, 384, 1024):
                for pooled_max in (7, 14):
                    assert troi.fits_vmem(h, w, c, pooled_max) == j_pallas_roi.fits_vmem(
                        h, w, c, pooled_max), (h, w, c, pooled_max)
    # the FPN train canvas (608 × 1024, 256 channels, 14 × 14): P2 and P3
    # stream, P4 and P5 stay resident
    assert [troi.fits_vmem(608 // s, 1024 // s, 256) for s in (4, 8, 16, 32)] == [
        False, False, True, True]


@pytest.mark.parametrize("stride,fwd_only,with_valid_hw,route", [
    (4, False, False, "stream"), (8, False, False, "stream"),
    (16, False, False, "resident"), (32, False, False, "resident"),
    (4, True, False, "resident"), (4, False, True, "resident"),
])
def test_extract_roi_features_routes_as_jax(monkeypatch, stride, fwd_only, with_valid_hw, route):
    """At the FPN train canvas P2/P3 take the streamed wrapper and P4/P5
    the resident one, as the JAX package routes them to its two Pallas
    kernels; a forward-only graph or ``valid_hw`` keeps the resident one."""
    calls = []
    monkeypatch.setattr(troi, "roi_align", lambda f, *a: calls.append("resident") or f)
    monkeypatch.setattr(tstream, "roi_align_stream", lambda f, *a: calls.append("stream") or f)
    feat = torch.zeros((1, 608 // stride, 1024 // stride, 256))
    valid_hw = torch.tensor([[600.0, 800.0]]) if with_valid_hw else None
    troi.extract_roi_features_batched(feat, torch.zeros((1, 3, 4)), "roi_align", (14, 14),
                                      1.0 / stride, 2, fwd_only=fwd_only, valid_hw=valid_hw)
    assert calls == [route]


# --------------------------------------------------------- model pieces
@pytest.fixture(scope="module")
def fpn_trees():
    """(JAX cfg, port cfg, port model's Flax tree with perturbed BN and a
    tamed RPN, the JAX model's parameter shapes, the port model that
    ``build_model`` built)."""
    jcfg = fpn_cfg()
    tcfg = port_cfg(jcfg)
    model = build_model(tcfg, generator=torch.Generator().manual_seed(0))
    params_np = _tame_rpn(_perturb(torch_to_flax(model), np.random.RandomState(1)))
    batch = fpn_batch(np.random.RandomState(0))
    shapes = jax.eval_shape(
        lambda: JFPNFasterRCNN(jcfg).init(
            {"params": jax.random.key(0), "sampling": jax.random.key(1)}, train=True, **batch)
    )["params"]
    return jcfg, tcfg, params_np, shapes, model


def test_build_model_dispatches_on_use_fpn(fpn_trees):
    _, tcfg, _, _, model = fpn_trees
    assert isinstance(model, tfpn.FPNFasterRCNN)
    c4 = port_cfg(fpn_cfg()).replace(network=t_generate_config("resnet50", "PascalVOC").network)
    assert isinstance(build_model(c4), FasterRCNN)
    with pytest.raises(NotImplementedError, match="USE_FPN"):
        FasterRCNN(tcfg)


def test_fpn_refuses_what_is_not_ported(fpn_trees):
    """Frozen-proposal training raises; a mask model builds and its
    inference forward runs (held against JAX in ``tests/test_torch_mask.py``;
    its training in ``tests/test_torch_mask_train.py``)."""
    _, tcfg, _, _, model = fpn_trees
    x, info = torch.zeros((1, 64, 64, 3)), torch.tensor([[64.0, 64.0, 1.0]])
    with pytest.raises(NotImplementedError, match="frozen-proposal"):
        model(x, info, train=True, proposals=torch.zeros((1, 4, 4)), prop_valid=torch.ones(1, 4))
    mask = tcfg.replace(network=dataclasses.replace(tcfg.network, USE_MASK=True))
    mask_model = tfpn.FPNFasterRCNN(mask)
    with torch.inference_mode():
        out = mask_model.eval()(x, info)
    assert out["mask_logits"].shape == (1, tcfg.TEST.RPN_POST_NMS_TOP_N, 28, 28,
                                        tcfg.dataset.NUM_CLASSES)


def test_bridge_round_trip_is_exact_on_the_fpn_tree(fpn_trees):
    """The port's module names give the JAX FPN tree, leaf for leaf and
    shape for shape (no name table), and the round trip is exact."""
    _, tcfg, params_np, shapes, model = fpn_trees
    ref = dict(_leaves(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))))
    got = dict(_leaves(params_np))
    assert set(got) == set(ref)
    for path, a in got.items():
        assert a.shape == ref[path].shape, path
    assert {p[0] for p in got} == {"backbone", "neck", "rpn", "top_head", "rcnn"}
    assert got[("rpn", "rpn_conv", "kernel")].shape == (3, 3, 256, 256)
    assert got[("top_head", "fc1", "kernel")].shape == (14 * 14 * 256, 1024)
    back = dict(_leaves(torch_to_flax(flax_to_torch(params_np, model))))
    for path, a in got.items():
        np.testing.assert_array_equal(back[path], a, err_msg="/".join(path))


def test_init_follows_each_layers_flax_initializer():
    """``fc1``/``fc2`` draw lecun_normal (std 1/sqrt(fan_in), truncated at
    2σ), not the RCNN head's N(0.01): at resnet_fpn's fan-in 14·14·256 =
    50176 the std is 4.46e-3.  cls_score and bbox_pred keep N(0.01) and
    N(0.001)."""
    holder = torch.nn.Module()
    holder.top_head = tfpn.FPNTopHead(14 * 14 * 256)
    holder.rcnn = tfr.RCNNHead(1024, 21)
    tfr.init_weights(holder, torch.Generator().manual_seed(4))
    with torch.no_grad():
        for layer, fan_in in ((holder.top_head.fc1, 14 * 14 * 256), (holder.top_head.fc2, 1024)):
            std = float(layer.weight.std())
            assert abs(std / math.sqrt(1.0 / fan_in) - 1.0) < 0.01, (layer, std)
            assert float(layer.weight.abs().max()) <= 2.0 * math.sqrt(1.0 / fan_in) / 0.8796 + 1e-7
            assert not layer.bias.any()
        assert abs(float(holder.rcnn.cls_score.weight.std()) / 0.01 - 1.0) < 0.05
        assert abs(float(holder.rcnn.bbox_pred.weight.std()) / 0.001 - 1.0) < 0.05


def test_optimizer_freezes_the_fpn_tree_as_jax_masks_it(fpn_trees):
    """``make_optimizer`` trains ``neck.*``, ``top_head.fc*``, stage2–4, the
    RPN and the RCNN head, and freezes conv0, stage1 and every BN: the
    leaves JAX's optimizer mask (its ``is_frozen_path``) leaves trainable."""
    jcfg, tcfg, params_np, _, model = fpn_trees
    opt = ttrain.make_optimizer(tcfg, model, lambda k: 0.1)
    trainable = {tuple(n.split(".")) for n, p in model.named_parameters() if p.requires_grad}
    ref = {path[:-1] + ("weight" if path[-1] == "kernel" else path[-1],)
           for path, _ in _leaves(params_np)
           if not j_is_frozen_path(path, jcfg.network.FIXED_PARAMS)}
    assert trainable == ref
    assert len(opt.params) == len(trainable)
    groups = {p[0] if p[0] != "backbone" else ".".join(p[:2]) for p in trainable}
    assert groups == {"backbone.stage2", "backbone.stage3", "backbone.stage4", "neck", "rpn",
                      "top_head", "rcnn"}
    assert ("top_head", "fc1", "weight") in trainable and ("neck", "lateral2", "bias") in trainable


def test_propose_multilevel_matches(rng):
    """Equal keep sets (valid masks) and boxes within 1e-4 px, for two
    images of different sizes over a five-level anchor table."""
    shapes = ((16, 20), (8, 10), (4, 5), (2, 3), (1, 2))
    strides = (4, 8, 16, 32, 64)
    from mx_rcnn_tpu.ops.anchors import shifted_anchors
    anchors = np.concatenate([shifted_anchors(h, w, s, scales=(8,)) for (h, w), s in zip(shapes, strides)])
    bounds = np.cumsum([0] + [h * w * 3 for h, w in shapes]).tolist()
    n = anchors.shape[0]
    scores = rng.rand(2, n).astype(np.float32)
    scores[:, :40] = scores[:, 40:80]                  # ties inside a level
    deltas = (rng.randn(2, n, 4) * 0.2).astype(np.float32)
    im_info = np.array([[64.0, 80.0, 1.0], [50.0, 70.0, 0.8]], np.float32)
    ref = jax.jit(jax.vmap(lambda s, d, info: JFPNFasterRCNN._propose_multilevel(
        None, s, d, jnp.asarray(anchors), bounds, info, 256, 60, 0.7, 4)))(
        jnp.asarray(scores), jnp.asarray(deltas), jnp.asarray(im_info))
    got = tfpn.FPNFasterRCNN._propose_multilevel(
        T(scores), T(deltas), T(anchors), bounds, T(im_info), 256, 60, 0.7, 4)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref[2]))
    v = got.valid.numpy()
    assert 10 < v.sum(1).min() and v.sum(1).max() <= 60
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(ref[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy()[v], np.asarray(ref[1])[v], rtol=1e-6)


# ------------------------------------------------------- one train step
def _j_fpn_samples(m, images, im_info, gt_boxes, gt_valid, sample_seeds):
    """The JAX FPN train_forward's samplers and proposals, with its keys."""
    cfg = m.cfg
    t = cfg.TRAIN
    pyramid = m._pyramid(j_normalize_images(images, im_info, cfg))
    logits, deltas, anchors, bounds = m._rpn_over_levels(pyramid)
    key = m.make_rng("sampling")
    keys = jax.vmap(lambda s: jax.random.split(jax.random.fold_in(key, s), 2))(sample_seeds)
    atgt = jax.vmap(lambda g, v, info, k: jtargets.assign_anchor(anchors, g[:, :4], v, info, k, cfg))(
        gt_boxes, gt_valid, im_info, keys[:, 0])
    fg = jax.nn.softmax(logits, axis=-1)[..., 1]
    pre = max(t.RPN_PRE_NMS_TOP_N // (len(bounds) - 1), 256)
    boxes, _, valid = jax.vmap(lambda s, d, info: m._propose_multilevel(
        s, d, anchors, bounds, info, pre, t.RPN_POST_NMS_TOP_N, t.RPN_NMS_THRESH,
        t.RPN_MIN_SIZE))(fg, deltas, im_info)
    samples = jax.vmap(lambda r, rv, g, v, k: jtargets.sample_rois(r, rv, g, v, k, cfg))(
        boxes, valid, gt_boxes, gt_valid, keys[:, 1])
    return atgt.labels, valid, samples.rois, samples.labels, key


@pytest.fixture(scope="module")
def fpn_step(fpn_trees):
    """One JAX FPN train step (value_and_grad, then its optax update) and
    one port step from the same weights, with the JAX step's sampling draws
    injected into the port."""
    jcfg, tcfg, params_np, _, _ = fpn_trees
    batch = fpn_batch(np.random.RandomState(1))
    batch["sample_seeds"] = jnp.asarray([0], jnp.int32)
    jmodel = JFPNFasterRCNN(jcfg)
    params = jax.tree.map(jnp.asarray, params_np)
    step_key = jax.random.fold_in(jax.random.key(7), 0)

    def loss_fn(p):
        return jmodel.apply({"params": p}, train=True, rngs={"sampling": step_key}, **batch)

    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = j_make_optimizer(jcfg, j_make_lr_schedule(jcfg, 10))
    updates, _ = tx.update(j_grads, tx.init(params), params)
    j_new = optax.apply_updates(params, updates)
    a_labels, p_valid, s_rois, s_labels, key = jax.jit(lambda p: jmodel.apply(
        {"params": p}, batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
        batch["sample_seeds"], method=_j_fpn_samples, rngs={"sampling": step_key}))(params)
    key2 = jmodel.apply({"params": params}, method=lambda m: m.make_rng("sampling"),
                        rngs={"sampling": step_key})
    n_anchors, n_cand = a_labels.shape[1], p_valid.shape[1] + batch["gt_boxes"].shape[1]
    k_anchor, k_roi = jax.random.split(jax.random.fold_in(key2, 0), 2)
    u = [jax.random.uniform(k, (n_anchors,)) for k in jax.random.split(k_anchor)]
    u += [jax.random.uniform(k, (n_cand,)) for k in jax.random.split(k_roi, 3)]
    draws = {name: T(np.asarray(x))[None] for name, x in zip(tfr.DRAW_NAMES, u)}

    model = flax_to_torch(params_np, tfpn.FPNFasterRCNN(tcfg))
    captured = {}
    orig = (tfpn.assign_anchor, tfpn.sample_rois)
    tfpn.assign_anchor = lambda *a, **k: captured.setdefault("anchor", orig[0](*a, **k))
    tfpn.sample_rois = lambda *a, **k: captured.setdefault("rois", orig[1](*a, **k))
    try:
        tb = {k: T(v) for k, v in batch.items() if k != "sample_seeds"}
        pristine = copy.deepcopy(model)
        opt = ttrain.make_optimizer(tcfg, model, ttrain.make_lr_schedule(tcfg, 10))
        opt.zero_grad()
        t_loss, t_aux = model(tb["images"], tb["im_info"], tb["gt_boxes"], tb["gt_valid"],
                              train=True, draws=draws)
        t_loss.backward()
        t_grads = grads_to_flax(model)
        opt.step()
    finally:
        tfpn.assign_anchor, tfpn.sample_rois = orig
    return {
        "jax": dict(loss=j_loss, aux=j_aux, grads=j_grads, params=params, new_params=j_new,
                    key=key, key2=key2, a_labels=a_labels, s_rois=s_rois, s_labels=s_labels),
        "port": dict(loss=t_loss.detach(), aux={k: v.detach() for k, v in t_aux.items()},
                     grads=t_grads, model=model, pristine=pristine, captured=captured, cfg=tcfg),
    }


def test_fpn_step_samples_match(fpn_step):
    """The key the step's draws come from is the one train_forward makes;
    anchor labels, sampled labels identical, sampled rois within 1e-4 px."""
    j, p = fpn_step["jax"], fpn_step["port"]
    assert np.array_equal(jax.random.key_data(j["key"]), jax.random.key_data(j["key2"]))
    cap = p["captured"]
    np.testing.assert_array_equal(cap["anchor"].labels.numpy(), np.asarray(j["a_labels"]))
    np.testing.assert_array_equal(cap["rois"].labels.numpy(), np.asarray(j["s_labels"]))
    np.testing.assert_allclose(cap["rois"].rois.numpy(), np.asarray(j["s_rois"]), atol=1e-4)
    assert (cap["rois"].labels > 0).sum() > 0 and (cap["anchor"].labels == 1).sum() > 0


def test_fpn_step_losses_and_aux_match(fpn_step):
    """Losses and aux within 1e-4 relative (f32 convolutions sum in another
    order in torch and XLA); the counts equal."""
    j, p = fpn_step["jax"], fpn_step["port"]
    assert set(p["aux"]) == set(j["aux"])
    np.testing.assert_allclose(float(p["loss"]), float(j["loss"]), rtol=1e-4)
    for k, v in p["aux"].items():
        np.testing.assert_allclose(float(v), float(j["aux"][k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("num_fg_rois", "num_valid_props", "num_fg_anchors"):
        assert int(p["aux"][k]) == int(j["aux"][k])


def test_fpn_step_gradients_match(fpn_step):
    """Every trainable leaf's gradient within 2e-3 of the leaf's largest
    gradient (and 1e-6 absolute), the C4 step's bar: the f32 sums of the
    convolutions and their backward run in another order in torch and XLA."""
    j, p = fpn_step["jax"], fpn_step["port"]
    got = dict(_leaves(p["grads"]))
    ref = dict(_leaves(jax.tree.map(np.asarray, j["grads"])))
    trainable = {path for path in ref
                 if not ttrain.is_frozen_path(path, p["cfg"].network.FIXED_PARAMS)}
    assert set(got) == trainable
    assert {path[0] for path in got} == {"backbone", "neck", "rpn", "top_head", "rcnn"}
    for path in trainable:
        scale = float(np.abs(ref[path]).max())
        err = float(np.abs(got[path] - ref[path]).max())
        assert err <= 2e-3 * scale + 1e-6, ("/".join(path), err, scale)


def test_fpn_step_updated_params_match(fpn_step):
    """After one MXNet SGD step: trainable leaves within 1e-5 relative of
    JAX's, frozen leaves unchanged on both sides."""
    j, p = fpn_step["jax"], fpn_step["port"]
    got = dict(_leaves(torch_to_flax(p["model"])))
    new = dict(_leaves(jax.tree.map(np.asarray, j["new_params"])))
    old = dict(_leaves(jax.tree.map(np.asarray, j["params"])))
    pristine = dict(_leaves(torch_to_flax(p["pristine"])))
    frozen = {path for path in new if ttrain.is_frozen_path(path, p["cfg"].network.FIXED_PARAMS)}
    assert any(path[1] == "stage1" for path in frozen)
    for path in new:
        if path in frozen:
            np.testing.assert_array_equal(new[path], old[path])
            np.testing.assert_array_equal(got[path], pristine[path])
        else:
            np.testing.assert_allclose(got[path], new[path], rtol=1e-5, atol=1e-7,
                                       err_msg="/".join(path))
    assert all(not np.array_equal(got[path], pristine[path])
               for path in new if path not in frozen and path[-1] == "kernel")


def test_cli_trains_the_fpn_network_on_the_cpu(monkeypatch, tmp_path):
    """``--network resnet_fpn`` builds the FPN model through build_model and
    trains one step through ``fit`` on the CPU (a small canvas)."""
    from mx_rcnn_tpu_torch.tools import train_end2end as cli

    def small(network, dataset):
        cfg = t_generate_config(network, dataset)
        assert network == "resnet_fpn" and cfg.network.USE_FPN
        return cfg.replace(
            dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
            SHAPE_BUCKETS=((96, 128), (128, 96)),
            TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=400, RPN_POST_NMS_TOP_N=32,
                                      BATCH_ROIS=16, RPN_BATCH_SIZE=32))

    monkeypatch.setattr(cli, "generate_config", small)
    out = cli.main(["--network", "resnet_fpn", "--cpu", "1", "--synthetic", "4", "--max_steps", "1",
                    "--prefix", str(tmp_path / "e2e")])
    assert out["steps"] == 1
    assert all(math.isfinite(v) for v in out["history"][0].values())
