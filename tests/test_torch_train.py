"""The PyTorch port's training slice on the CPU against the JAX package, on
the same numpy-seeded inputs and bridged weights: ``bbox_transform``, the
losses, the samplers with JAX's uniforms injected, the ROIAlign backward, the
MXNet SGD, the loader's batch plan, and one ``tiny_cfg`` train step
(losses, aux, sampled rois and labels, every gradient, the updated
parameters)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mx_rcnn_tpu.core.train import make_lr_schedule as j_make_lr_schedule
from mx_rcnn_tpu.core.train import make_optimizer as j_make_optimizer
from mx_rcnn_tpu.core.train import create_train_state, make_train_step as j_make_train_step
from mx_rcnn_tpu.data import loader as jloader
from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from mx_rcnn_tpu.data.synthetic import synthetic_image as j_synthetic_image
from mx_rcnn_tpu.data.imdb import IMDB as JIMDB
from mx_rcnn_tpu.models import FasterRCNN as JFasterRCNN
from mx_rcnn_tpu.models.layers import normalize_images as j_normalize_images
from mx_rcnn_tpu.ops import boxes as jboxes
from mx_rcnn_tpu.ops import losses as jlosses
from mx_rcnn_tpu.ops import targets as jtargets
from mx_rcnn_tpu.ops.anchors import shifted_anchors
from mx_rcnn_tpu.ops.pallas.roi_align import roi_align_pallas
from mx_rcnn_tpu.ops.proposal import propose as j_propose
from mx_rcnn_tpu.ops.roi_align import roi_align as j_roi_align
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.data import loader as tloader
from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset, synthetic_image
from mx_rcnn_tpu_torch.models import faster_rcnn as tfr
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.models.heads import RCNNHead
from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm
from mx_rcnn_tpu_torch.ops import boxes as tboxes
from mx_rcnn_tpu_torch.ops import losses as tlosses
from mx_rcnn_tpu_torch.ops import roi_align as troi
from mx_rcnn_tpu_torch.ops import targets as ttargets
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, grads_to_flax, torch_to_flax
from tests.test_model import tiny_batch, tiny_cfg
from tests.test_nms import random_dets
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


def train_cfg():
    """``tiny_cfg`` with anchors small enough (32–128 px) that some lie
    inside a 128 × 128 image, so the RPN losses and gradients are live."""
    cfg = tiny_cfg()
    return cfg.replace(network=dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4, 8)))


# ------------------------------------------------------------ boxes, losses
def test_bbox_transform_matches(rng):
    ex, _ = random_dets(rng, 50)
    gt, _ = random_dets(rng, 50)
    ex[0] = [5, 5, 5, 5]                  # one-pixel roi
    np.testing.assert_allclose(
        tboxes.bbox_transform(T(ex), T(gt)).numpy(),
        np.asarray(jboxes.bbox_transform(jnp.asarray(ex), jnp.asarray(gt))),
        rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_smooth_l1_losses_match(rng, sigma):
    pred = rng.randn(40, 8).astype(np.float32)
    target = rng.randn(40, 8).astype(np.float32) * 0.3
    weight = (rng.rand(40, 8) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.smooth_l1(T(pred), T(target), sigma).numpy(),
        np.asarray(jlosses.smooth_l1(pred, target, sigma)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(tlosses.weighted_smooth_l1(T(pred), T(target), T(weight), sigma, 128.0)),
        float(jlosses.weighted_smooth_l1(pred, target, weight, sigma, 128.0)), rtol=1e-6)


@pytest.mark.parametrize("norm", [None, 256.0])
def test_softmax_cross_entropy_and_accuracy_match(rng, norm):
    logits = (rng.randn(300, 21) * 3).astype(np.float32)
    logits[:10] = 1.0                     # all-tie rows: argmax takes the first
    labels = rng.randint(-1, 21, 300).astype(np.int32)
    got = tlosses.softmax_cross_entropy(T(logits), T(labels), -1, norm)
    ref = jlosses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), -1, norm)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.accuracy(T(logits), T(labels))),
                               float(jlosses.accuracy(logits, labels)), rtol=1e-7)
    assert int(torch.argmax(T(logits[:10]), -1).max()) == 0
    # ignored rows get no gradient
    lt = T(logits).requires_grad_()
    tlosses.softmax_cross_entropy(lt, T(labels), -1, norm).backward()
    assert float(lt.grad[T(labels) == -1].abs().max()) == 0.0


# ------------------------------------------------------------------ samplers
def _gt(rng, b, g, h, w, n_valid):
    boxes = np.zeros((b, g, 5), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        d, _ = random_dets(rng, n_valid[i], span=min(h, w) * 0.6)
        boxes[i, : n_valid[i], :4] = d
        boxes[i, : n_valid[i], 4] = rng.randint(1, 21, n_valid[i])
        valid[i, : n_valid[i]] = True
    return boxes, valid


def test_assign_anchor_matches_with_jax_draws(rng):
    cfg = train_cfg()
    tcfg = port_cfg(cfg)
    h, w = 160.0, 200.0
    anchors = shifted_anchors(10, 13, 16, ratios=cfg.network.ANCHOR_RATIOS,
                              scales=cfg.network.ANCHOR_SCALES)
    gt, gt_valid = _gt(rng, 2, 6, h, w, [3, 5])
    im_info = np.array([[h, w, 1.0], [h - 30, w, 1.0]], np.float32)
    keys = jax.random.split(jax.random.key(3), 2)
    ref, u_fg, u_bg = [], [], []
    for i in range(2):
        ref.append(jtargets.assign_anchor(jnp.asarray(anchors), jnp.asarray(gt[i, :, :4]),
                                          jnp.asarray(gt_valid[i]), jnp.asarray(im_info[i]),
                                          keys[i], cfg))
        k_fg, k_bg = jax.random.split(keys[i])
        u_fg.append(np.asarray(jax.random.uniform(k_fg, (len(anchors),))))
        u_bg.append(np.asarray(jax.random.uniform(k_bg, (len(anchors),))))
    got = ttargets.assign_anchor(T(anchors), T(gt), T(gt_valid), T(im_info), tcfg,
                                 u=(T(u_fg), T(u_bg)))
    for i in range(2):
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(ref[i].labels))
        np.testing.assert_allclose(got.bbox_targets[i].numpy(), np.asarray(ref[i].bbox_targets),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got.bbox_weights[i].numpy(), np.asarray(ref[i].bbox_weights))
        assert (got.labels[i] == 1).sum() > 0 and (got.labels[i] == 0).sum() > 0


@pytest.mark.parametrize("n_props", [200, 20])   # 20 + 6 < BATCH_ROIS: the padding branch
def test_sample_rois_matches_with_jax_draws(rng, n_props):
    cfg = train_cfg()
    tcfg = port_cfg(cfg)
    gt, gt_valid = _gt(rng, 2, 6, 200, 200, [4, 2])
    rois = np.stack([random_dets(rng, n_props, span=150.0)[0] for _ in range(2)])
    for i in range(2):      # some proposals near each gt, so there are fg rois
        rois[i, :5] = gt[i, 0, :4] + rng.randn(5, 4).astype(np.float32) * 3
    rois_valid = rng.rand(2, n_props) > 0.1
    keys = jax.random.split(jax.random.key(5), 2)
    p = n_props + 6
    ref, draws = [], []
    for i in range(2):
        ref.append(jtargets.sample_rois(jnp.asarray(rois[i]), jnp.asarray(rois_valid[i]),
                                        jnp.asarray(gt[i]), jnp.asarray(gt_valid[i]), keys[i], cfg))
        draws.append([np.asarray(jax.random.uniform(k, (p,)))
                      for k in jax.random.split(keys[i], 3)])
    u = tuple(T(np.stack([d[j] for d in draws])) for j in range(3))
    got = ttargets.sample_rois(T(rois), T(rois_valid), T(gt), T(gt_valid), tcfg, u=u)
    for i in range(2):
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(ref[i].labels))
        np.testing.assert_array_equal(got.rois[i].numpy(), np.asarray(ref[i].rois))
        np.testing.assert_array_equal(got.gt_index[i].numpy(), np.asarray(ref[i].gt_index))
        np.testing.assert_allclose(got.bbox_targets[i].numpy(), np.asarray(ref[i].bbox_targets),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got.bbox_weights[i].numpy(), np.asarray(ref[i].bbox_weights))
        assert (got.labels[i] > 0).sum() > 0


def test_samplers_draw_from_a_generator_or_raise(rng):
    cfg = port_cfg(train_cfg())
    gt, gt_valid = _gt(rng, 1, 4, 160, 160, [2])
    anchors = T(shifted_anchors(10, 10, 16, scales=(2, 4, 8)))
    args = (anchors, T(gt), T(gt_valid), T([[160.0, 160.0, 1.0]]), cfg)
    a = ttargets.assign_anchor(*args, generator=torch.Generator().manual_seed(1))
    b = ttargets.assign_anchor(*args, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.labels, b.labels)
    with pytest.raises(ValueError, match="Generator"):
        ttargets.assign_anchor(*args)


# ---------------------------------------------------------- ROIAlign backward
def _roi_case(rng, b, h, w, c, r):
    feat = rng.randn(b, h, w, c).astype(np.float32)
    rois = np.stack([random_rois(rng, r, h * 16, w * 16) for _ in range(b)])
    return feat, rois


@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_roi_align_bwd_plain_matches_jax_grads(rng, pooled):
    feat, rois = _roi_case(rng, 2, 14, 18, 128, 5)
    cot = rng.randn(2, 5, *pooled, 128).astype(np.float32)
    jf, jr, jc = jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(cot)
    ref_pallas = jax.grad(
        lambda f: (roi_align_pallas(f, jr, pooled, 1.0 / 16, 2, True) * jc).sum())(jf)
    ref_gather = jax.grad(lambda f: sum(
        (j_roi_align(f[i], jr[i], pooled, 1.0 / 16, 2) * jc[i]).sum() for i in range(2)))(jf)
    got = troi.roi_align_bwd_plain(T(cot), T(rois), feat.shape, pooled, 1.0 / 16, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_pallas), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_gather), rtol=1e-4, atol=1e-4)


def test_roi_align_bwd_plain_valid_hw_matches_jax_grad(rng):
    feat, rois = _roi_case(rng, 2, 14, 18, 64, 6)
    valid_hw = np.array([[150.0, 200.0], [224.0, 120.0]], np.float32)
    cot = rng.randn(2, 6, 7, 7, 64).astype(np.float32)
    jr, jc, jv = jnp.asarray(rois), jnp.asarray(cot), jnp.asarray(valid_hw)
    ref = jax.grad(lambda f: sum(
        (j_roi_align(f[i], jr[i], (7, 7), 1.0 / 16, 2, valid_hw=jv[i]) * jc[i]).sum()
        for i in range(2)))(jnp.asarray(feat))
    got = troi.roi_align_bwd_plain(T(cot), T(rois), feat.shape, (7, 7), 1.0 / 16, 2, T(valid_hw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_valid_hw", [False, True])
def test_roi_align_bwd_plain_matches_autograd(rng, with_valid_hw):
    feat, rois = _roi_case(rng, 2, 12, 15, 32, 7)
    valid_hw = T([[120.0, 200.0], [192.0, 90.0]]) if with_valid_hw else None
    f = T(feat).requires_grad_()
    out = troi.roi_align_plain(f, T(rois), (14, 14), 1.0 / 16, 2, valid_hw)
    cot = T(rng.randn(*out.shape).astype(np.float32))
    (ref,) = torch.autograd.grad((out * cot).sum(), f)
    got = troi.roi_align_bwd_plain(cot, T(rois), feat.shape, (14, 14), 1.0 / 16, 2, valid_hw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_roi_align_function_wires_both_kernels(rng, monkeypatch):
    """RoIAlignFunction's forward and backward call the two launchers with
    the arguments the plain versions take (routed to the plain versions
    here, where no card is present); rois get no gradient."""
    calls = []
    monkeypatch.setattr(troi, "_roi_align_cuda", lambda *a: calls.append("fwd") or troi.roi_align_plain(*a))
    monkeypatch.setattr(troi, "_roi_align_bwd_cuda",
                        lambda *a: calls.append("bwd") or troi.roi_align_bwd_plain(*a))
    feat, rois = _roi_case(rng, 2, 10, 12, 16, 4)
    f1, f2 = T(feat).requires_grad_(), T(feat).requires_grad_()
    r = T(rois).requires_grad_()
    cot = T(rng.randn(2, 4, 7, 7, 16).astype(np.float32))
    (troi.RoIAlignFunction.apply(f1, r, (7, 7), 1.0 / 16, 2, None) * cot).sum().backward()
    (troi.roi_align_plain(f2, T(rois), (7, 7), 1.0 / 16, 2) * cot).sum().backward()
    assert calls == ["fwd", "bwd"] and r.grad is None
    np.testing.assert_allclose(f1.grad.numpy(), f2.grad.numpy(), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- optimizer
class _Mini(torch.nn.Module):
    """A few tensors under the Flax tree's names: a frozen ``conv0``, a
    frozen BN, a trainable conv and a trainable head."""

    def __init__(self):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.conv0 = torch.nn.Conv2d(3, 4, 3, bias=False)
        self.backbone.bn0 = FrozenBatchNorm(4)
        self.backbone.stage2 = torch.nn.Module()
        self.backbone.stage2.conv1 = torch.nn.Conv2d(4, 6, 1, bias=True)
        self.rcnn = RCNNHead(8, 3)


def test_optimizer_matches_optax_across_an_lr_boundary(rng):
    cfg = port_cfg(tiny_cfg())
    cfg = cfg.replace(TRAIN=dataclasses.replace(
        cfg.TRAIN, LEARNING_RATE=0.1, LR_STEP_EPOCHS=(1,), LR_FACTOR=0.1))
    jcfg = tiny_cfg()
    jcfg = jcfg.replace(TRAIN=dataclasses.replace(
        jcfg.TRAIN, LEARNING_RATE=0.1, LR_STEP_EPOCHS=(1,), LR_FACTOR=0.1))
    model = _Mini()
    params = jax.tree.map(jnp.asarray, torch_to_flax(model))
    before = dict(_leaves(torch_to_flax(model)))
    tx = j_make_optimizer(jcfg, j_make_lr_schedule(jcfg, 2))
    opt_state = tx.init(params)
    opt = ttrain.make_optimizer(cfg, model, ttrain.make_lr_schedule(cfg, 2))
    assert {tuple(n.split(".")) for n, p in model.named_parameters() if p.requires_grad} == {
        ("backbone", "stage2", "conv1", "weight"), ("backbone", "stage2", "conv1", "bias"),
        ("rcnn", "cls_score", "weight"), ("rcnn", "cls_score", "bias"),
        ("rcnn", "bbox_pred", "weight"), ("rcnn", "bbox_pred", "bias")}
    for step in range(5):           # the boundary at 2 updates scales updates 2 on
        grads = jax.tree.map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 4), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        gmodel = flax_to_torch(jax.tree.map(np.asarray, grads), _Mini())
        opt.zero_grad()
        for (_, p), (_, g) in zip(model.named_parameters(), gmodel.named_parameters()):
            if p.requires_grad:
                p.grad = g.detach().clone()
        opt.step()
        got = dict(_leaves(torch_to_flax(model)))
        for path, ref in _leaves(params):
            np.testing.assert_allclose(got[path], ref, rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {'/'.join(path)}")
    for path in (("backbone", "conv0", "kernel"), ("backbone", "bn0", "scale")):
        np.testing.assert_array_equal(got[path], before[path])
    assert [ttrain.make_lr_schedule(cfg, 2)(k) for k in range(5)] == pytest.approx(
        [0.1, 0.1, 0.01, 0.01, 0.01])


def test_optimizer_refuses_trainable_bn():
    cfg = port_cfg(tiny_cfg())
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, FIXED_PARAMS=("conv0",)))
    with pytest.raises(NotImplementedError, match="BN"):
        ttrain.make_optimizer(cfg, _Mini(), lambda k: 0.1)


# -------------------------------------------------------------------- data
def test_synthetic_roidb_and_images_match():
    ref = JSyntheticDataset(num_images=4, image_size=(160, 200)).gt_roidb()
    got = SyntheticDataset(num_images=4, image_size=(160, 200)).gt_roidb()
    ref, got = JIMDB.append_flipped_images(ref), IMDB.append_flipped_images(got)
    assert len(got) == len(ref) == 8
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(synthetic_image(a, a["synthetic_seed"]),
                                      j_synthetic_image(b, b["synthetic_seed"]))


@pytest.fixture
def jax_render_cache():
    """The JAX loader's render LRU keys synthetic images by (uri, flipped,
    seed), not by size: drop this test's 160×200 renders afterwards, so a
    later test in the same process that renders the same records at
    another size gets its own."""
    yield
    jloader._RENDER_CACHE.clear()


def test_train_loader_plan_and_batches_match(jax_render_cache):
    jcfg = tiny_cfg().replace(SHAPE_BUCKETS=((96, 128), (128, 96)))
    jcfg = jcfg.replace(dataset=dataclasses.replace(jcfg.dataset, SCALES=((96, 128),)))
    cfg = port_cfg(jcfg)
    roidb = SyntheticDataset(num_images=10, image_size=(160, 200)).gt_roidb()
    roidb += [dict(r, height=200, width=160, boxes=r["boxes"][:, [1, 0, 3, 2]])
              for r in roidb[:5]]            # portrait records: the other bucket
    jl = jloader.TrainLoader(roidb, jcfg, 2, shuffle=True, seed=3)
    tl = tloader.TrainLoader(roidb, cfg, 2, shuffle=True, seed=3)
    assert len(tl) == len(jl)
    for epoch in range(2):
        assert tl._epoch_plan(epoch) == jl._epoch_plan(epoch)
    bucket, idxs = tl._epoch_plan(0)[0]
    recs = [roidb[i] for i in idxs]
    got = tloader.make_batch(recs, cfg, bucket, seeds=idxs)
    ref = jloader.make_batch(recs, jcfg, bucket, seeds=idxs)
    assert got.keys() == ref.keys()
    for k in ("im_info", "gt_boxes", "gt_valid", "sample_seeds"):
        np.testing.assert_array_equal(got[k], ref[k])
    # the port's numpy resize is within 5e-5 of cv2 on float images
    np.testing.assert_allclose(got["images"], ref["images"], atol=1e-3)
    batches = list(iter(tl))
    assert tl.epoch == 1 and len(batches) == len(tl)


# ------------------------------------------------------- one train step
def _j_samples(m, images, im_info, gt_boxes, gt_valid, sample_seeds):
    """The JAX train_forward's samplers and proposals, with its keys."""
    cfg = m.cfg
    t = cfg.TRAIN
    feat = m.backbone(j_normalize_images(images, im_info, cfg))
    logits, deltas = m.rpn(feat)
    anchors = m._anchors(feat.shape[1], feat.shape[2])
    key = m.make_rng("sampling")
    keys = jax.vmap(lambda s: jax.random.split(jax.random.fold_in(key, s), 2))(sample_seeds)
    atgt = jax.vmap(lambda g, v, info, k: jtargets.assign_anchor(anchors, g[:, :4], v, info, k, cfg))(
        gt_boxes, gt_valid, im_info, keys[:, 0])
    fg = jax.nn.softmax(logits, axis=-1)[..., 1]
    props = jax.vmap(lambda s, d, info: j_propose(
        s, d, anchors, info, t.RPN_PRE_NMS_TOP_N, t.RPN_POST_NMS_TOP_N, t.RPN_NMS_THRESH,
        t.RPN_MIN_SIZE))(fg, deltas, im_info)
    samples = jax.vmap(lambda r, rv, g, v, k: jtargets.sample_rois(r, rv, g, v, k, cfg))(
        props.rois, props.valid, gt_boxes, gt_valid, keys[:, 1])
    return atgt.labels, props.valid, samples.rois, samples.labels, key


@pytest.fixture(scope="module")
def one_step():
    """One step of JAX ``make_train_step`` and of the port, from the same
    weights (the port's seeded init, bridged, with perturbed BN and a tamed
    RPN) and with JAX's sampling draws injected into the port."""
    jcfg = train_cfg()
    tcfg = port_cfg(jcfg)
    batch = tiny_batch(np.random.RandomState(0))
    batch["sample_seeds"] = jnp.asarray([0], jnp.int32)
    model = FasterRCNN(tcfg, generator=torch.Generator().manual_seed(0))
    params_np = _tame_rpn(_perturb(torch_to_flax(model), np.random.RandomState(1)))
    flax_to_torch(params_np, model)
    jmodel = JFasterRCNN(jcfg)
    params = jax.tree.map(jnp.asarray, params_np)

    tx = j_make_optimizer(jcfg, j_make_lr_schedule(jcfg, 10))
    rng = jax.random.key(7)
    # the key the JAX step hands train_forward: fold_in(rng, state.step = 0)
    step_key = jax.random.fold_in(rng, 0)

    def loss_fn(p):
        return jmodel.apply({"params": p}, train=True, rngs={"sampling": step_key}, **batch)

    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    j_step = j_make_train_step(jmodel, tx, donate=False)
    new_state, j_aux = j_step(create_train_state(params, tx), batch, rng)
    a_labels, p_valid, s_rois, s_labels, key = jax.jit(lambda p: jmodel.apply(
        {"params": p}, batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
        batch["sample_seeds"], method=_j_samples, rngs={"sampling": step_key}))(params)
    # the key train_forward makes, drawn the same way, and its uniforms
    key2 = jmodel.apply({"params": params}, method=lambda m: m.make_rng("sampling"),
                        rngs={"sampling": step_key})
    n_anchors = a_labels.shape[1]
    n_cand = p_valid.shape[1] + batch["gt_boxes"].shape[1]

    def draws_of(step):
        """The port's draws for the JAX step ``step``: the uniforms its
        train_forward draws from ``fold_in(rng, step)`` for image seed 0."""
        k = jmodel.apply({"params": params}, method=lambda m: m.make_rng("sampling"),
                         rngs={"sampling": jax.random.fold_in(rng, step)})
        k_anchor, k_roi = jax.random.split(jax.random.fold_in(k, 0), 2)
        u = [jax.random.uniform(k, (n_anchors,)) for k in jax.random.split(k_anchor)]
        u += [jax.random.uniform(k, (n_cand,)) for k in jax.random.split(k_roi, 3)]
        return {name: T(np.asarray(x))[None] for name, x in zip(tfr.DRAW_NAMES, u)}

    draws = draws_of(0)

    captured = {}
    orig = (tfr.assign_anchor, tfr.sample_rois)
    tfr.assign_anchor = lambda *a, **k: captured.setdefault("anchor", orig[0](*a, **k))
    tfr.sample_rois = lambda *a, **k: captured.setdefault("rois", orig[1](*a, **k))
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
        tfr.assign_anchor, tfr.sample_rois = orig
    return {
        "jax": dict(loss=j_loss, aux=j_aux, grads=j_grads, params=params,
                    new_params=new_state.params, key=key, key2=key2, a_labels=a_labels,
                    s_rois=s_rois, s_labels=s_labels, step=j_step, tx=tx, rng=rng,
                    batch=batch, draws_of=draws_of),
        "port": dict(loss=t_loss.detach(), aux={k: v.detach() for k, v in t_aux.items()}, grads=t_grads, model=model, captured=captured,
                     pristine=pristine, batch=tb, draws=draws, cfg=tcfg),
    }


def test_train_step_key_is_the_one_train_forward_makes(one_step):
    j = one_step["jax"]
    assert np.array_equal(jax.random.key_data(j["key"]), jax.random.key_data(j["key2"]))


def test_train_step_samples_match(one_step):
    j, p = one_step["jax"], one_step["port"]
    cap = p["captured"]
    np.testing.assert_array_equal(cap["anchor"].labels.numpy(), np.asarray(j["a_labels"]))
    np.testing.assert_array_equal(cap["rois"].labels.numpy(), np.asarray(j["s_labels"]))
    np.testing.assert_allclose(cap["rois"].rois.numpy(), np.asarray(j["s_rois"]), atol=1e-4)
    assert (cap["rois"].labels > 0).sum() > 0 and (cap["anchor"].labels == 1).sum() > 0


def test_train_step_losses_and_aux_match(one_step):
    j, p = one_step["jax"], one_step["port"]
    assert set(p["aux"]) == set(j["aux"]) - {"loss"}
    np.testing.assert_allclose(float(p["loss"]), float(j["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(j["aux"]["loss"]), float(j["loss"]), rtol=1e-6)
    for k, v in p["aux"].items():
        # f32 convolutions sum in another order in torch and in XLA: 1e-4
        np.testing.assert_allclose(float(v), float(j["aux"][k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("num_fg_rois", "num_valid_props", "num_fg_anchors"):
        assert int(p["aux"][k]) == int(j["aux"][k])


def test_train_step_gradients_match(one_step):
    """Every trainable leaf's gradient.  Bar: max |Δ| ≤ 2e-3 of the leaf's
    largest gradient (and 1e-6 absolute): the f32 sums of the convolutions
    and their backward run in another order in torch and XLA, and the error
    grows through the 50 layers of the backward."""
    j, p = one_step["jax"], one_step["port"]
    got = dict(_leaves(p["grads"]))
    ref = dict(_leaves(jax.tree.map(np.asarray, j["grads"])))
    trainable = {path for path in ref
                 if not ttrain.is_frozen_path(path, p["cfg"].network.FIXED_PARAMS)}
    assert set(got) == trainable
    assert {path[0] for path in got} == {"backbone", "top_head", "rpn", "rcnn"}
    for path in trainable:
        scale = float(np.abs(ref[path]).max())
        err = float(np.abs(got[path] - ref[path]).max())
        assert err <= 2e-3 * scale + 1e-6, ("/".join(path), err, scale)


def test_train_step_updated_params_match(one_step):
    j, p = one_step["jax"], one_step["port"]
    got = dict(_leaves(torch_to_flax(p["model"])))
    new = dict(_leaves(jax.tree.map(np.asarray, j["new_params"])))
    old = dict(_leaves(jax.tree.map(np.asarray, j["params"])))
    pristine = dict(_leaves(torch_to_flax(p["pristine"])))
    frozen = {path for path in new if ttrain.is_frozen_path(path, p["cfg"].network.FIXED_PARAMS)}
    assert any(path[1] == "conv0" for path in frozen)
    for path in new:
        if path in frozen:
            np.testing.assert_array_equal(new[path], old[path])
            np.testing.assert_array_equal(got[path], pristine[path])
        else:
            np.testing.assert_allclose(got[path], new[path], rtol=1e-5, atol=1e-7,
                                       err_msg="/".join(path))
    assert any(not np.array_equal(got[path], pristine[path]) for path in new if path not in frozen)


def test_port_train_step_equals_the_manual_step(one_step):
    """``train_step`` runs the same forward, backward and update."""
    p = one_step["port"]
    model = copy.deepcopy(p["pristine"])
    opt = ttrain.make_optimizer(p["cfg"], model, ttrain.make_lr_schedule(p["cfg"], 10))
    state, aux = ttrain.train_step(ttrain.create_train_state(model, opt), p["batch"], 0,
                                   draws=p["draws"])
    assert state.model is model and float(aux["loss"]) == float(p["loss"])
    # the CPU convolutions' backward splits its sums over threads, so a
    # second run may round the last bit differently
    for (n, a), (_, b) in zip(model.named_parameters(), p["model"].named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6, atol=1e-8,
                                   err_msg=n)
    assert opt.count == 1


def test_train_trajectory_matches_jax_over_three_steps(one_step):
    """Three steps of the port's ``train_step`` against JAX's from the
    same weights, each step with JAX's draws for it: the momentum trace
    carried across steps, the learning rate at each update count and the
    per-step sampling keys.  Losses within 1e-4 relative, as for one step,
    and parameters within 2e-5 of each leaf's largest value after the third
    step (one step's bar is 1e-5 relative per element; three steps compound
    the differences of the f32 sums, which torch and XLA take in other
    orders).  The loss falls over the three steps on this batch."""
    j, p = one_step["jax"], one_step["port"]
    model = copy.deepcopy(p["pristine"])
    opt = ttrain.make_optimizer(p["cfg"], model, ttrain.make_lr_schedule(p["cfg"], 10))
    port_state = ttrain.create_train_state(model, opt)
    state = create_train_state(j["params"], j["tx"])
    losses = []
    for k in range(3):
        state, j_aux = j["step"](state, j["batch"], j["rng"])
        _, aux = ttrain.train_step(port_state, p["batch"], 0, draws=j["draws_of"](k))
        loss = aux["loss"]
        np.testing.assert_allclose(float(loss), float(j_aux["loss"]), rtol=1e-4, err_msg=f"step {k}")
        losses.append(float(loss))
        for name in ("num_fg_rois", "num_valid_props", "num_fg_anchors"):
            assert int(aux[name]) == int(j_aux[name]), (k, name)
    assert opt.count == 3 and losses[0] > losses[1] > losses[2]
    got = dict(_leaves(torch_to_flax(model)))
    for path, ref in _leaves(jax.tree.map(np.asarray, state.params)):
        scale = float(np.abs(ref).max())
        assert float(np.abs(got[path] - ref).max()) <= 2e-5 * scale + 1e-7, "/".join(path)


def test_cli_refuses_data_parallel_cpu_runs(tmp_path):
    from mx_rcnn_tpu_torch.tools import train_end2end as cli
    with pytest.raises(NotImplementedError, match="data-parallel"):
        cli.train_net(cli.parse_args(["--cpu", "2", "--synthetic", "2",
                                      "--prefix", str(tmp_path / "e2e")]))


def test_fit_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(torch.nn.Linear(1, 1), port_cfg(train_cfg()), [], epochs=1)


def test_fit_trains_from_bridged_params_on_the_cpu():
    """``fit`` loads a Flax tree, runs the loader → step → metrics loop on
    the CPU and leaves the frozen tensors as the tree had them."""
    cfg = port_cfg(train_cfg())
    cfg = cfg.replace(dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
                      SHAPE_BUCKETS=((96, 128), (128, 96)))
    params_np = torch_to_flax(FasterRCNN(cfg, generator=torch.Generator().manual_seed(5)))
    model = FasterRCNN(cfg)
    roidb = SyntheticDataset(num_images=3, image_size=(160, 200)).gt_roidb()
    out = fit(model, cfg, roidb, epochs=2, max_steps=2, device="cpu", init_params=params_np)
    assert out["steps"] == 2 and len(out["history"]) == 2
    for h in out["history"]:
        assert set(h) >= {"loss", "RPNAcc", "RCNNL1Loss", "num_fg_rois", "step_ms", "wait_ms"}
        assert np.isfinite(h["loss"])
    got = dict(_leaves(torch_to_flax(model)))
    for path, a in _leaves(params_np):
        if ttrain.is_frozen_path(path, cfg.network.FIXED_PARAMS):
            np.testing.assert_array_equal(got[path], a, err_msg="/".join(path))
