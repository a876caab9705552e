"""FPN's frozen-proposal training in the PyTorch port on the CPU against the
JAX package: one box step and one Mask R-CNN step whose RCNN and mask
branches sample from the batch's ``proposals`` / ``prop_valid`` instead of
the RPN's, with JAX's draws injected (losses and aux, sampled rois, every
gradient, the updated parameters), with the proposal NMS never called; and
``fit(proposal_count=)`` driving the frozen mode from a proposal roidb.
Sizes of ``tests/test_fpn.py::fpn_cfg`` (ResNet-50 FPN, 128 × 128)."""

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
from mx_rcnn_tpu.models.fpn import FPNFasterRCNN as JFPNFasterRCNN
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.models import faster_rcnn as tfr
from mx_rcnn_tpu_torch.models import fpn as tfpn
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, grads_to_flax, torch_to_flax
from mx_rcnn_tpu_torch.utils.load_data import attach_proposals
from tests.test_fpn import fpn_batch, fpn_cfg
from tests.test_torch_mask_train import _anchor_count, gt_masks_for
from tests.test_torch_model import _perturb, _tame_rpn, port_cfg

torch.set_num_threads(2)

PROPOSALS = 48


def T(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def frozen_proposals(rng, gt, n=PROPOSALS, h=128, w=128):
    """(n, 4) proposals: jittered copies of the two gt boxes, random boxes,
    one inverted and one past the image."""
    rows = []
    for k in range(n):
        if k < n // 2:
            box = gt[k % 2, :4] + rng.randn(4) * 5
        else:
            x1, y1 = rng.rand() * (w - 40), rng.rand() * (h - 40)
            box = [x1, y1, x1 + 8 + rng.rand() * 60, y1 + 8 + rng.rand() * 60]
        rows.append(np.clip(box, 0, [w - 1, h - 1, w - 1, h - 1]))
    rows[-2] = [60.0, 60.0, 50.0, 52.0]
    rows[-1] = [90.0, 80.0, 127.0, 127.0]
    return np.asarray(rows, np.float32)


# half-width of the band around a ReLU's kink that no mask-head
# pre-activation may sit in, as a fraction of its layer's largest
# |pre-activation|: the two packages' float32 forwards of these pre-
# activations differ by at most ~3e-6 of it on this step's data
KINK_BAND = 1e-4
MASK_RELU_LAYERS = ("mask_conv1", "mask_conv2", "mask_conv3", "mask_conv4", "mask_deconv")


@torch.no_grad()
def _clear_mask_head_kinks(model, mask_input):
    """Move the bias of every mask-head channel that has a pre-activation
    within ``KINK_BAND`` of its ReLU's kink, on this step's pooled rois
    ``mask_input``, by the least amount that puts the nearest gap of its
    values around 0: across ~1.6 M pre-activations a few land within
    float32 rounding of 0, where the two packages' forwards can take
    opposite sides, and each gradient is then exact for its own forward but
    the two differ by ~4e-3 of their largest.  Every other weight stays as
    it was.  The role of ``_tame_rpn`` for the RPN's rounding.  Returns
    {layer: (channels moved, largest move / the layer's largest
    |pre-activation|)}."""
    head, x, moved = model.mask_head, mask_input, {}
    for name in MASK_RELU_LAYERS:
        layer = getattr(head, name)
        pre = layer(x)
        scale = float(pre.abs().max())
        band = KINK_BAND * scale
        vals = pre.transpose(0, 1).reshape(pre.shape[1], -1).double()
        near = (vals.abs() < band).any(dim=1).nonzero().flatten().tolist()
        shifts = []
        for c in near:
            v = vals[c].sort().values
            v = torch.cat([v.new_tensor([-1e30]), v, v.new_tensor([1e30])])
            mids, wide = (v[1:] + v[:-1]) / 2, (v[1:] - v[:-1]) > 4 * band
            shift = -mids[wide][mids[wide].abs().argmin()]
            layer.bias[c] += shift.float()
            shifts.append(abs(float(shift)))
        moved[name] = (len(near), max(shifts, default=0.0) / scale)
        pre = layer(x)
        assert not (pre.abs() < band).any(), name
        x = torch.relu(pre)
    return moved


@pytest.fixture
def no_proposal_nms(monkeypatch):
    """Frozen mode must run no proposal NMS: both entries raise."""
    def refuse(*a, **k):
        raise AssertionError("the frozen-proposal step ran a proposal NMS")

    monkeypatch.setattr(tfpn, "nms", refuse)
    monkeypatch.setattr(tfpn.FPNFasterRCNN, "_propose_multilevel", staticmethod(refuse))


@pytest.fixture(scope="module", params=["box", "mask"])
def frozen_step(request):
    """One JAX frozen-proposal step (value_and_grad, then its optax update)
    and one port step from the same weights and batch, with JAX's draws
    (its key split per image seed, then per sampler) injected into the port,
    the proposal NMS patched to raise."""
    jcfg = fpn_cfg()
    if request.param == "mask":
        jcfg = jcfg.replace(network=dataclasses.replace(jcfg.network, USE_MASK=True))
    tcfg = port_cfg(jcfg)
    model = build_model(tcfg, generator=torch.Generator().manual_seed(0))
    params_np = _tame_rpn(_perturb(torch_to_flax(model), np.random.RandomState(1)))
    flax_to_torch(params_np, model)
    batch = {k: np.array(v) for k, v in fpn_batch(np.random.RandomState(1)).items()}
    batch["sample_seeds"] = np.asarray([0], np.int32)
    batch["proposals"] = frozen_proposals(np.random.RandomState(2), batch["gt_boxes"][0])[None]
    batch["prop_valid"] = np.ones((1, PROPOSALS), bool)
    batch["prop_valid"][0, -5:] = False
    if request.param == "mask":
        batch["gt_masks"] = gt_masks_for(batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JFPNFasterRCNN(jcfg)
    step_key = jax.random.fold_in(jax.random.key(7), 0)
    key = jmodel.apply({"params": jax.tree.map(jnp.asarray, params_np)},
                       method=lambda m: m.make_rng("sampling"), rngs={"sampling": step_key})
    n_anchors = _anchor_count(jcfg, 128, 128)
    n_cand = PROPOSALS + batch["gt_boxes"].shape[1]
    k_anchor, k_roi = jax.random.split(jax.random.fold_in(key, 0), 2)
    u = [jax.random.uniform(k, (n_anchors,)) for k in jax.random.split(k_anchor)]
    u += [jax.random.uniform(k, (n_cand,)) for k in jax.random.split(k_roi, 3)]
    draws = {name: T(np.asarray(x))[None] for name, x in zip(tfr.DRAW_NAMES, u)}
    tb = {k: T(v) for k, v in batch.items() if k != "sample_seeds"}
    moved = None
    if request.param == "mask":
        seen = []
        hook = model.mask_head.register_forward_pre_hook(lambda m, a: seen.append(a[0].detach()))
        with torch.no_grad():
            model(tb["images"], tb["im_info"], tb["gt_boxes"], tb["gt_valid"], train=True,
                  draws=draws, gt_masks=tb["gt_masks"], proposals=tb["proposals"],
                  prop_valid=tb["prop_valid"])
        hook.remove()
        moved = _clear_mask_head_kinks(model, seen[0])
        params_np = torch_to_flax(model)
    params = jax.tree.map(jnp.asarray, params_np)

    def loss_fn(p):
        return jmodel.apply({"params": p}, train=True, rngs={"sampling": step_key}, **jb)

    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = j_make_optimizer(jcfg, j_make_lr_schedule(jcfg, 10))
    j_new = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        j_grads, params)

    def refuse(*a, **k):
        raise AssertionError("the frozen-proposal step ran a proposal NMS")

    pristine = copy.deepcopy(model)
    captured = {}
    orig = (tfpn.sample_rois, tfpn.nms, tfpn.FPNFasterRCNN._propose_multilevel)
    tfpn.sample_rois = lambda *a, **k: captured.setdefault("rois", orig[0](*a, **k))
    tfpn.nms, tfpn.FPNFasterRCNN._propose_multilevel = refuse, staticmethod(refuse)
    try:
        opt = ttrain.make_optimizer(tcfg, model, ttrain.make_lr_schedule(tcfg, 10))
        opt.zero_grad()
        t_loss, t_aux = model(tb["images"], tb["im_info"], tb["gt_boxes"], tb["gt_valid"],
                              train=True, draws=draws, gt_masks=tb.get("gt_masks"),
                              proposals=tb["proposals"], prop_valid=tb["prop_valid"])
        t_loss.backward()
        t_grads = grads_to_flax(model)
        opt.step()
    finally:
        tfpn.sample_rois = orig[0]
        tfpn.nms, tfpn.FPNFasterRCNN._propose_multilevel = orig[1], staticmethod(orig[2])
    return {
        "kind": request.param, "batch": batch,
        "jax": dict(loss=j_loss, aux=j_aux, grads=j_grads, params=params, new_params=j_new),
        "port": dict(loss=t_loss.detach(), aux={k: v.detach() for k, v in t_aux.items()},
                     grads=t_grads, model=model, pristine=pristine, cfg=tcfg,
                     samples=captured["rois"], draws=draws, moved=moved),
    }


def test_frozen_step_samples_from_the_given_proposals(frozen_step):
    """Every sampled roi is a valid given proposal or a gt box (scaled
    canvas coordinates, as the batch holds them), and the step counts the
    given proposals' validity."""
    b, p = frozen_step["batch"], frozen_step["port"]
    rois = p["samples"].rois[0].numpy()
    pool = np.concatenate([b["proposals"][0][b["prop_valid"][0]], b["gt_boxes"][0, :2, :4]])
    assert all(np.abs(pool - r).sum(1).min() == 0 for r in rois)
    assert int(p["aux"]["num_valid_props"]) == int(b["prop_valid"].sum()) == PROPOSALS - 5


def test_frozen_step_losses_and_aux_match(frozen_step):
    """The total loss and every aux within 1e-4 relative (``MaskBCELoss``
    too); the counts equal and live."""
    j, p = frozen_step["jax"], frozen_step["port"]
    assert set(p["aux"]) == set(j["aux"])
    assert ("MaskBCELoss" in p["aux"]) == (frozen_step["kind"] == "mask")
    np.testing.assert_allclose(float(p["loss"]), float(j["loss"]), rtol=1e-4)
    for k, v in p["aux"].items():
        np.testing.assert_allclose(float(v), float(j["aux"][k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("num_fg_rois", "num_valid_props", "num_fg_anchors"):
        assert int(p["aux"][k]) == int(j["aux"][k]) > 0


def test_frozen_step_gradients_match(frozen_step):
    """Every trainable leaf's gradient within 2e-3 of the leaf's largest
    (and 1e-6 absolute): the RPN's from its own losses, the heads' and the
    neck's through the ROIAlign backward of the given proposals."""
    j, p = frozen_step["jax"], frozen_step["port"]
    got = dict(_leaves(p["grads"]))
    ref = dict(_leaves(jax.tree.map(np.asarray, j["grads"])))
    trainable = {path for path in ref
                 if not ttrain.is_frozen_path(path, p["cfg"].network.FIXED_PARAMS)}
    assert set(got) == trainable
    assert {"rpn", "neck", "top_head", "rcnn"} <= {path[0] for path in got}
    for path in trainable:
        scale = float(np.abs(ref[path]).max())
        err = float(np.abs(got[path] - ref[path]).max())
        assert err <= 2e-3 * scale + 1e-6, ("/".join(path), err, scale)


def test_frozen_step_updated_params_match(frozen_step):
    """After one MXNet SGD step: trainable leaves within 1e-5 relative of
    JAX's, frozen leaves unchanged on both sides."""
    j, p = frozen_step["jax"], frozen_step["port"]
    got = dict(_leaves(torch_to_flax(p["model"])))
    new = dict(_leaves(jax.tree.map(np.asarray, j["new_params"])))
    old = dict(_leaves(jax.tree.map(np.asarray, j["params"])))
    pristine = dict(_leaves(torch_to_flax(p["pristine"])))
    frozen = {path for path in new if ttrain.is_frozen_path(path, p["cfg"].network.FIXED_PARAMS)}
    for path in new:
        if path in frozen:
            np.testing.assert_array_equal(new[path], old[path])
            np.testing.assert_array_equal(got[path], pristine[path])
        else:
            np.testing.assert_allclose(got[path], new[path], rtol=1e-5, atol=1e-7,
                                       err_msg="/".join(path))


def test_frozen_mode_needs_prop_valid():
    cfg = port_cfg(fpn_cfg())
    model = build_model(cfg)
    b = {k: T(v) for k, v in fpn_batch(np.random.RandomState(0)).items()}
    with pytest.raises(ValueError, match="prop_valid"):
        model(b["images"], b["im_info"], b["gt_boxes"], b["gt_valid"], train=True,
              proposals=torch.zeros((1, 4, 4)))


def test_fit_trains_the_frozen_mode_from_a_proposal_roidb(no_proposal_nms):
    """``fit(proposal_count=)`` on a flipped proposal roidb: the loader's
    batches carry the proposals, the step samples from them and runs no
    proposal NMS, and the losses are finite."""
    cfg = port_cfg(fpn_cfg())
    roidb = SyntheticDataset(num_images=2, num_classes=4, image_size=(128, 128),
                             max_boxes=2).gt_roidb()
    rng = np.random.RandomState(3)
    props = [np.hstack([frozen_proposals(rng, np.resize(r["boxes"], (2, 4)), n=20),
                        np.ones((20, 1), np.float32)]) for r in roidb]
    roidb = IMDB.append_flipped_images(attach_proposals(roidb, props))
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    flax_to_torch(_tame_rpn(torch_to_flax(model)), model)
    out = fit(model, cfg, roidb, epochs=1, max_steps=2, device="cpu", prefetch=0,
              proposal_count=cfg.TRAIN.RPN_POST_NMS_TOP_N)
    assert out["steps"] == 2
    for h in out["history"]:
        assert np.isfinite(h["loss"]) and h["num_valid_props"] == 20
