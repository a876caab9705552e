"""``FOLD_BN`` in the PyTorch port on the CPU: the folded conv → frozen-BN
graph against the port's unfolded graph and against the JAX package's
``fused_conv_bn`` at float32 (JAX's own exact-rewrite test,
``tests/test_model.py::test_fold_bn_exact_rewrite``: ResNet-50 on a 64 × 96
image with its BN randomized, outputs within rtol 2e-3 / atol 1e-4, gradients
within 5e-3 of the leaf's largest), the ``state_dict`` keys with the fold on
and off, the parameter bridge with the fold on, the fold's cache, and every
model building and serving in each (compute dtype, fold) combination."""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mx_rcnn_tpu.models.resnet import ResNetBackbone as JBackbone
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.models import faster_rcnn as tfr
from mx_rcnn_tpu_torch.models import fpn as tfpn
from mx_rcnn_tpu_torch.models import stage_models as tsm
from mx_rcnn_tpu_torch.models.layers import ConvBNFolder, FrozenBatchNorm
from mx_rcnn_tpu_torch.models.resnet import ResNetBackbone
from mx_rcnn_tpu_torch.models.stage_models import FastRCNN, RPNOnly
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, grads_to_flax, torch_to_flax
from tests.test_fpn import fpn_cfg
from tests.test_model import tiny_cfg
from tests.test_torch_model import port_cfg

torch.set_num_threads(2)

# JAX's exact-rewrite bars (tests/test_model.py:380-389)
OUT_RTOL, OUT_ATOL, GRAD_REL = 2e-3, 1e-4, 5e-3


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def randomized():
    """(input, the JAX backbone's params with every leaf moved by N(0,
    0.05) as JAX's test does, the output of JAX's folded backbone and the
    gradients of its sum)."""
    x = np.random.RandomState(0).rand(1, 64, 96, 3).astype(np.float32)
    a = JBackbone(depth=50, dtype=jnp.float32)
    b = JBackbone(depth=50, dtype=jnp.float32, fold_bn=True)
    pa = a.init(jax.random.key(0), jnp.asarray(x))["params"]
    flat, key, out = flatten_dict(pa), jax.random.key(7), {}
    for k, v in flat.items():
        key, sk = jax.random.split(key)
        n = 0.05 * jax.random.normal(sk, v.shape)
        out[k] = jnp.abs(v + n) + 0.5 if k[-1] == "var" else v + n
    pa = unflatten_dict(out)
    yb, vjp = jax.vjp(lambda p: b.apply({"params": p}, jnp.asarray(x)), pa)
    (gb,) = vjp(jnp.ones_like(yb))
    return x, jax.tree.map(np.asarray, pa), np.asarray(yb), jax.tree.map(np.asarray, gb)


def _port_backbone(params, fold):
    model = flax_to_torch({"backbone": params}, _Holder(fold))
    return model.backbone


class _Holder(torch.nn.Module):
    def __init__(self, fold):
        super().__init__()
        self.backbone = ResNetBackbone(50, fold_bn=fold)


def _forward_and_grads(backbone, x):
    for p in backbone.parameters():
        p.grad = None
    y = backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    y.sum().backward()
    grads = {n: p.grad.clone() for n, p in backbone.named_parameters()}
    return y.detach().permute(0, 2, 3, 1).numpy(), grads


def test_fold_is_an_exact_rewrite_of_the_unfolded_graph(randomized):
    """The port's folded backbone against its unfolded one, at JAX's bars:
    outputs within rtol 2e-3 / atol 1e-4, each kernel's gradient within
    5e-3 of its largest."""
    x, params, *_ = randomized
    y0, g0 = _forward_and_grads(_port_backbone(params, False), x)
    y1, g1 = _forward_and_grads(_port_backbone(params, True), x)
    np.testing.assert_allclose(y1, y0, rtol=OUT_RTOL, atol=OUT_ATOL)
    assert set(g0) == set(g1)
    for n in g0:
        rel = float((g1[n] - g0[n]).abs().max() / (g0[n].abs().max() + 1e-6))
        assert rel < GRAD_REL, (n, rel)


def test_fold_matches_jaxs_fused_conv_bn(randomized):
    """The port's folded backbone against JAX's ``fused_conv_bn`` backbone on
    the same params: outputs at rtol 2e-3 / atol 1e-4, every kernel's
    gradient within 5e-3 of its largest."""
    x, params, yb, gb = randomized
    y, g = _forward_and_grads(_port_backbone(params, True), x)
    np.testing.assert_allclose(y, yb, rtol=OUT_RTOL, atol=OUT_ATOL)
    holder = _Holder(True)
    for n, p in holder.backbone.named_parameters():
        p.grad = g[n]
    got = dict(_leaves(grads_to_flax(holder)["backbone"]))
    ref = dict(_leaves(gb))
    assert set(got) <= set(ref) and all(p[-1] == "kernel" for p in got)
    for path in got:
        rel = float(np.abs(got[path] - ref[path]).max() / (np.abs(ref[path]).max() + 1e-6))
        assert rel < GRAD_REL, ("/".join(path), rel)


def _cfgs():
    c4 = tiny_cfg()
    fpn = fpn_cfg()
    mask = fpn.replace(network=dataclasses.replace(fpn.network, USE_MASK=True))
    return {"c4": (c4, None), "fpn": (fpn, None), "mask": (mask, None),
            "rpn_only": (c4, RPNOnly), "fast_rcnn": (c4, FastRCNN)}


KINDS = list(_cfgs())
COMBOS = [("float32", False), ("float32", True), ("bfloat16", False), ("bfloat16", True)]


def _build(kind, dtype="float32", fold=False, seeded=True):
    """The kind's model in a (COMPUTE_DTYPE, FOLD_BN) combination; without
    ``seeded`` its Flax-style random init is skipped (it takes seconds at
    ResNet-50 and the tests below load or ignore the values)."""
    jcfg, cls = _cfgs()[kind]
    cfg = port_cfg(jcfg)
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, COMPUTE_DTYPE=dtype, FOLD_BN=fold))
    gen = torch.Generator().manual_seed(0)
    init = tfr.init_weights if seeded else (lambda *a: None)
    with mock.patch.object(tfr, "init_weights", init), \
            mock.patch.object(tfpn, "init_weights", init), \
            mock.patch.object(tsm, "init_weights", init):
        return cfg, (build_model(cfg, gen) if cls is None else cls(cfg, gen))


@functools.lru_cache(maxsize=None)
def _combo(kind, dtype, fold):
    return _build(kind, dtype, fold, seeded=False)[1].eval()


@pytest.mark.parametrize("kind", KINDS)
def test_state_dict_is_the_same_with_the_fold_on_and_off(kind):
    """The same ``state_dict`` keys and shapes, every tensor float32, in each
    (dtype, fold) combination: the fold and the compute dtype change no
    tensor of the tree."""
    want = _combo(kind, "float32", False).state_dict()
    for dtype, fold in COMBOS:
        got = _combo(kind, dtype, fold).state_dict()
        assert list(got) == list(want), (dtype, fold)
        for k in want:
            assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape, k


def test_seeded_init_is_the_same_with_the_fold_and_bf16_on():
    """The seeded init draws the same values whatever the dtype and fold."""
    want = _build("c4")[1].state_dict()
    got = _build("c4", "bfloat16", True)[1].state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_bridge_round_trip_with_the_fold_on():
    """``flax_to_torch`` / ``torch_to_flax`` are independent of the fold: a
    folded model's Flax tree round-trips exactly, and loads into JAX's
    folded backbone, whose output the port's folded backbone matches at the
    exact-rewrite bars."""
    _, model = _build("c4", fold=True, seeded=False)
    model.load_state_dict(_combo("c4", "float32", False).state_dict())
    tree = torch_to_flax(model)
    other = _build("c4", "bfloat16", True, seeded=False)[1]
    back = torch_to_flax(flax_to_torch(tree, other))
    a, b = dict(_leaves(tree)), dict(_leaves(back))
    assert set(a) == set(b)
    for path in a:
        np.testing.assert_array_equal(a[path], b[path], err_msg="/".join(path))
    x = np.random.RandomState(3).rand(1, 64, 64, 3).astype(np.float32)
    ref = JBackbone(depth=50, fold_bn=True).apply({"params": tree["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=OUT_RTOL, atol=OUT_ATOL)


def test_the_fold_is_cached_and_refolded_when_a_tensor_changes():
    """Outside autograd the fold runs once and is kept; writing a kernel or a
    BN buffer in place, or replacing one, refolds that model's pairs; a
    kernel that takes a gradient is folded anew in every forward, into the
    graph."""
    _, model = _build("c4", "bfloat16", True, seeded=False)
    backbone = model.backbone
    folder = backbone._folder
    assert isinstance(folder, ConvBNFolder) and len(folder.pairs) == 1 + 3 * 3 + 4 * 3 + 6 * 3 + 3
    x = torch.rand(1, 3, 64, 64)
    with torch.no_grad():
        first = folder.fold()
        again = folder.fold()
        assert all(again[c][0] is first[c][0] for c, _ in folder.pairs)
        conv0, bn0 = folder.pairs[0]
        bn0.var.mul_(2.0)
        refolded = folder.fold()
        assert refolded[conv0][0] is not first[conv0][0]
        assert refolded[folder.pairs[1][0]][0] is first[folder.pairs[1][0]][0]
        w, add = refolded[conv0]
        assert w.dtype == add.dtype == torch.bfloat16
        mul = bn0.scale * torch.rsqrt(bn0.var + bn0.eps)
        torch.testing.assert_close(w.float(), (conv0.weight * mul[:, None, None, None])
                                   .bfloat16().float(), rtol=0, atol=0)
        y0 = backbone(x)
    conv0.weight.requires_grad_(True)
    y1 = backbone(x)
    y1.float().sum().backward()
    assert conv0.weight.grad is not None and conv0.weight.grad.dtype == torch.float32
    np.testing.assert_array_equal(y0.float().numpy(), y1.detach().float().numpy())
    assert folder.fold()[conv0][0] is not folder.fold()[conv0][0]


def test_every_frozen_bn_is_folded_and_unused():
    """With the fold on no FrozenBatchNorm module runs: the conv reads the
    folded pair."""
    model = _combo("mask", "float32", True)
    calls = []
    hooks = [m.register_forward_hook(lambda *a: calls.append(1)) for m in model.modules()
             if isinstance(m, FrozenBatchNorm)]
    try:
        with torch.no_grad():
            model(torch.rand(1, 128, 128, 3), torch.tensor([[128.0, 128.0, 1.0]]))
    finally:
        for h in hooks:
            h.remove()
    assert hooks and not calls


@pytest.mark.parametrize("dtype,fold", COMBOS[1:])
@pytest.mark.parametrize("kind", KINDS)
def test_every_model_serves_in_each_combination(kind, dtype, fold):
    """FasterRCNN, FPN (box and mask), RPNOnly and FastRCNN build and run a
    test forward in each (COMPUTE_DTYPE, FOLD_BN) combination, on the float32
    graph's weights: float32 outputs of its shapes, finite."""
    ref_model, model = _combo(kind, "float32", False), _combo(kind, dtype, fold)
    model.load_state_dict(ref_model.state_dict())
    rng = np.random.RandomState(4)
    images = torch.from_numpy((rng.rand(1, 128, 128, 3) * 255).astype(np.uint8))
    im_info = torch.tensor([[128.0, 128.0, 1.0]])
    extra = {}
    if kind == "fast_rcnn":
        extra = {"proposals": torch.tensor([[[10.0, 10.0, 70.0, 70.0], [40.0, 30.0, 120.0, 100.0]]]),
                 "prop_valid": torch.tensor([[True, True]])}
    with torch.no_grad():
        ref = ref_model(images, im_info, **extra)
        out = model(images, im_info, **extra)
    assert set(out) == set(ref)
    for k, v in out.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k
        if v.dtype.is_floating_point:
            assert v.dtype == torch.float32 and torch.isfinite(v).all(), k
