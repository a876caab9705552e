"""The bfloat16 compute dtype of the PyTorch port on the CPU against the JAX
package's bfloat16 graph (``COMPUTE_DTYPE="bfloat16"``, float32 parameters):
the backbone (folded and not), the RPN, the heads and the FPN neck; the
plain ROIAlign versions in bfloat16 against the Pallas kernels in interpret
mode and the float32 gather path, with their one rounding and their
float32 backward; the routing of bfloat16 maps; the kernel wrappers, which
convert no dtype; one Fast R-CNN and one Mask R-CNN bfloat16 train step
with the fold on against JAX's, on injected draws and fixed proposals;
``train_end2end --compute_dtype bfloat16``; and TF32 off at every entry
point.

Tolerances: XLA's CPU and oneDNN round bfloat16 at different places (XLA
keeps excess precision inside a fusion), so two bfloat16 graphs of the same
weights differ by a few bfloat16 ulps (2^-8 relative) of each output, which
depth carries on; the bars are relative to the largest output, at the
JAX package's bfloat16 ROIAlign bar, 0.05 (``tests/test_pallas_roi_align.py``).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.models.fpn import FPNFasterRCNN as JFPNFasterRCNN
from mx_rcnn_tpu.models.fpn import FPNNeck as JFPNNeck
from mx_rcnn_tpu.models.fpn import FPNTopHead as JFPNTopHead
from mx_rcnn_tpu.models.heads import MaskHead as JMaskHead
from mx_rcnn_tpu.models.heads import RCNNHead as JRCNNHead
from mx_rcnn_tpu.models.resnet import ResNetBackbone as JBackbone
from mx_rcnn_tpu.models.rpn import RPNHead as JRPNHead
from mx_rcnn_tpu.models.stage_models import FastRCNN as JFastRCNN
from mx_rcnn_tpu.ops.pallas.roi_align import roi_align_pallas as j_roi_align_pallas
from mx_rcnn_tpu.ops.pallas.roi_align_stream import roi_align_stream as j_roi_align_stream
from mx_rcnn_tpu.ops.roi_align import roi_align as j_roi_align
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.tester import Predictor
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.models import faster_rcnn as tfr
from mx_rcnn_tpu_torch.models import fpn as tfpn
from mx_rcnn_tpu_torch.models import stage_models as tsm
from mx_rcnn_tpu_torch.models.heads import MaskHead, RCNNHead
from mx_rcnn_tpu_torch.models.resnet import ResNetBackbone
from mx_rcnn_tpu_torch.models.rpn import RPNHead
from mx_rcnn_tpu_torch.ops import nms as tnms
from mx_rcnn_tpu_torch.ops import roi_align as troi
from mx_rcnn_tpu_torch.ops import roi_align_stream as tstream
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, grads_to_flax, torch_to_flax
from mx_rcnn_tpu_torch.utils.cuda_build import kernel_input
from tests.test_alternate import tiny_alt_cfg
from tests.test_fpn import fpn_batch, fpn_cfg
from tests.test_pallas_roi_align import random_rois
from tests.test_torch_alternate import proposal_batch
from tests.test_torch_frozen import PROPOSALS, frozen_proposals
from tests.test_torch_mask_train import _anchor_count, gt_masks_for
from tests.test_torch_model import _perturb, _tame_rpn, port_cfg, uint8_batch

torch.set_num_threads(2)

# relative to the largest output: a few bf16 ulps through the depth
BF16_TOL = 0.05
# one bf16 ulp of x: 2^(exponent - 7)
BF16_EPS = 2.0 ** -7


def T(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def bf16(cfg, fold=True):
    """``cfg`` (either package's) with the bf16 compute dtype and FOLD_BN."""
    return cfg.replace(network=dataclasses.replace(cfg.network, COMPUTE_DTYPE="bfloat16",
                                                   FOLD_BN=fold))


def rel_max(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


class _Holder(torch.nn.Module):
    """Port modules under the Flax tree's names, for the bridge."""

    def __init__(self, **mods):
        super().__init__()
        for k, m in mods.items():
            self.add_module(k, m)


# ------------------------------------------------------------ the modules
@pytest.fixture(scope="module")
def backbone_params():
    """A seeded ResNet-50's Flax tree with its BN moments and affines
    randomized (``_perturb``)."""
    holder = _Holder(backbone=ResNetBackbone(50))
    tfr.init_weights(holder, torch.Generator().manual_seed(0))
    return _perturb(torch_to_flax(holder), np.random.RandomState(1))["backbone"]


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
def test_bf16_backbone_matches_jax(backbone_params, fold):
    """ResNet-50 (C4) in bf16, folded and not, on a 64 × 96 image: bf16
    out, within BF16_TOL of JAX's bf16 backbone's largest output."""
    x = np.random.RandomState(0).rand(1, 64, 96, 3).astype(np.float32)
    ref = jax.jit(lambda p, v: JBackbone(depth=50, dtype=jnp.bfloat16, fold_bn=fold).apply(
        {"params": p}, v))(backbone_params, jnp.asarray(x))
    holder = flax_to_torch({"backbone": backbone_params},
                           _Holder(backbone=ResNetBackbone(50, dtype=torch.bfloat16,
                                                           fold_bn=fold)))
    with torch.no_grad():
        got = holder.backbone(T(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert rel_max(got.float().permute(0, 2, 3, 1), ref) < BF16_TOL


def _flax(module, x, seed=0):
    params = module.init(jax.random.key(seed), jnp.asarray(x))["params"]
    return jax.tree.map(np.asarray, params)


def test_bf16_rpn_and_rcnn_heads_match_jax(rng):
    """The RPN and the RCNN head compute in bf16 and return float32, as
    JAX's: within BF16_TOL of JAX's largest output."""
    feat = rng.randn(2, 6, 8, 64).astype(np.float32)
    jrpn = JRPNHead(num_anchors=9, channels=32, dtype=jnp.bfloat16)
    p = _flax(jrpn, feat)
    jl, jd = jrpn.apply({"params": p}, jnp.asarray(feat))
    rpn = flax_to_torch({"rpn": p}, _Holder(rpn=RPNHead(64, 9, 32, torch.bfloat16))).rpn
    with torch.no_grad():
        tl, td = rpn(T(feat).permute(0, 3, 1, 2))
    assert tl.dtype == td.dtype == torch.float32 and jl.dtype == jnp.float32
    assert rel_max(tl, jl) < BF16_TOL and rel_max(td, jd) < BF16_TOL
    trunk = rng.randn(12, 48).astype(np.float32)
    jhead = JRCNNHead(num_classes=5, dtype=jnp.bfloat16)
    p = _flax(jhead, trunk)
    jc, jb = jhead.apply({"params": p}, jnp.asarray(trunk))
    head = flax_to_torch({"rcnn": p}, _Holder(rcnn=RCNNHead(48, 5, torch.bfloat16))).rcnn
    with torch.no_grad():
        tc, tb = head(T(trunk))
    assert tc.dtype == tb.dtype == torch.float32
    assert rel_max(tc, jc) < BF16_TOL and rel_max(tb, jb) < BF16_TOL


def test_bf16_mask_head_and_fpn_match_jax(rng):
    """The mask head (flipped transposed-conv kernel kept), the FPN neck and
    the 2-fc head in bf16 against JAX's bf16 modules; the mask logits come
    out float32, the neck's maps and the 2-fc features bf16."""
    x = rng.randn(3, 14, 14, 16).astype(np.float32)
    jmask = JMaskHead(num_classes=5, channels=16, dtype=jnp.bfloat16)
    p = _flax(jmask, x)
    ref = jmask.apply({"params": p}, jnp.asarray(x))
    head = flax_to_torch({"mask_head": p}, _Holder(mask_head=MaskHead(16, 5, 16,
                                                                      torch.bfloat16))).mask_head
    with torch.no_grad():
        got = head(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32 and rel_max(got, ref) < BF16_TOL

    chans = (8, 16, 24, 32)
    feats = [rng.randn(1, 16 // 2 ** i, 20 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate(chans)]
    jneck = JFPNNeck(channels=16, dtype=jnp.bfloat16)
    pn = jax.tree.map(np.asarray, jneck.init(jax.random.key(1),
                                             tuple(jnp.asarray(f) for f in feats))["params"])
    jouts = jneck.apply({"params": pn}, tuple(jnp.asarray(f) for f in feats))
    neck = flax_to_torch({"neck": pn}, _Holder(neck=tfpn.FPNNeck(chans, 16, torch.bfloat16))).neck
    with torch.no_grad():
        outs = neck([T(f).permute(0, 3, 1, 2) for f in feats])
    for got, ref in zip(outs, jouts):
        assert got.dtype == torch.bfloat16
        assert rel_max(got.float().permute(0, 2, 3, 1), ref) < BF16_TOL

    rois = rng.randn(6, 7, 7, 16).astype(np.float32)
    jtop = JFPNTopHead(width=32, dtype=jnp.bfloat16)
    pt = _flax(jtop, rois)
    ref = jtop.apply({"params": pt}, jnp.asarray(rois))
    top = flax_to_torch({"top_head": pt},
                        _Holder(top_head=tfpn.FPNTopHead(7 * 7 * 16, 32, torch.bfloat16))).top_head
    with torch.no_grad():
        got = top(T(rois))
    assert got.dtype == torch.bfloat16 and rel_max(got.float(), ref) < BF16_TOL


# --------------------------------------------------------------- ROIAlign
def _roi_case(rng, b=1, h=10, w=12, c=128, r=6, stride=16):
    feat = rng.randn(b, h, w, c).astype(np.float32)
    rois = np.stack([random_rois(rng, r, h * stride, w * stride) for _ in range(b)])
    return feat, rois


@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_bf16_roi_align_plain_matches_the_pallas_kernel_and_the_gather_path(rng, pooled):
    """``roi_align_plain`` on a bf16 map: bf16 out, within 0.05 of JAX's
    bf16 Pallas kernel (interpret mode) and of the float32 gather path
    (``tests/test_pallas_roi_align.py``'s bars), and exactly the float32
    plain output on the same (bf16-valued) map rounded once to bf16."""
    feat, rois = _roi_case(rng)
    fb = torch.from_numpy(feat).bfloat16()
    got = troi.roi_align_plain(fb, T(rois), pooled, 1.0 / 16, 2)
    assert got.dtype == torch.bfloat16
    f32 = troi.roi_align_plain(fb.float(), T(rois), pooled, 1.0 / 16, 2)
    assert torch.equal(got, f32.bfloat16())
    kern = j_roi_align_pallas(jnp.asarray(feat).astype(jnp.bfloat16), jnp.asarray(rois),
                              pooled, 1.0 / 16, 2, True)
    gather = j_roi_align(jnp.asarray(feat[0]), jnp.asarray(rois[0]), pooled, 1.0 / 16, 2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(kern, np.float32),
                               rtol=0.05, atol=0.05)
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(gather), rtol=0.05, atol=0.05)


def test_bf16_roi_align_stream_plain_matches_the_pallas_kernel(rng):
    """``roi_align_stream_plain`` on a bf16 map: bf16 out, within 0.05 of
    JAX's bf16 streamed Pallas kernel (interpret mode), an inverted roi
    pooled to zeros, and the float32 output rounded once."""
    feat, rois = _roi_case(rng, b=2, h=24, w=32, r=6, stride=4)
    rois[1, 2] = [60.0, 20.0, 40.0, 50.0]                   # inverted
    fb = torch.from_numpy(feat).bfloat16()
    got = tstream.roi_align_stream_plain(fb, T(rois), (7, 7), 0.25, 2)
    assert got.dtype == torch.bfloat16 and not got[1, 2].any()
    assert torch.equal(got, tstream.roi_align_stream_plain(fb.float(), T(rois), (7, 7), 0.25,
                                                           2).bfloat16())
    ref = j_roi_align_stream(jnp.asarray(feat).astype(jnp.bfloat16), jnp.asarray(rois), (7, 7),
                             0.25, 2, True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0.05, atol=0.05)


def test_roi_align_plain_writes_into_a_map_of_the_features_dtype():
    """The plain forward allocates its output with ``feat.new_empty``: the
    feature's dtype and device."""
    out = troi.roi_align_plain(torch.zeros(1, 4, 4, 4, dtype=torch.bfloat16),
                               torch.tensor([[[0.0, 0.0, 30.0, 30.0]]]), (2, 2), 1.0 / 16, 2)
    assert out.dtype == torch.bfloat16


@pytest.fixture
def kernels_as_plain(monkeypatch):
    """The autograd Functions with their launchers routed to the plain
    versions, so the CPU drives the wrappers' dtype handling."""
    monkeypatch.setattr(troi, "_roi_align_cuda", lambda f, r, p, sc, s, v: troi.roi_align_plain(
        f, r, p, sc, s, v))
    monkeypatch.setattr(troi, "_roi_align_bwd_cuda", troi.roi_align_bwd_plain)
    monkeypatch.setattr(tstream, "_roi_align_stream_cuda", tstream.roi_align_stream_plain)
    monkeypatch.setattr(tstream, "_roi_align_stream_bwd_cuda", tstream.roi_align_stream_bwd_plain)


@pytest.mark.parametrize("route", ["resident", "stream"])
def test_bf16_backward_is_float32_then_cast(rng, kernels_as_plain, route):
    """Through the Functions: a bf16 map's pooled output is bf16 and its
    gradient bf16, equal to the float32 backward of the upcast cotangent
    rounded once; the float32 plain backward returns float32 for a bf16
    cotangent; and the plain version's own autograd gives a gradient within
    one bf16 ulp of it (its sums are float32 too)."""
    feat, rois = _roi_case(rng, h=24, w=32, r=6, stride=4)
    fb = torch.from_numpy(feat).bfloat16().requires_grad_()
    fn, plain_bwd, plain = {
        "resident": (lambda f: troi.RoIAlignFunction.apply(f, T(rois), (7, 7), 0.25, 2, None),
                     lambda g: troi.roi_align_bwd_plain(g, T(rois), fb.shape, (7, 7), 0.25, 2),
                     lambda f: troi.roi_align_plain(f, T(rois), (7, 7), 0.25, 2)),
        "stream": (lambda f: tstream.RoIAlignStreamFunction.apply(f, T(rois), (7, 7), 0.25, 2),
                   lambda g: tstream.roi_align_stream_bwd_plain(g, T(rois), fb.shape, (7, 7),
                                                                 0.25, 2),
                   lambda f: tstream.roi_align_stream_plain(f, T(rois), (7, 7), 0.25, 2)),
    }[route]
    out = fn(fb)
    assert out.dtype == torch.bfloat16
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).bfloat16()
    out.backward(g)
    dfeat = plain_bwd(g)
    assert fb.grad.dtype == torch.bfloat16 and dfeat.dtype == torch.float32
    assert torch.equal(fb.grad, dfeat.bfloat16())
    assert torch.equal(plain_bwd(g), plain_bwd(g.float()))
    f2 = fb.detach().clone().requires_grad_()
    plain(f2).backward(g)
    ulp = BF16_EPS * dfeat.abs().clamp_min(1e-30)
    assert ((f2.grad.float() - dfeat).abs() <= ulp + 1e-6).all()


def test_bf16_maps_route_as_float32_maps(monkeypatch):
    """``fits_vmem`` takes no dtype: at the 608 × 1024 canvas C4's map and
    FPN's P4/P5 stay resident and P2/P3 stream, in bf16 as in float32."""
    routes = []
    monkeypatch.setattr(troi, "roi_align", lambda f, *a: routes.append(("resident", f.dtype)))
    monkeypatch.setattr(tstream, "roi_align_stream",
                        lambda f, *a: routes.append(("stream", f.dtype)))
    rois = torch.zeros(1, 2, 4)
    cases = {(38, 64, 1024, 16): "resident", (152, 256, 256, 4): "stream",
             (76, 128, 256, 8): "stream", (38, 64, 256, 16): "resident",
             (19, 32, 256, 32): "resident"}
    for dtype in (torch.float32, torch.bfloat16):
        for (h, w, c, stride), want in cases.items():
            routes.clear()
            feat = torch.empty(1, h, w, c, dtype=dtype)
            troi.extract_roi_features_batched(feat, rois, "roi_align", (14, 14), 1.0 / stride)
            assert routes == [(want, dtype)], (h, w, c, dtype)


def test_kernel_wrappers_convert_no_dtype():
    """``kernel_input`` takes the dtypes a kernel was built for and raises on
    any other (before it looks at the device): a float16 map, float64 rois,
    a bf16 box tensor into the float32 NMS."""
    with pytest.raises(TypeError, match="float16"):
        kernel_input("feat", torch.zeros(1, 2, 2, 4, dtype=torch.float16),
                     tuple(troi.FWD_KERNELS), 4)
    with pytest.raises(TypeError, match="float64"):
        kernel_input("rois", torch.zeros(1, 1, 4, dtype=torch.float64), torch.float32, 3)
    with pytest.raises(TypeError, match="bfloat16"):
        tnms._nms_mask_sorted_cuda(torch.zeros(1, 4, 4, dtype=torch.bfloat16),
                                   torch.ones(1, 4, dtype=torch.bool), 0.5, 0)
    with pytest.raises(ValueError, match="CUDA"):
        kernel_input("feat", torch.zeros(1, 2, 2, 4, dtype=torch.bfloat16),
                     tuple(troi.FWD_KERNELS), 4)
    assert set(troi.FWD_KERNELS) == set(tstream.BWD_KERNELS) == {torch.float32, torch.bfloat16}
    assert len({id(k) for k in (*troi.FWD_KERNELS.values(), *troi.BWD_KERNELS.values(),
                                *tstream.FWD_KERNELS.values(),
                                *tstream.BWD_KERNELS.values())}) == 8


# --------------------------------------------------------- the train steps
def _grad_rel(got, ref, keys):
    """{group: ‖Δg‖ / ‖g‖ over the group's leaves among ``keys``} of two
    Flax gradient trees; a group is the tree's top level, the backbone's
    stage."""
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    num, den = {}, {}
    for p in keys:
        grp = "/".join(p[:2]) if p[0] == "backbone" else p[0]
        num[grp] = num.get(grp, 0.0) + float(np.sum((got[p] - ref[p]).astype(np.float64) ** 2))
        den[grp] = den.get(grp, 0.0) + float(np.sum(ref[p].astype(np.float64) ** 2))
    return {g: math.sqrt(num[g] / max(den[g], 1e-30)) for g in num}


def _jax_step(jmodel, params_np, batch):
    """JAX's (loss, aux, gradients) of one train step and its sampling key
    (from the step key that ``make_train_step`` folds for step 0)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(jnp.asarray, params_np)
    step_key = jax.random.fold_in(jax.random.key(7), 0)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, train=True, rngs={"sampling": step_key}, **jb),
        has_aux=True))(params)
    key = jmodel.apply({"params": params}, method=lambda m: m.make_rng("sampling"),
                       rngs={"sampling": step_key})
    return float(loss), {k: float(v) for k, v in aux.items()}, \
        jax.tree.map(np.asarray, grads), jax.random.fold_in(key, 0)


def _port_step(cfg, params_np, batch, draws, fold=False, dtype="float32"):
    """The port's (loss, aux, gradients, model, optimizer) of one step of
    ``cfg``'s model in ``dtype`` on the Flax weights, with ``draws``."""
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, COMPUTE_DTYPE=dtype,
                                                  FOLD_BN=fold))
    cls = tsm.FastRCNN if not cfg.network.USE_FPN else None
    gen = torch.Generator().manual_seed(0)
    model = flax_to_torch(params_np, cls(cfg, gen) if cls else build_model(cfg, gen))
    opt = ttrain.make_optimizer(cfg, model, ttrain.make_lr_schedule(cfg, 10))
    tb = {k: T(v) for k, v in batch.items() if k != "sample_seeds"}
    extra = {k: tb[k] for k in ("gt_masks", "proposals", "prop_valid") if k in tb}
    opt.zero_grad()
    loss, aux = model(tb["images"], tb["im_info"], tb["gt_boxes"], tb["gt_valid"], train=True,
                      draws=draws, **extra)
    loss.backward()
    return (float(loss.detach()), {k: float(v.detach()) for k, v in aux.items()},
            grads_to_flax(model), model, opt)


# the bf16 steps' bars.  The loss within 2e-2 relative of JAX's bf16 loss.
# The gradients: bf16 rounding alone moves a deep group's gradient by ~0.12
# of its norm from the float32 one (JAX's own bf16 step at these shapes), so
# each group's bf16 gradient must be as close to the float32 step's as
# JAX's bf16 gradient is (within 1.25x, plus 0.01), and within 0.25 of JAX's
# bf16 gradient itself
STEP_LOSS_TOL, NOISE_FACTOR, NOISE_FLOOR, STEP_GRAD_TOL = 2e-2, 1.25, 0.01, 0.25


def _hold_step(port16, port32, jax16, count):
    """The loss and fg count against JAX's bf16 step, and the gradient bars
    against the float32 step; returns the measured ratios."""
    loss, aux, grads = port16[:3]
    j_loss, j_aux, j_grads = jax16[:3]
    assert math.isfinite(loss) and int(aux[count]) == int(j_aux[count]) > 0
    np.testing.assert_allclose(loss, j_loss, rtol=STEP_LOSS_TOL)
    # the port's trained leaves (JAX also differentiates the frozen ones,
    # which its optimizer masks)
    keys = [p for p, _ in _leaves(port32[2])]
    assert keys and keys == [p for p, _ in _leaves(grads)]
    ours = _grad_rel(grads, port32[2], keys)
    theirs = _grad_rel(j_grads, port32[2], keys)
    direct = _grad_rel(grads, j_grads, keys)
    print(f"bf16 step gradients, relative L2 by group: port bf16 vs float32 {ours}; "
          f"JAX bf16 vs float32 {theirs}; port vs JAX bf16 {direct}")
    for grp in ours:
        assert ours[grp] <= NOISE_FACTOR * theirs[grp] + NOISE_FLOOR, (grp, ours, theirs)
        assert direct[grp] < STEP_GRAD_TOL, (grp, direct)
    return ours, theirs, direct


def test_bf16_fast_rcnn_step_matches_jax():
    """The bf16 + FOLD_BN Fast R-CNN step on fixed proposals with JAX's
    draws: the same fg rois, the loss within 2e-2 of JAX's bf16 step, every
    trained group's gradient as near the float32 step's as JAX's bf16
    gradient is; parameters, gradients and momentum stay float32."""
    jcfg = tiny_alt_cfg()
    jcfg = jcfg.replace(TRAIN=dataclasses.replace(jcfg.TRAIN, BATCH_IMAGES=1))
    tcfg = port_cfg(jcfg)
    params_np = _perturb(torch_to_flax(tsm.FastRCNN(tcfg, torch.Generator().manual_seed(0))),
                         np.random.RandomState(2))
    batch = proposal_batch(np.random.RandomState(1))
    batch["sample_seeds"] = np.asarray([0], np.int32)
    jax16 = _jax_step(JFastRCNN(bf16(jcfg)), params_np, batch)
    n = batch["proposals"].shape[1] + batch["gt_boxes"].shape[1]
    u = [jax.random.uniform(k, (n,)) for k in jax.random.split(jax16[3], 3)]
    draws = {name: T(np.asarray(x))[None] for name, x in zip(tsm.ROI_DRAWS, u)}
    port32 = _port_step(tcfg, params_np, batch, draws)
    port16 = _port_step(tcfg, params_np, batch, draws, True, "bfloat16")
    _hold_step(port16, port32, jax16, "num_fg_rois")
    model, opt = port16[3], port16[4]
    for p in model.parameters():
        assert p.dtype == torch.float32
        assert p.grad is None or p.grad.dtype == torch.float32
    opt.step()
    bufs = [st["momentum_buffer"] for st in opt.sgd.state.values()]
    assert bufs and all(b.dtype == torch.float32 for b in bufs)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_bf16_mask_step_matches_jax():
    """A bf16 + FOLD_BN Mask R-CNN FPN step on fixed proposals (frozen mode)
    with gt masks and JAX's draws: the same fg rois, the total and the mask
    loss within 2e-2 of JAX's bf16 step, every trained group's gradient as
    near the float32 step's as JAX's bf16 gradient is."""
    jcfg = fpn_cfg()
    jcfg = jcfg.replace(network=dataclasses.replace(jcfg.network, USE_MASK=True))
    tcfg = port_cfg(jcfg)
    model = build_model(tcfg, generator=torch.Generator().manual_seed(0))
    params_np = _tame_rpn(_perturb(torch_to_flax(model), np.random.RandomState(1)))
    batch = {k: np.array(v) for k, v in fpn_batch(np.random.RandomState(1)).items()}
    batch["sample_seeds"] = np.asarray([0], np.int32)
    batch["proposals"] = frozen_proposals(np.random.RandomState(2), batch["gt_boxes"][0])[None]
    batch["prop_valid"] = np.ones((1, PROPOSALS), bool)
    batch["gt_masks"] = gt_masks_for(batch)
    jax16 = _jax_step(JFPNFasterRCNN(bf16(jcfg)), params_np, batch)
    k_anchor, k_roi = jax.random.split(jax16[3], 2)
    n_cand = PROPOSALS + batch["gt_boxes"].shape[1]
    u = [jax.random.uniform(k, (_anchor_count(jcfg, 128, 128),))
         for k in jax.random.split(k_anchor)]
    u += [jax.random.uniform(k, (n_cand,)) for k in jax.random.split(k_roi, 3)]
    draws = {name: T(np.asarray(x))[None] for name, x in zip(tfr.DRAW_NAMES, u)}
    port32 = _port_step(tcfg, params_np, batch, draws)
    port16 = _port_step(tcfg, params_np, batch, draws, True, "bfloat16")
    _hold_step(port16, port32, jax16, "num_fg_rois")
    np.testing.assert_allclose(port16[1]["MaskBCELoss"], jax16[1]["MaskBCELoss"],
                               rtol=STEP_LOSS_TOL)


def test_bf16_predictor_hands_float32_to_the_postprocess():
    """A bf16 + FOLD_BN C4 model behind the Predictor: every output the
    device postprocess reads is float32, and the detections are finite."""
    jcfg = bf16(tiny_alt_cfg())
    tcfg = port_cfg(jcfg)
    model = tfr.FasterRCNN(tcfg, torch.Generator().manual_seed(0))
    images, im_info, orig_hw = uint8_batch(np.random.RandomState(0))
    k = tcfg.dataset.NUM_CLASSES
    raw = Predictor(model, device="cpu").predict({"images": images, "im_info": im_info})
    assert all(v.dtype in (np.float32, np.bool_) for v in raw.values()), \
        {n: v.dtype for n, v in raw.items()}
    pp = make_test_postprocess(tcfg, k, tcfg.TEST.SCORE_THRESH, tcfg.TEST.DET_PER_CLASS)
    out = Predictor(model, pp, device="cpu").predict(
        {"images": images, "im_info": im_info, "orig_hw": orig_hw})
    assert out["det_boxes"].dtype == np.float32 and np.isfinite(out["det_boxes"]).all()


# ------------------------------------------------------- the CLI and TF32
def _tiny(network, dataset):
    """A ResNet-50 C4 config at 96 × 128, bf16 graph folded (FOLD_BN comes
    from the config: the CLI has no flag for it, as JAX's has none)."""
    from mx_rcnn_tpu_torch.config import generate_config

    cfg = generate_config("resnet50", dataset)
    return cfg.replace(network=dataclasses.replace(cfg.network, FOLD_BN=True),
                       dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
                       SHAPE_BUCKETS=((96, 128), (128, 96)),
                       TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=200,
                                                 RPN_POST_NMS_TOP_N=32, BATCH_ROIS=16,
                                                 RPN_BATCH_SIZE=32))


def _tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def _tf32_off() -> bool:
    return not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_train_end2end_compute_dtype_bfloat16_trains_and_checkpoints(monkeypatch, tmp_path):
    """``--compute_dtype bfloat16 --cpu 1``: an epoch of one step trains the
    folded bf16 graph and saves ``epoch_0001`` (float32 tensors, the JAX
    manifest); ``--resume`` continues from it; run_meta records the dtype;
    and the CLI leaves TF32 off."""
    from mx_rcnn_tpu_torch.core.checkpoint import DATA_FILE
    from mx_rcnn_tpu_torch.tools import train_end2end as cli
    from mx_rcnn_tpu_torch.utils.run_meta import load_run_meta

    monkeypatch.setattr(cli, "generate_config", _tiny)
    prefix = str(tmp_path / "e2e")
    argv = ["--cpu", "1", "--synthetic", "1", "--no_flip", "--compute_dtype", "bfloat16",
            "--prefix", prefix]
    _tf32_on()
    out = cli.main(argv + ["--epochs", "1"])
    assert _tf32_off()
    assert out["steps"] == 1 and all(math.isfinite(v) for v in out["history"][0].values())
    model = out["state"].model
    assert model.cfg.network.COMPUTE_DTYPE == "bfloat16" and model.cfg.network.FOLD_BN
    assert load_run_meta(prefix)["COMPUTE_DTYPE"] == "bfloat16"
    tree = torch.load(tmp_path / "e2e" / "epoch_0001" / DATA_FILE, weights_only=True)
    tensors = [t for t in tree["model"].values()] + [t for t in tree["momentum"].values()
                                                        if t is not None]
    assert tensors and all(t.dtype == torch.float32 for t in tensors)
    again = cli.main(argv + ["--epochs", "2", "--resume"])
    assert again["begin"] == (1, 0) and again["steps"] == 1


@pytest.mark.parametrize("name", ["train_end2end", "train_rpn", "train_rcnn", "train_alternate",
                                  "test_rpn", "test", "reeval", "demo"])
def test_every_cli_main_turns_tf32_off(name):
    """Each CLI main of ``tools/`` turns TF32 off before it reads its
    arguments (``--help`` then exits)."""
    import importlib

    cli = importlib.import_module(f"mx_rcnn_tpu_torch.tools.{name}")
    _tf32_on()
    with pytest.raises((SystemExit, NotImplementedError)):
        cli.main(["--help"])
    assert _tf32_off()


def test_library_entry_points_turn_tf32_off():
    """``Predictor``, ``fit`` and ``generate_proposals`` on the CPU leave
    TF32 off for cuDNN and for matmuls."""
    from mx_rcnn_tpu_torch.core.fit import fit
    from mx_rcnn_tpu_torch.core.tester import generate_proposals
    from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset

    cfg = _tiny("resnet", "PascalVOC")
    model = tsm.RPNOnly(cfg)
    _tf32_on()
    predictor = Predictor(model, device="cpu")
    assert _tf32_off()

    class _NoImages:
        def __len__(self):
            return 0

        def iter_batched(self):
            return iter(())

    _tf32_on()
    assert generate_proposals(predictor, _NoImages(), cfg) == []
    assert _tf32_off()
    _tf32_on()
    roidb = SyntheticDataset(num_images=1, image_size=(240, 320)).gt_roidb()
    out = fit(model, cfg, roidb, epochs=1, max_steps=1, device="cpu")
    assert out["steps"] == 1 and _tf32_off()


# ------------------------------------------------------ found while testing
def test_render_cache_tells_records_of_other_classes_apart():
    """The synthetic render cache keys a render by everything it paints
    from: two records of one uri, seed and size whose classes (or boxes)
    differ render apart (the old key served the first render to both, so
    a CLI eval test compared JAX against another file's image)."""
    from mx_rcnn_tpu_torch.data import loader as tloader
    from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset, synthetic_image

    rec = SyntheticDataset(num_images=1, num_classes=21).gt_roidb()[0]
    other = dict(rec, gt_classes=np.asarray(rec["gt_classes"]) % 20 + 1)
    moved = dict(rec, boxes=np.asarray(rec["boxes"]) + np.float32(3.0))
    for r in (rec, other, moved):
        np.testing.assert_array_equal(tloader.load_record_image(r),
                                      synthetic_image(r, r["synthetic_seed"]))
    assert len({tloader._render_key(r) for r in (rec, other, moved)}) == 3
