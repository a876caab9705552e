"""The port's ``utils/bn_calibrate.py::calibrate_frozen_bn`` against the JAX
package's on bridged weights: a small C4 model (one image, one roi, so the
top head's convs see a batch of one: JAX's rule refuses a batch of rois)
with a dead conv0 channel that the variance floor binds, and a small FPN
model on one image.  Moments within 1e-5 relative L2 by BN (torch's and
XLA's convs round apart, ~2e-6 at the deepest BN).  Under FOLD_BN the
unfused twin gives the unfolded model's moments; a stage model under
FOLD_BN is refused."""

import dataclasses

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.tools.integration_gate import gate_cfg as j_gate_cfg
from mx_rcnn_tpu.utils.bn_calibrate import calibrate_frozen_bn as j_calibrate
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm
from mx_rcnn_tpu_torch.models.stage_models import RPNOnly
from mx_rcnn_tpu_torch.tools.integration_gate import gate_cfg
from mx_rcnn_tpu_torch.utils.bn_calibrate import calibrate_frozen_bn
from mx_rcnn_tpu_torch.utils.bridge import torch_to_flax

MOMENT_TOL = 1e-5


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _with_rois(cfg, n):
    return cfg.replace(TEST=dataclasses.replace(cfg.TEST, RPN_POST_NMS_TOP_N=n))


def _batch(b, seed=0):
    rng = np.random.RandomState(seed)
    images = (rng.rand(b, 128, 128, 3) * 100).astype(np.float32)
    info = np.tile([128, 128, 1.0], (b, 1)).astype(np.float32)
    return images, info


def _torch_batch(images, info):
    return {"images": torch.from_numpy(images), "im_info": torch.from_numpy(info)}


def _moments(model):
    return {n: (m.mean.clone(), m.var.clone()) for n, m in model.named_modules()
            if isinstance(m, FrozenBatchNorm)}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("network,images,rois", [("resnet50", 1, 1), ("resnet_fpn", 1, 64)])
def test_moments_match_jax(network, images, rois):
    tcfg, jcfg = _with_rois(gate_cfg(network), rois), _with_rois(j_gate_cfg(network), rois)
    torch.manual_seed(0)
    model = build_model(tcfg, generator=torch.Generator().manual_seed(0)).eval()
    dead = None
    if network == "resnet50":
        # a dead conv0 channel: var 0 and mean 0, so the floor gives 0.04
        with torch.no_grad():
            model.backbone.conv0.weight[5] = 0.0
        dead = ("backbone", "bn0", "var")
    params = torch_to_flax(model)
    ims, info = _batch(images)
    ref = dict(_leaves(j_calibrate(j_build_model(jcfg), params,
                                   {"images": ims, "im_info": info})))
    assert calibrate_frozen_bn(model, _torch_batch(ims, info)) is model
    got = dict(_leaves(torch_to_flax(model)))
    n = 0
    for path, want in ref.items():
        if path[-1] in ("mean", "var"):
            assert _rel_l2(got[path], want) <= MOMENT_TOL, "/".join(path)
            n += 1
    assert n == 2 * sum(isinstance(m, FrozenBatchNorm) for m in model.modules())
    if dead is not None:
        assert ref[dead][5] == pytest.approx(0.04) and got[dead][5] == pytest.approx(0.04)
    # every BN moved off the identity moments
    assert all(not np.array_equal(got[p], np.ones_like(got[p])) for p in got if p[-1] == "var")


def test_c4_rois_are_not_a_batch_activation():
    """At the gate's 32 test rois the top head's convs see 32 rows for one
    image: refused, as JAX's assertion refuses them."""
    model = build_model(gate_cfg("resnet50"), generator=torch.Generator().manual_seed(0))
    with pytest.raises(AssertionError, match="top_head.*not a batch activation"):
        calibrate_frozen_bn(model, _torch_batch(*_batch(1)))


def test_fold_bn_calibrates_on_the_unfused_twin():
    base = _with_rois(gate_cfg("resnet50"), 1)
    fold = base.replace(network=dataclasses.replace(base.network, FOLD_BN=True))
    plain = build_model(base, generator=torch.Generator().manual_seed(3)).eval()
    folded = build_model(fold, generator=torch.Generator().manual_seed(3)).eval()
    batch = _torch_batch(*_batch(1, seed=1))
    calibrate_frozen_bn(plain, batch)
    calibrate_frozen_bn(folded, batch)
    want, got = _moments(plain), _moments(folded)
    assert want.keys() == got.keys()
    for name, (m, v) in want.items():
        torch.testing.assert_close(got[name][0], m, rtol=0, atol=0, msg=name)
        torch.testing.assert_close(got[name][1], v, rtol=0, atol=0, msg=name)


def test_fold_bn_stage_model_is_refused():
    cfg = gate_cfg("resnet50")
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, FOLD_BN=True))
    with torch.device("meta"):
        model = RPNOnly(cfg)
    with pytest.raises(TypeError, match="RPNOnly"):
        calibrate_frozen_bn(model, _torch_batch(*_batch(1)))
