"""Data-dependent FrozenBatchNorm calibration for random-init training (port
of ``mx_rcnn_tpu/utils/bn_calibrate.py``).

A random-init frozen-BN ResNet has moments (0, 1) while its conv outputs
drift to O(10²) by the deep stages, so losses start huge and SGD diverges
at the reference learning rates.  :func:`calibrate_frozen_bn` runs ONE test
forward, records every conv's output (forward hooks that only record: no BN
changes before the sweep ends) and writes each BN's observed input mean and
variance into its frozen ``mean`` / ``var`` buffers, in place.  BN stays a
frozen affine; only its constants change.

Pairing is by the module names (``convX ↔ bnX``, ``sc ↔ sc_bn``,
``conv0 ↔ bn0``, ``models/resnet.py``), asserted, as is that each captured
output is a batch activation (its leading axis the batch's images): the C4
top head's convs see rois, not images, so a C4 model with more than one roi
a batch is refused as in the JAX package.

This is not ``chip_smoke.py``'s ``calibrate_bn``, which sets each BN from
its input in sequence (later layers see calibrated inputs) and floors
nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm


def _bn_to_conv_name(bn: str) -> str:
    if bn == "sc_bn":
        return "sc"
    assert bn.startswith("bn"), f"unrecognized FrozenBatchNorm name {bn!r}"
    return "conv" + bn[2:]


def _graph_class(cfg):
    """The class ``build_model(cfg)`` returns, without building it."""
    if cfg.network.USE_FPN:
        from mx_rcnn_tpu_torch.models.fpn import FPNFasterRCNN

        return FPNFasterRCNN
    from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN

    return FasterRCNN


def _unfused_twin(model: nn.Module, cfg) -> nn.Module:
    """``build_model(cfg)`` with FOLD_BN off, holding ``model``'s tensors on
    its device (built on the meta device: no seeded init)."""
    from mx_rcnn_tpu_torch.models import build_model

    ucfg = cfg.replace(network=dataclasses.replace(cfg.network, FOLD_BN=False))
    with torch.device("meta"):
        twin = build_model(ucfg)
    dev = next(iter(model.state_dict().values())).device
    twin.to_empty(device=dev)
    twin.load_state_dict(model.state_dict())
    return twin


@torch.no_grad()
def calibrate_frozen_bn(model: nn.Module, batch: Dict) -> nn.Module:
    """Set every frozen BN's ``mean`` / ``var`` to its conv's observed
    output statistics on ``batch`` (``images`` / ``im_info`` tensors on the
    model's device; a test forward runs every backbone and neck BN), in
    place, and return ``model``.

    ONE whole-net sweep, deliberately: every BN's statistics come from the
    raw forward, so deep BNs see slightly different inputs once shallow BNs
    are corrected.  Iterating to self-consistency diverges (the JAX
    package's docstring: a near-dead channel's large gain compounds across
    the residual units into float32 overflow); the variance floor
    ``max(var, 0.04·(mean² + 1))`` caps any one BN's gain at 5×.

    Under FOLD_BN the folded graph never materializes a conv's output, so
    the sweep runs on an unfused twin built by ``build_model(cfg)`` with
    FOLD_BN off; a stage model (``models/stage_models.py``) has no such
    twin and raises ``TypeError``."""
    cfg = getattr(model, "cfg", None)
    probe = model
    if cfg is not None and getattr(cfg.network, "FOLD_BN", False):
        if type(model) is not _graph_class(cfg):
            raise TypeError(
                "calibrate_frozen_bn with FOLD_BN=True only supports "
                f"build_model(cfg) models, got {type(model).__name__}; "
                "calibrate the stage model with FOLD_BN off"
            )
        probe = _unfused_twin(model, cfg)
    modules = dict(probe.named_modules())
    pairs = []
    for name, m in probe.named_modules():
        if not isinstance(m, FrozenBatchNorm):
            continue
        parent, _, leaf = name.rpartition(".")
        conv_name = (parent + "." if parent else "") + _bn_to_conv_name(leaf)
        assert conv_name in modules, f"no conv {conv_name} for BN {name}"
        pairs.append((name, conv_name))
    captured: Dict[str, torch.Tensor] = {}

    def recorder(conv_name):
        def hook(_m, _args, out):
            captured.setdefault(conv_name, out)   # the first call, as JAX's vals[0]
        return hook

    hooks = [modules[c].register_forward_hook(recorder(c)) for _, c in pairs]
    was_training = probe.training
    try:
        probe.eval()
        probe(batch["images"], batch["im_info"])
    finally:
        for h in hooks:
            h.remove()
        probe.train(was_training)
    n_images = batch["images"].shape[0]
    bns = dict(model.named_modules())
    for bn_name, conv_name in pairs:
        assert conv_name in captured, f"no captured conv output {conv_name} for BN {bn_name}"
        x = captured[conv_name].float()
        # a parameter bank (a folded graph's kernels) is not an activation
        assert x.shape[0] == n_images, (
            f"captured {conv_name} is not a batch activation: {tuple(x.shape)}")
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        # a (near-)dead channel's var → 0 would get a ~1/sqrt(eps) gain;
        # flooring at (20% of |mean|)² + 0.04 caps the gain at 5×
        var = torch.maximum(var, 0.04 * (mean * mean + 1.0))
        bn = bns[bn_name]
        bn.mean.copy_(mean)
        bn.var.copy_(var)
    return model
