"""The port's integration gate (``tools/integration_gate.py``) against the JAX
package's: ``gate_cfg`` trees for every family, dtype and fold setting;
``mask_iou_eval`` on bridged weights; a 2-step CPU ``run_gate`` with JAX's
result keys; the CLI's exit code."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.models import build_model as j_build_model
from mx_rcnn_tpu.tools import integration_gate as jgate
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.tools import integration_gate as tgate
from mx_rcnn_tpu_torch.utils.bn_calibrate import calibrate_frozen_bn
from mx_rcnn_tpu_torch.utils.bridge import torch_to_flax

torch.set_num_threads(2)

OUT_KEYS = {"mAP", "segm_AP50", "gate", "network", "steps", "per_eval"}


@pytest.mark.parametrize("fold_bn", [None, True])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("network", ["resnet50", "resnet_fpn", "mask_resnet_fpn", "vgg"])
def test_gate_cfg_equals_jax(network, compute_dtype, fold_bn):
    want = jgate.gate_cfg(network, compute_dtype=compute_dtype, fold_bn=fold_bn)
    got = tgate.gate_cfg(network, compute_dtype=compute_dtype, fold_bn=fold_bn)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_mask_iou_eval_matches_jax():
    jcfg, tcfg = jgate.gate_cfg("mask_resnet_fpn"), tgate.gate_cfg("mask_resnet_fpn")
    roidb = SyntheticDataset(num_images=2, num_classes=4, image_size=(128, 128), max_boxes=2,
                             seed=0, with_masks=True).gt_roidb()
    model = build_model(tcfg, generator=torch.Generator().manual_seed(0)).eval()
    b = {"images": torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1)) * 200,
         "im_info": torch.tensor([[128.0, 128.0, 1.0]] * 2)}
    calibrate_frozen_bn(model, b)
    params = torch_to_flax(model)
    want = jgate.mask_iou_eval(j_build_model(jcfg), jax.tree.map(jnp.asarray, params), jcfg,
                               roidb)
    got = tgate.mask_iou_eval(model, None, tcfg, roidb, device="cpu")
    assert 0.0 < want < 1.0
    assert got == pytest.approx(want, abs=1e-5)
    # params given: loaded first (a host state_dict of other weights)
    other = {k: v.clone() for k, v in model.state_dict().items()}
    other["mask_head.mask_logits.bias"] = other["mask_head.mask_logits.bias"] - 100.0
    assert tgate.mask_iou_eval(model, other, tcfg, roidb, device="cpu") == 0.0


def test_two_step_cpu_gate_has_jax_keys():
    out = tgate.run_gate("resnet50", num_images=2, steps=2, eval_every=2, target=0,
                         device="cpu")
    assert set(out) == OUT_KEYS
    assert out["network"] == "resnet50" and out["steps"] == 2 and out["segm_AP50"] is None
    assert [s for s, _ in out["per_eval"]] == [2]
    assert all(np.isfinite(v) for v in (out["mAP"], out["gate"], out["per_eval"][0][1]))


def test_cli_exit_code_follows_the_target(monkeypatch, capsys):
    calls = []

    def fake(**kw):
        calls.append(kw)
        return {"mAP": 0.5, "segm_AP50": None, "gate": 0.5, "network": kw["network"],
                "steps": 1, "per_eval": [(1, 0.5)]}

    monkeypatch.setattr(tgate, "run_gate", fake)
    assert tgate.main(["--cpu", "1", "--target", "0.4", "--bf16", "--fold_bn"]) == 0
    assert tgate.main(["--cpu", "1", "--target", "0.6", "--network", "vgg"]) == 1
    assert calls[0]["device"] == "cpu" and calls[0]["compute_dtype"] == "bfloat16"
    assert calls[0]["fold_bn"] is True and calls[1]["fold_bn"] is None
    assert "'gate': 0.5" in capsys.readouterr().out
