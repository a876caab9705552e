"""Pretrained-backbone import: torchvision checkpoints → the port's models
(port of ``mx_rcnn_tpu/utils/pretrained.py``).

Reference: ``rcnn/utils/load_model.py :: load_param`` and the ImageNet
initialization of ``train_end2end.py :: train_net``: the reference never
trains from random weights, it loads ImageNet VGG-16 / ResNet weights into
the backbone before attaching the detection heads.

The importers read the torchvision ``state_dict`` naming of ResNet-50/101
and VGG-16 (``.pth`` / ``.pt`` through ``torch.load(weights_only=True)``,
``.npz``, or a pickled dict) and build the JAX package's Flax-layout trees,
numpy leaves, so a tree is the same in both packages; :func:`apply_pretrained`
loads one into a port model through ``utils/bridge.py``.  Layouts:

- torch convs are OIHW, Flax kernels HWIO;
- torch BN ``weight/bias/running_mean/running_var`` →
  ``FrozenBatchNorm`` ``scale/bias/mean/var``;
- ``layer4`` goes to the top head (conv5 runs per roi) in the C4 layout,
  to the backbone in the FPN layout (C5 feeds the pyramid);
- VGG's fc6 reads a (512, 7, 7) CHW-flattened roi in torch, a (7, 7, 512)
  HWC-flattened one here (``models/vgg.py::VGGTopHead``): its rows are
  permuted;
- torchvision models are trained on RGB in [0, 1] normalized by mean
  (0.485, 0.456, 0.406) and std (0.229, 0.224, 0.225):
  :func:`torchvision_pixel_stats` gives the same on the 0–255 scale of
  PIXEL_MEANS / PIXEL_STDS.
"""

from __future__ import annotations

import pickle
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch

_RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

# torchvision feature indices of the 13 VGG-16 convs, in block order
_VGG16_FEATURES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG16_NAMES = (
    "conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
    "conv3_3", "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2",
    "conv5_3",
)


def torchvision_pixel_stats() -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """(PIXEL_MEANS, PIXEL_STDS) on the 0–255 RGB scale for torchvision
    checkpoints."""
    means = tuple(255.0 * m for m in (0.485, 0.456, 0.406))
    stds = tuple(255.0 * s for s in (0.229, 0.224, 0.225))
    return means, stds


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint file → a flat {name: ndarray} dict: ``.npz``, a torch
    ``.pth`` / ``.pt`` state_dict (read weights-only onto the CPU) or a
    pickled dict."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    if path.endswith((".pth", ".pt")):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
        return {k: v.detach().cpu().numpy() for k, v in obj.items()}
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return {k: np.asarray(v) for k, v in obj.items()}


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """OIHW → HWIO."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))).astype(np.float32)


def _bn(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "scale": sd[f"{prefix}.weight"].astype(np.float32),
        "bias": sd[f"{prefix}.bias"].astype(np.float32),
        "mean": sd[f"{prefix}.running_mean"].astype(np.float32),
        "var": sd[f"{prefix}.running_var"].astype(np.float32),
    }


def _bottleneck(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    unit = {}
    for i in (1, 2, 3):
        unit[f"conv{i}"] = {"kernel": _conv_kernel(sd[f"{prefix}.conv{i}.weight"])}
        unit[f"bn{i}"] = _bn(sd, f"{prefix}.bn{i}")
    if f"{prefix}.downsample.0.weight" in sd:
        unit["sc"] = {"kernel": _conv_kernel(sd[f"{prefix}.downsample.0.weight"])}
        unit["sc_bn"] = _bn(sd, f"{prefix}.downsample.1")
    return unit


def import_resnet(sd: Dict[str, np.ndarray], depth: int, fpn: bool = False) -> Tuple[Dict, Dict]:
    """torchvision ResNet state_dict → (backbone tree, top head tree).

    C4 layout: the backbone is conv0/bn0 and stage1–stage3, the top head
    stage4.  FPN layout (``fpn``): stage4 is the backbone's too, and the
    top head (the box head's two fcs, no ImageNet twin) is empty."""
    blocks = _RESNET_BLOCKS[depth]
    backbone: Dict = {
        "conv0": {"kernel": _conv_kernel(sd["conv1.weight"])},
        "bn0": _bn(sd, "bn1"),
    }
    n_backbone_stages = 4 if fpn else 3
    for stage, n_units in enumerate(blocks[:n_backbone_stages], start=1):
        backbone[f"stage{stage}"] = {
            f"unit{u + 1}": _bottleneck(sd, f"layer{stage}.{u}") for u in range(n_units)
        }
    if fpn:
        return backbone, {}
    top_head = {"stage4": {f"unit{u + 1}": _bottleneck(sd, f"layer4.{u}")
                           for u in range(blocks[3])}}
    return backbone, top_head


def import_vgg16(sd: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """torchvision VGG-16 state_dict → (backbone tree, top head tree)."""
    backbone: Dict = {}
    for idx, name in zip(_VGG16_FEATURES, _VGG16_NAMES):
        backbone[name] = {
            "kernel": _conv_kernel(sd[f"features.{idx}.weight"]),
            "bias": sd[f"features.{idx}.bias"].astype(np.float32),
        }
    # fc6: torch flattens (512, 7, 7) CHW, the port (7, 7, 512) HWC
    w6 = sd["classifier.0.weight"]                     # (4096, 25088)
    w6 = w6.reshape(4096, 512, 7, 7).transpose(2, 3, 1, 0).reshape(25088, 4096)
    top_head = {
        "fc6": {"kernel": np.ascontiguousarray(w6).astype(np.float32),
                "bias": sd["classifier.0.bias"].astype(np.float32)},
        "fc7": {"kernel": np.ascontiguousarray(sd["classifier.3.weight"].T).astype(np.float32),
                "bias": sd["classifier.3.bias"].astype(np.float32)},
    }
    return backbone, top_head


def import_tree(sd: Dict[str, np.ndarray], network: str, depth: int,
                fpn: bool = False) -> Dict:
    """The imported ``{backbone, top_head}`` tree of a network (``top_head``
    left out where it is empty: ResNet FPN)."""
    if network == "vgg":
        backbone, top_head = import_vgg16(sd)
    else:
        backbone, top_head = import_resnet(sd, depth, fpn=fpn)
    return {"backbone": backbone, **({"top_head": top_head} if top_head else {})}


def apply_pretrained(model: nn.Module, sd: Dict[str, np.ndarray], network: str, depth: int,
                     fpn: bool = False) -> nn.Module:
    """Replace ``model``'s backbone and top head (C4 / VGG) with the imported
    ImageNet weights, in place; the RPN and detection heads keep their
    init, as in the reference.  Every imported leaf must name a tensor of
    the model with its shape, and every tensor of the replaced subtrees
    must be imported (``flax_to_torch(partial=True)``)."""
    return flax_to_torch(import_tree(sd, network, depth, fpn), model, partial=True)
