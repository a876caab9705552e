"""Stage graphs of alternate training (port of
``mx_rcnn_tpu/models/stage_models.py``): the RPN alone and Fast R-CNN on
given proposals, each with a train and a test forward.

Reference: ``get_*_rpn`` / ``get_*_rpn_test`` (``rcnn/tools/train_rpn.py``,
``test_rpn.py``) and ``get_*_rcnn`` / ``get_*_rcnn_test``
(``rcnn/tools/train_rcnn.py``).  Both hold the submodules of
:class:`~mx_rcnn_tpu_torch.models.faster_rcnn.FasterRCNN` under its names,
``{backbone, rpn}`` and ``{backbone, top_head, rcnn}``, so a stage's Flax
tree moves into another stage or the joint model by subtree
(``core/fit.py::merge_params``, ``utils/combine_model.py``).  Both take
``forward(..., train=True)`` → (loss, aux) and ``forward(...)`` → padded
outputs, as FasterRCNN does, so ``train_step`` and the ``Predictor`` drive
them unchanged.

The graphs are the JAX package's, which differ from FasterRCNN's in two
places: the RPN's test forward masks no bucket padding (no pad mask, no
anchor grid mask), and Fast R-CNN's test forward pools the proposals with
the canvas clamp (no ``valid_hw``), the rule of the train path.  The
kernels: NMS (kernel 1) in the RPN's test forward only; ROIAlign forward
(kernel 2) in both Fast R-CNN forwards, its backward (kernel 3) in
training.  Both build in the config's COMPUTE_DTYPE and FOLD_BN, as
FasterRCNN does (the JAX package's ``build_backbone``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
from torch import nn

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.models.faster_rcnn import (
    FasterRCNN,
    init_weights,
    rcnn_losses,
    rpn_losses,
    sampling_uniforms,
)
from mx_rcnn_tpu_torch.models.heads import RCNNHead
from mx_rcnn_tpu_torch.models.layers import compute_dtype, normalize_images
from mx_rcnn_tpu_torch.models.resnet import ResNetBackbone, ResNetTopHead
from mx_rcnn_tpu_torch.models.rpn import RPNHead
from mx_rcnn_tpu_torch.ops.proposal import propose
from mx_rcnn_tpu_torch.ops.roi_align import extract_roi_features_batched
from mx_rcnn_tpu_torch.ops.targets import assign_anchor, sample_rois

ANCHOR_DRAWS = ("anchor_fg", "anchor_bg")
ROI_DRAWS = ("roi_fg", "roi_bg", "roi_tie")


def _check(cfg: Config, what: str) -> None:
    net = cfg.network
    if net.name == "vgg":
        raise NotImplementedError(f"{what} for vgg: the VGG-16 graphs are ROADMAP queue 1 item 11")
    if net.name != "resnet" or net.USE_FPN or net.USE_MASK:
        raise NotImplementedError(f"{what} builds the ResNet C4 stage graphs only, "
                                  f"not {net.name!r} with FPN {net.USE_FPN}, mask {net.USE_MASK}")


class RPNOnly(nn.Module):
    """The RPN training and proposal graph: backbone → RPN head → anchor
    targets and the two RPN losses (train), or → proposals (test, the
    config's TEST.RPN_* budgets)."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        _check(cfg, "RPNOnly")
        net = cfg.network
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.backbone = ResNetBackbone(net.depth, dtype=dtype, fold_bn=net.FOLD_BN)
        self.rpn = RPNHead(1024, net.NUM_ANCHORS, 512, dtype)
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self._constants: Dict = {}

    _anchors = FasterRCNN._anchors

    def forward(
        self,
        images: torch.Tensor,
        im_info: torch.Tensor,
        gt_boxes: Optional[torch.Tensor] = None,
        gt_valid: Optional[torch.Tensor] = None,
        train: bool = False,
        sample_seeds: Optional[Iterable[int]] = None,
        rng: int = 0,
        draws: Optional[Dict[str, torch.Tensor]] = None,
    ):
        """Test: padded ``rois`` (B, R, 4) in the resized image's
        coordinates, ``roi_scores``, ``roi_valid``.  Train: (loss, aux);
        the anchor sampler takes ``draws`` (:data:`ANCHOR_DRAWS`) when
        given, else :func:`sampling_uniforms` of ``rng`` and
        ``sample_seeds``."""
        cfg = self.cfg
        images = normalize_images(images, im_info, cfg)
        b = images.shape[0]
        feat = self.backbone(images.permute(0, 3, 1, 2))
        rpn_logits, rpn_deltas = self.rpn(feat)
        anchors = self._anchors(feat.shape[2], feat.shape[3], images.device)
        if not train:
            te = cfg.TEST
            props = propose(
                torch.softmax(rpn_logits, dim=-1)[..., 1], rpn_deltas, anchors, im_info,
                te.RPN_PRE_NMS_TOP_N, te.RPN_POST_NMS_TOP_N, te.RPN_NMS_THRESH, te.RPN_MIN_SIZE,
            )
            return {"rois": props.rois, "roi_scores": props.scores, "roi_valid": props.valid}

        if draws is None:
            seeds = range(b) if sample_seeds is None else sample_seeds
            draws = sampling_uniforms(rng, seeds, anchors.shape[0], 0, images.device,
                                      names=ANCHOR_DRAWS)
        atgt = assign_anchor(anchors, gt_boxes, gt_valid, im_info, cfg,
                             u=(draws["anchor_fg"], draws["anchor_bg"]))
        return rpn_losses(cfg, rpn_logits, rpn_deltas, atgt)


class FastRCNN(nn.Module):
    """Fast R-CNN on given proposals (the reference's TRAIN.HAS_RPN off):
    backbone → ROIAlign of the sampled proposals → conv5 top head → RCNN
    head → the two RCNN losses (train), or of every proposal → class
    probabilities and de-normalized deltas (test).  The proposals are the
    batch's ``proposals`` / ``prop_valid`` (``make_batch(proposal_count)``),
    in the resized image's coordinates."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        _check(cfg, "FastRCNN")
        net = cfg.network
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.backbone = ResNetBackbone(net.depth, dtype=dtype, fold_bn=net.FOLD_BN)
        self.top_head = ResNetTopHead(net.depth, dtype, net.FOLD_BN)
        self.rcnn = RCNNHead(2048, cfg.dataset.NUM_CLASSES, dtype)
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self._constants: Dict = {}

    _bbox_denorm = FasterRCNN._bbox_denorm

    def _roi_features(self, feat: torch.Tensor, rois: torch.Tensor,
                      fwd_only: bool = False) -> torch.Tensor:
        """(B, 1024, H, W) feature × (B, R, 4) rois → (B·R, 2048): ROIAlign
        clamped to the canvas (no ``valid_hw``), then the top head."""
        net = self.cfg.network
        pooled = extract_roi_features_batched(
            feat.permute(0, 2, 3, 1), rois, net.ROI_MODE, net.POOLED_SIZE,
            1.0 / net.RCNN_FEAT_STRIDE, net.ROI_SAMPLE_RATIO, fwd_only=fwd_only,
        )
        b, r = pooled.shape[0], pooled.shape[1]
        return self.top_head(pooled.reshape((b * r,) + pooled.shape[2:]).permute(0, 3, 1, 2))

    def forward(
        self,
        images: torch.Tensor,
        im_info: torch.Tensor,
        gt_boxes: Optional[torch.Tensor] = None,
        gt_valid: Optional[torch.Tensor] = None,
        train: bool = False,
        sample_seeds: Optional[Iterable[int]] = None,
        rng: int = 0,
        draws: Optional[Dict[str, torch.Tensor]] = None,
        proposals: Optional[torch.Tensor] = None,
        prop_valid: Optional[torch.Tensor] = None,
    ):
        """Test: ``rois`` (the proposals), ``roi_scores`` (zeros),
        ``roi_valid`` (``prop_valid``), ``cls_prob`` (B, R, K) and
        ``bbox_deltas`` (B, R, 4K).  Train: (loss, aux); the roi sampler
        takes ``draws`` (:data:`ROI_DRAWS`) when given, else
        :func:`sampling_uniforms` of ``rng`` and ``sample_seeds``."""
        if proposals is None or prop_valid is None:
            raise ValueError("FastRCNN needs the batch's proposals and prop_valid")
        cfg = self.cfg
        k = cfg.dataset.NUM_CLASSES
        images = normalize_images(images, im_info, cfg)
        b = images.shape[0]
        feat = self.backbone(images.permute(0, 3, 1, 2))
        if not train:
            cls_logits, bbox_deltas = self.rcnn(self._roi_features(feat, proposals, fwd_only=True))
            r = proposals.shape[1]
            means, stds = self._bbox_denorm(images.device)
            return {
                "rois": proposals,
                "roi_scores": torch.zeros(proposals.shape[:2], dtype=torch.float32,
                                          device=proposals.device),
                "roi_valid": prop_valid,
                "cls_prob": torch.softmax(cls_logits, dim=-1).reshape(b, r, k),
                "bbox_deltas": (bbox_deltas * stds + means).reshape(b, r, 4 * k),
            }

        if draws is None:
            seeds = range(b) if sample_seeds is None else sample_seeds
            draws = sampling_uniforms(rng, seeds, 0, proposals.shape[1] + gt_boxes.shape[1],
                                      images.device, names=ROI_DRAWS)
        samples = sample_rois(proposals, prop_valid, gt_boxes, gt_valid, cfg,
                              u=(draws["roi_fg"], draws["roi_bg"], draws["roi_tie"]))
        cls_logits, bbox_pred_out = self.rcnn(self._roi_features(feat, samples.rois))
        return rcnn_losses(cfg, samples, cls_logits, bbox_pred_out)
