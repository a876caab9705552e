"""Faster R-CNN, ResNet C4 (port of ``mx_rcnn_tpu/models/faster_rcnn.py``):
the inference forward ``test_forward`` and the training forward
``train_forward``, in the JAX graph's order.

Inference: normalize → pad mask → backbone → RPN softmax fg → grid mask →
propose → ``pad_feat_to_ladder`` → ROIAlign with ``valid_hw`` → top head →
RCNN head → de-normalized deltas.  Training keeps the plain arithmetic (no
pad mask, no grid mask, no ladder padding): backbone → RPN → anchor targets
→ proposals from detached scores → roi sampling → ROIAlign clamped to the
canvas → heads → the four losses.  The kernels of the two paths are the NMS
inside ``propose`` and the ROIAlign forward, and in training also the
ROIAlign backward.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.models.heads import RCNNHead
from mx_rcnn_tpu_torch.models.layers import (
    make_pad_mask,
    normalize_images,
    pad_feat_to_ladder,
)
from mx_rcnn_tpu_torch.models.resnet import ResNetBackbone, ResNetTopHead
from mx_rcnn_tpu_torch.models.rpn import RPNHead
from mx_rcnn_tpu_torch.ops.anchors import shifted_anchors
from mx_rcnn_tpu_torch.ops.losses import accuracy, softmax_cross_entropy, weighted_smooth_l1
from mx_rcnn_tpu_torch.ops.nms import _NEG_INF
from mx_rcnn_tpu_torch.ops.proposal import anchor_grid_mask, propose
from mx_rcnn_tpu_torch.ops.roi_align import extract_roi_features_batched
from mx_rcnn_tpu_torch.ops.targets import assign_anchor, bbox_denorm_vectors, sample_rois

# stddev of a unit truncated normal on [-2, 2] (Flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978

_MASK64 = (1 << 64) - 1

# the five (B, n) uniforms of one train step, in the order they are drawn
DRAW_NAMES = ("anchor_fg", "anchor_bg", "roi_fg", "roi_bg", "roi_tie")


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (the splitmix64
    finalizer): the role of ``jax.random.fold_in`` for integer seeds."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def sampling_uniforms(
    rng: int, sample_seeds: Iterable[int], n_anchors: int, n_cand: int, device
) -> Dict[str, torch.Tensor]:
    """The samplers' uniforms for a batch: image i's come from a generator
    seeded with ``fold_in(rng, sample_seeds[i])``, so they depend only on
    the step's seed and the image, never on the batch around it (the JAX
    package's per-image ``sample_seeds`` keys)."""
    rows = {k: [] for k in DRAW_NAMES}
    for seed in sample_seeds:
        gen = torch.Generator(device=device).manual_seed(fold_in(rng, int(seed)))
        for k in DRAW_NAMES:
            n = n_anchors if k.startswith("anchor") else n_cand
            rows[k].append(torch.rand(n, generator=gen, device=device))
    return {k: torch.stack(v) for k, v in rows.items()}


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init with Flax's distributions, drawn from ``generator``:
    lecun_normal (truncated, fan-in) for conv kernels, Normal(0.01) for
    ``cls_score`` and Normal(0.001) for ``bbox_pred`` (models/heads.py),
    zero biases, identity frozen BN (the buffers' defaults)."""
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        elif isinstance(m, nn.Linear):
            std = 0.001 if name.endswith("bbox_pred") else 0.01
            nn.init.normal_(m.weight, 0.0, std, generator=generator)
        else:
            continue
        if m.bias is not None:
            nn.init.zeros_(m.bias)


class FasterRCNN(nn.Module):
    """Two-stage detector over the single-level ResNet C4 feature map."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        net = cfg.network
        if net.USE_FPN:
            raise NotImplementedError("USE_FPN: FasterRCNN builds a single-level C4 graph")
        if net.USE_MASK:
            raise NotImplementedError("USE_MASK: the mask path lands with the FPN model")
        if net.name != "resnet":
            raise NotImplementedError(f"network {net.name!r} is not ported yet")
        if net.COMPUTE_DTYPE != "float32" or net.FOLD_BN:
            raise NotImplementedError("only the float32, unfolded-BN graph is ported")
        self.cfg = cfg
        self.backbone = ResNetBackbone(net.depth)
        self.top_head = ResNetTopHead(net.depth)
        self.rpn = RPNHead(1024, net.NUM_ANCHORS, 512)
        self.rcnn = RCNNHead(2048, cfg.dataset.NUM_CLASSES)
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))

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
        images = normalize_images(images, im_info, self.cfg)
        if train:
            return self.train_forward(images, im_info, gt_boxes, gt_valid, sample_seeds, rng, draws)
        return self.test_forward(images, im_info)

    def _anchors(self, fh: int, fw: int, device) -> torch.Tensor:
        net = self.cfg.network
        return torch.from_numpy(
            shifted_anchors(fh, fw, net.RPN_FEAT_STRIDE, ratios=net.ANCHOR_RATIOS,
                            scales=net.ANCHOR_SCALES)
        ).to(device)

    # ------------------------------------------------------------------ train
    def train_forward(
        self,
        images: torch.Tensor,
        im_info: torch.Tensor,
        gt_boxes: torch.Tensor,
        gt_valid: torch.Tensor,
        sample_seeds: Optional[Iterable[int]] = None,
        rng: int = 0,
        draws: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(B, H, W, 3) normalized images, (B, 3) im_info, (B, G, 5) padded
        gt boxes and (B, G) ``gt_valid`` → (total loss, aux metrics).

        The samplers take ``draws`` (the five (B, n) uniforms of
        :data:`DRAW_NAMES`) when given, else :func:`sampling_uniforms` of
        ``rng`` and the per-image ``sample_seeds`` (the image index when
        None)."""
        cfg = self.cfg
        net, t = cfg.network, cfg.TRAIN
        b = images.shape[0]

        feat = self.backbone(images.permute(0, 3, 1, 2))
        rpn_logits, rpn_deltas = self.rpn(feat)                # (B, N, 2/4)
        anchors = self._anchors(feat.shape[2], feat.shape[3], images.device)

        # proposals from detached outputs: the reference's proposal op has
        # no backward
        fg_scores = torch.softmax(rpn_logits, dim=-1)[..., 1]
        props = propose(
            fg_scores.detach(), rpn_deltas.detach(), anchors, im_info,
            t.RPN_PRE_NMS_TOP_N, t.RPN_POST_NMS_TOP_N, t.RPN_NMS_THRESH, t.RPN_MIN_SIZE,
        )
        if draws is None:
            seeds = range(b) if sample_seeds is None else sample_seeds
            draws = sampling_uniforms(
                rng, seeds, anchors.shape[0], props.rois.shape[1] + gt_boxes.shape[1],
                images.device,
            )
        atgt = assign_anchor(
            anchors, gt_boxes, gt_valid, im_info, cfg, u=(draws["anchor_fg"], draws["anchor_bg"])
        )
        samples = sample_rois(
            props.rois, props.valid, gt_boxes, gt_valid, cfg,
            u=(draws["roi_fg"], draws["roi_bg"], draws["roi_tie"]),
        )

        # second stage: ROIAlign clamped to the canvas (no valid_hw)
        pooled = extract_roi_features_batched(
            feat.permute(0, 2, 3, 1), samples.rois, net.ROI_MODE, net.POOLED_SIZE,
            1.0 / net.RCNN_FEAT_STRIDE, net.ROI_SAMPLE_RATIO,
        )
        r = pooled.shape[1]
        trunk = self.top_head(pooled.reshape((b * r,) + pooled.shape[2:]).permute(0, 3, 1, 2))
        cls_logits, bbox_pred_out = self.rcnn(trunk)           # (B·R, K), (B·R, 4K)

        labels = samples.labels.reshape(-1)
        bbox_targets = samples.bbox_targets.reshape(bbox_pred_out.shape)
        bbox_weights = samples.bbox_weights.reshape(bbox_pred_out.shape)
        anchor_labels = atgt.labels.reshape(-1)

        rpn_norm = float(t.RPN_BATCH_SIZE * b)
        rcnn_norm = float(t.BATCH_ROIS * b)
        rpn_cls_loss = softmax_cross_entropy(rpn_logits.reshape(-1, 2), anchor_labels, -1, rpn_norm)
        rpn_bbox_loss = weighted_smooth_l1(
            rpn_deltas.reshape(-1, 4), atgt.bbox_targets.reshape(-1, 4),
            atgt.bbox_weights.reshape(-1, 4), sigma=3.0, norm=rpn_norm,
        )
        rcnn_cls_loss = softmax_cross_entropy(cls_logits, labels, -1, rcnn_norm)
        rcnn_bbox_loss = weighted_smooth_l1(
            bbox_pred_out, bbox_targets, bbox_weights, sigma=1.0, norm=rcnn_norm
        )
        total = rpn_cls_loss + rpn_bbox_loss + rcnn_cls_loss + rcnn_bbox_loss
        aux = {
            "RPNAcc": accuracy(rpn_logits.reshape(-1, 2), anchor_labels),
            "RPNLogLoss": rpn_cls_loss,
            "RPNL1Loss": rpn_bbox_loss,
            "RCNNAcc": accuracy(cls_logits, labels),
            "RCNNLogLoss": rcnn_cls_loss,
            "RCNNL1Loss": rcnn_bbox_loss,
            "num_fg_rois": (labels > 0).sum(),
            "num_valid_props": props.valid.sum(),
            "num_fg_anchors": (anchor_labels == 1).sum(),
        }
        return total, aux

    def test_forward(self, images: torch.Tensor, im_info: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) normalized images + (B, 3) im_info → padded per-image
        ``rois``, ``roi_scores``, ``roi_valid``, ``cls_prob`` and
        de-normalized ``bbox_deltas``."""
        cfg = self.cfg
        net, te = cfg.network, cfg.TEST
        b = images.shape[0]
        pad_mask = make_pad_mask(im_info, (images.shape[1], images.shape[2]))
        # NHWC → an NCHW view (channels_last memory, no copy)
        feat = pad_mask(self.backbone(images.permute(0, 3, 1, 2), pad_mask))
        rpn_logits, rpn_deltas = self.rpn(feat)
        fh, fw = feat.shape[2], feat.shape[3]
        anchors = self._anchors(fh, fw, images.device)

        fg_scores = torch.softmax(rpn_logits, dim=-1)[..., 1]
        # anchors on bucket padding would make the pre-NMS top-k depend on
        # the bucket: drop them
        grid_ok = anchor_grid_mask(((fh, fw),), (net.RPN_FEAT_STRIDE,), net.NUM_ANCHORS, im_info)
        fg_scores = torch.where(grid_ok, fg_scores, _NEG_INF)
        props = propose(
            fg_scores, rpn_deltas, anchors, im_info, te.RPN_PRE_NMS_TOP_N,
            te.RPN_POST_NMS_TOP_N, te.RPN_NMS_THRESH, te.RPN_MIN_SIZE,
        )

        # one ladder-wide shape into ROIAlign for every bucket
        feat = pad_feat_to_ladder(feat.permute(0, 2, 3, 1), net.RCNN_FEAT_STRIDE, cfg.SHAPE_BUCKETS)
        pooled = extract_roi_features_batched(
            feat, props.rois, net.ROI_MODE, net.POOLED_SIZE, 1.0 / net.RCNN_FEAT_STRIDE,
            net.ROI_SAMPLE_RATIO, valid_hw=im_info[:, :2],
        )
        r = pooled.shape[1]
        # (B·R, ph, pw, C) → NCHW view, channels_last memory
        trunk = self.top_head(pooled.reshape((b * r,) + pooled.shape[2:]).permute(0, 3, 1, 2))
        cls_logits, bbox_deltas = self.rcnn(trunk)
        k = cfg.dataset.NUM_CLASSES
        means, stds = bbox_denorm_vectors(cfg, k, images.device)
        bbox_deltas = bbox_deltas * stds + means
        return {
            "rois": props.rois,                                   # (B, R, 4)
            "roi_scores": props.scores,                           # (B, R)
            "roi_valid": props.valid,                             # (B, R)
            "cls_prob": torch.softmax(cls_logits, dim=-1).reshape(b, r, k),
            "bbox_deltas": bbox_deltas.reshape(b, r, 4 * k),
        }
