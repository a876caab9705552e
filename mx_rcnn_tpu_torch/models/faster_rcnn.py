"""Faster R-CNN, ResNet C4 (port of ``mx_rcnn_tpu/models/faster_rcnn.py``):
the inference forward ``test_forward`` and the training forward
``train_forward``, in the JAX graph's order, in the config's compute dtype
(COMPUTE_DTYPE) with the frozen BNs folded into the convs or not (FOLD_BN).

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
    compute_dtype,
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
    rng: int, sample_seeds: Iterable[int], n_anchors: int, n_cand: int, device,
    names: Tuple[str, ...] = DRAW_NAMES,
) -> Dict[str, torch.Tensor]:
    """The samplers' uniforms for a batch: image i's come from a generator
    seeded with ``fold_in(rng, sample_seeds[i])``, so they depend only on
    the step's seed and the image, never on the batch around it (the JAX
    package's per-image ``sample_seeds`` keys).  ``names``: the draws the
    graph takes, in :data:`DRAW_NAMES`' order (a stage model's sampler
    takes only the anchor or only the roi draws)."""
    rows = {k: [] for k in names}
    for seed in sample_seeds:
        gen = torch.Generator(device=device).manual_seed(fold_in(rng, int(seed)))
        for k in names:
            n = n_anchors if k.startswith("anchor") else n_cand
            rows[k].append(torch.rand(n, generator=gen, device=device))
    return {k: torch.stack(v) for k, v in rows.items()}


def rpn_losses(cfg: Config, rpn_logits, rpn_deltas, atgt) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The RPN's two losses, summed, and their aux metrics under the JAX
    train_forward's names, from the RPN outputs (B, N, 2/4) and the anchor
    targets."""
    labels = atgt.labels.reshape(-1)
    norm = float(cfg.TRAIN.RPN_BATCH_SIZE * rpn_logits.shape[0])
    cls_loss = softmax_cross_entropy(rpn_logits.reshape(-1, 2), labels, -1, norm)
    bbox_loss = weighted_smooth_l1(
        rpn_deltas.reshape(-1, 4), atgt.bbox_targets.reshape(-1, 4),
        atgt.bbox_weights.reshape(-1, 4), sigma=3.0, norm=norm,
    )
    aux = {
        "RPNAcc": accuracy(rpn_logits.reshape(-1, 2), labels),
        "RPNLogLoss": cls_loss,
        "RPNL1Loss": bbox_loss,
        # 0 means no anchor fits inside the image: the loss is then 0
        "num_fg_anchors": (labels == 1).sum(),
    }
    return cls_loss + bbox_loss, aux


def rcnn_losses(cfg: Config, samples, cls_logits, bbox_pred_out) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The RCNN head's two losses, summed, and their aux metrics, from the
    sampled rois of B images and the head's (B·R, K) / (B·R, 4K) outputs."""
    labels = samples.labels.reshape(-1)
    norm = float(cfg.TRAIN.BATCH_ROIS * samples.labels.shape[0])
    cls_loss = softmax_cross_entropy(cls_logits, labels, -1, norm)
    bbox_loss = weighted_smooth_l1(
        bbox_pred_out, samples.bbox_targets.reshape(bbox_pred_out.shape),
        samples.bbox_weights.reshape(bbox_pred_out.shape), sigma=1.0, norm=norm,
    )
    aux = {
        "RCNNAcc": accuracy(cls_logits, labels),
        "RCNNLogLoss": cls_loss,
        "RCNNL1Loss": bbox_loss,
        "num_fg_rois": (labels > 0).sum(),
    }
    return cls_loss + bbox_loss, aux


def train_losses(
    cfg: Config, rpn_logits, rpn_deltas, atgt, samples, prop_valid, cls_logits, bbox_pred_out,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The train step's four losses, summed, and its aux metrics
    (:func:`rpn_losses`, :func:`rcnn_losses` and the proposals' (B, P)
    validity count)."""
    rpn_loss, rpn_aux = rpn_losses(cfg, rpn_logits, rpn_deltas, atgt)
    rcnn_loss, rcnn_aux = rcnn_losses(cfg, samples, cls_logits, bbox_pred_out)
    return rpn_loss + rcnn_loss, {**rpn_aux, **rcnn_aux, "num_valid_props": prop_valid.sum()}


# Flax's initializer for each Dense kernel that is not the nn.Dense default
# (lecun_normal): the RCNN head's (models/heads.py)
_DENSE_STD = {"cls_score": 0.01, "bbox_pred": 0.001}


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax's lecun_normal: a normal truncated at ±2σ, scaled so the
    variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init with each layer's Flax initializer, drawn from
    ``generator``: lecun_normal (truncated, fan-in) for conv kernels (the
    mask head's transposed one too) and
    Dense kernels (``nn.Dense``'s default, e.g. the FPN head's ``fc1`` and
    ``fc2``), Normal(0.01) for ``cls_score`` and Normal(0.001) for
    ``bbox_pred`` (models/heads.py), zero biases, identity frozen BN (the
    buffers' defaults)."""
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            # Flax's fan-in of an HWIO kernel, transposed ones included
            _lecun_normal_(m.weight, m.in_channels * m.kernel_size[0] * m.kernel_size[1], generator)
        elif isinstance(m, nn.Linear):
            std = _DENSE_STD.get(name.rsplit(".", 1)[-1])
            if std is None:
                _lecun_normal_(m.weight, m.in_features, generator)
            else:
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
            raise NotImplementedError("USE_MASK: the mask family is not ported yet")
        if net.name != "resnet":
            raise NotImplementedError(f"network {net.name!r} is not ported yet")
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.backbone = ResNetBackbone(net.depth, dtype=dtype, fold_bn=net.FOLD_BN)
        self.top_head = ResNetTopHead(net.depth, dtype, net.FOLD_BN)
        self.rpn = RPNHead(1024, net.NUM_ANCHORS, 512, dtype)
        self.rcnn = RCNNHead(2048, cfg.dataset.NUM_CLASSES, dtype)
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        # constants of the graph, built once per (device, shape): a copy from
        # host memory in every forward would make the host wait for the card
        # (JAX folds them into the executable)
        self._constants: Dict = {}

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
        key = ("anchors", fh, fw, torch.device(device))
        if key not in self._constants:
            net = self.cfg.network
            self._constants[key] = torch.from_numpy(
                shifted_anchors(fh, fw, net.RPN_FEAT_STRIDE, ratios=net.ANCHOR_RATIOS,
                                scales=net.ANCHOR_SCALES)
            ).to(device)
        return self._constants[key]

    def _bbox_denorm(self, device):
        key = ("bbox_denorm", torch.device(device))
        if key not in self._constants:
            self._constants[key] = bbox_denorm_vectors(
                self.cfg, self.cfg.dataset.NUM_CLASSES, device)
        return self._constants[key]

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

        return train_losses(
            cfg, rpn_logits, rpn_deltas, atgt, samples, props.valid, cls_logits, bbox_pred_out
        )

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
        means, stds = self._bbox_denorm(images.device)
        bbox_deltas = bbox_deltas * stds + means
        return {
            "rois": props.rois,                                   # (B, R, 4)
            "roi_scores": props.scores,                           # (B, R)
            "roi_valid": props.valid,                             # (B, R)
            "cls_prob": torch.softmax(cls_logits, dim=-1).reshape(b, r, k),
            "bbox_deltas": bbox_deltas.reshape(b, r, 4 * k),
        }
