"""Feature Pyramid Network Faster R-CNN and Mask R-CNN (port of
``mx_rcnn_tpu/models/fpn.py``): the training forward ``train_forward`` and
the inference forward ``test_forward``, each with the mask branch of a mask
model, and ``mask_iou_probe``, in the JAX graph's order.

normalize → ResNet C2..C5 → neck (1×1 laterals, nearest top-down adds, 3×3
smoothing) → P2..P5, P6 = P5 at stride 2 → one shared RPN head on every
level, levels concatenated P2→P6 against one anchor table → per-level top-k
of the fg scores, one NMS over their union → ROIAlign of every roi from each
of P2..P5, each blended in by the roi's level (``roi_levels``) → 2-fc head →
RCNN head.  Training adds anchor targets, roi sampling and the four losses;
a mask model adds the mask loss on the first FG_FRACTION·BATCH_ROIS sampled
slots (fg first): those rois pooled again at 14×14, the mask head, targets
resampled from the gt masks (``ops/mask_targets.py``) and the sigmoid BCE on
the label's channel.
Inference masks the bucket padding through the backbone, the neck and every
level, drops anchors on padding, pads P2..P5 to the bucket ladder and pools
with ``valid_hw``; a mask model pools the same rois again at 14×14 for the
mask head (per-class 28×28 logits).

The ROIAlign routes as the JAX package's does (``ops/roi_align.py``): in
training at the 608×1024 canvas P2 and P3 go to the streamed kernels 4/5,
P4 and P5 to the resident kernels 2/3, for the box and the mask branch
alike; inference (``valid_hw``) pools every level with kernel 2.  The NMS is
kernel 1.  Frozen-proposal training (the batch's ``proposals`` /
``prop_valid``) samples the RCNN and mask branches from the given proposals
instead of the RPN's, while the RPN losses still train the RPN: that step
runs no NMS.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.models.faster_rcnn import (
    FasterRCNN,
    init_weights,
    sampling_uniforms,
    train_losses,
)
from mx_rcnn_tpu_torch.models.heads import MaskHead, RCNNHead
from mx_rcnn_tpu_torch.models.layers import (
    conv,
    make_pad_mask,
    normalize_images,
    pad_feat_to_ladder,
)
from mx_rcnn_tpu_torch.models.resnet import ResNetBackbone
from mx_rcnn_tpu_torch.models.rpn import RPNHead
from mx_rcnn_tpu_torch.ops.anchors import shifted_anchors
from mx_rcnn_tpu_torch.ops.boxes import bbox_pred, clip_boxes
from mx_rcnn_tpu_torch.ops.losses import select_class, sigmoid_bce
from mx_rcnn_tpu_torch.ops.mask_targets import crop_resize_masks, rasterize_box_masks
from mx_rcnn_tpu_torch.ops.nms import _NEG_INF, nms
from mx_rcnn_tpu_torch.ops.proposal import Proposals, anchor_grid_mask
from mx_rcnn_tpu_torch.ops.roi_align import extract_roi_features_batched
from mx_rcnn_tpu_torch.ops.targets import assign_anchor, sample_rois

# C2..C5 channels of a ResNet-50/101 bottleneck backbone
PYRAMID_CHANNELS = (256, 512, 1024, 2048)


def _identity(x):
    return x


class FPNNeck(nn.Module):
    """C2..C5 (NCHW) → P2..P5: 1×1 ``lateral2..5`` and 3×3 ``post2..5``,
    both with bias, and nearest-neighbour top-down adds.

    ``jax.image.resize(..., "nearest")`` samples at half-pixel centres,
    ``floor((i + 0.5)·in/out)``: torch's ``nearest-exact``, which agrees with
    ``nearest`` only where each level is exactly twice the next."""

    def __init__(self, in_channels: Sequence[int] = PYRAMID_CHANNELS, channels: int = 256):
        super().__init__()
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral{i + 2}", conv(cin, channels, 1, bias=True))
        for i in range(len(in_channels)):
            self.add_module(f"post{i + 2}", conv(channels, channels, 3, bias=True))

    def forward(self, feats: Sequence[torch.Tensor], pad_mask=_identity) -> List[torch.Tensor]:
        # pad_mask (layers.make_pad_mask): re-zero bucket padding before the
        # 3×3 smoothing convs, as the JAX neck does for serving
        laterals = [getattr(self, f"lateral{i + 2}")(c) for i, c in enumerate(feats)]
        outs = [laterals[-1]]
        for lat in reversed(laterals[:-1]):
            up = F.interpolate(outs[0], size=lat.shape[-2:], mode="nearest-exact")
            outs.insert(0, lat + up)
        return [getattr(self, f"post{i + 2}")(pad_mask(p)) for i, p in enumerate(outs)]


class FPNTopHead(nn.Module):
    """2-fc box head: (R, ph, pw, C) pooled rois → (R, width).

    The NHWC rois flatten as they are: Flax's ``fc1`` kernel is
    (ph·pw·C, width) in (ph, pw, C) order, so the bridged weights need
    no permute."""

    def __init__(self, din: int, width: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(din, width)
        self.fc2 = nn.Linear(width, width)

    def forward(self, rois_feat: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc1(rois_feat.reshape(rois_feat.shape[0], -1)))
        return F.relu(self.fc2(x))


_CANONICAL: Dict = {}


def roi_levels(rois: torch.Tensor, k0: int = 4, canonical: float = 224.0,
               lo: int = 2, hi: int = 5) -> torch.Tensor:
    """(…, 4) boxes → FPN level in [lo, hi] (Lin et al. eq. 1), int32, in
    the JAX function's float32 op order."""
    w = torch.clamp_min(rois[..., 2] - rois[..., 0] + 1.0, 1.0)
    h = torch.clamp_min(rois[..., 3] - rois[..., 1] + 1.0, 1.0)
    # a device tensor divisor: IEEE division (CUDA multiplies by the
    # reciprocal of a Python scalar); built once per device, since a copy
    # from host memory in every call would make the host wait for the card
    key = (canonical, w.dtype, w.device)
    if key not in _CANONICAL:
        _CANONICAL[key] = torch.tensor(canonical, dtype=w.dtype, device=w.device)
    k = torch.floor(k0 + torch.log2(torch.sqrt(w * h) / _CANONICAL[key]))
    return torch.clamp(k, lo, hi).to(torch.int32)


def mask_bce(logits: torch.Tensor, labels: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(B, R, S, S, K) mask logits, (B, R) roi labels, (B, R, S, S) targets
    → the sigmoid BCE on each roi's label channel, averaged over its cells,
    summed over the fg rois and divided by max(#fg, 1)."""
    fg = labels > 0
    sel = select_class(logits, labels.clamp_min(0)[..., None, None])
    per_roi = sigmoid_bce(sel, targets).mean(dim=(-1, -2))              # (B, R)
    return (per_roi * fg).sum() / fg.float().sum().clamp_min(1.0)


class FPNFasterRCNN(nn.Module):
    """Multi-level two-stage detector (``generate_config("resnet_fpn", …)``,
    and ``"mask_resnet_fpn"`` with the mask head) with
    :class:`~mx_rcnn_tpu_torch.models.faster_rcnn.FasterRCNN`'s contracts:
    ``forward(..., train=True)`` → (loss, aux), ``forward(...)`` → the
    padded inference outputs (plus ``mask_logits`` for a mask model)."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        net = cfg.network
        if not net.USE_FPN:
            raise ValueError("FPNFasterRCNN needs a USE_FPN config")
        if net.name != "resnet":
            raise NotImplementedError(f"network {net.name!r} is not ported yet")
        if net.COMPUTE_DTYPE != "float32" or net.FOLD_BN:
            raise NotImplementedError("only the float32, unfolded-BN graph is ported")
        self.cfg = cfg
        ch = net.FPN_CHANNELS
        self.backbone = ResNetBackbone(net.depth, return_pyramid=True)
        self.neck = FPNNeck(PYRAMID_CHANNELS, ch)
        # one RPN head shared across levels
        self.rpn = RPNHead(ch, len(net.ANCHOR_RATIOS) * len(net.FPN_ANCHOR_SCALES), ch)
        self.top_head = FPNTopHead(ch * net.POOLED_SIZE[0] * net.POOLED_SIZE[1])
        self.rcnn = RCNNHead(self.top_head.fc2.out_features, cfg.dataset.NUM_CLASSES)
        if net.USE_MASK:
            self.mask_head = MaskHead(ch, cfg.dataset.NUM_CLASSES)
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        # constants of the graph, built once per (device, shape), as in
        # FasterRCNN
        self._constants: Dict = {}

    _bbox_denorm = FasterRCNN._bbox_denorm

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
        gt_masks: Optional[torch.Tensor] = None,
        proposals: Optional[torch.Tensor] = None,
        prop_valid: Optional[torch.Tensor] = None,
    ):
        images = normalize_images(images, im_info, self.cfg)
        if not train:
            return self.test_forward(images, im_info)
        return self.train_forward(images, im_info, gt_boxes, gt_valid, sample_seeds, rng, draws,
                                  gt_masks, proposals, prop_valid)

    # ----------------------------------------------------------- helpers
    def _pyramid(self, images: torch.Tensor, pad_mask=_identity) -> List[torch.Tensor]:
        """(B, H, W, 3) → [P2, P3, P4, P5, P6], NCHW.  P6 is the JAX
        package's 1×1 max pool at stride 2 of P5: every other cell, which
        mixes nothing spatially and so needs no mask of its own."""
        ps = self.neck(self.backbone(images.permute(0, 3, 1, 2), pad_mask), pad_mask)
        return ps + [ps[-1][:, :, ::2, ::2]]

    def _anchors(self, shapes: Tuple[Tuple[int, int], ...], device) -> torch.Tensor:
        """The levels' anchors concatenated P2→P6, (N, 4), built once per
        (level shapes, device)."""
        key = ("anchors", shapes, torch.device(device))
        if key not in self._constants:
            net = self.cfg.network
            self._constants[key] = torch.from_numpy(np.concatenate([
                shifted_anchors(h, w, stride, ratios=net.ANCHOR_RATIOS,
                                scales=net.FPN_ANCHOR_SCALES)
                for (h, w), stride in zip(shapes, net.FPN_FEAT_STRIDES)
            ], axis=0)).to(device)
        return self._constants[key]

    def _rpn_over_levels(self, pyramid: Sequence[torch.Tensor]):
        """The shared RPN on each level → logits (B, N, 2) and deltas
        (B, N, 4) concatenated P2→P6, the (N, 4) anchor table and the
        levels' bounds in it."""
        outs = [self.rpn(p) for p in pyramid]
        shapes = tuple((p.shape[2], p.shape[3]) for p in pyramid)
        bounds = np.cumsum([0] + [lg.shape[1] for lg, _ in outs]).tolist()
        return (
            torch.cat([lg for lg, _ in outs], dim=1),
            torch.cat([dl for _, dl in outs], dim=1),
            self._anchors(shapes, pyramid[0].device),
            bounds,
        )

    @staticmethod
    def _propose_multilevel(
        fg_scores: torch.Tensor,
        deltas: torch.Tensor,
        anchors: torch.Tensor,
        bounds: Sequence[int],
        im_info: torch.Tensor,
        pre_per_level: int,
        post_nms: int,
        nms_thresh: float,
        min_size: float,
    ) -> Proposals:
        """(B, N) fg scores + (B, N, 4) deltas → per-level top
        ``pre_per_level`` → one NMS over their union (kernel 1, unsorted
        contract) → ``post_nms`` padded proposals per image.  The per-level
        selection is a stable descending sort, which orders ties as
        ``lax.top_k`` does."""
        h, w, scale = im_info[:, 0], im_info[:, 1], im_info[:, 2]
        boxes = clip_boxes(bbox_pred(anchors, deltas), h, w)
        ms = (min_size * scale)[:, None]
        ws = boxes[..., 2] - boxes[..., 0] + 1.0
        hs = boxes[..., 3] - boxes[..., 1] + 1.0
        scores = torch.where((ws >= ms) & (hs >= ms), fg_scores, _NEG_INF)

        top_scores, top_boxes = [], []
        for a, b in zip(bounds[:-1], bounds[1:]):
            k = min(pre_per_level, b - a)
            ts, idx = torch.sort(scores[:, a:b], dim=1, descending=True, stable=True)
            idx = idx[:, :k]
            top_scores.append(ts[:, :k])
            top_boxes.append(torch.gather(boxes[:, a:b], 1, idx[..., None].expand(idx.shape + (4,))))
        cat_scores = torch.cat(top_scores, dim=1)
        out = nms(torch.cat(top_boxes, dim=1), cat_scores, nms_thresh, post_nms,
                  cat_scores > _NEG_INF / 2)
        return Proposals(*out)

    def _level_pooled(self, feats: Sequence[torch.Tensor], rois: torch.Tensor, pooled_size,
                      fwd_only: bool = False, valid_hw: Optional[torch.Tensor] = None):
        """(B, R, 4) rois → (B·R, ph, pw, C): every roi pooled from each of
        the NHWC maps P2..P5 and kept where its level matches (4× the
        pooling work, one static graph, as the JAX package does)."""
        net = self.cfg.network
        levels = roi_levels(rois)[..., None, None, None]       # (B, R, 1, 1, 1)
        pooled = None
        for li, stride in enumerate(net.FPN_FEAT_STRIDES[:4]):
            got = extract_roi_features_batched(
                feats[li], rois, "roi_align", pooled_size, 1.0 / stride, net.ROI_SAMPLE_RATIO,
                fwd_only=fwd_only, valid_hw=valid_hw,
            )                                                   # (B, R, ph, pw, C)
            contrib = torch.where(levels == li + 2, got, 0.0)
            pooled = contrib if pooled is None else pooled + contrib
        b, r = pooled.shape[0], pooled.shape[1]
        return pooled.reshape((b * r,) + pooled.shape[2:])

    def _roi_features(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                      fwd_only: bool = False, valid_hw: Optional[torch.Tensor] = None):
        """(B, R, 4) rois → (B·R, 1024) head features from the NHWC maps
        P2..P5."""
        return self.top_head(self._level_pooled(
            feats, rois, self.cfg.network.POOLED_SIZE, fwd_only, valid_hw))

    def _mask_forward(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                      valid_hw: Optional[torch.Tensor] = None,
                      fwd_only: bool = True) -> torch.Tensor:
        """(B, R, 4) rois → (B, R, 28, 28, K) per-class mask logits: the rois
        pooled again at 14×14 (JAX's ``_mask_pooled``), then the mask head.
        The training branch pools with ``fwd_only`` off, so the backward
        runs through ROIAlign's kernels 3 and 5."""
        b, r = rois.shape[0], rois.shape[1]
        pooled = self._level_pooled(feats, rois, (14, 14), fwd_only, valid_hw)
        # (B·R, 14, 14, C) → NCHW view, channels_last memory; the logits
        # come back channels_last, so the NHWC permute is a view
        logits = self.mask_head(pooled.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return logits.reshape((b, r) + logits.shape[1:])

    def _mask_loss(self, feats: Sequence[torch.Tensor], samples, gt_boxes: torch.Tensor,
                   gt_masks: Optional[torch.Tensor] = None):
        """Per-fg-roi sigmoid BCE against the matched gt's mask on the roi's
        28×28 grid → (loss, ``{"MaskBCELoss": loss}``).

        Only the first ``nfg = min(round(FG_FRACTION·BATCH_ROIS), R)``
        sampled slots enter: ``sample_rois`` packs fg first within that
        quota, so every fg roi is there and the bg rows that pad it weigh
        nothing.  The matched gt is ``samples.gt_index``, the assignment the
        roi's label came from.  Targets: with ``gt_masks`` (B, G, M, M)
        box-frame bitmaps, the matched bitmap resampled under the roi grid
        and binarized at 0.5; without, the matched gt's rectangle.  The BCE
        on the label's channel is averaged per roi, kept on fg rois and
        divided by max(#fg, 1).  ``nfg`` is a Python int: no host sync."""
        t = self.cfg.TRAIN
        nfg = min(int(round(t.FG_FRACTION * t.BATCH_ROIS)), samples.rois.shape[1])
        m_rois, m_labels = samples.rois[:, :nfg], samples.labels[:, :nfg]
        logits = self._mask_forward(feats, m_rois, fwd_only=False)    # (B, R, S, S, K)
        targets = self._mask_targets(m_rois, samples.gt_index[:, :nfg], gt_boxes, gt_masks)
        loss = mask_bce(logits, m_labels, targets)
        return loss, {"MaskBCELoss": loss}

    def _mask_targets(self, rois: torch.Tensor, gt_index: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, R, 4) rois and their matched gt slots (B, R) → (B, R, S, S)
        {0, 1} float32 targets: the matched bitmap of ``gt_masks`` resampled
        and binarized at 0.5, or without ``gt_masks`` the matched box."""
        size = self.cfg.TRAIN.MASK_SIZE
        b, r = rois.shape[0], rois.shape[1]
        gi = gt_index.long()
        matched = torch.gather(gt_boxes[..., :4], 1, gi[..., None].expand(b, r, 4))
        if gt_masks is None:
            return rasterize_box_masks(rois, matched, size)
        m = gt_masks.shape[-1]
        bitmaps = torch.gather(gt_masks, 1, gi[..., None, None].expand(b, r, m, m))
        return (crop_resize_masks(rois, matched, bitmaps, size) >= 0.5).float()

    @torch.no_grad()
    def mask_iou_probe(self, images: torch.Tensor, im_info: torch.Tensor, gt_boxes: torch.Tensor,
                       gt_valid: torch.Tensor, gt_masks: torch.Tensor):
        """Mask quality without the detector in the way: the masks predicted
        at the gt boxes for the gt classes (no RPN, no scoring, no NMS),
        thresholded at logit 0, against the gt bitmaps resampled onto the
        same 28×28 grid → (IoU (B, G) float32, ``gt_valid``).  A head that
        paints rectangles scores the shapes' box occupancy (ellipse ≈ 0.785,
        triangle ≈ 0.5)."""
        size = self.cfg.TRAIN.MASK_SIZE
        images = normalize_images(images, im_info, self.cfg)
        feats = [p.permute(0, 2, 3, 1) for p in self._pyramid(images)[:4]]
        boxes = gt_boxes[..., :4]
        logits = self._mask_forward(feats, boxes)                       # (B, G, S, S, K)
        cls = gt_boxes[..., 4].to(torch.int32).clamp_min(0)
        pred = select_class(logits, cls[..., None, None]) > 0.0
        target = crop_resize_masks(boxes, boxes, gt_masks, size) >= 0.5
        inter = (pred & target).sum(dim=(-1, -2)).float()
        union = (pred | target).sum(dim=(-1, -2)).float()
        return inter / union.clamp_min(1.0), gt_valid

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
        gt_masks: Optional[torch.Tensor] = None,
        proposals: Optional[torch.Tensor] = None,
        prop_valid: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(B, H, W, 3) normalized images, (B, 3) im_info, (B, G, 5) padded
        gt boxes and (B, G) ``gt_valid`` → (total loss, aux metrics), with
        the samplers' uniforms as in ``FasterRCNN.train_forward`` (over the
        concatenated anchor table).  A mask model adds ``_mask_loss``
        (``gt_masks``: (B, G, M, M) uint8 box-frame bitmaps, or None for
        rectangle targets) and its ``MaskBCELoss``.

        Frozen-proposal mode (the reference's ROIIter role): with
        ``proposals`` (B, P, 4) and ``prop_valid`` (B, P) the RCNN and mask
        branches sample from those, in the resized image's coordinates, and
        no proposal NMS runs; the RPN losses still train the RPN, but its
        drift no longer reshuffles the roi labels step to step."""
        cfg = self.cfg
        t = cfg.TRAIN
        b = images.shape[0]
        pyramid = self._pyramid(images)
        rpn_logits, rpn_deltas, anchors, bounds = self._rpn_over_levels(pyramid)

        if proposals is not None:
            if prop_valid is None:
                raise ValueError("frozen-proposal mode needs prop_valid alongside proposals "
                                 "(a padded-count validity mask)")
            prop_boxes = proposals
        else:
            # proposals from detached outputs: the reference's proposal op
            # has no backward
            fg_scores = torch.softmax(rpn_logits, dim=-1)[..., 1]
            pre_per_level = max(t.RPN_PRE_NMS_TOP_N // (len(bounds) - 1), 256)
            prop_boxes, _, prop_valid = self._propose_multilevel(
                fg_scores.detach(), rpn_deltas.detach(), anchors, bounds, im_info, pre_per_level,
                t.RPN_POST_NMS_TOP_N, t.RPN_NMS_THRESH, t.RPN_MIN_SIZE,
            )
        if draws is None:
            seeds = range(b) if sample_seeds is None else sample_seeds
            draws = sampling_uniforms(
                rng, seeds, anchors.shape[0], prop_boxes.shape[1] + gt_boxes.shape[1],
                images.device,
            )
        atgt = assign_anchor(
            anchors, gt_boxes, gt_valid, im_info, cfg, u=(draws["anchor_fg"], draws["anchor_bg"])
        )
        samples = sample_rois(
            prop_boxes, prop_valid, gt_boxes, gt_valid, cfg,
            u=(draws["roi_fg"], draws["roi_bg"], draws["roi_tie"]),
        )

        feats = [p.permute(0, 2, 3, 1) for p in pyramid[:4]]
        cls_logits, bbox_pred_out = self.rcnn(self._roi_features(feats, samples.rois))
        total, aux = train_losses(
            cfg, rpn_logits, rpn_deltas, atgt, samples, prop_valid, cls_logits, bbox_pred_out
        )
        if cfg.network.USE_MASK:
            mask_loss, mask_aux = self._mask_loss(feats, samples, gt_boxes, gt_masks)
            total = total + mask_loss
            aux.update(mask_aux)
        return total, aux

    # ------------------------------------------------------------------ test
    def test_forward(self, images: torch.Tensor, im_info: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) normalized images + (B, 3) im_info → padded per-image
        ``rois``, ``roi_scores``, ``roi_valid``, ``cls_prob`` and
        de-normalized ``bbox_deltas``, and for a mask model ``mask_logits``
        (B, R, 28, 28, K)."""
        cfg = self.cfg
        net, te = cfg.network, cfg.TEST
        b = images.shape[0]
        k = cfg.dataset.NUM_CLASSES
        # bucket padding masked through the backbone and the neck and on
        # every level before the shared RPN's 3×3 conv
        pad_mask = make_pad_mask(im_info, (images.shape[1], images.shape[2]))
        pyramid = [pad_mask(p) for p in self._pyramid(images, pad_mask)]
        rpn_logits, rpn_deltas, anchors, bounds = self._rpn_over_levels(pyramid)
        fg_scores = torch.softmax(rpn_logits, dim=-1)[..., 1]
        # anchors on bucket padding, level by level, would make the top-k
        # depend on the bucket: drop them
        shapes = tuple((p.shape[2], p.shape[3]) for p in pyramid)
        a_per_cell = len(net.ANCHOR_RATIOS) * len(net.FPN_ANCHOR_SCALES)
        grid_ok = anchor_grid_mask(shapes, net.FPN_FEAT_STRIDES, a_per_cell, im_info)
        fg_scores = torch.where(grid_ok, fg_scores, _NEG_INF)
        pre_per_level = max(te.RPN_PRE_NMS_TOP_N // (len(bounds) - 1), 256)
        props = self._propose_multilevel(
            fg_scores, rpn_deltas, anchors, bounds, im_info, pre_per_level,
            te.RPN_POST_NMS_TOP_N, te.RPN_NMS_THRESH, te.RPN_MIN_SIZE,
        )

        # one ladder-wide shape per level into ROIAlign for every bucket;
        # P6 feeds only the RPN
        feats = [pad_feat_to_ladder(p.permute(0, 2, 3, 1), stride, cfg.SHAPE_BUCKETS)
                 for p, stride in zip(pyramid[:4], net.FPN_FEAT_STRIDES[:4])]
        valid_hw = im_info[:, :2]
        cls_logits, bbox_deltas = self.rcnn(
            self._roi_features(feats, props.rois, fwd_only=True, valid_hw=valid_hw))
        r = props.rois.shape[1]
        means, stds = self._bbox_denorm(images.device)
        bbox_deltas = bbox_deltas * stds + means
        out = {
            "rois": props.rois,                                   # (B, R, 4)
            "roi_scores": props.scores,                           # (B, R)
            "roi_valid": props.valid,                             # (B, R)
            "cls_prob": torch.softmax(cls_logits, dim=-1).reshape(b, r, k),
            "bbox_deltas": bbox_deltas.reshape(b, r, 4 * k),
        }
        if net.USE_MASK:
            out["mask_logits"] = self._mask_forward(feats, props.rois, valid_hw)
        return out
