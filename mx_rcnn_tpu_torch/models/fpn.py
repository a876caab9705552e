"""Feature Pyramid Network Faster R-CNN, box-only (port of
``mx_rcnn_tpu/models/fpn.py``): the training forward ``train_forward``, in
the JAX graph's order.

normalize → ResNet C2..C5 → neck (1×1 laterals, nearest top-down adds, 3×3
smoothing) → P2..P5, P6 = P5 at stride 2 → one shared RPN head on every
level, levels concatenated P2→P6 against one anchor table → anchor targets
→ per-level top-k of the detached scores, one NMS over their union → roi
sampling → ROIAlign of every roi from each of P2..P5, each blended in by the
roi's level (``roi_levels``) → 2-fc head → RCNN head → the four losses.

The ROIAlign routes as the JAX package's does (``ops/roi_align.py``): at the
608×1024 train canvas P2 and P3 go to the streamed kernels 4/5, P4 and P5
to the resident kernels 2/3; the NMS is kernel 1.  The inference forward,
frozen-proposal training and the mask branch are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.models.faster_rcnn import init_weights, sampling_uniforms, train_losses
from mx_rcnn_tpu_torch.models.heads import RCNNHead
from mx_rcnn_tpu_torch.models.layers import conv, normalize_images
from mx_rcnn_tpu_torch.models.resnet import ResNetBackbone
from mx_rcnn_tpu_torch.models.rpn import RPNHead
from mx_rcnn_tpu_torch.ops.anchors import shifted_anchors
from mx_rcnn_tpu_torch.ops.boxes import bbox_pred, clip_boxes
from mx_rcnn_tpu_torch.ops.nms import _NEG_INF, nms
from mx_rcnn_tpu_torch.ops.proposal import Proposals
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


def roi_levels(rois: torch.Tensor, k0: int = 4, canonical: float = 224.0,
               lo: int = 2, hi: int = 5) -> torch.Tensor:
    """(…, 4) boxes → FPN level in [lo, hi] (Lin et al. eq. 1), int32, in
    the JAX function's float32 op order."""
    w = torch.clamp_min(rois[..., 2] - rois[..., 0] + 1.0, 1.0)
    h = torch.clamp_min(rois[..., 3] - rois[..., 1] + 1.0, 1.0)
    # a device tensor divisor: IEEE division (CUDA multiplies by the
    # reciprocal of a Python scalar)
    canon = torch.tensor(canonical, dtype=w.dtype, device=w.device)
    k = torch.floor(k0 + torch.log2(torch.sqrt(w * h) / canon))
    return torch.clamp(k, lo, hi).to(torch.int32)


class FPNFasterRCNN(nn.Module):
    """Multi-level two-stage detector (``generate_config("resnet_fpn", …)``)
    with :class:`~mx_rcnn_tpu_torch.models.faster_rcnn.FasterRCNN`'s train
    contract: ``forward(..., train=True)`` → (loss, aux)."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        net = cfg.network
        if not net.USE_FPN:
            raise ValueError("FPNFasterRCNN needs a USE_FPN config")
        if net.USE_MASK:
            raise NotImplementedError("USE_MASK: the mask family is not ported yet "
                                      "(ROADMAP queue 1, item 13)")
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
        proposals: Optional[torch.Tensor] = None,
        prop_valid: Optional[torch.Tensor] = None,
    ):
        if not train:
            raise NotImplementedError("the FPN inference forward (test_forward) and serving are "
                                      "not ported yet (ROADMAP queue 1, item 12)")
        if proposals is not None or prop_valid is not None:
            raise NotImplementedError("frozen-proposal training is not ported yet "
                                      "(ROADMAP queue 1, item 12)")
        images = normalize_images(images, im_info, self.cfg)
        return self.train_forward(images, im_info, gt_boxes, gt_valid, sample_seeds, rng, draws)

    # ----------------------------------------------------------- helpers
    def _pyramid(self, images: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W, 3) → [P2, P3, P4, P5, P6], NCHW.  P6 is the JAX
        package's 1×1 max pool at stride 2 of P5: every other cell."""
        ps = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return ps + [ps[-1][:, :, ::2, ::2]]

    def _rpn_over_levels(self, pyramid: Sequence[torch.Tensor]):
        """The shared RPN on each level → logits (B, N, 2) and deltas
        (B, N, 4) concatenated P2→P6, the (N, 4) anchor table and the
        levels' bounds in it."""
        net = self.cfg.network
        outs = [self.rpn(p) for p in pyramid]
        anchors = np.concatenate([
            shifted_anchors(p.shape[2], p.shape[3], stride, ratios=net.ANCHOR_RATIOS,
                            scales=net.FPN_ANCHOR_SCALES)
            for p, stride in zip(pyramid, net.FPN_FEAT_STRIDES)
        ], axis=0)
        bounds = np.cumsum([0] + [lg.shape[1] for lg, _ in outs]).tolist()
        return (
            torch.cat([lg for lg, _ in outs], dim=1),
            torch.cat([dl for _, dl in outs], dim=1),
            torch.from_numpy(anchors).to(pyramid[0].device),
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

    def _roi_features(self, pyramid: Sequence[torch.Tensor], rois: torch.Tensor) -> torch.Tensor:
        """(B, R, 4) rois → (B·R, 1024) head features: every roi pooled
        from each of P2..P5 and kept where its level matches (4× the pooling
        work, one static graph, as the JAX package does)."""
        net = self.cfg.network
        levels = roi_levels(rois)[..., None, None, None]       # (B, R, 1, 1, 1)
        pooled = None
        for li, stride in enumerate(net.FPN_FEAT_STRIDES[:4]):
            feats = extract_roi_features_batched(
                pyramid[li].permute(0, 2, 3, 1), rois, "roi_align", net.POOLED_SIZE,
                1.0 / stride, net.ROI_SAMPLE_RATIO,
            )                                                   # (B, R, ph, pw, C)
            contrib = torch.where(levels == li + 2, feats, 0.0)
            pooled = contrib if pooled is None else pooled + contrib
        b, r = pooled.shape[0], pooled.shape[1]
        return self.top_head(pooled.reshape((b * r,) + pooled.shape[2:]))

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
        gt boxes and (B, G) ``gt_valid`` → (total loss, aux metrics), with
        the samplers' uniforms as in ``FasterRCNN.train_forward`` (over the
        concatenated anchor table)."""
        cfg = self.cfg
        t = cfg.TRAIN
        b = images.shape[0]
        pyramid = self._pyramid(images)
        rpn_logits, rpn_deltas, anchors, bounds = self._rpn_over_levels(pyramid)

        # proposals from detached outputs: the reference's proposal op has
        # no backward
        fg_scores = torch.softmax(rpn_logits, dim=-1)[..., 1]
        pre_per_level = max(t.RPN_PRE_NMS_TOP_N // (len(bounds) - 1), 256)
        props = self._propose_multilevel(
            fg_scores.detach(), rpn_deltas.detach(), anchors, bounds, im_info, pre_per_level,
            t.RPN_POST_NMS_TOP_N, t.RPN_NMS_THRESH, t.RPN_MIN_SIZE,
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

        cls_logits, bbox_pred_out = self.rcnn(self._roi_features(pyramid, samples.rois))
        return train_losses(
            cfg, rpn_logits, rpn_deltas, atgt, samples, props.valid, cls_logits, bbox_pred_out
        )
