"""Target assignment for training (port of ``mx_rcnn_tpu/ops/targets.py``):
RPN anchor targets, RCNN roi sampling, and the test path's bbox
de-normalization.

Batched over images (the per-image ``vmap`` of the JAX package becomes a
leading batch dim).  "Choose K of M at random" is "rank random priorities,
keep the top K", as in the JAX package.  ``jax.random`` cannot be reproduced
in torch, so the uniforms are an argument: ``(u_fg, u_bg)`` for
:func:`assign_anchor`, ``(u_fg, u_bg, u_tie)`` for :func:`sample_rois`, each
(B, n).  Without them the functions draw from the ``generator`` they are
given.  The ranking is a stable descending sort (``jnp.argsort(-priority)``)
and the final selection one too (``lax.top_k``), so ties and padding land
where the JAX package puts them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.ops.boxes import bbox_overlaps, bbox_transform

_BIG = 1e9
_CONSTANTS: Dict = {}


def device_constant(values, device) -> torch.Tensor:
    """A config vector or table (nested tuples of floats) as a float32
    tensor, built once per (values, device), for every module of the step:
    a host → device copy at every step would hold the host until the card
    caught up.  Never written in place."""
    key = (values, torch.device(device))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.tensor(values, dtype=torch.float32, device=device)
    return _CONSTANTS[key]


def _uniforms(u: Optional[Sequence[torch.Tensor]], count: int, shape, generator, device):
    if u is not None:
        if len(u) != count:
            raise ValueError(f"expected {count} uniform tensors, got {len(u)}")
        return [t.to(device) for t in u]
    if generator is None:
        raise ValueError("pass the uniforms or a torch.Generator to draw them from")
    return [torch.rand(shape, generator=generator, device=device) for _ in range(count)]


def _random_keep_k(u: torch.Tensor, candidate_mask: torch.Tensor, k) -> torch.Tensor:
    """(B, n) bool: a uniformly random size-``min(k, n_candidates)`` subset
    of each row's candidates, ranked by the uniforms ``u``; ``k`` is an int
    or a (B, 1) tensor."""
    priority = u - (~candidate_mask).float() * 2.0
    order = torch.sort(priority, dim=-1, descending=True, stable=True).indices
    n = candidate_mask.shape[-1]
    ranks = torch.arange(n, device=u.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, ranks)
    return candidate_mask & (rank < k)


def bbox_denorm_vectors(cfg: Config, num_classes: int, device=None):
    """(4K,) de-normalization (means, stds) for test-time delta decode:
    the per-class tables flattened class-major, or the class-agnostic
    vectors tiled over the K classes."""
    t = cfg.TRAIN
    if t.BBOX_STDS_PER_CLASS is not None:
        means = torch.tensor(t.BBOX_MEANS_PER_CLASS, dtype=torch.float32).reshape(-1)
        stds = torch.tensor(t.BBOX_STDS_PER_CLASS, dtype=torch.float32).reshape(-1)
        if means.shape != (4 * num_classes,):
            raise ValueError(f"per-class bbox stats shape {tuple(means.shape)} != K={num_classes}")
    else:
        means = torch.tensor(t.BBOX_MEANS, dtype=torch.float32).repeat(num_classes)
        stds = torch.tensor(t.BBOX_STDS, dtype=torch.float32).repeat(num_classes)
    return means.to(device), stds.to(device)


class AnchorTargets(NamedTuple):
    labels: torch.Tensor        # (B, N) int32: 1 fg / 0 bg / -1 ignore
    bbox_targets: torch.Tensor  # (B, N, 4) float32
    bbox_weights: torch.Tensor  # (B, N, 4) float32


def assign_anchor(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    im_info: torch.Tensor,
    cfg: Config,
    u: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    allowed_border: float = 0.0,
) -> AnchorTargets:
    """RPN anchor targets: (N, 4) anchors, (B, G, ≥4) padded gt boxes,
    (B, G) ``gt_valid``, (B, 3) ``im_info`` of the unpadded images.

    Only anchors inside the image take part; fg = each gt's best anchors
    (for gts that touch any) plus IoU ≥ RPN_POSITIVE_OVERLAP; bg = IoU <
    RPN_NEGATIVE_OVERLAP; subsampled to RPN_FG_FRACTION·RPN_BATCH_SIZE fg
    and the rest bg, by the uniforms ``u = (u_fg, u_bg)``, each (B, N)."""
    t = cfg.TRAIN
    b, n = gt_boxes.shape[0], anchors.shape[0]
    u_fg, u_bg = _uniforms(u, 2, (b, n), generator, anchors.device)
    h, w = im_info[:, 0, None], im_info[:, 1, None]

    inside = (
        (anchors[:, 0] >= -allowed_border)
        & (anchors[:, 1] >= -allowed_border)
        & (anchors[:, 2] < w + allowed_border)
        & (anchors[:, 3] < h + allowed_border)
    )                                                                 # (B, N)
    overlaps = bbox_overlaps(anchors, gt_boxes[..., :4])              # (B, N, G)
    overlaps = torch.where(gt_valid[:, None, :], overlaps, -1.0)
    overlaps = torch.where(inside[..., None], overlaps, -1.0)
    max_ov = overlaps.amax(-1)
    argmax_gt = overlaps.argmax(-1)                                   # first maximum
    gt_max_ov = overlaps.amax(1)                                      # (B, G)

    # per-gt best anchors (ties included), only for gts that touch anything
    gmax = gt_max_ov[:, None, :]
    is_gt_best = ((overlaps == gmax) & (gmax > 0) & gt_valid[:, None, :]).any(-1)

    fg = inside & (is_gt_best | (max_ov >= t.RPN_POSITIVE_OVERLAP))
    bg = inside & (max_ov < t.RPN_NEGATIVE_OVERLAP) & ~fg
    if t.RPN_CLOBBER_POSITIVES:
        bg = inside & (max_ov < t.RPN_NEGATIVE_OVERLAP)
        fg = fg & ~bg

    num_fg = int(t.RPN_FG_FRACTION * t.RPN_BATCH_SIZE)
    fg = _random_keep_k(u_fg, fg, num_fg)
    bg = _random_keep_k(u_bg, bg, t.RPN_BATCH_SIZE - fg.sum(-1, keepdim=True))

    labels = torch.where(fg, 1, torch.where(bg, 0, -1)).to(torch.int32)
    matched = torch.gather(gt_boxes[..., :4], 1, argmax_gt[..., None].expand(b, n, 4))
    targets = torch.where(fg[..., None], bbox_transform(anchors, matched), 0.0)
    weights = torch.where(fg[..., None], device_constant(t.RPN_BBOX_WEIGHTS, anchors.device), 0.0)
    return AnchorTargets(labels, targets.float(), weights)


class RoiSamples(NamedTuple):
    rois: torch.Tensor          # (B, R, 4) float32, image coords
    labels: torch.Tensor        # (B, R) int32: class id, 0 = bg, -1 = ignore
    bbox_targets: torch.Tensor  # (B, R, 4K) class-specific layout
    bbox_weights: torch.Tensor  # (B, R, 4K)
    gt_index: torch.Tensor      # (B, R) int32: matched gt slot


def sample_rois(
    rois: torch.Tensor,
    rois_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    cfg: Config,
    u: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> RoiSamples:
    """BATCH_ROIS rois per image for the RCNN head: (B, P, 4) padded
    proposals, (B, G, 5) padded gt ``[x1, y1, x2, y2, cls]``.

    The gt boxes join the candidates; fg = IoU ≥ FG_THRESH, subsampled to
    FG_FRACTION·BATCH_ROIS; bg = IoU in [BG_THRESH_LO, BG_THRESH_HI) fills
    the rest; rows are packed fg, then bg, then ignore.  Targets are
    class-specific (4K layout), normalized by BBOX_MEANS/STDS (or the
    per-class tables).  ``u = (u_fg, u_bg, u_tie)``, each (B, P + G)."""
    t = cfg.TRAIN
    num_classes = cfg.dataset.NUM_CLASSES
    r_out = t.BATCH_ROIS
    b = rois.shape[0]

    cand = torch.cat([rois[..., :4], gt_boxes[..., :4]], dim=1)      # (B, p, 4)
    cand_valid = torch.cat([rois_valid, gt_valid], dim=1)
    p = cand.shape[1]
    u_fg, u_bg, u_tie = _uniforms(u, 3, (b, p), generator, rois.device)

    overlaps = bbox_overlaps(cand, gt_boxes[..., :4])                 # (B, p, G)
    overlaps = torch.where(gt_valid[:, None, :], overlaps, -1.0)
    max_ov = overlaps.amax(-1)
    argmax_gt = overlaps.argmax(-1)
    cls_of = torch.gather(gt_boxes[..., 4], 1, argmax_gt).to(torch.int32)

    fg_cand = cand_valid & (max_ov >= t.FG_THRESH)
    bg_cand = cand_valid & (max_ov < t.BG_THRESH_HI) & (max_ov >= t.BG_THRESH_LO) & ~fg_cand

    num_fg = int(round(t.FG_FRACTION * r_out))
    fg_sel = _random_keep_k(u_fg, fg_cand, num_fg)
    bg_sel = _random_keep_k(u_bg, bg_cand, r_out - fg_sel.sum(-1, keepdim=True))

    # pack: fg first, then bg, then ignore padding (float32 sums, as in JAX:
    # the tie uniform only orders the ignore rows)
    sel_priority = torch.where(fg_sel, 2.0 * _BIG, 0.0) + torch.where(bg_sel, _BIG, 0.0)
    sel_priority = sel_priority + u_tie
    if p < r_out:  # fewer candidates than the roi budget (tiny configs)
        pad = r_out - p
        sel_priority = torch.cat([sel_priority, sel_priority.new_full((b, pad), -_BIG)], 1)
        cand = torch.cat([cand, cand.new_zeros((b, pad, 4))], 1)
        fg_sel = torch.cat([fg_sel, fg_sel.new_zeros((b, pad))], 1)
        bg_sel = torch.cat([bg_sel, bg_sel.new_zeros((b, pad))], 1)
        cls_of = torch.cat([cls_of, cls_of.new_zeros((b, pad))], 1)
        argmax_gt = torch.cat([argmax_gt, argmax_gt.new_zeros((b, pad))], 1)
    idx = torch.sort(sel_priority, dim=-1, descending=True, stable=True).indices[:, :r_out]
    picked_fg = torch.gather(fg_sel, 1, idx)
    picked_bg = torch.gather(bg_sel, 1, idx)

    out_rois = torch.gather(cand, 1, idx[..., None].expand(b, r_out, 4))
    labels = torch.where(
        picked_fg, torch.gather(cls_of, 1, idx), torch.where(picked_bg, 0, -1)
    ).to(torch.int32)

    gt_index = torch.gather(argmax_gt, 1, idx)
    matched = torch.gather(gt_boxes[..., :4], 1, gt_index[..., None].expand(b, r_out, 4))
    raw = bbox_transform(out_rois, matched)
    dev = rois.device
    if t.BBOX_STDS_PER_CLASS is not None:
        cls = labels.clamp_min(0).long()
        means = device_constant(t.BBOX_MEANS_PER_CLASS, dev)[cls]
        stds = device_constant(t.BBOX_STDS_PER_CLASS, dev)[cls]
    else:
        means = device_constant(t.BBOX_MEANS, dev)
        stds = device_constant(t.BBOX_STDS, dev)
    raw = torch.where(picked_fg[..., None], (raw - means) / stds, 0.0)

    cls_onehot = torch.nn.functional.one_hot(
        labels.clamp_min(0).long(), num_classes
    ).float() * picked_fg[..., None]                                  # (B, R, K)
    bbox_targets = (cls_onehot[..., None] * raw[..., None, :]).reshape(b, r_out, -1)
    bbox_weights = cls_onehot.repeat_interleave(4, dim=-1)
    return RoiSamples(out_rois, labels, bbox_targets, bbox_weights, gt_index.to(torch.int32))
