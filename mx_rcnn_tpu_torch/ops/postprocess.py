"""Device-side eval post-processing: per-class decode + NMS, batched, and for
mask models the selection and paste of the survivors' masks (port of
``mx_rcnn_tpu/ops/postprocess.py``).

decode → clip to the resized image → /scale → clip to the original extent →
per-class NMS in original coordinates, where the +1-pixel IoU of the host
reference loop is measured.  All B images × (K−1) foreground classes go
through one batched NMS (one kernel launch pair on the card).  Below-threshold
and padding rows are excluded before suppression.

Mask models: the cross-class top ``max_det`` survivors of each image keep
their S×S logit grid for their class (``det_masks``), and with ``paste`` each
grid is pasted into its box on the bucket canvas (``det_canvas``) in int32
fixed point, bitwise equal to ``eval/segm.py::paste_mask_canvas``.  These are
indexing and integer ops that the JAX package leaves to XLA: plain torch ops
here.
"""

from __future__ import annotations

from typing import Dict

import torch

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.ops.boxes import bbox_pred, clip_boxes
from mx_rcnn_tpu_torch.ops.nms import _NEG_INF, batched_class_nms

# logit of a padding row's mask: sigmoid ≈ 0 (an empty mask), no overflow in
# the host's exp
MASK_FILL = -80.0


def make_test_postprocess(cfg: Config, num_classes: int, thresh: float, max_out: int = 100,
                          paste: bool = False):
    """→ ``fn(out, im_info, orig_hw) -> {det_boxes, det_scores, det_valid}``
    with shapes (B, K−1, max_out, ·); class j's detections live at row j−1.
    Boxes are in ORIGINAL image coordinates (``orig_hw`` (B, 2) = pre-resize
    heights/widths).

    When ``out`` carries ``mask_logits`` (B, R, S, S, K) the function also
    returns, for the cross-class top ``max_det = TEST.MAX_PER_IMAGE``
    survivors by score (ties to the lower flat index, as ``lax.top_k``):
    ``det_masks`` (B, max_det, S, S) float32 LOGITS for each survivor's class
    (the sigmoid stays on the host, in the reference's numpy expression),
    ``det_mask_idx`` (B, max_det) int32 flat index ``(class − 1)·max_out +
    slot`` into the det grid (−1 on padding) and ``det_mask_valid``.

    ``paste=True`` (``TEST.MASK_CANVAS``): the function takes a fourth
    argument ``canvas_hw``, the padded bucket extent (the Predictor passes
    the batch's image extent, since ``fn.wants_canvas``), and also returns
    ``det_canvas`` (B, max_det, Hc, Wc) uint8: each grid bilinearly resized
    to its box's pixel extent in canvas (= resized image) coordinates and
    thresholded at logit 0 (probability 0.5), in int32 fixed point (8
    fractional bits on the logits, 7 on the weights)."""
    te = cfg.TEST
    max_det = te.MAX_PER_IMAGE if te.MAX_PER_IMAGE > 0 else (num_classes - 1) * max_out
    # the det grid holds only (K-1)·max_out candidates
    max_det = min(max_det, (num_classes - 1) * max_out)

    def select_masks(os_, ov, oi, mask_logits):
        """(B, K−1, max_out) det grid → the top ``max_det`` survivors'
        grids, flat indices and validity."""
        b, r = mask_logits.shape[:2]
        flat = torch.where(ov, os_, _NEG_INF).reshape(b, -1)
        # a stable descending sort: ties to the lower flat index
        top_s, top_flat = torch.sort(flat, dim=1, descending=True, stable=True)
        top_s, top_flat = top_s[:, :max_det], top_flat[:, :max_det]
        mvalid = top_s > _NEG_INF / 2
        # the survivor's source roi (a padding slot's index may pass R) and
        # class channel
        roi_idx = torch.gather(oi.reshape(b, -1), 1, top_flat).clamp(0, r - 1)
        roi_idx = torch.where(mvalid, roi_idx, 0)
        cls = torch.where(mvalid, top_flat // ov.shape[-1] + 1, 1)
        rows = torch.arange(b, device=mask_logits.device)[:, None]
        grids = mask_logits[rows, roi_idx, :, :, cls]                  # (B, max_det, S, S)
        grids = torch.where(mvalid[..., None, None], grids, MASK_FILL).float()
        midx = torch.where(mvalid, top_flat, -1).to(torch.int32)
        return grids, midx, mvalid

    def paste_canvas(ob, midx, grids, mvalid, im_info, canvas_hw):
        """The survivors' logit grids → (B, max_det, Hc, Wc) uint8 masks,
        in ``eval/segm.py::paste_mask_canvas``'s op order."""
        hc, wc = canvas_hw
        b, d, s = grids.shape[:3]
        dev = grids.device
        # survivor boxes in canvas coordinates, clipped to the canvas (so
        # the floor/ceil footprint stays inside it)
        bf = ob.reshape(b, -1, 4)
        sel = midx.long().clamp(0, bf.shape[1] - 1)
        box = torch.gather(bf, 1, sel[..., None].expand(b, d, 4)) * im_info[:, 2, None, None]
        x1 = box[..., 0].clamp(0.0, wc - 1.0)
        y1 = box[..., 1].clamp(0.0, hc - 1.0)
        x2 = box[..., 2].clamp(0.0, wc - 1.0)
        y2 = box[..., 3].clamp(0.0, hc - 1.0)
        x1i, y1i = torch.floor(x1).to(torch.int32), torch.floor(y1).to(torch.int32)
        x2i, y2i = torch.ceil(x2).to(torch.int32), torch.ceil(y2).to(torch.int32)
        bw = torch.clamp_min(x2i - x1i + 1, 1)
        bh = torch.clamp_min(y2i - y1i + 1, 1)
        # logits to 8 fractional bits, |logit| capped at 60: |q| ≤ 2^14
        q = torch.round(grids.clamp(-60.0, 60.0) * 256.0).to(torch.int32)

        def axis(n, lo, extent):
            # half-pixel source mapping dst → src, border-replicate clamped,
            # weights to 7 bits; the divisor is a tensor: IEEE division
            coords = torch.arange(n, dtype=torch.int32, device=dev)
            dd = (coords - lo[..., None]).float()
            t = (dd + 0.5) * float(s) / extent[..., None].float() - 0.5
            sc = t.clamp(0.0, s - 1.0)
            i0 = torch.floor(sc).to(torch.int32)
            i1 = torch.clamp_max(i0 + 1, s - 1)
            w = torch.round((sc - i0.float()) * 128.0).to(torch.int32)
            return coords, i0.long(), i1.long(), w

        xs, x0, x1b, wx = axis(wc, x1i, bw)                       # (B, D, Wc)
        ys, y0, y1b, wy = axis(hc, y1i, bh)                       # (B, D, Hc)
        # the blend is exact integer arithmetic (|val| < 2^28), so the x
        # lerp on the S grid rows first gives the reference's integers
        rows_x = ((128 - wx)[:, :, None, :] * torch.gather(q, 3, x0[:, :, None, :].expand(b, d, s, wc))
                  + wx[:, :, None, :] * torch.gather(q, 3, x1b[:, :, None, :].expand(b, d, s, wc)))
        val = ((128 - wy)[..., None] * torch.gather(rows_x, 2, y0[..., None].expand(b, d, hc, wc))
               + wy[..., None] * torch.gather(rows_x, 2, y1b[..., None].expand(b, d, hc, wc)))
        inside = (((xs >= x1i[..., None]) & (xs <= x2i[..., None]))[:, :, None, :]
                  & ((ys >= y1i[..., None]) & (ys <= y2i[..., None]))[..., None])
        return ((val >= 0) & inside & mvalid[..., None, None]).to(torch.uint8)

    def batched(out: Dict[str, torch.Tensor], im_info, orig_hw, canvas_hw=None):
        rois, scores, deltas = out["rois"], out["cls_prob"], out["bbox_deltas"]
        b, r, k = scores.shape
        boxes = bbox_pred(rois, deltas)                                 # (B, R, 4K)
        boxes = clip_boxes(boxes, im_info[:, 0], im_info[:, 1])
        boxes = clip_boxes(
            boxes / im_info[:, 2, None, None], orig_hw[:, 0], orig_hw[:, 1]
        )
        # foreground classes on a leading axis: (B, K-1, R, ·)
        boxes_k = boxes.reshape(b, r, k, 4).permute(0, 2, 1, 3)[:, 1:]
        scores_k = scores.permute(0, 2, 1)[:, 1:]
        valid_k = out["roi_valid"].bool()[:, None, :] & (scores_k > thresh)
        ob, os_, ov, oi = batched_class_nms(boxes_k, scores_k, te.NMS, max_out, valid_k,
                                            with_idx=True)
        res = {"det_boxes": ob, "det_scores": os_, "det_valid": ov}
        if "mask_logits" in out:
            grids, midx, mvalid = select_masks(os_, ov, oi, out["mask_logits"])
            res.update(det_masks=grids, det_mask_idx=midx, det_mask_valid=mvalid)
            if paste and canvas_hw is not None:
                res["det_canvas"] = paste_canvas(ob, midx, grids, mvalid, im_info,
                                                 tuple(canvas_hw))
        return res

    # the Predictor passes the batch's image extent as canvas_hw only to
    # postprocess functions that ask for it
    batched.wants_canvas = bool(paste)
    return batched
