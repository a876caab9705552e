#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit, torch's name and
   device count) and turns TF32 off for convolutions and matmuls;
2. builds the hand-written kernels from ``mx_rcnn_tpu_torch/csrc`` with nvcc
   for sm_90a (one nvcc per source, all started together: ``nms.cu`` exports
   the NMS launcher, ``roi_align.cu`` the ROIAlign forward and backward) and
   prints ptxas' register / shared-memory / spill lines;
3. holds the NMS kernel against its plain PyTorch version on the card at the
   serving proposal shape (2 × 6000 sorted, max_keep 300, IoU 0.7), the
   train proposal shape (1 × 12000 sorted, max_keep 2000, IoU 0.7), the
   per-class shape (2 × 20 problems × 300 unsorted, IoU 0.3) and N = 1000
   (not a multiple of 64) with invalid rows: the keep masks must be
   identical;
4. holds the ROIAlign forward kernel against its plain version at
   (1, 64, 64, 1024), R = 300, and at the train shape (1, 38, 64, 1024),
   R = 128, both 14 × 14, s = 2, with and without ``valid_hw``, degenerate
   and off-canvas rois included: max |Δ| ≤ 1e-5; and the ROIAlign backward
   kernel against its plain scatter-add at the train shape, with and
   without ``valid_hw``: |Δ| ≤ 1e-4 · max(1, Σ|terms|) (atomics sum in a
   run-dependent order, and a float32 sum's rounding grows with the sum of
   its terms' magnitudes);
5. serves VOC-sized requests through full-width ResNet-101 C4 Faster R-CNN
   (``generate_config("resnet", "PascalVOC")``, seeded random weights) with
   ``detect_single`` in both buckets, plus a same-bucket batch of 2 through
   the ``Predictor``; both kernels' launch counts are reset just before and
   read just after, and each must be > 0.  The tensors the path fed the
   kernels are captured and each kernel is held against its plain version on
   them; one request is profiled (device time by layer); a small request
   runs on the card and on the CPU (plain versions) and the two must agree;
6. trains the same model (``generate_config("resnet", "PascalVOC")``, full
   width, BATCH_ROIS 128, 12000 → 2000 proposals) for 10 steps through
   ``core/fit.py::fit`` on 8 synthetic 480 × 640 images (600 × 800 in the
   608 × 1024 bucket: a 38 × 64 × 1024 feature map); the three kernels'
   launch counts are reset just before and read just after, and each must be
   > 0; the frozen BN moments are first set from one forward on a training
   image (unit-scale activations, as a pretrained backbone's give); every
   loss must be finite and none above 100× the first step's, every frozen
   tensor bit-identical after the steps and some trainable tensor of each
   trained group changed; each kernel is held against its plain version on
   the tensors the steps fed it; the loss's central difference along each
   trained group's gradient must match the gradient within 1e-2; one step is
   profiled (forward / backward / optimizer, device time by
   layer); one small step (ResNet-50, 128 × 128) runs on the card and on the
   CPU with the same weights and sampling draws, and the two must agree;
7. times each kernel on captured tensors, at the serving shapes (the
   batch-of-2 call) and at the train shapes: its device time from a CUDA
   graph of the wrapper (``ms``), the eager wrapper (``wrapper_ms``) and the
   eager plain version (``plain_ms``), beside the bound for the work this
   data needs;
8. prints one JSON line with each kernel's launches, max error, times and
   bound, then the ``nvidia-smi`` line, then the device line last.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.fit import batch_to_device, fit
from mx_rcnn_tpu_torch.core.metrics import METRIC_NAMES
from mx_rcnn_tpu_torch.core.tester import Predictor
from mx_rcnn_tpu_torch.core.train import (
    is_frozen_path,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from mx_rcnn_tpu_torch.data.loader import _orientation_bucket, make_batch
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.models import faster_rcnn as model_mod
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN, sampling_uniforms
from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm
from mx_rcnn_tpu_torch.ops import nms as nms_mod
from mx_rcnn_tpu_torch.ops import roi_align as roi_mod
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess
from mx_rcnn_tpu_torch.serve.buckets import BucketLadder
from mx_rcnn_tpu_torch.serve.runner import detect_single, prepare_request
from mx_rcnn_tpu_torch.utils.cuda_build import build_all

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# flops the NMS spends per IoU test and the ROIAlign per output element
# (4 samples × (3 lerps of 3 flops + 1 add) + 1 divide)
NMS_FLOPS_PER_PAIR = 17
ROI_FLOPS_PER_OUTPUT = 41
# the ROIAlign backward per cotangent element: 1 divide, 4 samples × 6
# multiplies, 16 adds
ROI_BWD_FLOPS_PER_G = 41
ROI_TOL = 1e-5
ROI_BWD_TOL = 1e-4
# the train path: no step's loss may exceed this multiple of the first
# step's (a loss that runs away grows by orders of magnitude in a few
# steps; a sound one swings with the number of fg rois the image gives),
# and the loss's central difference along each trained group's gradient
# must match the gradient to this relative bar
LOSS_GROWTH_MAX = 100.0
FD_TOL = 1e-2
NUM_CLASSES = 21
TRAIN_STEPS = 10
TRAIN_WARMUP = 2
REQUEST_HW = [(375, 500), (500, 375), (480, 640), (640, 480), (333, 500), (500, 333)]
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back eager calls (CUDA
    events after a warm-up; inputs warm in L2, as the path leaves them).
    It includes the host's launch cost wherever that is the slower side."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, replays: int = 3) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed after a warm-up and timed with CUDA events, so the
    wrapper's host work (checks, allocations, the ctypes call) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ NMS
def nms_work(boxes, valid, keep, thresh, max_keep):
    """Bytes the function must move and the IoU flops this data needs.

    The greedy sweep decides the boxes in score order and can stop at the
    max_keep-th survivor (at the end of the problem when it keeps fewer):
    no box past that point needs a test, or needs to be read.  Before it, a
    survivor needs an IoU test against every earlier survivor, and a
    suppressed valid box against the earlier survivors up to the first one
    that suppresses it.  The whole keep mask is written."""
    p, n = valid.shape
    pairs, nbytes = 0, keep.numel()
    for q in range(p):
        surv = torch.nonzero(keep[q]).flatten()
        stop = n if max_keep <= 0 or surv.numel() < max_keep else int(surv[-1]) + 1
        nbytes += stop * (boxes.element_size() * 4 + valid.element_size())
        if surv.numel() == 0:
            continue
        x1, y1, x2, y2 = boxes[q, :stop].float().unbind(-1)
        area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
        iw = torch.minimum(x2[surv, None], x2[None]) - torch.maximum(x1[surv, None], x1[None]) + 1.0
        ih = torch.minimum(y2[surv, None], y2[None]) - torch.maximum(y1[surv, None], y1[None]) + 1.0
        inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)
        iou = inter / (area[surv, None] + area[None] - inter).clamp_min(1e-12)   # (K, stop)
        earlier = surv[:, None] < torch.arange(stop, device=surv.device)[None]
        hit = (iou > thresh) & earlier
        first = torch.where(hit.any(0), hit.int().argmax(0) + 1, 0)
        kept, dropped = keep[q, :stop], valid[q, :stop] & ~keep[q, :stop]
        tests = torch.where(kept, earlier.sum(0), torch.where(dropped, first, 0))
        pairs += int(tests.sum())
    return nbytes, pairs * NMS_FLOPS_PER_PAIR


class MaskDiff:
    """Running comparison of keep masks: mismatched entries, and the max
    |kernel − plain| over the masks as 0/1 values."""

    def __init__(self):
        self.mismatches, self.max_abs_err = 0, 0.0

    def add(self, got: torch.Tensor, ref: torch.Tensor) -> int:
        d = (got.to(torch.int8) - ref.to(torch.int8)).abs()
        bad = int(d.sum())
        self.mismatches += bad
        self.max_abs_err = max(self.max_abs_err, float(d.max()) if d.numel() else 0.0)
        return bad


def nms_case(diff, boxes, valid, thresh, max_keep, label):
    """Kernel vs plain on sorted (P, N, 4) CUDA inputs, into ``diff``."""
    got = nms_mod.nms_mask_sorted(boxes, valid, thresh, max_keep)
    ref = nms_mod.nms_mask_sorted_plain(boxes, valid, thresh, max_keep)
    bad = diff.add(got, ref)
    if max_keep > 0:
        # truncated exactness: the first max_keep survivors of the full sweep
        full = nms_mod.nms_mask_sorted_plain(boxes, valid, thresh)
        bad += diff.add(got, full & (torch.cumsum(full, dim=-1) <= max_keep))
    log(f"  nms {label}: P={boxes.shape[0]} N={boxes.shape[1]} thresh={thresh} "
        f"max_keep={max_keep} kept={int(got.sum())} mismatches={bad}")
    if bad:
        raise AssertionError(f"NMS kernel disagrees with the plain version ({label})")


def random_boxes(rng, p, n, w_img, h_img, max_side):
    xy = rng.rand(p, n, 2) * [w_img * 0.9, h_img * 0.9]
    wh = rng.rand(p, n, 2) * max_side + 2.0
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def nms_synthetic(diff, dev):
    rng = np.random.RandomState(0)
    # proposal shape: 2 images × 6000 sorted, the low-score tail invalid
    boxes = torch.from_numpy(random_boxes(rng, 2, 6000, 1000, 600, 300)).to(dev)
    valid = torch.ones((2, 6000), dtype=torch.bool, device=dev)
    valid[:, 5500:] = False
    nms_case(diff, boxes, valid, 0.7, 300, "proposals")
    # per-class shape: 2 images × 20 classes × 300 unsorted rois, through the
    # full contract (sort, kernel, scatter back) vs the CPU plain path
    cb = torch.from_numpy(random_boxes(rng, 40, 300, 500, 400, 120))
    cs = torch.from_numpy(rng.rand(40, 300).astype(np.float32))
    cv = cs > 0.3
    got = nms_mod.nms_mask(cb.to(dev), cs.to(dev), 0.3, cv.to(dev)).cpu()
    ref = nms_mod.nms_mask(cb, cs, 0.3, cv)
    bad = diff.add(got, ref)
    log(f"  nms classes (unsorted, vs CPU plain): P=40 N=300 thresh=0.3 kept={int(got.sum())} "
        f"mismatches={bad}")
    if bad:
        raise AssertionError("NMS kernel disagrees with the plain version (classes)")
    order = torch.sort(torch.where(cv, cs, -1e10), dim=-1, descending=True, stable=True).indices
    sb = torch.gather(cb, 1, order[..., None].expand(-1, -1, 4)).to(dev)
    nms_case(diff, sb, torch.gather(cv, 1, order).to(dev), 0.3, 0, "classes (sorted)")
    # N not a multiple of 64, 30% invalid rows, with and without max_keep
    boxes = torch.from_numpy(random_boxes(rng, 3, 1000, 300, 300, 80)).to(dev)
    valid = torch.from_numpy(rng.rand(3, 1000) > 0.3).to(dev)
    nms_case(diff, boxes, valid, 0.5, 0, "N=1000")
    nms_case(diff, boxes, valid, 0.5, 50, "N=1000 truncated")
    # train proposal shape: 1 × 12000 sorted, the sweep stops at the 2000th
    # survivor (pass 2's longest chain; an 18 MB mask scratch)
    boxes = torch.from_numpy(random_boxes(rng, 1, 12000, 1024, 608, 300)).to(dev)
    valid = torch.ones((1, 12000), dtype=torch.bool, device=dev)
    nms_case(diff, boxes, valid, 0.7, 2000, "train proposals")


# ------------------------------------------------------------- ROIAlign
def roi_work(feat, rois, pooled, scale, s, valid_hw, out):
    """Bytes the function must move and the flops it does: the feature cells
    some roi's samples read (each once, all channels), the rois, valid_hw
    and the output."""
    b, h, w, c = feat.shape
    r = rois.float() * scale
    taps = []
    for axis, size, (c1, c2), nbins in ((0, h, (1, 3), pooled[0]), (1, w, (0, 2), pooled[1])):
        lim = None if valid_hw is None else valid_hw[:, axis]
        lim_f, lim_i = roi_mod._feat_limits(size, lim, scale, b, feat.device)
        lo, hi, _, _ = roi_mod._axis_taps(r[..., c1], r[..., c2], nbins, s, lim_f, lim_i)
        hit = torch.zeros(lo.shape[:2] + (size,), device=feat.device)
        taps.append(hit.scatter_(2, lo, 1.0).scatter_(2, hi, 1.0))
    cells = int((torch.einsum("brh,brw->bhw", *taps) > 0).sum())
    nbytes = (cells * c + rois.numel() + out.numel()
              + (0 if valid_hw is None else valid_hw.numel())) * 4
    return nbytes, out.numel() * ROI_FLOPS_PER_OUTPUT


def roi_case(feat, rois, valid_hw, label):
    got = roi_mod.roi_align(feat, rois, (14, 14), 1.0 / 16, 2, valid_hw)
    ref = roi_mod.roi_align_plain(feat, rois, (14, 14), 1.0 / 16, 2, valid_hw)
    err = float((got - ref).abs().max())
    log(f"  roi_align {label}: feat={tuple(feat.shape)} R={rois.shape[1]} max|d|={err:.3g}")
    if not err <= ROI_TOL:
        raise AssertionError(f"ROIAlign kernel disagrees with the plain version ({label}): {err}")
    return err


def synthetic_rois(rng, r, h_img, w_img):
    x1 = rng.rand(r) * w_img * 0.8
    y1 = rng.rand(r) * h_img * 0.8
    x2 = x1 + rng.rand(r) * (w_img - x1)
    y2 = y1 + rng.rand(r) * (h_img - y1)
    rois = np.stack([x1, y1, x2, y2], axis=1).astype(np.float32)
    rois[0] = [0, 0, w_img - 1, h_img - 1]                      # whole canvas
    rois[1] = [5, 5, 5.5, 5.5]                                   # sub-cell
    rois[2] = [w_img - 2, h_img - 2, w_img + 50, h_img + 50]     # off canvas
    rois[3] = [0, 0, 0, 0]                                       # degenerate
    rois[4] = [700, 500, 650, 450]                               # inverted
    return rois


def roi_synthetic(dev):
    rng = np.random.RandomState(1)
    feat = torch.from_numpy(rng.randn(1, 64, 64, 1024).astype(np.float32)).to(dev)
    rois = torch.from_numpy(synthetic_rois(rng, 300, 1024, 1024)[None]).to(dev)
    err = roi_case(feat, rois, None, "canvas clamp")
    valid_hw = torch.tensor([[600.0, 800.0]], device=dev)
    err = max(err, roi_case(feat, rois, valid_hw, "valid_hw clamp"))
    # the train shape: 38 × 64 × 1024, 128 rois, canvas clamp (the train
    # path's branch) and valid_hw
    feat = torch.from_numpy(rng.randn(1, 38, 64, 1024).astype(np.float32)).to(dev)
    rois = torch.from_numpy(synthetic_rois(rng, 128, 608, 1024)[None]).to(dev)
    err = max(err, roi_case(feat, rois, None, "train shape, canvas clamp"))
    return max(err, roi_case(feat, rois, valid_hw, "train shape, valid_hw clamp"))


class BwdDiff:
    """Running comparison of kernel 3 with its plain version: the max |Δ|,
    and the max of |Δ| / max(1, Σ|terms|), Σ|terms| being the plain backward
    of |g| (the weights are ≥ 0), which the bar holds to ROI_BWD_TOL."""

    def __init__(self):
        self.max_abs_err, self.scaled_err = 0.0, 0.0

    def add(self, g, rois, shape, pooled, scale, s, valid_hw, label):
        got = roi_mod._roi_align_bwd_cuda(g, rois, shape, pooled, scale, s, valid_hw)
        ref = roi_mod.roi_align_bwd_plain(g, rois, shape, pooled, scale, s, valid_hw)
        mag = roi_mod.roi_align_bwd_plain(g.abs(), rois, shape, pooled, scale, s, valid_hw)
        d = (got - ref).abs()
        err, scaled = float(d.max()), float((d / mag.clamp_min(1.0)).max())
        self.max_abs_err = max(self.max_abs_err, err)
        self.scaled_err = max(self.scaled_err, scaled)
        log(f"  roi_align_bwd {label}: g={tuple(g.shape)} -> {tuple(shape)} max|d|={err:.3g} "
            f"max|d|/max(1,sum|terms|)={scaled:.3g} max|plain|={float(ref.abs().max()):.3g}")
        if not scaled <= ROI_BWD_TOL:
            raise AssertionError(f"ROIAlign backward kernel disagrees with the plain version ({label})")


def roi_bwd_synthetic(diff, dev):
    """Kernel 3 at the train shape: g (1, 128, 14, 14, 1024) → (1, 38, 64, 1024)."""
    rng = np.random.RandomState(5)
    rois = torch.from_numpy(synthetic_rois(rng, 128, 608, 1024)[None]).to(dev)
    g = torch.from_numpy(rng.randn(1, 128, 14, 14, 1024).astype(np.float32)).to(dev)
    shape = (1, 38, 64, 1024)
    diff.add(g, rois, shape, (14, 14), 1.0 / 16, 2, None, "train shape, canvas clamp")
    valid_hw = torch.tensor([[600.0, 800.0]], device=dev)
    diff.add(g, rois, shape, (14, 14), 1.0 / 16, 2, valid_hw, "train shape, valid_hw clamp")


# ------------------------------------------------------------ main path
def make_model(cfg, seed: int = 0) -> FasterRCNN:
    """Seeded random weights (no checkpoint is on disk).  The RPN output
    layers are scaled down 1000× so proposals stay near their anchors: the
    lecun-initialized head on raw-pixel inputs emits deltas of ~75, which
    would clip nearly every proposal to the whole image."""
    model = FasterRCNN(cfg, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for layer in (model.rpn.rpn_cls_score, model.rpn.rpn_bbox_pred):
            layer.weight.mul_(1e-3)
    return model


def request_images(seed: int = 2):
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in REQUEST_HW]


class Capture:
    """Records the inputs a path hands each kernel's launcher: every NMS
    call, and the first ``keep`` ROIAlign forward and backward calls (all
    when None; the train path keeps 2, so the copies add little to its peak
    memory and nothing measurable to its steps)."""

    def __init__(self, keep=None):
        self.keep = keep
        self.nms, self.roi, self.roi_bwd = [], [], []
        self._orig = (nms_mod._nms_mask_sorted_cuda, roi_mod._roi_align_cuda,
                      roi_mod._roi_align_bwd_cuda)

    def __enter__(self):
        orig_nms, orig_roi, orig_bwd = self._orig

        def nms_rec(boxes, valid, thresh, max_keep):
            self.nms.append((boxes.clone(), valid.clone(), thresh, max_keep))
            return orig_nms(boxes, valid, thresh, max_keep)

        def roi_rec(feat, rois, pooled, scale, s, valid_hw):
            if self.keep is None or len(self.roi) < self.keep:
                self.roi.append((feat.clone(), rois.clone(), pooled, scale, s,
                                 None if valid_hw is None else valid_hw.clone()))
            return orig_roi(feat, rois, pooled, scale, s, valid_hw)

        def bwd_rec(g, rois, feat_shape, pooled, scale, s, valid_hw):
            if self.keep is None or len(self.roi_bwd) < self.keep:
                self.roi_bwd.append((g.clone(), rois.clone(), tuple(feat_shape), pooled, scale,
                                     s, None if valid_hw is None else valid_hw.clone()))
            return orig_bwd(g, rois, feat_shape, pooled, scale, s, valid_hw)

        nms_mod._nms_mask_sorted_cuda, roi_mod._roi_align_cuda = nms_rec, roi_rec
        roi_mod._roi_align_bwd_cuda = bwd_rec
        return self

    def __exit__(self, *exc):
        (nms_mod._nms_mask_sorted_cuda, roi_mod._roi_align_cuda,
         roi_mod._roi_align_bwd_cuda) = self._orig
        return False


def reset_launches():
    for k in (nms_mod.kernel, roi_mod.kernel, roi_mod.bwd_kernel):
        k.launches = 0


def read_launches():
    return {"nms": nms_mod.kernel.launches, "roi_align_fwd": roi_mod.kernel.launches,
            "roi_align_bwd": roi_mod.bwd_kernel.launches}


def main_path(cfg, dev):
    """Serve the requests; returns the captured kernel inputs, the launch
    counts of the run, the predictor and one request image."""
    predictor = Predictor(
        make_model(cfg),
        make_test_postprocess(cfg, NUM_CLASSES, cfg.TEST.SCORE_THRESH, cfg.TEST.DET_PER_CLASS),
        device=dev,
    )
    images = request_images()
    ladder = BucketLadder(cfg.SHAPE_BUCKETS)
    reqs = [prepare_request(im, cfg, ladder) for im in images]
    buckets = sorted({r.bucket for r in reqs})
    log(f"  requests {REQUEST_HW} -> buckets {[r.bucket for r in reqs]}")
    if len(buckets) != 2:
        raise AssertionError(f"requests must cover both buckets, got {buckets}")
    # warm-up: one request per bucket (cuDNN and allocator first use)
    for b in buckets:
        detect_single(predictor, images[[r.bucket for r in reqs].index(b)], cfg, NUM_CLASSES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    times, all_dets = [], []
    with Capture() as cap:
        for im in images:
            t0 = time.perf_counter()
            dets = detect_single(predictor, im, cfg, NUM_CLASSES)
            times.append((time.perf_counter() - t0) * 1e3)
            all_dets.append(dets)
        # a same-bucket batch of 2 through the Predictor
        pair = [r for r in reqs if r.bucket == buckets[0]][:2]
        batch = {
            "images": np.stack([r.image for r in pair]),
            "im_info": np.stack([r.im_info for r in pair]),
            "orig_hw": np.asarray([r.orig_hw for r in pair], np.float32),
        }
        t0 = time.perf_counter()
        out = predictor.predict(batch)
        batch_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    log(f"  launches in the serving path: {launches}")
    if min(launches["nms"], launches["roi_align_fwd"]) <= 0:
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")

    for dets in all_dets:
        for d in dets[1:]:
            if d.ndim != 2 or d.shape[1] != 5 or not np.isfinite(d).all():
                raise AssertionError("non-finite or misshapen detections")
    if out["det_boxes"].shape != (2, NUM_CLASSES - 1, cfg.TEST.DET_PER_CLASS, 4):
        raise AssertionError(f"det_boxes shape {out['det_boxes'].shape}")
    if not np.isfinite(out["det_boxes"]).all() or not out["det_valid"].any():
        raise AssertionError("batch detections are non-finite or empty")
    log(f"  per-request ms (detect_single, host resize included): "
        f"{[round(t, 3) for t in times]} median={statistics.median(times):.3f}")
    log(f"  batch-of-2 Predictor.predict ms: {batch_ms:.3f}")
    log(f"  detections per class, request 0: {[len(d) for d in all_dets[0][1:]]}")
    log(f"  detections per class, batch image 0: {out['det_valid'][0].sum(-1).tolist()}")
    log(f"  max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    prep = []
    for im in images:
        t0 = time.perf_counter()
        prepare_request(im, cfg, ladder)
        prep.append((time.perf_counter() - t0) * 1e3)
    log(f"  host prepare_request ms (resize, quantize, pad): median={statistics.median(prep):.3f}")
    return cap, launches, predictor, images[0]


def _layer_of(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "nms_" in name:
        return "nms kernel"
    if "roi_align" in name:
        return "roi_align kernel"
    if "nhwctonchw" in name or "nchwtonhwc" in name:
        return "layout transposes around cuDNN"
    if any(k in name for k in ("conv", "gemm", "xmma", "cudnn", "implicit")):
        return "convolutions / matmuls"
    return "other (elementwise, sort, copies)"


def profile_request(predictor, cfg, im):
    """Device time by layer for one served request (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        detect_single(predictor, im, cfg, NUM_CLASSES)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    by_layer, total = {}, 0.0
    for e in events:
        us = e.self_device_time_total
        total += us
        by_layer[_layer_of(e.key)] = by_layer.get(_layer_of(e.key), 0.0) + us
    if total == 0:
        log("  profiler saw no device time: breakdown not measured")
        return
    log(f"  one request: wall {wall_ms:.3f} ms, device busy {total / 1e3:.3f} ms "
        f"({100 * total / 1e3 / wall_ms:.1f}% of wall; profiler on)")
    for layer, us in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        log(f"    {layer}: {us / 1e3:.3f} ms ({100 * us / total:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    top: {e.key[:90]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms")


def hold_captured(diff, cap, bwd_diff):
    """Each kernel against its plain version on the tensors the path fed it
    (NMS into ``diff``, the ROIAlign backward into ``bwd_diff``); returns
    the ROIAlign forward's max |Δ|."""
    nms_bad = 0
    for boxes, valid, thresh, max_keep in cap.nms:
        got = nms_mod.nms_mask_sorted(boxes, valid.bool(), thresh, max_keep)
        ref = nms_mod.nms_mask_sorted_plain(boxes, valid.bool(), thresh, max_keep)
        nms_bad += diff.add(got, ref)
    log(f"  nms on {len(cap.nms)} captured calls: mismatches={nms_bad}")
    if nms_bad:
        raise AssertionError("NMS kernel disagrees with the plain version on the path's tensors")
    roi_err = 0.0
    for feat, rois, pooled, scale, s, valid_hw in cap.roi:
        got = roi_mod.roi_align(feat, rois, pooled, scale, s, valid_hw)
        ref = roi_mod.roi_align_plain(feat, rois, pooled, scale, s, valid_hw)
        roi_err = max(roi_err, float((got - ref).abs().max()))
    log(f"  roi_align on {len(cap.roi)} captured calls: max|d|={roi_err:.3g}")
    if not roi_err <= ROI_TOL:
        raise AssertionError(f"ROIAlign kernel disagrees on the path's tensors: {roi_err}")
    for i, (g, rois, shape, pooled, scale, s, valid_hw) in enumerate(cap.roi_bwd):
        bwd_diff.add(g, rois, shape, pooled, scale, s, valid_hw, f"captured call {i}")
    return roi_err


def roi_bwd_work(g, rois, shape, valid_hw):
    """Bytes the backward must move (g, the rois, valid_hw read once, the
    whole dfeat written once) and its flops."""
    nbytes = (g.numel() + rois.numel() + int(np.prod(shape))
              + (0 if valid_hw is None else valid_hw.numel())) * 4
    return nbytes, g.numel() * ROI_BWD_FLOPS_PER_G


def time_kernel(kernel_fn, plain_fn, reps):
    """(device ms in a CUDA graph, eager wrapper ms, eager plain ms)."""
    return (graph_ms(kernel_fn, reps), cuda_ms(kernel_fn, reps),
            cuda_ms(plain_fn, reps=2, warmup=1))


def time_nms(boxes, valid, thresh, max_keep):
    valid = valid.bool()
    times = time_kernel(
        lambda: nms_mod.nms_mask_sorted(boxes, valid, thresh, max_keep),
        lambda: nms_mod.nms_mask_sorted_plain(boxes, valid, thresh, max_keep), reps=50)
    keep = nms_mod.nms_mask_sorted_plain(boxes, valid, thresh, max_keep)
    return times + bound_ms(*nms_work(boxes, valid, keep, thresh, max_keep))


def small_request_agrees(cfg, dev):
    """A small request through the card (kernels) and the CPU (plain
    versions) with the same weights: the forward outputs and the
    detections must agree."""
    small = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, SCALES=((192, 320),)),
        SHAPE_BUCKETS=((192, 320), (320, 192)),
        TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=1000, RPN_POST_NMS_TOP_N=100),
    )
    model = make_model(small)
    rng = np.random.RandomState(3)
    ladder = BucketLadder(small.SHAPE_BUCKETS)
    reqs = [prepare_request((rng.rand(h, w, 3) * 255).astype(np.uint8), small, ladder)
            for h, w in ((150, 200), (180, 240))]
    batch = {
        "images": np.stack([r.image for r in reqs]),
        "im_info": np.stack([r.im_info for r in reqs]),
        "orig_hw": np.asarray([r.orig_hw for r in reqs], np.float32),
    }
    raw = {k: v for k, v in batch.items() if k != "orig_hw"}
    pp = make_test_postprocess(small, NUM_CLASSES, small.TEST.SCORE_THRESH, small.TEST.DET_PER_CLASS)
    outs = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        pred = Predictor(copy.deepcopy(model), pp, device=d)
        outs[name] = (pred.predict(raw), pred.predict(batch))
    (fg, dg), (fc, dc) = outs["card"], outs["cpu"]
    if not np.array_equal(fg["roi_valid"], fc["roi_valid"]):
        raise AssertionError("card and CPU keep different proposals")
    v = fc["roi_valid"]
    errs = {
        "rois": float(np.abs(fg["rois"][v] - fc["rois"][v]).max()),
        "cls_prob": float(np.abs(fg["cls_prob"][v] - fc["cls_prob"][v]).max()),
        "bbox_deltas": float(np.abs(fg["bbox_deltas"][v] - fc["bbox_deltas"][v]).max()),
    }
    same_dets = bool(np.array_equal(dg["det_valid"], dc["det_valid"]))
    m = dc["det_valid"]
    if same_dets:
        errs["det_boxes"] = float(np.abs(dg["det_boxes"][m] - dc["det_boxes"][m]).max())
        errs["det_scores"] = float(np.abs(dg["det_scores"][m] - dc["det_scores"][m]).max())
    log(f"  small request card vs CPU: valid rois {int(v.sum())}, detections {int(m.sum())}, "
        f"same keep masks {same_dets}, max|d| {errs}")
    limits = {"rois": 1e-2, "cls_prob": 1e-4, "bbox_deltas": 1e-3, "det_boxes": 1e-2, "det_scores": 1e-4}
    if not same_dets or any(errs[k] > limits[k] for k in errs):
        raise AssertionError(f"card and CPU disagree beyond {limits}")


# ------------------------------------------------------------ train path
TRAINED_GROUPS = ("backbone.stage2", "backbone.stage3", "top_head", "rpn", "rcnn")


def train_batch(cfg, roidb, i, dev):
    rec = roidb[i]
    return batch_to_device(
        make_batch([rec], cfg, _orientation_bucket(rec, cfg.SHAPE_BUCKETS), seeds=[i]), dev)


def calibrate_bn(model, batch):
    """Set every frozen BN's moments to the per-channel mean and variance of
    its input in one train forward on ``batch`` (a pre-hook sets them before
    the layer runs, so each later layer sees calibrated inputs).  This gives
    the random network the unit-scale activations a pretrained backbone's BN
    moments give: with identity moments, seeded random convolutions on raw
    pixels (PIXEL_STDS 1) reach ~1e3 in the top head, every gradient element
    hits the ±CLIP_GRADIENT clip, and each clipped update moves the cls
    logits by ~1e4, so the loss grows ~1e4× within a few steps."""

    def set_moments(bn, args):
        x = args[0]
        bn.mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    dev = batch["images"].device
    model.to(dev, memory_format=torch.channels_last)
    hooks = [m.register_forward_pre_hook(set_moments) for m in model.modules()
             if isinstance(m, FrozenBatchNorm)]
    try:
        with torch.no_grad():
            model(batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
                  train=True, sample_seeds=batch["sample_seeds"])
    finally:
        for h in hooks:
            h.remove()
    log(f"  BN moments set from one forward on a training image: {len(hooks)} layers")


def gradient_matches_finite_differences(model, cfg, roidb, dev):
    """The full-width backward against the forward on the card: for each
    trained group, the loss's central difference along the group's gradient,
    f(θ + εd) − f(θ − εd) with d = g/‖g‖, must equal gᵀ(θ₊ − θ₋) (the
    displacement as rounded into the f32 weights) within FD_TOL.  The
    samplers' draws are fixed (one rng and seed) and the first forward's
    sampled rois are reused, so the loss is a smooth function of the
    weights; ε moves it by ~1e-3 of itself.  stage2 and stage3 take their
    gradient through the ROIAlign backward (kernel 3) almost wholly, since the
    RPN's output layers are scaled by 1e-3."""
    batch = train_batch(cfg, roidb, 1, dev)
    held = {}
    orig = model_mod.sample_rois

    def sample_once(*a, **k):
        if "samples" not in held:
            held["samples"] = orig(*a, **k)
        return held["samples"]

    def loss_fn():
        return model(batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
                     train=True, sample_seeds=batch["sample_seeds"], rng=5)[0]

    model_mod.sample_rois = sample_once
    try:
        for p in model.parameters():
            p.grad = None
        loss = loss_fn()
        loss.backward()
        f0 = float(loss.detach())
        worst = 0.0
        with torch.no_grad():
            for grp in TRAINED_GROUPS:
                ps = [p for n, p in model.named_parameters()
                      if n.startswith(grp + ".") and p.grad is not None]
                gs = [p.grad.clone() for p in ps]
                p0 = [p.clone() for p in ps]
                gnorm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in gs))
                if not gnorm > 0:
                    raise AssertionError(f"{grp} has no gradient")
                eps = 1e-3 * abs(f0) / gnorm
                f, moved = {}, {}
                for sign in (1.0, -1.0):
                    for p, a, g in zip(ps, p0, gs):
                        p.copy_(a + (sign * eps / gnorm) * g)
                    moved[sign] = [p.clone() for p in ps]
                    f[sign] = float(loss_fn())
                for p, a in zip(ps, p0):
                    p.copy_(a)
                want = sum(float((g.double() * (hi.double() - lo.double())).sum())
                           for g, hi, lo in zip(gs, moved[1.0], moved[-1.0]))
                got = f[1.0] - f[-1.0]
                rel = abs(got - want) / abs(want)
                worst = max(worst, rel)
                log(f"  {grp}: |g| {gnorm:.4g}, eps {eps:.3g}, f(+)-f(-) {got:.6g}, "
                    f"g.(p+ - p-) {want:.6g}, relative difference {rel:.3g}")
    finally:
        model_mod.sample_rois = orig
        for p in model.parameters():
            p.grad = None
    log(f"  loss {f0:.6f}; worst relative difference {worst:.3g} (bar {FD_TOL})")
    if not worst <= FD_TOL:
        raise AssertionError("the full-width gradient disagrees with the loss's finite differences")
    return worst


def train_path(cfg, dev):
    """TRAIN_STEPS steps of ``fit`` at full width on synthetic records;
    returns the captured kernel inputs, the launch counts of the run, the
    model, the roidb and the step statistics."""
    roidb = SyntheticDataset(num_images=8, image_size=(480, 640)).gt_roidb()
    model = make_model(cfg)
    calibrate_bn(model, train_batch(cfg, roidb, 0, dev))
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with Capture(keep=2) as cap:
        out = fit(model, cfg, roidb, epochs=2, seed=0, max_steps=TRAIN_STEPS,
                  frequent=TRAIN_STEPS, device=dev)
    launches = read_launches()
    log(f"  launches in the train path: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the train path never launched: {launches}")
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    captured_mib = sum(t.numel() * t.element_size() for c in (cap.roi, cap.roi_bwd)
                       for entry in c for t in entry[:2]) / 2**20

    hist = out["history"]
    if len(hist) != TRAIN_STEPS:
        raise AssertionError(f"fit ran {len(hist)} steps, not {TRAIN_STEPS}")
    for i, h in enumerate(hist):
        log(f"  step {i}: loss={h['loss']:.5f} "
            + " ".join(f"{k}={h[k]:.5f}" for k in METRIC_NAMES)
            + f" fg_rois={int(h['num_fg_rois'])} valid_props={int(h['num_valid_props'])}"
            f" fg_anchors={int(h['num_fg_anchors'])} step_ms={h['step_ms']:.3f}"
            f" load_ms={h['load_ms']:.3f}")
    bad = sorted({k for h in hist for k in METRIC_NAMES + ("loss",) if not math.isfinite(h[k])})
    if bad:
        raise AssertionError(f"non-finite losses in the train path: {bad}")
    growth = max(h["loss"] for h in hist) / hist[0]["loss"]
    log(f"  largest loss / first step's loss: {growth:.3f} (bar {LOSS_GROWTH_MAX})")
    if not growth <= LOSS_GROWTH_MAX:
        raise AssertionError(f"the train path's loss grew {growth:.3g}x: the run diverges")

    after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    params = {k for k, _ in model.named_parameters()}
    fixed = cfg.network.FIXED_PARAMS
    frozen = [k for k in before if k not in params or is_frozen_path(tuple(k.split(".")), fixed)]
    moved = [k for k in frozen if not torch.equal(before[k], after[k])]
    if moved:
        raise AssertionError(f"frozen tensors changed: {moved[:5]}")
    changed = {grp: any(not torch.equal(before[k], after[k]) for k in params
                        if k.startswith(grp + ".") and k not in frozen)
               for grp in TRAINED_GROUPS}
    n_frozen_params = sum(k in params for k in frozen)
    log(f"  frozen tensors bit-identical after the steps: {len(frozen)} ({n_frozen_params} "
        f"parameters of conv0/stage1, {len(frozen) - n_frozen_params} BN buffers); "
        f"a trainable tensor changed in: {changed}")
    if not all(changed.values()):
        raise AssertionError(f"a trained group did not change: {changed}")

    timed = [h["step_ms"] for h in hist[TRAIN_WARMUP:]]
    stats = {
        "steps": len(hist), "timed_steps": len(timed),
        "step_ms_median": statistics.median(timed), "step_ms": timed,
        "images_per_s": cfg.TRAIN.BATCH_IMAGES * 1e3 / statistics.median(timed),
        "load_ms_median": statistics.median(h["load_ms"] for h in hist[TRAIN_WARMUP:]),
        "first_step_ms": hist[0]["step_ms"],
        "peak_mib": peak_mib, "captured_mib": captured_mib,
    }
    log(f"  train step (host batch to metrics on the host, {len(timed)} steps after "
        f"{TRAIN_WARMUP} warm-up): median {stats['step_ms_median']:.3f} ms, "
        f"{stats['images_per_s']:.3f} images/s; host batch assembly median "
        f"{stats['load_ms_median']:.3f} ms; first step {stats['first_step_ms']:.3f} ms")
    log(f"  max_memory_allocated: {peak_mib:.1f} MiB (of which {captured_mib:.1f} MiB are "
        f"this script's copies of kernel inputs)")
    return cap, launches, model, roidb, stats


def _train_layer_of(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "roi_align_bwd" in name:
        return "roi_align bwd kernel"
    if "roi_align_fwd" in name:
        return "roi_align fwd kernel"
    if "multi_tensor_apply" in name or "foreach" in name:
        return "optimizer (foreach clamp / SGD)"
    return _layer_of(kernel_name).replace("convolutions / matmuls", "convolutions / matmuls, fwd + bwd")


def _profiled(fn):
    """(result, wall ms, CUDA kernel events) of ``fn`` ending in a sync."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return out, wall_ms, [e for e in prof.key_averages() if e.device_type.name == "CUDA"]


def profile_train_step(model, cfg, roidb, dev):
    """One more step on the trained model: forward / backward / optimizer
    spans on the stream (CUDA events, no profiler), then each phase under
    torch.profiler with a sync after it: its wall time, its device busy
    time and the device time by layer."""
    opt = make_optimizer(cfg, model, make_lr_schedule(cfg, len(roidb)))
    step = make_train_step(model, opt, rng=99)
    batch = train_batch(cfg, roidb, 0, dev)
    step(batch)
    torch.cuda.synchronize()

    def forward():
        opt.zero_grad()
        return model(batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
                     train=True, sample_seeds=batch["sample_seeds"], rng=1)[0]

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss = forward()
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    ev[3].synchronize()
    spans = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    log(f"  stream spans (CUDA events, no profiler, host gaps included): forward "
        f"{spans[0]:.3f} ms, backward {spans[1]:.3f} ms, optimizer {spans[2]:.3f} ms")

    loss, fwd_wall, fwd_ev = _profiled(forward)
    _, bwd_wall, bwd_ev = _profiled(loss.backward)
    _, opt_wall, opt_ev = _profiled(opt.step)
    phases = {}
    by_layer, total = {}, 0.0
    for name, wall, events in (("forward", fwd_wall, fwd_ev), ("backward", bwd_wall, bwd_ev),
                               ("optimizer", opt_wall, opt_ev)):
        busy = sum(e.self_device_time_total for e in events) / 1e3
        phases[name] = {"wall_ms": wall, "busy_ms": busy}
        for e in events:
            us = e.self_device_time_total
            total += us
            by_layer[_train_layer_of(e.key)] = by_layer.get(_train_layer_of(e.key), 0.0) + us
    if total == 0:
        log("  profiler saw no device time: breakdown not measured")
        return {"spans_ms": spans}
    for name, ph in phases.items():
        log(f"  {name}: wall {ph['wall_ms']:.3f} ms, device busy {ph['busy_ms']:.3f} ms "
            f"(idle {100 * (1 - ph['busy_ms'] / ph['wall_ms']):.1f}%; profiler on, sync after)")
    log(f"  one train step by layer (device busy {total / 1e3:.3f} ms):")
    for layer, us in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        log(f"    {layer}: {us / 1e3:.3f} ms ({100 * us / total:.1f}%)")
    events = fwd_ev + bwd_ev + opt_ev
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    top: {e.key[:90]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms")
    return {"spans_ms": spans, "phases": phases, "busy_ms": total / 1e3,
            "by_layer_ms": {k: v / 1e3 for k, v in by_layer.items()}}


def argmax_takes_the_first_maximum(dev):
    """``torch.argmax`` on the card returns the first of tied maxima (the
    samplers' gt assignment relies on it, as JAX's does)."""
    row = torch.zeros(100_000, device=dev)
    row[[70_000, 90_000]] = 3.0
    small = torch.tensor([[1.0, 3.0, 3.0, 0.0], [-1.0, -1.0, -1.0, -1.0]], device=dev)
    got = (int(torch.argmax(row)), torch.argmax(small, -1).tolist())
    log(f"  argmax of tied maxima on the card: {got}")
    if got != (70_000, [1, 0]):
        raise AssertionError(f"argmax does not take the first maximum on the card: {got}")


def train_step_agrees(dev):
    """One small train step (ResNet-50, 128 × 128, the same weights and the
    same sampling draws) on the card (kernels, cuDNN) and on the CPU (plain
    versions): identical sampled labels and anchor labels, rois within
    1e-3 px, losses within 1e-4 relative, and every gradient leaf within
    1e-3 of its own L2 norm and within 3e-3 of its largest element (cuDNN's
    f32 convolution algorithms, its split reductions in the weight gradients
    and the atomics of the ROIAlign backward sum in other orders than the
    CPU)."""
    cfg = generate_config("resnet50", "PascalVOC")
    cfg = cfg.replace(
        network=dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4, 8)),
        TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=400, RPN_POST_NMS_TOP_N=64,
                                  BATCH_ROIS=32, RPN_BATCH_SIZE=64),
    )
    model = make_model(cfg, seed=3)
    rng = np.random.RandomState(4)
    # tests/test_model.py::tiny_batch's inputs: pixels in [0, 1), two gts
    images = torch.from_numpy(rng.rand(1, 128, 128, 3).astype(np.float32))
    im_info = torch.tensor([[128.0, 128.0, 1.0]])
    gt = torch.zeros((1, 4, 5))
    gt[0, 0] = torch.tensor([10.0, 10.0, 70.0, 70.0, 1.0])
    gt[0, 1] = torch.tensor([60.0, 60.0, 120.0, 110.0, 2.0])
    gt_valid = torch.tensor([[True, True, False, False]])
    draws = sampling_uniforms(11, [0], 8 * 8 * cfg.network.NUM_ANCHORS, 64 + 4, "cpu")

    runs = {}
    orig = (model_mod.assign_anchor, model_mod.sample_rois)
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        m = copy.deepcopy(model).to(d, memory_format=torch.channels_last)
        make_optimizer(cfg, m, make_lr_schedule(cfg, 10))
        got = {}
        model_mod.assign_anchor = lambda *a, **k: got.setdefault("anchor", orig[0](*a, **k))
        model_mod.sample_rois = lambda *a, **k: got.setdefault("rois", orig[1](*a, **k))
        try:
            loss, aux = m(images.to(d), im_info.to(d), gt.to(d), gt_valid.to(d), train=True,
                          draws={k: v.to(d) for k, v in draws.items()})
        finally:
            model_mod.assign_anchor, model_mod.sample_rois = orig
        loss.backward()
        runs[name] = {
            "loss": float(loss.detach()), "aux": {k: float(v.detach()) for k, v in aux.items()},
            "anchor_labels": got["anchor"].labels.cpu(), "labels": got["rois"].labels.cpu(),
            "rois": got["rois"].rois.cpu(),
            "grads": {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None},
        }
    card, cpu = runs["card"], runs["cpu"]
    same_labels = torch.equal(card["labels"], cpu["labels"]) and torch.equal(
        card["anchor_labels"], cpu["anchor_labels"])
    roi_err = float((card["rois"] - cpu["rois"]).abs().max())
    loss_rel = {k: abs(card["aux"][k] - v) / max(abs(v), 1e-6) for k, v in cpu["aux"].items()}
    loss_rel["loss"] = abs(card["loss"] - cpu["loss"]) / max(abs(cpu["loss"]), 1e-6)
    # per leaf: ||Δ||₂ / ||g||₂ and max|Δ| / max|g|
    leaf = {n: (float((card["grads"][n] - g).norm()) / max(float(g.norm()), 1e-30),
                float((card["grads"][n] - g).abs().max()) / max(float(g.abs().max()), 1e-30))
            for n, g in cpu["grads"].items()}
    worst = sorted(leaf.items(), key=lambda kv: -kv[1][0])[:4]
    grad_rel = worst[0][1][0]
    grad_max_rel = max(v[1] for v in leaf.values())
    log(f"  small train step card vs CPU: fg rois {int(cpu['aux']['num_fg_rois'])}, fg anchors "
        f"{int(cpu['aux']['num_fg_anchors'])}, same labels {same_labels}, rois max|d| {roi_err:.3g} px, "
        f"loss {cpu['loss']:.6f} vs {card['loss']:.6f}, max relative loss/aux diff "
        f"{max(loss_rel.values()):.3g}, gradients over {len(cpu['grads'])} leaves: max "
        f"||d||/||g|| {grad_rel:.3g}, max max|d|/max|g| {grad_max_rel:.3g}")
    for n, (norm_rel, max_rel) in worst:
        log(f"    {n}: ||d||/||g|| {norm_rel:.3g}, max|d|/max|g| {max_rel:.3g}, "
            f"max|g| {float(cpu['grads'][n].abs().max()):.3g}")
    if set(card["grads"]) != set(cpu["grads"]):
        raise AssertionError("card and CPU computed gradients for different tensors")
    if (not same_labels or roi_err > 1e-3 or max(loss_rel.values()) > 1e-4 or grad_rel > 1e-3
            or grad_max_rel > 3e-3):
        raise AssertionError("the small train step disagrees between the card and the CPU")
    if cpu["aux"]["num_fg_rois"] <= 0 or cpu["aux"]["num_fg_anchors"] <= 0:
        raise AssertionError("the small train step sampled no fg rois or anchors")


# ------------------------------------------------------------------ timing
def nms_timing(entry, label):
    boxes, valid, thresh, max_keep = entry
    ms, wrap, plain, bound, by = time_nms(*entry)
    kept = int(nms_mod.nms_mask_sorted(boxes, valid.bool(), thresh, max_keep).sum())
    log(f"  nms {label} {tuple(boxes.shape)} valid={int(valid.sum())} max_keep={max_keep} "
        f"kept={kept}: kernel {ms:.4f} ms (graph), "
        f"wrapper {wrap:.4f} ms (eager), plain {plain:.2f} ms, bound {bound:.7f} ms ({by})")
    return {"ms": ms, "wrapper_ms": wrap, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "shape": list(boxes.shape)}


def roi_fwd_timing(entry, label):
    feat, rois, pooled, scale, s, valid_hw = entry
    ms, wrap, plain = time_kernel(
        lambda: roi_mod.roi_align(feat, rois, pooled, scale, s, valid_hw),
        lambda: roi_mod.roi_align_plain(feat, rois, pooled, scale, s, valid_hw), reps=20)
    out = roi_mod.roi_align(feat, rois, pooled, scale, s, valid_hw)
    bound, by = bound_ms(*roi_work(feat, rois, pooled, scale, s, valid_hw, out))
    log(f"  roi_align {label} feat {tuple(feat.shape)} rois {tuple(rois.shape)}: kernel "
        f"{ms:.4f} ms (graph), wrapper {wrap:.4f} ms (eager), plain {plain:.2f} ms, "
        f"bound {bound:.5f} ms ({by})")
    return {"ms": ms, "wrapper_ms": wrap, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "shape": list(feat.shape) + list(rois.shape)}


def roi_bwd_timing(entry, label):
    g, rois, shape, pooled, scale, s, valid_hw = entry
    ms, wrap, plain = time_kernel(
        lambda: roi_mod._roi_align_bwd_cuda(g, rois, shape, pooled, scale, s, valid_hw),
        lambda: roi_mod.roi_align_bwd_plain(g, rois, shape, pooled, scale, s, valid_hw), reps=20)
    bound, by = bound_ms(*roi_bwd_work(g, rois, shape, valid_hw))
    log(f"  roi_align_bwd {label} g {tuple(g.shape)} -> {tuple(shape)}: kernel {ms:.4f} ms "
        f"(graph), wrapper {wrap:.4f} ms (eager), plain {plain:.2f} ms, bound {bound:.5f} ms ({by})")
    return {"ms": ms, "wrapper_ms": wrap, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "shape": list(g.shape) + list(shape)}


def _prefixed(prefix, d):
    return {f"{prefix}_{k}": v for k, v in d.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.monotonic()
    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi} | torch: {kind} x{torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[card] TF32 off for cuDNN convolutions and matmuls: full float32")

    libraries = (nms_mod.library, roi_mod.library)
    t0 = time.monotonic()
    build_all(libraries)
    log(f"[build] {len(libraries)} libraries in {time.monotonic() - t0:.1f} s (parallel nvcc); "
        f"launchers: {nms_mod.kernel.function} ({nms_mod.library.source.name}), "
        f"{roi_mod.kernel.function} and {roi_mod.bwd_kernel.function} "
        f"({roi_mod.library.source.name})")
    for lib in libraries:
        secs = lib.build_seconds
        log(f"  {lib.source.name}: {secs if secs is None else round(secs, 1)} s")
        for line in lib.ptxas_log.splitlines():
            if "ptxas info" in line or "spill" in line:
                log(f"    {line.strip()}")

    nms_diff, bwd_diff = MaskDiff(), BwdDiff()
    log("[nms] kernel vs plain, synthetic")
    nms_synthetic(nms_diff, dev)
    log("[roi_align] forward kernel vs plain, synthetic")
    roi_err = roi_synthetic(dev)
    log("[roi_align_bwd] backward kernel vs plain, synthetic")
    roi_bwd_synthetic(bwd_diff, dev)

    cfg = generate_config("resnet", "PascalVOC")
    log(f"[main path] serving: ResNet-{cfg.network.depth} C4, {cfg.dataset.NUM_CLASSES} classes, "
        f"buckets {cfg.SHAPE_BUCKETS}, {cfg.TEST.RPN_PRE_NMS_TOP_N}->{cfg.TEST.RPN_POST_NMS_TOP_N} "
        f"proposals, device postprocess")
    cap, serve_launches, predictor, image = main_path(cfg, dev)
    log("[main path] serving kernels vs plain on the captured tensors")
    roi_err = max(roi_err, hold_captured(nms_diff, cap, bwd_diff))

    t = cfg.TRAIN
    log(f"[train] ResNet-{cfg.network.depth} C4, {cfg.dataset.NUM_CLASSES} classes, BATCH_IMAGES "
        f"{t.BATCH_IMAGES}, BATCH_ROIS {t.BATCH_ROIS}, {t.RPN_PRE_NMS_TOP_N}->{t.RPN_POST_NMS_TOP_N} "
        f"proposals, {TRAIN_STEPS} steps of fit on synthetic 480x640 images")
    train_cap, launches, model, roidb, train_stats = train_path(cfg, dev)
    log("[train] kernels vs plain on the captured tensors")
    roi_err = max(roi_err, hold_captured(nms_diff, train_cap, bwd_diff))
    log("[train] full-width gradient vs finite differences of the loss")
    train_stats["fd_worst"] = gradient_matches_finite_differences(model, cfg, roidb, dev)

    log("[timing] serving shapes, on the batch-of-2 call's captured tensors")
    serve_nms = nms_timing([c for c in cap.nms if c[3] > 0][-1], "proposals")
    classes = nms_timing([c for c in cap.nms if c[3] == 0][-1], "classes")
    serve_roi = roi_fwd_timing(cap.roi[-1], "serving")
    log("[timing] train shapes, on the train steps' captured tensors")
    train_nms = nms_timing(train_cap.nms[-1], "train proposals")
    train_roi = roi_fwd_timing(train_cap.roi[-1], "train")
    train_bwd = roi_bwd_timing(train_cap.roi_bwd[-1], "train")

    log("[profile] where one request's device time goes")
    profile_request(predictor, cfg, image)
    log("[profile] where one train step's device time goes")
    train_stats["profile"] = profile_train_step(model, cfg, roidb, dev)

    log("[reference] small request, card vs CPU")
    small_request_agrees(cfg, dev)
    log("[train reference] small train step, card vs CPU")
    argmax_takes_the_first_maximum(dev)
    train_step_agrees(dev)

    log(f"[train] stats {json.dumps(train_stats)}")
    log(f"[done] {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {
            "name": "nms", "route": "cuda", "source": "mx_rcnn_tpu_torch/csrc/nms.cu",
            "replaces": "mx_rcnn_tpu/ops/pallas/nms.py:40",
            "launches": launches["nms"], "serve_launches": serve_launches["nms"],
            "max_abs_err": nms_diff.max_abs_err, "mismatches": nms_diff.mismatches,
            **train_nms, "library_ms": None,
            **_prefixed("serve", serve_nms), **_prefixed("class", classes),
        },
        {
            "name": "roi_align_fwd", "route": "cuda", "source": "mx_rcnn_tpu_torch/csrc/roi_align.cu",
            "replaces": "mx_rcnn_tpu/ops/pallas/roi_align.py:88",
            "launches": launches["roi_align_fwd"], "serve_launches": serve_launches["roi_align_fwd"],
            "max_abs_err": roi_err, **train_roi, "library_ms": None,
            **_prefixed("serve", serve_roi),
        },
        {
            "name": "roi_align_bwd", "route": "cuda", "source": "mx_rcnn_tpu_torch/csrc/roi_align.cu",
            "replaces": "mx_rcnn_tpu/ops/pallas/roi_align.py:148",
            "launches": launches["roi_align_bwd"], "max_abs_err": bwd_diff.max_abs_err,
            "scaled_err": bwd_diff.scaled_err, **train_bwd, "library_ms": None,
        },
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
