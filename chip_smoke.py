#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit, torch's name and
   device count) and turns TF32 off for convolutions and matmuls;
2. builds the hand-written kernels from ``mx_rcnn_tpu_torch/csrc`` with nvcc
   for sm_90a (one nvcc per source, all started together: ``nms.cu`` exports
   the NMS launcher, ``roi_align.cu`` the resident ROIAlign forward and
   backward, ``roi_align_stream.cu`` the streamed ones; the two ROIAlign
   sources share the backward's table and tile kernels of
   ``roi_align_table.cuh`` and the forward template of ``roi_align_fwd.cuh``)
   and prints ptxas' register / shared-memory / spill lines, and one summary
   line of the registers and spills of the kernels redesigned since the
   first port (all five) as the paths launch them;
3. holds the NMS kernel against its plain PyTorch version on the card at the
   serving proposal shape (2 × 6000 sorted, max_keep 300, IoU 0.7), the
   train proposal shape (1 × 12000 sorted, max_keep 2000, IoU 0.7), the
   per-class shape (2 × 20 problems × 300 unsorted, IoU 0.3), N = 1000
   (not a multiple of 64) with invalid rows and the FPN union shape (1 ×
   9504 unsorted, IoU 0.7, no stop, through ``nms_mask``): the keep masks
   must be identical;
4. holds the ROIAlign forward kernel (2) against its plain version at
   (1, 64, 64, 1024), R = 300, and at the train shape (1, 38, 64, 1024),
   R = 128, both 14 × 14, s = 2, with and without ``valid_hw``, degenerate
   and off-canvas rois included: max |Δ| ≤ 1e-5; the ROIAlign backward
   kernel (3) against its plain scatter-add at the train shape, with and
   without ``valid_hw``: |Δ| ≤ 1e-4 · max(1, Σ|terms|) (the plain version
   sums with atomics in a run-dependent order, and a float32 sum's rounding
   grows with the sum of its terms' magnitudes) and two launches
   bit-identical; and the streamed kernels 4 and 5 against theirs
   at FPN's P2 (1, 152, 256, 256) and P3 (1, 76, 128, 256), 128 rois,
   pooled 14 and 7, inverted, off-map, tiny and map-sized rois included:
   forward max |Δ| ≤ 1e-5, backward the scaled 1e-4 bar and two launches
   bit-identical; and the run-time sample-ratio instances at s = 5: kernel 2
   with and without ``valid_hw`` and kernel 4 against their plain versions
   (max |Δ| ≤ 1e-5, 0 expected), kernels 3 and 5 at the scaled bar and
   bit-identical across two launches;
5. serves VOC-sized requests through full-width ResNet-101 C4 Faster R-CNN
   (``generate_config("resnet", "PascalVOC")``, seeded random weights) with
   ``detect_single`` in both buckets, plus a same-bucket batch of 2 through
   the ``Predictor``; the kernels' launch counts are reset just before and
   read just after, and NMS and kernel 2 must be > 0.  The tensors the path
   fed the kernels are captured and each kernel is held against its plain
   version on them; one request is profiled (device time by layer); a small
   request runs on the card and on the CPU (plain versions) and the two
   must agree;
6. trains the same model (full width, BATCH_ROIS 128, 12000 → 2000
   proposals) for 10 steps through ``core/fit.py::fit`` (its defaults: a
   prefetching loader, the device feed on a copy stream, every step under
   the divergence guard) on 8 synthetic
   480 × 640 images (600 × 800 in the 608 × 1024 bucket: a 38 × 64 × 1024
   feature map), then ResNet-50 FPN (``generate_config("resnet_fpn",
   "PascalVOC")``: P2..P6, 12000 → 2000 proposals from the levels' top-k
   union) the same way.  Each run resets the launch counts just before and
   reads them just after: a C4 step launches NMS and kernels 2 and 3 once,
   an FPN step NMS once and kernels 2–5 twice (P2/P3 streamed, P4/P5
   resident).  The random weights are calibrated first on one batch of the
   8 training images (``calibration_batch``): the frozen BN moments
   (unit-scale activations, as a pretrained backbone's give) and, for FPN,
   the output scale of the neck's convs and the 2-fc head
   (``calibrate_scales``).  Every loss must be finite and none
   above 100× the first step's, every frozen tensor bit-identical after the
   steps and some trainable tensor of each trained group changed; each
   kernel is held against its plain version on the tensors the steps fed
   it; the loss's central difference along each trained group's gradient
   must match the gradient within 1e-2; one step of each is profiled
   (forward / backward / optimizer, device time by layer); one small step
   of each (128 × 128) runs on the card and on the CPU with the same weights
   and sampling draws, and the two must agree;
   ``[mask train]``: Mask R-CNN ResNet-101 FPN
   (``generate_config("mask_resnet_fpn", "coco")``: 81 classes, BATCH_ROIS
   128 of which the mask branch takes the first 32, MASK_SIZE 28,
   MASK_GT_SIZE 64) the same way on 8 synthetic 480 × 640 polygon images and
   their flipped copies (``load_gt_roidb(flip=True)``), the batches carrying
   the gt masks: a step launches NMS once and kernels 2–5 four times each
   (the mask branch pools its 32 rois again, with the backward), the
   captured calls of both branches are held against the plain versions,
   ``MaskBCELoss`` is held to the loss gates on its own, a mask head
   weight must change, the finite differences move the mask head and the
   neck; printed: host syncs in one step, one profiled step and its mask
   branch split into pooling, head, targets and BCE, and a small mask step
   (ResNet-50 depth, polygon gt masks) runs on the card and on the CPU;
7. ``[pipeline]``: from each path's calibrated weights, 10 steps of ``fit``
   in each of three loop settings, serial (no prefetch, no pool, feed depth
   1, aux every step), ``fit``'s defaults (prefetch 2, feed depth 2) and the
   card CLI's (aux every 8 steps, an assembly pool of N workers chosen from
   the host's cores), and the serial one again, under cuDNN's deterministic
   mode: the batch digests, the losses and the final parameters must be
   identical, and the kernels must launch their count per dispatched step;
   FPN then runs with ``MX_RCNN_FAULTS=nan_loss@5`` at aux_interval 4 and
   1: one batch skipped, one window rollback, and the same final parameters.
   Printed: loop images/s, the step thread's wait for a batch, feed and
   pool occupancy, the aux sink's fetches and stalls, the guard snapshot's
   cost, host syncs in one step (``set_sync_debug_mode``; at aux_interval 1
   they must be 1, the guard's aux fetch, here and in ``[mask train]``) and
   nproc;
   ``[checkpoint]``: the Mask R-CNN ``[mask train]`` run's final state is
   saved (``core/checkpoint.py``), loaded into a freshly built model and
   optimizer and held bitwise; then, from the calibrated C4 weights, under
   cuDNN's deterministic mode, on 4 synthetic images, batch 1, 2 epochs:
   ``fit(prefix=A)`` uninterrupted; ``fit(prefix=B)`` stopped by a real
   SIGTERM from a helper thread once its stream log has 5 lines
   (``stall@5:10`` holds it there), which must commit a ``step_0001_B``
   dump; ``fit(prefix=B, resume=True)``.  The concatenated stream log must
   equal the golden one line for line, the epoch dumps' checksums A's, the
   final ``state_dict``, momentum and count the golden run's bitwise, and
   the resumed run must launch NMS and kernels 2 and 3 once a step; a
   one-epoch ``fit(step_timeout=3)`` whose step 2 is followed on the card
   by a 10 s spin kernel must see the watchdog commit its dump from the
   snapshot's host mirror and exit while the spin still runs, and the
   dump's resume must write the golden ``epoch_0001`` checksum.  Then
   ``tools/test.py --synthetic 8`` on the card evaluates A's newest dump,
   its ``--epoch 1`` and ``--params`` of the golden run's final weights:
   the newest dump's detections must equal ``--params``' bitwise, and NMS
   and kernel 2 launch.  Printed: each dump's bytes and save / load
   seconds, the stop position and the seconds from SIGTERM to the commit;
   ``[alternate]``: the four-stage schedule (``tools/train_alternate.py``)
   at full width, ResNet-101 C4 on 8 synthetic 480 × 640 images and their
   flipped copies, 6 steps of ``fit`` a training stage, from the calibrated
   ``[train]`` weights as the donor: each stage's launch counts are reset
   just before it and read just after (RPN stages launch nothing, Fast
   R-CNN kernel 2 once a step and kernel 3 once a step of stage 3 (stage 5
   freezes the whole backbone, so no gradient reaches the feature map),
   each proposal pass
   (``test_rpn``, 1 × 20000 → 2000 at IoU 0.7) one NMS an image); every
   proposal pass's NMS and the first Fast R-CNN steps' ROIAlign calls are
   held against their plain versions; losses finite and under the 100×
   gate; every stage's frozen leaves (FIXED_PARAMS in stages 1 and 3,
   FIXED_PARAMS_SHARED in stages 4 and 5) bitwise its donor's and
   ``final.pkl``'s backbone bitwise RPN-2's; ``tools/test.py --params
   final.pkl --synthetic 8`` applies the run's per-class statistics and
   launches NMS 16 and kernel 2 8 times; the finite differences of Fast
   R-CNN-1's groups; printed: recall@300/1000/2000 of both passes, each
   stage's step median, the passes' images/s, peak memory.  ``[frozen
   fpn]``: ResNet-50 FPN's frozen-proposal mode at full width, the
   ``[fpn train]`` weights' own proposals (20000 → 2000) over the 8 images
   and their flips, 4 steps of ``fit(proposal_count=2000)``: no NMS, kernels
   2–5 twice a step, the captured calls held against the plain versions;
8. ``[eval]``: ``pred_eval`` over 32 synthetic VOC-sized (375 × 500) images
   with the calibrated C4 weights the ``[train]`` run started from, in five
   settings: serial (batch 1, no feed, one forward in flight), the JAX
   package's defaults (feed depth 2, two in flight), batches of 2 from a
   pool of N assembly processes with 2 completion threads (the async and
   the threads dispatch modes), and the host decode + C NMS branch
   (``DEVICE_POSTPROCESS`` off).  Gates: serial and the defaults give
   bit-identical detections and equal mAP, image 0's equal
   ``detect_single``'s on the same pixels, the batched settings and the host
   branch keep the same detections within the bars, NMS and kernel 2 launch
   in every setting and equal their plain versions on the eval path's
   tensors, the host NMS loaded its C library, and a small eval agrees
   between the card and the CPU.  Printed: images/s per setting, the
   dispatch thread's wait per batch, the feed's and the completion pool's
   counters, host syncs per forward, launches per image, peak memory;
9. ``[fpn serve]`` and ``[mask serve]``: ResNet-50 FPN
   (``generate_config("resnet_fpn", "coco")``) and Mask R-CNN ResNet-101 FPN
   (``"mask_resnet_fpn"``) at full width (81 classes, the 256-channel neck,
   14 × 14 pooling, the 28 × 28 mask head), seeded weights calibrated on the
   first request by inference forwards, serve six synthetic COCO-like
   requests in both buckets and a same-bucket batch of 2: FPN through
   ``detect_single``, the mask model through the Predictor with the device
   canvas paste, ``detections_from_output``, the cap and
   ``rles_for_detections``.  The launch counts of the run must be NMS 2 and
   kernel 2 4 (FPN) or 8 (mask) a forward; the kernels are held against
   their plain versions on the captured tensors, every device canvas of the
   batch bitwise against ``paste_mask_canvas``; printed: request latency,
   peak memory, the paste's ms and memory, host syncs in one forward on a
   staged batch (must be 0) and one profiled request.  ``[mask eval]``:
   ``pred_eval`` of the mask model over 32 synthetic 480 × 640 masked
   images, serial and the JAX package's defaults, which must give
   bit-identical detections and RLEs and equal box mAP and segm stats;
   images/s.  A small request of each runs on the card and on the CPU and
   the two must agree;
10. times each kernel on captured tensors: NMS and kernel 2 at the serving
   shapes (the batch-of-2 call), NMS and kernels 2–3 at the C4 train shapes,
   and at the FPN train shapes NMS, kernels 4–5 at P2 and P3, kernels 2–3
   at P4 and, for the comparison of the two tap rules' kernels, at P2 (and
   kernel 2 at P3): its device time
   from a CUDA graph of the wrapper (``ms``), the eager wrapper
   (``wrapper_ms``) and the eager plain version (``plain_ms``), beside the
   bound for the work this data needs; and NMS (the levels' union, the
   classes) and kernel 2 (P2..P5, and the mask branch's P2) at the FPN and
   mask serving shapes, and kernels 2–5 at P2..P5 on the mask branch's
   train tensors (R = 32), and the proposal dump's NMS (1 × 20000 → 2000)
   and Fast R-CNN's kernels 2 and 3 on the ``[alternate]`` run's tensors;
   small RPNOnly and Fast R-CNN steps run on the card and on the CPU and
   must agree;
11. prints one JSON line with each kernel's launches, max error, times and
   bound, then the ``nvidia-smi`` line, then the device line last.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import json
import math
import os
import pickle
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.checkpoint import (
    DATA_FILE,
    latest_checkpoint,
    load_checkpoint,
    read_manifest,
    restorable_checkpoints,
    save_checkpoint,
)
from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.core.metrics import METRIC_NAMES
from mx_rcnn_tpu_torch.core.pipeline import PipelinedLoop, batch_to_device
from mx_rcnn_tpu_torch.core import tester as tester_mod
from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval
from mx_rcnn_tpu_torch.core.train import (
    create_train_state,
    is_frozen_path,
    make_lr_schedule,
    make_optimizer,
    train_step,
)
from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.data.loader import (
    TestLoader,
    _orientation_bucket,
    build_test_batch,
    load_record_image,
    make_batch,
)
from mx_rcnn_tpu_torch.data.masks import polygons_to_box_frame
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset, shape_polygon
from mx_rcnn_tpu_torch.eval.segm import paste_mask_canvas, rles_for_detections
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.models.faster_rcnn import sampling_uniforms
from mx_rcnn_tpu_torch.models.fpn import mask_bce
from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm, normalize_images
from mx_rcnn_tpu_torch.models.stage_models import FastRCNN, RPNOnly
from mx_rcnn_tpu_torch.native import hostops
from mx_rcnn_tpu_torch.ops import nms as nms_mod
from mx_rcnn_tpu_torch.ops import roi_align as roi_mod
from mx_rcnn_tpu_torch.ops import roi_align_stream as stream_mod
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess
from mx_rcnn_tpu_torch.serve.buckets import BucketLadder
from mx_rcnn_tpu_torch.serve import runner as runner_mod
from mx_rcnn_tpu_torch.serve.runner import cap_detections, detect_single, prepare_request
from mx_rcnn_tpu_torch.tools import test as test_cli
from mx_rcnn_tpu_torch.tools import test_rpn as test_rpn_mod
from mx_rcnn_tpu_torch.tools import train_alternate as alt_mod
from mx_rcnn_tpu_torch.tools.kernel_bench import fpn_union, graph_ms
from mx_rcnn_tpu_torch.utils import faults
from mx_rcnn_tpu_torch.utils.bridge import _leaves as tree_leaves
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, torch_to_flax
from mx_rcnn_tpu_torch.utils.combine_model import load_params, save_params
from mx_rcnn_tpu_torch.utils.cuda_build import build_all
from mx_rcnn_tpu_torch.utils.load_data import attach_proposals, load_gt_roidb
from mx_rcnn_tpu_torch.utils.run_meta import load_run_meta, save_run_meta

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
# the finite-difference steps, as the share of the loss each moves it by
FD_STEPS = tuple(1e-3 / 2**i for i in range(7))
NUM_CLASSES = 21
TRAIN_STEPS = 10
TRAIN_WARMUP = 2
REQUEST_HW = [(375, 500), (500, 375), (480, 640), (640, 480), (333, 500), (500, 333)]
DEVICE = "cuda"


# (tag, start) of each phase: a line "[tag] ..." after lines of another tag
# starts one
PHASES = []


def log(msg: str) -> None:
    if msg.startswith("[") and "]" in msg:
        tag = msg[1:msg.index("]")]
        if not PHASES or PHASES[-1][0] != tag:
            PHASES.append((tag, time.monotonic()))
    print(msg, flush=True)


def phase_seconds(end: float) -> dict:
    """Seconds spent in each phase, summed over its runs of lines."""
    out = {}
    for (tag, t0), (_, t1) in zip(PHASES, PHASES[1:] + [("", end)]):
        out[tag] = round(out.get(tag, 0.0) + t1 - t0, 1)
    return out


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
    # survivor (an 18 MB mask scratch)
    boxes = torch.from_numpy(random_boxes(rng, 1, 12000, 1024, 608, 300)).to(dev)
    valid = torch.ones((1, 12000), dtype=torch.bool, device=dev)
    nms_case(diff, boxes, valid, 0.7, 2000, "train proposals")
    # FPN union shape: 1 × 9504 anchor-like boxes in random score order,
    # through the full contract (sort, kernel, scatter back) against the
    # same contract with the plain sweep, on the card; no stop
    boxes = torch.from_numpy(fpn_union(rng)).to(dev)
    scores = torch.from_numpy(rng.rand(1, boxes.shape[1]).astype(np.float32)).to(dev)
    got = nms_mod.nms_mask(boxes, scores, 0.7)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    ref = torch.zeros_like(got).scatter(
        1, order, nms_mod.nms_mask_sorted_plain(sb, torch.ones_like(got), 0.7))
    bad = diff.add(got, ref)
    log(f"  nms FPN union (unsorted, nms_mask): P=1 N={boxes.shape[1]} thresh=0.7 "
        f"kept={int(got.sum())} mismatches={bad}")
    if bad:
        raise AssertionError("NMS kernel disagrees with the plain version (FPN union)")


# ------------------------------------------------------------- ROIAlign
def roi_work(feat, rois, pooled, scale, s, valid_hw, out, keep=None):
    """Bytes the function must move and the flops it does: the feature cells
    some roi's samples read (each once, all channels), the rois, valid_hw
    and the output.  ``keep`` (B, R): the rois that pool at all (the
    streamed function's inverted rois read nothing and write zeros)."""
    b, h, w, c = feat.shape
    r = rois.float() * scale
    keep = torch.ones(r.shape[:2], device=feat.device) if keep is None else keep.float()
    taps = []
    for axis, size, (c1, c2), nbins in ((0, h, (1, 3), pooled[0]), (1, w, (0, 2), pooled[1])):
        lim = None if valid_hw is None else valid_hw[:, axis]
        lim_f, lim_i = roi_mod._feat_limits(size, lim, scale, b, feat.device)
        lo, hi, _, _ = roi_mod._axis_taps(r[..., c1], r[..., c2], nbins, s, lim_f, lim_i)
        hit = torch.zeros(lo.shape[:2] + (size,), device=feat.device)
        taps.append(hit.scatter_(2, lo, 1.0).scatter_(2, hi, 1.0) * keep[..., None])
    cells = int((torch.einsum("brh,brw->bhw", *taps) > 0).sum())
    nbytes = (cells * c + rois.numel() + out.numel()
              + (0 if valid_hw is None else valid_hw.numel())) * 4
    pooled_outputs = out.numel() // keep.numel() * float(keep.sum())
    return nbytes, pooled_outputs * ROI_FLOPS_PER_OUTPUT


def roi_case(feat, rois, valid_hw, label, s=2):
    got = roi_mod.roi_align(feat, rois, (14, 14), 1.0 / 16, s, valid_hw)
    ref = roi_mod.roi_align_plain(feat, rois, (14, 14), 1.0 / 16, s, valid_hw)
    err = float((got - ref).abs().max())
    log(f"  roi_align {label}: feat={tuple(feat.shape)} R={rois.shape[1]} s={s} max|d|={err:.3g}")
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
    of |g| (the weights are ≥ 0), which the bar holds to ROI_BWD_TOL; and
    whether two launches gave bit-identical dfeat (they must: no atomics)."""

    def __init__(self):
        self.max_abs_err, self.scaled_err, self.repeatable = 0.0, 0.0, True

    def add(self, g, rois, shape, pooled, scale, s, valid_hw, label):
        got = roi_mod._roi_align_bwd_cuda(g, rois, shape, pooled, scale, s, valid_hw)
        again = roi_mod._roi_align_bwd_cuda(g, rois, shape, pooled, scale, s, valid_hw)
        ref = roi_mod.roi_align_bwd_plain(g, rois, shape, pooled, scale, s, valid_hw)
        mag = roi_mod.roi_align_bwd_plain(g.abs(), rois, shape, pooled, scale, s, valid_hw)
        d = (got - ref).abs()
        err, scaled = float(d.max()), float((d / mag.clamp_min(1.0)).max())
        same = torch.equal(got, again)
        self.max_abs_err = max(self.max_abs_err, err)
        self.scaled_err = max(self.scaled_err, scaled)
        self.repeatable &= same
        log(f"  roi_align_bwd {label}: g={tuple(g.shape)} -> {tuple(shape)} max|d|={err:.3g} "
            f"max|d|/max(1,sum|terms|)={scaled:.3g} max|plain|={float(ref.abs().max()):.3g} "
            f"two launches bit-identical={same}")
        if not scaled <= ROI_BWD_TOL or not same:
            raise AssertionError(f"ROIAlign backward kernel fails its bars ({label})")


def roi_bwd_synthetic(diff, dev):
    """Kernel 3 at the train shape: g (1, 128, 14, 14, 1024) → (1, 38, 64, 1024)."""
    rng = np.random.RandomState(5)
    rois = torch.from_numpy(synthetic_rois(rng, 128, 608, 1024)[None]).to(dev)
    g = torch.from_numpy(rng.randn(1, 128, 14, 14, 1024).astype(np.float32)).to(dev)
    shape = (1, 38, 64, 1024)
    diff.add(g, rois, shape, (14, 14), 1.0 / 16, 2, None, "train shape, canvas clamp")
    valid_hw = torch.tensor([[600.0, 800.0]], device=dev)
    diff.add(g, rois, shape, (14, 14), 1.0 / 16, 2, valid_hw, "train shape, valid_hw clamp")


# ---------------------------------------------------- streamed ROIAlign
class StreamDiff:
    """Running comparison of kernels 4 and 5 with their plain versions:
    the forward's max |Δ| (bar ROI_TOL); the backward's max |Δ| and max
    |Δ| / max(1, Σ|terms|) (bar ROI_BWD_TOL), and whether two launches of
    the backward gave bit-identical dfeat (they must: no atomics)."""

    def __init__(self):
        self.fwd_err, self.bwd_err, self.bwd_scaled, self.repeatable = 0.0, 0.0, 0.0, True

    def fwd(self, feat, rois, pooled, scale, s, label):
        got = stream_mod._roi_align_stream_cuda(feat, rois, pooled, scale, s)
        ref = stream_mod.roi_align_stream_plain(feat, rois, pooled, scale, s)
        err = float((got - ref).abs().max())
        self.fwd_err = max(self.fwd_err, err)
        inverted = ~stream_mod.valid_rois(rois, scale)
        log(f"  roi_align_stream {label}: feat={tuple(feat.shape)} R={rois.shape[1]} "
            f"({int(inverted.sum())} inverted) pooled={tuple(pooled)} max|d|={err:.3g}")
        if not err <= ROI_TOL or got[inverted].any():
            raise AssertionError(f"streamed ROIAlign kernel disagrees with the plain version ({label})")

    def bwd(self, g, rois, shape, pooled, scale, s, label):
        got = stream_mod._roi_align_stream_bwd_cuda(g, rois, shape, pooled, scale, s)
        again = stream_mod._roi_align_stream_bwd_cuda(g, rois, shape, pooled, scale, s)
        ref = stream_mod.roi_align_stream_bwd_plain(g, rois, shape, pooled, scale, s)
        mag = stream_mod.roi_align_stream_bwd_plain(g.abs(), rois, shape, pooled, scale, s)
        d = (got - ref).abs()
        err, scaled = float(d.max()), float((d / mag.clamp_min(1.0)).max())
        same = torch.equal(got, again)
        self.bwd_err, self.bwd_scaled = max(self.bwd_err, err), max(self.bwd_scaled, scaled)
        self.repeatable &= same
        log(f"  roi_align_stream_bwd {label}: g={tuple(g.shape)} -> {tuple(shape)} max|d|={err:.3g} "
            f"max|d|/max(1,sum|terms|)={scaled:.3g} max|plain|={float(ref.abs().max()):.3g} "
            f"two launches bit-identical={same}")
        if not scaled <= ROI_BWD_TOL or not same:
            raise AssertionError(f"streamed ROIAlign backward kernel fails its bars ({label})")


def stream_rois(rng, r, h_img, w_img):
    """``synthetic_rois`` (whole canvas, sub-cell, off canvas, degenerate,
    inverted) plus one roi above and left of the map, a tiny one and an
    inverted one inside the map."""
    rois = synthetic_rois(rng, r, h_img, w_img)
    rois[5] = [-80, -60, -20, -10]
    rois[6] = [10, 10, 13, 12]
    rois[7] = [w_img / 2, 30, w_img / 2 - 40, 90]
    return rois


def stream_synthetic(diff, dev):
    """Kernels 4 and 5 at the FPN train shapes: P2 (1, 152, 256, 256) at 1/4
    and P3 (1, 76, 128, 256) at 1/8, 128 rois on the 608 × 1024 canvas,
    pooled 14 and 7."""
    rng = np.random.RandomState(6)
    for h, w, stride in ((152, 256, 4), (76, 128, 8)):
        feat = torch.from_numpy(rng.randn(1, h, w, 256).astype(np.float32)).to(dev)
        rois = torch.from_numpy(stream_rois(rng, 128, 608, 1024)[None]).to(dev)
        for pooled in ((14, 14), (7, 7)):
            label = f"P{int(math.log2(stride))} pooled {pooled[0]}"
            diff.fwd(feat, rois, pooled, 1.0 / stride, 2, label)
            g = torch.from_numpy(rng.randn(1, 128, *pooled, 256).astype(np.float32)).to(dev)
            diff.bwd(g, rois, tuple(feat.shape), pooled, 1.0 / stride, 2, label)


# the sample ratio of the run-time instances' phase: past the compiled-in 1..4
RUNTIME_S = 5


def runtime_s_synthetic(dev):
    """The run-time sample-ratio instances at s = RUNTIME_S (no configuration
    uses s > 4): kernel 2 with and without ``valid_hw`` at the C4 train shape
    and kernel 4 at P2 against their plain versions (max |Δ| ≤ ROI_TOL; the
    kernels add in the plain version's order, so 0 is expected where the
    plain mean adds in that order too), kernels 3 and 5 (whose tables take
    any s) at the scaled bar and bit-identical across two launches.  Returns
    kernel 2's max |Δ| and the comparisons of kernel 3 (a BwdDiff) and of
    kernels 4 and 5 (a StreamDiff), kept apart from the s = 2 ones."""
    bwd_diff, stream_diff = BwdDiff(), StreamDiff()
    rng = np.random.RandomState(7)
    s = RUNTIME_S
    feat = torch.from_numpy(rng.randn(1, 38, 64, 1024).astype(np.float32)).to(dev)
    rois = torch.from_numpy(synthetic_rois(rng, 128, 608, 1024)[None]).to(dev)
    valid_hw = torch.tensor([[600.0, 800.0]], device=dev)
    err = max(roi_case(feat, rois, None, "train shape, canvas clamp", s),
              roi_case(feat, rois, valid_hw, "train shape, valid_hw clamp", s))
    g = torch.from_numpy(rng.randn(1, 128, 14, 14, 1024).astype(np.float32)).to(dev)
    bwd_diff.add(g, rois, tuple(feat.shape), (14, 14), 1.0 / 16, s, None,
                 f"s={s} train shape, canvas clamp")
    feat = torch.from_numpy(rng.randn(1, 152, 256, 256).astype(np.float32)).to(dev)
    rois = torch.from_numpy(stream_rois(rng, 128, 608, 1024)[None]).to(dev)
    stream_diff.fwd(feat, rois, (14, 14), 0.25, s, f"s={s} P2 pooled 14")
    g = torch.from_numpy(rng.randn(1, 128, 14, 14, 256).astype(np.float32)).to(dev)
    stream_diff.bwd(g, rois, tuple(feat.shape), (14, 14), 0.25, s, f"s={s} P2 pooled 14")
    return err, bwd_diff, stream_diff


# ------------------------------------------------------------ main path
def make_model(cfg, seed: int = 0, cls=None):
    """The config's model (``build_model``, or the graph ``cls``: a stage
    model) with seeded random weights (no checkpoint is on disk).  The RPN
    output layers, where the graph has them, are scaled down 1000× so
    proposals stay near their anchors: the lecun-initialized head on
    raw-pixel inputs emits deltas of ~75, which would clip nearly every
    proposal to the whole image."""
    gen = torch.Generator().manual_seed(seed)
    model = build_model(cfg, generator=gen) if cls is None else cls(cfg, generator=gen)
    if hasattr(model, "rpn"):
        with torch.no_grad():
            for layer in (model.rpn.rpn_cls_score, model.rpn.rpn_bbox_pred):
                layer.weight.mul_(1e-3)
    return model


def request_images(seed: int = 2):
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in REQUEST_HW]


class Capture:
    """Records the inputs a path hands each kernel's launcher: every NMS
    call, and the first ``keep`` calls of each ROIAlign forward and backward
    (all when None; the train paths keep 2, so the copies add little to
    their peak memory and nothing measurable to their steps)."""

    def __init__(self, keep=None):
        self.keep = keep
        self.nms, self.roi, self.roi_bwd, self.stream, self.stream_bwd = [], [], [], [], []
        self._orig = (nms_mod._nms_mask_sorted_cuda, roi_mod._roi_align_cuda,
                      roi_mod._roi_align_bwd_cuda, stream_mod._roi_align_stream_cuda,
                      stream_mod._roi_align_stream_bwd_cuda)

    def __enter__(self):
        orig_nms, orig_roi, orig_bwd, orig_stream, orig_stream_bwd = self._orig

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

        def stream_rec(feat, rois, pooled, scale, s):
            if self.keep is None or len(self.stream) < self.keep:
                self.stream.append((feat.clone(), rois.clone(), pooled, scale, s))
            return orig_stream(feat, rois, pooled, scale, s)

        def stream_bwd_rec(g, rois, feat_shape, pooled, scale, s):
            if self.keep is None or len(self.stream_bwd) < self.keep:
                self.stream_bwd.append((g.clone(), rois.clone(), tuple(feat_shape), pooled, scale, s))
            return orig_stream_bwd(g, rois, feat_shape, pooled, scale, s)

        nms_mod._nms_mask_sorted_cuda, roi_mod._roi_align_cuda = nms_rec, roi_rec
        roi_mod._roi_align_bwd_cuda = bwd_rec
        stream_mod._roi_align_stream_cuda = stream_rec
        stream_mod._roi_align_stream_bwd_cuda = stream_bwd_rec
        return self

    def __exit__(self, *exc):
        (nms_mod._nms_mask_sorted_cuda, roi_mod._roi_align_cuda,
         roi_mod._roi_align_bwd_cuda, stream_mod._roi_align_stream_cuda,
         stream_mod._roi_align_stream_bwd_cuda) = self._orig
        return False


KERNELS = {
    "nms": nms_mod.kernel, "roi_align_fwd": roi_mod.kernel, "roi_align_bwd": roi_mod.bwd_kernel,
    "roi_align_stream_fwd": stream_mod.fwd_kernel, "roi_align_stream_bwd": stream_mod.bwd_kernel,
}


def reset_launches():
    for k in KERNELS.values():
        k.launches = 0


def read_launches():
    return {name: k.launches for name, k in KERNELS.items()}


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
    if "roi_align" in name or "roi_table" in name:
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


def hold_captured(diff, cap, bwd_diff, stream_diff):
    """Each kernel against its plain version on the tensors the path fed it
    (NMS into ``diff``, the ROIAlign backward into ``bwd_diff``, the
    streamed kernels into ``stream_diff``); returns the ROIAlign forward's
    max |Δ|.  A captured adjoint g is divided by its max |g| first: the
    path's g are often far below 1, where the backward's bar
    (|Δ| / max(1, Σ|terms|)) would be an absolute 1e-4 that a wrong
    kernel could pass."""
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
        bwd_diff.add(unit_max(g), rois, shape, pooled, scale, s, valid_hw,
                     f"captured call {i}, g / max|g|")
    for i, (feat, rois, pooled, scale, s) in enumerate(cap.stream):
        stream_diff.fwd(feat, rois, pooled, scale, s, f"captured call {i}")
    for i, (g, rois, shape, pooled, scale, s) in enumerate(cap.stream_bwd):
        stream_diff.bwd(unit_max(g), rois, shape, pooled, scale, s, f"captured call {i}, g / max|g|")
    return roi_err


def unit_max(g):
    """``g`` scaled to a max |g| of 1 (an all-zero g stays zero)."""
    return g / g.abs().max().clamp_min(torch.finfo(g.dtype).tiny)


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


def small_request_agrees(cfg, dev, num_classes=NUM_CLASSES):
    """A small request through the card (kernels) and the CPU (plain
    versions) with the same weights: the forward outputs and the
    detections must agree.  An FPN model's weights are calibrated on the
    request first (BN moments and unit scales, as for serving); a mask
    model's mask logits, selected masks and pasted canvases are held too."""
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
    if small.network.USE_FPN:
        staged = batch_to_device(raw, dev)
        calibrate_bn(model, staged)
        calibrate_scales(model, staged)
    mask = small.network.USE_MASK
    pp = make_test_postprocess(small, num_classes, small.TEST.SCORE_THRESH,
                               small.TEST.DET_PER_CLASS, paste=mask)
    outs = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        pred = Predictor(copy.deepcopy(model), pp, device=d)
        outs[name] = (pred.predict(raw), pred.predict(batch))
    (fg, dg), (fc, dc) = outs["card"], outs["cpu"]
    if not np.array_equal(fg["roi_valid"], fc["roi_valid"]):
        raise AssertionError("card and CPU keep different proposals")
    v = fc["roi_valid"]
    keys = ("rois", "cls_prob", "bbox_deltas") + (("mask_logits",) if mask else ())
    errs = {k: float(np.abs(fg[k][v] - fc[k][v]).max()) for k in keys}
    same_dets = bool(np.array_equal(dg["det_valid"], dc["det_valid"]))
    m = dc["det_valid"]
    canvas = {}
    if same_dets:
        # each class's kept rows by nearest box: two rows whose scores tie
        # within rounding may take each other's slot
        box_err = score_err = 0.0
        for b, c in zip(*np.nonzero(m.any(-1))):
            d, near = _nearest(dg["det_boxes"][b, c][m[b, c]], dc["det_boxes"][b, c][m[b, c]])
            box_err = max(box_err, float(d.max()))
            score_err = max(score_err, float(np.abs(
                dg["det_scores"][b, c][m[b, c]] - dc["det_scores"][b, c][m[b, c]][near]).max()))
        errs["det_boxes"], errs["det_scores"] = box_err, score_err
        if mask:
            canvas = _mask_entries_agree(dg, dc, errs)
    log(f"  small request card vs CPU: valid rois {int(v.sum())}, detections {int(m.sum())}, "
        f"same keep masks {same_dets}, max|d| {errs}" + (f", masks {canvas}" if mask else ""))
    limits = {"rois": 1e-2, "cls_prob": 1e-4, "bbox_deltas": 1e-3, "det_boxes": 1e-2,
              "det_scores": 1e-4, "mask_logits": 1e-3, "det_masks": 1e-3}
    if not same_dets or any(errs[k] > limits[k] for k in errs):
        raise AssertionError(f"card and CPU disagree beyond {limits}")
    # a canvas pixel flips only where its fixed-point value sits on 0, which
    # logits a rounding step apart can straddle
    if canvas and (canvas["differing"] > 1e-3 * max(canvas["set_pixels"], 1)
                   or canvas["unmatched_off_the_cut"]):
        raise AssertionError(f"card and CPU masks differ: {canvas}")


def _nearest(a, b):
    """For each row of the (n, 4) boxes ``a``: the largest coordinate gap
    to its nearest row of ``b``, and that row."""
    if not len(a):
        return np.zeros(0), np.zeros(0, int)
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    return d.min(1), d.argmin(1)


def _mask_entries_agree(dg, dc, errs):
    """The device-selected masks of the card (``dg``) against the CPU's
    (``dc``): each image's entries matched by class and nearest box.  An
    entry without a match must score within 1e-4 of the image's cut (its
    lowest selected score: two near-tied candidates may swap across it).
    Sets ``errs["det_masks"]`` (matched logits) and returns the canvases'
    set and differing pixels over the matched pairs."""
    max_out = dg["det_boxes"].shape[2]
    out = {"set_pixels": 0, "differing": 0, "matched": 0, "unmatched_at_the_cut": 0,
           "unmatched_off_the_cut": 0}
    err = 0.0
    for b in range(dg["det_masks"].shape[0]):
        sides = []
        for o in (dg, dc):
            idx = o["det_mask_idx"][b][o["det_mask_valid"][b]]
            flat = o["det_boxes"][b].reshape(-1, 4)
            sides.append((idx, idx // max_out, flat[idx], o["det_scores"][b].reshape(-1)[idx],
                          np.nonzero(o["det_mask_valid"][b])[0]))
        (gi, gcls, gbox, gsc, gpos), (ci, ccls, cbox, csc, cpos) = sides
        cut = min(gsc.min(), csc.min())
        used = set()
        for t in range(len(gi)):
            same = np.nonzero(ccls == gcls[t])[0]
            d = np.abs(cbox[same] - gbox[t]).max(-1) if len(same) else np.zeros(0)
            if len(d) and d.min() <= 1e-2:
                u = int(same[d.argmin()])
                used.add(u)
                err = max(err, float(np.abs(dg["det_masks"][b, gpos[t]]
                                            - dc["det_masks"][b, cpos[u]]).max()))
                if "det_canvas" in dg:
                    a, c = dg["det_canvas"][b, gpos[t]], dc["det_canvas"][b, cpos[u]]
                    out["set_pixels"] += int(c.sum())
                    out["differing"] += int((a != c).sum())
                out["matched"] += 1
            elif gsc[t] - cut <= 1e-4:
                out["unmatched_at_the_cut"] += 1
            else:
                out["unmatched_off_the_cut"] += 1
        for u in set(range(len(ci))) - used:
            key = "unmatched_at_the_cut" if csc[u] - cut <= 1e-4 else "unmatched_off_the_cut"
            out[key] += 1
    errs["det_masks"] = err
    return out


# ------------------------------------------------------------ train path
TRAINED_GROUPS = ("backbone.stage2", "backbone.stage3", "top_head", "rpn", "rcnn")
FPN_TRAINED_GROUPS = ("backbone.stage2", "backbone.stage3", "backbone.stage4", "neck", "rpn",
                      "top_head", "rcnn")
# launches a train step makes of each kernel: C4 pools one map (kernels 2/3);
# FPN pools P2/P3 streamed (kernels 4/5) and P4/P5 resident (kernels 2/3);
# both run one batched NMS
C4_LAUNCHES_PER_STEP = {"nms": 1, "roi_align_fwd": 1, "roi_align_bwd": 1,
                        "roi_align_stream_fwd": 0, "roi_align_stream_bwd": 0}
FPN_LAUNCHES_PER_STEP = {"nms": 1, "roi_align_fwd": 2, "roi_align_bwd": 2,
                         "roi_align_stream_fwd": 2, "roi_align_stream_bwd": 2}
# Mask R-CNN pools through each route twice, the box branch's BATCH_ROIS rois
# and the mask branch's first FG_FRACTION·BATCH_ROIS slots, each with its
# backward
MASK_TRAINED_GROUPS = FPN_TRAINED_GROUPS + ("mask_head",)
MASK_LAUNCHES_PER_STEP = {"nms": 1, "roi_align_fwd": 4, "roi_align_bwd": 4,
                          "roi_align_stream_fwd": 4, "roi_align_stream_bwd": 4}
# the groups the mask phase's finite differences move: the mask head, and
# the neck, whose gradient comes through the ROIAlign backward kernels of
# both branches
MASK_FD_GROUPS = ("mask_head", "neck")
MASK_TRAIN_IMAGES = 8
# the train paths calibrate their random weights on this many images at once
CALIBRATION_IMAGES = 8


def train_batch(cfg, roidb, i, dev):
    """Record ``i``'s train batch on ``dev``; from a proposal roidb it
    carries the proposals, padded to TRAIN.RPN_POST_NMS_TOP_N."""
    rec = roidb[i]
    count = cfg.TRAIN.RPN_POST_NMS_TOP_N if "proposals" in rec else 0
    return batch_to_device(
        make_batch([rec], cfg, _orientation_bucket(rec, cfg.SHAPE_BUCKETS), seeds=[i],
                   with_masks=cfg.network.USE_MASK, proposal_count=count), dev)


def calibration_batch(cfg, roidb, dev):
    """One batch of the first CALIBRATION_IMAGES records in the first
    record's bucket: the images the train paths calibrate their random
    weights on.  Moments from one image do not carry to the others: the
    first synthetic image holds one shape and the least contrast, and the
    weights calibrated on it alone gave the deep stages and the neck
    activations many times unit scale on the other images, so each step
    moved the model by far more than its scale and the losses (the mask
    run's ``MaskBCELoss`` most) ran away within ten steps."""
    bucket = _orientation_bucket(roidb[0], cfg.SHAPE_BUCKETS)
    recs = [r for r in roidb
            if _orientation_bucket(r, cfg.SHAPE_BUCKETS) == bucket][:CALIBRATION_IMAGES]
    return batch_to_device(
        make_batch(recs, cfg, bucket, seeds=list(range(len(recs))),
                   with_masks=cfg.network.USE_MASK), dev)


def model_extras(batch) -> dict:
    """The batch's tensors that only some graphs take: a mask network's gt
    masks, a proposal roidb's proposals."""
    return {k: batch[k] for k in ("gt_masks", "proposals", "prop_valid") if k in batch}


def _calibration_forward(model, batch):
    """One forward on ``batch``: the train forward when it carries gt boxes
    (the mask branch included), else the inference forward."""
    with torch.no_grad():
        if "gt_boxes" in batch:
            model(batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
                  train=True, sample_seeds=batch["sample_seeds"], **model_extras(batch))
        else:
            model(batch["images"], batch["im_info"])


def calibrate_bn(model, batch):
    """Set every frozen BN's moments to the per-channel mean and variance of
    its input in one forward on ``batch`` (a pre-hook sets them before
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
        _calibration_forward(model, batch)
    finally:
        for h in hooks:
            h.remove()
    log(f"  BN moments set from one forward on {batch['images'].shape[0]} image(s): "
        f"{len(hooks)} layers")


def calibrate_scales(model, batch):
    """Rescale each layer that no frozen BN follows, the FPN neck's convs,
    its 2-fc head and the mask head's layers (none in C4), so that its
    output has unit standard deviation on ``batch``: layer by layer in
    forward order, one forward each (LSUV, Mishkin & Matas 2016).  ``calibrate_bn`` gives the
    backbone unit-scale activations; without this the random neck and head
    leave the pooled features and the head's outputs far above unit scale,
    each clipped SGD step moves the 50176-input ``fc1`` outputs by far more
    than their scale, and the losses run away within a few steps."""
    layers = [(n, m) for n, m in model.named_modules()
              if n.startswith(("neck.", "mask_head.")) or n in ("top_head.fc1", "top_head.fc2")]
    for name, layer in layers:
        seen = []
        hook = layer.register_forward_hook(lambda m, i, o: seen.append(float(o.std())))
        try:
            _calibration_forward(model, batch)
        finally:
            hook.remove()
        with torch.no_grad():
            layer.weight.div_(seen[0])
            if layer.bias is not None:
                layer.bias.div_(seen[0])
    if layers:
        log(f"  unit output scale set from one forward each on {batch['images'].shape[0]} "
            f"image(s): {len(layers)} "
            f"layers ({', '.join(n for n, _ in layers)})")


def gradient_matches_finite_differences(model, cfg, roidb, dev, groups):
    """The full-width backward against the forward on the card: for each
    trained group, the loss's central difference along the group's gradient,
    f(θ + εd) − f(θ − εd) with d = g/‖g‖, must equal gᵀ(θ₊ − θ₋) (the
    displacement as rounded into the f32 weights) within FD_TOL.  The
    samplers' draws are fixed (one rng and seed) and the first forward's
    sampled rois are reused, so the loss is a function of the weights alone,
    smooth but for the ReLU and max-pool switches; ε moves it by ~1e-3 of
    itself, then by half that, six times, and the smallest of the seven
    readings is held to the bar (a wrong gradient fails all seven).  The backbone takes its gradient
    through the ROIAlign backward kernels almost wholly, since the RPN's
    output layers are scaled by 1e-3."""
    batch = train_batch(cfg, roidb, 1, dev)
    held = {}
    model_mod = importlib.import_module(type(model).__module__)
    orig = model_mod.sample_rois

    def sample_once(*a, **k):
        if "samples" not in held:
            held["samples"] = orig(*a, **k)
        return held["samples"]

    def loss_fn():
        return model(batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
                     train=True, sample_seeds=batch["sample_seeds"], rng=5, **model_extras(batch))[0]

    model_mod.sample_rois = sample_once
    try:
        for p in model.parameters():
            p.grad = None
        loss = loss_fn()
        loss.backward()
        f0 = float(loss.detach())
        worst = 0.0
        with torch.no_grad():
            for grp in groups:
                ps = [p for n, p in model.named_parameters()
                      if n.startswith(grp + ".") and p.grad is not None]
                gs = [p.grad.clone() for p in ps]
                p0 = [p.clone() for p in ps]
                gnorm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in gs))
                if not gnorm > 0:
                    raise AssertionError(f"{grp} has no gradient")
                # seven step sizes, each half the last: a gradient error
                # shows at all of them, while the ReLU / max-pool switches
                # a step crosses move a reading in proportion to the step
                # (a deep group such as C4's stage 2 reads ~1e-2 at the
                # fourth step) and the float32 rounding of the loss moves
                # it in inverse proportion (~1e-3 at the seventh)
                rels = []
                for step in FD_STEPS:
                    eps = step * abs(f0) / gnorm
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
                    rels.append(abs(got - want) / abs(want))
                    log(f"  {grp}: |g| {gnorm:.4g}, eps {eps:.3g}, f(+)-f(-) {got:.6g}, "
                        f"g.(p+ - p-) {want:.6g}, relative difference {rels[-1]:.3g}")
                worst = max(worst, min(rels))
    finally:
        model_mod.sample_rois = orig
        for p in model.parameters():
            p.grad = None
    log(f"  loss {f0:.6f}; worst group's smallest relative difference {worst:.3g} (bar {FD_TOL})")
    if not worst <= FD_TOL:
        raise AssertionError("the full-width gradient disagrees with the loss's finite differences")
    return worst


def train_path(cfg, dev, groups, per_step, roidb=None, keep=2):
    """TRAIN_STEPS steps of ``fit`` (its defaults: a prefetch thread, a
    device feed of depth 2, the aux checked every step) at full width on
    synthetic records (``roidb``, default 8 box records of 480 × 640); each
    kernel must launch ``per_step`` times a step dispatched; the first
    ``keep`` calls of each ROIAlign kernel are captured.  Returns the
    captured kernel inputs, the launch counts of the run, the model, the
    roidb, the step statistics, the calibrated weights the run started
    from (on the host) and the run's final train state."""
    if roidb is None:
        roidb = SyntheticDataset(num_images=8, image_size=(480, 640)).gt_roidb()
    model = make_model(cfg)
    calib = calibration_batch(cfg, roidb, dev)
    calibrate_bn(model, calib)
    calibrate_scales(model, calib)
    del calib
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with Capture(keep=keep) as cap:
        out = fit(model, cfg, roidb, epochs=2, seed=0, max_steps=TRAIN_STEPS,
                  frequent=TRAIN_STEPS, device=dev)
    launches = read_launches()
    want = {k: n * out["dispatched_steps"] for k, n in per_step.items()}
    log(f"  launches in the train path: {launches} (expected {want}, {out['dispatched_steps']} "
        f"steps dispatched); pipeline {out['pipeline']}")
    if launches != want or out["dispatched_steps"] != TRAIN_STEPS:
        raise AssertionError(f"the train path dispatched {out['dispatched_steps']} steps (not "
                             f"{TRAIN_STEPS}: a step was retried) or launched {launches}, "
                             f"not {want}")
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    captured_mib = sum(t.numel() * t.element_size()
                       for c in (cap.roi, cap.roi_bwd, cap.stream, cap.stream_bwd)
                       for entry in c for t in entry[:2]) / 2**20

    hist = out["history"]
    if len(hist) != TRAIN_STEPS:
        raise AssertionError(f"fit ran {len(hist)} steps, not {TRAIN_STEPS}")
    losses = METRIC_NAMES + (("MaskBCELoss",) if cfg.network.USE_MASK else ())
    for i, h in enumerate(hist):
        log(f"  step {i}: loss={h['loss']:.5f} "
            + " ".join(f"{k}={h[k]:.5f}" for k in losses)
            + f" fg_rois={int(h['num_fg_rois'])} valid_props={int(h['num_valid_props'])}"
            f" fg_anchors={int(h['num_fg_anchors'])} step_ms={h['step_ms']:.3f}"
            f" wait_ms={h['wait_ms']:.3f}")
    bad = sorted({k for h in hist for k in losses + ("loss",) if not math.isfinite(h[k])})
    if bad:
        raise AssertionError(f"non-finite losses in the train path: {bad}")
    # the total, and a mask network's MaskBCELoss on its own (every image
    # has a gt, which joins the sampled rois: the first step's is > 0)
    for key in ("loss",) + (("MaskBCELoss",) if cfg.network.USE_MASK else ()):
        growth = max(h[key] for h in hist) / hist[0][key] if hist[0][key] > 0 else math.inf
        log(f"  largest {key} / first step's: {growth:.3f} (bar {LOSS_GROWTH_MAX})")
        if not growth <= LOSS_GROWTH_MAX:
            raise AssertionError(f"the train path's {key} grew {growth:.3g}x: the run diverges")

    after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    params = {k for k, _ in model.named_parameters()}
    fixed = cfg.network.FIXED_PARAMS
    frozen = [k for k in before if k not in params or is_frozen_path(tuple(k.split(".")), fixed)]
    moved = [k for k in frozen if not torch.equal(before[k], after[k])]
    if moved:
        raise AssertionError(f"frozen tensors changed: {moved[:5]}")
    changed = {grp: any(not torch.equal(before[k], after[k]) for k in params
                        if k.startswith(grp + ".") and k not in frozen)
               for grp in groups}
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
        "wait_ms_median": statistics.median(h["wait_ms"] for h in hist[TRAIN_WARMUP:]),
        "loop_images_per_s": loop_images_per_s(cfg, out),
        "first_step_ms": hist[0]["step_ms"],
        "peak_mib": peak_mib, "captured_mib": captured_mib,
    }
    if cfg.network.USE_MASK:
        stats["mask_bce"] = [h["MaskBCELoss"] for h in hist]
    log(f"  train step (batch in hand to metrics on the host, guard snapshot included, "
        f"{len(timed)} steps after {TRAIN_WARMUP} warm-up): median "
        f"{stats['step_ms_median']:.3f} ms ({stats['images_per_s']:.3f} images/s); the step "
        f"thread's wait for a batch, median {stats['wait_ms_median']:.3f} ms; loop "
        f"{stats['loop_images_per_s']:.3f} images/s; first step {stats['first_step_ms']:.3f} ms")
    log(f"  max_memory_allocated: {peak_mib:.1f} MiB (of which {captured_mib:.1f} MiB are "
        f"this script's copies of kernel inputs)")
    return cap, launches, model, roidb, stats, before, out["state"]


def loop_images_per_s(cfg, out) -> float:
    """Images over the steps after TRAIN_WARMUP, by the host clock from the
    request of the first timed batch to the end of ``fit`` (after its last
    flush and a synchronisation)."""
    clock = out["clock"]
    n = len(clock["step_start"]) - TRAIN_WARMUP
    return cfg.TRAIN.BATCH_IMAGES * n / (clock["end"] - clock["step_start"][TRAIN_WARMUP])


# ---------------------------------------------------------- pipeline phase
def assembly_workers_for(nproc: int) -> int:
    """The card CLI run's assembly pool: half the host's cores, at most 4
    (the step's own thread and the feed's take two more)."""
    return max(1, min(4, nproc // 2))


def pipeline_settings(workers: int):
    """The [pipeline] phase's three loop settings, as ``fit`` knobs."""
    return (
        ("serial", {"prefetch": 0, "assembly_workers": 0, "feed_depth": 1, "aux_interval": 1}),
        ("fit defaults", {"prefetch": 2, "assembly_workers": 0, "feed_depth": 2,
                          "aux_interval": 1}),
        ("card CLI defaults", {"prefetch": 2, "assembly_workers": workers, "feed_depth": 2,
                               "aux_interval": 8}),
    )


def _summed(stats_list):
    out = {}
    for st in stats_list:
        for k, v in st.items():
            if isinstance(v, (int, float)) and k not in ("occupancy", "depth", "workers"):
                out[k] = out.get(k, 0) + v
    return out


def pipeline_run(model, weights, cfg, roidb, dev, per_step, knobs, tmp, label):
    """``fit`` for TRAIN_STEPS steps from ``weights`` with ``knobs``; the
    kernels must launch ``per_step`` times each dispatched step (replays and
    retries included).  Returns the digests, stream indices, losses, final
    parameters and the loop's figures."""
    model.load_state_dict(weights)
    log_path = os.path.join(tmp, f"{label.replace(' ', '_')}.log")
    torch.cuda.synchronize()
    reset_launches()
    out = fit(model, cfg, roidb, epochs=2, seed=0, max_steps=TRAIN_STEPS, frequent=TRAIN_STEPS,
              device=dev, stream_log=log_path, **knobs)
    launches = read_launches()
    want = {k: n * out["dispatched_steps"] for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches} are not {want} "
                             f"({out['dispatched_steps']} steps dispatched)")
    with open(log_path) as f:
        digests = [line.split()[2] for line in f]
    hist = out["history"]
    timed = [h for h in hist if h["index"] >= TRAIN_WARMUP]
    feed, pool = _summed(out["feed"]), out["loader"].get("assembly", {})
    pipe = out["pipeline"]
    fig = {
        "images_per_s": loop_images_per_s(cfg, out),
        "wait_ms_median": statistics.median(h["wait_ms"] for h in timed),
        "wait_ms_mean": statistics.fmean(h["wait_ms"] for h in timed),
        "feed_occupancy": feed["staged_hits"] / feed["fed"],
        "feed_starved_after_first": feed["feed_starved_after_first"],
        "pool_occupancy": pool["ready_hits"] / pool["yielded"] if pool else None,
        "pool_starved_after_first": pool.get("starved_after_first"),
        "pool_wait_s": pool.get("wait_s"),
        "fetches": pipe["fetches"], "fetch_stalls": pipe["fetch_stalls"],
        "fetch_stall_ms": pipe["fetch_stall_ms"], "dispatched_steps": out["dispatched_steps"],
    }
    if knobs["aux_interval"] <= 1:
        fig["step_ms_median"] = statistics.median(h["step_ms"] for h in timed)
    starts = out["clock"]["step_start"] + [out["clock"]["end"]]
    fig["interval_ms"] = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    fig["wait_ms"] = [h["wait_ms"] for h in hist]
    log(f"  {label} {knobs}: {fig['images_per_s']:.3f} images/s over {len(timed)} steps; "
        f"wait for a batch median {fig['wait_ms_median']:.3f} ms (mean "
        f"{fig['wait_ms_mean']:.3f}); feed occupancy {fig['feed_occupancy']:.3f} "
        f"({fig['feed_starved_after_first']} starved after the first); pool occupancy "
        f"{fig['pool_occupancy']}; sink {fig['fetches']} fetches, {fig['fetch_stalls']} stalls "
        f"({fig['fetch_stall_ms']} ms); launches {launches}; pipeline {pipe}; ms from each "
        f"batch request to the next (the last to the end) {[round(t, 1) for t in fig['interval_ms']]}"
        f"; waits {[round(t, 1) for t in fig['wait_ms']]}")
    return {"digests": digests, "index": [h["index"] for h in hist],
            "losses": [h["loss"] for h in hist], "pipeline": pipe,
            "params": [p.detach().clone() for p in model.parameters()], "fig": fig}


def training_diff(a, b):
    """(same batches, same losses, same parameters bit for bit, the
    largest parameter difference)."""
    worst = max(float((x - y).abs().max()) for x, y in zip(a["params"], b["params"]))
    return (a["digests"] == b["digests"], a["index"] == b["index"] and a["losses"] == b["losses"],
            worst == 0.0 and all(torch.equal(x, y) for x, y in zip(a["params"], b["params"])),
            worst)


def snapshot_cost(model, weights, cfg, roidb, dev):
    """The guard's snapshot of a full-width train state on the card: device
    time of ``TrainState.snapshot`` into reused buffers and of ``restore``
    (CUDA events over 20 calls), the host's time to issue one, the bytes
    copied and their bound (read once, written once, at HBM rate)."""
    model.load_state_dict(weights)
    state = create_train_state(model, make_optimizer(cfg, model, make_lr_schedule(cfg, 8)))
    train_step(state, train_batch(cfg, roidb, 0, dev), 7)  # momentum buffers exist
    snap = state.snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        state.snapshot(snap)
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    ms = cuda_ms(lambda: state.snapshot(snap), reps=20)
    restore_ms = cuda_ms(snap.restore, reps=20)
    nbytes = sum(t.numel() * t.element_size() for t in snap.params + snap.momenta if t is not None)
    out = {"snapshot_ms": ms, "restore_ms": restore_ms, "issue_host_ms": host_ms,
           "mib": nbytes / 2**20, "bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
           "tensors": len(snap.params)}
    log(f"  snapshot of {out['tensors']} trainable tensors + momentum ({out['mib']:.1f} MiB): "
        f"{ms:.4f} ms on the card (bound {out['bound_ms']:.4f}), restore {restore_ms:.4f} ms, "
        f"{host_ms:.4f} ms of host time to issue")
    return out


def host_syncs_per_step(model, weights, cfg, roidb, dev, k):
    """Host synchronisations in one ``PipelinedLoop.step`` at ``aux_interval``
    k (a mid-window step when k > 1), counted with
    ``torch.cuda.set_sync_debug_mode("warn")``, and their source lines."""
    model.load_state_dict(weights)
    state = create_train_state(model, make_optimizer(cfg, model, make_lr_schedule(cfg, 8)))
    loop = PipelinedLoop(train_step, aux_interval=k)
    batches = [train_batch(cfg, roidb, i, dev) for i in range(2)]
    loop.step(state, batches[0], 7)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loop.step(state, batches[1], 7)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    lines = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            where = f"{os.path.relpath(w.filename)}:{w.lineno}"
            lines[where] = lines.get(where, 0) + 1
    return sum(lines.values()), lines


PIPELINE_IMAGES = 16
# host synchronisations in one step at aux_interval 1: the guard's aux fetch
# (core/resilience.py::fetch_host); the samplers' constant vectors are built
# once per device (ops/targets.py::device_constant)
HOST_SYNCS_PER_STEP = 1


def pipeline_phase(name, cfg, weights, dev, per_step, workers):
    """The [pipeline] phase for one path: the serial, fit-default and card
    CLI-default loops from the same calibrated weights (and the serial loop
    once more, the run-to-run reference) on the same batches, then the
    card-side recovery check on FPN.  Gates: identical digests, launches per
    dispatched step, and identical losses and parameters across the runs.
    The runs draw from PIPELINE_IMAGES synthetic records, so their steps lie
    in one epoch, each image rendered once, as in a long run's epoch (an
    epoch boundary restarts the feed and the loader's stream)."""
    roidb = SyntheticDataset(num_images=PIPELINE_IMAGES, image_size=(480, 640)).gt_roidb()
    model = make_model(cfg)
    figures = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {label: pipeline_run(model, weights, cfg, roidb, dev, per_step, knobs, tmp, label)
                for label, knobs in pipeline_settings(workers)}
        runs["serial again"] = pipeline_run(model, weights, cfg, roidb, dev, per_step,
                                            pipeline_settings(workers)[0][1], tmp, "serial again")
        ref = runs["serial"]
        for label, run in runs.items():
            same_batches, same_losses, same_params, worst = training_diff(ref, run)
            log(f"  {name} {label} vs serial: same digests {same_batches}, same losses "
                f"{same_losses}, parameters bit-identical {same_params} (max |d| {worst:.3g})")
            if not (same_batches and same_losses and same_params):
                raise AssertionError(f"{name}: the {label} loop did not train as the serial one")
            figures[label] = run["fig"]
        if name == "FPN":
            figures["recovery"] = recovery_check(model, weights, cfg, roidb, dev, per_step, tmp)
    figures["snapshot"] = snapshot_cost(model, weights, cfg, roidb, dev)
    figures["host_syncs"] = {}
    for k in (1, 8):
        n, lines = host_syncs_per_step(model, weights, cfg, roidb, dev, k)
        top = sorted(lines.items(), key=lambda kv: -kv[1])[:6]
        log(f"  host syncs in one step at aux_interval {k}: {n}; by line {top}")
        figures["host_syncs"][k] = {"count": n, "top": top}
        if k == 1 and n != HOST_SYNCS_PER_STEP:
            raise AssertionError(f"{name}: a step at aux_interval 1 synchronised the host {n} "
                                 f"times, not {HOST_SYNCS_PER_STEP}: {top}")
    return figures


def recovery_check(model, weights, cfg, roidb, dev, per_step, tmp):
    """``nan_loss@5`` on the card: caught 4 steps late (aux_interval 4), the
    window rolled back and step 4 replayed, step 5 retried and skipped,
    steps 6 and 7 dispatched again; the run must end with the parameters of
    the guarded aux_interval 1 run under the same fault, and the launches
    must count every replayed and retried step.  The fault is cleared after,
    so no later phase sees it."""
    knobs = {"prefetch": 2, "assembly_workers": 0, "feed_depth": 2}
    os.environ["MX_RCNN_FAULTS"] = "nan_loss@5"
    try:
        faults.reset()
        late = pipeline_run(model, weights, cfg, roidb, dev, per_step,
                            {**knobs, "aux_interval": 4}, tmp, "nan_loss@5 K=4")
        faults.reset()
        guarded = pipeline_run(model, weights, cfg, roidb, dev, per_step,
                               {**knobs, "aux_interval": 1}, tmp, "nan_loss@5 K=1")
    finally:
        del os.environ["MX_RCNN_FAULTS"]
        faults.reset()
    want_index = [i for i in range(TRAIN_STEPS) if i != 5]
    same_batches, same_losses, same_params, worst = training_diff(guarded, late)
    p = late["pipeline"]
    log(f"  nan_loss@5 at K=4: ready indices {late['index']}, skipped {p['skipped_batches']}, "
        f"window rollbacks {p['window_rollbacks']}, replayed {p['replayed_steps']}, retried "
        f"{p['retried_steps']}, dispatched {late['fig']['dispatched_steps']} (K=1: "
        f"{guarded['fig']['dispatched_steps']}); vs the guarded K=1 run: same digests "
        f"{same_batches}, same losses {same_losses}, parameters bit-identical {same_params} "
        f"(max |d| {worst:.3g})")
    if (p["skipped_batches"] != 1 or p["window_rollbacks"] != 1 or late["index"] != want_index
            or guarded["index"] != want_index or not (same_batches and same_losses and same_params)
            or late["fig"]["dispatched_steps"] != TRAIN_STEPS + 6
            or guarded["fig"]["dispatched_steps"] != TRAIN_STEPS + 2):
        raise AssertionError("the card-side recovery from nan_loss@5 failed its checks")
    return {"K4": p, "K1": guarded["pipeline"], "dispatched": {
        "K4": late["fig"]["dispatched_steps"], "K1": guarded["fig"]["dispatched_steps"]}}


# -------------------------------------------------------- checkpoint phase
CHECKPOINT_IMAGES = 4
# the preempted run is signalled once its stream log has this many lines
# (batch 0 of epoch 2 in hand); the stall holds the next step, so the signal
# cannot land after the last one
CHECKPOINT_SIGNAL_LINES = 5
CHECKPOINT_FAULTS = "stall@5:10"
# the watchdog check: a spin kernel of WATCHDOG_HANG_S seconds queued on the
# card after step WATCHDOG_HANG_STEP holds that step's aux fetch past
# WATCHDOG_TIMEOUT_S
WATCHDOG_HANG_STEP = 2
WATCHDOG_HANG_S = 10.0
WATCHDOG_TIMEOUT_S = 3.0


class SigtermAfter:
    """A thread that sends this process SIGTERM once ``log_path`` has
    ``lines`` lines, unless ``cancel()`` comes first; ``at`` is the host
    clock at the send."""

    def __init__(self, log_path: str, lines: int):
        self.log_path, self.lines, self.at = log_path, lines, None
        self._cancel = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _count(self) -> int:
        try:
            with open(self.log_path) as f:
                return sum(1 for _ in f)
        except FileNotFoundError:
            return 0

    def _run(self):
        while not self._cancel.wait(0.002):
            if self._count() >= self.lines:
                self.at = time.perf_counter()
                os.kill(os.getpid(), signal.SIGTERM)
                return

    def cancel(self):
        self._cancel.set()
        self._thread.join(timeout=30)


def hung_card_watchdog(cfg, model, weights, roidb, dev, tmp, golden_prefix) -> dict:
    """``fit(prefix=W, step_timeout=WATCHDOG_TIMEOUT_S)`` for one epoch, with
    a spin kernel (``torch.cuda._sleep``) of WATCHDOG_HANG_S seconds queued
    on the card after step WATCHDOG_HANG_STEP: the guard's aux fetch waits
    on the hung card, the watchdog fires, saves the guard's snapshot from
    its host mirror and calls ``os._exit`` (replaced here by a recorder).
    Gates: the exit came while the spin still ran (an event queued after it
    had not completed), the dump is committed at the hung step's position,
    and its resume ends the epoch with the golden run's ``epoch_0001``
    checksum."""
    import mx_rcnn_tpu_torch.core.fit as fit_module

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 8)
    stop.record()
    stop.synchronize()
    cycles = int(WATCHDOG_HANG_S * 1e3 / start.elapsed_time(stop) * 1e8)
    real_step, real_exit = fit_module.train_step, os._exit
    hang, exits = {}, []

    def hung_step(state, batch, rng, lr_scale=None, **kw):
        out = real_step(state, batch, rng, lr_scale, **kw)
        if state.optimizer.count == WATCHDOG_HANG_STEP + 1 and not hang:
            torch.cuda._sleep(cycles)
            hang["end"] = torch.cuda.Event()
            hang["end"].record()
            hang["at"] = time.perf_counter()
        return out

    def recorded_exit(code):
        exits.append((code, hang["end"].query(), time.perf_counter()))

    w = os.path.join(tmp, "W")
    knobs = {"seed": 0, "device": dev, "frequent": 100, "epochs": 1}
    model.load_state_dict(weights)
    fit_module.train_step, os._exit = hung_step, recorded_exit
    try:
        hung = fit(model, cfg, roidb, prefix=w, step_timeout=WATCHDOG_TIMEOUT_S,
                   max_steps=CHECKPOINT_IMAGES, **knobs)
    finally:
        fit_module.train_step, os._exit = real_step, real_exit
    want = (0, WATCHDOG_HANG_STEP)
    dumps = [x for x in hung["saves"] if (x["epoch"], x["batch"]) == want]
    log(f"  hung card: a {WATCHDOG_HANG_S:.0f} s spin kernel after step {WATCHDOG_HANG_STEP}, "
        f"step_timeout {WATCHDOG_TIMEOUT_S:.0f} s: exits {[(c, busy) for c, busy, _ in exits]} "
        f"(code, spin completed at the exit), "
        f"{[round(t - hang['at'], 3) for *_, t in exits]} s after the spin was queued; dumps "
        f"{[(os.path.basename(x['path']), x['bytes'], round(x['seconds'], 3)) for x in hung['saves']]}"
        f"; restorable {restorable_checkpoints(w)}; step_ms "
        f"{[round(h.get('step_ms', float('nan')), 3) for h in hung['history']]}")
    if len(exits) != 1 or exits[0][0] != 75 or exits[0][1]:
        raise AssertionError(f"the watchdog did not exit while the card was hung: {exits}")
    if len(dumps) != 1 or restorable_checkpoints(w) != [want]:
        raise AssertionError(f"no committed watchdog dump at {want}: {hung['saves']}")
    model.load_state_dict(weights)
    res = fit(model, cfg, roidb, prefix=w, resume=True, **knobs)
    checksums = [read_manifest(os.path.join(p, "epoch_0001"))["checksum"]
                 for p in (golden_prefix, w)]
    log(f"  resumed from the watchdog dump at {res['begin']}: {res['steps']} steps; epoch_0001 "
        f"checksum equal to the golden run's: {checksums[0] == checksums[1]}")
    if res["begin"] != want or res["steps"] != CHECKPOINT_IMAGES - want[1] or \
            checksums[0] != checksums[1]:
        raise AssertionError("the resume from the watchdog dump lost or repeated a batch")
    return {"exit_after_hang_s": exits[0][2] - hang["at"], "dump": dumps[0],
            "resumed_steps": res["steps"]}


def tree_diff(a, b) -> list:
    """The names where two checkpoint trees differ: a ``state_dict`` tensor,
    a momentum buffer, or the count."""
    bad = [] if a["count"] == b["count"] else ["count"]
    for part in ("model", "momentum"):
        if a[part].keys() != b[part].keys():
            bad.append(f"{part} names")
            continue
        for k, v in a[part].items():
            w = b[part][k]
            if (v is None) != (w is None) or (v is not None and not torch.equal(v, w)):
                bad.append(f"{part}.{k}")
    return bad


def state_round_trip(cfg, state, dev):
    """Save a full-width train state from the card, load it into a freshly
    built model and optimizer on the card, and hold every ``state_dict``
    tensor, momentum buffer and the count bitwise.  Returns the dump's bytes
    and the save's and load's seconds (the load verifies the checksum)."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, state, 1)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(path, DATA_FILE))
        model = make_model(cfg, seed=1).to(dev, memory_format=torch.channels_last)
        fresh = create_train_state(model, make_optimizer(cfg, model, make_lr_schedule(cfg, 8)))
        t0 = time.perf_counter()
        load_checkpoint(tmp, 1, fresh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        fresh_tree = fresh.state_tree()
        bad = tree_diff(state.state_tree(), fresh_tree)
    n_momentum = sum(v is not None for v in fresh_tree["momentum"].values())
    log(f"  {len(state.model.state_dict())} state_dict tensors, {n_momentum} momentum buffers, "
        f"count {state.optimizer.count}: {nbytes} bytes, saved in {save_s:.3f} s, loaded with its "
        f"checksum in {load_s:.3f} s; bitwise equal after the load: {not bad}")
    if bad:
        raise AssertionError(f"the loaded state differs from the saved one: {bad[:5]}")
    return {"bytes": nbytes, "save_s": save_s, "load_s": load_s, "count": state.optimizer.count}


def checkpoint_phase(cfg, weights, dev):
    """The training-state cycle at full width on CHECKPOINT_IMAGES records,
    batch 1, 2 epochs, from ``weights``: a golden ``fit(prefix=A)``; a run
    under B that a real SIGTERM stops mid epoch 2 (CHECKPOINT_FAULTS holds
    it there), which must leave a committed ``step_0001_BBBBBB`` dump; its
    ``fit(resume=True)``.  Gates: the concatenated stream log equals the
    golden one line for line, ``epoch_0002``'s checksum under B equals A's
    (and ``epoch_0001``'s), the final ``state_dict``, momentum and count
    equal the golden run's bitwise, and the resumed run launches NMS and
    kernels 2 and 3 once a step.  Then ``tools/test.py`` evaluates A's
    newest dump, its ``epoch_0001`` and ``--params`` of the golden run's
    final weights on the card: the newest dump's detections equal
    ``--params``' bitwise (and the mAPs), and NMS and kernel 2 launch in
    each run."""
    roidb = SyntheticDataset(num_images=CHECKPOINT_IMAGES, image_size=(480, 640)).gt_roidb()
    model = make_model(cfg)
    knobs = {"epochs": 2, "seed": 0, "device": dev, "frequent": 100}
    late = []
    # a signal that lands after fit has uninstalled its guard must not end
    # the script: the guard restores this handler
    prev = signal.signal(signal.SIGTERM, lambda signum, frame: late.append(signum))
    tmp = tempfile.mkdtemp()
    try:
        a, b = os.path.join(tmp, "A"), os.path.join(tmp, "B")
        log_a, log_b = os.path.join(tmp, "a.log"), os.path.join(tmp, "b.log")
        model.load_state_dict(weights)
        golden = fit(model, cfg, roidb, prefix=a, stream_log=log_a, **knobs)
        golden_tree = golden["state"].state_tree()
        params = os.path.join(tmp, "P", "params.pkl")
        os.makedirs(os.path.dirname(params))
        save_params(params, torch_to_flax(model))
        step_ms = statistics.median(h["step_ms"] for h in golden["history"][TRAIN_WARMUP:])
        saves = [(os.path.basename(x["path"]), x["bytes"], round(x["seconds"], 3))
                 for x in golden["saves"]]
        log(f"  golden run: {golden['steps']} steps, step median {step_ms:.3f} ms after "
            f"{TRAIN_WARMUP} warm-up, saves (dump, bytes, seconds) {saves}")

        model.load_state_dict(weights)
        os.environ[faults.ENV_VAR] = CHECKPOINT_FAULTS
        faults.reset()
        sig = SigtermAfter(log_b, CHECKPOINT_SIGNAL_LINES)
        try:
            pre = fit(model, cfg, roidb, prefix=b, stream_log=log_b, **knobs)
        finally:
            sig.cancel()
            del os.environ[faults.ENV_VAR]
            faults.reset()
        stop = pre["stopped_at"]
        if sig.at is None or not pre["preempted"] or stop[0] != 1 or late:
            raise AssertionError(f"the SIGTERM did not stop the run mid epoch 2: sent "
                                 f"{sig.at is not None}, stopped at {stop}, late {late}")
        dump = pre["saves"][-1]
        if latest_checkpoint(b) != stop or os.path.basename(dump["path"]) != \
                f"step_{stop[0]:04d}_{stop[1]:06d}":
            raise AssertionError(f"no committed step dump at {stop}: {pre['saves']}")
        commit_s = dump["at"] - sig.at
        log(f"  preempted run: SIGTERM once its log had {CHECKPOINT_SIGNAL_LINES} lines "
            f"({CHECKPOINT_FAULTS}); stopped at epoch {stop[0]} batch {stop[1]} after "
            f"{pre['steps']} steps; committed {os.path.basename(dump['path'])} ({dump['bytes']} "
            f"bytes, saved in {dump['seconds']:.3f} s), {commit_s:.3f} s after the signal")

        model.load_state_dict(weights)
        torch.cuda.synchronize()
        reset_launches()
        res = fit(model, cfg, roidb, prefix=b, resume=True, stream_log=log_b, **knobs)
        launches = read_launches()
        want = {k: n * res["dispatched_steps"] for k, n in C4_LAUNCHES_PER_STEP.items()}
        with open(log_a) as fa, open(log_b) as fb:
            lines_a, lines_b = fa.read().splitlines(), fb.read().splitlines()
        checksums = {(p, e): read_manifest(os.path.join(p, f"epoch_{e:04d}"))["checksum"]
                     for p in (a, b) for e in (1, 2)}
        bad = tree_diff(golden_tree, res["state"].state_tree())
        t0 = time.perf_counter()
        load_checkpoint(a, 2, res["state"])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        log(f"  resumed run: from {res['begin']}, {res['steps']} steps; stream log equal to the "
            f"golden one line for line: {lines_a == lines_b} ({len(lines_b)} lines); epoch_0002 "
            f"checksum equal: {checksums[(a, 2)] == checksums[(b, 2)]} ({checksums[(b, 2)][:16]}), "
            f"epoch_0001: {checksums[(a, 1)] == checksums[(b, 1)]}; state_dict, momentum and "
            f"count bitwise equal: {not bad}; launches {launches} (expected {want}); "
            f"epoch_0002 loaded with its checksum in {load_s:.3f} s")
        if lines_a != lines_b or len(lines_a) != 2 * CHECKPOINT_IMAGES:
            raise AssertionError("the preempted and resumed runs did not consume the golden stream")
        if checksums[(a, 2)] != checksums[(b, 2)] or checksums[(a, 1)] != checksums[(b, 1)]:
            raise AssertionError(f"the epoch dumps' checksums differ: {checksums}")
        if bad:
            raise AssertionError(f"the resumed run's state differs from the golden run's: {bad[:5]}")
        if launches != want or res["begin"] != stop:
            raise AssertionError(f"the resumed run from {res['begin']} launched {launches}, not "
                                 f"{want}")
        watchdog = hung_card_watchdog(cfg, model, weights, roidb, dev, tmp, a)

        save_run_meta(a, cfg)
        shutil.copy(os.path.join(a, "run_meta.json"), os.path.dirname(params))
        evals = {}
        for label, extra in (("newest dump", ["--prefix", a]),
                             ("--epoch 1", ["--prefix", a, "--epoch", "1"]),
                             ("--params", ["--params", params])):
            dets = os.path.join(tmp, f"{len(evals)}.pkl")
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            results = test_cli.test_rcnn(test_cli.parse_args(
                ["--network", "resnet", "--dataset", "PascalVOC", "--synthetic", "8",
                 "--dump", dets] + extra))
            secs = time.perf_counter() - t0
            with open(dets, "rb") as f:
                evals[label] = {"mAP": results["mAP"], "launches": read_launches(),
                                "seconds": secs, "dets": pickle.load(f)}
            log(f"  tools/test.py {' '.join(extra[:1] + extra[2:])}: mAP {results['mAP']:.6f}, "
                f"{secs:.3f} s, launches {evals[label]['launches']}")
        picked = (test_cli.pick_checkpoint(a, None), test_cli.pick_checkpoint(a, 1))
        newest, params_run = evals["newest dump"], evals["--params"]
        same = len(newest["dets"]) == len(params_run["dets"]) and all(
            len(ca) == len(cb) and all(np.array_equal(x, y) for x, y in zip(ca, cb))
            for ca, cb in zip(newest["dets"], params_run["dets"]))
        log(f"  picked dumps (newest, --epoch 1): {picked}; newest dump's detections bitwise "
            f"equal to --params': {same}, mAP {newest['mAP']} vs {params_run['mAP']}")
        if picked != ((2, 0), (1, 0)) or not same or newest["mAP"] != params_run["mAP"]:
            raise AssertionError("tools/test.py --prefix did not evaluate the dump as --params")
        for label in ("newest dump", "--epoch 1"):
            n = evals[label]["launches"]
            if not (n["nms"] > 0 and n["roi_align_fwd"] > 0):
                raise AssertionError(f"tools/test.py {label} launched {n}")
    finally:
        signal.signal(signal.SIGTERM, prev)
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "golden_step_ms_median": step_ms, "golden_saves": golden["saves"],
        "stopped_at": stop, "preempted_steps": pre["steps"], "stop_dump": dump,
        "sigterm_to_commit_s": commit_s, "resumed_steps": res["steps"],
        "resumed_launches": launches, "load_s": load_s, "watchdog": watchdog,
        "eval": {k: {kk: vv for kk, vv in v.items() if kk != "dets"} for k, v in evals.items()},
    }


def _train_layer_of(kernel_name: str) -> str:
    name = kernel_name.lower()
    # both forwards are instances of one template (roi_align_fwd.cuh), the
    # backwards' table and tile kernels of others (roi_align_table.cuh),
    # each named by its tap rule
    if "roi_align_fwd" in name:
        return "roi_align_stream fwd kernel" if "streamtaps" in name else "roi_align fwd kernel"
    if "streamtaps" in name:
        return "roi_align_stream bwd kernel"
    if "residenttaps" in name:
        return "roi_align bwd kernel"
    if "roi_align_bwd" in name:
        return "roi_align bwd kernel"
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
    batch = train_batch(cfg, roidb, 0, dev)
    train_step(create_train_state(model, opt), batch, 99)
    torch.cuda.synchronize()

    def forward():
        opt.zero_grad()
        return model(batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
                     train=True, sample_seeds=batch["sample_seeds"], rng=1, **model_extras(batch))[0]

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


def mask_branch_profile(model, cfg, roidb, dev):
    """The mask branch of one train step split into its pieces, each run on
    that step's own tensors (its sampled rois, pyramid, gt masks) under
    torch.profiler with a sync after, forward and backward: the second
    pooling of the mask rois from P2..P5 (``_level_pooled``: kernels 4/5 at
    P2/P3, 2/3 at P4/P5), the mask head, the targets (``_mask_targets``)
    and the BCE (``mask_bce``).  Returns each piece's device busy and wall
    ms."""
    batch = train_batch(cfg, roidb, 0, dev)
    fpn_mod = importlib.import_module(type(model).__module__)
    held = {}
    orig = fpn_mod.sample_rois

    def keep(*a, **k):
        held["samples"] = orig(*a, **k)
        return held["samples"]

    fpn_mod.sample_rois = keep
    try:
        with torch.no_grad():
            model(batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
                  train=True, sample_seeds=batch["sample_seeds"], rng=1, **model_extras(batch))
            images = normalize_images(batch["images"], batch["im_info"], cfg)
            feats = [p.permute(0, 2, 3, 1).detach().requires_grad_()
                     for p in model._pyramid(images)[:4]]
    finally:
        fpn_mod.sample_rois = orig
    t = cfg.TRAIN
    nfg = int(round(t.FG_FRACTION * t.BATCH_ROIS))
    smp = held["samples"]
    rois, labels, gi = smp.rois[:, :nfg], smp.labels[:, :nfg], smp.gt_index[:, :nfg]
    with torch.no_grad():
        pooled = model._level_pooled(feats, rois, (14, 14))
        x = pooled.permute(0, 3, 1, 2).detach().requires_grad_()
        head_out = model.mask_head(x).permute(0, 2, 3, 1)
    logits = head_out.reshape((1, nfg) + head_out.shape[1:]).detach().requires_grad_()
    g_pool, g_head = torch.randn_like(pooled), torch.randn_like(head_out)
    targets = model._mask_targets(rois, gi, batch["gt_boxes"], batch.get("gt_masks"))
    pieces = {
        "pooling": lambda: model._level_pooled(feats, rois, (14, 14)).backward(g_pool),
        "head": lambda: model.mask_head(x).permute(0, 2, 3, 1).backward(g_head),
        "targets": lambda: model._mask_targets(rois, gi, batch["gt_boxes"],
                                               batch.get("gt_masks")),
        "BCE": lambda: mask_bce(logits, labels, targets).backward(),
    }
    out = {}
    for name, fn in pieces.items():
        fn()
        _, wall, events = _profiled(fn)
        out[name] = {"busy_ms": sum(e.self_device_time_total for e in events) / 1e3,
                     "wall_ms": wall, "kernels": sum(e.count for e in events)}
    for p in model.parameters():
        p.grad = None
    log(f"  the mask branch of one step ({nfg} rois, {int((labels > 0).sum())} fg), piece by "
        f"piece on its tensors (forward + backward, profiler on, sync after): "
        + "; ".join(f"{k} {v['busy_ms']:.3f} ms busy of {v['wall_ms']:.3f} ms wall, "
                    f"{v['kernels']} kernels" for k, v in out.items()))
    return out


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


def anchor_count(cfg, h: int, w: int) -> int:
    """Anchors of an h × w canvas: every stride-2 layer of the backbone
    rounds up."""
    net = cfg.network
    if net.USE_FPN:
        per_cell = len(net.ANCHOR_RATIOS) * len(net.FPN_ANCHOR_SCALES)
        return sum(-(-h // s) * -(-w // s) for s in net.FPN_FEAT_STRIDES) * per_cell
    return -(-h // net.RPN_FEAT_STRIDE) * -(-w // net.RPN_FEAT_STRIDE) * net.NUM_ANCHORS


def small_c4_cfg():
    """ResNet-50 C4 with anchors small enough (32–128 px) to meet the gts of
    a 128 × 128 image (tests/test_torch_train.py::train_cfg)."""
    cfg = generate_config("resnet50", "PascalVOC")
    return cfg.replace(
        network=dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4, 8)),
        TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=400, RPN_POST_NMS_TOP_N=64,
                                  BATCH_ROIS=32, RPN_BATCH_SIZE=64),
    )


def small_fpn_cfg():
    """ResNet-50 FPN at tests/test_fpn.py::fpn_cfg's size: a 128 × 128
    canvas, 4 classes, 400 → 48 proposals, 16 rois."""
    cfg = generate_config("resnet_fpn", "PascalVOC")
    return cfg.replace(
        SHAPE_BUCKETS=((128, 128),),
        dataset=dataclasses.replace(cfg.dataset, NUM_CLASSES=4, SCALES=((128, 128),),
                                    MAX_GT_BOXES=4),
        TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=400, RPN_POST_NMS_TOP_N=48,
                                  BATCH_ROIS=16, RPN_BATCH_SIZE=32),
    )


def small_mask_cfg():
    """Mask R-CNN (``mask_resnet_fpn``'s network) at small_fpn_cfg's size and
    ResNet-50 depth: a calibrated random ResNet-101 carries the card's and
    the CPU's rounding apart by depth (ROADMAP queue 3)."""
    net = generate_config("mask_resnet_fpn", "coco").network
    return small_fpn_cfg().replace(network=dataclasses.replace(net, depth=50))


def small_gt_masks(gts, m: int):
    """(1, 4, m, m) box-frame bitmaps of an ellipse and a triangle in the
    first two of ``gts``."""
    out = np.zeros((1, 4, m, m), np.uint8)
    for j, kind in enumerate(("ellipse", "triangle")):
        out[0, j] = polygons_to_box_frame([shape_polygon(kind, gts[j])], gts[j], m)
    return torch.from_numpy(out)


def small_proposals(gts, n: int) -> torch.Tensor:
    """(1, n, 4) proposals in a 128 × 128 image: jittered copies of the
    first two of ``gts``, then seeded random boxes."""
    rng = np.random.RandomState(6)
    rows = []
    for k in range(n):
        if k < n // 2:
            box = np.asarray(gts[k % 2][:4]) + rng.randn(4) * 4
        else:
            x1, y1 = rng.rand(2) * 88
            box = [x1, y1, x1 + 10 + rng.rand() * 30, y1 + 10 + rng.rand() * 30]
        rows.append(np.clip(box, 0, 127))
    return torch.from_numpy(np.asarray(rows, np.float32)[None])


def train_step_agrees(dev, cfg, gts, label, cls=None):
    """One small train step (128 × 128, the same weights and the same
    sampling draws) on the card (kernels, cuDNN) and on the CPU (plain
    versions): identical sampled labels and anchor labels, rois within
    1e-3 px, losses within 1e-4 relative, and every gradient leaf within
    1e-3 of its own L2 norm and within 3e-3 of its largest element (cuDNN's
    f32 convolution algorithms, its split reductions in the weight gradients
    and the atomics of the ROIAlign backward sum in other orders than the
    CPU).  ``gts``: the image's (x1, y1, x2, y2, class) boxes; a mask
    network gets the polygon gt masks of :func:`small_gt_masks`.  ``cls``:
    a stage graph instead of the config's model (its sampler's labels are
    compared; Fast R-CNN gets :func:`small_proposals`)."""
    model = make_model(cfg, seed=3, cls=cls)
    model_mod = importlib.import_module(type(model).__module__)
    rng = np.random.RandomState(4)
    # tests/test_model.py::tiny_batch's inputs: pixels in [0, 1), two gts
    images = torch.from_numpy(rng.rand(1, 128, 128, 3).astype(np.float32))
    im_info = torch.tensor([[128.0, 128.0, 1.0]])
    gt = torch.zeros((1, 4, 5))
    gt[0, :len(gts)] = torch.tensor(gts)
    gt_valid = torch.arange(4)[None] < len(gts)
    draws = sampling_uniforms(11, [0], anchor_count(cfg, 128, 128),
                              cfg.TRAIN.RPN_POST_NMS_TOP_N + 4, "cpu")
    masks = ({"gt_masks": small_gt_masks(gts, cfg.TRAIN.MASK_GT_SIZE)}
             if cfg.network.USE_MASK else {})
    if cls is FastRCNN:
        masks = {"proposals": small_proposals(gts, cfg.TRAIN.RPN_POST_NMS_TOP_N),
                 "prop_valid": torch.ones((1, cfg.TRAIN.RPN_POST_NMS_TOP_N), dtype=torch.bool)}

    runs = {}
    orig = (getattr(model_mod, "assign_anchor", None), getattr(model_mod, "sample_rois", None))
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        m = copy.deepcopy(model).to(d, memory_format=torch.channels_last)
        make_optimizer(cfg, m, make_lr_schedule(cfg, 10))
        got = {}
        model_mod.assign_anchor = lambda *a, **k: got.setdefault("anchor", orig[0](*a, **k))
        model_mod.sample_rois = lambda *a, **k: got.setdefault("rois", orig[1](*a, **k))
        try:
            loss, aux = m(images.to(d), im_info.to(d), gt.to(d), gt_valid.to(d), train=True,
                          draws={k: v.to(d) for k, v in draws.items()},
                          **{k: v.to(d) for k, v in masks.items()})
        finally:
            model_mod.assign_anchor, model_mod.sample_rois = orig
        loss.backward()
        runs[name] = {
            "loss": float(loss.detach()), "aux": {k: float(v.detach()) for k, v in aux.items()},
            "anchor_labels": got["anchor"].labels.cpu() if "anchor" in got else None,
            "labels": got["rois"].labels.cpu() if "rois" in got else None,
            "rois": got["rois"].rois.cpu() if "rois" in got else torch.zeros(1),
            "grads": {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None},
        }
    card, cpu = runs["card"], runs["cpu"]
    same_labels = all(
        (card[k] is None and cpu[k] is None) or torch.equal(card[k], cpu[k])
        for k in ("labels", "anchor_labels"))
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
    log(f"  small {label} train step card vs CPU: fg rois {int(cpu['aux'].get('num_fg_rois', -1))}, "
        f"fg anchors {int(cpu['aux'].get('num_fg_anchors', -1))}, same labels {same_labels}, rois "
        f"max|d| {roi_err:.3g} px, "
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
    if any(cpu["aux"].get(k, 1) <= 0 for k in ("num_fg_rois", "num_fg_anchors")):
        raise AssertionError("the small train step sampled no fg rois or anchors")


# --------------------------------------------------------- alternate phase
ALT_IMAGES = 8
# the steps of each training stage, and of the frozen FPN run
ALT_STEPS = 6
FROZEN_STEPS = 4
# the groups Fast R-CNN-1 trains (FIXED_PARAMS), which the finite
# differences move
FAST_RCNN_GROUPS = ("backbone.stage2", "backbone.stage3", "top_head", "rcnn")
# launches a stage's train step makes: an RPN stage none (no proposals);
# Fast R-CNN one ROIAlign forward, and one backward in stage 3 only: stage 5
# freezes every backbone tensor (FIXED_PARAMS_SHARED), so no gradient
# reaches the feature map and the adjoint is not run (the JAX graph's
# stop-gradient at the frozen prefix drops it too).  A proposal pass
# launches one NMS an image.
NO_LAUNCHES = {"nms": 0, "roi_align_fwd": 0, "roi_align_bwd": 0, "roi_align_stream_fwd": 0,
               "roi_align_stream_bwd": 0}
STAGE_LAUNCHES_PER_STEP = {
    "rpn1": NO_LAUNCHES,
    "rcnn1": dict(NO_LAUNCHES, roi_align_fwd=1, roi_align_bwd=1),
    "rpn2": NO_LAUNCHES,
    "rcnn2": dict(NO_LAUNCHES, roi_align_fwd=1),
}
# FPN's frozen step pools the given proposals through both routes and runs
# no proposal NMS
FROZEN_FPN_LAUNCHES_PER_STEP = dict(FPN_LAUNCHES_PER_STEP, nms=0)


class StageRecorder:
    """Wraps ``tools/train_alternate.py``'s stage calls while it runs: each
    call resets the launch counts just before and reads them just after; a
    training stage hands ``fit``'s result to its record (``report``), a
    proposal pass its recalls and the seconds of ``generate_proposals``."""

    NAMES = ("train_rpn", "test_rpn", "train_rcnn")

    def __init__(self):
        self.records = []
        self._orig = {n: getattr(alt_mod, n) for n in self.NAMES}
        self._gen = test_rpn_mod.generate_proposals

    def _wrap(self, name):
        fn = self._orig[name]

        def run(*a, **k):
            rec = {"stage": name}
            if name != "test_rpn":
                k["report"] = rec.setdefault("fit", {})
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec["seconds"] = time.perf_counter() - t0
            rec["launches"] = read_launches()
            # the stage's train state would keep its model and momenta on
            # the card through the later stages
            rec.get("fit", {}).pop("state", None)
            if name == "test_rpn":
                rec["recalls"], rec["images"] = out[1], len(out[0])
                rec["counts"] = [len(p) for p in out[0]]
            self.records.append(rec)
            return out

        return run

    def _timed_generate(self, *a, **k):
        t0 = time.perf_counter()
        out = self._gen(*a, **k)
        torch.cuda.synchronize()
        self.gen_seconds.append(time.perf_counter() - t0)
        return out

    def __enter__(self):
        self.gen_seconds = []
        for n in self.NAMES:
            setattr(alt_mod, n, self._wrap(n))
        test_rpn_mod.generate_proposals = self._timed_generate
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(alt_mod, n, fn)
        test_rpn_mod.generate_proposals = self._gen
        return False


def frozen_leaves_equal(tree, donor, fixed) -> int:
    """How many of ``tree``'s leaves the freeze set ``fixed`` holds that the
    donor also has; raises unless each is bitwise the donor's."""
    ref = dict(tree_leaves(donor))
    held = [(p, a) for p, a in tree_leaves(tree) if is_frozen_path(p, fixed) and p in ref]
    bad = ["/".join(p) for p, a in held if not np.array_equal(a, ref[p])]
    if bad or not held:
        raise AssertionError(f"frozen leaves differ from their donor's ({len(held)} held): "
                             f"{bad[:5]}")
    return len(held)


def stage_train_checks(name, rec, per_step) -> dict:
    """A training stage's gates, after its line is logged: it dispatched
    ALT_STEPS steps and launched ``per_step`` a step; finite losses, none
    above 100× the first step's.  Returns its step statistics."""
    out = rec["fit"]
    hist = out["history"]
    want = {k: n * out["dispatched_steps"] for k, n in per_step.items()}
    losses = [h["loss"] for h in hist]
    growth = max(losses) / losses[0] if losses and losses[0] > 0 else math.inf
    timed = [h["step_ms"] for h in hist[TRAIN_WARMUP:]]
    worst = max(hist, key=lambda h: h["loss"]) if hist else {}
    log(f"  {name}: losses {[round(v, 5) for v in losses]} (largest / first {growth:.3f}), "
        f"the largest step's aux "
        f"{ {k: round(v, 5) for k, v in worst.items() if k not in ('index', 'wait_ms')} }, "
        f"step median {statistics.median(timed) if timed else math.nan:.3f} ms after "
        f"{TRAIN_WARMUP} warm-up, launches {rec['launches']}")
    if rec["launches"] != want or out["dispatched_steps"] != ALT_STEPS or len(hist) != ALT_STEPS:
        raise AssertionError(f"{name} dispatched {out['dispatched_steps']} steps, ran "
                             f"{len(hist)} and launched {rec['launches']}, not {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite losses {losses}")
    if not growth <= LOSS_GROWTH_MAX:
        raise AssertionError(f"{name}: the loss grew {growth:.3g}x")
    return {"losses": losses, "growth": growth, "step_ms": timed,
            "step_ms_median": statistics.median(timed), "launches": rec["launches"],
            "dispatched_steps": out["dispatched_steps"]}


def alternate_phase(cfg, weights, dev):
    """The four-stage schedule (``tools/train_alternate.py::
    alternate_train``) at full width: ResNet-101 C4, ALT_IMAGES synthetic
    480 × 640 images and their flipped copies, ALT_STEPS steps of ``fit`` a
    training stage, from the calibrated weights the ``[train]`` run started
    from (its BN moments from ``calibration_batch`` on these images) as the
    donor of stages 1 and 3; then ``tools/test.py --params final.pkl`` with
    the run's per-class statistics.  Gates: each stage's launches (RPN
    stages none, Fast R-CNN kernel 2 once a step and kernel 3 once a step
    of stage 3 (:data:`STAGE_LAUNCHES_PER_STEP`), each proposal
    pass one NMS an image), losses, the frozen leaves of every stage bitwise
    its donor's, the final backbone bitwise RPN-2's, the evaluation's
    launches and statistics.  Returns the captured kernel inputs, the
    stats, and the Fast R-CNN-1 model and proposal roidb for the finite
    differences."""
    roidb = SyntheticDataset(num_images=ALT_IMAGES, image_size=(480, 640)).gt_roidb()
    donor_model = make_model(cfg)
    donor_model.load_state_dict(weights)
    donor = torch_to_flax(donor_model)
    del donor_model
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_alt_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Capture(keep=2) as cap, StageRecorder() as rec:
        alt_mod.alternate_train(cfg, roidb, epochs_rpn=1, epochs_rcnn=1, pretrained_donor=donor,
                                out_dir=out_dir, max_steps=ALT_STEPS, device=dev,
                                frequent=ALT_STEPS)
    seconds = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    names = ["rpn1", "test_rpn1", "rcnn1", "rpn2", "test_rpn2", "rcnn2"]
    if [r["stage"] for r in rec.records] != ["train_rpn", "test_rpn", "train_rcnn", "train_rpn",
                                             "test_rpn", "train_rcnn"]:
        raise AssertionError(f"the schedule ran {[r['stage'] for r in rec.records]}")
    stats = {"seconds": seconds, "peak_mib": peak_mib, "stages": {}}
    for name, r in zip(names, rec.records):
        if r["stage"] == "test_rpn":
            want = dict(NO_LAUNCHES, nms=ALT_IMAGES)
            gen_s = rec.gen_seconds[len([k for k in stats["stages"] if k.startswith("test_rpn")])]
            st = {"launches": r["launches"], "recalls": r["recalls"], "counts": r["counts"],
                  "seconds": r["seconds"], "images_per_s": r["images"] / gen_s}
            log(f"  {name}: {r['images']} images, proposals per image {r['counts']}, "
                f"{st['images_per_s']:.3f} images/s (generate_proposals), recalls "
                f"{ {k: round(v, 4) for k, v in r['recalls'].items()} }, launches {r['launches']}")
            if r["launches"] != want:
                raise AssertionError(f"{name} launched {r['launches']}, not {want}")
        else:
            st = stage_train_checks(name, r, STAGE_LAUNCHES_PER_STEP[name])
        stats["stages"][name] = st

    trees = {n: load_params(os.path.join(out_dir, f"{n}.pkl"))
             for n in ("rpn1", "rcnn1", "rpn2", "rcnn2", "final")}
    net = cfg.network
    held = {
        "rpn1 (FIXED_PARAMS) vs the donor": frozen_leaves_equal(trees["rpn1"], donor,
                                                                net.FIXED_PARAMS),
        "rcnn1 (FIXED_PARAMS) vs the donor": frozen_leaves_equal(trees["rcnn1"], donor,
                                                                 net.FIXED_PARAMS),
        "rpn2 (FIXED_PARAMS_SHARED) vs rcnn1": frozen_leaves_equal(
            trees["rpn2"], trees["rcnn1"], net.FIXED_PARAMS_SHARED),
        "rcnn2 (FIXED_PARAMS_SHARED) vs rpn2": frozen_leaves_equal(
            trees["rcnn2"], trees["rpn2"], net.FIXED_PARAMS_SHARED),
        "final backbone vs rpn2": frozen_leaves_equal(
            {"backbone": trees["final"]["backbone"]}, trees["rpn2"], ("backbone",)),
    }
    log(f"  frozen leaves bitwise their donor's: {held}")
    stats["frozen_leaves_held"] = held
    start = dict(tree_leaves(donor))
    if not any(not np.array_equal(a, start[p]) for p, a in tree_leaves(trees["rcnn1"])
               if p[:2] == ("backbone", "stage3") and p[-1] == "kernel"):
        raise AssertionError("Fast R-CNN-1 did not move the shared convolutions it trains")

    meta = load_run_meta(out_dir)
    seen = {}
    real_eval = test_cli.pred_eval

    def spy(predictor, loader, imdb, cfg_used, **kw):
        seen["cfg"] = cfg_used
        return real_eval(predictor, loader, imdb, cfg_used, **kw)

    test_cli.pred_eval = spy
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        results = test_cli.test_rcnn(test_cli.parse_args(
            ["--network", "resnet", "--dataset", "PascalVOC", "--synthetic", "8",
             "--params", os.path.join(out_dir, "final.pkl")]))
        eval_s = time.perf_counter() - t0
    finally:
        test_cli.pred_eval = real_eval
    eval_launches = read_launches()
    per_class = tuple(tuple(r) for r in meta["BBOX_STDS_PER_CLASS"])
    log(f"  tools/test.py --params final.pkl --synthetic 8: mAP {results['mAP']:.6f}, "
        f"{eval_s:.3f} s, launches {eval_launches}; per-class stats applied "
        f"{seen['cfg'].TRAIN.BBOX_STDS_PER_CLASS == per_class}")
    if seen["cfg"].TRAIN.BBOX_STDS_PER_CLASS != per_class:
        raise AssertionError("tools/test.py did not apply final.pkl's run_meta statistics")
    if eval_launches != dict(NO_LAUNCHES, nms=16, roi_align_fwd=8):
        raise AssertionError(f"tools/test.py launched {eval_launches}")
    stats["eval"] = {"mAP": results["mAP"], "seconds": eval_s, "launches": eval_launches}
    log(f"  the schedule {seconds:.1f} s; max_memory_allocated {peak_mib:.1f} MiB")

    props1 = load_params(os.path.join(out_dir, "proposals1.pkl"))
    prop_roidb = IMDB.append_flipped_images(attach_proposals(roidb, props1))
    rcnn1 = flax_to_torch(trees["rcnn1"], make_model(cfg, cls=FastRCNN))
    rcnn1.to(dev, memory_format=torch.channels_last)
    shutil.rmtree(out_dir, ignore_errors=True)
    return cap, stats, rcnn1, prop_roidb


def frozen_fpn_phase(fcfg, weights, dev):
    """FPN's frozen-proposal mode at full width (ResNet-50 FPN): the
    calibrated ``[fpn train]`` weights' own proposals over ALT_IMAGES
    synthetic 480 × 640 images (``generate_proposals`` at the dump's
    TEST.PROPOSAL_* budgets), attached and flipped, then FROZEN_STEPS steps
    of ``fit(proposal_count=TRAIN.RPN_POST_NMS_TOP_N)``.  Gates: no NMS in
    the steps, kernels 2–5 twice a step, the losses.  Returns the captured
    kernel inputs, the launches and the stats."""
    roidb = SyntheticDataset(num_images=ALT_IMAGES, image_size=(480, 640)).gt_roidb()
    pcfg = test_rpn_mod.proposal_cfg(fcfg)
    model = make_model(pcfg)
    model.load_state_dict(weights)
    props = tester_mod.generate_proposals(Predictor(model, device=dev), TestLoader(roidb, pcfg),
                                          pcfg)
    del model
    counts = [len(p) for p in props]
    frozen = IMDB.append_flipped_images(attach_proposals(roidb, props))
    model = make_model(fcfg)
    model.load_state_dict(weights)
    torch.cuda.synchronize()
    reset_launches()
    with Capture(keep=2) as cap:
        out = fit(model, fcfg, frozen, epochs=1, seed=0, max_steps=FROZEN_STEPS,
                  frequent=FROZEN_STEPS, device=dev,
                  proposal_count=fcfg.TRAIN.RPN_POST_NMS_TOP_N)
    launches = read_launches()
    hist = out["history"]
    want = {k: n * out["dispatched_steps"] for k, n in FROZEN_FPN_LAUNCHES_PER_STEP.items()}
    losses = [h["loss"] for h in hist]
    log(f"  proposals per image {counts}; {len(frozen)} records; losses "
        f"{[round(v, 5) for v in losses]}; valid proposals a step "
        f"{[int(h['num_valid_props']) for h in hist]}; launches {launches} (expected {want})")
    if launches != want or out["dispatched_steps"] != FROZEN_STEPS:
        raise AssertionError(f"the frozen FPN run dispatched {out['dispatched_steps']} steps and "
                             f"launched {launches}, not {want}")
    growth = max(losses) / losses[0] if losses[0] > 0 else math.inf
    if not all(math.isfinite(v) for v in losses) or not growth <= LOSS_GROWTH_MAX:
        raise AssertionError(f"the frozen FPN run's losses {losses}")
    timed = [h["step_ms"] for h in hist[TRAIN_WARMUP:]]
    stats = {"proposals_per_image": counts, "losses": losses, "growth": growth,
             "step_ms": timed, "step_ms_median": statistics.median(timed), "launches": launches}
    log(f"  frozen FPN step median {stats['step_ms_median']:.3f} ms after {TRAIN_WARMUP} warm-up")
    return cap, launches, stats


# -------------------------------------------------------------- eval phase
EVAL_IMAGES = 32
# VOC's most common image size: 600 x 800 after the resize, in the 608 x 1024
# bucket
EVAL_HW = (375, 500)
# detections of two settings whose forwards differ (a batch of 2, the host
# decode): the bars of tests/test_postprocess.py and of the JAX comparison
EVAL_SCORE_TOL = 1e-5
EVAL_BOX_TOL = 1e-3
MAP_TOL = 1e-6


class _TimedImdb:
    """An imdb that notes when ``pred_eval`` hands it the detections (the
    end of the loop's drain) and keeps a mask model's RLEs."""

    def __init__(self, imdb):
        self.imdb, self.num_classes = imdb, imdb.num_classes
        self.t_end = self.all_masks = None

    def evaluate_detections(self, all_boxes, all_masks=None):
        self.t_end = time.perf_counter()
        if all_masks is None:
            return self.imdb.evaluate_detections(all_boxes)
        self.all_masks = all_masks
        return self.imdb.evaluate_detections(all_boxes, all_masks=all_masks)


def eval_settings(workers: int):
    """The [eval] phase's settings: (label, test_batch, pred_eval knobs,
    pipelined knobs, DEVICE_POSTPROCESS)."""
    return (
        ("serial", 1, {"postprocess_workers": 0},
         {"in_flight": 1, "feed_depth": 0, "mode": "async"}, True),
        ("JAX defaults", 1, {"postprocess_workers": 0}, {}, True),
        ("JAX defaults, threads", 1, {"postprocess_workers": 0}, {"mode": "threads"}, True),
        ("batched async", 2, {"assembly_workers": workers, "postprocess_workers": 2},
         {"mode": "async"}, True),
        ("batched threads", 2, {"assembly_workers": workers, "postprocess_workers": 2},
         {"mode": "threads"}, True),
        ("host branch", 1, {"postprocess_workers": 2}, {}, False),
        ("host branch, ties ascending", 1, {"postprocess_workers": 2}, {}, False),
    )


def nms_ties_ascending(dets: np.ndarray, thresh: float) -> list:
    """``nms_numpy`` with equal scores taken in ascending index order, as
    the device's stable sort takes them (the host C NMS, like the
    reference's, takes them in descending order)."""
    if dets.size == 0:
        return []
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        w = np.maximum(0.0, np.minimum(x2[i], x2[order[1:]]) - np.maximum(x1[i], x1[order[1:]]) + 1)
        h = np.maximum(0.0, np.minimum(y2[i], y2[order[1:]]) - np.maximum(y1[i], y1[order[1:]]) + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return keep


def eval_run(predictor, cfg, roidb, imdb, batch, knobs, loop_knobs, label):
    """``pred_eval`` over ``roidb`` with the loop's ``loop_knobs`` (its
    in_flight, feed_depth and mode); images/s over the images after the
    first result, by the host clock from that result to the end of the
    drain.  Returns (all_boxes, results, figures, launches, all_masks)."""
    orig = tester_mod.pipelined
    first = {}

    def timed(*a, **k):
        for item in orig(*a, **{**k, **loop_knobs}):
            if not first:
                first["t"], first["n"] = time.perf_counter(), len(item[1]["images"])
            yield item

    timed_imdb = _TimedImdb(imdb)
    stats = {}
    tester_mod.pipelined = timed
    torch.cuda.synchronize()
    reset_launches()
    try:
        all_boxes, results = pred_eval(predictor, TestLoader(roidb, cfg, batch_size=batch),
                                       timed_imdb, cfg, stats_out=stats, **knobs)
    finally:
        tester_mod.pipelined = orig
    launches = read_launches()
    n = len(roidb) - first["n"]
    feed = stats["feed"]
    fig = {
        "images_per_s": n / (timed_imdb.t_end - first["t"]), "timed_images": n,
        "wait_ms_median": statistics.median(feed["wait_ms"]),
        "wait_ms_mean": statistics.fmean(feed["wait_ms"]),
        "wait_ms": [round(w, 3) for w in feed["wait_ms"]],
        "feed": {k: v for k, v in feed.items() if k != "wait_ms"},
        "completion": stats["completion"],
        "launches_per_image": {k: v / len(roidb) for k, v in launches.items() if v},
        "mAP": results["mAP"],
    }
    log(f"  {label}: test_batch {batch}, {knobs}, loop {loop_knobs}, DEVICE_POSTPROCESS "
        f"{cfg.TEST.DEVICE_POSTPROCESS}: {fig['images_per_s']:.3f} images/s over {n} images; "
        f"the dispatch thread's wait per batch median {fig['wait_ms_median']:.3f} ms (mean "
        f"{fig['wait_ms_mean']:.3f}); loop {fig['feed']}; completion {fig['completion']}; "
        f"launches {launches} ({fig['launches_per_image']} per image); mAP {results['mAP']:.6f}")
    if min(launches["nms"], launches["roi_align_fwd"]) <= 0:
        raise AssertionError(f"{label}: a kernel of the eval path never launched: {launches}")
    return all_boxes, results, fig, launches, timed_imdb.all_masks


def _kept_diff(a, b, cfg):
    """The detections of one (image, class) kept in ``a`` and not in ``b``,
    each with its score's gap to the threshold and its largest IoU with a
    higher-scored detection of ``a`` against the NMS bar."""
    out = []
    for d in a:
        if len(b) and np.abs(b - d).max(axis=1).min() <= EVAL_BOX_TOL:
            continue
        higher = a[a[:, 4] > d[4]]
        iou = 0.0
        if len(higher):
            iw = np.minimum(higher[:, 2], d[2]) - np.maximum(higher[:, 0], d[0]) + 1
            ih = np.minimum(higher[:, 3], d[3]) - np.maximum(higher[:, 1], d[1]) + 1
            inter = np.maximum(iw, 0) * np.maximum(ih, 0)
            area = lambda x: (x[..., 2] - x[..., 0] + 1) * (x[..., 3] - x[..., 1] + 1)
            iou = float((inter / (area(higher) + area(d) - inter)).max())
        out.append({"score_minus_thresh": float(d[4]) - cfg.TEST.SCORE_THRESH,
                    "iou_minus_nms": iou - cfg.TEST.NMS})
    return out


def _by_score(x):
    return x[np.argsort(-x[:, 4], kind="stable")]


def _close(x, y, rtol=0.0) -> bool:
    """Same count, scores within EVAL_SCORE_TOL (and ``rtol``), boxes
    within EVAL_BOX_TOL px (and 10 ``rtol``), each sorted by score."""
    if x.shape != y.shape:
        return False
    x, y = _by_score(x), _by_score(y)
    return bool(np.allclose(x[:, 4], y[:, 4], rtol=rtol, atol=EVAL_SCORE_TOL)
                and np.allclose(x[:, :4], y[:, :4], rtol=rtol * 10, atol=EVAL_BOX_TOL))


def same_detections(a, b, cfg, label, rtol=0.0):
    """Every (image, class) of ``a`` and ``b`` :func:`_close`; prints the
    image, class and the gaps to the threshold and to the NMS bar of every
    keep that differs, and raises.  Returns whether they are
    bit-identical."""
    bad, score_err, box_err, identical = [], 0.0, 0.0, True
    for j in range(1, len(a)):
        for i in range(len(a[j])):
            x, y = a[j][i], b[j][i]
            if x.shape != y.shape:
                bad.append((i, j, len(x), len(y), _kept_diff(x, y, cfg), _kept_diff(y, x, cfg)))
                continue
            identical &= bool(np.array_equal(x, y))
            if len(x):
                xs, ys = _by_score(x), _by_score(y)
                score_err = max(score_err, float(np.abs(xs[:, 4] - ys[:, 4]).max()))
                box_err = max(box_err, float(np.abs(xs[:, :4] - ys[:, :4]).max()))
            if not _close(x, y, rtol):
                bad.append((i, j, "values"))
    log(f"  {label}: bit-identical {identical}, max score |d| {score_err:.3g}, max box |d| "
        f"{box_err:.3g} px, differing (image, class): {bad[:10]}")
    if bad:
        raise AssertionError(f"{label}: the detections differ beyond the bars: {bad[:10]}")
    return identical


def host_syncs_per_forward(predictor, batch, dev):
    """Host synchronisations in one ``predict_async`` (the forward and the
    device postprocess) on a batch staged on the card, and in reading its
    batched host copy, counted with ``torch.cuda.set_sync_debug_mode``."""
    from mx_rcnn_tpu_torch.core.pipeline import batch_to_device
    from mx_rcnn_tpu_torch.core.tester import PendingFetch

    staged = batch_to_device(batch, dev)
    PendingFetch(predictor.predict_async(staged)).result()
    counts = {}
    for what in ("forward", "fetch"):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if what == "forward":
                    out = predictor.predict_async(staged)
                else:
                    PendingFetch(out).result()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        lines = {}
        for w in caught:
            if "synchroniz" in str(w.message):
                where = f"{os.path.relpath(w.filename)}:{w.lineno}"
                lines[where] = lines.get(where, 0) + 1
        counts[what] = {"count": sum(lines.values()), "by_line": lines}
    log(f"  host syncs in one forward on a staged batch: {counts['forward']}; in reading its "
        f"host copy: {counts['fetch']}")
    return counts


def eval_profile(predictor, cfg, roidb, dev):
    """Wall and device-busy time of one eval forward (the device
    postprocess and the host copy included) on a staged batch of 1 and of
    2 images (torch.profiler), and the busy time per image."""
    from mx_rcnn_tpu_torch.core.pipeline import batch_to_device

    out = {}
    bucket = _orientation_bucket(roidb[0], cfg.SHAPE_BUCKETS)
    for n in (1, 2):
        staged = batch_to_device(build_test_batch(roidb, cfg, bucket, list(range(n)))[2], dev)
        predictor.predict(staged)
        _, wall_ms, events = _profiled(lambda: predictor.predict(staged))
        busy = sum(e.self_device_time_total for e in events) / 1e3
        out[n] = {"wall_ms": wall_ms, "busy_ms": busy, "busy_ms_per_image": busy / n}
        log(f"  one eval forward of {n} image(s): wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
            f"({busy / n:.3f} ms an image; profiler on)")
    return out


def eval_phase(cfg, weights, dev, workers):
    """``pred_eval`` at full width on EVAL_IMAGES synthetic VOC-sized
    images from the calibrated C4 weights, in each of ``eval_settings``;
    gates: serial and the JAX defaults bit-identical, image 0 as
    ``detect_single`` gives it, the batched settings at the bars, the host
    branch at the bars once its NMS takes tied scores in the device's
    order, equal mAP where the detections are equal, both kernels launched
    in every setting and equal to their plain versions on the eval path's
    tensors.  Returns the figures, the captured kernel inputs and the
    JAX-defaults run's launches."""
    if hostops.backend() != "c":
        raise AssertionError("the host NMS did not load its C library on this machine")
    imdb = SyntheticDataset(num_images=EVAL_IMAGES, num_classes=NUM_CLASSES, image_size=EVAL_HW)
    roidb = imdb.gt_roidb()
    model = make_model(cfg)
    model.load_state_dict(weights)
    predictor = Predictor(model, device=dev)
    host_cfg = cfg.replace(TEST=dataclasses.replace(cfg.TEST, DEVICE_POSTPROCESS=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, figures = {}, {}
    settings = eval_settings(workers)
    timed = [st for st in settings if st[0] != "host branch, ties ascending"]
    # two passes, the second in reverse order: one pass of 32 images per
    # setting does not resolve the settings' order on a shared host
    for pass_no, order in ((1, settings), (2, timed[::-1])):
        log(f"  pass {pass_no}")
        for label, batch, knobs, loop_knobs, device_pp in order:
            args = (predictor, cfg if device_pp else host_cfg, roidb, imdb, batch, knobs,
                    loop_knobs, label)
            if pass_no == 2:
                figures[label]["pass 2"] = eval_run(*args)[2]
            elif label == "JAX defaults":
                with Capture(keep=2) as cap:
                    runs[label] = eval_run(*args)
            elif label == "host branch, ties ascending":
                orig = runner_mod.nms_host
                runner_mod.nms_host = nms_ties_ascending
                try:
                    runs[label] = eval_run(*args)
                finally:
                    runner_mod.nms_host = orig
            else:
                runs[label] = eval_run(*args)
            if pass_no == 1:
                figures[label] = runs[label][2]
    log("  images/s by setting, pass 1 / pass 2: " + "; ".join(
        f"{label} {figures[label]['images_per_s']:.3f} / {figures[label]['pass 2']['images_per_s']:.3f}"
        for label, *_ in timed))
    figures["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    log(f"  max_memory_allocated over the eval runs: {figures['peak_mib']:.1f} MiB")

    # image 0 through detect_single, on the same rendered pixels
    serial = runs["serial"][0]
    pp = make_test_postprocess(cfg, NUM_CLASSES, cfg.TEST.SCORE_THRESH, cfg.TEST.DET_PER_CLASS)
    single = Predictor(model, pp, device=dev)
    dets, _ = cap_detections(
        detect_single(single, load_record_image(roidb[0]), cfg, NUM_CLASSES),
        cfg.TEST.MAX_PER_IMAGE)
    worst = max((float(np.abs(dets[j] - serial[j][0]).max()) if len(dets[j]) else 0.0)
                if dets[j].shape == serial[j][0].shape else math.inf
                for j in range(1, NUM_CLASSES))
    log(f"  image 0: pred_eval vs detect_single on the same pixels, max |d| {worst}")
    figures["host_syncs"] = host_syncs_per_forward(single, next(iter(TestLoader(roidb, cfg)))[1],
                                                   dev)
    figures["profile"] = eval_profile(single, cfg, roidb, dev)

    kept = sum(len(serial[j][i]) for j in range(1, NUM_CLASSES) for i in range(EVAL_IMAGES))
    maps = {label: run[1]["mAP"] for label, run in runs.items()}
    log(f"  serial: {kept} detections kept over {EVAL_IMAGES} images; results "
        f"{runs['serial'][1]}; mAP by setting: {maps}")
    for label in runs:
        if label in ("serial", "host branch"):
            continue
        identical = same_detections(
            serial, runs[label][0], cfg, f"{label} vs serial",
            rtol=EVAL_SCORE_TOL if label.startswith("host") else 0.0)
        if label.startswith("JAX defaults") and not identical:
            raise AssertionError(f"{label}: other detections than the serial loop's")
        if identical and abs(maps[label] - maps["serial"]) > MAP_TOL:
            raise AssertionError(f"{label}: equal detections, mAP {maps}")
    # the C NMS takes tied scores in the reference's (descending index)
    # order: where a class's scores tie (a saturated softmax), it may keep
    # other boxes than the device.  The same run with the device's tie
    # order was held to the device's detections above, so these pairs
    # differ by that order alone
    tie_pairs = tie_order_pairs(serial, runs["host branch"][0])
    figures["host_branch_tie_order_pairs"] = tie_pairs
    log(f"  host branch (C NMS, ties in descending index order) vs serial: (image, class) pairs "
        f"that differ only by the order of tied scores: {tie_pairs}")
    if kept == 0:
        raise AssertionError("the eval path kept no detection")
    if worst != 0.0:
        raise AssertionError(f"pred_eval and detect_single disagree on image 0: {worst}")
    return figures, cap, runs["JAX defaults"][3]


def tie_order_pairs(device, host):
    """(image, class, device keeps, host keeps) of every pair where the host
    branch's detections differ from the device's beyond the bars."""
    return [(i, j, len(device[j][i]), len(host[j][i]))
            for j in range(1, len(device)) for i in range(len(device[j]))
            if not _close(device[j][i], host[j][i], rtol=EVAL_SCORE_TOL)]


def small_eval_agrees(dev):
    """A small eval (``small_c4_cfg`` at 128 x 128, 4 synthetic images) on
    the card and on the CPU with the same weights: the same keep counts,
    scores within 1e-4, boxes within 1e-2 px (small_request_agrees' bars),
    mAP within MAP_TOL."""
    cfg = small_c4_cfg()
    cfg = cfg.replace(
        SHAPE_BUCKETS=((128, 128),),
        dataset=dataclasses.replace(cfg.dataset, SCALES=((128, 128),)),
        TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=32),
    )
    imdb = SyntheticDataset(num_images=4, num_classes=NUM_CLASSES, image_size=(128, 128),
                            max_boxes=2)
    roidb = imdb.gt_roidb()
    model = make_model(cfg, seed=5)
    out = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        out[name] = pred_eval(Predictor(copy.deepcopy(model), device=d), TestLoader(roidb, cfg),
                              imdb, cfg)
    (card, card_res), (cpu, cpu_res) = out["card"], out["cpu"]
    counts_equal = all(card[j][i].shape == cpu[j][i].shape
                       for j in range(1, NUM_CLASSES) for i in range(4))
    score_err = box_err = 0.0
    if counts_equal:
        for j in range(1, NUM_CLASSES):
            for i in range(4):
                x, y = card[j][i], cpu[j][i]
                x, y = x[np.argsort(-x[:, 4], kind="stable")], y[np.argsort(-y[:, 4], kind="stable")]
                if len(x):
                    score_err = max(score_err, float(np.abs(x[:, 4] - y[:, 4]).max()))
                    box_err = max(box_err, float(np.abs(x[:, :4] - y[:, :4]).max()))
    kept = sum(len(cpu[j][i]) for j in range(1, NUM_CLASSES) for i in range(4))
    log(f"  small eval card vs CPU: {kept} detections on the CPU, same keep counts "
        f"{counts_equal}, max score |d| {score_err:.3g}, max box |d| {box_err:.3g} px, mAP "
        f"{card_res['mAP']:.6f} vs {cpu_res['mAP']:.6f}")
    if (not counts_equal or score_err > 1e-4 or box_err > 1e-2 or kept == 0
            or abs(card_res["mAP"] - cpu_res["mAP"]) > MAP_TOL):
        raise AssertionError("the small eval disagrees between the card and the CPU")


# ------------------------------------------------- FPN and mask inference
COCO_CLASSES = 81
# kernel launches of one FPN / Mask R-CNN inference forward with the device
# postprocess: NMS over the levels' union and over the classes; kernel 2 on
# P2..P5 for the box head, and again at 14 x 14 for the mask head
FPN_SERVE_LAUNCHES = {"nms": 2, "roi_align_fwd": 4}
MASK_SERVE_LAUNCHES = {"nms": 2, "roi_align_fwd": 8}
MASK_EVAL_IMAGES = 32
# COCO's most common image size: 608 x 810 after the resize, in the
# 608 x 1024 bucket
MASK_EVAL_HW = (480, 640)


def masked_images(hws, seed: int = 30):
    """Synthetic COCO-like images (polygon shapes of 80 classes on noise)
    of the given sizes, one record each."""
    out = []
    for i, hw in enumerate(hws):
        rec = SyntheticDataset(num_images=1, num_classes=COCO_CLASSES, image_size=hw,
                               seed=seed + i, with_masks=True).gt_roidb()[0]
        out.append(load_record_image(rec))
    return out


def serve_masks(predictor, im, cfg):
    """One mask request: prepare, forward with the device postprocess (and
    paste), per-class detections capped at MAX_PER_IMAGE with their mask
    probabilities, and an image-space RLE for each.  → (dets, rles, the
    host outputs, the batch)."""
    req = prepare_request(im, cfg, BucketLadder(cfg.SHAPE_BUCKETS))
    batch = {"images": req.image[None], "im_info": req.im_info[None],
             "orig_hw": np.asarray([req.orig_hw], np.float32)}
    out = predictor.predict(batch)
    dets, probs = runner_mod.detections_from_output(
        out, batch["im_info"][0], req.orig_hw, cfg, COCO_CLASSES)
    dets, probs = cap_detections(dets, cfg.TEST.MAX_PER_IMAGE, probs)
    h, w = req.orig_hw
    rles = {j: rles_for_detections(probs[j], dets[j], h, w) for j in range(1, COCO_CLASSES)}
    return dets, rles, out, batch


def canvas_matches_host_paste(out, batch):
    """Every valid survivor's device canvas (``det_canvas``) bitwise against
    ``eval/segm.py::paste_mask_canvas`` on the same logits and box; returns
    (survivors checked, pixels set)."""
    checked = pixels = 0
    hc, wc = batch["images"].shape[1:3]
    for b in range(out["det_canvas"].shape[0]):
        flat = out["det_boxes"][b].reshape(-1, 4)
        for p in np.where(out["det_mask_valid"][b])[0]:
            box = flat[out["det_mask_idx"][b, p]] * batch["im_info"][b, 2]
            expect = paste_mask_canvas(out["det_masks"][b, p], box, hc, wc)
            if out["det_canvas"][b, p].tobytes() != expect.tobytes():
                raise AssertionError(f"device canvas of image {b} survivor {p} differs from "
                                     f"paste_mask_canvas")
            checked += 1
            pixels += int(expect.sum())
    return checked, pixels


def paste_cost(model, cfg, batch, dev):
    """Device ms and memory of the canvas paste at the batch's bucket: the
    mask postprocess with and without ``paste`` on the same raw outputs
    (CUDA events), and the peak memory the paste adds."""
    staged = batch_to_device(batch, dev)
    with torch.inference_mode():
        raw = Predictor(model, device=dev).predict_async(staged)
        hw = tuple(staged["images"].shape[1:3])
        args = (raw, staged["im_info"], staged["orig_hw"])
        te = cfg.TEST
        plain = make_test_postprocess(cfg, COCO_CLASSES, te.SCORE_THRESH, te.DET_PER_CLASS)
        paste = make_test_postprocess(cfg, COCO_CLASSES, te.SCORE_THRESH, te.DET_PER_CLASS,
                                      paste=True)
        no_paste_ms = cuda_ms(lambda: plain(*args), reps=5)
        with_paste_ms = cuda_ms(lambda: paste(*args, hw), reps=5)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        paste(*args, hw)
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base) / 2**20
    fig = {"batch": int(staged["images"].shape[0]), "canvas_hw": list(hw),
           "postprocess_ms": no_paste_ms, "postprocess_with_paste_ms": with_paste_ms,
           "paste_ms": with_paste_ms - no_paste_ms, "paste_peak_extra_mib": extra,
           "canvas_mib": staged["images"].shape[0] * cfg.TEST.MAX_PER_IMAGE * hw[0] * hw[1] / 2**20}
    log(f"  canvas paste at {hw}, batch {fig['batch']}: postprocess {no_paste_ms:.3f} ms, with "
        f"paste {with_paste_ms:.3f} ms (paste {fig['paste_ms']:.3f} ms); canvas "
        f"{fig['canvas_mib']:.1f} MiB uint8, peak memory over the forward's +{extra:.1f} MiB")
    return fig


def infer_serve_phase(label, cfg, dev, per_forward):
    """Serve the six REQUEST_HW synthetic COCO-like requests (both buckets)
    and a same-bucket batch of 2 through the FPN or Mask R-CNN model at full
    width, from seeded weights calibrated on the first request (BN moments
    and unit scales from one inference forward).  A box model serves with
    ``detect_single``; a mask model through the Predictor with the canvas
    paste, ``detections_from_output``, the cap and ``rles_for_detections``.
    Gates: the launches of the run (reset just before, read just after) are
    ``per_forward`` × 7 forwards, finite detections of the right shapes, and
    for the mask model every device canvas of the batch bitwise equal to
    ``paste_mask_canvas``.  Returns (capture, launches, figures, predictor,
    one request image, the calibrated weights)."""
    mask = cfg.network.USE_MASK
    model = make_model(cfg)
    images = masked_images(REQUEST_HW)
    ladder = BucketLadder(cfg.SHAPE_BUCKETS)
    reqs = [prepare_request(im, cfg, ladder) for im in images]
    buckets = sorted({r.bucket for r in reqs})
    if len(buckets) != 2:
        raise AssertionError(f"requests must cover both buckets, got {buckets}")
    calib = batch_to_device({"images": reqs[0].image[None], "im_info": reqs[0].im_info[None]}, dev)
    calibrate_bn(model, calib)
    calibrate_scales(model, calib)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    te = cfg.TEST
    pp = make_test_postprocess(cfg, COCO_CLASSES, te.SCORE_THRESH, te.DET_PER_CLASS, paste=mask)
    predictor = Predictor(model, pp, device=dev)

    def serve(im):
        if mask:
            return serve_masks(predictor, im, cfg)[0]
        return detect_single(predictor, im, cfg, COCO_CLASSES)

    pair = [i for i, r in enumerate(reqs) if r.bucket == buckets[0]][:2]
    batch = {
        "images": np.stack([reqs[i].image for i in pair]),
        "im_info": np.stack([reqs[i].im_info for i in pair]),
        "orig_hw": np.asarray([reqs[i].orig_hw for i in pair], np.float32),
    }
    # warm-up, one request per bucket and the batch (cuDNN and allocator
    # first use); the peak memory is read over it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for b in buckets:
        serve(images[[r.bucket for r in reqs].index(b)])
    predictor.predict(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20

    reset_launches()
    with Capture() as cap:
        all_dets = [serve(im) for im in images]
        out = predictor.predict(batch)
    launches = read_launches()
    expected = {k: per_forward.get(k, 0) * 7 for k in KERNELS}
    log(f"  launches in the {label} path (6 requests, a batch of 2): {launches}")
    if launches != expected:
        raise AssertionError(f"{label}: launches {launches}, reckoned {expected}")
    for dets in all_dets:
        for d in dets[1:]:
            if d.ndim != 2 or d.shape[1] != 5 or not np.isfinite(d).all():
                raise AssertionError("non-finite or misshapen detections")
    if out["det_boxes"].shape != (2, COCO_CLASSES - 1, te.DET_PER_CLASS, 4):
        raise AssertionError(f"det_boxes shape {out['det_boxes'].shape}")
    if not np.isfinite(out["det_boxes"]).all() or not out["det_valid"].any():
        raise AssertionError("batch detections are non-finite or empty")

    times, fwd_times, rle_counts = [], [], []
    for im in images:
        t0 = time.perf_counter()
        if mask:
            _, rles, _, _ = serve_masks(predictor, im, cfg)
            rle_counts.append(sum(len(v) for v in rles.values()))
        else:
            serve(im)
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    predictor.predict(batch)
    batch_ms = (time.perf_counter() - t0) * 1e3
    fig = {"latency_ms": times, "latency_ms_median": statistics.median(times),
           "batch_of_2_ms": batch_ms, "peak_mib": peak,
           "detections_request_0": int(sum(len(d) for d in all_dets[0][1:]))}
    log(f"  per-request ms (host resize" + (", RLEs of the capped detections" if mask else "")
        + f" included): {[round(t, 3) for t in times]} median={fig['latency_ms_median']:.3f}; "
        f"batch-of-2 Predictor.predict ms: {batch_ms:.3f}; max_memory_allocated over the warm-up "
        f"{peak:.1f} MiB; detections request 0: {fig['detections_request_0']}")
    if mask:
        fig["rles_per_request"] = rle_counts
        checked, pixels = canvas_matches_host_paste(out, batch)
        fig["canvas_checked"], fig["canvas_pixels"] = checked, pixels
        log(f"  RLEs per request {rle_counts}; device canvas bitwise equal to paste_mask_canvas "
            f"on all {checked} survivors of the batch ({pixels} pixels set)")
        if checked == 0 or pixels == 0 or min(rle_counts) == 0:
            raise AssertionError("the mask path pasted no mask")
        fig["paste"] = paste_cost(model, cfg, batch, dev)
    fig["host_syncs"] = host_syncs_per_forward(
        predictor, {k: v[:1] for k, v in batch.items()}, dev)
    if fig["host_syncs"]["forward"]["count"] != 0:
        raise AssertionError(f"{label}: host syncs in the forward {fig['host_syncs']}")
    _, wall_ms, events = _profiled(lambda: serve(images[0]))
    busy = sum(e.self_device_time_total for e in events) / 1e3
    fig["profile"] = {"wall_ms": wall_ms, "busy_ms": busy}
    by_layer = {}
    for e in events:
        by_layer[_layer_of(e.key)] = by_layer.get(_layer_of(e.key), 0.0) + e.self_device_time_total
    log(f"  one request profiled: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms; by layer "
        + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in sorted(by_layer.items(), key=lambda kv: -kv[1])))
    return cap, launches, fig, predictor, images[0], weights


def mask_eval_phase(cfg, weights, dev):
    """``pred_eval`` of the Mask R-CNN model over MASK_EVAL_IMAGES synthetic
    COCO-sized masked images, serial and with the JAX package's defaults:
    bit-identical detections and RLEs, equal box mAP and segm stats, and the
    path's kernels launched per image as reckoned.  Returns the figures."""
    imdb = SyntheticDataset(num_images=MASK_EVAL_IMAGES, num_classes=COCO_CLASSES,
                            image_size=MASK_EVAL_HW, with_masks=True)
    roidb = imdb.gt_roidb()
    model = make_model(cfg)
    model.load_state_dict(weights)
    predictor = Predictor(model, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, figures = {}, {}
    for label, knobs, loop_knobs in (
            ("serial", {"postprocess_workers": 0}, {"in_flight": 1, "feed_depth": 0,
                                                    "mode": "async"}),
            ("JAX defaults", {"postprocess_workers": 0}, {})):
        runs[label] = eval_run(predictor, cfg, roidb, imdb, 1, knobs, loop_knobs, label)
        figures[label] = runs[label][2]
        figures[label]["segm"] = {k: v for k, v in runs[label][1].items() if k.startswith("segm_")}
        per_image = {k: v / MASK_EVAL_IMAGES for k, v in runs[label][3].items()}
        if per_image != {k: float(MASK_SERVE_LAUNCHES.get(k, 0)) for k in KERNELS}:
            raise AssertionError(f"{label}: launches per image {per_image}")
    figures["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    (a, ra, _, _, ma), (b, rb, _, _, mb) = runs["serial"], runs["JAX defaults"]
    kept = sum(len(a[j][i]) for j in range(1, COCO_CLASSES) for i in range(MASK_EVAL_IMAGES))
    same = all(np.array_equal(a[j][i], b[j][i]) and ma[j][i] == mb[j][i]
               for j in range(1, COCO_CLASSES) for i in range(MASK_EVAL_IMAGES))
    log(f"  {kept} detections (and masks) kept over {MASK_EVAL_IMAGES} images; serial vs JAX "
        f"defaults bit-identical (boxes and RLEs) {same}; images/s serial "
        f"{figures['serial']['images_per_s']:.3f}, JAX defaults "
        f"{figures['JAX defaults']['images_per_s']:.3f}; mAP {ra['mAP']:.6f}; segm "
        f"{figures['serial']['segm']}; max_memory_allocated {figures['peak_mib']:.1f} MiB")
    if kept == 0 or not same or ra != rb:
        raise AssertionError("the mask eval settings disagree or kept nothing")
    if len(figures["serial"]["segm"]) != 12:
        raise AssertionError(f"segm stats missing: {ra}")
    figures["launches"] = runs["JAX defaults"][3]
    return figures


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


def stream_fwd_timing(entry, label):
    feat, rois, pooled, scale, s = entry
    ms, wrap, plain = time_kernel(
        lambda: stream_mod.roi_align_stream(feat, rois, pooled, scale, s),
        lambda: stream_mod.roi_align_stream_plain(feat, rois, pooled, scale, s), reps=20)
    out = stream_mod.roi_align_stream(feat, rois, pooled, scale, s)
    keep = stream_mod.valid_rois(rois, scale)
    bound, by = bound_ms(*roi_work(feat, rois, pooled, scale, s, None, out, keep))
    log(f"  roi_align_stream {label} feat {tuple(feat.shape)} rois {tuple(rois.shape)} "
        f"({int(keep.sum())} valid): kernel {ms:.4f} ms (graph), wrapper {wrap:.4f} ms (eager), "
        f"plain {plain:.2f} ms, bound {bound:.5f} ms ({by})")
    return {"ms": ms, "wrapper_ms": wrap, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "shape": list(feat.shape) + list(rois.shape)}


def stream_bwd_work(g, rois, shape, scale):
    """Bytes the streamed backward must move (the cotangents of the valid
    rois, the rois, the whole dfeat written once) and its flops."""
    keep = stream_mod.valid_rois(rois, scale)
    g_valid = g.numel() // keep.numel() * int(keep.sum())
    return (g_valid + rois.numel() + int(np.prod(shape))) * 4, g_valid * ROI_BWD_FLOPS_PER_G


def stream_bwd_timing(entry, label):
    g, rois, shape, pooled, scale, s = entry
    ms, wrap, plain = time_kernel(
        lambda: stream_mod._roi_align_stream_bwd_cuda(g, rois, shape, pooled, scale, s),
        lambda: stream_mod.roi_align_stream_bwd_plain(g, rois, shape, pooled, scale, s), reps=20)
    bound, by = bound_ms(*stream_bwd_work(g, rois, shape, scale))
    log(f"  roi_align_stream_bwd {label} g {tuple(g.shape)} -> {tuple(shape)}: kernel {ms:.4f} ms "
        f"(graph), wrapper {wrap:.4f} ms (eager), plain {plain:.2f} ms, bound {bound:.5f} ms ({by})")
    return {"ms": ms, "wrapper_ms": wrap, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "shape": list(g.shape) + list(shape)}


def at_scale(entries, scale):
    """The last captured ROIAlign call at ``scale`` (the pyramid level):
    a forward entry holds the scale after (feat, rois, pooled), a backward
    one after (g, rois, feat_shape, pooled)."""
    return [e for e in entries if e[3 if e[0].dim() == 4 else 4] == scale][-1]


def ptxas_summary(lib):
    """{mangled kernel name: "R registers, spill stores S B, spill loads L B"}
    from ``lib``'s ptxas log."""
    out, name = {}, None
    for line in lib.ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = f"spill stores {m.group(1)} B, spill loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
    return out


# the instances of the redesigned kernels that the paths launch, each by the
# name printed for it and the piece of its mangled name that picks it out:
# NMS, kernels 2 and 4 (the forward template <S, Rule>) at s = 2, and the
# table and tile kernels (template <Rule, kSplit, kTileW, kGroups>) of kernel
# 3, in each cluster size the path picks, and of kernel 5
PATH_INSTANCES = {
    "nms": {"nms_mask_kernel": "15nms_mask_kernelE",
            "nms_reduce_kernel": "17nms_reduce_kernelE"},
    "roi_align_fwd": {"roi_align_fwd_kernel<2, ResidentTaps>":
                      "20roi_align_fwd_kernelILi2ENS_12ResidentTapsEEE"},
    "roi_align_stream_fwd": {"roi_align_fwd_kernel<2, StreamTaps>":
                             "20roi_align_fwd_kernelILi2ENS_10StreamTapsEEE"},
    "roi_align_bwd": {
        "roi_table_kernel<ResidentTaps>": "16roi_table_kernelINS_12ResidentTapsEE",
        **{f"roi_align_tile_bwd_kernel<ResidentTaps, 8, 8, {g}>":
           f"25roi_align_tile_bwd_kernelINS_12ResidentTapsELi8ELi8ELi{g}EE" for g in (1, 2, 4)},
    },
    "roi_align_stream_bwd": {
        "roi_table_kernel<StreamTaps>": "16roi_table_kernelINS_10StreamTapsEE",
        "roi_align_tile_bwd_kernel<StreamTaps, 4, 8, 1>":
            "25roi_align_tile_bwd_kernelINS_10StreamTapsELi4ELi8ELi1EE",
    },
}


def path_ptxas(summaries: dict) -> dict:
    """{kernel: {instance: its ptxas summary}} for PATH_INSTANCES; raises
    when an instance matches no kernel, or several, of the ptxas logs."""
    out = {}
    for kernel, instances in PATH_INSTANCES.items():
        out[kernel] = {}
        for name, piece in instances.items():
            found = [v for k, v in summaries.items() if piece in k]
            if len(found) != 1:
                raise AssertionError(f"ptxas log: {len(found)} kernels match {name} ({piece})")
            out[kernel][name] = found[0]
    return out


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

    libraries = (nms_mod.library, roi_mod.library, stream_mod.library)
    t0 = time.monotonic()
    build_all(libraries)
    log(f"[build] {len(libraries)} libraries in {time.monotonic() - t0:.1f} s (parallel nvcc); "
        f"launchers: " + ", ".join(f"{k.function} ({k.library.source.name})" for k in KERNELS.values()))
    for lib in libraries:
        secs = lib.build_seconds
        log(f"  {lib.source.name}: {secs if secs is None else round(secs, 1)} s")
        for line in lib.ptxas_log.splitlines():
            if "ptxas info" in line or "spill" in line:
                log(f"    {line.strip()}")

    # the kernels redesigned since the first port, as the paths launch them
    redesigned = path_ptxas({k: v for lib in libraries for k, v in ptxas_summary(lib).items()})
    log("[build] redesigned kernels, registers and spills: "
        + "; ".join(f"{k}: {v}" for d in redesigned.values() for k, v in d.items()))

    nms_diff, bwd_diff, stream_diff = MaskDiff(), BwdDiff(), StreamDiff()
    log("[nms] kernel vs plain, synthetic")
    nms_synthetic(nms_diff, dev)
    log("[roi_align] forward kernel vs plain, synthetic")
    roi_err = roi_synthetic(dev)
    log("[roi_align_bwd] backward kernel vs plain, synthetic")
    roi_bwd_synthetic(bwd_diff, dev)
    log("[roi_align_stream] streamed forward and backward kernels vs plain, synthetic P2/P3")
    stream_synthetic(stream_diff, dev)
    log(f"[roi_align s={RUNTIME_S}] the run-time sample-ratio instances vs plain, synthetic")
    s5_err, s5_bwd, s5_stream = runtime_s_synthetic(dev)

    cfg = generate_config("resnet", "PascalVOC")
    log(f"[main path] serving: ResNet-{cfg.network.depth} C4, {cfg.dataset.NUM_CLASSES} classes, "
        f"buckets {cfg.SHAPE_BUCKETS}, {cfg.TEST.RPN_PRE_NMS_TOP_N}->{cfg.TEST.RPN_POST_NMS_TOP_N} "
        f"proposals, device postprocess")
    cap, serve_launches, predictor, image = main_path(cfg, dev)
    log("[main path] serving kernels vs plain on the captured tensors")
    roi_err = max(roi_err, hold_captured(nms_diff, cap, bwd_diff, stream_diff))

    t = cfg.TRAIN
    log(f"[train] ResNet-{cfg.network.depth} C4, {cfg.dataset.NUM_CLASSES} classes, BATCH_IMAGES "
        f"{t.BATCH_IMAGES}, BATCH_ROIS {t.BATCH_ROIS}, {t.RPN_PRE_NMS_TOP_N}->{t.RPN_POST_NMS_TOP_N} "
        f"proposals, {TRAIN_STEPS} steps of fit on synthetic 480x640 images")
    train_cap, launches, model, roidb, train_stats, c4_weights, _ = train_path(
        cfg, dev, TRAINED_GROUPS, C4_LAUNCHES_PER_STEP)
    log("[train] kernels vs plain on the captured tensors")
    roi_err = max(roi_err, hold_captured(nms_diff, train_cap, bwd_diff, stream_diff))
    log("[train] full-width gradient vs finite differences of the loss")
    train_stats["fd_worst"] = gradient_matches_finite_differences(
        model, cfg, roidb, dev, TRAINED_GROUPS)

    fcfg = generate_config("resnet_fpn", "PascalVOC")
    ft, fn = fcfg.TRAIN, fcfg.network
    log(f"[fpn train] ResNet-{fn.depth} FPN ({fn.FPN_CHANNELS} channels, strides "
        f"{fn.FPN_FEAT_STRIDES}, pooled {fn.POOLED_SIZE}), {fcfg.dataset.NUM_CLASSES} classes, "
        f"BATCH_ROIS {ft.BATCH_ROIS}, {ft.RPN_PRE_NMS_TOP_N}->{ft.RPN_POST_NMS_TOP_N} proposals, "
        f"{TRAIN_STEPS} steps of fit on synthetic 480x640 images")
    fpn_cap, fpn_launches, fpn_model, fpn_roidb, fpn_stats, fpn_weights, _ = train_path(
        fcfg, dev, FPN_TRAINED_GROUPS, FPN_LAUNCHES_PER_STEP)
    log("[fpn train] kernels vs plain on the captured tensors")
    roi_err = max(roi_err, hold_captured(nms_diff, fpn_cap, bwd_diff, stream_diff))
    log("[fpn train] full-width gradient vs finite differences of the loss")
    fpn_stats["fd_worst"] = gradient_matches_finite_differences(
        fpn_model, fcfg, fpn_roidb, dev, FPN_TRAINED_GROUPS)

    mcfg = generate_config("mask_resnet_fpn", "coco")
    mt, mn = mcfg.TRAIN, mcfg.network
    nfg = int(round(mt.FG_FRACTION * mt.BATCH_ROIS))
    log(f"[mask train] Mask R-CNN ResNet-{mn.depth} FPN ({mn.FPN_CHANNELS} channels, pooled "
        f"{mn.POOLED_SIZE}, 28x28 mask head), {mcfg.dataset.NUM_CLASSES} classes, buckets "
        f"{mcfg.SHAPE_BUCKETS}, BATCH_ROIS {mt.BATCH_ROIS} of which the mask branch's {nfg}, "
        f"{mt.RPN_PRE_NMS_TOP_N}->{mt.RPN_POST_NMS_TOP_N} proposals, MASK_SIZE {mt.MASK_SIZE}, "
        f"MASK_GT_SIZE {mt.MASK_GT_SIZE}, {TRAIN_STEPS} steps of fit on {MASK_TRAIN_IMAGES} "
        f"synthetic 480x640 polygon images and their flipped copies (load_gt_roidb)")
    _, mask_roidb = load_gt_roidb(mcfg, flip=True, synthetic_size=MASK_TRAIN_IMAGES)
    mtrain_cap, mask_launches, mask_model, mask_roidb, mask_stats, mask_train_weights, \
        mask_state = train_path(mcfg, dev, MASK_TRAINED_GROUPS, MASK_LAUNCHES_PER_STEP,
                                roidb=mask_roidb, keep=4)
    log("[checkpoint] Mask R-CNN: the [mask train] run's final state saved, then loaded into a "
        "freshly built model and optimizer")
    mask_ckpt = state_round_trip(mcfg, mask_state, dev)
    del mask_state
    log("[mask train] kernels vs plain on the captured tensors (the first step's calls of both "
        "branches)")
    if not all(any(e[1].shape[1] == nfg for e in calls) for calls in (
            mtrain_cap.roi, mtrain_cap.roi_bwd, mtrain_cap.stream, mtrain_cap.stream_bwd)):
        raise AssertionError("a ROIAlign kernel's mask-branch call was not captured")
    roi_err = max(roi_err, hold_captured(nms_diff, mtrain_cap, bwd_diff, stream_diff))
    log("[mask train] full-width gradient vs finite differences of the loss")
    mask_stats["fd_worst"] = gradient_matches_finite_differences(
        mask_model, mcfg, mask_roidb, dev, MASK_FD_GROUPS)
    n_syncs, sync_lines = host_syncs_per_step(mask_model, mask_train_weights, mcfg, mask_roidb,
                                              dev, 1)
    top = sorted(sync_lines.items(), key=lambda kv: -kv[1])[:6]
    log(f"[mask train] host syncs in one step at aux_interval 1: {n_syncs}; by line {top}")
    mask_stats["host_syncs"] = {"count": n_syncs, "top": top}
    if n_syncs != HOST_SYNCS_PER_STEP:
        raise AssertionError(f"a Mask R-CNN step at aux_interval 1 synchronised the host "
                             f"{n_syncs} times, not {HOST_SYNCS_PER_STEP}: {top}")

    nproc, affinity = os.cpu_count(), len(os.sched_getaffinity(0))
    workers = assembly_workers_for(affinity)
    log(f"[pipeline] nproc {nproc} (this process may run on {affinity}); the card CLI run's "
        f"assembly workers N = {workers}; cuDNN deterministic, no autotuning; {TRAIN_STEPS} "
        f"steps a run on {PIPELINE_IMAGES} synthetic 480x640 images, from the calibrated "
        f"weights each path's [train] run started from")
    cudnn_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        pipeline_stats = {"nproc": nproc, "affinity": affinity, "assembly_workers": workers}
        log("[pipeline] C4")
        pipeline_stats["C4"] = pipeline_phase("C4", cfg, c4_weights, dev, C4_LAUNCHES_PER_STEP,
                                              workers)
        log("[pipeline] FPN")
        pipeline_stats["FPN"] = pipeline_phase("FPN", fcfg, fpn_weights, dev,
                                               FPN_LAUNCHES_PER_STEP, workers)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags

    log(f"[checkpoint] ResNet-{cfg.network.depth} C4 at full width from the calibrated weights "
        f"the [train] run started from, cuDNN deterministic: {CHECKPOINT_IMAGES} synthetic "
        f"480x640 images, batch 1, 2 epochs of fit with checkpoints (golden), a run stopped by "
        f"SIGTERM mid epoch 2, its resume; tools/test.py on the dumps")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        checkpoint_stats = checkpoint_phase(cfg, c4_weights, dev)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    checkpoint_stats["mask"] = mask_ckpt

    dump = (cfg.TEST.PROPOSAL_PRE_NMS_TOP_N, cfg.TEST.PROPOSAL_POST_NMS_TOP_N)
    log(f"[alternate] ResNet-{cfg.network.depth} C4 four-stage alternate training at full width: "
        f"{ALT_IMAGES} synthetic 480x640 images and their flipped copies, {ALT_STEPS} steps of "
        f"fit a training stage, proposal passes at {dump[0]}->{dump[1]} (IoU "
        f"{cfg.TEST.PROPOSAL_NMS}), Fast R-CNN batches padded to "
        f"{cfg.TRAIN.RPN_POST_NMS_TOP_N} proposals; the calibrated [train] weights as the donor")
    alt_cap, alt_stats, rcnn1_model, prop_roidb = alternate_phase(cfg, c4_weights, dev)
    log("[alternate] kernels vs plain on the captured tensors (every proposal pass's NMS, the "
        "first Fast R-CNN steps' ROIAlign)")
    if not alt_cap.nms or any((tuple(c[0].shape), c[3]) != ((1, dump[0], 4), dump[1])
                              for c in alt_cap.nms):
        raise AssertionError(f"the proposal passes' NMS calls are not 1 x {dump[0]} -> {dump[1]}: "
                             f"{[(tuple(c[0].shape), c[3]) for c in alt_cap.nms]}")
    roi_err = max(roi_err, hold_captured(nms_diff, alt_cap, bwd_diff, stream_diff))
    log("[alternate] full-width Fast R-CNN-1 gradient vs finite differences of the loss")
    alt_stats["fd_worst"] = gradient_matches_finite_differences(
        rcnn1_model, cfg, prop_roidb, dev, FAST_RCNN_GROUPS)
    del rcnn1_model, prop_roidb
    ft = fcfg.TRAIN
    log(f"[frozen fpn] ResNet-{fcfg.network.depth} FPN frozen-proposal training at full width: "
        f"the [fpn train] weights' own proposals over {ALT_IMAGES} synthetic 480x640 images "
        f"({fcfg.TEST.PROPOSAL_PRE_NMS_TOP_N}->{fcfg.TEST.PROPOSAL_POST_NMS_TOP_N}), "
        f"{FROZEN_STEPS} steps of fit with proposal_count {ft.RPN_POST_NMS_TOP_N}")
    frozen_cap, frozen_launches, frozen_stats = frozen_fpn_phase(fcfg, fpn_weights, dev)
    log("[frozen fpn] kernels vs plain on the captured tensors")
    roi_err = max(roi_err, hold_captured(nms_diff, frozen_cap, bwd_diff, stream_diff))
    del frozen_cap

    te = cfg.TEST
    log(f"[eval] ResNet-{cfg.network.depth} C4 pred_eval from the calibrated weights the [train] "
        f"run started from: {EVAL_IMAGES} synthetic {EVAL_HW[0]}x{EVAL_HW[1]} images, "
        f"{cfg.dataset.NUM_CLASSES} classes, buckets {cfg.SHAPE_BUCKETS}, "
        f"{te.RPN_PRE_NMS_TOP_N}->{te.RPN_POST_NMS_TOP_N} proposals, UINT8_TRANSFER "
        f"{te.UINT8_TRANSFER}, MAX_PER_IMAGE {te.MAX_PER_IMAGE}; assembly workers N = {workers}")
    eval_stats, eval_cap, eval_launches = eval_phase(cfg, c4_weights, dev, workers)
    log("[eval] kernels vs plain on the captured tensors")
    roi_err = max(roi_err, hold_captured(nms_diff, eval_cap, bwd_diff, stream_diff))

    fpn_cfg = generate_config("resnet_fpn", "coco")
    mask_cfg = generate_config("mask_resnet_fpn", "coco")
    for name, c in (("fpn serve", fpn_cfg), ("mask serve", mask_cfg)):
        n, t = c.network, c.TEST
        log(f"[{name}] ResNet-{n.depth} FPN{' Mask R-CNN' if n.USE_MASK else ''} "
            f"({n.FPN_CHANNELS} channels, pooled {n.POOLED_SIZE}"
            f"{', 28x28 mask head, device canvas paste' if n.USE_MASK else ''}), "
            f"{c.dataset.NUM_CLASSES} classes, buckets {c.SHAPE_BUCKETS}, "
            f"{t.RPN_PRE_NMS_TOP_N}->{t.RPN_POST_NMS_TOP_N} proposals, MAX_PER_IMAGE "
            f"{t.MAX_PER_IMAGE}: six synthetic COCO-like requests {REQUEST_HW} and a batch of 2")
        if name == "fpn serve":
            fpn_serve_cap, fpn_serve_launches, fpn_serve_stats, *_ = infer_serve_phase(
                "FPN serving", c, dev, FPN_SERVE_LAUNCHES)
            cap_in = fpn_serve_cap
        else:
            mask_cap, mask_serve_launches, mask_serve_stats, _, _, mask_weights = \
                infer_serve_phase("Mask R-CNN serving", c, dev, MASK_SERVE_LAUNCHES)
            cap_in = mask_cap
        log(f"[{name}] kernels vs plain on the captured tensors")
        roi_err = max(roi_err, hold_captured(nms_diff, cap_in, bwd_diff, stream_diff))
    log(f"[mask eval] Mask R-CNN pred_eval from the calibrated serving weights: "
        f"{MASK_EVAL_IMAGES} synthetic {MASK_EVAL_HW[0]}x{MASK_EVAL_HW[1]} masked images, "
        f"{COCO_CLASSES} classes, serial and the JAX defaults, box mAP and the COCO segm stats")
    mask_eval_stats = mask_eval_phase(mask_cfg, mask_weights, dev)

    log("[timing] serving shapes, on the batch-of-2 call's captured tensors")
    serve_nms = nms_timing([c for c in cap.nms if c[3] > 0][-1], "proposals")
    classes = nms_timing([c for c in cap.nms if c[3] == 0][-1], "classes")
    serve_roi = roi_fwd_timing(cap.roi[-1], "serving")
    log("[timing] C4 train shapes, on the train steps' captured tensors")
    train_nms = nms_timing(train_cap.nms[-1], "train proposals")
    train_roi = roi_fwd_timing(train_cap.roi[-1], "train")
    train_bwd = roi_bwd_timing(train_cap.roi_bwd[-1], "train")
    log("[timing] FPN train shapes, on the FPN steps' captured tensors")
    fpn_nms = nms_timing(fpn_cap.nms[-1], "FPN union of the levels' top-k")
    p2, p3 = at_scale(fpn_cap.stream, 0.25), at_scale(fpn_cap.stream, 0.125)
    p2_bwd, p3_bwd = at_scale(fpn_cap.stream_bwd, 0.25), at_scale(fpn_cap.stream_bwd, 0.125)
    stream_p2, stream_p3 = stream_fwd_timing(p2, "P2"), stream_fwd_timing(p3, "P3")
    stream_bwd_p2 = stream_bwd_timing(p2_bwd, "P2")
    stream_bwd_p3 = stream_bwd_timing(p3_bwd, "P3")
    fpn_roi = roi_fwd_timing(at_scale(fpn_cap.roi, 1.0 / 16), "FPN P4")
    fpn_bwd = roi_bwd_timing(at_scale(fpn_cap.roi_bwd, 1.0 / 16), "FPN P4")
    log(f"[timing] Mask R-CNN train shapes, on the mask branch's captured tensors (R = {nfg})")

    def mask_branch(entries, scale):
        return at_scale([e for e in entries if e[1].shape[1] == nfg], scale)

    mtrain = {
        "stream_fwd": {f"p{lv}": stream_fwd_timing(mask_branch(mtrain_cap.stream, 0.5 ** lv),
                                                   f"mask branch P{lv}") for lv in (2, 3)},
        "stream_bwd": {f"p{lv}": stream_bwd_timing(mask_branch(mtrain_cap.stream_bwd, 0.5 ** lv),
                                                   f"mask branch P{lv}") for lv in (2, 3)},
        "roi_fwd": {f"p{lv}": roi_fwd_timing(mask_branch(mtrain_cap.roi, 0.5 ** lv),
                                             f"mask branch P{lv}") for lv in (4, 5)},
        "roi_bwd": {f"p{lv}": roi_bwd_timing(mask_branch(mtrain_cap.roi_bwd, 0.5 ** lv),
                                             f"mask branch P{lv}") for lv in (4, 5)},
    }
    log("[timing] the resident kernels 2 and 3 on the same P2 tensors, and kernel 2 on P3's "
        "(the other tap rule)")
    resident_p2 = roi_fwd_timing(p2 + (None,), "P2, resident kernel 2")
    resident_bwd_p2 = roi_bwd_timing(p2_bwd + (None,), "P2, resident kernel 3")
    resident_p3 = roi_fwd_timing(p3 + (None,), "P3, resident kernel 2")
    log(f"  P2: streamed forward {stream_p2['ms']:.4f} ms vs resident {resident_p2['ms']:.4f} ms; "
        f"streamed backward {stream_bwd_p2['ms']:.4f} ms vs resident {resident_bwd_p2['ms']:.4f} ms; "
        f"P3: streamed forward {stream_p3['ms']:.4f} ms vs resident {resident_p3['ms']:.4f} ms")

    log("[timing] FPN and Mask R-CNN serving shapes, on the batch-of-2 calls' captured tensors")
    fpn_union = nms_timing([c for c in fpn_serve_cap.nms if c[2] == fpn_cfg.TEST.RPN_NMS_THRESH][-1],
                           "FPN serving union of the levels' top-k")
    fpn_classes = nms_timing([c for c in fpn_serve_cap.nms if c[2] == fpn_cfg.TEST.NMS][-1],
                             "FPN serving classes")
    fpn_serve_roi = {f"p{lv}": roi_fwd_timing(at_scale(fpn_serve_cap.roi, 0.5 ** lv),
                                              f"FPN serving P{lv}") for lv in (2, 3, 4, 5)}
    mask_roi = roi_fwd_timing(at_scale(mask_cap.roi, 0.25), "Mask R-CNN mask branch P2")
    log("[timing] the proposal dump's NMS (1 x 20000 -> 2000) and Fast R-CNN's kernels 2 and 3, "
        "on the [alternate] run's captured tensors")
    dump_nms = nms_timing(alt_cap.nms[-1], "proposal dump")
    alt_roi = roi_fwd_timing(alt_cap.roi[-1], "Fast R-CNN train")
    alt_bwd = roi_bwd_timing(alt_cap.roi_bwd[-1], "Fast R-CNN train")
    del fpn_serve_cap, mask_cap, cap_in, mtrain_cap, alt_cap

    log("[profile] where one request's device time goes")
    profile_request(predictor, cfg, image)
    log("[profile] where one C4 train step's device time goes")
    train_stats["profile"] = profile_train_step(model, cfg, roidb, dev)
    log("[profile] where one FPN train step's device time goes")
    fpn_stats["profile"] = profile_train_step(fpn_model, fcfg, fpn_roidb, dev)
    log("[profile] where one Mask R-CNN train step's device time goes, and its mask branch's")
    mask_stats["profile"] = profile_train_step(mask_model, mcfg, mask_roidb, dev)
    mask_stats["branch"] = mask_branch_profile(mask_model, mcfg, mask_roidb, dev)
    for label, st in (("C4", train_stats), ("FPN", fpn_stats), ("Mask R-CNN", mask_stats)):
        busy = st["profile"].get("busy_ms")
        if busy:
            st["idle"] = 1 - busy / st["step_ms_median"]
            log(f"[profile] {label}: step median {st['step_ms_median']:.3f} ms beside one "
                f"profiled step's device busy {busy:.3f} ms: idle {100 * st['idle']:.1f}%")

    log("[reference] small request, card vs CPU")
    small_request_agrees(cfg, dev)
    log("[fpn serve reference] small FPN request, card vs CPU")
    small_request_agrees(fpn_cfg, dev, COCO_CLASSES)
    # at ResNet-50 depth: the calibrated random ResNet-101 carries the card's
    # and the CPU's rounding apart until the proposals reorder (rois 148 px
    # apart at equal validity on the H100, PERF.md §6)
    log("[mask serve reference] small Mask R-CNN request (ResNet-50 depth), card vs CPU")
    small_request_agrees(mask_cfg.replace(network=dataclasses.replace(mask_cfg.network, depth=50)),
                         dev, COCO_CLASSES)
    log("[train reference] small train steps, card vs CPU")
    argmax_takes_the_first_maximum(dev)
    train_step_agrees(dev, small_c4_cfg(), [[10.0, 10.0, 70.0, 70.0, 1.0],
                                            [60.0, 60.0, 120.0, 110.0, 2.0]], "C4")
    log("[fpn train reference] small FPN train step, card vs CPU")
    train_step_agrees(dev, small_fpn_cfg(), [[10.0, 10.0, 70.0, 70.0, 1.0],
                                             [50.0, 60.0, 120.0, 110.0, 2.0]], "FPN")
    log("[mask train reference] small Mask R-CNN train step (ResNet-50 depth, polygon gt "
        "masks), card vs CPU")
    train_step_agrees(dev, small_mask_cfg(), [[10.0, 10.0, 70.0, 70.0, 1.0],
                                              [50.0, 60.0, 120.0, 110.0, 2.0]], "Mask R-CNN")
    log("[alternate reference] small RPNOnly and Fast R-CNN train steps (ResNet-50 depth), card "
        "vs CPU")
    for cls in (RPNOnly, FastRCNN):
        train_step_agrees(dev, small_c4_cfg(), [[10.0, 10.0, 70.0, 70.0, 1.0],
                                                [60.0, 60.0, 120.0, 110.0, 2.0]],
                          cls.__name__, cls=cls)
    log("[eval reference] small eval, card vs CPU")
    small_eval_agrees(dev)

    log(f"[train] stats {json.dumps(train_stats)}")
    log(f"[fpn train] stats {json.dumps(fpn_stats)}")
    log(f"[mask train] stats {json.dumps(mask_stats)}")
    log(f"[pipeline] stats {json.dumps(pipeline_stats)}")
    log(f"[checkpoint] stats {json.dumps(checkpoint_stats)}")
    log(f"[alternate] stats {json.dumps(alt_stats)}")
    log(f"[frozen fpn] stats {json.dumps(frozen_stats)}")
    log(f"[eval] stats {json.dumps(eval_stats)}")
    log(f"[fpn serve] stats {json.dumps(fpn_serve_stats)}")
    log(f"[mask serve] stats {json.dumps(mask_serve_stats)}")
    log(f"[mask eval] stats {json.dumps(mask_eval_stats)}")
    log(f"[done] {time.monotonic() - t_start:.1f} s; by phase {phase_seconds(time.monotonic())}")
    def infer_launches(kernel):
        return {"fpn_serve_launches": fpn_serve_launches[kernel],
                "mask_serve_launches": mask_serve_launches[kernel],
                "mask_eval_launches": mask_eval_stats["launches"][kernel],
                "mask_train_launches": mask_launches[kernel]}

    stages = alt_stats["stages"]

    def alt_launches(kernel):
        """The [alternate] and [frozen fpn] runs' launches of a kernel."""
        return {"alternate_test_rpn_launches": sum(stages[n]["launches"][kernel]
                                                   for n in ("test_rpn1", "test_rpn2")),
                "alternate_rpn_launches": sum(stages[n]["launches"][kernel]
                                              for n in ("rpn1", "rpn2")),
                "alternate_fast_rcnn_launches": sum(stages[n]["launches"][kernel]
                                                    for n in ("rcnn1", "rcnn2")),
                "frozen_fpn_launches": frozen_launches[kernel]}

    def mask_train_timing(kernel):
        return {k: v for lv, e in mtrain[kernel].items()
                for k, v in _prefixed(f"mask_train_{lv}", e).items()}

    print(json.dumps({"kernels": [
        {
            "name": "nms", "route": "cuda", "source": "mx_rcnn_tpu_torch/csrc/nms.cu",
            "replaces": "mx_rcnn_tpu/ops/pallas/nms.py:40", "design": "PR 4",
            "ptxas": redesigned["nms"],
            "launches": launches["nms"], "fpn_launches": fpn_launches["nms"],
            "eval_launches": eval_launches["nms"],
            "serve_launches": serve_launches["nms"],
            **infer_launches("nms"),
            "max_abs_err": nms_diff.max_abs_err, "mismatches": nms_diff.mismatches,
            **train_nms, "library_ms": None,
            **_prefixed("serve", serve_nms), **_prefixed("class", classes),
            **_prefixed("fpn", fpn_nms), **_prefixed("fpn_serve_union", fpn_union),
            **_prefixed("fpn_serve_classes", fpn_classes),
            **alt_launches("nms"), **_prefixed("proposal_dump", dump_nms),
        },
        {
            "name": "roi_align_fwd", "route": "cuda", "source": "mx_rcnn_tpu_torch/csrc/roi_align.cu",
            "replaces": "mx_rcnn_tpu/ops/pallas/roi_align.py:88", "design": "PR 5",
            "ptxas": redesigned["roi_align_fwd"],
            "launches": launches["roi_align_fwd"], "fpn_launches": fpn_launches["roi_align_fwd"],
            "eval_launches": eval_launches["roi_align_fwd"],
            "serve_launches": serve_launches["roi_align_fwd"],
            **infer_launches("roi_align_fwd"),
            "max_abs_err": roi_err, f"s{RUNTIME_S}_max_abs_err": s5_err, **train_roi,
            "library_ms": None, **_prefixed("serve", serve_roi), **_prefixed("fpn_p4", fpn_roi),
            **_prefixed("p2", resident_p2), **_prefixed("p3", resident_p3),
            **{k: v for lv, e in fpn_serve_roi.items() for k, v in
               _prefixed(f"fpn_serve_{lv}", e).items()},
            **_prefixed("mask_serve_p2", mask_roi), **mask_train_timing("roi_fwd"),
            **alt_launches("roi_align_fwd"), **_prefixed("fast_rcnn", alt_roi),
        },
        {
            "name": "roi_align_bwd", "route": "cuda", "source": "mx_rcnn_tpu_torch/csrc/roi_align.cu",
            "replaces": "mx_rcnn_tpu/ops/pallas/roi_align.py:148", "design": "PR 5",
            "ptxas": redesigned["roi_align_bwd"],
            "launches": launches["roi_align_bwd"], "fpn_launches": fpn_launches["roi_align_bwd"],
            "eval_launches": eval_launches["roi_align_bwd"], **infer_launches("roi_align_bwd"),
            "max_abs_err": bwd_diff.max_abs_err, "scaled_err": bwd_diff.scaled_err,
            "bitwise_repeatable": bwd_diff.repeatable,
            f"s{RUNTIME_S}_scaled_err": s5_bwd.scaled_err,
            f"s{RUNTIME_S}_bitwise_repeatable": s5_bwd.repeatable,
            **train_bwd, "library_ms": None,
            **_prefixed("fpn_p4", fpn_bwd), **_prefixed("p2", resident_bwd_p2),
            **mask_train_timing("roi_bwd"),
            **alt_launches("roi_align_bwd"), **_prefixed("fast_rcnn", alt_bwd),
        },
        {
            "name": "roi_align_stream_fwd", "route": "cuda",
            "source": "mx_rcnn_tpu_torch/csrc/roi_align_stream.cu",
            "replaces": "mx_rcnn_tpu/ops/pallas/roi_align_stream.py:100", "design": "PR 6",
            "ptxas": redesigned["roi_align_stream_fwd"],
            "launches": fpn_launches["roi_align_stream_fwd"],
            "eval_launches": eval_launches["roi_align_stream_fwd"], **infer_launches("roi_align_stream_fwd"),
            "max_abs_err": stream_diff.fwd_err, f"s{RUNTIME_S}_max_abs_err": s5_stream.fwd_err,
            **stream_p2, "library_ms": None,
            **_prefixed("p3", stream_p3), **mask_train_timing("stream_fwd"),
            **alt_launches("roi_align_stream_fwd"),
        },
        {
            "name": "roi_align_stream_bwd", "route": "cuda",
            "source": "mx_rcnn_tpu_torch/csrc/roi_align_stream.cu",
            "replaces": "mx_rcnn_tpu/ops/pallas/roi_align_stream.py:164", "design": "PR 4",
            "ptxas": redesigned["roi_align_stream_bwd"],
            "launches": fpn_launches["roi_align_stream_bwd"],
            "eval_launches": eval_launches["roi_align_stream_bwd"], **infer_launches("roi_align_stream_bwd"),
            "max_abs_err": stream_diff.bwd_err, "scaled_err": stream_diff.bwd_scaled,
            "bitwise_repeatable": stream_diff.repeatable,
            f"s{RUNTIME_S}_scaled_err": s5_stream.bwd_scaled,
            f"s{RUNTIME_S}_bitwise_repeatable": s5_stream.repeatable,
            **stream_bwd_p2, "library_ms": None,
            **_prefixed("p3", stream_bwd_p3), **mask_train_timing("stream_bwd"),
            **alt_launches("roi_align_stream_bwd"),
        },
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
