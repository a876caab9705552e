#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit, torch's name and
   device count) and turns TF32 off for convolutions and matmuls
   (``utils/precision.py::full_float32``, as every entry point of the port);
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
   must match the gradient within 1e-2, read at the largest of seven halved
   steps at which no ReLU input changes sign from the base point, or, where
   every step changes some, as the smallest of the seven readings; one step of each is profiled
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
8. ``[eval]``: ``pred_eval`` over 16 synthetic VOC-sized (375 × 500) images
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
   ``pred_eval`` of the mask model over 16 synthetic 480 × 640 masked
   images, serial and the JAX package's defaults, which must give
   bit-identical detections and RLEs and equal box mAP and segm stats;
   images/s.  A small request of each runs on the card and on the CPU and
   the two must agree;
9b. ``[bf16]``: ``COMPUTE_DTYPE="bfloat16"`` with ``FOLD_BN`` (the JAX
   package's ``bench.py`` configuration) at full width: the bf16 instances
   of kernels 2–5 against their plain versions on synthetic bf16 tensors
   (the forward within one bf16 ulp beyond the float32 bar; the backward's
   float32-epilogue instance at the scaled float32 bar, the path's bf16
   dfeat its round-to-nearest-even bit for bit, each bit-identical across
   two launches) and on every bf16 path's captured tensors; the backwards
   of bf16 maps profiled: their table and stage kernels only, no cast after
   them; C4 serving of the
   six requests and a batch of 2 on the calibrated ``[train]`` weights (NMS
   twice and kernel 2's bf16 instance once a forward, the detections
   matched to the float32 port's by nearest box); C4 training through
   ``train_end2end --compute_dtype bfloat16`` (FOLD_BN from the config):
   10 steps at batch 1 on ``[train]``'s images and 6 at BATCH_IMAGES 8 on 16
   images (NMS and kernels 2/3's bf16 instances once a step); 10 Mask
   R-CNN steps (kernels 2–5 bf16 four times a step) and six mask requests
   (kernel 2 bf16 eight times a forward); every float32 ROIAlign counter 0
   and the float32-epilogue counters 0 on these paths; the loss gates;
   each trained group's bf16 gradient
   against the float32 step's on the same weights, batch and rois
   (relative L2 ≤ 0.25 on JAX's exact-rewrite weights, printed on the
   calibrated ones); FOLD_BN in float32 against the unfolded graph at JAX's
   exact-rewrite bars; the CUDA kernels a step launches with the fold off
   and on;
9c. ``[images]``: real JPEG files at full width on the calibrated C4
   weights: each committed fixture (``tests/fixtures/jpeg/``) decoded by
   the port with the SHA-256 of its RGB bytes held to the manifest's, which
   ``cv2.imread`` produced; the host decode's median ms (the 4:2:0 baseline
   375 × 500 fixture and the largest); the first calls of the host NMS, the
   RLE encode and the JPEG decode from 8 threads at once into a fresh build
   directory (every thread on the C libraries, one file built per library,
   no temporary left); on a Pascal VOC tree of the fixtures written here,
   ``tools/test.py --vis`` in the threads mode with 2 completion workers
   (mAP a gate, images/s printed, NMS twice and kernel 2 once an image,
   every ``det_%06d.png`` read back to the overlay drawn from the dumped
   detections), ``tools/train_end2end.py`` for 2 steps on the files and
   their flips with assembly processes that decode and build the decoder
   themselves (NMS and kernels 2 and 3 once a step), and ``tools/demo.py``
   on one fixture (``demo_out.png`` read back to its overlay);
9d. ``[vgg]``: VGG-16 (``generate_config("vgg", "PascalVOC")``: 13 convs,
   7 × 7 ROIPooling at stride 16, fc6 / fc7 at 4096, 21 classes) at full
   width on seeded weights calibrated on the 8 training images (every conv
   and fc6 / fc7 to unit output scale: no BN): 10 steps of ``fit`` (the
   loss gates, conv1 / conv2 bitwise frozen, finite differences through
   ROIPooling's backward, one profiled step), the six requests and a batch
   of 2, ``pred_eval`` on 8 images, a bf16 request and 4 bf16 steps of
   ``train_end2end --compute_dtype bfloat16``, the alternate schedule at 2
   steps a stage with ``tools/test.py --params final.pkl --synthetic 8``;
   every run launches NMS as reckoned (1 a step, 2 a forward, 1 an image
   of a proposal pass) and kernels 2–5 never, and pools once a step or
   forward.  ROIPooling (``ops/roi_pool.py``, plain PyTorch: the JAX
   package leaves it to XLA) on the captured serving, train and bf16
   calls, card vs CPU: the forward bit for bit, the backward within
   1e-6 of the largest sum of a cell's |terms|; its ms beside a bytes
   bound (the cells its rois cover and its output); a small request and a
   small step card vs CPU;
9e. ``[serve]``: the online serving stack (``serve/engine.py::ServingEngine``
   over ``serve/runner.py::ServeRunner``) at full-width ResNet-101 C4
   (608 × 1024 / 1024 × 608 buckets, max_batch 4, 21 classes, 6000 → 300)
   with three families in one registry, one a precision rung (float32
   on JAX's exact-rewrite weights; bf16 + FOLD_BN and int8 weights on
   ``gate_weights``, where the gate can hold): warmup makes one signature
   a rung and passes the bf16 and int8 parity gates, which refuse the
   bf16 rung with its box regression perturbed.  On ``gate_weights`` the
   gate and the responses' check cannot fail a wrong reduced forward (the
   image moves a box by ~0.05 px, scores are the class bias's), so
   ``reduced_rungs_hold`` runs each reduced slot on the exact-rewrite
   weights and holds its raw heads at batch 4 against batch 1 at bars set
   from the card's readings, which another image and neighbouring rois
   fail; 48
   VOC-sized requests of ``run_load`` (concurrency 8, every family, lanes
   50/50, max_queue 4) in two runs, the first with a mid-load
   ``admin("swap default <dump>")`` to the epoch dump of a one-step
   ``tools/train_end2end.py`` run, then one request past its deadline and
   one ``QueueFull`` (the float32 slot held until the queue fills), the
   second profiled; every response held against ``detect_single`` of its
   family and version on the card (nearest box of its class: float32 and
   int8 at the ``[eval]`` bars, bf16 at the gate's), the float32 ones
   before the swap to v1 and after it to v2; no new signature after
   warmup; NMS twice and kernel 2 (its bf16 instance on the bf16 family)
   once a forward; then three Mask R-CNN requests through ``mask_rles_for``
   (device canvas, batch of 1, cuDNN deterministic) whose detections and
   RLEs equal those of ``detect_single`` + ``eval/segm.py::canvas_rles`` on
   the same weights; printed with the card: p50 / p99 latency, images/s,
   fetch bytes a batch, the device-busy share of the profiled run;
9f. ``[dp]``: data parallel (``parallel/``) at full-width ResNet-101 C4 from
   the calibrated ``[train]`` weights under cuDNN's deterministic mode:
   (a) 3 DP steps (``make_parallel_train_step``) at world size 1 over NCCL
   in this process, bit-identical (state and losses) to 3 ``train_step``s on
   the same batches, NMS and kernels 2 and 3 once a step; (b) two rank
   processes on the card over gloo (``parallel/dist_smoke.py::run_case``),
   one image each of 2-image batches with per-image ``sample_seeds``, 4
   steps: the ranks' states bit-identical after every step, the momentum
   after step 1 within ``DP_STEP1_BAR`` (relative L2 by leaf) of one rank on
   the 2-image batch while a sum-reduced (x2) step must exceed it, each
   rank's launches; (c) ``train_end2end --elastic`` as two ``--dist_*``
   ranks with a ``--prefix`` each and ``device_lost@2.1:2`` (8 images, 4
   steps an epoch, 2 epochs, ``--lr 1e-5``): 1 shrink, 1 regrow at the epoch
   boundary, the window's replays, a committed emergency dump, the
   survivor's degraded epoch dump bit-identical to one rank restored from
   the emergency dump over the same batches' kept rows, both ranks equal at
   the end with the same final loss, only rank 0's prefix written; (d) its
   ``--resume`` for a third epoch as two ``--dist_*`` processes: both at
   rank 0's dump, the same final loss and state; printed with the
   card: the DP and plain step medians, the all-reduce's ms and bytes a
   step at world 2, the elastic ``recovery_s``, the peak MiB a rank;
9g. ``[gate]``: the JAX package's five ``make integration-gate`` runs
   through the port's ``tools/integration_gate.py::run_gate`` on the card at
   its flags (128 × 128 synthetic images, seeded random weights, cuDNN's
   deterministic mode): ResNet-50 C4 (400 steps, lr 2e-3, mAP ≥ 0.8),
   ResNet-50 FPN (1200 steps, lr 5e-4, ≥ 0.5), Mask R-CNN FPN (the same,
   min(mAP, segm AP50) ≥ 0.3), VGG-16 (lr 1e-3, ≥ 0.5) and C4 ``--dp 8``
   (eight rank processes sharing the card over gloo, 200 steps, ≥ 0.5);
   each must reach its target (the C4 line, whose target the JAX package's
   own run misses, at least that run's 0.7040: ``REFERENCE_MISSES``)
   and launch NMS, and all but VGG's (ROIPooling) kernels 2 and 3 (a
   ``--dp`` run's count sums its ranks'); the C4 gate at bf16 + FOLD_BN (the
   bench configuration) runs too and is printed;
9h. ``[tools]`` (run first of the paths, after the synthetic kernel
   checks): ``tools/profile_step.py`` at full width (bf16 and
   float32 rows, ``--ablate`` at batch 8: every row's wall ms and device ms
   finite and > 0, NMS and kernels 2 and 3 (their bf16 instances on the
   bf16 rows) launched), ``tools/bench_eval.py`` (the device postprocess
   and ``--host_path`` at full width, and ``--data_plane``, whose serial and
   overlapped detections must be byte-identical) and
   ``tools/check_data.py --smoke`` on a VOC tree of the JPEG fixtures;
10. times each kernel on captured tensors (the bf16 instances on the
   ``[bf16]`` paths' tensors, the bf16 backwards also at batch 8 and on the
   mask branch's R = 32 calls, kernel 2's bf16 instance also on the bf16
   Mask R-CNN serving forward's eight calls, each bf16 forward's launch plan
   held to its Python twin; ``--save-bwd-cases FILE`` and
   ``--save-fwd-cases FILE`` save those calls for ``tools/kernel_bench.py
   --cases``): NMS and kernel 2 at the serving
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
   bound (the five float32 kernels and the four bf16 instances), then the
   ``nvidia-smi`` line, then the device line last.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import importlib
import json
import math
import os
import pickle
import re
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings
import zlib
from pathlib import Path

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.checkpoint import (
    DATA_FILE,
    is_committed,
    latest_checkpoint,
    load_checkpoint,
    read_manifest,
    restorable_checkpoints,
    save_checkpoint,
    tree_checksum,
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
from mx_rcnn_tpu_torch.data.image import load_image
from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.data.loader import (
    TestLoader,
    TrainLoader,
    _orientation_bucket,
    build_test_batch,
    load_record_image,
    make_batch,
)
from mx_rcnn_tpu_torch.data.masks import polygons_to_box_frame
from mx_rcnn_tpu_torch.data.pascal_voc import CLASSES as VOC_CLASS_NAMES
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset, shape_polygon
from mx_rcnn_tpu_torch.eval.segm import paste_mask_canvas, rles_for_detections
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.models import faster_rcnn as fr_mod
from mx_rcnn_tpu_torch.models import fpn as fpn_mod
from mx_rcnn_tpu_torch.models import stage_models as stage_mod
from mx_rcnn_tpu_torch.models.faster_rcnn import sampling_uniforms
from mx_rcnn_tpu_torch.models.fpn import mask_bce
from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm, normalize_images
from mx_rcnn_tpu_torch.models.stage_models import FastRCNN, RPNOnly
from mx_rcnn_tpu_torch.models.vgg import VGGBackbone
from mx_rcnn_tpu_torch.native import hostops
from mx_rcnn_tpu_torch.native import jpeg as jpeg_mod
from mx_rcnn_tpu_torch.native import rle as rle_mod
from mx_rcnn_tpu_torch.native.jpeg import decode_jpeg
from mx_rcnn_tpu_torch.ops import nms as nms_mod
from mx_rcnn_tpu_torch.ops import roi_align as roi_mod
from mx_rcnn_tpu_torch.ops import roi_align_stream as stream_mod
from mx_rcnn_tpu_torch.ops import roi_pool as roi_pool_mod
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess
from mx_rcnn_tpu_torch.parallel import distributed
from mx_rcnn_tpu_torch.parallel.dist_smoke import free_port, run_case
from mx_rcnn_tpu_torch.parallel.mesh import (
    make_mesh,
    make_parallel_train_step,
    take_replica_rows,
)
from mx_rcnn_tpu_torch.serve.buckets import BucketLadder
from mx_rcnn_tpu_torch.serve import runner as runner_mod
from mx_rcnn_tpu_torch.serve.runner import cap_detections, detect_single, prepare_request
from mx_rcnn_tpu_torch.tools import bench_eval as bench_eval_mod
from mx_rcnn_tpu_torch.tools import check_data as check_data_mod
from mx_rcnn_tpu_torch.tools import integration_gate as gate_mod
from mx_rcnn_tpu_torch.tools import profile_step as profile_mod
from mx_rcnn_tpu_torch.tools import test as test_cli
from mx_rcnn_tpu_torch.tools import test_rpn as test_rpn_mod
from mx_rcnn_tpu_torch.tools import train_alternate as alt_mod
from mx_rcnn_tpu_torch.tools.kernel_bench import fpn_union, graph_ms
from mx_rcnn_tpu_torch.utils import faults
from mx_rcnn_tpu_torch.utils.bridge import _leaves as tree_leaves
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, torch_to_flax
from mx_rcnn_tpu_torch.utils.combine_model import load_params, save_params
from mx_rcnn_tpu_torch.utils.cuda_build import build_all
from mx_rcnn_tpu_torch.utils.load_data import attach_proposals, get_imdb, load_gt_roidb
from mx_rcnn_tpu_torch.utils.precision import full_float32
from mx_rcnn_tpu_torch.utils.run_meta import load_run_meta, save_run_meta
from mx_rcnn_tpu_torch.utils.visualize import draw_detections

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
# the finite-difference steps, as the share of the loss each moves it by:
# halvings from 1e-3; at the last one float32 rounding alone reads ~1e-3,
# so no smaller step resolves the bar
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
    and the output, each at its dtype's size (bf16 maps and outputs: 2
    bytes an element).  ``keep`` (B, R): the rois that pool at all (the
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
    nbytes = (cells * c * feat.element_size() + out.numel() * out.element_size()
              + (rois.numel() + (0 if valid_hw is None else valid_hw.numel())) * 4)
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


def bf16_epilogue_holds(run, got):
    """For a bf16 g: the path's bf16 dfeat, two launches of it, is the
    round-to-nearest-even of the float32 epilogue's ``got`` bit for bit
    (True for a float32 g: one instance, no rounding)."""
    if got.dtype != torch.float32 or run is None:
        return True
    path, again = run(), run()
    return path.dtype == torch.bfloat16 and torch.equal(path, again) and torch.equal(
        path, got.bfloat16())


class BwdDiff:
    """Running comparison of kernel 3 with its plain version: the max |Δ|,
    and the max of |Δ| / max(1, Σ|terms|), Σ|terms| being the plain backward
    of |g| (the weights are ≥ 0), which the bar holds to ROI_BWD_TOL; and
    whether two launches gave bit-identical dfeat (they must: no atomics).
    A bf16 g is held through the float32 epilogue of its instance, and the
    path's bf16 dfeat must be that float32 sum rounded to nearest even, bit
    for bit (``rounded``)."""

    def __init__(self):
        self.max_abs_err, self.scaled_err, self.repeatable, self.rounded = 0.0, 0.0, True, True

    def add(self, g, rois, shape, pooled, scale, s, valid_hw, label):
        bf16 = g.dtype == torch.bfloat16
        got = roi_mod._roi_align_bwd_cuda(g, rois, shape, pooled, scale, s, valid_hw, bf16)
        again = roi_mod._roi_align_bwd_cuda(g, rois, shape, pooled, scale, s, valid_hw, bf16)
        rounded = bf16_epilogue_holds(bf16 and (lambda: roi_mod._roi_align_bwd_cuda(
            g, rois, shape, pooled, scale, s, valid_hw)) or None, got)
        ref = roi_mod.roi_align_bwd_plain(g, rois, shape, pooled, scale, s, valid_hw)
        mag = roi_mod.roi_align_bwd_plain(g.abs(), rois, shape, pooled, scale, s, valid_hw)
        d = (got - ref).abs()
        err, scaled = float(d.max()), float((d / mag.clamp_min(1.0)).max())
        same = torch.equal(got, again)
        self.max_abs_err = max(self.max_abs_err, err)
        self.scaled_err = max(self.scaled_err, scaled)
        self.repeatable &= same
        self.rounded &= rounded
        log(f"  roi_align_bwd {label}: g={tuple(g.shape)} -> {tuple(shape)} max|d|={err:.3g} "
            f"max|d|/max(1,sum|terms|)={scaled:.3g} max|plain|={float(ref.abs().max()):.3g} "
            f"two launches bit-identical={same}"
            + (f", bf16 dfeat the RNE of the float32 epilogue={rounded}" if bf16 else ""))
        if not scaled <= ROI_BWD_TOL or not same or not rounded:
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
        self.rounded = True

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
        bf16 = g.dtype == torch.bfloat16
        got = stream_mod._roi_align_stream_bwd_cuda(g, rois, shape, pooled, scale, s, bf16)
        again = stream_mod._roi_align_stream_bwd_cuda(g, rois, shape, pooled, scale, s, bf16)
        rounded = bf16_epilogue_holds(bf16 and (lambda: stream_mod._roi_align_stream_bwd_cuda(
            g, rois, shape, pooled, scale, s)) or None, got)
        ref = stream_mod.roi_align_stream_bwd_plain(g, rois, shape, pooled, scale, s)
        mag = stream_mod.roi_align_stream_bwd_plain(g.abs(), rois, shape, pooled, scale, s)
        d = (got - ref).abs()
        err, scaled = float(d.max()), float((d / mag.clamp_min(1.0)).max())
        same = torch.equal(got, again)
        self.bwd_err, self.bwd_scaled = max(self.bwd_err, err), max(self.bwd_scaled, scaled)
        self.repeatable &= same
        self.rounded &= rounded
        log(f"  roi_align_stream_bwd {label}: g={tuple(g.shape)} -> {tuple(shape)} max|d|={err:.3g} "
            f"max|d|/max(1,sum|terms|)={scaled:.3g} max|plain|={float(ref.abs().max()):.3g} "
            f"two launches bit-identical={same}"
            + (f", bf16 dfeat the RNE of the float32 epilogue={rounded}" if bf16 else ""))
        if not scaled <= ROI_BWD_TOL or not same or not rounded:
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


def bare_model(cfg, cls=None):
    """The config's graph (``build_model``, or the stage graph ``cls``)
    without its seeded init, for weights that replace every tensor (seconds
    of host time at ResNet-101, more at VGG-16's fc6)."""
    skip = (lambda *a, **k: None)
    saved = [(m, m.init_weights) for m in (fr_mod, fpn_mod, stage_mod)]
    for m, _ in saved:
        m.init_weights = skip
    try:
        return build_model(cfg) if cls is None else cls(cfg)
    finally:
        for m, fn in saved:
            m.init_weights = fn


def loaded_model(cfg, weights, cls=None):
    """:func:`bare_model` holding ``weights``, a calibrated run's
    ``state_dict``."""
    model = bare_model(cfg, cls)
    model.load_state_dict(weights)
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
    # the bf16 instances of kernels 2-5, each with its own count
    "roi_align_fwd_bf16": roi_mod.kernel_bf16, "roi_align_bwd_bf16": roi_mod.bwd_kernel_bf16,
    "roi_align_stream_fwd_bf16": stream_mod.fwd_kernel_bf16,
    "roi_align_stream_bwd_bf16": stream_mod.bwd_kernel_bf16,
    # the bf16 backwards' float32 epilogues: gate aids, 0 on every path
    "roi_align_bwd_bf16_f32": roi_mod.bwd_kernel_bf16_f32,
    "roi_align_stream_bwd_bf16_f32": stream_mod.bwd_kernel_bf16_f32,
}
# a count of every kernel, all 0: the base of each path's reckoning
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches():
    for k in KERNELS.values():
        k.launches = 0
    ROI_POOL.reset()


def read_launches():
    ROI_POOL.read()
    return {name: k.launches for name, k in KERNELS.items()}


def path_kernels(cfg) -> tuple:
    """The kernels a single-level forward of ``cfg``'s model launches: NMS,
    and under ROI_MODE 'roi_align' kernel 2 of the compute dtype.
    ROIPooling (VGG-16) is plain PyTorch and launches none."""
    if cfg.network.ROI_MODE != "roi_align":
        return ("nms",)
    return ("nms", "roi_align_fwd_bf16" if cfg.network.COMPUTE_DTYPE == "bfloat16"
            else "roi_align_fwd")


class RoiPoolCalls:
    """Counts the model's ROIPooling calls (``ops/roi_pool.py``, plain
    PyTorch: no kernel of its own) beside the kernels' launch counts:
    ``reset_launches`` zeroes it and ``read_launches`` notes it in ``last``,
    so a path's window reads it as it reads the kernels.  While installed
    (``with``) it wraps the name ``ops/roi_align.py`` calls and keeps the
    inputs of the first call of each kind and dtype: a differentiated call
    (train), a forward with ``valid_hw`` over 2 images (a serving batch of
    2), any other."""

    def __init__(self):
        self.n, self.last, self.calls = 0, 0, {}
        self._orig = roi_mod.roi_pool

    def reset(self):
        self.n = 0

    def read(self):
        self.last = self.n

    def __enter__(self):
        orig = self._orig

        def rec(feat, rois, pooled, spatial_scale, valid_hw=None):
            self.n += 1
            kind = ("train" if feat.requires_grad else
                    "serve" if valid_hw is not None and feat.shape[0] == 2 else "other")
            key = f"{kind}_{str(feat.dtype).split('.')[-1]}"
            if key not in self.calls:
                self.calls[key] = (feat.detach().clone(), rois.clone(), tuple(pooled),
                                   spatial_scale, None if valid_hw is None else valid_hw.clone())
            return orig(feat, rois, pooled, spatial_scale, valid_hw)

        roi_mod.roi_pool = rec
        return self

    def __exit__(self, *exc):
        roi_mod.roi_pool = self._orig
        return False


ROI_POOL = RoiPoolCalls()


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
    """Bytes the backward must move (g at its dtype's size, the rois,
    valid_hw read once, the whole dfeat, of g's dtype, written once) and
    its flops."""
    nbytes = ((g.numel() + int(np.prod(shape))) * g.element_size()
              + (rois.numel() + (0 if valid_hw is None else valid_hw.numel())) * 4)
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
C4_LAUNCHES_PER_STEP = dict(NO_LAUNCHES, nms=1, roi_align_fwd=1, roi_align_bwd=1)
FPN_LAUNCHES_PER_STEP = dict(NO_LAUNCHES, nms=1, roi_align_fwd=2, roi_align_bwd=2,
                             roi_align_stream_fwd=2, roi_align_stream_bwd=2)
# Mask R-CNN pools through each route twice, the box branch's BATCH_ROIS rois
# and the mask branch's first FG_FRACTION·BATCH_ROIS slots, each with its
# backward
MASK_TRAINED_GROUPS = FPN_TRAINED_GROUPS + ("mask_head",)
MASK_LAUNCHES_PER_STEP = dict(NO_LAUNCHES, nms=1, roi_align_fwd=4, roi_align_bwd=4,
                              roi_align_stream_fwd=4, roi_align_stream_bwd=4)
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
    its 2-fc head and the mask head's layers (none in C4), and every conv of
    VGG-16 (no BN at all) and its fc6 / fc7, so that its
    output has unit standard deviation on ``batch``: layer by layer in
    forward order, one forward each (LSUV, Mishkin & Matas 2016).  ``calibrate_bn`` gives the
    backbone unit-scale activations; without this the random neck and head
    leave the pooled features and the head's outputs far above unit scale,
    each clipped SGD step moves the 50176-input ``fc1`` outputs by far more
    than their scale, and the losses run away within a few steps."""
    vgg = isinstance(getattr(model, "backbone", None), VGGBackbone)
    layers = [(n, m) for n, m in model.named_modules()
              if n.startswith(("neck.", "mask_head.")) or (vgg and n.startswith("backbone.conv"))
              or n in ("top_head.fc1", "top_head.fc2", "top_head.fc6", "top_head.fc7")]
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


class ReluPattern:
    """The sign pattern (input > 0) of every ReLU a forward runs, in call
    order: the models call ``F.relu`` and ``torch.relu``, both patched while
    the context is open.  Without ``base`` it records the pattern; with it,
    it counts the activations whose sign differs from ``base``'s."""

    def __init__(self, base=None):
        self.base, self.signs, self.flips = base, [], None
        self._orig = (torch.nn.functional.relu, torch.relu)

    def __enter__(self):
        orig = self._orig[1]

        def rec(x, inplace=False):
            sign = x.detach() > 0
            if self.base is None:
                self.signs.append(sign)
            else:
                n = (sign != self.base[len(self.signs)]).sum()
                self.signs.append(None)
                self.flips = n if self.flips is None else self.flips + n
            return orig(x)

        torch.nn.functional.relu = torch.relu = rec
        return self

    def __exit__(self, *exc):
        torch.nn.functional.relu, torch.relu = self._orig
        return False

    def count(self) -> int:
        if self.base is not None and len(self.signs) != len(self.base):
            raise AssertionError(f"{len(self.signs)} ReLUs ran, the base point ran "
                                 f"{len(self.base)}")
        return 0 if self.flips is None else int(self.flips)


def gradient_matches_finite_differences(model, cfg, roidb, dev, groups):
    """The full-width backward against the forward on the card: for each
    trained group, the loss's central difference along the group's gradient,
    f(θ + εd) − f(θ − εd) with d = g/‖g‖, must equal gᵀ(θ₊ − θ₋) (the
    displacement as rounded into the f32 weights) within FD_TOL.  The
    samplers' draws are fixed (one rng and seed) and the first forward's
    sampled rois are reused, so the loss is a function of the weights alone,
    smooth but for the ReLU switches.  The sign of every ReLU's input is
    recorded at the base point (``ReluPattern``); ε moves the loss by 1e-3 of
    itself, then by half that, down to FD_STEPS[-1], and the first (largest)
    step at which both f(θ ± εd) keep the recorded pattern gives the one
    reading held to the bar: there the loss is linear in the weights but
    for float32 rounding.  A group whose pattern changes at every step, down
    to the smallest one that float32 resolves the loss's difference at,
    is held to the smallest of the readings, and says so.  The
    backbone takes its gradient through the ROIAlign backward kernels almost
    wholly, since the RPN's output layers are scaled by 1e-3."""
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
        with ReluPattern() as base:
            loss = loss_fn()
        loss.backward()
        f0 = float(loss.detach())
        worst, rules = 0.0, {}
        with torch.no_grad():
            for grp in groups:
                ps = [p for n, p in model.named_parameters()
                      if n.startswith(grp + ".") and p.grad is not None]
                gs = [p.grad.clone() for p in ps]
                p0 = [p.clone() for p in ps]
                gnorm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in gs))
                if not gnorm > 0:
                    raise AssertionError(f"{grp} has no gradient")
                rels = []
                for step in FD_STEPS:
                    eps = step * abs(f0) / gnorm
                    f, moved, flips = {}, {}, 0
                    for sign in (1.0, -1.0):
                        for p, a, g in zip(ps, p0, gs):
                            p.copy_(a + (sign * eps / gnorm) * g)
                        moved[sign] = [p.clone() for p in ps]
                        with ReluPattern(base.signs) as pat:
                            f[sign] = float(loss_fn())
                        flips += pat.count()
                    for p, a in zip(ps, p0):
                        p.copy_(a)
                    want = sum(float((g.double() * (hi.double() - lo.double())).sum())
                               for g, hi, lo in zip(gs, moved[1.0], moved[-1.0]))
                    got = f[1.0] - f[-1.0]
                    rels.append(abs(got - want) / abs(want))
                    log(f"  {grp}: |g| {gnorm:.4g}, eps {eps:.3g}, f(+)-f(-) {got:.6g}, "
                        f"g.(p+ - p-) {want:.6g}, relative difference {rels[-1]:.3g}, ReLU "
                        f"signs changed {flips}")
                    if flips == 0:
                        rules[grp] = {"step": step, "reading": rels[-1], "rule": "kept pattern"}
                        break
                else:
                    rules[grp] = {"step": None, "reading": min(rels), "rule": "smallest of seven"}
                    log(f"  {grp}: ReLU signs change at every step down to {FD_STEPS[-1]:.3g} of "
                        f"the loss, below which float32 does not resolve f(+) - f(-) to the bar; "
                        f"held: the smallest of the {len(rels)} readings")
                worst = max(worst, rules[grp]["reading"])
    finally:
        model_mod.sample_rois = orig
        for p in model.parameters():
            p.grad = None
    log(f"  loss {f0:.6f}; {len(base.signs)} ReLUs at the base point; held readings "
        f"{ {g: (r['rule'], r['step'], round(r['reading'], 6)) for g, r in rules.items()} }; "
        f"worst {worst:.3g} (bar {FD_TOL})")
    if not worst <= FD_TOL:
        raise AssertionError("the full-width gradient disagrees with the loss's finite differences")
    return {"worst": worst, "groups": rules}


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
    if isinstance(model.backbone, VGGBackbone):
        # no BN: unit output scales on this image, as the [vgg] phase calibrates;
        # uncalibrated on [0, 1) pixels, the random RPN's scores are flat to
        # float32 rounding and the card and the CPU order the proposals apart
        calibrate_scales(model, {"images": images, "im_info": im_info, "gt_boxes": gt,
                                 "gt_valid": gt_valid, "sample_seeds": [0], **masks})

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


def stage_train_checks(name, rec, per_step, steps=ALT_STEPS) -> dict:
    """A training stage's gates, after its line is logged: it dispatched
    ``steps`` steps and launched ``per_step`` a step; finite losses, none
    above 100× the first step's.  Returns its step statistics."""
    out = rec["fit"]
    hist = out["history"]
    want = {k: n * out["dispatched_steps"] for k, n in per_step.items()}
    losses = [h["loss"] for h in hist]
    growth = max(losses) / losses[0] if losses and losses[0] > 0 else math.inf
    timed = [h["step_ms"] for h in hist[min(TRAIN_WARMUP, len(hist) - 1):]]
    worst = max(hist, key=lambda h: h["loss"]) if hist else {}
    log(f"  {name}: losses {[round(v, 5) for v in losses]} (largest / first {growth:.3f}), "
        f"the largest step's aux "
        f"{ {k: round(v, 5) for k, v in worst.items() if k not in ('index', 'wait_ms')} }, "
        f"step median {statistics.median(timed) if timed else math.nan:.3f} ms after "
        f"{len(hist) - len(timed)} warm-up, launches {rec['launches']}")
    if rec["launches"] != want or out["dispatched_steps"] != steps or len(hist) != steps:
        raise AssertionError(f"{name} dispatched {out['dispatched_steps']} steps, ran "
                             f"{len(hist)} and launched {rec['launches']}, not {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite losses {losses}")
    if not growth <= LOSS_GROWTH_MAX:
        raise AssertionError(f"{name}: the loss grew {growth:.3g}x")
    return {"losses": losses, "growth": growth, "step_ms": timed,
            "step_ms_median": statistics.median(timed), "launches": rec["launches"],
            "dispatched_steps": out["dispatched_steps"]}


def alternate_phase(cfg, weights, dev, steps=ALT_STEPS, per_stage=STAGE_LAUNCHES_PER_STEP):
    """The four-stage schedule (``tools/train_alternate.py::
    alternate_train``) at full width: ResNet-101 C4 (or VGG-16), ALT_IMAGES synthetic
    480 × 640 images and their flipped copies, ``steps`` steps of ``fit`` a
    training stage, from the calibrated weights the ``[train]`` run started
    from (its BN moments from ``calibration_batch`` on these images) as the
    donor of stages 1 and 3; then ``tools/test.py --params final.pkl`` with
    the run's per-class statistics.  Gates: each stage's launches
    (``per_stage``: for C4 RPN stages none, Fast R-CNN kernel 2 once a step
    and kernel 3 once a step of stage 3 (:data:`STAGE_LAUNCHES_PER_STEP`);
    VGG-16's ROIPooling launches none), each proposal
    pass one NMS an image, losses, the frozen leaves of every stage bitwise
    its donor's, the final backbone bitwise RPN-2's, the evaluation's
    launches and statistics.  Returns the captured kernel inputs, the
    stats, and Fast R-CNN-1's tree and proposal roidb for the finite
    differences."""
    roidb = SyntheticDataset(num_images=ALT_IMAGES, image_size=(480, 640)).gt_roidb()
    donor = torch_to_flax(loaded_model(cfg, weights))
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_alt_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Capture(keep=2) as cap, StageRecorder() as rec:
        alt_mod.alternate_train(cfg, roidb, epochs_rpn=1, epochs_rcnn=1, pretrained_donor=donor,
                                out_dir=out_dir, max_steps=steps, device=dev, frequent=steps)
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
            st = stage_train_checks(name, r, per_stage[name], steps)
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
               if p[0] == "backbone" and p[-1] == "kernel"
               and not is_frozen_path(p, net.FIXED_PARAMS)):
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
            ["--network", cfg.network.name, "--dataset", "PascalVOC", "--synthetic", "8",
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
    want = dict(NO_LAUNCHES, **{k: 16 if k == "nms" else 8 for k in path_kernels(cfg)})
    if eval_launches != want:
        raise AssertionError(f"tools/test.py launched {eval_launches}, not {want}")
    stats["eval"] = {"mAP": results["mAP"], "seconds": eval_s, "launches": eval_launches}
    log(f"  the schedule {seconds:.1f} s; max_memory_allocated {peak_mib:.1f} MiB")

    props1 = load_params(os.path.join(out_dir, "proposals1.pkl"))
    prop_roidb = IMDB.append_flipped_images(attach_proposals(roidb, props1))
    shutil.rmtree(out_dir, ignore_errors=True)
    return cap, stats, trees["rcnn1"], prop_roidb


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
EVAL_IMAGES = 16
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
    if min(launches[k] for k in path_kernels(cfg)) <= 0:
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
    # two passes, the second in reverse order: one pass of the images per
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
MASK_EVAL_IMAGES = 16
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


def infer_serve_phase(label, cfg, dev, per_forward, weights=None):
    """Serve the six REQUEST_HW synthetic COCO-like requests (both buckets)
    and a same-bucket batch of 2 through the FPN, Mask R-CNN or VGG-16 model
    at full width, from seeded weights calibrated on the first request (BN moments
    and unit scales from one inference forward).  A box model serves with
    ``detect_single``; a mask model through the Predictor with the canvas
    paste, ``detections_from_output``, the cap and ``rles_for_detections``.
    Gates: the launches of the run (reset just before, read just after) are
    ``per_forward`` × 7 forwards, finite detections of the right shapes, and
    for the mask model every device canvas of the batch bitwise equal to
    ``paste_mask_canvas``.  Given ``weights`` (a calibrated run's), the model
    holds them and is not calibrated again (a bf16 model with folded BN
    cannot be: its BN layers do not run).  Returns (capture, launches,
    figures, predictor, one request image, the calibrated weights)."""
    mask = cfg.network.USE_MASK
    num_classes = cfg.dataset.NUM_CLASSES
    images = masked_images(REQUEST_HW)
    ladder = BucketLadder(cfg.SHAPE_BUCKETS)
    reqs = [prepare_request(im, cfg, ladder) for im in images]
    buckets = sorted({r.bucket for r in reqs})
    if len(buckets) != 2:
        raise AssertionError(f"requests must cover both buckets, got {buckets}")
    if weights is None:
        model = make_model(cfg)
        calib = batch_to_device({"images": reqs[0].image[None], "im_info": reqs[0].im_info[None]},
                                dev)
        calibrate_bn(model, calib)
        calibrate_scales(model, calib)
        weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    else:
        model = loaded_model(cfg, weights)
    te = cfg.TEST
    pp = make_test_postprocess(cfg, num_classes, te.SCORE_THRESH, te.DET_PER_CLASS, paste=mask)
    predictor = Predictor(model, pp, device=dev)

    def serve(im):
        if mask:
            return serve_masks(predictor, im, cfg)[0]
        return detect_single(predictor, im, cfg, num_classes)

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
    if out["det_boxes"].shape != (2, num_classes - 1, te.DET_PER_CLASS, 4):
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


# ---------------------------------------------------------- images phase
FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "jpeg"
DECODE_REPS = 30
IMAGES_TRAIN_STEPS = 2
FIRST_USE_THREADS = 8
# pred_eval's overlay threshold (tools/test.py has no flag for it), and the
# demo's: it logs a line for each detection at or above its threshold
VIS_THRESH = 0.7
DEMO_VIS_THRESH = 0.5
# a library file hostops.build_library installs: ``<source stem>-<16 hex>.so``
BUILT_NAME = re.compile(r"[a-z]+-[0-9a-f]{16}\.so")


def read_png(path) -> np.ndarray:
    """The (H, W, 3) uint8 pixels of an 8-bit RGB PNG whose rows all use
    filter 0, as ``utils/visualize.py::save_image`` writes them (the
    script's own reader: no image library is installed)."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: no PNG signature")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos: pos + 8])
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8: pos + 8 + n])
        elif kind == b"IDAT":
            idat += data[pos + 8: pos + 8 + n]
        pos += 12 + n
    w, h, depth, color = header[:4]
    if (depth, color) != (8, 2):
        raise AssertionError(f"{path}: bit depth {depth}, colour type {color}, not 8-bit RGB")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise AssertionError(f"{path}: a row with a filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def decode_fixtures(smi: str) -> dict:
    """Every fixture decoded by the port, its RGB bytes' SHA-256 held to
    the manifest's (cv2's decode); the host decode's median ms for the
    4:2:0 baseline 375 x 500 fixture and the largest one."""
    manifest = json.loads((FIXTURES / "manifest.json").read_text())["files"]
    for e in manifest:
        got = decode_jpeg((FIXTURES / e["name"]).read_bytes(), e["name"])
        digest = hashlib.sha256(got.tobytes()).hexdigest()
        log(f"  {e['name']}: {e['sampling']} {e['mode']}, restart {e['restart_interval']}, "
            f"orientation {e['orientation']}: {got.shape} sha256 {digest[:16]}.. "
            f"{'==' if digest == e['sha256'] else '!='} cv2's")
        if digest != e["sha256"] or list(got.shape) != e["shape"]:
            raise AssertionError(f"{e['name']}: the port's decode differs from cv2's")
    baseline = next(e for e in manifest if e["sampling"] == "4:2:0" and e["mode"] == "baseline"
                    and e["shape"][:2] == [375, 500])
    largest = max(manifest, key=lambda e: e["shape"][0] * e["shape"][1])
    figures = {}
    for label, e in (("baseline_420_375x500", baseline), ("largest", largest)):
        data = (FIXTURES / e["name"]).read_bytes()
        times = []
        for _ in range(DECODE_REPS):
            t0 = time.perf_counter()
            decode_jpeg(data)
            times.append((time.perf_counter() - t0) * 1e3)
        figures[label] = {"name": e["name"], "shape": e["shape"],
                          "median_ms": statistics.median(times), "min_ms": min(times)}
        log(f"  host decode {e['name']} {e['shape'][1]}x{e['shape'][0]} ({e['sampling']} "
            f"{e['mode']}): median {figures[label]['median_ms']:.3f} ms, min "
            f"{figures[label]['min_ms']:.3f} ms over {DECODE_REPS} ({smi})")
    return figures


def first_use_in_threads() -> dict:
    """Point the host libraries' builds at a fresh directory, forget the
    loaded ones, and make the first calls of the NMS, the RLE encode and
    the JPEG decode from FIRST_USE_THREADS threads at once: every thread
    must get the C libraries, one file built per library, no temporary
    left."""
    build = Path(tempfile.mkdtemp(prefix="native_build_"))
    saved = hostops.BUILD_DIR
    hostops.BUILD_DIR = build
    for mod in (hostops, rle_mod):
        mod._LIB, mod._TRIED = None, False
    jpeg_mod._LIB = None
    dets = np.array([[0, 0, 10, 10, 0.9], [1, 1, 11, 11, 0.8], [50, 50, 60, 60, 0.7]], np.float32)
    mask = np.zeros((6, 5), np.uint8)
    mask[1:4, 2:4] = 1
    fixture = str(FIXTURES / "voc_420_baseline.jpg")
    calls = (lambda: hostops.nms_host(dets, 0.5), lambda: rle_mod.encode(mask)["counts"],
             lambda: float(load_image(fixture).sum()))
    barrier = threading.Barrier(FIRST_USE_THREADS)
    results, errors = [None] * FIRST_USE_THREADS, []

    def work(i):
        barrier.wait()
        try:
            # each thread makes all three first calls, starting at another one
            out = [None] * 3
            for k in range(3):
                j = (i + k) % 3
                out[j] = calls[j]()
            results[i] = out
        except Exception as e:  # noqa: BLE001 — every failure fails the phase below
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=work, args=(i,)) for i in range(FIRST_USE_THREADS)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a first-use thread did not finish in 300 s")
        built = sorted(os.listdir(build))
    finally:
        hostops.BUILD_DIR = saved
        shutil.rmtree(build, ignore_errors=True)
    secs = time.perf_counter() - t0
    backends = {"hostops": hostops.backend(), "rle": rle_mod.backend(),
                "jpeg": "c" if jpeg_mod._LIB is not None else "none"}
    log(f"  {FIRST_USE_THREADS} threads' first calls in {secs:.2f} s: backends {backends}; "
        f"built {built}; errors {errors}")
    if errors or any(r != results[0] for r in results) or results[0][0] != [0, 2]:
        raise AssertionError(f"first use in threads: errors {errors}, results {results}")
    if set(backends.values()) != {"c"}:
        raise AssertionError(f"a thread's first call did not get the C library: {backends}")
    if ([n.split("-")[0] for n in built] != ["hostops", "jpegdec", "rlelib"]
            or not all(BUILT_NAME.fullmatch(n) for n in built)):
        raise AssertionError(f"first use in threads built {built}, not one file per library")
    return {"threads": FIRST_USE_THREADS, "seconds": secs, "built": built}


def write_voc_fixture_tree(root: Path):
    """``VOCdevkit/VOC2007`` under ``root`` with every fixture JPEG as an
    image of both the test and the trainval split, and an annotation per
    image written here (size from the decoded shape, two objects)."""
    base = root / "VOCdevkit" / "VOC2007"
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (base / d).mkdir(parents=True)
    manifest = json.loads((FIXTURES / "manifest.json").read_text())["files"]
    names = []
    for i, e in enumerate(manifest, 1):
        name = f"{i:06d}"
        names.append(name)
        shutil.copy(FIXTURES / e["name"], base / "JPEGImages" / f"{name}.jpg")
        h, w = e["shape"][:2]
        objects = "".join(
            f"<object><name>{cls}</name><difficult>0</difficult><bndbox><xmin>{x1}</xmin>"
            f"<ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>"
            for cls, (x1, y1, x2, y2) in (
                (VOC_CLASS_NAMES[i], (w // 8, h // 6, w // 2, h // 2)),
                (VOC_CLASS_NAMES[i + 6], (w // 3, h // 3, w - w // 10, h - h // 12))))
        (base / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth>"
            f"</size>{objects}</annotation>")
    for split in ("test", "trainval"):
        (base / "ImageSets" / "Main" / f"{split}.txt").write_text("\n".join(names) + "\n")
    return root / "VOCdevkit", len(names)


def images_phase(cfg, weights, dev, workers, smi) -> dict:
    """``[images]``: real JPEG files through the port's public entry points
    at full width, from the calibrated C4 weights: the fixtures' decode
    against cv2's hashes and its host time, first use of the host C
    libraries from threads, and on a VOC tree of the fixtures
    ``tools/test.py --vis`` (threads mode, completion workers),
    ``tools/train_end2end.py`` for IMAGES_TRAIN_STEPS steps with assembly
    processes that decode and build the decoder themselves, and
    ``tools/demo.py``; the PNGs are read back to the drawn arrays."""
    from mx_rcnn_tpu_torch.tools import demo as demo_mod
    from mx_rcnn_tpu_torch.tools import train_end2end as e2e

    stats = {"decode": decode_fixtures(smi), "first_use": first_use_in_threads()}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        devkit, n_images = write_voc_fixture_tree(tmp)
        tree_cfg = cfg.replace(dataset=dataclasses.replace(
            cfg.dataset, root_path=str(tmp / "root"), dataset_path=str(devkit)))
        params = str(tmp / "c4.pkl")
        save_params(params, torch_to_flax(loaded_model(cfg, weights)))

        # tools/test.py --vis: threads mode, completion workers
        vis, dump = tmp / "vis", str(tmp / "dets.pkl")
        orig_pipelined, orig_pred_eval, orig_cfg = (tester_mod.pipelined, test_cli.pred_eval,
                                                    test_cli.generate_config)
        modes, timed = [], {}

        def threads_mode(*a, **k):
            modes.append("threads")
            return orig_pipelined(*a, **dict(k, mode="threads"))

        def timed_pred_eval(*a, **k):
            t0 = time.perf_counter()
            out = orig_pred_eval(*a, **k)
            timed["seconds"] = time.perf_counter() - t0
            return out

        tester_mod.pipelined, test_cli.pred_eval = threads_mode, timed_pred_eval
        test_cli.generate_config = lambda network, dataset: tree_cfg
        env = os.environ.get("MX_RCNN_POSTPROCESS_WORKERS")
        os.environ["MX_RCNN_POSTPROCESS_WORKERS"] = "2"
        torch.cuda.synchronize()
        reset_launches()
        try:
            results = test_cli.main(["--network", "resnet", "--dataset", "PascalVOC",
                                     "--params", params, "--vis", str(vis), "--dump", dump])
        finally:
            tester_mod.pipelined, test_cli.pred_eval, test_cli.generate_config = (
                orig_pipelined, orig_pred_eval, orig_cfg)
            if env is None:
                os.environ.pop("MX_RCNN_POSTPROCESS_WORKERS")
            else:
                os.environ["MX_RCNN_POSTPROCESS_WORKERS"] = env
        eval_launches = read_launches()
        with open(dump, "rb") as f:
            all_boxes = pickle.load(f)
        imdb = get_imdb(tree_cfg, tree_cfg.dataset.test_image_set)[0]
        drawn = 0
        for i, rec in enumerate(imdb.gt_roidb()):
            dets = {imdb.classes[j]: all_boxes[j][i] for j in range(1, NUM_CLASSES)}
            want = draw_detections(load_record_image(rec), dets, VIS_THRESH)
            got = read_png(vis / f"det_{i:06d}.png")
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"det_{i:06d}.png does not read back to its overlay")
            drawn += sum(int((d[:, 4] >= VIS_THRESH).sum()) for d in dets.values())
        images_per_s = n_images / timed["seconds"]
        want_launches = dict(NO_LAUNCHES, nms=2 * n_images, roi_align_fwd=n_images)
        log(f"  tools/test.py --vis on {n_images} JPEGs (VOC tree; threads mode, 2 completion "
            f"workers): mAP {results['mAP']:.6f}, pred_eval {timed['seconds']:.3f} s = "
            f"{images_per_s:.3f} images/s ({smi}); launches {eval_launches}; {n_images} PNGs "
            f"read back to their overlays ({drawn} boxes at or above {VIS_THRESH})")
        if modes != ["threads"]:
            raise AssertionError(f"the eval loop ran {modes}, not one threads-mode loop")
        if not (math.isfinite(results["mAP"]) and 0.0 <= results["mAP"] <= 1.0):
            raise AssertionError(f"the real-file eval's mAP is {results['mAP']}")
        if eval_launches != want_launches:
            raise AssertionError(f"the real-file eval launched {eval_launches}, not {want_launches}")
        stats["eval"] = {"images": n_images, "mAP": results["mAP"], "seconds": timed["seconds"],
                         "images_per_s": images_per_s, "launches": eval_launches,
                         "boxes_drawn": drawn}

        # train_end2end on the tree's files: the assembly processes decode
        # and build the decoder themselves (none is built where they look)
        for stale in hostops.BUILD_DIR.glob("jpegdec-*.so"):
            stale.unlink()
        saved = (e2e.generate_config, e2e.build_model, e2e.ranks_to_launch)
        e2e.generate_config = lambda network, dataset: tree_cfg
        e2e.build_model = lambda c, generator=None: loaded_model(c, weights)
        # one rank in this process, on a host with more cards too: launched
        # ranks would not see these patches
        e2e.ranks_to_launch = lambda args: 0
        env = os.environ.get("MX_RCNN_ASSEMBLY_WORKERS")
        os.environ["MX_RCNN_ASSEMBLY_WORKERS"] = str(max(2, workers))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        try:
            out = e2e.main(["--network", "resnet", "--dataset", "PascalVOC", "--epochs", "1",
                            "--max_steps", str(IMAGES_TRAIN_STEPS), "--frequent", "1",
                            "--aux_interval", "1", "--prefix", str(tmp / "e2e")])
        finally:
            e2e.generate_config, e2e.build_model, e2e.ranks_to_launch = saved
            if env is None:
                os.environ.pop("MX_RCNN_ASSEMBLY_WORKERS")
            else:
                os.environ["MX_RCNN_ASSEMBLY_WORKERS"] = env
        train_s = time.perf_counter() - t0
        train_launches = read_launches()
        built = sorted(p.name for p in hostops.BUILD_DIR.iterdir())
        losses = out["history"]
        want_launches = {k: n * IMAGES_TRAIN_STEPS for k, n in C4_LAUNCHES_PER_STEP.items()}
        log(f"  train_end2end on the tree's {n_images} JPEGs and their flips, "
            f"{max(2, workers)} assembly processes: {out['steps']} steps in {train_s:.2f} s; "
            f"launches {train_launches}; losses {losses}; native/build after: {built}")
        if out["steps"] != IMAGES_TRAIN_STEPS or train_launches != want_launches:
            raise AssertionError(f"the real-file train run took {out['steps']} steps, launches "
                                 f"{train_launches}, not {want_launches}")
        if not all(math.isfinite(v) for h in losses for v in h.values()):
            raise AssertionError(f"the real-file train run's losses are not finite: {losses}")
        if (sum(n.startswith("jpegdec-") for n in built) != 1
                or not all(BUILT_NAME.fullmatch(n) for n in built)):
            raise AssertionError(f"the assembly processes' builds left {built}")
        stats["train"] = {"steps": out["steps"], "seconds": train_s, "launches": train_launches,
                          "assembly_workers": max(2, workers), "native_build": built}

        # the demo CLI on one fixture
        image = FIXTURES / "voc_420_baseline.jpg"
        demo_out = tmp / "demo_out.png"
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        dets = demo_mod.main(["--image", str(image), "--out", str(demo_out), "--params", params,
                              "--vis_thresh", str(DEMO_VIS_THRESH)])
        demo_s = time.perf_counter() - t0
        demo_launches = read_launches()
        want = draw_detections(load_image(str(image)), dets, DEMO_VIS_THRESH)
        got = read_png(demo_out)
        n_dets = sum(int((d[:, 4] >= DEMO_VIS_THRESH).sum()) for d in dets.values())
        log(f"  tools/demo.py {image.name}: {n_dets} detections at or above {DEMO_VIS_THRESH} in "
            f"{len(dets)} classes, {demo_s:.2f} s; launches {demo_launches}; demo_out.png "
            f"{got.shape} reads back to the overlay: {np.array_equal(got, want)}")
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError("demo_out.png does not read back to the drawn overlay")
        if demo_launches != dict(NO_LAUNCHES, nms=1, roi_align_fwd=1):
            raise AssertionError(f"the demo launched {demo_launches}, not NMS and kernel 2 once")
        stats["demo"] = {"seconds": demo_s, "detections": n_dets, "launches": demo_launches}
    return stats


# ------------------------------------------------------------ bf16 phase
# The bf16 instances of kernels 2-5 against their plain versions: a forward
# within one bf16 ulp of the plain value beyond the float32 forward's bar
# ROI_TOL (both round a float32 sum once: at s = 2 the sums are the same and
# the outputs equal; the run-time instances add in another order than the
# plain mean, and two float32 sums ROI_TOL apart round at most one ulp
# further apart), a backward's float32 dfeat
# (before the wrapper's cast) within the float32 bar ROI_BWD_TOL of the plain
# backward fed the same bf16 cotangent, and bit-identical across launches
BF16_FWD_ULPS = 1.0
# the bf16 train step's gradients against the float32 step's, on the same
# weights, batch and sampled rois: the relative L2 difference of each
# trained group.  JAX's own bf16 graph differs from its float32 one by up to
# 0.125 of a group's norm on the CPU parity tests' shapes (ResNet-50,
# tests/test_torch_bf16.py); the bar is twice that.  The gate and the
# FOLD_BN gate below run on JAX's exact-rewrite weights (``rewrite_weights``):
# on the calibrated weights (unit-scale activations through every random
# layer) a rounding-sized change of the forward moves a deep group's
# gradient far more (the float32 fold against the unfolded graph already
# differs by 1e-2 of stage 2's norm on the CPU at ResNet-50 depth, bf16 by
# ~1 of it), so there both comparisons are printed, not held
BF16_GRAD_TOL = 0.25
# the bf16 C4 requests' detections against the float32 port's on the same
# weights, each matched to the nearest float32 box of its class: the share
# of bf16 detections whose match is within BF16_BOX_PX pixels (every
# coordinate) and BF16_SCORE of its score.  The random classifier's scores
# crowd near the score threshold and the cap, where a bf16 rounding moves a
# detection in or out of the kept set.  Held on the exact-rewrite weights
# (below; ResNet-50 on the CPU: 0.81, the float32 fold 1.0), printed on the
# calibrated ones, whose forward a rounding-sized change moves far more
# (0.57 on the CPU)
BF16_BOX_PX, BF16_SCORE, BF16_MATCHED = 4.0, 0.02, 0.5
# FOLD_BN in float32 against the unfolded graph, JAX's exact-rewrite bars
# (tests/test_model.py:380-389): outputs rtol 2e-3 / atol 1e-4, each
# trained leaf's gradient within 5e-3 of its largest element
FOLD_RTOL, FOLD_ATOL, FOLD_GRAD = 2e-3, 1e-4, 5e-3
BF16_TRAIN_IMAGES_LARGE = 16
BF16_LARGE_BATCH = 8
BF16_LARGE_STEPS = 6
C4_BF16_LAUNCHES_PER_STEP = dict(NO_LAUNCHES, nms=1, roi_align_fwd_bf16=1, roi_align_bwd_bf16=1)
MASK_BF16_LAUNCHES_PER_STEP = dict(NO_LAUNCHES, nms=1, roi_align_fwd_bf16=4,
                                   roi_align_bwd_bf16=4, roi_align_stream_fwd_bf16=4,
                                   roi_align_stream_bwd_bf16=4)
C4_BF16_SERVE_LAUNCHES = {"nms": 2, "roi_align_fwd_bf16": 1}
MASK_BF16_SERVE_LAUNCHES = {"nms": 2, "roi_align_fwd_bf16": 8}


def bf16_cfg(cfg, fold=True):
    """``cfg`` with the bf16 compute dtype and FOLD_BN (the JAX package's
    ``bench.py`` and ``ServeRunner`` bf16 configuration)."""
    return cfg.replace(network=dataclasses.replace(cfg.network, COMPUTE_DTYPE="bfloat16",
                                                   FOLD_BN=fold))


def bf16_ulps(got, ref) -> float:
    """The largest |got − ref| beyond ROI_TOL, in bf16 ulps of the larger
    magnitude."""
    got, ref = got.float(), ref.float()
    mag = torch.maximum(got.abs(), ref.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(torch.finfo(torch.float32).tiny))) - 7)
    return float(((got - ref).abs() - ROI_TOL).clamp_min(0.0).div(ulp).max())


class Bf16FwdDiff:
    """Running comparison of the bf16 forwards (kernels 2 and 4) with their
    plain versions: the largest distance, absolute and in bf16 ulps."""

    def __init__(self):
        self.ulps, self.max_abs_err = 0.0, 0.0

    def add(self, feat, rois, pooled, scale, s, valid_hw, label, stream=False):
        if stream:
            got = stream_mod._roi_align_stream_cuda(feat, rois, pooled, scale, s)
            ref = stream_mod.roi_align_stream_plain(feat, rois, pooled, scale, s)
        else:
            got = roi_mod._roi_align_cuda(feat, rois, pooled, scale, s, valid_hw)
            ref = roi_mod.roi_align_plain(feat, rois, pooled, scale, s, valid_hw)
        if got.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16:
            raise AssertionError(f"a bf16 forward returned {got.dtype} / {ref.dtype} ({label})")
        ulps = bf16_ulps(got, ref)
        self.ulps = max(self.ulps, ulps)
        self.max_abs_err = max(self.max_abs_err, float((got.float() - ref.float()).abs().max()))
        log(f"  {'roi_align_stream' if stream else 'roi_align'} bf16 {label}: "
            f"feat={tuple(feat.shape)} R={rois.shape[1]} pooled={tuple(pooled)} s={s} "
            f"max|d| {float((got.float() - ref.float()).abs().max()):.3g}, beyond {ROI_TOL}: "
            f"{ulps:.3g} bf16 ulps (bar {BF16_FWD_ULPS})")
        if not ulps <= BF16_FWD_ULPS:
            raise AssertionError(f"a bf16 ROIAlign forward disagrees with its plain version "
                                 f"({label}): {ulps} ulps")


def bf16_synthetic(dev):
    """The bf16 instances on synthetic bf16 tensors at the path shapes:
    kernel 2 at the serving map (1, 64, 64, 1024) × 300 rois and the C4
    train map (1, 38, 64, 1024) × 128, with and without ``valid_hw``;
    kernel 3 at the C4 train shape; kernels 4 and 5 at P2 and P3, 128 rois,
    pooled 14 and 7, inverted rois included; s = RUNTIME_S for kernels 2-5.
    Returns (forward diff, kernel 3's BwdDiff, kernels 4/5's StreamDiff)."""
    fwd, bwd, stream = Bf16FwdDiff(), BwdDiff(), StreamDiff()
    rng = np.random.RandomState(11)
    bf = torch.bfloat16
    valid_hw = torch.tensor([[600.0, 800.0]], device=dev)
    feat = torch.from_numpy(rng.randn(1, 64, 64, 1024).astype(np.float32)).to(dev, bf)
    rois = torch.from_numpy(synthetic_rois(rng, 300, 1024, 1024)[None]).to(dev)
    fwd.add(feat, rois, (14, 14), 1.0 / 16, 2, None, "serving map, canvas clamp")
    fwd.add(feat, rois, (14, 14), 1.0 / 16, 2, valid_hw, "serving map, valid_hw clamp")
    feat = torch.from_numpy(rng.randn(1, 38, 64, 1024).astype(np.float32)).to(dev, bf)
    rois = torch.from_numpy(synthetic_rois(rng, 128, 608, 1024)[None]).to(dev)
    for s in (2, RUNTIME_S):
        fwd.add(feat, rois, (14, 14), 1.0 / 16, s, None, "train shape, canvas clamp")
        fwd.add(feat, rois, (14, 14), 1.0 / 16, s, valid_hw, "train shape, valid_hw clamp")
        g = torch.from_numpy(rng.randn(1, 128, 14, 14, 1024).astype(np.float32)).to(dev, bf)
        for vhw, clamp in ((None, "canvas"), (valid_hw, "valid_hw")):
            bwd.add(g, rois, tuple(feat.shape), (14, 14), 1.0 / 16, s, vhw,
                    f"bf16 g, s={s} train shape, {clamp} clamp")
    for h, w, stride in ((152, 256, 4), (76, 128, 8)):
        feat = torch.from_numpy(rng.randn(1, h, w, 256).astype(np.float32)).to(dev, bf)
        rois = torch.from_numpy(stream_rois(rng, 128, 608, 1024)[None]).to(dev)
        for pooled, s in (((14, 14), 2), ((7, 7), 2), ((14, 14), RUNTIME_S)):
            label = f"P{int(math.log2(stride))} pooled {pooled[0]} s={s}"
            fwd.add(feat, rois, pooled, 1.0 / stride, s, None, label, stream=True)
            if fwd_has_inverted_nonzero(feat, rois, pooled, 1.0 / stride, s):
                raise AssertionError(f"a bf16 inverted roi did not pool to zeros ({label})")
            g = torch.from_numpy(rng.randn(1, 128, *pooled, 256).astype(np.float32)).to(dev, bf)
            stream.bwd(g, rois, tuple(feat.shape), pooled, 1.0 / stride, s, f"bf16 g, {label}")
    return fwd, bwd, stream


BF16_BWD_KERNELS = ("roi_table_kernel", "roi_align_stage_bwd_kernel")


def bf16_backward_kernels(dev) -> dict:
    """Autograd through roi_align (C4's train map, 128 rois) and
    roi_align_stream (P2, 128 rois) on bf16 maps: the gradient must be the
    bf16 tensor the backward kernel wrote (the same storage: no cast after
    it), and every CUDA kernel the profiled backward shows must be its
    table or stage kernel.  Returns {function: [kernel names]}."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(13)
    out = {}
    for name, fn, mod, attr, shape, stride, rois in (
            ("roi_align", roi_mod.roi_align, roi_mod, "_roi_align_bwd_cuda", (1, 38, 64, 1024),
             16, synthetic_rois(rng, 128, 608, 1024)),
            ("roi_align_stream", stream_mod.roi_align_stream, stream_mod,
             "_roi_align_stream_bwd_cuda", (1, 152, 256, 256), 4,
             stream_rois(rng, 128, 608, 1024))):
        feat = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)
        f = feat.requires_grad_()
        pooled = fn(f, torch.from_numpy(rois[None]).to(dev), (14, 14), 1.0 / stride, 2)
        g = torch.from_numpy(rng.randn(*pooled.shape).astype(np.float32)).to(dev, torch.bfloat16)
        written = {}
        orig = getattr(mod, attr)

        def record(*a, **k):
            dfeat = orig(*a, **k)
            written["ptr"], written["dtype"] = dfeat.data_ptr(), dfeat.dtype
            return dfeat

        torch.cuda.synchronize()
        setattr(mod, attr, record)
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                pooled.backward(g)
                torch.cuda.synchronize()
        finally:
            setattr(mod, attr, orig)
        names = sorted({e.key for e in prof.key_averages() if e.device_type.name == "CUDA"})
        same = f.grad.data_ptr() == written.get("ptr")
        out[name] = names
        log(f"  {name} backward on a bf16 map {shape}: the kernel wrote {written.get('dtype')}, "
            f"the gradient {f.grad.dtype} is its storage: {same}; CUDA kernels profiled {names}")
        ours = all(any(k in n for k in BF16_BWD_KERNELS) for n in names)
        if (f.grad.dtype != torch.bfloat16 or written.get("dtype") != torch.bfloat16 or not ours
                or not (same or names)):
            raise AssertionError(f"the bf16 {name} backward cast or launched more: {names}, "
                                 f"gradient {f.grad.dtype}, its kernel's storage {same}")
    return out


def fwd_has_inverted_nonzero(feat, rois, pooled, scale, s) -> bool:
    out = stream_mod._roi_align_stream_cuda(feat, rois, pooled, scale, s)
    return bool(out[~stream_mod.valid_rois(rois, scale)].any())


def hold_captured_bf16(cap, nms_diff, fwd, bwd, stream):
    """Each kernel against its plain version on the tensors a bf16 path fed
    it: NMS (float32 boxes: the heads hand float32 out) into ``nms_diff``,
    the bf16 instances of kernels 2-5 (the captured cotangents scaled to a
    max |g| of 1, as in ``hold_captured``); every captured ROIAlign call
    must be bf16.  Returns the number of calls held."""
    calls = 0
    for boxes, valid, thresh, max_keep in cap.nms:
        if boxes.dtype != torch.float32:
            raise AssertionError(f"a bf16 path fed the NMS {boxes.dtype} boxes")
        got = nms_mod.nms_mask_sorted(boxes, valid.bool(), thresh, max_keep)
        ref = nms_mod.nms_mask_sorted_plain(boxes, valid.bool(), thresh, max_keep)
        if nms_diff.add(got, ref):
            raise AssertionError("NMS kernel disagrees with the plain version on a bf16 path")
        calls += 1
    for feat, rois, pooled, scale, s, valid_hw in cap.roi:
        fwd.add(feat, rois, pooled, scale, s, valid_hw, "captured call")
        calls += 1
    for feat, rois, pooled, scale, s in cap.stream:
        fwd.add(feat, rois, pooled, scale, s, None, "captured call", stream=True)
        calls += 1
    for i, (g, rois, shape, pooled, scale, s, valid_hw) in enumerate(cap.roi_bwd):
        bwd.add(unit_max(g), rois, shape, pooled, scale, s, valid_hw,
                f"bf16 captured call {i}, g / max|g|")
        calls += 1
    for i, (g, rois, shape, pooled, scale, s) in enumerate(cap.stream_bwd):
        stream.bwd(unit_max(g), rois, shape, pooled, scale, s,
                   f"bf16 captured call {i}, g / max|g|")
        calls += 1
    dtypes = {e[0].dtype for c in (cap.roi, cap.stream, cap.roi_bwd, cap.stream_bwd) for e in c}
    if dtypes != {torch.bfloat16}:
        raise AssertionError(f"a bf16 path fed its ROIAlign kernels {dtypes}")
    return calls


def _match_detections(dets_b, dets_f):
    """(bf16 detections, matched within the bars) over the classes of one
    request: each bf16 row's nearest float32 row of its class."""
    total = matched = 0
    gaps = []
    for db, df in zip(dets_b[1:], dets_f[1:]):
        total += len(db)
        if not len(db) or not len(df):
            continue
        d, near = _nearest(db[:, :4], df[:, :4])
        ds = np.abs(db[:, 4] - df[near, 4])
        gaps.extend(d.tolist())
        matched += int(((d <= BF16_BOX_PX) & (ds <= BF16_SCORE)).sum())
    return total, matched, gaps


def bf16_serve_c4(cfg, weights, dev):
    """C4 serving in bf16 + FOLD_BN on the calibrated weights: the six
    REQUEST_HW requests through ``detect_single`` and a same-bucket batch of
    2 through the Predictor.  Launches reset just before and read just
    after: NMS twice and kernel 2's bf16 instance once a forward, no float32
    ROIAlign.  The detections against the float32 port's on the same
    weights, matched by nearest box.  Returns (capture, launches, figures)."""
    bcfg = bf16_cfg(cfg)
    pp = make_test_postprocess(cfg, NUM_CLASSES, cfg.TEST.SCORE_THRESH, cfg.TEST.DET_PER_CLASS)
    f32 = Predictor(loaded_model(cfg, weights), pp, device=dev)
    predictor = Predictor(loaded_model(bcfg, weights), pp, device=dev)
    images = request_images()
    ladder = BucketLadder(cfg.SHAPE_BUCKETS)
    reqs = [prepare_request(im, cfg, ladder) for im in images]
    buckets = sorted({r.bucket for r in reqs})
    pair = [r for r in reqs if r.bucket == buckets[0]][:2]
    batch = {"images": np.stack([r.image for r in pair]),
             "im_info": np.stack([r.im_info for r in pair]),
             "orig_hw": np.asarray([r.orig_hw for r in pair], np.float32)}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for b in buckets:
        detect_single(predictor, images[[r.bucket for r in reqs].index(b)], bcfg, NUM_CLASSES)
    reset_launches()
    with Capture() as cap:
        dets = [detect_single(predictor, im, bcfg, NUM_CLASSES) for im in images]
        out = predictor.predict(batch)
    launches = read_launches()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    want = {k: C4_BF16_SERVE_LAUNCHES.get(k, 0) * 7 for k in KERNELS}
    log(f"  launches in the bf16 serving path (6 requests, a batch of 2): {launches}")
    if launches != want:
        raise AssertionError(f"bf16 C4 serving launched {launches}, reckoned {want}")
    if not np.isfinite(out["det_boxes"]).all() or out["det_boxes"].dtype != np.float32:
        raise AssertionError("bf16 batch detections are non-finite or not float32")
    times = []
    for im in images:
        t0 = time.perf_counter()
        detect_single(predictor, im, bcfg, NUM_CLASSES)
        times.append((time.perf_counter() - t0) * 1e3)
    _, wall_ms, events = _profiled(lambda: detect_single(predictor, images[0], bcfg, NUM_CLASSES))
    busy = sum(e.self_device_time_total for e in events) / 1e3
    fig = {"latency_ms": times, "latency_ms_median": statistics.median(times),
           "busy_ms": busy, "wall_ms_profiled": wall_ms, "peak_mib": peak,
           "kernel_launches_per_request": sum(e.count for e in events)}
    log(f"  bf16 per-request ms (detect_single, host resize included): "
        f"{[round(t, 3) for t in times]} median={fig['latency_ms_median']:.3f}; one request "
        f"profiled: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
        f"{fig['kernel_launches_per_request']} kernels; max_memory_allocated {peak:.1f} MiB above "
        f"the {held / 2**20:.1f} MiB the script already held")
    by_layer = {}
    for e in events:
        by_layer[_layer_of(e.key)] = by_layer.get(_layer_of(e.key), 0.0) + e.self_device_time_total
    fig["by_layer_ms"] = {k: v / 1e3 for k, v in by_layer.items()}
    log("    by layer " + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in
                                   sorted(by_layer.items(), key=lambda kv: -kv[1])))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"    top: {e.key[:90]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms")
    fig["calibrated"] = detections_agree(cfg, pp, images, f32, predictor, "calibrated weights",
                                         dets)
    rewrite = rewrite_weights(cfg)
    fig["rewrite"] = detections_agree(
        cfg, pp, images, Predictor(loaded_model(cfg, rewrite), pp, device=dev),
        Predictor(loaded_model(bcfg, rewrite), pp, device=dev), "exact-rewrite weights",
        gate=True)
    return cap, launches, fig


def detections_agree(cfg, pp, images, f32, b16, label, dets=None, gate=False) -> dict:
    """The bf16 predictor's detections of ``images`` against the float32
    one's (the same weights), each matched to the nearest float32 box of its
    class: the share within BF16_BOX_PX and BF16_SCORE, held to
    BF16_MATCHED with ``gate``."""
    bcfg = bf16_cfg(cfg)
    total = matched = 0
    gaps = []
    for i, im in enumerate(images):
        db = dets[i] if dets is not None else detect_single(b16, im, bcfg, NUM_CLASSES)
        t, m, g = _match_detections(db, detect_single(f32, im, cfg, NUM_CLASSES))
        total, matched, gaps = total + t, matched + m, gaps + g
    fig = {"detections": total, "matched": matched, "matched_share": matched / max(total, 1),
           "box_gap_px_median": statistics.median(gaps) if gaps else None}
    log(f"  bf16 detections vs the float32 port's, {label}: {matched} of {total} within "
        f"{BF16_BOX_PX} px and {BF16_SCORE} score of their nearest float32 box "
        f"({fig['matched_share']:.3f}; " + (f"bar {BF16_MATCHED}" if gate else "printed, not held")
        + f"); nearest-box gap median {fig['box_gap_px_median']} px")
    if gate and (total == 0 or fig["matched_share"] < BF16_MATCHED):
        raise AssertionError(f"bf16 detections stray from the float32 port's ({label}): {fig}")
    return fig


def bf16_train_cli(cfg, weights, roidb, dev, label, batch=1, steps=TRAIN_STEPS, keep=2,
                   per_step=None):
    """``tools/train_end2end.py --compute_dtype bfloat16`` on the card with
    FOLD_BN from the config, on ``roidb`` (``load_gt_roidb`` patched to it)
    from the calibrated ``weights`` (``build_model`` patched to load them).
    Launches reset just before, read just after: ``per_step`` a step (C4:
    NMS and kernels 2 and 3's bf16 instances once a step, no float32
    ROIAlign).  Returns (capture, launches, figures)."""
    per_step = C4_BF16_LAUNCHES_PER_STEP if per_step is None else per_step
    from mx_rcnn_tpu_torch.tools import train_end2end as e2e

    epochs = -(-steps // (len(roidb) // batch))

    saved = (e2e.generate_config, e2e.build_model, e2e.load_gt_roidb, e2e.ranks_to_launch)
    e2e.generate_config = lambda network, dataset: cfg.replace(
        network=dataclasses.replace(cfg.network, FOLD_BN=True))
    e2e.build_model = lambda c, generator=None: loaded_model(c, weights)
    e2e.load_gt_roidb = lambda *a, **k: (None, roidb)
    e2e.ranks_to_launch = lambda args: 0  # one rank, in this process
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--compute_dtype", "bfloat16", "--synthetic", str(len(roidb)), "--no_flip",
                "--epochs", str(epochs), "--max_steps", str(steps), "--frequent", str(steps),
                "--batch_images", str(batch), "--aux_interval", "1",
                "--prefix", os.path.join(tmp, "e2e")]
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        try:
            with Capture(keep=keep) as cap:
                out = e2e.main(argv)
        finally:
            e2e.generate_config, e2e.build_model, e2e.load_gt_roidb, e2e.ranks_to_launch = saved
        launches = read_launches()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    model_cfg = out["state"].model.cfg.network
    want = {k: n * out["dispatched_steps"] for k, n in per_step.items()}
    log(f"  {label}: train_end2end {' '.join(argv[:-2])}: COMPUTE_DTYPE "
        f"{model_cfg.COMPUTE_DTYPE}, FOLD_BN {model_cfg.FOLD_BN}; launches {launches} "
        f"(expected {want})")
    if (model_cfg.COMPUTE_DTYPE, model_cfg.FOLD_BN) != ("bfloat16", True):
        raise AssertionError(f"{label}: the CLI built {model_cfg}")
    if launches != want or out["dispatched_steps"] != steps:
        raise AssertionError(f"{label}: {out['dispatched_steps']} steps dispatched, launches "
                             f"{launches}, not {want}")
    return cap, launches, train_figures(cfg, out, label, peak, batch)


def train_figures(cfg, out, label, peak, batch=None) -> dict:
    """The losses' gates (finite, none above LOSS_GROWTH_MAX × the first
    step's, a mask network's MaskBCELoss on its own) and the step figures
    of a ``fit`` run."""
    hist = out["history"]
    keys = ("loss",) + (("MaskBCELoss",) if cfg.network.USE_MASK else ())
    if not all(math.isfinite(h[k]) for h in hist for k in keys):
        raise AssertionError(f"{label}: non-finite losses")
    growth = {k: max(h[k] for h in hist) / hist[0][k] if hist[0][k] > 0 else math.inf
              for k in keys}
    timed = [h["step_ms"] for h in hist[TRAIN_WARMUP:]]
    batch = int(batch or cfg.TRAIN.BATCH_IMAGES)
    clock = out["clock"]
    window = clock["end"] - clock["step_start"][TRAIN_WARMUP]
    # the CLI's epoch-end checkpoints that fell in the timed window
    saved = sum(d["seconds"] for d in out.get("saves", ())
                if d["at"] >= clock["step_start"][TRAIN_WARMUP])
    images = batch * (len(clock["step_start"]) - TRAIN_WARMUP)
    fig = {"steps": len(hist), "losses": [h["loss"] for h in hist], "growth": growth,
           "step_ms_median": statistics.median(timed), "step_ms": timed,
           "images_per_s": batch * 1e3 / statistics.median(timed),
           "loop_images_per_s": images / window, "saves_s_in_loop": saved,
           "loop_images_per_s_without_saves": images / (window - saved), "peak_mib": peak}
    log(f"  {label}: losses {[round(v, 5) for v in fig['losses']]}; largest / first "
        f"{ {k: round(v, 3) for k, v in growth.items()} } (bar {LOSS_GROWTH_MAX}); step median "
        f"{fig['step_ms_median']:.3f} ms ({fig['images_per_s']:.3f} images/s, batch {batch}); "
        f"loop {fig['loop_images_per_s']:.3f} images/s ({fig['loop_images_per_s_without_saves']:.3f} "
        f"without the {saved:.3f} s of checkpoint saves in it); max_memory_allocated "
        f"{peak:.1f} MiB above what the script already held")
    if not all(v <= LOSS_GROWTH_MAX for v in growth.values()):
        raise AssertionError(f"{label}: a loss grew {growth}: the run diverges")
    return fig


def bf16_fit(cfg, weights, roidb, dev, per_step, label, keep=4):
    """TRAIN_STEPS steps of ``fit`` in bf16 + FOLD_BN from the calibrated
    ``weights``; launches reset just before, read just after, must be
    ``per_step`` a step.  Returns (capture, launches, figures)."""
    bcfg = bf16_cfg(cfg)
    model = loaded_model(bcfg, weights)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with Capture(keep=keep) as cap:
        out = fit(model, bcfg, roidb, epochs=2, seed=0, max_steps=TRAIN_STEPS,
                  frequent=TRAIN_STEPS, device=dev)
    launches = read_launches()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    want = {k: n * out["dispatched_steps"] for k, n in per_step.items()}
    log(f"  {label}: launches {launches} (expected {want})")
    if launches != want or out["dispatched_steps"] != TRAIN_STEPS:
        raise AssertionError(f"{label}: launches {launches}, not {want}")
    return cap, launches, train_figures(bcfg, out, label, peak)


def _held_step(model, cfg, batch, samples=None):
    """One train step's forward and backward with the sampled rois held to
    ``samples`` (None: the step samples, and they are returned); the
    optimizer's freeze set applied.  → (loss, {name: grad}, samples, the
    rois each ROIAlign forward pooled)."""
    make_optimizer(cfg, model, make_lr_schedule(cfg, 8))
    mod = importlib.import_module(type(model).__module__)
    orig = mod.sample_rois
    held = {}

    def sample(*a, **k):
        held["samples"] = orig(*a, **k) if samples is None else samples
        return held["samples"]

    mod.sample_rois = sample
    try:
        for p in model.parameters():
            p.grad = None
        with Capture() as cap:
            loss = model(batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
                         train=True, sample_seeds=batch["sample_seeds"], rng=5,
                         **model_extras(batch))[0]
            loss.backward()
    finally:
        mod.sample_rois = orig
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    rois = [e[1] for e in cap.roi] + [e[1] for e in cap.stream]
    return float(loss.detach()), grads, held["samples"], rois


def rewrite_weights(cfg, seed: int = 7):
    """The seeded random weights with every frozen BN's four tensors moved
    as JAX's exact-rewrite test moves them (tests/test_model.py:370-389):
    scale, bias and mean by N(0, 0.05), var to |var + N(0, 0.05)| + 0.5."""
    model = make_model(cfg)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                for leaf in ("scale", "bias", "mean", "var"):
                    t = getattr(m, leaf)
                    t.add_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.05))
                    if leaf == "var":
                        t.abs_().add_(0.5)
    return model.state_dict()


def bf16_gradient_gate(cfg, weights, roidb, dev, groups, label, gate=True):
    """The bf16 + FOLD_BN step's gradient against the float32 unfolded
    step's on the same weights and batch: the bf16 step takes the float32
    step's sampled rois (their proposals differ by rounding), and both must
    pool the same rois; each trained group's relative L2 difference is held
    to BF16_GRAD_TOL (printed only, without ``gate``)."""
    batch = train_batch(cfg, roidb, 1, dev)
    ref = loaded_model(cfg, weights).to(dev, memory_format=torch.channels_last).train()
    f_loss, f_grads, samples, f_rois = _held_step(ref, cfg, batch)
    del ref
    bcfg = bf16_cfg(cfg)
    model = loaded_model(bcfg, weights).to(dev, memory_format=torch.channels_last).train()
    b_loss, b_grads, _, b_rois = _held_step(model, bcfg, batch, samples)
    same = len(f_rois) == len(b_rois) and all(torch.equal(a, b) for a, b in zip(f_rois, b_rois))
    if not same or set(f_grads) != set(b_grads):
        raise AssertionError(f"{label}: the bf16 and float32 steps pooled different rois or "
                             f"trained different tensors")
    rel = {}
    for grp in groups:
        names = [n for n in f_grads if n.startswith(grp + ".")]
        num = sum(float((b_grads[n].double() - f_grads[n].double()).pow(2).sum()) for n in names)
        den = sum(float(f_grads[n].double().pow(2).sum()) for n in names)
        # a group with no gradient in either step (no fg anchor on a small
        # image leaves the RPN's 0) agrees
        rel[grp] = math.sqrt(num / den) if den > 0 else (0.0 if num == 0 else math.inf)
    log(f"  {label}: loss bf16 {b_loss:.6f} vs float32 {f_loss:.6f}; both pooled the same "
        f"{len(f_rois)} roi sets; gradient relative L2 difference by group "
        f"{ {g: round(v, 5) for g, v in rel.items()} } "
        + (f"(bar {BF16_GRAD_TOL})" if gate else "(printed, not held)"))
    if gate and not max(rel.values()) <= BF16_GRAD_TOL:
        raise AssertionError(f"{label}: the bf16 gradient strays from the float32 one: {rel}")
    return {"loss_bf16": b_loss, "loss_f32": f_loss, "rel_l2": rel}


def fold_gate(cfg, weights, roidb, dev, gate=True):
    """FOLD_BN in float32 against the unfolded graph on the card, on the
    calibrated weights: one request's forward outputs (the same valid
    proposals; rois, class probabilities and deltas within FOLD_RTOL /
    FOLD_ATOL) and one train step's gradients on the same sampled rois
    (each trained leaf within FOLD_GRAD of its largest element); without
    ``gate`` the figures are printed, not held."""
    fcfg = cfg.replace(network=dataclasses.replace(cfg.network, FOLD_BN=True))
    im = request_images()[0]
    req = prepare_request(im, cfg, BucketLadder(cfg.SHAPE_BUCKETS))
    batch = {"images": req.image[None], "im_info": req.im_info[None]}
    outs = [Predictor(loaded_model(c, weights), device=dev).predict(batch) for c in (cfg, fcfg)]
    same_valid = bool(np.array_equal(outs[0]["roi_valid"], outs[1]["roi_valid"]))
    if gate and not same_valid:
        raise AssertionError("FOLD_BN: the folded graph keeps other proposals")
    v = outs[0]["roi_valid"] & outs[1]["roi_valid"]
    err = {}
    for k in ("rois", "cls_prob", "bbox_deltas"):
        a, b = outs[0][k][v], outs[1][k][v]
        err[k] = float(np.max(np.abs(b - a) - FOLD_RTOL * np.abs(a)))
        if gate and not np.allclose(b, a, rtol=FOLD_RTOL, atol=FOLD_ATOL):
            raise AssertionError(f"FOLD_BN: {k} differs beyond rtol {FOLD_RTOL} / atol {FOLD_ATOL}")
    tb = train_batch(cfg, roidb, 1, dev)
    ref = loaded_model(cfg, weights).to(dev, memory_format=torch.channels_last).train()
    _, g0, samples, _ = _held_step(ref, cfg, tb)
    del ref
    model = loaded_model(fcfg, weights).to(dev, memory_format=torch.channels_last).train()
    _, g1, _, _ = _held_step(model, fcfg, tb, samples)
    worst = max(float((g1[n] - g0[n]).abs().max() / (g0[n].abs().max() + 1e-6)) for n in g0)
    log(f"  FOLD_BN float32 vs unfolded: the same valid proposals {same_valid}; request "
        f"outputs' largest |d| - rtol|a| {err} (rtol {FOLD_RTOL}, atol {FOLD_ATOL}); train step "
        f"gradients, worst leaf max|d| / max|g| {worst:.3g} over {len(g0)} leaves "
        + (f"(bar {FOLD_GRAD})" if gate else "(printed, not held)"))
    if gate and not worst < FOLD_GRAD:
        raise AssertionError(f"FOLD_BN: a gradient differs by {worst} of its largest")
    return {"same_valid": same_valid, "request_excess": err, "grad_worst": worst}


def launches_per_step(cfg, weights, roidb, dev) -> dict:
    """CUDA kernels launched by one C4 train step (forward, backward,
    optimizer) and by one inference forward, with the fold off and on, in
    float32 and bf16 (torch.profiler's kernel events)."""
    batch = train_batch(cfg, roidb, 0, dev)
    req = prepare_request(request_images()[0], cfg, BucketLadder(cfg.SHAPE_BUCKETS))
    request = {"images": req.image[None], "im_info": req.im_info[None]}
    out = {}
    for dtype, fold in (("float32", False), ("float32", True), ("bfloat16", False),
                        ("bfloat16", True)):
        c = cfg.replace(network=dataclasses.replace(cfg.network, COMPUTE_DTYPE=dtype,
                                                    FOLD_BN=fold))
        model = loaded_model(c, weights).to(dev, memory_format=torch.channels_last).train()
        state = create_train_state(model, make_optimizer(c, model, make_lr_schedule(c, 8)))
        train_step(state, batch, 1)
        torch.cuda.synchronize()
        _, _, step_ev = _profiled(lambda: train_step(state, batch, 2))
        pred = Predictor(model, device=dev)
        pred.predict(request)
        _, _, fwd_ev = _profiled(lambda: pred.predict_async(request))
        key = f"{dtype}{' fold' if fold else ''}"
        out[key] = {"train_step": sum(e.count for e in step_ev),
                    "forward": sum(e.count for e in fwd_ev)}
        del model, state, pred
    log(f"  CUDA kernel launches, one C4 train step / one inference forward: "
        + "; ".join(f"{k} {v['train_step']} / {v['forward']}" for k, v in out.items()))
    return out


def bf16_phase(cfg, c4_weights, roidb, mcfg, mask_train_weights, mask_roidb, mask_cfg,
               mask_weights, nms_diff, dev):
    """The ``[bf16]`` phase: the bf16 kernels on synthetic and path tensors,
    C4 serving, C4 training through the CLI (batch 1 on ``[train]``'s
    images, and BATCH_IMAGES 8, ``bench.py``'s configuration), Mask R-CNN
    training and serving, the bf16 gradient gates, FOLD_BN in float32, and
    the launches a step with the fold off and on.  Returns (figures, the
    comparisons, the captures, the launch counts by run)."""
    fwd, bwd, stream = bf16_synthetic(dev)
    figs, caps, launches = {}, {}, {}
    log("[bf16] the backwards of bf16 maps launch their table and stage kernels only (no cast)")
    figs["backward_kernels"] = bf16_backward_kernels(dev)
    log(f"[bf16] C4 serving, bf16 + FOLD_BN, the calibrated [train] weights: {REQUEST_HW} "
        f"requests and a batch of 2")
    caps["serve"], launches["serve"], figs["serve"] = bf16_serve_c4(cfg, c4_weights, dev)
    log(f"[bf16] C4 training through train_end2end --compute_dtype bfloat16 (FOLD_BN from the "
        f"config): {TRAIN_STEPS} steps at BATCH_IMAGES 1 on the [train] run's {len(roidb)} "
        f"images")
    caps["train"], launches["train"], figs["train"] = bf16_train_cli(
        cfg, c4_weights, roidb, dev, "C4 bf16 train")
    large = SyntheticDataset(num_images=BF16_TRAIN_IMAGES_LARGE, image_size=(480, 640)).gt_roidb()
    log(f"[bf16] C4 training at BATCH_IMAGES {BF16_LARGE_BATCH} (bench.py's configuration) on "
        f"{len(large)} synthetic 480x640 images, {BF16_LARGE_STEPS} steps")
    caps["train_b8"], launches["train_b8"], figs["train_b8"] = bf16_train_cli(
        cfg, c4_weights, large, dev, f"C4 bf16 train, batch {BF16_LARGE_BATCH}",
        batch=BF16_LARGE_BATCH, steps=BF16_LARGE_STEPS, keep=1)
    log(f"[bf16] Mask R-CNN training, bf16 + FOLD_BN, {TRAIN_STEPS} steps of fit from the "
        f"calibrated [mask train] weights")
    caps["mask_train"], launches["mask_train"], figs["mask_train"] = bf16_fit(
        mcfg, mask_train_weights, mask_roidb, dev, MASK_BF16_LAUNCHES_PER_STEP,
        "Mask R-CNN bf16 train")
    log("[bf16] Mask R-CNN serving, bf16 + FOLD_BN, the calibrated [mask serve] weights")
    caps["mask_serve"], launches["mask_serve"], figs["mask_serve"], *_ = infer_serve_phase(
        "Mask R-CNN bf16 serving", bf16_cfg(mask_cfg), dev, MASK_BF16_SERVE_LAUNCHES,
        weights=mask_weights)
    log("[bf16] the bf16 kernels vs plain on every bf16 path's captured tensors")
    figs["captured_calls"] = sum(hold_captured_bf16(c, nms_diff, fwd, bwd, stream)
                                 for c in caps.values())
    log("[bf16] gradients, bf16 + FOLD_BN against float32, same weights, batch and rois: "
        "held on JAX's exact-rewrite weights (seeded, BN moved as in its test), printed on the "
        "calibrated ones")
    c4_rewrite, mask_rewrite = rewrite_weights(cfg), rewrite_weights(mcfg)
    figs["grad_c4"] = bf16_gradient_gate(cfg, c4_rewrite, roidb, dev, TRAINED_GROUPS, "C4")
    figs["grad_mask"] = bf16_gradient_gate(mcfg, mask_rewrite, mask_roidb, dev,
                                           MASK_TRAINED_GROUPS, "Mask R-CNN")
    figs["grad_c4_calibrated"] = bf16_gradient_gate(cfg, c4_weights, roidb, dev, TRAINED_GROUPS,
                                                    "C4, calibrated weights", gate=False)
    figs["grad_mask_calibrated"] = bf16_gradient_gate(
        mcfg, mask_train_weights, mask_roidb, dev, MASK_TRAINED_GROUPS,
        "Mask R-CNN, calibrated weights", gate=False)
    log("[bf16] FOLD_BN in float32 against the unfolded graph: held at JAX's exact-rewrite bars "
        "on its exact-rewrite weights, printed on the calibrated ones")
    figs["fold"] = fold_gate(cfg, c4_rewrite, roidb, dev)
    figs["fold_calibrated"] = fold_gate(cfg, c4_weights, roidb, dev, gate=False)
    log("[bf16] where one bf16 C4 train step's and one bf16 Mask R-CNN train step's device time "
        "goes")
    figs["train_profile"] = profile_train_step(
        loaded_model(bf16_cfg(cfg), c4_weights).to(dev, memory_format=torch.channels_last),
        bf16_cfg(cfg), roidb, dev)
    figs["mask_train_profile"] = profile_train_step(
        loaded_model(bf16_cfg(mcfg), mask_train_weights).to(
            dev, memory_format=torch.channels_last), bf16_cfg(mcfg), mask_roidb, dev)
    log("[bf16] CUDA kernel launches per step and per forward, the fold off and on")
    figs["launches_per_step"] = launches_per_step(cfg, c4_weights, roidb, dev)
    return figs, (fwd, bwd, stream), caps, launches


# ------------------------------------------------------------------ VGG-16
# the groups a VGG-16 step trains (conv1/conv2 frozen, FIXED_PARAMS): one
# conv of each trained block, the top head and the heads; the finite
# differences move the last conv (its gradient comes through ROIPooling's
# backward), the top head and the RCNN head
VGG_TRAINED_GROUPS = ("backbone.conv3_1", "backbone.conv4_1", "backbone.conv5_3", "top_head",
                      "rpn", "rcnn")
VGG_FD_GROUPS = ("backbone.conv5_3", "top_head", "rcnn")
# ROIPooling is plain PyTorch: a VGG-16 step launches the proposal NMS only,
# a forward the proposal and the per-class NMS, kernels 2-5 never
VGG_LAUNCHES_PER_STEP = dict(NO_LAUNCHES, nms=1)
VGG_SERVE_LAUNCHES = {"nms": 2}
VGG_STAGE_LAUNCHES = dict.fromkeys(("rpn1", "rcnn1", "rpn2", "rcnn2"), NO_LAUNCHES)
VGG_ALT_STEPS = 2
VGG_BF16_STEPS = 4
VGG_EVAL_IMAGES = 8
# ROIPooling's backward, card vs CPU: both sum a cell's terms (the split
# gradients of the bins that chose it) in their own order, so |Δ| ≤ this
# × the largest Σ|terms| of a cell (the backward of |g|); rois of the train
# call held on the CPU (its masked form is ~1 G elements at 128 rois)
ROI_POOL_BWD_TOL = 1e-6
ROI_POOL_BWD_ROIS = 32


def small_vgg_cfg():
    """VGG-16 with anchors small enough (32–128 px) to meet the gts of a
    128 × 128 image, as :func:`small_c4_cfg`."""
    cfg = generate_config("vgg", "PascalVOC")
    return cfg.replace(
        network=dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4, 8)),
        TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=400, RPN_POST_NMS_TOP_N=64,
                                  BATCH_ROIS=32, RPN_BATCH_SIZE=64),
    )


def roi_pool_work(feat, rois, pooled, scale, valid_hw, backward=False):
    """The bytes ROIPooling must move: each roi's covered cells (the rows
    and columns its bins span, clipped) read once and its output written
    once; the backward reads g and the covered cells and writes dfeat."""
    b, h, w, c = feat.shape
    covered = 0
    for i in range(b):
        vhw = None if valid_hw is None else valid_hw[i].expand(rois.shape[1], 2)
        (rlo, rhi), (clo, chi) = roi_pool_mod.bin_edges(rois[i], pooled, scale, (h, w), vhw)
        rows = (rhi.max(1).values - rlo.min(1).values).clamp_min(0)
        cols = (chi.max(1).values - clo.min(1).values).clamp_min(0)
        covered += int((rows * cols).sum())
    out = b * rois.shape[1] * pooled[0] * pooled[1] * c
    cells = covered * c + out + (b * h * w * c if backward else 0)
    return cells * feat.element_size()


def _roi_pool_grad(feat, rois, pooled, scale, valid_hw, g):
    f = feat.detach().requires_grad_(True)
    roi_pool_mod.roi_pool(f, rois, pooled, scale, valid_hw).backward(g)
    return f.grad


def roi_pool_hold(entry, label, backward):
    """ROIPooling on a path's captured call, on the card against the CPU:
    the forward bit for bit; with ``backward`` the gradient of a seeded g
    on the first ROI_POOL_BWD_ROIS rois at ROI_POOL_BWD_TOL.  Times the
    forward (and forward + backward) on the card beside its bytes bound.
    Returns the figures."""
    feat, rois, pooled, scale, valid_hw = entry

    def host(t):
        return None if t is None else t.cpu()

    with torch.no_grad():
        got = roi_pool_mod.roi_pool(feat, rois, pooled, scale, valid_hw)
        ref = roi_pool_mod.roi_pool(host(feat), host(rois), pooled, scale, host(valid_hw))
    if got.dtype != feat.dtype or not torch.equal(got.cpu(), ref):
        raise AssertionError(f"ROIPooling {label}: the card's forward is not the CPU's bit for bit")

    def forward():
        with torch.no_grad():
            roi_pool_mod.roi_pool(feat, rois, pooled, scale, valid_hw)

    ms = cuda_ms(forward, 10)
    bound, _ = bound_ms(roi_pool_work(feat, rois, pooled, scale, valid_hw), 0.0)
    fig = {"feat": list(feat.shape), "rois": list(rois.shape), "dtype": str(feat.dtype),
           "valid_hw": valid_hw is not None, "forward_bitwise": True, "ms": ms,
           "bound_ms": bound, "bound_by": "bytes", "library_ms": None}
    if backward:
        g = torch.randn(got.shape, generator=torch.Generator().manual_seed(8)).to(feat.dtype)
        part = (feat, rois[:, :ROI_POOL_BWD_ROIS], pooled, scale, valid_hw)
        gp = g[:, :ROI_POOL_BWD_ROIS]
        card = _roi_pool_grad(*part, gp.to(feat.device)).cpu()
        cpu_part = tuple(host(t) if torch.is_tensor(t) else t for t in part)
        plain = _roi_pool_grad(*cpu_part, gp)
        terms = float(_roi_pool_grad(*cpu_part, gp.abs()).max())
        err = float((card - plain).abs().max())
        gd = g.to(feat.device)
        fb_ms = cuda_ms(lambda: _roi_pool_grad(feat, rois, pooled, scale, valid_hw, gd), 3, 1)
        fb_bound, _ = bound_ms(roi_pool_work(feat, rois, pooled, scale, valid_hw, True), 0.0)
        fig.update({"bwd_rois_held": ROI_POOL_BWD_ROIS, "bwd_max_abs_err": err,
                    "bwd_terms_max": terms, "fwd_bwd_ms": fb_ms, "bwd_ms": fb_ms - ms,
                    "bwd_bound_ms": fb_bound})
        if not err <= ROI_POOL_BWD_TOL * terms:
            raise AssertionError(f"ROIPooling {label}: backward card vs CPU {err} > "
                                 f"{ROI_POOL_BWD_TOL} x {terms}")
    log(f"  roi_pool {label} feat {tuple(feat.shape)} {feat.dtype} rois {tuple(rois.shape)} "
        f"valid_hw {valid_hw is not None}: forward bitwise card = CPU; forward {ms:.4f} ms "
        f"(eager, plain PyTorch), bound {bound:.5f} ms (bytes)"
        + (f"; forward + backward {fig['fwd_bwd_ms']:.3f} ms (backward {fig['bwd_ms']:.3f}, "
           f"bound {fig['bwd_bound_ms']:.5f}), backward on {ROI_POOL_BWD_ROIS} rois card vs "
           f"CPU max|d| {fig['bwd_max_abs_err']:.3g} (bar {ROI_POOL_BWD_TOL} x the largest "
           f"sum of |terms| {fig['bwd_terms_max']:.4g})" if backward else ""))
    return fig


def vgg_eval(cfg, weights, dev):
    """``pred_eval`` of VGG-16 over VGG_EVAL_IMAGES synthetic VOC-sized
    images, the JAX package's loop defaults: NMS twice an image, no other
    kernel.  Returns the figures and the launches."""
    imdb = SyntheticDataset(num_images=VGG_EVAL_IMAGES, num_classes=NUM_CLASSES,
                            image_size=EVAL_HW)
    predictor = Predictor(loaded_model(cfg, weights), device=dev)
    _, _, fig, launches, _ = eval_run(predictor, cfg, imdb.gt_roidb(), imdb, 1,
                                      {"postprocess_workers": 0}, {}, "VGG-16, JAX defaults")
    want = dict(NO_LAUNCHES, nms=2 * VGG_EVAL_IMAGES)
    if launches != want or ROI_POOL.last != VGG_EVAL_IMAGES:
        raise AssertionError(f"VGG-16 eval launched {launches} and pooled {ROI_POOL.last} "
                             f"times, not {want} and {VGG_EVAL_IMAGES}")
    return fig, launches


def vgg_phase(nms_diff, bwd_diff, stream_diff, dev):
    """The ``[vgg]`` phase: VGG-16 (``generate_config("vgg", "PascalVOC")``:
    13 convs, 7 × 7 ROIPooling at stride 16, fc6 / fc7 at 4096, 21 classes)
    at full width.  Training: TRAIN_STEPS steps of ``fit`` on 8 synthetic
    480 × 640 images from seeded weights calibrated on them (every conv and
    fc6 / fc7 to unit output scale: VGG has no BN), the loss gates, conv1 /
    conv2 bitwise frozen, the finite differences, one profiled step.
    Serving the six requests and a batch of 2 (``detect_single``, the
    Predictor) and ``pred_eval`` on the calibrated weights; a bf16 request
    and bf16 steps (``train_end2end --compute_dtype bfloat16``); the
    alternate schedule (VGG_ALT_STEPS steps a stage) with ``tools/test.py
    --params final.pkl --synthetic 8``.  Every run: NMS as reckoned,
    kernels 2–5 never, ROIPooling once a step or forward.  ROIPooling on
    the captured calls card vs CPU (:func:`roi_pool_hold`); the NMS calls
    against the plain version; a small request and a small step card vs
    CPU.  Returns (figures, launches by run)."""
    cfg = generate_config("vgg", "PascalVOC")
    figs, launches, caps = {}, {}, {}
    t = cfg.TRAIN
    with ROI_POOL:
        log(f"[vgg] training: {TRAIN_STEPS} steps of fit, BATCH_ROIS {t.BATCH_ROIS}, "
            f"{t.RPN_PRE_NMS_TOP_N}->{t.RPN_POST_NMS_TOP_N} proposals, on 8 synthetic 480x640 "
            f"images; weights calibrated on them (unit output scale, each conv and fc6 / fc7)")
        caps["train"], launches["train"], model, roidb, figs["train"], weights, _ = train_path(
            cfg, dev, VGG_TRAINED_GROUPS, VGG_LAUNCHES_PER_STEP)
        figs["train"]["roi_pool_calls"] = ROI_POOL.last
        if ROI_POOL.last != TRAIN_STEPS:
            raise AssertionError(f"VGG-16 training pooled {ROI_POOL.last} times in "
                                 f"{TRAIN_STEPS} steps")
        log("[vgg] full-width gradient vs finite differences of the loss")
        figs["train"]["fd"] = gradient_matches_finite_differences(model, cfg, roidb, dev,
                                                                  VGG_FD_GROUPS)
        log("[vgg] where one train step's device time goes")
        figs["train"]["profile"] = profile_train_step(model, cfg, roidb, dev)
        busy = figs["train"]["profile"].get("busy_ms")
        if busy:
            figs["train"]["idle"] = 1 - busy / figs["train"]["step_ms_median"]
        del model
        log(f"[vgg] serving the calibrated weights: {REQUEST_HW} requests and a batch of 2")
        caps["serve"], launches["serve"], figs["serve"], *_ = infer_serve_phase(
            "VGG-16 serving", cfg, dev, VGG_SERVE_LAUNCHES, weights=weights)
        figs["serve"]["roi_pool_calls"] = ROI_POOL.last
        log(f"[vgg] pred_eval: {VGG_EVAL_IMAGES} synthetic {EVAL_HW[0]}x{EVAL_HW[1]} images")
        figs["eval"], launches["eval"] = vgg_eval(cfg, weights, dev)
        log("[vgg] bf16 (COMPUTE_DTYPE bfloat16; FOLD_BN has no BN to fold): serving and "
            f"{VGG_BF16_STEPS} steps of train_end2end --compute_dtype bfloat16")
        caps["bf16_serve"], launches["bf16_serve"], figs["bf16_serve"], *_ = infer_serve_phase(
            "VGG-16 bf16 serving", bf16_cfg(cfg), dev, VGG_SERVE_LAUNCHES, weights=weights)
        caps["bf16_train"], launches["bf16_train"], figs["bf16_train"] = bf16_train_cli(
            cfg, weights, roidb, dev, "VGG-16 bf16 train", steps=VGG_BF16_STEPS,
            per_step=VGG_LAUNCHES_PER_STEP)
        log(f"[vgg] alternate training: {VGG_ALT_STEPS} steps a stage, the calibrated weights as "
            f"the donor, then tools/test.py --params final.pkl --synthetic 8")
        caps["alternate"], figs["alternate"], _, _ = alternate_phase(
            cfg, weights, dev, steps=VGG_ALT_STEPS, per_stage=VGG_STAGE_LAUNCHES)
        calls = dict(ROI_POOL.calls)
        ROI_POOL.calls.clear()
    log("[vgg] NMS vs plain on every VGG run's captured calls; ROIPooling card vs CPU on the "
        "captured calls")
    for cap in caps.values():
        hold_captured(nms_diff, cap, bwd_diff, stream_diff)
    figs["roi_pool"] = {
        "serve": roi_pool_hold(calls["serve_float32"], "serving, batch of 2", False),
        "train": roi_pool_hold(calls["train_float32"], "train step", True),
        "bf16_serve": roi_pool_hold(calls["serve_bfloat16"], "bf16 serving, batch of 2", False),
    }
    del calls, caps
    log("[vgg reference] small VGG-16 request, card vs CPU")
    small_request_agrees(cfg, dev)
    log("[vgg reference] small VGG-16 and VGG-16 Fast R-CNN train steps, card vs CPU")
    for cls in (None, FastRCNN):
        train_step_agrees(dev, small_vgg_cfg(), [[10.0, 10.0, 70.0, 70.0, 1.0],
                                                 [60.0, 60.0, 120.0, 110.0, 2.0]],
                          "VGG-16" + (" Fast R-CNN" if cls else ""), cls=cls)
    return figs, launches



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
    rois at their dtype's size, the rois, the whole dfeat, of g's dtype,
    written once) and its flops."""
    keep = stream_mod.valid_rois(rois, scale)
    g_valid = g.numel() // keep.numel() * int(keep.sum())
    return ((g_valid + int(np.prod(shape))) * g.element_size() + rois.numel() * 4,
            g_valid * ROI_BWD_FLOPS_PER_G)


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
# NMS, kernels 2 and 4 at s = 2 (the float32 forward template <S, Rule, V>,
# V the four channels a lane, float4; the bf16 forward's <S, Rule, V>, V a
# lane's 16-byte vector of eight channels, uint4, at the path's widths), the table
# and tile kernels (template <Rule, kSplit, kTileW, kGroups, V>) of the
# float32 kernel 3, in each cluster size the path picks, and of kernel 5,
# and the table and stage kernels (roi_align_bwd_bf16.cuh, template <Rule,
# kGroups, kF32Out>) of the bf16 kernels 3 and 5 in each cluster size, with
# their bf16 epilogue; the table kernel reads no cotangent, so one instance
# serves both dtypes
def _table_instance(rule):
    return {f"roi_table_kernel<{rule}>": f"16roi_table_kernelINS_{len(rule)}{rule}EE"}


def _bwd_instances(rule, tiles, vec):
    return dict(_table_instance(rule), **{
        f"roi_align_tile_bwd_kernel<{rule}, {split}, 8, {g}, {vec}>":
        f"25roi_align_tile_bwd_kernelINS_{len(rule)}{rule}ELi{split}ELi8ELi{g}E{len(vec)}{vec}EE"
        for split, g in tiles})


def _stage_instances(rule):
    return dict(_table_instance(rule), **{
        f"roi_align_stage_bwd_kernel<{rule}, {g}, false>":
        f"26roi_align_stage_bwd_kernelINS_{len(rule)}{rule}ELi{g}ELb0EEE"
        for g in STAGE_GROUPS})


def _fwd_instance(rule, vec, kernel="roi_align_fwd_kernel"):
    return {f"{kernel}<2, {rule}, {vec}>":
            f"{len(kernel)}{kernel}ILi2ENS_{len(rule)}{rule}E{len(vec)}{vec}EE"}


RESIDENT_TILES = ((8, 1), (8, 2), (8, 4))
STREAM_TILES = ((4, 1),)
STAGE_GROUPS = (1, 2, 4, 8)
PATH_INSTANCES = {
    "nms": {"nms_mask_kernel": "15nms_mask_kernelE",
            "nms_reduce_kernel": "17nms_reduce_kernelE"},
    "roi_align_fwd": _fwd_instance("ResidentTaps", "float4"),
    "roi_align_stream_fwd": _fwd_instance("StreamTaps", "float4"),
    "roi_align_bwd": _bwd_instances("ResidentTaps", RESIDENT_TILES, "float4"),
    "roi_align_stream_bwd": _bwd_instances("StreamTaps", STREAM_TILES, "float4"),
    "roi_align_fwd_bf16": _fwd_instance("ResidentTaps", "uint4", "roi_align_fwd_bf16_kernel"),
    "roi_align_stream_fwd_bf16": _fwd_instance("StreamTaps", "uint4", "roi_align_fwd_bf16_kernel"),
    "roi_align_bwd_bf16": _stage_instances("ResidentTaps"),
    "roi_align_stream_bwd_bf16": _stage_instances("StreamTaps"),
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


def f32_same_inputs_ms(kind, entry) -> float:
    """Graph ms of the float32 instance on a bf16 entry's tensors cast to
    float32 (the same rois and values): the bf16 instance's own cost."""
    up = tuple(t.float() if torch.is_tensor(t) and t.dtype == torch.bfloat16 else t
               for t in entry)
    if kind == "fwd":
        feat, rois, pooled, scale, s, valid_hw = up
        fn = lambda: roi_mod.roi_align(feat, rois, pooled, scale, s, valid_hw)  # noqa: E731
    elif kind == "bwd":
        g, rois, shape, pooled, scale, s, valid_hw = up
        fn = lambda: roi_mod._roi_align_bwd_cuda(g, rois, shape, pooled, scale, s,  # noqa: E731
                                                 valid_hw)
    elif kind == "stream":
        feat, rois, pooled, scale, s = up
        fn = lambda: stream_mod.roi_align_stream(feat, rois, pooled, scale, s)  # noqa: E731
    else:
        g, rois, shape, pooled, scale, s = up
        fn = lambda: stream_mod._roi_align_stream_bwd_cuda(g, rois, shape, pooled,  # noqa: E731
                                                           scale, s)
    ms = graph_ms(fn, 20)
    log(f"  the float32 instance on the same {kind} tensors: {ms:.4f} ms (graph)")
    return ms


def mask_serve_calls(cap) -> dict:
    """The bf16 Mask R-CNN batch-of-2 forward's kernel 2 calls, by name:
    the box head's P2..P5 (mask_serve_box_p2..), then the mask head's."""
    calls = cap.roi[-MASK_BF16_SERVE_LAUNCHES["roi_align_fwd_bf16"]:]
    out = {}
    for i, entry in enumerate(calls):
        head = "box" if i < 4 else "mask"
        level = int(round(-np.log2(entry[3])))
        out[f"mask_serve_{head}_p{level}"] = entry
    if sorted(out) != sorted(f"mask_serve_{h}_p{lv}" for h in ("box", "mask")
                              for lv in (2, 3, 4, 5)):
        raise AssertionError(f"the bf16 mask serving forward's calls are {sorted(out)}")
    return out


def bf16_fwd_plan(entry) -> dict:
    """The library's launch plan of a bf16 forward call, which must be its
    Python twin's (``ops/roi_align.py::fwd_bf16_plan``)."""
    feat, rois, pooled, _, s = entry[:5]
    args = tuple(feat.shape) + (rois.shape[1], tuple(pooled), s)
    plan = roi_mod.fwd_bf16_plan_of_library(*args)
    if plan != roi_mod.fwd_bf16_plan(*args):
        raise AssertionError(f"bf16 forward plan {plan} != its twin {roi_mod.fwd_bf16_plan(*args)}")
    return plan


def bf16_kernel_entries(redesigned, launches, diffs, timing, r32):
    """The kernels line's rows of the four bf16 instances: launches from the
    bf16 C4 train run (kernels 2 and 3) or the bf16 Mask R-CNN train run
    (kernels 4 and 5), with every bf16 run's counts beside them; the errors
    of every comparison; the times on the bf16 paths' tensors (the
    backwards' also at batch 8 and on the mask branch's ``r32`` rois)."""
    fwd, bwd, stream = diffs

    def counts(kernel):
        return {f"{run}_launches": n[kernel] for run, n in launches.items()}

    common = {"route": "cuda", "library_ms": None}
    return [
        {"name": "roi_align_fwd_bf16", **common, "source": "mx_rcnn_tpu_torch/csrc/roi_align.cu",
         "replaces": "mx_rcnn_tpu/ops/pallas/roi_align.py:88",
         "ptxas": redesigned["roi_align_fwd_bf16"],
         "launches": launches["train"]["roi_align_fwd_bf16"], **counts("roi_align_fwd_bf16"),
         "max_abs_err": fwd.max_abs_err, "max_bf16_ulps": fwd.ulps, **timing["train_fwd"],
         **_prefixed("serve", timing["serve"]), **_prefixed("mask_p4", timing["p4_fwd"]),
         **{k: v for name, t in timing.items() if name.startswith("mask_serve_")
            for k, v in _prefixed(name, t).items()}},
        {"name": "roi_align_bwd_bf16", **common,
         "source": "mx_rcnn_tpu_torch/csrc/roi_align_bwd_bf16.cuh",
         "replaces": "mx_rcnn_tpu/ops/pallas/roi_align.py:148",
         "ptxas": redesigned["roi_align_bwd_bf16"],
         "launches": launches["train"]["roi_align_bwd_bf16"], **counts("roi_align_bwd_bf16"),
         "max_abs_err": bwd.max_abs_err, "scaled_err": bwd.scaled_err,
         "bitwise_repeatable": bwd.repeatable, "bf16_epilogue_is_rne": bwd.rounded,
         **timing["train_bwd"], **_prefixed(f"batch{BF16_LARGE_BATCH}", timing["train_b8_bwd"]),
         **_prefixed("mask_p4", timing["p4_bwd"]),
         **{k: v for lv in (4, 5) for k, v in
            _prefixed(f"mask_p{lv}_r{r32}", timing[f"p{lv}_bwd_r{r32}"]).items()}},
        {"name": "roi_align_stream_fwd_bf16", **common,
         "source": "mx_rcnn_tpu_torch/csrc/roi_align_stream.cu",
         "replaces": "mx_rcnn_tpu/ops/pallas/roi_align_stream.py:100",
         "ptxas": redesigned["roi_align_stream_fwd_bf16"],
         "launches": launches["mask_train"]["roi_align_stream_fwd_bf16"],
         **counts("roi_align_stream_fwd_bf16"), "max_abs_err": fwd.max_abs_err,
         "max_bf16_ulps": fwd.ulps, **timing["p2_fwd"], **_prefixed("p3", timing["p3_fwd"])},
        {"name": "roi_align_stream_bwd_bf16", **common,
         "source": "mx_rcnn_tpu_torch/csrc/roi_align_bwd_bf16.cuh",
         "replaces": "mx_rcnn_tpu/ops/pallas/roi_align_stream.py:164",
         "ptxas": redesigned["roi_align_stream_bwd_bf16"],
         "launches": launches["mask_train"]["roi_align_stream_bwd_bf16"],
         **counts("roi_align_stream_bwd_bf16"), "max_abs_err": stream.bwd_err,
         "scaled_err": stream.bwd_scaled, "bitwise_repeatable": stream.repeatable,
         "bf16_epilogue_is_rne": stream.rounded,
         **timing["p2_bwd"], **_prefixed("p3", timing["p3_bwd"]),
         **{k: v for lv in (2, 3) for k, v in
            _prefixed(f"p{lv}_r{r32}", timing[f"p{lv}_bwd_r{r32}"]).items()}},
    ]


def save_cases(path, timed, forward):
    """The bf16 forwards' or backwards' timed calls (their tensors on the
    host), for ``tools/kernel_bench.py --cases``: another checkout's kernels
    timed on the same tensors."""
    cases = []
    for name, t in timed.items():
        entry, route = t["entry"], t["route"]
        host = None if entry[-1] is None or not torch.is_tensor(entry[-1]) else entry[-1].cpu()
        if forward and route in ("fwd", "stream"):
            feat, rois, pooled, scale, s = entry[:5]
            cases.append({"kind": "resident_fwd" if route == "fwd" else "stream_fwd",
                          "label": name, "feat": feat.cpu(), "rois": rois.cpu(),
                          "pooled": list(pooled), "scale": scale, "s": s,
                          "valid_hw": host if route == "fwd" else None})
        elif not forward and route in ("bwd", "stream_bwd"):
            g, rois, shape, pooled, scale, s = entry[:6]
            cases.append({"kind": "resident" if route == "bwd" else "stream", "label": name,
                          "g": g.cpu(), "rois": rois.cpu(), "shape": list(shape),
                          "pooled": list(pooled), "scale": scale, "s": s,
                          "valid_hw": host if route == "bwd" else None})
    torch.save(cases, path)
    log(f"  saved {len(cases)} {'forward' if forward else 'backward'} cases to {path}")


# ------------------------------------------------------------ serve engine phase
# The online serving stack (serve/engine.py over serve/runner.py) at full
# width: three families of one ResNet-101 C4 registry, one a precision rung
# ("default" float32, "bf16" COMPUTE_DTYPE bfloat16 + FOLD_BN, "int8"
# per-channel int8 weights dequantized into the float32 graph), each rung
# (family, bucket) one signature at max_batch 4.  The float32 family holds
# JAX's exact-rewrite weights (rewrite_weights); the two reduced rungs
# hold gate_weights, on which the parity gate holds (its box and score
# bars need every confident detection matched: on seeded random weights,
# calibrated or exact-rewrite, bf16 or int8 rounding reorders their NMS:
# 409 px and 16 confident detections unmatched on the H100).  On
# gate_weights neither the gate nor the responses' check can fail a wrong
# reduced forward: reduced_rungs_hold is the check that can.
SERVE_FAMILIES = (("default", "float32"), ("bf16", "bfloat16"), ("int8", "int8"))
SERVE_MAX_BATCH = 4
SERVE_MAX_QUEUE = 4
SERVE_IN_FLIGHT = 2
SERVE_CONCURRENCY = 8
# two load runs of 24 requests (48 in all): the hot swap fires during the
# first, the second is profiled
SERVE_HALF = 24
SERVE_SIZES = ((375, 500), (500, 375), (333, 500), (500, 333))
C4_SERVE_LAUNCHES = {"nms": 2, "roi_align_fwd": 1}
C4_BF16_SERVE = {"nms": 2, "roi_align_fwd_bf16": 1}
# a response (batch of up to 4, padded to 4) against detect_single (batch of
# 1) on the card, rows matched by nearest box of their class, those scoring
# at least SCORE_THRESH + margin on either side: float32 and int8 at the
# [eval] phase's batch-2-vs-batch-1 bars, bf16 at the parity gate's
# tolerances (its batch-4 and batch-1 graphs round apart in bf16)
SERVE_TOL = {"f32": (EVAL_BOX_TOL, EVAL_SCORE_TOL, 1e-3),
             "int8": (EVAL_BOX_TOL, EVAL_SCORE_TOL, 1e-3),
             "bf16": (4.0, 0.1, 0.1)}
SERVE_MASK_REQUESTS = 3


def _served_agree(got, ref, thresh, cap, tol) -> dict:
    """One response against its reference detections: every row of either
    side scoring at least ``thresh`` + margin has a row of its class on the
    other side within the box and score bars (nearest box).  A side the
    cross-class cap ``cap`` cut is compared above its cut + margin only (a
    row at the cut may fall on either side of it).  Returns the rows
    checked and the largest gaps; raises past a bar."""
    box_tol, score_tol, margin = tol
    floor = thresh + margin
    for side in (got, ref):
        scores = np.concatenate([d[:, 4] for d in side[1:]])
        if len(scores) >= cap > 0:
            floor = max(floor, float(scores.min()) + margin)
    rows, gap, sgap = 0, 0.0, 0.0
    for j in range(1, len(ref)):
        for a, b in ((got[j], ref[j]), (ref[j], got[j])):
            conf = a[a[:, 4] >= floor]
            if not len(conf):
                continue
            if not len(b):
                raise AssertionError(f"class {j}: {len(conf)} confident rows and none to match")
            d, near = _nearest(conf[:, :4], b[:, :4])
            ds = np.abs(conf[:, 4] - b[near, 4])
            rows += len(conf)
            gap, sgap = max(gap, float(d.max())), max(sgap, float(ds.max()))
    if gap > box_tol or sgap > score_tol:
        raise AssertionError(f"response off its reference by {gap} px / {sgap} score "
                             f"(bars {box_tol} / {score_tol})")
    return {"rows": rows, "box_gap_px": gap, "score_gap": sgap}


# The checks above cannot fail a wrong bf16 or int8 forward: on
# gate_weights a box depends on the image by ~0.05 px and every score on
# the class bias alone, so the gate and the responses against
# detect_single hold the reduced rungs by their launch counts only.  This
# one can: each reduced slot's module runs on the exact-rewrite weights
# (int8: quantized and dequantized) with no postprocess, and its raw head
# outputs for a batch of SERVE_MAX_BATCH VOC-sized images are held against
# the same rung at batch 1, image by image.  Each roi of the batch is
# matched to the nearest roi of the image alone; at least ``share`` of them
# must lie within ``radius`` px, and there the class probabilities and the
# deltas within ``prob`` and ``deltas``.  The bars are set from the H100's
# readings at batch 4 vs 1 (NVIDIA H100 80GB HBM3, 700.00 W, 8 images):
# bf16 74.7-81.0% of rois within 0.1 px (median 0.055 px apart: the batch's
# convolutions round apart), gaps <= 0.0041 / 0.0031 there; int8 (the
# float32 graph) every roi at 0 px, gaps <= 5.4e-7.  Against a wrong
# forward: an image of the batch against ANOTHER image alone matched at
# most 1 roi of 300 within 0.1 px, with delta gaps of 0.015-0.031 there,
# and neighbouring rois' outputs (a forward that pools the wrong place)
# differ by 0.03-0.09; both must fail the bars.
SERVE_HEAD_BARS = {  # rung: (radius px, share, prob, deltas)
    "bf16": (0.1, 0.5, 1e-2, 1e-2),
    "int8": (1e-3, 1.0, 1e-5, 1e-5),
}


def _raw_heads(runner, fam, placed, batch):
    """The slot's module on ``placed`` params, no postprocess: host float32
    arrays of its raw test outputs."""
    slot = runner._slot(fam)
    with slot.lock:
        out = slot.predictor.predict_async(
            {"images": batch["images"], "im_info": batch["im_info"]}, params=placed)
        out = {k: v.float().cpu().numpy() for k, v in out.items()}
    return out


def _head_gaps(a, i, b, j, radius) -> dict:
    """Image ``i`` of raw outputs ``a`` against image ``j`` of ``b``: each
    valid roi of ``a`` matched to the nearest valid roi of ``b``; the share
    within ``radius`` px and, over those, the largest class-probability and
    delta gaps; and the largest gaps between neighbouring rois of ``a``."""
    va, vb = a["roi_valid"][i] > 0, b["roi_valid"][j] > 0
    d, near = _nearest(a["rois"][i][va], b["rois"][j][vb])
    m = d <= radius
    gap = {"share": float(m.mean()), "median_px": float(np.median(d))}
    for k in ("cls_prob", "bbox_deltas"):
        x, y = a[k][i][va], b[k][j][vb][near]
        gap[k] = float(np.abs(x[m] - y[m]).max()) if m.any() else 0.0
        gap[f"{k}_neighbours"] = float(np.abs(x[1:] - x[:-1]).max())
    return gap


def _head_held(gap, bars) -> bool:
    _, share, prob, deltas = bars
    return gap["share"] >= share and gap["cls_prob"] <= prob and gap["bbox_deltas"] <= deltas


def reduced_rungs_hold(runner, weights) -> dict:
    """Each reduced slot (bf16, int8) on the exact-rewrite ``weights``:
    its raw heads for a batch of SERVE_MAX_BATCH against batch 1 within
    SERVE_HEAD_BARS; another image and neighbouring rois outside them.
    Raises otherwise; returns the readings."""
    from mx_rcnn_tpu_torch.core.quantize import dequantize_tree, quantize_tree
    from mx_rcnn_tpu_torch.serve.loadgen import synthetic_image
    from mx_rcnn_tpu_torch.utils.bridge import flax_state_dict, state_dict_to_flax

    held = {}
    for fam, _ in SERVE_FAMILIES[1:]:
        slot = runner._slot(fam)
        bars = SERVE_HEAD_BARS[slot.precision]
        state = weights if slot.precision == "bf16" else flax_state_dict(
            dequantize_tree(quantize_tree(state_dict_to_flax(weights))), weights)
        placed = runner._stage(slot, state)
        reqs = [runner.make_request(synthetic_image(i, 375, 500, 7), model=fam)
                for i in range(SERVE_MAX_BATCH)]
        many = _raw_heads(runner, fam, placed, runner.assemble(reqs))
        alone = [_raw_heads(runner, fam, placed, {"images": r.image[None],
                                                  "im_info": r.im_info[None]}) for r in reqs]
        del placed
        n = SERVE_MAX_BATCH
        same = [_head_gaps(many, i, alone[i], 0, bars[0]) for i in range(n)]
        wrong = [_head_gaps(many, i, alone[(i + 1) % n], 0, bars[0]) for i in range(n)]
        worst = {k: max(g[k] for g in same) for k in ("cls_prob", "bbox_deltas")}
        worst["share"] = min(g["share"] for g in same)
        worst["median_px"] = max(g["median_px"] for g in same)
        log(f"  {fam} rung on the exact-rewrite weights, raw heads at batch {n} vs 1: "
            f"{worst} (bars {dict(zip(('radius_px', 'share', 'prob', 'deltas'), bars))}); "
            f"another image: shares {[round(g['share'], 4) for g in wrong]}; neighbouring "
            f"rois: prob {min(g['cls_prob_neighbours'] for g in same):.4f}, deltas "
            f"{min(g['bbox_deltas_neighbours'] for g in same):.4f} at least")
        if not all(_head_held(g, bars) for g in same):
            raise AssertionError(f"the {fam} rung's heads at batch {n} left batch 1's: {same}")
        if any(_head_held(g, bars) for g in wrong) or any(
                g["cls_prob_neighbours"] <= bars[2] or g["bbox_deltas_neighbours"] <= bars[3]
                for g in same):
            raise AssertionError(f"the {fam} rung's head bars do not refuse a wrong forward: "
                                 f"another image {wrong}, neighbours {same}")
        held[fam] = {"same": worst, "another_image_share": max(g["share"] for g in wrong)}
    return held


class _ForwardCount:
    """Counts each family's forwards (the slot predictor's predict_async,
    live and candidate alike) for the launch reckoning."""

    def __init__(self, runner):
        self.n = {}
        self._lock = threading.Lock()
        for mid, _ in SERVE_FAMILIES:
            pred = runner._slot(mid).predictor
            pred.predict_async = self._wrap(mid, pred.predict_async)

    def _wrap(self, mid, fn):
        def counted(*a, **k):
            with self._lock:
                self.n[mid] = self.n.get(mid, 0) + 1
            return fn(*a, **k)
        return counted

    def reset(self):
        with self._lock:
            self.n = {}


def train_cli_checkpoint(cfg, weights, tmp):
    """``tools/train_end2end.py`` for one epoch of one step (one synthetic
    image, no flip) from ``weights`` (``build_model`` patched to load them,
    as ``[images]`` does): the epoch dump it commits under ``tmp``."""
    from mx_rcnn_tpu_torch.core.checkpoint import is_committed
    from mx_rcnn_tpu_torch.tools import train_end2end as e2e

    saved = (e2e.build_model, e2e.ranks_to_launch)
    e2e.build_model = lambda c, generator=None: loaded_model(c, weights)
    e2e.ranks_to_launch = lambda args: 0  # one rank, in this process
    env = os.environ.get("MX_RCNN_ASSEMBLY_WORKERS")
    os.environ["MX_RCNN_ASSEMBLY_WORKERS"] = "0"
    try:
        out = e2e.main(["--network", "resnet", "--dataset", "PascalVOC", "--synthetic", "1",
                        "--no_flip", "--epochs", "1", "--prefix", str(tmp / "e2e")])
    finally:
        e2e.build_model, e2e.ranks_to_launch = saved
        if env is None:
            os.environ.pop("MX_RCNN_ASSEMBLY_WORKERS")
        else:
            os.environ["MX_RCNN_ASSEMBLY_WORKERS"] = env
    dumps = sorted(p for p in (tmp / "e2e").iterdir() if p.is_dir() and is_committed(str(p)))
    if out["steps"] != 1 or not dumps:
        raise AssertionError(f"the train CLI took {out['steps']} steps and committed {dumps}")
    return str(dumps[-1])


def gate_weights(cfg):
    """The exact-rewrite weights with heads the image moves only sub-pixel:
    the RPN objectness and the class scores their biases alone (the same
    for every anchor of a type and every roi: the stable sorts order them
    by index in every precision and batch), class 1 at probability
    e^1.5 / (e^1.5 + 20) ≈ 0.18, above SCORE_THRESH + the gate's margin,
    no RPN deltas (the proposals are the anchors, exactly) and the RCNN
    deltas × 1e-4: the image moves a box by ~0.05 px, precision rounding
    that by ~1e-3 px, and a perturbed rung (the deltas × 1e4) by tens of
    pixels.  With RCNN deltas × 1e-2 an NMS decision flipped between a
    batch of 4 and one of 1 in bf16 on the H100 (a box 32 px away)."""
    w = {k: v.clone() for k, v in rewrite_weights(cfg).items()}
    for k in ("rpn.rpn_cls_score.weight", "rpn.rpn_bbox_pred.weight", "rpn.rpn_bbox_pred.bias",
              "rcnn.cls_score.weight", "rcnn.cls_score.bias"):
        w[k].zero_()
    w["rcnn.cls_score.bias"][1] = 1.5
    w["rcnn.bbox_pred.weight"].mul_(1e-4)
    return w


def serve_header(cfg) -> str:
    t = cfg.TEST
    return (f"[serve] ServeRunner + ServingEngine, ResNet-{cfg.network.depth} C4 at full width: "
            f"{cfg.dataset.NUM_CLASSES} classes, buckets {cfg.SHAPE_BUCKETS}, max_batch "
            f"{SERVE_MAX_BATCH}, {t.RPN_PRE_NMS_TOP_N}->{t.RPN_POST_NMS_TOP_N} proposals; rungs "
            f"{dict(SERVE_FAMILIES)} (float32 on JAX's exact-rewrite weights, bf16 and int8 on "
            f"gate_weights, their raw heads held at batch 1 on the exact-rewrite weights); "
            f"{2 * SERVE_HALF} requests "
            f"{SERVE_SIZES} (concurrency {SERVE_CONCURRENCY}, lanes 50/50, max_queue "
            f"{SERVE_MAX_QUEUE}, in_flight {SERVE_IN_FLIGHT}) with a hot swap to a train-CLI "
            f"dump; then {SERVE_MASK_REQUESTS} Mask R-CNN requests through mask_rles_for")


def serve_engine_phase(cfg, dev, smi, mask_cfg, mask_weights) -> tuple:
    """``[serve]``: ``ServeRunner`` + ``ServingEngine`` at full-width
    ResNet-101 C4, its three precision rungs warmed up behind their parity
    gates, the reduced ones then held by :func:`reduced_rungs_hold`; 48 VOC-sized requests of ``run_load`` (concurrency 8, every
    family, a 50/50 lane mix) in two runs, a mid-load ``admin("swap ...")``
    of the float32 family to a dump the train CLI wrote, one request past
    its deadline and one ``QueueFull`` at max_queue 4; each response against
    ``detect_single`` of its family and version on the card; the signatures
    (the rungs after warmup, none new after the load and the swap); NMS and
    kernel 2 (float32 and bf16 instances) launched as reckoned per forward;
    then Mask R-CNN requests through ``mask_rles_for`` against the
    ``detect_single`` + ``eval/segm.py`` path, RLE for RLE.  Returns
    (launches of the C4 load, launches of the mask requests, figures)."""
    from mx_rcnn_tpu_torch.core.checkpoint import restore_tree
    from mx_rcnn_tpu_torch.eval.segm import canvas_rles
    from mx_rcnn_tpu_torch.serve.batcher import QueueFull
    from mx_rcnn_tpu_torch.serve.engine import DeadlineExceeded, ServingEngine
    from mx_rcnn_tpu_torch.serve.loadgen import run_load, synthetic_image
    from mx_rcnn_tpu_torch.serve.registry import ModelRegistry

    fig = {"card": smi}
    te = cfg.TEST
    weights, gated = rewrite_weights(cfg), gate_weights(cfg)
    registry = ModelRegistry()
    for mid, _ in SERVE_FAMILIES:
        registry.register(mid, bare_model(cfg), cfg, weights if mid == "default" else gated)
    runner = runner_mod.ServeRunner(registry=registry, max_batch=SERVE_MAX_BATCH, device=dev,
                                    precision=dict(SERVE_FAMILIES))
    t0 = time.perf_counter()
    misses = runner.warmup()
    fig["warmup_s"] = time.perf_counter() - t0
    rungs = len(SERVE_FAMILIES) * len(runner.ladder)
    log(f"  warmup: {misses} signatures for {rungs} rungs in {fig['warmup_s']:.2f} s; parity "
        + "; ".join(f"{k}: ok={v['ok']} unmatched={v['unmatched_confident']} box "
                    f"{v['max_box_delta_px']} px score {v['max_score_delta']}"
                    for k, v in runner.parity.items()))
    if misses != rungs or sorted(runner.parity) != ["bf16:bf16", "int8:int8"]:
        raise AssertionError(f"warmup made {misses} signatures for {rungs} rungs, gates "
                             f"{sorted(runner.parity)}")
    fig["parity"] = dict(runner.parity)
    # the gate refuses a perturbed rung: the bf16 slot's box regression
    # back at its seeded scale
    slot = runner._slot("bf16")
    box = slot.predictor.model.rcnn.bbox_pred.weight
    with torch.no_grad():
        box.mul_(1e4)
    try:
        runner.check_parity("bf16")
        raise AssertionError("the parity gate passed a perturbed bf16 rung")
    except runner_mod.PrecisionParityError as e:
        log(f"  perturbed bf16 rung refused: {str(e)[:160]}")
    finally:
        with torch.no_grad():
            box.mul_(1e-4)
    runner.check_parity("bf16")
    fig["reduced_heads"] = reduced_rungs_hold(runner, weights)

    tmp = Path(tempfile.mkdtemp(prefix="serve-"))
    try:
        ckpt = train_cli_checkpoint(cfg, weights, tmp)
        v2 = restore_tree(ckpt)["model"]
        pp = make_test_postprocess(cfg, NUM_CLASSES, te.SCORE_THRESH, te.DET_PER_CLASS)
        refs = {("default", 1): Predictor(loaded_model(cfg, weights), pp, device=dev),
                ("default", 2): Predictor(loaded_model(cfg, v2), pp, device=dev),
                ("bf16", 1): Predictor(loaded_model(bf16_cfg(cfg), gated), pp, device=dev),
                ("int8", 1): Predictor(loaded_model(cfg, runner._int8_state("int8", 1)), pp,
                                       device=dev)}
        del v2
        counter = _ForwardCount(runner)
        engine = ServingEngine(runner, max_queue=SERVE_MAX_QUEUE, in_flight=SERVE_IN_FLIGHT)
        swap = {}

        def run_swap():
            while engine.metrics.completed < SERVE_HALF // 3:
                time.sleep(0.002)
            swap["t0"] = time.monotonic()
            swap["result"] = engine.admin(f"swap default {ckpt}")
            swap["t1"] = time.monotonic()

        load = dict(concurrency=SERVE_CONCURRENCY, sizes=SERVE_SIZES, collect=True,
                    models=[None, "bf16", "int8"], lanes=["interactive", "bulk"])
        engine.start(warmup=False)
        torch.cuda.synchronize()
        reset_launches()
        counter.reset()
        compiled = runner.compile_cache.misses
        try:
            swapper = threading.Thread(target=run_swap, name="serve-swap")
            swapper.start()
            rep_a = run_load(engine, num_requests=SERVE_HALF, seed=0, **load)
            swapper.join()
            # one request already past its deadline: resolved without a forward
            late = engine.submit(synthetic_image(0, 375, 500), deadline_s=0.0)
            try:
                late.result(timeout=60)
                raise AssertionError("a request past its deadline was served")
            except DeadlineExceeded:
                pass
            # one QueueFull: the float32 slot held, its batches wait in the
            # completion threads and the assembler, the queue fills to 4
            slot = runner._slot("default")
            held, full = [], None
            with slot.lock:
                for i in range(SERVE_MAX_BATCH * (SERVE_IN_FLIGHT + 2) + 2):
                    try:
                        held.append(engine.submit(synthetic_image(100 + i, 375, 500)))
                    except QueueFull as e:
                        full = e
                        break
            if full is None:
                raise AssertionError(f"{len(held)} requests queued past max_queue 4")
            for f in held:
                f.result(timeout=300)
            rep_b, wall_ms, events = _profiled(
                lambda: run_load(engine, num_requests=SERVE_HALF, seed=1, **load))
        finally:
            engine.stop()
        launches = read_launches()
        forwards = dict(counter.n)
        snap = engine.snapshot()

        # the reckoning: NMS twice a forward; kernel 2 once a float32 or
        # int8 forward, its bf16 instance once a bf16 forward
        f32_fwd = forwards.get("default", 0) + forwards.get("int8", 0)
        want = dict(NO_LAUNCHES, nms=2 * sum(forwards.values()),
                    roi_align_fwd=C4_SERVE_LAUNCHES["roi_align_fwd"] * f32_fwd,
                    roi_align_fwd_bf16=C4_BF16_SERVE["roi_align_fwd_bf16"]
                    * forwards.get("bf16", 0))
        log(f"  forwards by family {forwards}; launches {launches}")
        if launches != want or min(launches["nms"], launches["roi_align_fwd"],
                                   launches["roi_align_fwd_bf16"]) <= 0:
            raise AssertionError(f"the serving load launched {launches}, reckoned {want}")
        if runner.compile_cache.misses != compiled:
            raise AssertionError(f"{runner.compile_cache.misses - compiled} new signatures "
                                 f"after warmup (the load and the swap)")
        res = swap["result"]
        log(f"  swap to {Path(ckpt).name}: v{res['previous']} -> v{res['version']}, "
            f"{res['warmed']} rungs warmed, canary {res['canary_probes']}, "
            f"{swap['t1'] - swap['t0']:.3f} s, swaps applied {runner.swaps_applied}")
        for rep in (rep_a, rep_b):
            o = rep["outcomes"]
            if o["ok"] != SERVE_HALF or o["error"] or o["deadline"]:
                raise AssertionError(f"requests lost or failed: {o}")

        # every response against its family's and version's detect_single
        checked = {"f32": [], "int8": [], "bf16": []}
        versions = {"v1": 0, "v2": 0}
        for rep, seed in ((rep_a, 0), (rep_b, 1)):
            rng = np.random.RandomState(seed)
            sizes = [SERVE_SIZES[rng.randint(len(SERVE_SIZES))] for _ in range(SERVE_HALF)]
            models = [[None, "bf16", "int8"][rng.randint(3)] for _ in range(SERVE_HALF)]
            for i in range(SERVE_HALF):
                im = synthetic_image(i, *sizes[i], seed)
                mid = models[i] or "default"
                got = rep["_results"][i][1]
                t_sub, t_done = rep["_times"][i]
                rung = {"default": "f32", "int8": "int8", "bf16": "bf16"}[mid]
                if mid != "default":
                    ref = detect_single(refs[(mid, 1)], im,
                                        bf16_cfg(cfg) if mid == "bf16" else cfg, NUM_CLASSES)
                    ref, _ = cap_detections(ref, te.MAX_PER_IMAGE)
                    checked[rung].append(_served_agree(got, ref, te.SCORE_THRESH,
                                                       te.MAX_PER_IMAGE, SERVE_TOL[rung]))
                    continue
                # the float32 family: v1 before the swap, v2 after it, either
                # while it ran (a request is served by one version)
                must = 1 if t_done < swap["t0"] else 2 if t_sub > swap["t1"] else None
                errs = {}
                for v in (1, 2):
                    ref, _ = cap_detections(detect_single(refs[("default", v)], im, cfg,
                                                          NUM_CLASSES), te.MAX_PER_IMAGE)
                    try:
                        errs[v] = _served_agree(got, ref, te.SCORE_THRESH, te.MAX_PER_IMAGE,
                                                SERVE_TOL["f32"])
                    except AssertionError as e:
                        errs[v] = e
                ok = [v for v, r in errs.items() if isinstance(r, dict)]
                if not ok or (must is not None and must not in ok):
                    raise AssertionError(f"request {i} (seed {seed}) matches versions {ok}, "
                                         f"must {must}: {errs}")
                versions[f"v{ok[0]}"] += 1
                checked["f32"].append(errs[ok[0]])
        if min(versions.values()) == 0:
            raise AssertionError(f"responses by version {versions}: the swap split nothing")
        agree = {k: {"responses": len(v), "rows": sum(r["rows"] for r in v),
                     "box_gap_px": max((r["box_gap_px"] for r in v), default=0.0),
                     "score_gap": max((r["score_gap"] for r in v), default=0.0)}
                 for k, v in checked.items()}
        log(f"  every response against detect_single on the card, by rung: {agree}; "
            f"float32 responses by version {versions}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    lat = snap["latency"]["e2e"]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    fig.update({
        "requests": 2 * SERVE_HALF, "forwards": forwards, "launches": launches,
        "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
        "images_per_s": [rep_a["imgs_per_sec"], rep_b["imgs_per_sec"]],
        "fetch_bytes_per_batch": runner.fetch_bytes_total / max(runner.split_completes, 1),
        "occupancy": snap["batches"]["occupancy"], "expired": snap["requests"]["expired"],
        "queue_full_retries": rep_a["outcomes"]["queue_full_retries"]
        + rep_b["outcomes"]["queue_full_retries"] + 1,
        "scheduler": snap["scheduler"], "completion": snap["completion"],
        "busy_ms_profiled": busy, "wall_ms_profiled": wall_ms,
        "device_busy_share": busy / wall_ms, "swap": {k: v for k, v in res.items()},
        "versions": versions, "agree": agree,
        "signatures": runner.compile_cache.misses,
    })
    log(f"  latency e2e p50 {lat['p50_ms']} ms p99 {lat['p99_ms']} ms ({smi}); images/s "
        f"{fig['images_per_s']} ({smi}); fetch bytes a batch "
        f"{fig['fetch_bytes_per_batch']:.0f}; occupancy {fig['occupancy']}; scheduler "
        f"{snap['scheduler']}; expired {fig['expired']}")
    log(f"  device busy over the profiled run of {SERVE_HALF} requests: {busy:.3f} of "
        f"{wall_ms:.3f} ms = {100 * fig['device_busy_share']:.1f}% ({smi})")
    if snap["requests"]["expired"] != 1:
        raise AssertionError(f"expired {snap['requests']['expired']}, not the 1 late request")
    del refs, engine, runner

    # Mask R-CNN through mask_rles_for: the device canvas, batch of 1, cuDNN
    # deterministic, against the detect_single + eval/segm.py path on the
    # same weights (host paste of the fetched grids), RLE for RLE
    cudnn_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        mte = mask_cfg.TEST
        mrunner = runner_mod.ServeRunner(bare_model(mask_cfg), mask_weights, mask_cfg,
                                         max_batch=1, device=dev, mask_canvas=True)
        mpred = Predictor(loaded_model(mask_cfg, mask_weights),
                          make_test_postprocess(mask_cfg, COCO_CLASSES, mte.SCORE_THRESH,
                                                mte.DET_PER_CLASS), device=dev)
        images = masked_images(REQUEST_HW[:SERVE_MASK_REQUESTS], seed=40)
        with ServingEngine(mrunner, in_flight=1) as meng:
            torch.cuda.synchronize()
            reset_launches()
            dispatched = mrunner.split_dispatches
            futs = [meng.submit(im, masks=True) for im in images]
            served = [f.result(timeout=300) for f in futs]
            torch.cuda.synchronize()
            mask_launches = read_launches()
            n_fwd = mrunner.split_dispatches - dispatched
        want = dict(NO_LAUNCHES, **{k: v * n_fwd for k, v in MASK_SERVE_LAUNCHES.items()})
        if mask_launches != want or n_fwd != len(images):
            raise AssertionError(f"mask requests launched {mask_launches} in {n_fwd} forwards, "
                                 f"reckoned {want}")
        n_rles = 0
        ladder = BucketLadder(mask_cfg.SHAPE_BUCKETS)
        for im, (dets, rles) in zip(images, served):
            req = prepare_request(im, mask_cfg, ladder)
            batch = {"images": req.image[None], "im_info": req.im_info[None],
                     "orig_hw": np.asarray([req.orig_hw], np.float32)}
            out = mpred.predict(batch)
            rd, _, rows = runner_mod.detections_from_output(
                out, batch["im_info"][0], req.orig_hw, mask_cfg, COCO_CLASSES, with_rows=True)
            rd, _, rows = cap_detections(rd, mte.MAX_PER_IMAGE, None, rows=rows)
            lut = {int(f): p for p, f in enumerate(out["det_mask_idx"][0]) if f >= 0}
            max_out = out["det_boxes"].shape[2]
            fill = np.full(out["det_masks"].shape[2:], -80.0, np.float32)
            for j in range(1, COCO_CLASSES):
                if dets[j].tobytes() != rd[j].tobytes():
                    raise AssertionError(f"mask request class {j}: detections differ")
                grids = [out["det_masks"][0][lut[(j - 1) * max_out + int(r)]]
                         if (j - 1) * max_out + int(r) in lut else fill for r in rows[j]]
                want_rles = canvas_rles(grids, rd[j], float(req.im_info[2]), *req.bucket)
                if rles[j] != want_rles:
                    raise AssertionError(f"mask request class {j}: RLEs differ")
                n_rles += len(want_rles)
        if n_rles == 0:
            raise AssertionError("the mask requests served no mask")
        log(f"  Mask R-CNN: {len(images)} requests through mask_rles_for (device canvas), "
            f"{n_rles} RLEs identical to detect_single + eval/segm.py's; launches "
            f"{mask_launches}; paste ms {mrunner.paste_ms_total:.3f} over {mrunner.pastes} "
            f"images, {mrunner.paste_bytes_total} bytes")
        fig["mask"] = {"requests": len(images), "rles": n_rles, "launches": mask_launches,
                       "paste_ms": mrunner.paste_ms_total}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    return launches, mask_launches, fig


# ------------------------------------------------------------- data parallel
# [dp]: (a) 3 DP steps at world size 1 over NCCL, (b) 4 steps at world size 2
# over gloo (both ranks on the card), (c) an elastic 2 -> 1 -> 2 run of the
# CLI, (d) the CLI as two --dist_* processes and their resume
DP_STEPS = 3
# (a)'s step times: this many more steps of each, in turns, after the 3
DP_TIMED_STEPS = 8
DP_WORLD2_STEPS = 4
# (b)'s bar: relative L2 distance by leaf of the momentum after step 1 (the
# clipped, reduced gradient plus the decay term) between two ranks of one
# image and one rank of the 2-image batch; a sum-reduced step (x2) fails it.
# Predicted 1e-3; read (NVIDIA H100 80GB HBM3, 700.00 W, PERF.md §6): worst
# leaf 6.2e-6, the sum-reduced step's smallest 0.98; set 16x the reading
DP_STEP1_BAR = 1e-4
DP_ALL_REDUCE_REPS = 5
DP_ELASTIC_IMAGES = 8  # 4 steps an epoch at a global batch of 2
DP_FAULT_STEP = 2
DP_FAULT = f"device_lost@{DP_FAULT_STEP}.1:2"  # rank 1 down for steps [2, 4)
DP_CLI_AUX_INTERVAL = 8  # the card CLI's default: the fault's window replays
# (c) and (d) train from the CLI's random init: at the config's 1e-3 the
# losses grow past 1e6 in 8 steps, hidden only by the guard's warmup; at
# 1e-5 they stay within 45-236 of a first loss of 109 on the H100
DP_CLI_LR = 1e-5
DP_CLI_LOSS_GROWTH = 10.0  # no loss of a run above this many times its first
DP_TIMEOUT_S = 300


def dp_cli_entry(deterministic: bool) -> list:
    """The command of a ``train_end2end`` rank: the module, or under cuDNN's
    deterministic mode (for the bitwise comparison of (c)) its ``main``."""
    if not deterministic:
        return [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.train_end2end"]
    return [sys.executable, "-c",
            "import sys, torch; "
            "torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False; "
            "from mx_rcnn_tpu_torch.tools.train_end2end import main; main(sys.argv[1:])"]


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def dp_world1(cfg, weights, roidb, dev) -> dict:
    """(a): DP steps at world size 1 over NCCL against ``train_step`` from
    the same weights and batches: bit-identical states and losses, the
    main path's kernels launched once a step."""
    assert distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0) == "nccl"
    try:
        mesh = make_mesh()
        runs = {}
        for name in ("dp", "plain"):
            model = loaded_model(cfg, weights).to(dev, memory_format=torch.channels_last).train()
            opt = make_optimizer(cfg, model, lambda s: cfg.TRAIN.LEARNING_RATE)
            runs[name] = {"state": create_train_state(model, opt), "ms": [], "losses": []}
        dp_step = make_parallel_train_step(mesh)
        launches = {}
        for k in range(DP_STEPS + DP_TIMED_STEPS):
            batch = train_batch(cfg, roidb, k % len(roidb), dev)
            for name, step in (("dp", dp_step), ("plain", train_step)):
                run = runs[name]
                if name == "dp" and k < DP_STEPS:
                    reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, aux = step(run["state"], batch, 5)
                torch.cuda.synchronize()
                run["ms"].append((time.perf_counter() - t0) * 1e3)
                if k >= DP_STEPS:
                    continue
                run["losses"].append(float(aux["loss"]))
                if name == "dp":
                    got = read_launches()
                    launches = {n: launches.get(n, 0) + got[n] for n in got}
            if k == DP_STEPS - 1:
                trees = {name: run["state"].state_tree() for name, run in runs.items()}
    finally:
        distributed.shutdown()
    bad = tree_diff(trees["dp"], trees["plain"])
    if bad or runs["dp"]["losses"] != runs["plain"]["losses"]:
        raise AssertionError(f"[dp] world 1: the DP steps differ from train_step: {bad[:5]}, "
                             f"losses {runs['dp']['losses']} vs {runs['plain']['losses']}")
    want = {n: DP_STEPS * c for n, c in C4_LAUNCHES_PER_STEP.items()}
    if launches != want:
        raise AssertionError(f"[dp] world 1: launches {launches}, not {want}")
    timed = {name: run["ms"][DP_STEPS:] for name, run in runs.items()}
    out = {"backend": "nccl", "launches": launches, "losses": runs["dp"]["losses"],
           "dp_ms": runs["dp"]["ms"], "plain_ms": runs["plain"]["ms"],
           "dp_ms_median": statistics.median(timed["dp"]),
           "plain_ms_median": statistics.median(timed["plain"]),
           "comm": dict(dp_step.comm)}
    log(f"[dp] (a) world 1 over NCCL: {DP_STEPS} DP steps bit-identical to train_step "
        f"(state checksum, losses {out['losses']}); launches {launches}; step median over "
        f"{DP_TIMED_STEPS} more in turns {out['dp_ms_median']:.3f} ms DP vs "
        f"{out['plain_ms_median']:.3f} ms plain (each {out['dp_ms']} / {out['plain_ms']}); "
        f"all-reduce bytes a step {dp_step.comm['bytes'] // len(runs['dp']['ms'])}")
    return out


def dp_world2(cfg, weights, roidb, dev, tmp) -> dict:
    """(b): two rank processes on the card over gloo, one image each, per-image
    ``sample_seeds``: equal states after every step, step 1 against one rank
    of the 2-image batch at :data:`DP_STEP1_BAR` (and a sum-reduced step
    failing it), each rank's launches, the all-reduce's time and bytes."""
    bucket = _orientation_bucket(roidb[0], cfg.SHAPE_BUCKETS)
    recs = [i for i, r in enumerate(roidb)
            if _orientation_bucket(r, cfg.SHAPE_BUCKETS) == bucket][:2 * DP_WORLD2_STEPS]
    if len(recs) < 2 * DP_WORLD2_STEPS:
        raise AssertionError(f"[dp] {len(recs)} records in one bucket")
    batches = [make_batch([roidb[i] for i in recs[2 * k:2 * k + 2]], cfg, bucket,
                          seeds=recs[2 * k:2 * k + 2]) for k in range(DP_WORLD2_STEPS)]
    rng = 5
    case = {"cfg": cfg, "weights": {k: v.cpu() for k, v in weights.items()},
            "batches": batches, "rng": rng, "device": dev.type, "deterministic": True,
            "time_all_reduce": DP_ALL_REDUCE_REPS,
            "variants": [{"reduce": "sum", "steps": 1, "params_after": 0},
                         {"reduce": "mean", "steps": DP_WORLD2_STEPS, "params_after": 0}]}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_case(case, str(tmp / "world2.pt"), 2, DP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError(f"[dp] world 2: backends {[r['backend'] for r in ranks]}")
    # (the sum-reduced variant reduces no aux: its losses are each rank's own)
    for v in range(2):
        a, b = (r["variants"][v] for r in ranks)
        if a["checksums"] != b["checksums"] or (v == 1 and a["losses"] != b["losses"]):
            raise AssertionError(f"[dp] world 2, variant {v}: the ranks' states differ after "
                                 f"some step: {a['checksums']} vs {b['checksums']}")
    # one rank, the 2-image batch, from the same weights (cuDNN deterministic)
    model = loaded_model(cfg, weights).to(dev, memory_format=torch.channels_last).train()
    opt = make_optimizer(cfg, model, lambda s: cfg.TRAIN.LEARNING_RATE)
    state = create_train_state(model, opt)
    _, aux1 = train_step(state, batch_to_device(batches[0], dev), rng)
    ref_m = {n: opt.sgd.state[p]["momentum_buffer"].cpu() for n, p in zip(state.names, opt.params)}
    ref_p = {n: p.detach().cpu() for n, p in zip(state.names, opt.params)}
    reading = {}
    for name, v in (("sum", 0), ("mean", 1)):
        got = ranks[0]["variants"][v]
        reading[name] = {
            "momentum_rel_l2": {n: _rel_l2(got["momenta"][n], ref_m[n]) for n in ref_m},
            "param_rel_l2": {n: _rel_l2(got["params"][n], ref_p[n]) for n in ref_p},
            "loss": got["losses"][0]}
    worst = {k: max(reading[k]["momentum_rel_l2"].items(), key=lambda kv: kv[1])
             for k in reading}
    log(f"[dp] (b) world 2 over gloo (2 ranks on the card): step 1 momentum relative L2 by "
        f"leaf, worst {worst['mean'][0]} {worst['mean'][1]:.3e} (median "
        f"{statistics.median(reading['mean']['momentum_rel_l2'].values()):.3e}); the "
        f"sum-reduced (x2) step: worst {worst['sum'][1]:.3e}, median "
        f"{statistics.median(reading['sum']['momentum_rel_l2'].values()):.3e}, smallest "
        f"{min(reading['sum']['momentum_rel_l2'].values()):.3e}; bar {DP_STEP1_BAR}; loss "
        f"{reading['mean']['loss']} vs one rank {float(aux1['loss'])}")
    if worst["mean"][1] > DP_STEP1_BAR:
        raise AssertionError(f"[dp] world 2: step 1 is {worst['mean'][1]:.3e} from one rank's "
                             f"at {worst['mean'][0]}, over the bar {DP_STEP1_BAR}")
    if worst["sum"][1] <= DP_STEP1_BAR:
        raise AssertionError(f"[dp] world 2: the sum-reduced step passes the bar "
                             f"({worst['sum'][1]:.3e}): the check cannot see it")
    per_rank = [r["variants"][1]["launches"] for r in ranks]
    want = {n: DP_WORLD2_STEPS * C4_LAUNCHES_PER_STEP.get(n, 0) for n in per_rank[0]}
    if any(lr != want for lr in per_rank):
        raise AssertionError(f"[dp] world 2: rank launches {per_rank}, not {want}")
    comm = ranks[0]["variants"][1]["comm"]
    out = {"backend": "gloo", "rank_launches": per_rank, "wall_s": wall,
           "losses": ranks[0]["variants"][1]["losses"],
           "all_reduce_ms": [r["all_reduce_ms"] for r in ranks],
           "all_reduce_bytes": ranks[0]["all_reduce_bytes"],
           "step_bytes": comm["bytes"] // DP_WORLD2_STEPS,
           "peak_mib": [r["variants"][1].get("peak_mib") for r in ranks],
           "momentum_rel_l2_worst": worst["mean"], "sum_rel_l2_worst": worst["sum"],
           "sum_rel_l2_min": min(reading["sum"]["momentum_rel_l2"].values()),
           "param_rel_l2_worst": max(reading["mean"]["param_rel_l2"].values()),
           "bar": DP_STEP1_BAR}
    log(f"[dp] (b) {DP_WORLD2_STEPS} steps, the ranks bit-identical after each; rank launches "
        f"{per_rank}; all-reduce of the {out['all_reduce_bytes']} gradient bytes "
        f"{out['all_reduce_ms']} ms (median of {DP_ALL_REDUCE_REPS}, each rank); bytes reduced "
        f"a step {out['step_bytes']}; peak MiB a rank {out['peak_mib']}; {wall:.1f} s of "
        f"rank processes")
    return out


def dp_cli_ranks(argv_of, n, tmp, label, env_extra=None, deterministic=False) -> list:
    """``n`` ranks of ``train_end2end`` started as a user would on this host
    (``--dist_coordinator 127.0.0.1:P --dist_nprocs n --dist_procid i``),
    one shared deadline; → each rank's report.  A rank that fails fails the
    phase, with the tail of its log."""
    port = free_port()
    reports = tmp / f"{label}_reports"
    reports.mkdir()
    env = dict(os.environ, MX_RCNN_RANK_REPORT=str(reports), LOCAL_WORLD_SIZE=str(n),
               PYTHONPATH=str(Path(__file__).resolve().parent), **(env_extra or {}))
    entry = dp_cli_entry(deterministic)
    logs = [tmp / f"{label}_rank{i}.log" for i in range(n)]
    procs = []
    for i in range(n):
        with open(logs[i], "w") as f:
            procs.append(subprocess.Popen(
                entry + argv_of(i) + ["--dist_coordinator", f"127.0.0.1:{port}",
                                      "--dist_nprocs", str(n), "--dist_procid", str(i)],
                stdout=f, stderr=subprocess.STDOUT, env=env,
                cwd=Path(__file__).resolve().parent))
    deadline = time.monotonic() + DP_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"[dp] {label}: rank {i} exited {p.returncode}:\n"
                                 + logs[i].read_text()[-4000:])
    return [json.loads((reports / f"rank{i}.json").read_text()) for i in range(n)]


def _sane_losses(label: str, report: dict) -> list:
    """The run's losses: finite, none above :data:`DP_CLI_LOSS_GROWTH`
    times the first, and no step retried or skipped by the divergence
    guard."""
    losses = [h["loss"] for h in report["history"]]
    if not all(math.isfinite(v) and v <= DP_CLI_LOSS_GROWTH * losses[0] for v in losses):
        raise AssertionError(f"[dp] {label}: the losses ran away: {losses}")
    if report["pipeline"]["retried_steps"] or report["pipeline"]["skipped_batches"]:
        raise AssertionError(f"[dp] {label}: the guard acted: {report['pipeline']}")
    return losses


def dp_elastic(dev, tmp) -> dict:
    """(c): ``train_end2end --elastic`` as two ``--dist_*`` ranks on the
    card over gloo, each with its own ``--prefix``, ``MX_RCNN_FAULTS`` =
    :data:`DP_FAULT`: one shrink, one regrow at the epoch boundary, the
    window's replays, a committed emergency dump; the survivor's degraded
    epoch dump bit-identical to one rank restored from the emergency dump
    over the same batches' kept rows; both ranks equal at the end, with the
    same final loss; only rank 0's prefix written."""
    prefix = tmp / "elastic0"
    t0 = time.perf_counter()
    reports = dp_cli_ranks(lambda i: [
        "--synthetic", str(DP_ELASTIC_IMAGES), "--no_flip", "--batch_images", "1",
        "--epochs", "2", "--lr", str(DP_CLI_LR), "--elastic",
        "--aux_interval", str(DP_CLI_AUX_INTERVAL), "--frequent", "1",
        "--prefix", str(tmp / f"elastic{i}")], 2, tmp, "elastic", {faults.ENV_VAR: DP_FAULT},
        deterministic=True)
    wall = time.perf_counter() - t0
    r0, r1 = reports
    el = r0["elastic"]
    replayed = DP_FAULT_STEP - DP_FAULT_STEP // DP_CLI_AUX_INTERVAL * DP_CLI_AUX_INTERVAL
    got = (el["shrinks"], el["regrows"], el["replayed_steps"], el["emergency_checkpoints"])
    if got != (1, 1, replayed, 1) or r0["degraded"] or r1["elastic"]["transitions"] != \
            el["transitions"]:
        raise AssertionError(f"[dp] elastic: shrinks, regrows, replays, emergency dumps {got} "
                             f"(expected (1, 1, {replayed}, 1)); {el['transitions']}")
    losses = _sane_losses("elastic", r0)
    if r0["state_checksum"] != r1["state_checksum"] or \
            r0["history"][-1]["loss"] != r1["history"][-1]["loss"]:
        raise AssertionError("[dp] elastic: the ranks' final states or losses differ after the "
                             "regrow")
    written = sorted(os.listdir(prefix))
    if (tmp / "elastic1").exists() or "run_meta.json" not in written or r1["saves"]:
        raise AssertionError(f"[dp] elastic: rank 0 wrote {written}; rank 1's prefix exists: "
                             f"{(tmp / 'elastic1').exists()}")
    emergency = [s for s in r0["saves"] if s["path"] not in
                 (str(prefix / "epoch_0001"), str(prefix / "epoch_0002"))]
    path = Path(emergency[0]["path"])
    man = read_manifest(str(path))
    if man is None or man.get("meta", {}).get("event") != "shrink" or not is_committed(str(path)):
        raise AssertionError(f"[dp] elastic: the emergency dump {path} is not committed: {man}")
    # one rank from the emergency dump over the same batches' kept rows
    cfg = generate_config("resnet", "PascalVOC")
    cfg = cfg.replace(TRAIN=dataclasses.replace(cfg.TRAIN, LEARNING_RATE=DP_CLI_LR))
    _, roidb = load_gt_roidb(cfg, None, flip=False, synthetic_size=DP_ELASTIC_IMAGES)
    model = bare_model(cfg).to(dev, memory_format=torch.channels_last).train()
    loader = TrainLoader(roidb, cfg, 2, shuffle=cfg.TRAIN.SHUFFLE, seed=0, prefetch=0)
    state = create_train_state(model, make_optimizer(cfg, model,
                                                     make_lr_schedule(cfg, len(loader))))
    load_checkpoint(str(prefix), emergency[0]["epoch"], state, emergency[0]["batch"])
    loader.epoch, loader.skip_batches = emergency[0]["epoch"], emergency[0]["batch"]
    reset_launches()
    for b in loader:
        train_step(state, batch_to_device(take_replica_rows(b, 1, 2), dev), 123)  # --seed 0 + 123
    fresh_launches = read_launches()
    degraded = read_manifest(str(prefix / "epoch_0001"))["checksum"]
    if tree_checksum(state.state_tree()) != degraded:
        raise AssertionError("[dp] elastic: the survivor's degraded epoch differs from one rank "
                             "restored from the emergency dump")
    out = {"recovery_s": el["recovery_s"], "transitions": el["transitions"],
           "replayed_steps": el["replayed_steps"], "emergency": str(path.name),
           "wall_s": wall, "fresh_launches": fresh_launches, "losses": losses,
           "written": written}
    log(f"[dp] (c) elastic over gloo as two --dist_* processes, {DP_FAULT}: shrink and regrow "
        f"{el['transitions']}, {el['replayed_steps']} step(s) replayed, emergency dump "
        f"{path.name}; the degraded epoch bit-identical to one rank restored from it; the ranks "
        f"equal after the regrow, final loss {losses[-1]} on both; losses {losses}; rank 0's "
        f"prefix {written}, rank 1's none; recovery_s {el['recovery_s']}; {wall:.1f} s of rank "
        f"processes")
    return out


def dp_cli(tmp) -> dict:
    """(d): the ``--resume`` of (c)'s run for a third epoch as two
    ``--dist_*`` processes: both resume at rank 0's last dump (rank 1's
    prefix holds none), end with the same loss and state, and only rank
    0's prefix is written."""
    t0 = time.perf_counter()
    again = dp_cli_ranks(lambda i: [
        "--synthetic", str(DP_ELASTIC_IMAGES), "--no_flip", "--batch_images", "1",
        "--epochs", "3", "--lr", str(DP_CLI_LR), "--resume", "--frequent", "1",
        "--prefix", str(tmp / f"elastic{i}")], 2, tmp, "cli_resume")
    wall = time.perf_counter() - t0
    a, b = again
    if a["history"][-1]["loss"] != b["history"][-1]["loss"] or \
            a["state_checksum"] != b["state_checksum"]:
        raise AssertionError("[dp] CLI resume: the ranks' final losses or states differ")
    losses = _sane_losses("CLI resume", a)
    if [tuple(r["begin"]) for r in again] != [(2, 0), (2, 0)]:
        raise AssertionError(f"[dp] CLI: resumed at {[r['begin'] for r in again]}")
    if (tmp / "elastic1").exists() or b["saves"] or \
            restorable_checkpoints(str(tmp / "elastic0"))[:3] != [(3, 0), (2, 0), (1, 0)]:
        raise AssertionError(f"[dp] CLI resume: rank 0's dumps "
                             f"{restorable_checkpoints(str(tmp / 'elastic0'))}; rank 1's prefix "
                             f"exists: {(tmp / 'elastic1').exists()}")
    out = {"resumed_final_loss": losses[-1], "losses": losses, "wall_s": wall}
    log(f"[dp] (d) --resume as two --dist_* processes: both at (2, 0), final loss "
        f"{losses[-1]} on both (losses {losses}); rank 0's prefix written, rank 1's none; "
        f"{wall:.1f} s of rank processes")
    return out


def dp_phase(cfg, weights, roidb, dev) -> tuple:
    """The ``[dp]`` phase: (a)–(d) above; → (stats, (a)'s launches)."""
    t0 = time.monotonic()
    cudnn_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory(prefix="dp-") as tmp:
            tmp = Path(tmp)
            stats = {"world1": dp_world1(cfg, weights, roidb, dev),
                     "world2": dp_world2(cfg, weights, roidb, dev, tmp),
                     "elastic": dp_elastic(dev, tmp),
                     "cli": dp_cli(tmp)}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    stats["seconds"] = time.monotonic() - t0
    w1, w2 = stats["world1"], stats["world2"]
    log(f"[dp] figures: DP step median {w1['dp_ms_median']:.3f} ms at world 1 (NCCL) vs plain "
        f"{w1['plain_ms_median']:.3f} ms; world 2 (gloo) all-reduce {w2['all_reduce_ms']} ms "
        f"of {w2['all_reduce_bytes']} bytes a step; elastic recovery_s "
        f"{stats['elastic']['recovery_s']}; peak MiB a rank {w2['peak_mib']}; phase "
        f"{stats['seconds']:.1f} s")
    return stats, w1["launches"]


# JAX's `make integration-gate` (Makefile:240-244): the CLI's defaults, then
# each run's network, flags and the kernels its run must launch
GATE_DEFAULTS = dict(steps=400, lr=2e-3, eval_every=100, target=0.8)
GATE_BOX_KERNELS = ("nms", "roi_align_fwd", "roi_align_bwd")
GATE_RUNS = (
    ("resnet50", {}, GATE_BOX_KERNELS),
    ("resnet_fpn", dict(lr=5e-4, steps=1200, eval_every=200, target=0.5), GATE_BOX_KERNELS),
    ("mask_resnet_fpn", dict(lr=5e-4, steps=1200, eval_every=200, target=0.3),
     GATE_BOX_KERNELS),
    ("vgg", dict(lr=1e-3, target=0.5), ("nms",)),
    # JAX's line: 8 virtual CPU devices there, 8 rank processes sharing the
    # card over gloo here, one image each of the 8-image global batch
    ("resnet50", dict(dp=8, steps=200, target=0.5), GATE_BOX_KERNELS),
)
# a line whose target the JAX package's own run misses (jax 0.9.0), with
# that run's gate metric, which the port's run must reach instead:
# `JAX_PLATFORMS=cpu python -m mx_rcnn_tpu.tools.integration_gate --network
# resnet50` reached 0.7040 at 400 steps and exited 1
REFERENCE_MISSES = {"resnet50": 0.7040}
# the gate at the bench configuration (gate_cfg's docstring): printed
GATE_BENCH = ("resnet50", dict(compute_dtype="bfloat16", fold_bn=True))
GATE_RANK_COMMAND = [
    sys.executable, "-c",
    "import sys, torch; "
    "torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False; "
    "from mx_rcnn_tpu_torch.tools.integration_gate import main; sys.exit(main(sys.argv[1:]))"]


def gate_run(network, flags, must_launch=()):
    """One ``run_gate`` on the card, its kernel launches counted from 0 (a
    ``--dp`` run's summed over its ranks' reports): → (result, launches,
    seconds).  Raises when a kernel of ``must_launch`` did not launch."""
    kw = dict(GATE_DEFAULTS, **flags)
    label = network + "".join(f" --{k} {v}" for k, v in flags.items())
    reset_launches()
    t0 = time.monotonic()
    out = gate_mod.run_gate(network, rank_command=GATE_RANK_COMMAND,
                            rank_timeout=DP_TIMEOUT_S, **kw)
    secs = time.monotonic() - t0
    if "ranks" in out:
        launches = {k: sum(r["launches"].get(k, 0) for r in out["ranks"]) for k in KERNELS}
        out = {k: v for k, v in out.items() if k != "ranks"}
    else:
        launches = read_launches()
    shown = {k: v for k, v in launches.items() if v}
    extra = "".join(f", {k} {out[k]}" for k in ("segm_AP50", "mask_iou")
                    if out.get(k) is not None)
    log(f"  {label}: gate {out['gate']:.4f} (target {kw['target']}), mAP {out['mAP']:.4f}"
        f"{extra}; {out['steps']} steps in {secs:.1f} s; per_eval {out['per_eval']}; "
        f"launches {shown}")
    missing = [k for k in must_launch if launches[k] == 0]
    if missing:
        raise AssertionError(f"[gate] {label}: {missing} never launched: {shown}")
    return out, launches, secs


def gate_phase() -> tuple:
    """``[gate]``: JAX's five integration gates through the port on the card,
    under cuDNN's deterministic mode, each held to its target, or, for a
    line whose target the JAX package's own run misses
    (:data:`REFERENCE_MISSES`), to that run's result; then the C4 gate at
    the bench configuration, printed.  → (stats, launches by run)."""
    stats, launches = {}, {}
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for network, run_flags, must in GATE_RUNS:
            name = network + ("_dp" if run_flags.get("dp") else "")
            out, n, secs = gate_run(network, run_flags, must)
            target = run_flags.get("target", GATE_DEFAULTS["target"])
            bar = target
            if out["gate"] < target and name in REFERENCE_MISSES:
                bar = REFERENCE_MISSES[name]
                log(f"  {name} missed JAX's target {target} after {out['steps']} steps, as the "
                    f"JAX package's own run of the line does ({bar}); held to that result")
            if out["gate"] < bar:
                raise AssertionError(f"[gate] {name} missed its bar: gate {out['gate']:.4f} "
                                     f"< {bar} after {out['steps']} steps: {out}")
            if network == "vgg" and any(n[k] for k in KERNELS if k.startswith("roi_align")):
                raise AssertionError(f"[gate] vgg launched a ROIAlign kernel: {n}")
            stats[name] = dict(out, seconds=secs, target=target, bar=bar)
            launches[name] = n
        network, run_flags = GATE_BENCH
        out, n, secs = gate_run(network, run_flags)
        stats["resnet50_bf16_fold"] = dict(out, seconds=secs, target=GATE_DEFAULTS["target"])
        launches["resnet50_bf16_fold"] = n
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    return stats, launches


PROFILE_ITERS = 3
PROFILE_ABLATE_BATCH = 8
TOOLS_EVAL_IMAGES = 16
CHECK_DATA_IMAGES = 6


def _profile_rows_hold(label, rows, launches, kernels):
    bad = {k: v for k, v in rows.items()
           if not all(x is not None and math.isfinite(x) and x > 0
                      for x in (v["wall_ms"], v["device_ms"]))}
    if bad:
        raise AssertionError(f"[tools] {label}: rows not finite and > 0: {bad}")
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"[tools] {label}: {missing} never launched: {launches}")
    for k, v in sorted(rows.items(), key=lambda kv: -kv[1]["wall_ms"]):
        log(f"    {k:28s} wall {v['wall_ms']:9.3f} ms, device {v['device_ms']:9.3f} ms "
            f"(host share {100 * (1 - v['device_ms'] / v['wall_ms']):.1f}%)")


def tools_phase(dev) -> tuple:
    """``[tools]``: profile_step (bf16, float32, --ablate), bench_eval (device
    and host paths at full width, the data plane) and check_data --smoke on
    a VOC tree of the fixtures.  → (stats, launches by run)."""
    stats, launches = {}, {}
    for dtype in ("bfloat16", "float32"):
        sfx = "_bf16" if dtype == "bfloat16" else ""
        reset_launches()
        t0 = time.monotonic()
        rows = profile_mod.profile(device=dev, iters=PROFILE_ITERS, dtype=dtype)
        rate = rows.pop("imgs/sec (full step)")
        n = launches[f"profile_{dtype}"] = read_launches()
        log(f"  profile_step --dtype {dtype}: {time.monotonic() - t0:.1f} s, "
            f"{rate:.2f} images/s (full step)")
        _profile_rows_hold(f"profile {dtype}", rows, n,
                           ("nms", "roi_align_fwd" + sfx, "roi_align_bwd" + sfx))
        stats[f"profile_{dtype}"] = dict(rows=rows, images_per_s=rate)
    reset_launches()
    t0 = time.monotonic()
    rows = profile_mod.ablate(device=dev, iters=PROFILE_ITERS, dtype="bfloat16",
                              batch=PROFILE_ABLATE_BATCH)
    n = launches["profile_ablate"] = read_launches()
    log(f"  profile_step --ablate --batch {PROFILE_ABLATE_BATCH}: "
        f"{time.monotonic() - t0:.1f} s")
    _profile_rows_hold("ablate", rows, n, ("nms", "roi_align_fwd_bf16", "roi_align_bwd_bf16"))
    stats["profile_ablate"] = rows

    for label, argv in (("bench_eval", []), ("bench_eval_host", ["--host_path"])):
        reset_launches()
        t0 = time.monotonic()
        line = bench_eval_mod.main(["--images", str(TOOLS_EVAL_IMAGES)] + argv)
        n = launches[label] = read_launches()
        log(f"  {label}: {line['metric']} {line['value']} {line['unit']}, "
            f"{line['detections']} detections, {time.monotonic() - t0:.1f} s; launches "
            f"{ {k: v for k, v in n.items() if v} }")
        if not line["value"] > 0 or n["nms"] == 0 or n["roi_align_fwd_bf16"] == 0:
            raise AssertionError(f"[tools] {label}: {line}, launches {n}")
        stats[label] = {k: line[k] for k in ("value", "detections", "path", "batch")}
    t0 = time.monotonic()
    line = bench_eval_mod.main(["--data_plane", "--images", str(TOOLS_EVAL_IMAGES)])
    log(f"  bench_eval --data_plane: serial {line['baseline_imgs_per_sec']} images/s, "
        f"overlapped {line['overlapped_imgs_per_sec']}, speedup {line['speedup']}, "
        f"byte-identical {line['byte_identical']}, {time.monotonic() - t0:.1f} s")
    if line["byte_identical"] is not True:
        raise AssertionError(f"[tools] the data plane's detections differ: {line}")
    stats["data_plane"] = {k: line[k] for k in ("baseline_imgs_per_sec",
                                                "overlapped_imgs_per_sec", "speedup",
                                                "byte_identical")}

    with tempfile.TemporaryDirectory() as tmp:
        devkit, n_images = write_voc_fixture_tree(Path(tmp))
        reset_launches()
        t0 = time.monotonic()
        rc = check_data_mod.main(["--data_root", str(Path(tmp)), "--smoke",
                                  "--smoke_images", str(min(n_images, CHECK_DATA_IMAGES))])
        n = launches["check_data"] = read_launches()
        log(f"  check_data --smoke on {n_images} fixture JPEGs: exit {rc}, "
            f"{time.monotonic() - t0:.1f} s; launches { {k: v for k, v in n.items() if v} }")
        if rc != 0 or any(n[k] == 0 for k in GATE_BOX_KERNELS):
            raise AssertionError(f"[tools] check_data --smoke: exit {rc}, launches {n}")
        stats["check_data"] = {"exit": rc, "images": n_images}
    return stats, launches


def _prefixed(prefix, d):
    return {f"{prefix}_{k}": v for k, v in d.items()}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port's paths on one card.")
    ap.add_argument("--save-bwd-cases", metavar="FILE",
                    help="also save the bf16 backwards' timed calls for kernel_bench --cases")
    ap.add_argument("--save-fwd-cases", metavar="FILE",
                    help="also save the bf16 forwards' timed calls for kernel_bench --cases")
    args = ap.parse_args(argv)
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
    full_float32()
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
    # first of the paths: the profiler passes of its short rows come back
    # without device events more often late in a long process
    log(f"[tools] tools/profile_step.py at full width (ResNet-{cfg.network.depth} C4, bucket "
        f"{cfg.SHAPE_BUCKETS[0]}): bf16 and float32 rows, --ablate at batch "
        f"{PROFILE_ABLATE_BATCH}, wall ms beside each row's device ms; tools/bench_eval.py "
        f"(device postprocess, --host_path, --data_plane) on {TOOLS_EVAL_IMAGES} images; "
        f"tools/check_data.py --smoke on a VOC tree of the JPEG fixtures")
    tools_stats, tools_launches = tools_phase(dev)
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
    train_stats["fd"] = gradient_matches_finite_differences(
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
    fpn_stats["fd"] = gradient_matches_finite_differences(
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
    mask_stats["fd"] = gradient_matches_finite_differences(
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
    alt_cap, alt_stats, rcnn1_tree, prop_roidb = alternate_phase(cfg, c4_weights, dev)
    rcnn1_model = flax_to_torch(rcnn1_tree, bare_model(cfg, FastRCNN)).to(
        dev, memory_format=torch.channels_last)
    del rcnn1_tree
    log("[alternate] kernels vs plain on the captured tensors (every proposal pass's NMS, the "
        "first Fast R-CNN steps' ROIAlign)")
    if not alt_cap.nms or any((tuple(c[0].shape), c[3]) != ((1, dump[0], 4), dump[1])
                              for c in alt_cap.nms):
        raise AssertionError(f"the proposal passes' NMS calls are not 1 x {dump[0]} -> {dump[1]}: "
                             f"{[(tuple(c[0].shape), c[3]) for c in alt_cap.nms]}")
    roi_err = max(roi_err, hold_captured(nms_diff, alt_cap, bwd_diff, stream_diff))
    log("[alternate] full-width Fast R-CNN-1 gradient vs finite differences of the loss")
    alt_stats["fd"] = gradient_matches_finite_differences(
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

    log(f"[images] real JPEG files at full width (ResNet-{cfg.network.depth} C4, "
        f"{cfg.dataset.NUM_CLASSES} classes, the calibrated weights the [train] run started "
        f"from): the fixtures decoded against cv2's hashes, the host C libraries' first use "
        f"from {FIRST_USE_THREADS} threads, and on a VOC tree of the fixtures tools/test.py "
        f"--vis, {IMAGES_TRAIN_STEPS} steps of train_end2end with assembly processes, "
        f"tools/demo.py")
    images_stats = images_phase(cfg, c4_weights, dev, workers, smi)

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
    log(serve_header(cfg))
    engine_launches, engine_mask_launches, serve_stats = serve_engine_phase(
        cfg, dev, smi, mask_cfg, mask_weights)

    log(f"[bf16] COMPUTE_DTYPE bfloat16 with FOLD_BN (bench.py's configuration): the bf16 "
        f"instances of kernels 2-5 vs plain, synthetic")
    bf16_stats, (bf16_fwd, bf16_bwd, bf16_stream), bf16_caps, bf16_launches = bf16_phase(
        cfg, c4_weights, roidb, mcfg, mask_train_weights, mask_roidb, mask_cfg, mask_weights,
        nms_diff, dev)

    log(f"[vgg] VGG-16 at full width (13 convs, 7x7 ROIPooling at stride 16, fc6 / fc7 4096, "
        f"{NUM_CLASSES} classes): training, serving, eval, bf16, alternate; ROIPooling is plain "
        f"PyTorch (no TPU kernel)")
    vgg_stats, vgg_launches = vgg_phase(nms_diff, bwd_diff, stream_diff, dev)

    log(f"[dp] data parallel: ResNet-{cfg.network.depth} C4 at full width from the calibrated "
        f"[train] weights, cuDNN deterministic: (a) {DP_STEPS} steps at world size 1 over NCCL "
        f"against train_step; (b) {DP_WORLD2_STEPS} steps at world size 2 over gloo, two rank "
        f"processes on the card, one image each; (c) train_end2end --elastic as two ranks with "
        f"{faults.ENV_VAR}={DP_FAULT}; (d) train_end2end as two --dist_* processes and their "
        f"--resume")
    dp_stats, dp_launches = dp_phase(cfg, c4_weights, roidb, dev)

    log("[gate] JAX's make integration-gate through tools/integration_gate.py on the card: "
        "C4, FPN, Mask R-CNN, VGG-16 and C4 --dp 8 (eight ranks sharing the card over gloo), "
        "each from seeded random weights on 8 synthetic 128x128 images to its target, "
        "cuDNN deterministic; then the C4 gate at bf16 + FOLD_BN")
    gate_stats, gate_launches = gate_phase()

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
    log("[timing] bf16 instances, on the bf16 paths' captured tensors (with the float32 "
        "instance on the same tensors cast to float32)")
    box = {k: [e for e in getattr(bf16_caps["mask_train"], k) if e[1].shape[1] == mt.BATCH_ROIS]
           for k in ("roi", "roi_bwd", "stream", "stream_bwd")}
    branch = {k: [e for e in getattr(bf16_caps["mask_train"], k) if e[1].shape[1] == nfg]
              for k in ("roi_bwd", "stream_bwd")}
    b16_entries = {
        "serve": (roi_fwd_timing, bf16_caps["serve"].roi[-1], "bf16 C4 serving"),
        "train_fwd": (roi_fwd_timing, bf16_caps["train"].roi[-1], "bf16 C4 train"),
        "train_bwd": (roi_bwd_timing, bf16_caps["train"].roi_bwd[-1], "bf16 C4 train"),
        "p4_fwd": (roi_fwd_timing, at_scale(box["roi"], 1.0 / 16), "bf16 mask train box P4"),
        "p4_bwd": (roi_bwd_timing, at_scale(box["roi_bwd"], 1.0 / 16), "bf16 mask train box P4"),
        **{f"p{lv}_fwd": (stream_fwd_timing, at_scale(box["stream"], 0.5 ** lv),
                          f"bf16 mask train box P{lv}") for lv in (2, 3)},
        **{f"p{lv}_bwd": (stream_bwd_timing, at_scale(box["stream_bwd"], 0.5 ** lv),
                          f"bf16 mask train box P{lv}") for lv in (2, 3)},
        "train_b8_bwd": (roi_bwd_timing, bf16_caps["train_b8"].roi_bwd[-1],
                         f"bf16 C4 train, batch {BF16_LARGE_BATCH}"),
        **{f"p{lv}_bwd_r{nfg}": (roi_bwd_timing, at_scale(branch["roi_bwd"], 0.5 ** lv),
                                 f"bf16 mask branch P{lv}") for lv in (4, 5)},
        **{f"p{lv}_bwd_r{nfg}": (stream_bwd_timing, at_scale(branch["stream_bwd"], 0.5 ** lv),
                                 f"bf16 mask branch P{lv}") for lv in (2, 3)},
        **{name: (roi_fwd_timing, entry, f"bf16 mask serving, {name.split('_')[2]} head P{name[-1]}")
           for name, entry in mask_serve_calls(bf16_caps["mask_serve"]).items()},
    }
    routes = {roi_fwd_timing: "fwd", roi_bwd_timing: "bwd", stream_fwd_timing: "stream",
              stream_bwd_timing: "stream_bwd"}
    b16 = {k: dict(fn(entry, label), entry=entry, route=routes[fn])
           for k, (fn, entry, label) in b16_entries.items()}
    if args.save_bwd_cases:
        save_cases(args.save_bwd_cases, b16, forward=False)
    if args.save_fwd_cases:
        save_cases(args.save_fwd_cases, b16, forward=True)
    for name, t in b16.items():
        if t["route"] in ("fwd", "stream"):
            t["plan"] = bf16_fwd_plan(t["entry"])
        t["f32_same_inputs_ms"] = f32_same_inputs_ms(t.pop("route"), t.pop("entry"))
    del fpn_serve_cap, mask_cap, cap_in, mtrain_cap, alt_cap, bf16_caps

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
    log(f"[images] stats {json.dumps(images_stats)}")
    log(f"[fpn serve] stats {json.dumps(fpn_serve_stats)}")
    log(f"[mask serve] stats {json.dumps(mask_serve_stats)}")
    log(f"[mask eval] stats {json.dumps(mask_eval_stats)}")
    log(f"[serve] stats {json.dumps(serve_stats)}")
    log(f"[bf16] stats {json.dumps(bf16_stats)}")
    log(f"[vgg] stats {json.dumps(vgg_stats)}")
    log(f"[dp] stats {json.dumps(dp_stats)}")
    log(f"[gate] stats {json.dumps(gate_stats)}")
    log(f"[tools] stats {json.dumps(tools_stats)}")
    log(f"[done] {time.monotonic() - t_start:.1f} s; by phase {phase_seconds(time.monotonic())}")
    def infer_launches(kernel):
        return {"fpn_serve_launches": fpn_serve_launches[kernel],
                "mask_serve_launches": mask_serve_launches[kernel],
                "mask_eval_launches": mask_eval_stats["launches"][kernel],
                "mask_train_launches": mask_launches[kernel]}

    def images_launches(kernel):
        """The [images] runs' launches of a kernel."""
        return {f"images_{run}_launches": images_stats[run]["launches"][kernel]
                for run in ("eval", "train", "demo")}

    stages = alt_stats["stages"]

    def vgg_runs_launches(kernel):
        """The [vgg] runs' launches of a kernel (NMS as reckoned, 2-5 none)."""
        vgg_alt = vgg_stats["alternate"]["stages"]
        return {**{f"vgg_{run}_launches": n[kernel] for run, n in vgg_launches.items()
                   if run != "alternate"},
                "vgg_alternate_launches": sum(st["launches"][kernel] for st in vgg_alt.values())
                + vgg_stats["alternate"]["eval"]["launches"][kernel]}

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

    kernels = [
        {
            "name": "nms", "route": "cuda", "source": "mx_rcnn_tpu_torch/csrc/nms.cu",
            "replaces": "mx_rcnn_tpu/ops/pallas/nms.py:40", "design": "PR 4",
            "ptxas": redesigned["nms"],
            "launches": launches["nms"], "fpn_launches": fpn_launches["nms"],
            "eval_launches": eval_launches["nms"],
            "serve_launches": serve_launches["nms"],
            "serve_engine_launches": engine_launches["nms"],
            "serve_engine_mask_launches": engine_mask_launches["nms"],
            **infer_launches("nms"), **images_launches("nms"),
            "max_abs_err": nms_diff.max_abs_err, "mismatches": nms_diff.mismatches,
            **train_nms, "library_ms": None,
            **_prefixed("serve", serve_nms), **_prefixed("class", classes),
            **_prefixed("fpn", fpn_nms), **_prefixed("fpn_serve_union", fpn_union),
            **_prefixed("fpn_serve_classes", fpn_classes),
            **alt_launches("nms"), **vgg_runs_launches("nms"),
            **_prefixed("proposal_dump", dump_nms),
            "dp_launches": dp_launches["nms"],
            "dp_world2_rank_launches": [r["nms"] for r in dp_stats["world2"]["rank_launches"]],
        },
        {
            "name": "roi_align_fwd", "route": "cuda", "source": "mx_rcnn_tpu_torch/csrc/roi_align.cu",
            "replaces": "mx_rcnn_tpu/ops/pallas/roi_align.py:88", "design": "PR 5",
            "ptxas": redesigned["roi_align_fwd"],
            "launches": launches["roi_align_fwd"], "fpn_launches": fpn_launches["roi_align_fwd"],
            "eval_launches": eval_launches["roi_align_fwd"],
            "serve_launches": serve_launches["roi_align_fwd"],
            "serve_engine_launches": engine_launches["roi_align_fwd"],
            "serve_engine_mask_launches": engine_mask_launches["roi_align_fwd"],
            **infer_launches("roi_align_fwd"), **images_launches("roi_align_fwd"),
            "max_abs_err": roi_err, f"s{RUNTIME_S}_max_abs_err": s5_err, **train_roi,
            "library_ms": None, **_prefixed("serve", serve_roi), **_prefixed("fpn_p4", fpn_roi),
            **_prefixed("p2", resident_p2), **_prefixed("p3", resident_p3),
            **{k: v for lv, e in fpn_serve_roi.items() for k, v in
               _prefixed(f"fpn_serve_{lv}", e).items()},
            **_prefixed("mask_serve_p2", mask_roi), **mask_train_timing("roi_fwd"),
            **alt_launches("roi_align_fwd"), **vgg_runs_launches("roi_align_fwd"),
            **_prefixed("fast_rcnn", alt_roi),
            "dp_launches": dp_launches["roi_align_fwd"],
            "dp_world2_rank_launches": [r["roi_align_fwd"] for r in dp_stats["world2"]["rank_launches"]],
        },
        {
            "name": "roi_align_bwd", "route": "cuda", "source": "mx_rcnn_tpu_torch/csrc/roi_align.cu",
            "replaces": "mx_rcnn_tpu/ops/pallas/roi_align.py:148", "design": "PR 5",
            "ptxas": redesigned["roi_align_bwd"],
            "launches": launches["roi_align_bwd"], "fpn_launches": fpn_launches["roi_align_bwd"],
            "eval_launches": eval_launches["roi_align_bwd"], **infer_launches("roi_align_bwd"),
            **images_launches("roi_align_bwd"),
            "max_abs_err": bwd_diff.max_abs_err, "scaled_err": bwd_diff.scaled_err,
            "bitwise_repeatable": bwd_diff.repeatable,
            f"s{RUNTIME_S}_scaled_err": s5_bwd.scaled_err,
            f"s{RUNTIME_S}_bitwise_repeatable": s5_bwd.repeatable,
            **train_bwd, "library_ms": None,
            **_prefixed("fpn_p4", fpn_bwd), **_prefixed("p2", resident_bwd_p2),
            **mask_train_timing("roi_bwd"),
            **alt_launches("roi_align_bwd"), **vgg_runs_launches("roi_align_bwd"),
            **_prefixed("fast_rcnn", alt_bwd),
            "dp_launches": dp_launches["roi_align_bwd"],
            "dp_world2_rank_launches": [r["roi_align_bwd"] for r in dp_stats["world2"]["rank_launches"]],
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
            **alt_launches("roi_align_stream_fwd"), **vgg_runs_launches("roi_align_stream_fwd"),
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
            **alt_launches("roi_align_stream_bwd"), **vgg_runs_launches("roi_align_stream_bwd"),
        },
        *bf16_kernel_entries(redesigned, bf16_launches, (bf16_fwd, bf16_bwd, bf16_stream), b16,
                             nfg),
    ]
    for entry in kernels:
        if entry["name"] == "roi_align_fwd_bf16":
            entry["serve_engine_launches"] = engine_launches["roi_align_fwd_bf16"]
        # the [gate] and [tools] runs' launches, each counted from 0
        entry["gate_launches"] = {run: n[entry["name"]] for run, n in gate_launches.items()}
        entry["tools_launches"] = {run: n[entry["name"]] for run, n in tools_launches.items()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
