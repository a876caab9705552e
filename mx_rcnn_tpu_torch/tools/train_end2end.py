"""End-to-end Faster R-CNN training CLI (port of
``mx_rcnn_tpu/tools/train_end2end.py``, the flags this slice supports, under
the same names).

    python -m mx_rcnn_tpu_torch.tools.train_end2end --network resnet \\
        --dataset PascalVOC --synthetic 64 --epochs 2 --prefix model/e2e

``--network vgg`` trains VGG-16 (ROIPooling), ``--network resnet_fpn``
ResNet-50 FPN and ``--network mask_resnet_fpn`` (with ``--dataset coco``) Mask R-CNN ResNet-101 FPN, whose
batches carry the gt masks, through the same loop.  The roidb comes from
``utils/load_data.py::load_gt_roidb`` (``--image_set``) with flipped copies
(TRAIN.FLIP, unless ``--no_flip``).  Runs on the card; ``--cpu 1`` runs the
plain PyTorch versions of the kernels on the CPU instead.  Every step runs
through ``fit``'s pipeline: the device feed (``--feed_depth``), the deferred
aux check (``--aux_interval``) and the divergence guard (``--spike_factor``,
``--max_bad_batches``, ``--snapshot_every``, ``--step_timeout``), over a
loader with a failure budget (``--loader_failure_budget``;
``MX_RCNN_ASSEMBLY_WORKERS`` sizes its assembly pool); ``--grad_accum N``
averages N microbatches' gradients into each update.

Checkpoints go under ``--prefix`` (``core/checkpoint.py``): ``run_meta.json``
before training, ``epoch_EEEE`` at each epoch end, ``step_EEEE_BBBBBB`` when
SIGTERM/SIGINT stops the run mid-epoch or the watchdog aborts a hung step
(exit code 75); ``--resume`` continues from the newest restorable dump, and
``tools/test.py --prefix`` evaluates one.  The log, the Speedometer lines
included, goes to standard output (``--metrics_jsonl`` also writes them as
JSON lines); ``--profile DIR`` writes a ``torch.profiler`` trace of steps
10–20.  Without ``--synthetic N`` it reads the config's dataset (VOC or COCO
annotations, JPEG images through the port's decoder); the weights start
seeded random (``--seed``), or with ``--pretrained CKPT`` the backbone and
top head from a torchvision checkpoint (``utils/pretrained.py``), with
torchvision's pixel statistics in the config and its ``run_meta.json``.
``--compute_dtype
bfloat16`` trains the bf16 graph (COMPUTE_DTYPE; FOLD_BN comes from the
config, as in the JAX CLI, which has no flag for it).

Data parallel (``parallel/``): one rank a process, one device a rank.  As
the JAX CLI trains on every device, the CLI starts one rank per local card
(on a one-card machine that is the plain path), and ``--cpu N`` starts N
ranks on the CPU over gloo.  It starts them as subprocesses of this module
(``python -m mx_rcnn_tpu_torch.tools.train_end2end``; a script that calls
:func:`main` after patching this module passes ``rank_command`` to have
each rank run it instead), each with ``--dist_coordinator 127.0.0.1:PORT
--dist_nprocs N --dist_procid i`` (a rendezvous the launching process
hosts), waits for them and returns rank 0's report; a rank that exits with
another code than 0 (or 76) fails the run.  Given those three flags the
process is one rank of a run launched by someone else (other hosts).  The
global batch is ``BATCH_IMAGES × ranks × --grad_accum``.  ``--elastic``
shrinks onto the surviving ranks when ``MX_RCNN_FAULTS``' ``device_lost`` /
``device_wedge`` mark ranks down, and regrows at epoch ends
(``parallel/elastic.py``): a run that ends on fewer ranks than it began
with exits with code 76.  A rank whose process really dies ends the run:
the others raise ``NoSurvivorsError`` (the process group cannot lose a
member).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.checkpoint import tree_checksum
from mx_rcnn_tpu_torch.core.fit import fit
from mx_rcnn_tpu_torch.core.resilience import DEGRADED_EXIT_CODE, DivergencePolicy
from mx_rcnn_tpu_torch.data.loader import load_record_image
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.parallel import distributed
from mx_rcnn_tpu_torch.parallel.mesh import make_mesh
from mx_rcnn_tpu_torch.utils.load_data import load_gt_roidb
from mx_rcnn_tpu_torch.utils.pretrained import (
    apply_pretrained,
    load_state_dict,
    torchvision_pixel_stats,
)
from mx_rcnn_tpu_torch.utils.run_meta import save_run_meta
from mx_rcnn_tpu_torch.utils.precision import full_float32

logger = logging.getLogger(__name__)

# a launched rank writes its report (JSON) as rank<i>.json into this directory
REPORT_ENV = "MX_RCNN_RANK_REPORT"
# what a launched rank runs, before its arguments
RANK_COMMAND = (sys.executable, "-m", "mx_rcnn_tpu_torch.tools.train_end2end")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Faster R-CNN end-to-end (PyTorch port)")
    p.add_argument("--network", default="resnet",
                   choices=["vgg", "resnet", "resnet50", "resnet152", "resnet_fpn",
                            "mask_resnet_fpn"])
    p.add_argument("--dataset", default="PascalVOC", choices=["PascalVOC", "PascalVOC0712", "coco"])
    p.add_argument("--image_set", default=None)
    p.add_argument("--prefix", default="model/e2e", help="checkpoint dir")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--batch_images", type=int, default=None, help="images per microbatch")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer update (gradient accumulation for big "
                        "effective batches)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--pretrained", default=None, metavar="CKPT",
                   help="torchvision checkpoint (.pth/.pt/.npz/pickle) for the backbone and top "
                        "head; sets the torchvision pixel statistics")
    p.add_argument("--compute_dtype", default=None, choices=["float32", "bfloat16"],
                   help="override network COMPUTE_DTYPE (bfloat16 activations, float32 "
                        "parameters, gradients and optimizer state)")
    p.add_argument("--no_flip", action="store_true")
    p.add_argument("--no_shuffle", action="store_true")
    p.add_argument("--frequent", type=int, default=20, help="logging interval")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic images (no dataset needed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop after N steps (smoke runs; the unfinished epoch is not saved)")
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="run on the CPU (the plain versions of the kernels) instead of the "
                        "card, as N data-parallel ranks over gloo")
    p.add_argument("--elastic", action="store_true",
                   help="survive injected device loss: on a device fault, take an "
                        "emergency checkpoint, shrink to the surviving ranks, replay the "
                        "in-flight window and keep training (regrow is tried at epoch ends); a "
                        "run that finishes shrunken exits 76; a rank process that dies ends "
                        "the run (NoSurvivorsError)")
    p.add_argument("--dist_coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process training: rank 0's rendezvous address")
    p.add_argument("--dist_nprocs", type=int, default=None,
                   help="multi-process training: the number of ranks")
    p.add_argument("--dist_procid", type=int, default=None,
                   help="multi-process training: this process's rank")
    p.add_argument("--metrics_jsonl", default=None, metavar="PATH",
                   help="append one JSON line of metrics per logging interval (structured twin "
                        "of the Speedometer log)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of steps 10-20 to DIR/trace.json")
    # resilience (core/resilience.py): divergence recovery + hang watchdog
    p.add_argument("--step_timeout", type=float, default=0.0, metavar="SECS",
                   help="wall-clock watchdog per train step: a step that exceeds this dumps a "
                        "resumable checkpoint and exits with code 75 instead of hanging (0 = off)")
    p.add_argument("--snapshot_every", type=int, default=10, metavar="N",
                   help="refresh the guarded loop's rollback snapshot every N accepted steps "
                        "(1 = exact rollback)")
    p.add_argument("--spike_factor", type=float, default=20.0,
                   help="treat a step as diverged when its loss exceeds this multiple of the "
                        "running EMA")
    p.add_argument("--max_bad_batches", type=int, default=8,
                   help="abort (TrainingDiverged) after this many batches are skipped via "
                        "rollback")
    p.add_argument("--loader_failure_budget", type=int, default=None,
                   help="abort after this many records fail to load (default: max(32, 1%% of "
                        "the roidb))")
    # step pipeline (core/pipeline.py): device feed + K-late aux fetch
    p.add_argument("--feed_depth", type=int, default=2, metavar="N",
                   help="device-feed depth: batches staged on the device ahead of the step")
    p.add_argument("--aux_interval", type=int, default=0, metavar="K",
                   help="fetch train aux every K steps instead of every step (divergence "
                        "checks run K late against the retained window snapshot); 0 = auto: "
                        "1 on the CPU, 8 on the card")
    return p.parse_args(argv)


def train_net(args) -> Dict:
    """One rank's run (the whole run in one process): returns ``fit``'s
    result."""
    backend = distributed.initialize(args.dist_coordinator, args.dist_nprocs, args.dist_procid,
                                     cpu=bool(args.cpu))
    try:
        return _train(args)
    finally:
        if backend is not None:
            distributed.shutdown()


def _train(args) -> Dict:
    cfg = generate_config(args.network, args.dataset)
    overrides = {}
    if args.lr is not None:
        overrides["LEARNING_RATE"] = args.lr
    if args.batch_images is not None:
        overrides["BATCH_IMAGES"] = args.batch_images
    if args.no_shuffle:
        overrides["SHUFFLE"] = False
    if overrides:
        cfg = cfg.replace(TRAIN=dataclasses.replace(cfg.TRAIN, **overrides))
    net_overrides = {}
    if args.compute_dtype:
        net_overrides["COMPUTE_DTYPE"] = args.compute_dtype
    if args.pretrained:
        # torchvision checkpoints expect their own pixel statistics
        net_overrides["PIXEL_MEANS"], net_overrides["PIXEL_STDS"] = torchvision_pixel_stats()
    if net_overrides:
        cfg = cfg.replace(network=dataclasses.replace(cfg.network, **net_overrides))
    ranks = distributed.process_count()
    logger.info("ranks=%d (%s) per_rank_batch=%d grad_accum=%d global_batch=%d", ranks,
                distributed.backend() or "one process", cfg.TRAIN.BATCH_IMAGES, args.grad_accum,
                cfg.TRAIN.BATCH_IMAGES * ranks * args.grad_accum)
    _, roidb = load_gt_roidb(cfg, args.image_set, flip=cfg.TRAIN.FLIP and not args.no_flip,
                             synthetic_size=args.synthetic)
    logger.info("roidb size: %d", len(roidb))
    if not args.synthetic:
        # an unreadable dataset (missing files, another format) fails at its
        # first image here rather than spend the loader's failure budget
        load_record_image(roidb[0])
    model = build_model(cfg, generator=torch.Generator().manual_seed(args.seed))
    if args.pretrained:
        net = cfg.network
        apply_pretrained(model, load_state_dict(args.pretrained), net.name, net.depth,
                         fpn=net.USE_FPN)
        logger.info("imported pretrained backbone from %s", args.pretrained)
    if distributed.is_main():
        save_run_meta(args.prefix, cfg)
    return fit(
        model, cfg, roidb, epochs=args.epochs, seed=args.seed, max_steps=args.max_steps,
        frequent=args.frequent, device="cpu" if args.cpu else None,
        mesh=make_mesh() if ranks > 1 else None, elastic=args.elastic,
        guard_policy=DivergencePolicy(spike_factor=args.spike_factor,
                                      max_bad_batches=args.max_bad_batches),
        step_timeout=args.step_timeout, snapshot_every=args.snapshot_every,
        aux_interval=args.aux_interval or (1 if args.cpu else 8),
        feed_depth=args.feed_depth, loader_failure_budget=args.loader_failure_budget,
        prefix=args.prefix, resume=args.resume, accum_steps=args.grad_accum,
        metrics_jsonl=args.metrics_jsonl, profile=args.profile,
    )


def ranks_to_launch(args) -> int:
    """How many rank processes this invocation starts: none when it is a
    rank itself (``--dist_*``) or the run has one device, else ``--cpu N``'s
    N or the local card count."""
    if args.dist_coordinator is not None or args.dist_nprocs is not None \
            or args.dist_procid is not None:
        return 0
    if args.cpu:
        return args.cpu if args.cpu > 1 else 0
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return count if count > 1 else 0


def _rank_report(out: Dict) -> Dict:
    """``fit``'s result as JSON, with the final state's checksum."""
    report = {k: v for k, v in out.items() if k != "state"}
    report["state_checksum"] = tree_checksum(out["state"].state_tree())
    return report


def _as_tuples(report: Dict) -> Dict:
    for k in ("begin", "stopped_at"):
        if report.get(k) is not None:
            report[k] = tuple(report[k])
    return report


def launch_ranks(argv: List[str], n: int, command: Sequence[str] = RANK_COMMAND) -> Dict:
    """Start ``n`` ranks of this run on this host (``command`` + ``argv`` +
    ``--dist_*``), forward SIGTERM / SIGINT to them, wait, and return rank
    0's report with every rank's under ``ranks``.  A rank that fails stops
    the others and the run."""
    store, coordinator = distributed.host_rendezvous(n)
    report_dir = tempfile.mkdtemp(prefix="train-ranks-")
    # the ranks import this package from where this process found it
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, **{REPORT_ENV: report_dir, "LOCAL_WORLD_SIZE": str(n),
                              distributed.HOSTED_STORE_ENV: "1"})
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    logger.info("starting %d ranks: %s ... --dist_coordinator %s", n, " ".join(command),
                coordinator)
    procs: List[subprocess.Popen] = []

    def forward(signum, _frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    old = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for i in range(n):
            procs.append(subprocess.Popen([*command, *argv, "--dist_coordinator", coordinator,
                                           "--dist_nprocs", str(n), "--dist_procid", str(i)],
                                          env=env))
        while any(p.poll() is None for p in procs):
            failed = [(i, p.returncode) for i, p in enumerate(procs)
                      if p.returncode not in (None, 0, DEGRADED_EXIT_CODE)]
            if failed:
                raise RuntimeError(f"rank {failed[0][0]} exited with code {failed[0][1]}")
            time.sleep(0.1)
        failed = [(i, p.returncode) for i, p in enumerate(procs)
                  if p.returncode not in (0, DEGRADED_EXIT_CODE)]
        if failed:
            raise RuntimeError(f"rank {failed[0][0]} exited with code {failed[0][1]}")
        reports = []
        for i in range(n):
            with open(os.path.join(report_dir, f"rank{i}.json")) as f:
                reports.append(_as_tuples(json.load(f)))
        return dict(reports[0], ranks=reports)
    finally:
        for s, h in old.items():
            signal.signal(s, h)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store
        shutil.rmtree(report_dir, ignore_errors=True)


def main(argv: Optional[List[str]] = None,
         rank_command: Sequence[str] = RANK_COMMAND) -> Dict:
    """Run the CLI: returns the report (rank 0's when it starts ranks), or
    exits with :data:`DEGRADED_EXIT_CODE` when an elastic run ended on fewer
    ranks than it began with.  Ranks it starts run ``rank_command`` (this
    module; a script that patched it passes itself)."""
    full_float32()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    rank = f"[rank {args.dist_procid}] " if args.dist_procid is not None else ""
    logging.basicConfig(level=logging.INFO, format=f"%(asctime)s {rank}%(message)s",
                        stream=sys.stdout)
    n = ranks_to_launch(args)
    if n:
        report = launch_ranks(argv, n, rank_command)
    else:
        report = train_net(args)
        report_dir = os.environ.get(REPORT_ENV)
        if report_dir:
            with open(os.path.join(report_dir, f"rank{args.dist_procid or 0}.json"), "w") as f:
                json.dump(_rank_report(report), f)
    if report.get("degraded"):
        # the run finished, but on fewer ranks: a scheduler may rerun it whole
        sys.exit(DEGRADED_EXIT_CODE)
    return report


if __name__ == "__main__":
    main()
