"""The training loop (port of ``mx_rcnn_tpu/core/fit.py``): a prefetching
or pooled :class:`TrainLoader` → :class:`DeviceFeed` (batch N+1 copied to
the card on its own stream while step N runs) → :class:`PipelinedLoop`
(every step guarded against a NaN or spiking loss, the aux check
``aux_interval`` steps late) → metrics, with checkpoints at epoch ends, on a
preemption signal and from the watchdog (``core/checkpoint.py``), and resume.
One loop serves every graph: FasterRCNN, FPN and the stage models of
alternate training (``models/stage_models.py``), whose batches carry the
proposal roidb's ``proposals`` (``proposal_count``) and whose init may take
subtrees of an earlier stage's tree (``init_donor``, :func:`merge_params`).
With a data-parallel ``mesh`` (``parallel/mesh.py``) every rank runs this loop
on its rows of each global batch, and with ``elastic`` it shrinks onto the
ranks the fault injector leaves up and regrows at epoch ends
(``parallel/elastic.py``; a rank whose process dies ends the run).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.checkpoint import (
    PreemptionGuard,
    load_restorable,
    prune_step_checkpoints,
    save_checkpoint,
)
from mx_rcnn_tpu_torch.core.metrics import MetricTracker, Speedometer
from mx_rcnn_tpu_torch.core.pipeline import DeviceFeed, PipelinedLoop, make_place_fn
from mx_rcnn_tpu_torch.core.resilience import DivergencePolicy, StepWatchdog
from mx_rcnn_tpu_torch.core.tester import resolve_device
from mx_rcnn_tpu_torch.core.train import (
    create_train_state,
    make_lr_schedule,
    make_optimizer,
    train_step,
)
from mx_rcnn_tpu_torch.data.loader import TrainLoader
from mx_rcnn_tpu_torch.parallel import distributed
from mx_rcnn_tpu_torch.parallel.elastic import ElasticLoop, make_elastic_factory
from mx_rcnn_tpu_torch.parallel.mesh import make_parallel_train_step, replicate
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch
from mx_rcnn_tpu_torch.utils.precision import full_float32

logger = logging.getLogger(__name__)

# the steps a ``profile`` trace covers: from the 10th step done to the 20th
PROFILE_STEPS = (10, 20)

# data parallel: the ranks vote on a preemption stop every this many steps
# (the same steps on every rank), so a signal that reached some ranks stops
# all of them at one step
STOP_VOTE_EVERY = 10


def merge_params(model: nn.Module, donor: Dict) -> nn.Module:
    """Load into ``model`` the top-level subtrees (``backbone``,
    ``top_head``, ``rpn``, ``rcnn``) of the Flax tree ``donor`` that the
    model also has, leaving its other tensors as they are: the stage models
    share those names, so an RPN stage's tree seeds a Fast R-CNN init, and
    the other way round, on their intersection."""
    own = {k.split(".")[0] for k in model.state_dict()}
    return flax_to_torch({k: v for k, v in donor.items() if k in own}, model, partial=True)


def batch_digest(batch: Dict[str, np.ndarray]) -> str:
    """Order-stable sha256 over a host batch's keys and array bytes: one
    digest line per consumed batch shows that two runs trained on the same
    data, in order, with no gaps and no repeats."""
    h = hashlib.sha256()
    for k in sorted(batch):
        arr = np.asarray(batch[k])
        h.update(k.encode())
        h.update(f"{arr.dtype}{arr.shape}".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class _Digested:
    """``(digest, batch)`` pairs of a host batch stream (digest None unless
    asked for: it is taken on the feed's worker, off the step's thread);
    ``close`` closes the stream."""

    def __init__(self, batches, digest: bool):
        self._batches = batches
        self._digest = digest

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._batches)
        return (batch_digest(batch) if self._digest else None), batch

    def close(self) -> None:
        self._batches.close()


def _profiler(dev):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _write_profile(prof, out_dir: str) -> str:
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def fit(
    model: nn.Module,
    cfg: Config,
    roidb: List[Dict],
    *,
    epochs: int,
    seed: int = 0,
    max_steps: int = 0,
    frequent: int = 20,
    device=None,
    init_donor: Optional[Dict] = None,
    fixed_params: Optional[Sequence[str]] = None,
    proposal_count: int = 0,
    guard_policy: Optional[DivergencePolicy] = None,
    step_timeout: float = 0.0,
    snapshot_every: int = 1,
    aux_interval: int = 1,
    feed_depth: int = 2,
    prefetch: int = 2,
    assembly_workers: Optional[int] = None,
    loader_failure_budget: Optional[int] = None,
    prefix: Optional[str] = None,
    resume: bool = False,
    stream_log: Optional[str] = None,
    accum_steps: int = 1,
    metrics_jsonl: Optional[str] = None,
    profile: Optional[str] = None,
    mesh=None,
    elastic: bool = False,
) -> Dict:
    """Train ``model`` in place on ``device`` (default: the card, which must
    be present).  The model starts from its own weights, except for the
    top-level subtrees of the Flax tree ``init_donor`` (numpy leaves) that
    it shares, which replace its own (:func:`merge_params`: a whole tree,
    an earlier stage's tree, or a pretrained backbone).  ``fixed_params``
    overrides the freeze set (``make_optimizer``; FIXED_PARAMS_SHARED in
    the later stages of alternate training).  ``proposal_count`` > 0 gives every batch the
    records' ``proposals`` / ``prop_valid`` padded to that count (Fast
    R-CNN, FPN's frozen mode).

    Every step runs under a :class:`PipelinedLoop` (``guard_policy``
    overrides the divergence defaults; ``snapshot_every`` is the guard's
    snapshot period): a NaN/Inf or spiking loss is retried with LR backoff,
    then rolled back and the poison batch skipped.  Batches come from a
    :class:`TrainLoader` (``prefetch`` batches ahead on a thread, or
    ``assembly_workers`` pool workers; None → ``MX_RCNN_ASSEMBLY_WORKERS``;
    ``loader_failure_budget``) through a :class:`DeviceFeed` of depth
    ``feed_depth``.  ``aux_interval`` > 1 defers the aux fetch K steps
    (flushed at each epoch end).  ``accum_steps`` > 1 takes batches of
    ``accum_steps × BATCH_IMAGES`` images and averages the microbatches'
    gradients into one update (``train_step``).  ``stream_log`` appends one
    ``epoch batch digest`` line per consumed batch; ``metrics_jsonl`` one
    JSON line per Speedometer log; ``profile`` writes a ``torch.profiler``
    trace of steps 10–20 (:data:`PROFILE_STEPS`) to ``profile/trace.json``,
    or of the steps from the 10th to the end of a shorter run.

    ``prefix`` turns on checkpoints (``core/checkpoint.py``): each epoch end
    flushes the loop, saves ``epoch_{E+1}`` and prunes the superseded step
    dumps; a :class:`PreemptionGuard` is installed while the loop runs, and
    SIGTERM/SIGINT flushes the loop, saves a committed ``step_E_B`` dump and
    returns.  A stop at ``max_steps`` saves nothing.  ``step_timeout`` > 0
    arms a watchdog that aborts a hung step with exit code 75, after saving
    the loop's last snapshot at the stream position it stands for, from the
    snapshot's host mirror (``TrainState.mirror_snapshots``: a hung card is
    never read).
    ``resume=True`` restores the newest restorable dump under ``prefix`` (the
    weights, momentum and update count) and continues the batch stream where
    it stopped (the loader's per-(seed, epoch) plan and ``skip_batches``).

    ``mesh`` (a ``parallel/mesh.py::DataMesh``; its device replaces
    ``device``): data parallel.  A step takes ``BATCH_IMAGES × accum_steps ×
    mesh.size`` images; the loader plans the global batches and loads this
    rank's rows, the DP step (``make_parallel_train_step``) all-reduces the
    gradients, and the state starts equal on every rank (``replicate``).
    Only rank 0 writes checkpoints, ``metrics_jsonl``, ``stream_log`` and
    the profile; a resume takes rank 0's choice of dump and its restored
    state on every rank; the ranks vote on a preemption stop every
    :data:`STOP_VOTE_EVERY` steps.  ``elastic`` runs the steps under
    ``parallel/elastic.py::ElasticLoop``: every rank loads the base-size
    global batch, a device fault shrinks the set (the lowest survivor writes
    an emergency dump and, while the run is degraded, the epoch saves) and
    each epoch end may regrow it.

    Returns ``{"steps": consumed batches, "history": [...], ...}``: one
    history dict per verified step, in stream order, with the aux metrics,
    ``loss``, ``index`` (its stream position), ``wait_ms`` (the step
    thread's wait for the batch) and, at ``aux_interval`` 1, ``step_ms``
    (host clock from the batch in hand to its metrics on the host);
    ``dispatched_steps`` (step calls, replays and retries included);
    ``pipeline`` (the loop's ``stats()``), ``loader`` (its ``stats()``: the
    fault counters and, when pooled, the assembly pool's), ``feed`` (each
    epoch's feed ``stats()``); ``clock`` (``step_start``: host clock at each
    batch request; ``end``: after the last flush, on a card after a
    synchronisation); ``state`` (the final ``TrainState``); ``begin`` (the
    (epoch, batch) the run started from); ``preempted`` and ``stopped_at``
    (the (epoch, batch) of a preemption's dump, else None); ``saves`` (one
    dict per dump: ``path``, ``epoch``, ``batch``, ``seconds``, ``bytes``,
    ``at``, the host clock at its commit); with a mesh ``rank``, and with
    ``elastic`` ``elastic`` (the loop's ``stats()``) and ``degraded`` (the
    run ended on fewer ranks than it began with)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    elastic = elastic and mesh is not None
    rank = distributed.process_index()
    full_float32()
    if init_donor is not None:
        merge_params(model, init_donor)
    # channels_last: the NHWC images and pooled rois enter the convs as views
    model.to(dev, memory_format=torch.channels_last).train()
    # the global batch: every rank's microbatches
    images_per_step = cfg.TRAIN.BATCH_IMAGES * accum_steps * (mesh.size if mesh is not None else 1)
    rows = None
    if mesh is not None and not elastic:
        rows = distributed.process_slice(images_per_step, rank=mesh.position, world=mesh.size)
    loader = TrainLoader(
        roidb, cfg, images_per_step, shuffle=cfg.TRAIN.SHUFFLE, seed=seed,
        prefetch=prefetch, failure_budget=loader_failure_budget,
        assembly_workers=assembly_workers, proposal_count=proposal_count, row_slice=rows,
    )
    optimizer = make_optimizer(cfg, model, make_lr_schedule(cfg, max(len(loader), 1)),
                               fixed_params)
    state = create_train_state(model, optimizer)
    rng = seed + 123
    dispatched = 0
    saves: List[Dict] = []

    def counted(step):
        def step_fn(state, batch, rng, lr_scale=None):
            nonlocal dispatched
            dispatched += 1
            return step(state, batch, rng, lr_scale)
        return step_fn

    if mesh is None:
        step_fn = counted(lambda state, batch, rng, lr_scale: train_step(
            state, batch, rng, lr_scale, accum_steps=accum_steps))
    elif not elastic:
        dp_step = make_parallel_train_step(mesh, accum_steps)
        step_fn = counted(lambda state, batch, rng, lr_scale: dp_step(state, batch, rng, lr_scale))
    eloop = None

    def writer() -> bool:
        """Whether this rank writes the run's dumps: rank 0, or while an
        elastic run is degraded the lowest active rank."""
        if eloop is not None:
            return rank == mesh.ranks[min(eloop.active)]
        return rank == 0

    def save(epoch: int, batch: int, tree=None, meta=None) -> str:
        t0 = time.perf_counter()
        path = save_checkpoint(prefix, state if tree is None else tree, epoch, batch, meta=meta)
        t1 = time.perf_counter()
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        saves.append({"path": path, "epoch": epoch, "batch": batch, "seconds": t1 - t0,
                      "bytes": nbytes, "at": t1})
        logger.info("checkpoint -> %s (%d bytes, %.3f s)", path, nbytes, t1 - t0)
        return path

    # (stream index, epoch, batch) of each epoch's first step: the loops
    # number the steps one by one, so an index maps to its stream position
    starts: List[Tuple[int, int, int]] = []

    def position(index: int) -> Tuple[int, int]:
        """The (epoch, batch) a stream index stands for."""
        first, epoch, batch = max(s for s in starts if s[0] <= index)
        return epoch, batch + index - first

    def watchdog_dump():
        got = pipeline.snapshot_for_dump() if prefix and writer() else None
        if got is None:
            return None
        index, tree = got
        # named at the position the snapshot stands for, so a resume
        # consumes the steps since then again
        return save(*position(index), tree)

    def emergency_dump(anchor, index, meta):
        if not prefix or not writer():
            return None
        tree = anchor.tree() if hasattr(anchor, "tree") else anchor
        return save(*position(index), tree, meta=meta)

    watchdog = StepWatchdog(step_timeout, dump_fn=watchdog_dump) if step_timeout > 0 else None
    if elastic:
        make_ctx = make_elastic_factory(ranks=mesh.ranks, device=dev, accum_steps=accum_steps)

        def factory(active):
            ctx = make_ctx(active)
            if ctx.step_fn is None:
                return ctx
            return dataclasses.replace(ctx, step_fn=counted(ctx.step_fn))

        eloop = ElasticLoop(factory, mesh.size, policy=guard_policy, watchdog=watchdog,
                            aux_interval=aux_interval, checkpoint_fn=emergency_dump)
        pipeline = eloop.pipe
        # host batches: the loop keeps the survivors' prefix and places it
        place = lambda batch: batch  # noqa: E731
    else:
        pipeline = PipelinedLoop(
            step_fn, policy=guard_policy, snapshot_every=snapshot_every, watchdog=watchdog,
            aux_interval=aux_interval,
        )
        place = make_place_fn(dev, mesh=mesh)
    step_loop = eloop if eloop is not None else pipeline
    main = rank == 0
    tracker = MetricTracker()
    speedo = Speedometer(images_per_step, frequent, jsonl_path=metrics_jsonl if main else None)
    history: List[Dict[str, float]] = []
    timing: Dict[int, Dict[str, float]] = {}
    step_start: List[float] = []
    feed_stats = []

    def deliver(ready):
        for idx, aux in ready:
            vals = {k: float(v) for k, v in aux.items()}
            vals.update(index=idx, **timing.pop(idx, {}))
            history.append(vals)
            tracker.update(vals)

    log_f = open(stream_log, "a") if stream_log and main else None
    guard = prof = None
    total_steps = 0
    begin_epoch = begin_batch = 0
    stopped_at = None
    try:
        if prefix and resume:
            # the ranks may see other dumps (per-host disks): rank 0 picks,
            # and its restored state reaches every rank below
            got = load_restorable(prefix, state) if main else None
            at = distributed.broadcast_ints(got[0] if got is not None else (-1, -1))
            if at != (-1, -1):
                begin_epoch, begin_batch = at
                logger.info("fit: resuming from epoch %d batch %d", begin_epoch, begin_batch)
        loader.epoch, loader.skip_batches = begin_epoch, begin_batch
        if eloop is not None:
            state = eloop.ctx.place_state(state)
        elif mesh is not None:
            state = replicate(state, mesh)
        if watchdog is not None and prefix:
            state.mirror_snapshots()  # a watchdog dump must read no device memory
        if prefix:
            guard = PreemptionGuard()
        for epoch in range(begin_epoch, epochs):
            batches = iter(loader)
            feed = DeviceFeed(_Digested(batches, log_f is not None),
                              place_fn=lambda item: (item[0], place(item[1])),
                              depth=feed_depth, device=dev)
            try:
                # position in the epoch's plan (a resume skips begin_batch)
                pos = begin_batch if epoch == begin_epoch else 0
                starts.append((pipeline.next_index, epoch, pos))
                while True:
                    t0 = time.perf_counter()
                    item = next(feed, None)
                    if item is None:
                        break
                    t1 = time.perf_counter()
                    step_start.append(t0)
                    digest, batch = item
                    if log_f is not None:
                        log_f.write(f"{epoch} {pos} {digest}\n")
                        log_f.flush()
                    if profile and main and total_steps == PROFILE_STEPS[0]:
                        prof = _profiler(dev)
                    idx = pipeline.next_index
                    timing[idx] = {"wait_ms": (t1 - t0) * 1e3}
                    state, ready, _ok = step_loop.step(state, batch, rng)
                    if aux_interval <= 1:
                        timing[idx]["step_ms"] = (time.perf_counter() - t1) * 1e3
                    deliver(ready)
                    total_steps += 1
                    pos += 1
                    if prof is not None and total_steps == PROFILE_STEPS[1]:
                        logger.info("profiler trace -> %s", _write_profile(prof, profile))
                        prof = None
                    speedo(epoch, total_steps, tracker)
                    if stop_agreed(guard, total_steps):
                        stopped_at = (epoch, pos)
                        break
                    if max_steps and total_steps >= max_steps:
                        break
            finally:
                feed.close()
                feed_stats.append(feed.stats())
            # a divergence inside the window must roll back before any save
            state, ready, _ok = step_loop.flush(state)
            deliver(ready)
            if stopped_at is not None:
                if writer():
                    save(*stopped_at)
                logger.warning("fit: preempted at epoch %d batch %d", *stopped_at)
                break
            if max_steps and total_steps >= max_steps:
                break
            if prefix and writer():
                save(epoch + 1, 0)
                prune_step_checkpoints(prefix, epoch)
            if eloop is not None:
                # regrow only here: the save above is what a failed regrow
                # would fall back to
                state, _ = eloop.checkpoint_boundary(state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        end = time.perf_counter()  # before the assembly processes shut down
    finally:
        if guard is not None:
            guard.uninstall()
        if prof is not None:  # the run ended inside the window: write what it has
            logger.info("profiler trace (short run) -> %s", _write_profile(prof, profile))
        loader_stats = loader.stats()
        loader.close()
        if log_f is not None:
            log_f.close()
    last_loss = pipeline.last_loss if total_steps else float("nan")
    logger.info("fit done: %d steps, last loss %.4f", total_steps, last_loss)
    if pipeline.skipped_batches or loader.record_failures:
        logger.warning(
            "fit skipped %d poison batch(es) after rollback (%d retried steps); %d record(s) "
            "failed to load", pipeline.skipped_batches, pipeline.retried_steps,
            loader.record_failures,
        )
    if total_steps and not math.isfinite(last_loss):
        logger.warning("fit finished with a non-finite loss")
    out = {
        "steps": total_steps, "history": history, "dispatched_steps": dispatched,
        "pipeline": pipeline.stats(), "loader": loader_stats, "feed": feed_stats,
        "clock": {"step_start": step_start, "end": end}, "state": state,
        "begin": (begin_epoch, begin_batch), "preempted": stopped_at is not None,
        "stopped_at": stopped_at, "saves": saves,
    }
    if mesh is not None:
        out["rank"] = rank
    if eloop is not None:
        st = eloop.stats()
        if st["shrinks"]:
            logger.warning(
                "elastic summary: %d shrink(s), %d regrow(s), %d emergency checkpoint(s), %d "
                "step(s) replayed, %.2f s of recovery; final set %d/%d replicas", st["shrinks"],
                st["regrows"], st["emergency_checkpoints"], st["replayed_steps"],
                st["recovery_s"], st["active_replicas"], st["base_replicas"])
        out.update(elastic=st, degraded=eloop.degraded)
    return out


def stop_agreed(guard: Optional[PreemptionGuard], step: int) -> bool:
    """Whether the run stops for a preemption signal after ``step`` steps.
    In one process, as soon as the signal came; with several ranks they
    vote every :data:`STOP_VOTE_EVERY` steps (any rank's signal stops all
    of them at that step), so none is left waiting in a collective."""
    if guard is None:
        return False
    if distributed.process_count() == 1:
        return guard.should_stop
    if step % STOP_VOTE_EVERY:
        return False
    return distributed.any_rank(guard.should_stop)
