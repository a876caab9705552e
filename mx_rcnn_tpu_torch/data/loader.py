"""Train and test batches: roidb → padded numpy batches (port of
``mx_rcnn_tpu/data/loader.py``).

Images are resized into shape buckets and gt boxes padded to MAX_GT_BOXES;
anchor targets and roi sampling happen in the model.  Batches are drawn
from one orientation bucket at a time (the reference's aspect grouping), in
a plan that depends only on (seed, epoch), so the batch order equals the
JAX loader's for the same seed.

The loader assembles ahead of the consumer: a prefetch thread
(:class:`PrefetchIterator`) or an ordered pool of assembly processes
(``data/assembler.py``), whose streams are bit-identical to the serial one.
A record that fails to load is retried, then its slot is filled with the
batch's first good record, within a failure budget.  :class:`TestLoader`
yields eval batches (uint8 images under TEST.UINT8_TRANSFER, with each
image's pre-resize ``orig_hw``), one image at a time or same-bucket batches
from a prefetch thread or the same kind of pool.  This module imports no
torch, so an assembly process starts quickly.
"""

from __future__ import annotations

import logging
import os
import queue
import signal
import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.data.assembler import AssemblyPool, default_assembly_workers
from mx_rcnn_tpu_torch.data.image import load_image, prepare_image
from mx_rcnn_tpu_torch.data.masks import record_gt_masks
from mx_rcnn_tpu_torch.data.synthetic import synthetic_image
from mx_rcnn_tpu_torch.utils import faults
from mx_rcnn_tpu_torch.utils.retry import RetryPolicy, make_retry_policy

logger = logging.getLogger(__name__)


class LoaderFaultBudgetExceeded(RuntimeError):
    """More records failed to load than the configured budget: aborting so
    silent data loss cannot pass for training."""


class _RenderLRU:
    """Locked LRU of rendered (or prepared) images.  Bounds the cache's
    memory (cap via ``MX_RCNN_RENDER_CACHE`` / ``MX_RCNN_PREPARED_CACHE``)
    while keeping sets that revisit the same images every epoch cached."""

    def __init__(self, max_entries: int):
        self.max_entries = max(0, int(max_entries))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        with self._lock:
            im = self._entries.get(key)
            if im is None:
                self.misses += 1
            else:
                self._entries.move_to_end(key)
                self.hits += 1
            return im

    def put(self, key, im) -> None:
        if self.max_entries <= 0:
            return
        with self._lock:
            self._entries[key] = im
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.evictions = 0


_RENDER_CACHE = _RenderLRU(int(os.environ.get("MX_RCNN_RENDER_CACHE", "1024")))

# Prepared-canvas LRU: the (padded image, im_info) pair after resize,
# normalization and padding.  Keyed by the record and every input of the
# prep math, so a hit is bit-identical to recomputation.  Off by default
# (0 entries): a train stream with flips rarely revisits a key before
# eviction; opt in with MX_RCNN_PREPARED_CACHE or set_prepared_cache.
_PREPARED_CACHE = _RenderLRU(int(os.environ.get("MX_RCNN_PREPARED_CACHE", "0")))


def set_prepared_cache(max_entries: int) -> None:
    """Resize (and clear) the prepared-canvas LRU at run time."""
    _PREPARED_CACHE.clear()
    _PREPARED_CACHE.max_entries = max(0, int(max_entries))


def _render_key(rec: Dict) -> Tuple:
    """A synthetic render is a function of the record's uri, flip, seed,
    size, boxes, classes and polygons (``synthetic_image``): two roidbs may
    give one uri two sizes, other boxes or classes (another class count), or
    one with boxes and one with polygon masks."""
    segms = rec.get("segmentation")
    return (rec["image"], bool(rec.get("flipped")), rec["synthetic_seed"],
            int(rec["height"]), int(rec["width"]),
            np.asarray(rec["boxes"], np.float32).tobytes(),
            np.asarray(rec["gt_classes"], np.int64).tobytes(),
            None if segms is None else repr(segms))


def _prepared_key(rec: Dict, scales, bucket, uint8: bool, means, stds) -> Tuple:
    """The record and every input of the prep math (a uint8 canvas is not
    normalized, so the pixel statistics are not part of its key)."""
    base = _render_key(rec) if "synthetic_seed" in rec else (rec["image"], bool(rec.get("flipped")))
    norm = None if uint8 else (tuple(np.ravel(means).tolist()), tuple(np.ravel(stds).tolist()))
    return base + (tuple(scales), tuple(bucket), uint8, norm)


def load_record_image(rec: Dict) -> np.ndarray:
    """The record's RGB float32 pixels.  Synthetic records render from their
    own (already flipped) geometry, through the render LRU (read-only
    downstream: ``prepare_image`` copies); image files are decoded
    (``data/image.py::load_image``) and mirrored when the record is
    flipped, as the JAX loader does."""
    if str(rec["image"]).startswith("synthetic://"):
        key = _render_key(rec)
        im = _RENDER_CACHE.get(key)
        if im is None:
            im = synthetic_image(rec, rec["synthetic_seed"])
            _RENDER_CACHE.put(key, im)
        return im
    im = load_image(rec["image"])
    if rec.get("flipped"):
        im = im[:, ::-1]
    return im


def make_batch(
    records: Sequence[Dict],
    cfg: Config,
    bucket: Tuple[int, int],
    seeds: Optional[Sequence[int]] = None,
    images: Optional[Sequence[np.ndarray]] = None,
    uint8_images: bool = False,
    with_masks: bool = False,
    proposal_count: int = 0,
) -> Dict[str, np.ndarray]:
    """One padded batch: normalized images in ``bucket`` (or, with
    ``uint8_images``, the resized pixels quantized to uint8, which the model
    normalizes on the device: TEST.UINT8_TRANSFER), im_info, gt boxes scaled
    by the resize factor and padded to MAX_GT_BOXES, and, with ``seeds``,
    the per-image sampling seeds.  ``images`` gives the records' pixels (the
    loader's guarded loads); without it they load here, through the
    prepared-canvas cache when it is on.  ``with_masks`` adds ``gt_masks``
    (n, MAX_GT_BOXES, M, M) uint8 box-frame bitmaps (M = TRAIN.MASK_GT_SIZE,
    ``data/masks.py::record_gt_masks``); a record without ``segmentation``
    gets all ones (rectangle targets).  The bitmaps are box-relative, so
    the resize does not touch them.  ``proposal_count`` > 0 adds
    ``proposals`` (n, proposal_count, 4), each record's ``proposals``
    scaled by the resize factor and cut to the count, and ``prop_valid``
    (n, proposal_count) (Fast R-CNN batches from a proposal roidb, the
    reference's ``get_rcnn_batch``)."""
    target, max_size = cfg.dataset.SCALES[0]
    g = cfg.dataset.MAX_GT_BOXES
    n = len(records)
    bh, bw = bucket
    out_images = np.zeros((n, bh, bw, 3), np.uint8 if uint8_images else np.float32)
    im_info = np.zeros((n, 3), np.float32)
    gt_boxes = np.zeros((n, g, 5), np.float32)
    gt_valid = np.zeros((n, g), bool)
    if with_masks:
        msize = cfg.TRAIN.MASK_GT_SIZE
        gt_masks = np.zeros((n, g, msize, msize), np.uint8)
    if proposal_count:
        proposals = np.zeros((n, proposal_count, 4), np.float32)
        prop_valid = np.zeros((n, proposal_count), bool)
    for i, rec in enumerate(records):
        # only loader-owned loads are cached: a caller's ``images`` may hold
        # substituted slots, whose pixels no longer match the record's key
        key = prepared = None
        if images is None and _PREPARED_CACHE.max_entries > 0:
            key = _prepared_key(rec, (target, max_size), bucket, uint8_images,
                                cfg.network.PIXEL_MEANS, cfg.network.PIXEL_STDS)
            prepared = _PREPARED_CACHE.get(key)
        if prepared is None:
            im = images[i] if images is not None else load_record_image(rec)
            prepared = prepare_image(
                im, target, max_size, cfg.network.PIXEL_MEANS, cfg.network.PIXEL_STDS, [bucket],
                uint8_out=uint8_images,
            )
            if key is not None:
                _PREPARED_CACHE.put(key, prepared)
        padded, info = prepared
        out_images[i] = padded
        im_info[i] = info
        boxes = rec["boxes"] * info[2]
        k = min(len(boxes), g)
        gt_boxes[i, :k, :4] = boxes[:k]
        gt_boxes[i, :k, 4] = rec["gt_classes"][:k]
        gt_valid[i, :k] = True
        if with_masks:
            rec_masks = record_gt_masks(rec, g, msize)
            gt_masks[i] = 1 if rec_masks is None else rec_masks
        if proposal_count:
            p = np.asarray(rec["proposals"], np.float32) * info[2]
            k = min(len(p), proposal_count)
            proposals[i, :k] = p[:k]
            prop_valid[i, :k] = True
    out = {"images": out_images, "im_info": im_info, "gt_boxes": gt_boxes, "gt_valid": gt_valid}
    if with_masks:
        out["gt_masks"] = gt_masks
    if seeds is not None:
        out["sample_seeds"] = np.asarray(seeds, np.int32)
    if proposal_count:
        out["proposals"] = proposals
        out["prop_valid"] = prop_valid
    return out


def _orientation_bucket(rec: Dict, buckets) -> Tuple[int, int]:
    """The bucket a record lands in after the resize (h ≤ w → wide)."""
    wide = rec["width"] >= rec["height"]
    for b in buckets:
        if (b[1] >= b[0]) == wide:
            return tuple(b)
    return tuple(buckets[0])


class PrefetchIterator:
    """Closeable host-prefetch stage: drains ``source`` through a daemon
    thread with a bounded queue, so host batch assembly overlaps the
    consumer's device work.

    Worker exceptions re-raise in the consumer (a swallowed decode error
    would silently truncate an epoch).  Shutdown is sentinel-based:
    :meth:`close` (also the context manager and, as a backstop, GC) signals
    the worker, drains queued batches and joins the thread.  The device
    feed (``core/pipeline.py :: DeviceFeed``) stacks on top and closes its
    source through the same interface.  ``prefetch <= 0`` is a synchronous
    pass-through (no thread)."""

    def __init__(self, source, prefetch: int):
        self._closed = threading.Event()
        self._done = False
        if prefetch <= 0:
            self._it = iter(source)
            self._thread = None
            return
        self._it = None
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._worker, name="loader-prefetch", daemon=True)
        self._thread.start()

    def _put(self, msg) -> bool:
        # a bounded put that gives up once the consumer is gone: a plain put
        # would park this thread forever on an abandoned iterator
        while not self._closed.is_set():
            try:
                self._q.put(msg, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for item in self._source:
                if not self._put(("item", item)):
                    return
            self._put(("stop", None))
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            self._put(("err", e))

    def __iter__(self):
        return self

    def __next__(self):
        if self._done or self._closed.is_set():
            raise StopIteration
        if self._thread is None:
            return next(self._it)
        while True:
            try:
                kind, payload = self._q.get(timeout=0.2)
                break
            except queue.Empty:
                if self._closed.is_set():
                    raise StopIteration from None
        if kind == "stop":
            self._done = True
            raise StopIteration
        if kind == "err":
            self._done = True
            raise payload
        return payload

    def close(self, timeout: float = 5.0) -> None:
        """Idempotent: stop the worker, drop queued batches, join."""
        self._closed.set()
        if self._thread is None:
            return
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread.is_alive():
            self._thread.join(timeout)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # abandoned without close(): still reclaim
        try:
            self.close(timeout=0.2)
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass


def build_batch(
    roidb: List[Dict], cfg: Config, retry: RetryPolicy, bucket: Tuple[int, int],
    idxs: List[int], injected: Dict[int, int], proposal_count: int = 0,
) -> Tuple[Optional[Dict[str, np.ndarray]], List[Tuple[int, str]], int]:
    """One plan entry's batch, a pure function of its arguments (so it runs
    the same in an assembly process): each record's image loads with
    bounded retry, the first ``injected[i]`` attempts of record ``i`` failing
    as an injected read fault; a record that still fails has its slot
    filled with the batch's first good record (record, pixels and seed stay
    consistent; the batch keeps its shape).  Returns ``(batch or None when
    no record loads, [(record, error)] of the failed records, substituted
    slots)``; the loader does the accounting.  A mask network's batch
    carries ``gt_masks``, and ``proposal_count`` > 0 adds the records'
    ``proposals`` / ``prop_valid`` (``make_batch``)."""
    failures: List[Tuple[int, str]] = []
    images: List[Optional[np.ndarray]] = []
    for i in idxs:
        def attempt(k: int, i: int = i) -> np.ndarray:
            if k < injected.get(i, 0):
                raise faults.InjectedFault(f"injected read failure for record {i}")
            return load_record_image(roidb[i])

        try:
            images.append(retry.run(attempt))
        except Exception as e:  # noqa: BLE001 — any read/decode failure
            failures.append((i, repr(e)))
            images.append(None)
    good = [(i, im) for i, im in zip(idxs, images) if im is not None]
    if not good:
        return None, failures, 0
    filled, imgs = [], []
    for i, im in zip(idxs, images):
        if im is None:
            i, im = good[0]
        filled.append(i)
        imgs.append(im)
    batch = make_batch([roidb[i] for i in filled], cfg, bucket, seeds=filled, images=imgs,
                       with_masks=cfg.network.USE_MASK, proposal_count=proposal_count)
    return batch, failures, len(idxs) - len(good)


# an assembly process's share of its loader, set once by the initializer
_WORKER_STATE: Dict[str, object] = {}


def _init_assembly_worker(roidb: List[Dict], cfg: Config, retry: RetryPolicy,
                          proposal_count: int = 0) -> None:
    # a preemption signal to the process group is the trainer's to handle:
    # its workers live on until it has saved and closes the pool
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    _WORKER_STATE.update(roidb=roidb, cfg=cfg, retry=retry, proposal_count=proposal_count)


def _assemble(task):
    bucket, idxs, injected = task
    w = _WORKER_STATE
    return build_batch(w["roidb"], w["cfg"], w["retry"], bucket, idxs, injected,
                       w["proposal_count"])


class _AssembledStream:
    """Closeable iterator over pool-assembled batches, the
    ``assembly_workers > 0`` twin of :class:`PrefetchIterator`.  Each
    result is accounted by its loader in submission order (the budget is
    exceeded at the same record as in the serial loop); batches with no
    loadable record are dropped; worker exceptions surface at their
    submission position.  ``close`` drops the pending work and leaves the
    loader's pool to the next epoch; ``stats()`` gives the pool's
    counters."""

    def __init__(self, loader: "TrainLoader", pool: AssemblyPool, results):
        self._loader = loader
        self._pool = pool
        self._results = results

    def __iter__(self) -> "_AssembledStream":
        return self

    def __next__(self):
        while True:
            out = self._loader._account(next(self._results))
            if out is not None:
                return out

    def stats(self) -> Dict:
        return self._pool.stats()

    def close(self, timeout: float = 5.0) -> None:
        self._results.close()

    def __enter__(self) -> "_AssembledStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TrainLoader:
    """Shuffled, orientation-grouped, bucket-padded batches, assembled
    ahead of the consumer: by one prefetch thread (``prefetch`` batches
    queued; 0 = on the consumer's thread) or, with ``assembly_workers`` > 0
    (None → ``MX_RCNN_ASSEMBLY_WORKERS``), by an ordered pool of processes,
    started at the first epoch and kept until :meth:`close`.  ``epoch``
    advances at each ``iter()``; ``skip_batches`` drops that many batches
    from the front of the next epoch's plan.

    A record whose image fails to load is retried per ``retry``, then its
    slot is filled with the batch's first good record, counted in
    ``record_failures`` / ``substituted_records``.  A batch with no loadable
    record is dropped (``dropped_batches``).  More failures than
    ``failure_budget`` raise :class:`LoaderFaultBudgetExceeded`.  Injected
    read faults (``record_fail``) are drawn from the fault registry in plan
    order as each batch is handed to its worker, so a pooled stream fails
    the same reads as the serial one.  ``proposal_count`` > 0 gives every
    batch the records' ``proposals`` / ``prop_valid`` padded to that count
    (Fast R-CNN on a proposal roidb)."""

    def __init__(
        self,
        roidb: List[Dict],
        cfg: Config,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        retry: Optional[RetryPolicy] = None,
        failure_budget: Optional[int] = None,
        assembly_workers: Optional[int] = None,
        proposal_count: int = 0,
    ):
        self.roidb = roidb
        self.cfg = cfg
        self.batch_size = batch_size
        self.proposal_count = proposal_count
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        self.skip_batches = 0
        self.retry = retry or make_retry_policy("loader")
        # default budget: 1% of the roidb, floored so tiny runs are not
        # aborted by a single flaky read
        self.failure_budget = (
            failure_budget if failure_budget is not None else max(32, len(roidb) // 100)
        )
        self.record_failures = 0
        self.substituted_records = 0
        self.dropped_batches = 0
        self.assembly_workers = assembly_workers
        self._pool: Optional[AssemblyPool] = None

    def __len__(self) -> int:
        return len(self.roidb) // self.batch_size

    def _epoch_plan(self, epoch: int) -> List[Tuple[Tuple[int, int], List[int]]]:
        """Group indices by orientation bucket, shuffle within groups, emit
        whole batches (the ragged tail of each group is dropped), then
        shuffle the batches."""
        rng = np.random.RandomState(self.seed + epoch)
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, rec in enumerate(self.roidb):
            groups.setdefault(_orientation_bucket(rec, self.cfg.SHAPE_BUCKETS), []).append(i)
        plan = []
        for b, idxs in groups.items():
            idxs = np.asarray(idxs)
            if self.shuffle:
                rng.shuffle(idxs)
            for s in range(0, len(idxs) - self.batch_size + 1, self.batch_size):
                plan.append((b, idxs[s : s + self.batch_size].tolist()))
        if self.shuffle:
            order = rng.permutation(len(plan))
            plan = [plan[i] for i in order]
        return plan

    def _injected(self, idxs: List[int]) -> Dict[int, int]:
        """How many leading read attempts of each record the fault registry
        fails (one ``fail_record`` call an attempt, as the serial loader
        makes them)."""
        out = {}
        for i in idxs:
            n = 0
            while n < self.retry.tries:
                try:
                    faults.fail_record(i)
                except faults.InjectedFault:
                    n += 1
                    continue
                break
            if n:
                out[i] = n
        return out

    def _account(self, result) -> Optional[Dict[str, np.ndarray]]:
        """Count one built entry's failures against the budget, in plan
        order; the batch, or None for a dropped one."""
        batch, failures, substituted = result
        for i, err in failures:
            self.record_failures += 1
            logger.warning(
                "record %d (%s) failed after %d attempts: %s — dropped (%d/%d failure budget)",
                i, self.roidb[i].get("image"), self.retry.tries, err, self.record_failures,
                self.failure_budget,
            )
            if self.record_failures > self.failure_budget:
                raise LoaderFaultBudgetExceeded(
                    f"{self.record_failures} records failed to load (budget "
                    f"{self.failure_budget}); latest: record {i} "
                    f"({self.roidb[i].get('image')}): {err}"
                )
        self.substituted_records += substituted
        if batch is None:
            self.dropped_batches += 1
            logger.warning("dropping a whole batch — no loadable record")
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        plan = self._epoch_plan(self.epoch)
        self.epoch += 1
        if self.skip_batches:
            plan = plan[self.skip_batches:]
            self.skip_batches = 0
        workers = (
            default_assembly_workers() if self.assembly_workers is None
            else max(0, int(self.assembly_workers))
        )
        if workers > 0:
            if self._pool is None:
                self._pool = AssemblyPool(workers, name="train-assembly",
                                          initializer=_init_assembly_worker,
                                          initargs=(self.roidb, self.cfg, self.retry,
                                                    self.proposal_count))
            # the faults are drawn lazily, as each entry is submitted: in
            # plan order, as the serial loop draws them
            tasks = ((bucket, idxs, self._injected(idxs)) for bucket, idxs in plan)
            window = max(self.prefetch, workers + 2)
            return _AssembledStream(self, self._pool, self._pool.imap(_assemble, tasks, window))
        source = (
            batch for bucket, idxs in plan
            if (batch := self._account(build_batch(
                self.roidb, self.cfg, self.retry, bucket, idxs, self._injected(idxs),
                self.proposal_count))) is not None
        )
        return PrefetchIterator(source, self.prefetch)

    def stats(self) -> Dict:
        """The fault counters, and the assembly pool's when there is one."""
        out = {"record_failures": self.record_failures,
               "substituted_records": self.substituted_records,
               "dropped_batches": self.dropped_batches}
        if self._pool is not None:
            out["assembly"] = self._pool.stats()
        return out

    def close(self) -> None:
        """Shut the assembly processes down (idempotent)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass


# ------------------------------------------------------------------ TestLoader
def build_test_batch(
    roidb: List[Dict], cfg: Config, bucket: Tuple[int, int], chunk: List[int],
    proposal_count: int = 0,
) -> Tuple[List[int], List[Dict], Dict[str, np.ndarray]]:
    """One eval batch of the records ``chunk`` in ``bucket``, a pure
    function of its arguments: ``(chunk, records, batch)``, the batch with
    uint8 images under TEST.UINT8_TRANSFER, ``orig_hw`` (n, 2), each
    image's pre-resize (height, width), and with ``proposal_count`` > 0 the
    records' ``proposals`` / ``prop_valid`` (``make_batch``)."""
    recs = [roidb[i] for i in chunk]
    batch = make_batch(recs, cfg, bucket, uint8_images=cfg.TEST.UINT8_TRANSFER,
                       proposal_count=proposal_count)
    batch["orig_hw"] = np.asarray([[r["height"], r["width"]] for r in recs], np.float32)
    return chunk, recs, batch


def _init_test_worker(roidb: List[Dict], cfg: Config, proposal_count: int = 0) -> None:
    _WORKER_STATE.update(roidb=roidb, cfg=cfg, proposal_count=proposal_count)


def _assemble_test(task):
    bucket, chunk = task
    w = _WORKER_STATE
    return build_test_batch(w["roidb"], w["cfg"], bucket, chunk, w["proposal_count"])


class _PooledTestStream:
    """Closeable iterator over pool-assembled eval batches, the
    ``assembly_workers > 0`` twin of :class:`PrefetchIterator`; it owns its
    pool and shuts it down at the end of the stream or at :meth:`close`.
    ``stats()`` gives the pool's counters."""

    def __init__(self, pool: AssemblyPool, results):
        self._pool = pool
        self._results = results

    def __iter__(self) -> "_PooledTestStream":
        return self

    def __next__(self):
        try:
            return next(self._results)
        except StopIteration:
            self._pool.close()
            raise

    def stats(self) -> Dict:
        return self._pool.stats()

    def close(self, timeout: float = 5.0) -> None:
        self._results.close()
        self._pool.close()

    def __enter__(self) -> "_PooledTestStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TestLoader:
    """Inference batches over a roidb, each with its record, so eval can
    undo the resize.  ``for rec, batch in loader`` yields one image at a
    time (on the consumer's thread); :meth:`iter_batched` yields
    ``(dataset_indices, records, batch)`` of up to ``batch_size``
    same-orientation-bucket images, the ragged tail of each bucket group at
    its own smaller size.  ``proposal_count`` > 0 (Fast R-CNN test mode)
    gives every batch the records' dumped ``proposals`` / ``prop_valid``,
    scaled by the resize factor and padded to that count."""

    def __init__(self, roidb: List[Dict], cfg: Config, proposal_count: int = 0,
                 batch_size: int = 1):
        self.roidb = roidb
        self.cfg = cfg
        self.proposal_count = proposal_count
        self.batch_size = batch_size

    def __len__(self) -> int:
        return len(self.roidb)

    def __iter__(self):
        for i, rec in enumerate(self.roidb):
            bucket = _orientation_bucket(rec, self.cfg.SHAPE_BUCKETS)
            _, _, batch = build_test_batch(self.roidb, self.cfg, bucket, [i],
                                           self.proposal_count)
            yield rec, batch

    def _plan(self) -> List[Tuple[Tuple[int, int], List[int]]]:
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, rec in enumerate(self.roidb):
            groups.setdefault(_orientation_bucket(rec, self.cfg.SHAPE_BUCKETS), []).append(i)
        return [
            (bucket, idxs[s : s + self.batch_size])
            for bucket, idxs in groups.items()
            for s in range(0, len(idxs), self.batch_size)
        ]

    def iter_batched(self, prefetch: int = 2, assembly_workers: Optional[int] = None):
        """``(dataset_indices, records, batch)`` assembled ahead of the
        consumer: by one prefetch thread (``prefetch`` batches queued; 0 =
        on the consumer's thread) or, with ``assembly_workers`` > 0 (None →
        ``MX_RCNN_ASSEMBLY_WORKERS``), by an ordered pool of that many
        processes, started here and shut down with the stream.  The same
        batches in the same order either way; the returned stream is
        closeable."""
        plan = self._plan()
        workers = (
            default_assembly_workers() if assembly_workers is None
            else max(0, int(assembly_workers))
        )
        if workers > 0:
            pool = AssemblyPool(workers, name="test-assembly", initializer=_init_test_worker,
                                initargs=(self.roidb, self.cfg, self.proposal_count))
            return _PooledTestStream(
                pool, pool.imap(_assemble_test, plan, window=max(prefetch, workers + 2)))
        source = (build_test_batch(self.roidb, self.cfg, bucket, chunk, self.proposal_count)
                  for bucket, chunk in plan)
        return PrefetchIterator(source, prefetch)
