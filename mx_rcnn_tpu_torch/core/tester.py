"""Inference: Predictor, the pipelined eval loop, im_detect, pred_eval and
generate_proposals (port of ``Predictor``, ``pipelined``, ``im_detect``,
``pred_eval`` and ``generate_proposals`` in ``mx_rcnn_tpu/core/tester.py``).

The forward runs eagerly under ``torch.inference_mode()`` on one explicit
device, with the device postprocess fused after it when the Predictor has
one, so only the per-class keep lists come back to the host, in one batched
device → host copy (:class:`PendingFetch`).  ``pred_eval`` is the dataset
loop: test batches → ``pipelined`` forwards → per-image detections (and
mask RLEs) in a completion pool → ``imdb.evaluate_detections``.
"""

from __future__ import annotations

import inspect
import logging
import os
import pickle
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.utils.bbox_stats import np_bbox_pred, np_clip_boxes

logger = logging.getLogger(__name__)


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; raises when the
    card is asked for and none is present (no silent fall back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


def _on_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``x`` on ``device``: a tensor already there as it is, host data
    copied (to a card pinned and ``non_blocking``, so the host does not
    wait for the stream)."""
    t = torch.as_tensor(x, dtype=dtype)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class PendingFetch:
    """A batched device → host copy of a dict of device outputs, started at
    once and read with :meth:`result`: every tensor's bytes gathered into
    one buffer and copied in one transfer (to a card's pinned memory,
    ``non_blocking``, with an event after it), then split and viewed back
    as each tensor's dtype and shape.  Started right after a forward, the
    copy waits in the stream behind that forward only, not behind the
    forwards dispatched after it."""

    def __init__(self, out: Dict[str, torch.Tensor]):
        self._layout = [(k, v.dtype, tuple(v.shape), v.numel() * v.element_size())
                        for k, v in out.items()]
        self._event = None
        if not out:
            self._host = None
            return
        with torch.inference_mode():
            flat = torch.cat([v.detach().contiguous().reshape(-1).view(torch.uint8)
                              for v in out.values()])
            if flat.is_cuda:
                self._host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
                self._host.copy_(flat, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record(torch.cuda.current_stream(flat.device))
                self._flat = flat  # alive until the copy is read
            else:
                self._host = flat

    def result(self) -> Dict[str, np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        flat = self._host.numpy() if self._host is not None else None
        out, pos = {}, 0
        for k, dtype, shape, n in self._layout:
            np_dtype = torch.empty((), dtype=dtype).numpy().dtype
            out[k] = flat[pos:pos + n].copy().view(np_dtype).reshape(shape)
            pos += n
        return out


def fetch_outputs(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Host numpy copies of a dict of device outputs, in one batched
    device → host copy (:class:`PendingFetch`)."""
    return PendingFetch(out).result()


class Predictor:
    """Forward-only wrapper around a model on ``device`` (default: the card).

    ``postprocess`` (ops/postprocess.py) runs on the device after the forward
    whenever the batch carries ``orig_hw``; one that ``wants_canvas`` (the
    mask paste) also gets the batch's padded image extent, the bucket
    canvas.  A batch may hold numpy arrays or tensors already on the device
    (a ``DeviceFeed`` stages them), which are used without another copy.
    A batch's ``proposals`` / ``prop_valid`` (``TestLoader(proposal_count)``)
    go to the model too (Fast R-CNN's test forward)."""

    def __init__(self, model: nn.Module, postprocess=None, device=None):
        self.device = resolve_device(device)
        # channels_last: the NHWC images and pooled rois enter the convs
        # as views, with no layout copy
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self.postprocess = postprocess

    def predict_async(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Dispatch the forward and return the device outputs without
        fetching them (the consumer does: :class:`PendingFetch`)."""
        with torch.inference_mode():
            images = _on_device(batch["images"], self.device)
            im_info = _on_device(batch["im_info"], self.device, torch.float32)
            extra = {k: _on_device(batch[k], self.device) for k in ("proposals", "prop_valid")
                     if k in batch}
            out = self.model(images, im_info, **extra)
            orig_hw = batch.get("orig_hw")
            if self.postprocess is not None and orig_hw is not None:
                orig_hw = _on_device(orig_hw, self.device, torch.float32)
                if getattr(self.postprocess, "wants_canvas", False):
                    out = self.postprocess(out, im_info, orig_hw, tuple(images.shape[1:3]))
                else:
                    out = self.postprocess(out, im_info, orig_hw)
        return out

    def predict(self, batch: Dict) -> Dict[str, np.ndarray]:
        return fetch_outputs(self.predict_async(batch))


def pipelined(
    predictor: Predictor,
    batches,
    in_flight: int = 2,
    feed_depth: int = 2,
    stats_out: Optional[Dict] = None,
    mode: str = "auto",
):
    """Overlapped eval loop: keeps ``in_flight`` forwards in motion and
    yields ``(payload, batch, outputs)`` for ``(payload, batch)`` items of
    ``batches``, in input order, with the outputs on the host.

    Two dispatch modes:

    * ``"async"`` (``"auto"``): :meth:`Predictor.predict_async` from this
      thread with a bounded window; each forward's batched host copy
      (:class:`PendingFetch`) is queued behind it at once and waited for
      only when its result is consumed;
    * ``"threads"``: ``in_flight`` blocking :meth:`Predictor.predict` calls
      in a small thread pool.

    The JAX package resolves ``"auto"`` to ``"threads"`` off the CPU for its
    relay-attached TPU, which overlaps only requests from separate threads.
    A card's stream runs one thread's dispatches in order anyway, and there
    the threads' forwards share the stream and the interpreter lock with
    the dispatch thread: ``"async"`` was faster on the H100 (``PERF.md``
    §6), so ``"auto"`` is ``"async"`` on every device.

    ``feed_depth`` > 0 stages the batches through a
    :class:`~mx_rcnn_tpu_torch.core.pipeline.DeviceFeed` (on a card: pinned
    copies on its own stream), so batch N+1's host assembly and copy overlap
    batch N's forward; the payload (indices, records) stays on the host.
    ``stats_out``, if given, receives the resolved mode and window, the
    feed's counters and ``wait_ms``: this thread's wait for each batch."""
    from mx_rcnn_tpu_torch.core.pipeline import DeviceFeed, batch_to_device

    if mode == "auto":
        mode = "async"
    if mode not in ("async", "threads"):
        raise ValueError(f"unknown pipelined mode {mode!r}")
    feed = None
    source = batches
    if feed_depth > 0:
        dev = predictor.device
        feed = DeviceFeed(
            batches,
            place_fn=lambda pair: (pair[0], batch_to_device(pair[1], dev)),
            depth=feed_depth,
            name="eval-device-feed",
            device=dev,
        )
        source = feed
    window = max(in_flight, 1)
    waits: List[float] = []
    it = iter(source)

    def next_item():
        t0 = time.perf_counter()
        item = next(it, None)
        if item is not None:
            waits.append((time.perf_counter() - t0) * 1e3)
        return item

    q: deque = deque()
    ex = None
    try:
        if mode == "async":
            while (item := next_item()) is not None:
                payload, batch = item
                q.append((payload, batch, PendingFetch(predictor.predict_async(batch))))
                while len(q) > window:
                    p, b, o = q.popleft()
                    yield p, b, o.result()
            while q:
                p, b, o = q.popleft()
                yield p, b, o.result()
        else:
            ex = ThreadPoolExecutor(max_workers=window, thread_name_prefix="eval-predict")
            while (item := next_item()) is not None:
                payload, batch = item
                q.append((payload, batch, ex.submit(predictor.predict, batch)))
                while len(q) > window:
                    p, b, f = q.popleft()
                    yield p, b, f.result()
            while q:
                p, b, f = q.popleft()
                yield p, b, f.result()
    finally:
        if ex is not None:
            # abandoned early: finish the forwards in flight, drop the rest
            ex.shutdown(wait=True, cancel_futures=True)
        if stats_out is not None:
            stats_out["mode"] = mode
            stats_out["in_flight"] = window
            stats_out["wait_ms"] = waits
        if feed is not None:
            if stats_out is not None:
                stats_out.update(feed.stats())
            feed.close()


def im_detect(
    output: Dict[str, np.ndarray], im_info: np.ndarray, orig_hw, index: int = 0
) -> Dict[str, np.ndarray]:
    """One image's raw head outputs (host numpy) → image-space detections:
    class-specific delta decode, clip to the resized image, divide by the
    scale, clip to the original extent; ``index`` picks the image of a
    batched forward.  → ``{"scores": (n, K), "boxes": (n, 4K)}`` over the
    valid rois, and for a mask model ``"mask_probs"`` (n, S, S, K), the
    sigmoid of the mask logits."""
    rois = output["rois"][index]
    valid = output["roi_valid"][index].astype(bool)
    scores = output["cls_prob"][index]
    deltas = output["bbox_deltas"][index]
    scale = float(im_info[2])

    boxes = np_bbox_pred(np.asarray(rois), np.asarray(deltas))
    boxes = np_clip_boxes(boxes, (float(im_info[0]), float(im_info[1])))
    boxes = boxes / scale
    h, w = orig_hw
    boxes = np_clip_boxes(boxes, (float(h), float(w)))
    det = {"scores": scores[valid], "boxes": boxes[valid]}
    if "mask_logits" in output:
        det["mask_probs"] = 1.0 / (1.0 + np.exp(-np.asarray(output["mask_logits"][index][valid])))
    return det


def pred_eval(
    predictor: Predictor,
    loader,
    imdb,
    cfg: Config,
    thresh: Optional[float] = None,
    vis: Optional[str] = None,
    dump_path: Optional[str] = None,
    vis_thresh: float = 0.7,
    postprocess_workers: Optional[int] = None,
    assembly_workers: Optional[int] = None,
    stats_out: Optional[Dict] = None,
):
    """Full-dataset evaluation loop: → ``(all_boxes, results)`` with
    ``all_boxes[cls][img]`` an (n, 5) [x1, y1, x2, y2, score] array and
    ``results = imdb.evaluate_detections(all_boxes)``.  For a mask model each
    kept detection's mask is pasted into the image and RLE-encoded
    (``eval/segm.py::rles_for_detections``, one (image, class) a unit of
    completion work) and ``evaluate_detections`` gets ``all_masks`` too,
    where it takes them (else a warning, and box results only).

    With TEST.DEVICE_POSTPROCESS the predictor is rebuilt with the device
    decode + NMS; otherwise its outputs go through the host branch
    (``im_detect`` + C NMS).  A loader with ``batch_size`` > 1 runs batched
    forwards (``iter_batched``, with ``assembly_workers`` processes);
    each image's detections, capped at MAX_PER_IMAGE across classes, are
    accumulated by index in a completion pool of ``postprocess_workers``
    threads (None → ``MX_RCNN_POSTPROCESS_WORKERS``, default 0 = inline),
    so the result does not depend on which worker finishes first.
    ``dump_path`` writes the ``all_boxes`` pickle; ``stats_out`` receives
    the completion pool's counters (``completion``) and the eval loop's
    (``feed``: mode, window, waits, feed occupancy).  ``vis`` raises: the
    overlays need an image writer (ROADMAP queue 1 item 7)."""
    from mx_rcnn_tpu_torch.data.assembler import CompletionPool
    from mx_rcnn_tpu_torch.eval.segm import rles_for_detections
    from mx_rcnn_tpu_torch.serve.runner import cap_detections, detections_from_output

    if vis:
        raise NotImplementedError(
            "vis (detection overlays) needs an image writer: ROADMAP queue 1 item 7"
        )
    te = cfg.TEST
    thresh = te.SCORE_THRESH if thresh is None else thresh
    num_classes = imdb.num_classes
    num_images = len(loader)
    if te.DEVICE_POSTPROCESS:
        from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess

        predictor = Predictor(
            predictor.model,
            postprocess=make_test_postprocess(cfg, num_classes, thresh, max_out=te.DET_PER_CLASS),
            device=predictor.device,
        )
    all_boxes: List[List[np.ndarray]] = [
        [np.zeros((0, 5), np.float32) for _ in range(num_images)]
        for _ in range(num_classes)
    ]
    all_masks: Optional[List[List[list]]] = None
    t0 = time.time()
    done = 0
    # the slot writes are disjoint per image; the lock covers the lazy
    # all_masks and the counter
    acc_lock = threading.Lock()

    def process_image(i: int, rec: Dict, out, im_info_row, k: int = 0):
        """Accumulate dataset image ``i`` from slot ``k`` of a forward's
        outputs; safe from any completion worker."""
        nonlocal all_masks, done
        cls_dets, mask_probs = detections_from_output(
            out, im_info_row, (rec["height"], rec["width"]), cfg, num_classes,
            index=k, thresh=thresh,
        )
        # the cap before the masks: pasting detections the cap drops would
        # dominate the segm eval's cost
        cls_dets, mask_probs = cap_detections(cls_dets, te.MAX_PER_IMAGE, mask_probs)
        for j in range(1, num_classes):
            all_boxes[j][i] = cls_dets[j]
        if mask_probs is not None:
            rles = {j: rles_for_detections(mask_probs[j], cls_dets[j], rec["height"], rec["width"])
                    for j in range(1, num_classes)}
            with acc_lock:
                if all_masks is None:
                    all_masks = [[[] for _ in range(num_images)] for _ in range(num_classes)]
            for j in range(1, num_classes):
                all_masks[j][i] = rles[j]
        with acc_lock:
            done += 1
            n_done = done
        if n_done % 100 == 0:
            logger.info("im_detect %d/%d %.3fs/im", n_done, num_images,
                        (time.time() - t0) / n_done)

    workers = (
        max(0, int(os.environ.get("MX_RCNN_POSTPROCESS_WORKERS", "0")))
        if postprocess_workers is None
        else max(0, int(postprocess_workers))
    )
    completion = CompletionPool(workers, name="eval-complete")
    loop_stats: Dict = {}
    try:
        # the payload carries each batch's host im_info: the staged batch
        # is on the device
        if getattr(loader, "batch_size", 1) > 1:
            for (idxs, recs, info), _, out in pipelined(
                predictor,
                (((idxs, recs, batch["im_info"]), batch)
                 for idxs, recs, batch in loader.iter_batched(assembly_workers=assembly_workers)),
                stats_out=loop_stats,
            ):
                for k, (i, rec) in enumerate(zip(idxs, recs)):
                    completion.submit(process_image, i, rec, out, info[k], k)
        else:
            for (i, rec, info), _, out in pipelined(
                predictor,
                (((i, rec, batch["im_info"]), batch) for i, (rec, batch) in enumerate(loader)),
                stats_out=loop_stats,
            ):
                completion.submit(process_image, i, rec, out, info[0])
        completion.drain()
    finally:
        completion.close()
        if stats_out is not None:
            stats_out["completion"] = completion.stats()
            stats_out["feed"] = loop_stats
    if dump_path:
        with open(dump_path, "wb") as f:
            pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)
    if all_masks is None:
        return all_boxes, imdb.evaluate_detections(all_boxes)
    if "all_masks" not in inspect.signature(imdb.evaluate_detections).parameters:
        logger.warning("%s.evaluate_detections takes no all_masks: box results only",
                       type(imdb).__name__)
        return all_boxes, imdb.evaluate_detections(all_boxes)
    return all_boxes, imdb.evaluate_detections(all_boxes, all_masks=all_masks)


def generate_proposals(predictor: Predictor, loader, cfg: Config,
                       dump_path: Optional[str] = None) -> List[np.ndarray]:
    """The RPN over a dataset (the reference's ``generate_proposals``): for
    each image, in dataset order, its valid proposals in original image
    coordinates with their scores, an (n, 5) float32 [x1, y1, x2, y2,
    score] array, score-descending.  ``loader`` is a ``TestLoader``, run
    through ``pipelined`` in its ``iter_batched`` batches; ``dump_path``
    pickles the list (numpy arrays only, readable by the JAX package's
    ``load_proposal_roidb``)."""
    proposals: List[Optional[np.ndarray]] = [None] * len(loader)
    # the payload carries each batch's host im_info: the staged batch is on
    # the device
    for (idxs, info), _, out in pipelined(
        predictor,
        (((idxs, batch["im_info"]), batch) for idxs, _, batch in loader.iter_batched()),
    ):
        for k, i in enumerate(idxs):
            valid = out["roi_valid"][k].astype(bool)
            boxes = out["rois"][k][valid] / float(info[k][2])
            scores = np.asarray(out["roi_scores"][k])[valid]
            proposals[i] = np.hstack([boxes, scores[:, None]]).astype(np.float32)
    if dump_path:
        with open(dump_path, "wb") as f:
            pickle.dump(proposals, f, pickle.HIGHEST_PROTOCOL)
    return proposals
