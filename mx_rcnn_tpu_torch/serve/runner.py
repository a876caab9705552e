"""The one predict path: prepare → batch → forward → detections (port of
``mx_rcnn_tpu/serve/runner.py``).

The host half (:func:`prepare_request`, :func:`detections_from_output`,
:func:`cap_detections`, :func:`detect_single`) is shared by eval
(``core/tester.py::pred_eval``), the demo and serving, so they give the same
detections for the same outputs.

:class:`ServeRunner` is the device half.  It holds no params of its own:
every model family's params are a versioned resource in a
:class:`~mx_rcnn_tpu_torch.serve.registry.ModelRegistry`, resolved per
batch.  Each family served gets a :class:`_ModelSlot`: its own module on
the device (a copy of the registered one, at the slot's precision) behind a
:class:`~mx_rcnn_tpu_torch.core.tester.Predictor` with the device
postprocess.  The runner enforces the serving bucket ladder on the prepare
path (oversize → :class:`~mx_rcnn_tpu_torch.serve.buckets.BucketOverflow`),
pads every batch to ``max_batch`` (pad slots replicate slot 0), so each
(model, bucket, precision) rung has one input shape, and accounts the
signatures in a :class:`~mx_rcnn_tpu_torch.serve.buckets.CompileCache`:
``warmup`` runs every rung once, after which ``misses`` must stay put.

Precision rungs (``precision=``, global or per model): ``"float32"``,
``"bfloat16"`` (a module rebuilt with ``COMPUTE_DTYPE`` bf16 and
``FOLD_BN``, on the same f32 params) and ``"int8"`` (per-channel int8
weights, ``core/quantize.py``, dequantized once when the slot is built or
swapped; the forward is the f32 graph).  A rung other than f32 serves only
after :meth:`ServeRunner.check_parity` held its detections (and mask grids)
against a transient f32 module on the same weights, at the JAX package's
tolerances (:data:`PARITY_BOX_TOL`, :data:`PARITY_SCORE_TOL`,
:data:`PARITY_MARGIN`, :data:`PARITY_MASK_TOL`); the gate always runs.

Hot swap: a slot's weights change only between batches.  ``_sync`` copies
the new version into the slot's module in place, under the slot lock (which
every forward of that module holds while it enqueues), on the stream the
forwards use, so a forward already dispatched finishes on the old weights.

The JAX runner's ``donate``, ``layout_feed`` and ``deterministic`` knobs
configure XLA (buffer donation, input layouts, the CPU compile mode) and
have no meaning here: they are not carried over, and nothing stands in for
them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from mx_rcnn_tpu_torch.analysis.lockcheck import make_lock
from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.tester import PendingFetch, Predictor, im_detect, resolve_device
from mx_rcnn_tpu_torch.data.image import normalize, pad_to_bucket, quantize_uint8, resize_im
from mx_rcnn_tpu_torch.native.hostops import nms_host
from mx_rcnn_tpu_torch.ops.postprocess import MASK_FILL
from mx_rcnn_tpu_torch.serve.batcher import Request
from mx_rcnn_tpu_torch.serve.buckets import BucketLadder, CompileCache

__all__ = [
    "ClsDets", "PARITY_BOX_TOL", "PARITY_MARGIN", "PARITY_MASK_TOL", "PARITY_SCORE_TOL",
    "PrecisionParityError", "Request", "ServeHandle", "ServeRunner",
    "cap_detections", "detect_single", "detection_parity", "detections_from_output",
    "mask_parity", "prepare_request",
]

# per class (n, 5) [x1 y1 x2 y2 score]; index 0 (background) is None
ClsDets = List[Optional[np.ndarray]]

#: precision tags, part of every serving signature, so the f32, bf16 and
#: int8 rungs of one (model, shape) never share a cache key
_PRECISION_TAGS = {
    None: "f32", "float32": "f32", "f32": "f32",
    "bfloat16": "bf16", "bf16": "bf16",
    "int8": "int8",
}

#: the warmup gate's tolerances, the JAX runner's defaults: a confident
#: detection's box corners (px), its score, the band above SCORE_THRESH
#: exempt from matching, and a matched pair's mask probabilities
PARITY_BOX_TOL = 4.0
PARITY_SCORE_TOL = 0.1
PARITY_MARGIN = 0.1
PARITY_MASK_TOL = 0.25


class PrecisionParityError(RuntimeError):
    """A reduced-precision rung's detections (bf16 compute or int8
    weights) drifted outside the tolerance against the f32 reference: the
    rung refuses to serve (it fails at warmup, not in production results)."""


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, 4) × (m, 4) [x1 y1 x2 y2] → (n, m) IoU matrix."""
    ax1, ay1, ax2, ay2 = [a[:, k, None] for k in range(4)]
    bx1, by1, bx2, by2 = [b[None, :, k] for k in range(4)]
    iw = np.maximum(np.minimum(ax2, bx2) - np.maximum(ax1, bx1) + 1.0, 0.0)
    ih = np.maximum(np.minimum(ay2, by2) - np.maximum(ay1, by1) + 1.0, 0.0)
    inter = iw * ih
    area_a = (ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0)
    area_b = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


def detection_parity(
    ref: ClsDets,
    test: ClsDets,
    thresh: float,
    margin: float = PARITY_MARGIN,
    match_iou: float = 0.5,
) -> Dict:
    """Compare two detection sets for reduced-precision parity.

    Detections scoring within ``margin`` of ``thresh`` are exempt:
    threshold flips are the expected (and harmless) failure mode of a
    lower-precision graph.  Every CONFIDENT detection (score ≥ thresh +
    margin) on either side must have a counterpart on the other with IoU ≥
    ``match_iou``; for matched pairs the max absolute box-corner delta (px)
    and score delta are reported.  Symmetric by construction."""
    max_box = 0.0
    max_score = 0.0
    unmatched = 0
    for j in range(1, max(len(ref), len(test))):
        a = ref[j] if j < len(ref) else None
        b = test[j] if j < len(test) else None
        a = np.zeros((0, 5), np.float32) if a is None else np.asarray(a)
        b = np.zeros((0, 5), np.float32) if b is None else np.asarray(b)
        for src, dst in ((a, b), (b, a)):
            conf = src[src[:, 4] >= thresh + margin]
            if not len(conf):
                continue
            if not len(dst):
                unmatched += len(conf)
                continue
            iou = _box_iou(conf[:, :4], dst[:, :4])
            best = iou.argmax(axis=1)
            for i, k in enumerate(best):
                if iou[i, k] < match_iou:
                    unmatched += 1
                    continue
                max_box = max(max_box, float(np.abs(conf[i, :4] - dst[k, :4]).max()))
                max_score = max(max_score, float(abs(conf[i, 4] - dst[k, 4])))
    return {
        "max_box_delta_px": round(max_box, 4),
        "max_score_delta": round(max_score, 5),
        "unmatched_confident": unmatched,
        "margin": margin,
        "match_iou": match_iou,
    }


def mask_parity(
    ref_dets: ClsDets,
    ref_masks: Dict[int, np.ndarray],
    test_dets: ClsDets,
    test_masks: Dict[int, np.ndarray],
    thresh: float,
    margin: float = PARITY_MARGIN,
    match_iou: float = 0.5,
) -> Dict:
    """Mask-grid companion of :func:`detection_parity`: for every confident
    reference detection with an IoU-matched counterpart, the max absolute
    per-pixel probability delta between the two S×S grids, so a
    reduced-precision mask graph cannot pass on boxes alone."""
    max_delta = 0.0
    pairs = 0
    for j in range(1, len(ref_dets)):
        a = ref_dets[j]
        b = test_dets[j] if j < len(test_dets) else None
        ma = ref_masks.get(j) if ref_masks else None
        mb = test_masks.get(j) if test_masks else None
        if a is None or b is None or ma is None or mb is None or not len(a) or not len(b):
            continue
        conf = np.where(np.asarray(a)[:, 4] >= thresh + margin)[0]
        if not len(conf):
            continue
        iou = _box_iou(np.asarray(a)[conf, :4], np.asarray(b)[:, :4])
        best = iou.argmax(axis=1)
        for t, i in enumerate(conf):
            k = int(best[t])
            if iou[t, k] < match_iou:
                continue
            pairs += 1
            max_delta = max(max_delta, float(np.abs(ma[i] - mb[k]).max()))
    return {"max_mask_prob_delta": round(max_delta, 5), "mask_pairs": pairs}


# --------------------------------------------------------------- detections
def detections_from_output(
    out: Dict[str, np.ndarray],
    im_info_row: np.ndarray,
    orig_hw: Tuple[float, float],
    cfg: Config,
    num_classes: int,
    index: int = 0,
    thresh: Optional[float] = None,
    with_rows: bool = False,
):
    """One image's forward outputs (host numpy) → ``(cls_dets,
    mask_probs)``: per-class (n, 5) [x1 y1 x2 y2 score] arrays, ``cls_dets[0]``
    None (background), and for a mask model ``mask_probs[j]`` (n, S, S), the
    kept detections' mask probabilities row for row (else None).

    Both output flavors: the device-postprocess dict (``det_boxes`` /
    ``det_scores`` / ``det_valid``: decode, unscale, clip and per-class NMS
    already ran on the device) and raw head outputs (host decode through
    :func:`~mx_rcnn_tpu_torch.core.tester.im_detect`, then per-class
    ``score > thresh`` and the host NMS at TEST.NMS, the reference's
    ``pred_eval`` inner loop).  On the device flavor a mask model ships the
    selected survivors' LOGIT grids (``det_masks``, ``det_mask_idx``): each
    kept row finds its grid by its flat det-grid index, rows past the
    device's ``max_det`` budget (only past the MAX_PER_IMAGE cut) get the
    −80 fill, and the sigmoid is the reference ``im_detect``'s numpy
    expression, so the probabilities equal the host flavor's bit for bit.
    ``with_rows=True`` also returns each kept detection's det-grid row
    (device flavor; None on the host flavor)."""
    te = cfg.TEST
    thresh = te.SCORE_THRESH if thresh is None else thresh
    cls_dets: ClsDets = [None] * num_classes
    mask_probs: Optional[Dict[int, np.ndarray]] = None
    det_rows: Optional[Dict[int, np.ndarray]] = None
    if "det_boxes" in out:
        det_rows = {}
        lut = None
        if "det_masks" in out:
            mask_probs = {}
            grids = np.asarray(out["det_masks"][index])
            lut = {int(f): p for p, f in enumerate(np.asarray(out["det_mask_idx"][index]))
                   if f >= 0}
        max_out = out["det_boxes"].shape[2]
        for j in range(1, num_classes):
            m = np.asarray(out["det_valid"][index][j - 1]).astype(bool)
            b = np.asarray(out["det_boxes"][index][j - 1][m])
            s = np.asarray(out["det_scores"][index][j - 1][m])
            cls_dets[j] = np.hstack([b, s[:, None]]).astype(np.float32)
            det_rows[j] = np.where(m)[0]
            if lut is not None:
                g = np.full((len(det_rows[j]),) + grids.shape[1:], MASK_FILL, np.float32)
                for t, row in enumerate(det_rows[j]):
                    p = lut.get((j - 1) * max_out + int(row))
                    if p is not None:
                        g[t] = grids[p]
                mask_probs[j] = 1.0 / (1.0 + np.exp(-g))
    else:
        det = im_detect(out, im_info_row, orig_hw, index=index)
        scores, boxes = det["scores"], det["boxes"]
        if "mask_probs" in det:
            mask_probs = {}
        for j in range(1, num_classes):
            keep = np.where(scores[:, j] > thresh)[0]
            cd = np.hstack(
                [boxes[keep, j * 4 : (j + 1) * 4], scores[keep, j : j + 1]]
            ).astype(np.float32)
            keep_nms = nms_host(cd, te.NMS)
            cls_dets[j] = cd[keep_nms]
            if mask_probs is not None:
                mask_probs[j] = det["mask_probs"][keep][keep_nms, :, :, j]
    if with_rows:
        return cls_dets, mask_probs, det_rows
    return cls_dets, mask_probs


def cap_detections(
    cls_dets: ClsDets,
    max_per_image: int,
    mask_probs: Optional[Dict[int, np.ndarray]] = None,
    rows: Optional[Dict[int, np.ndarray]] = None,
):
    """Cross-class per-image cap (the reference's ``max_per_image``): keep
    the top ``max_per_image`` detections by score across classes (every
    detection scoring at least the cut); a no-op when ``max_per_image`` <= 0.
    ``mask_probs`` and ``rows`` (``detections_from_output``'s side
    channels) are filtered in lockstep; ``rows`` comes back as a third
    element when given."""
    num_classes = len(cls_dets)
    if max_per_image > 0:
        all_scores = np.concatenate([cls_dets[j][:, 4] for j in range(1, num_classes)])
        if len(all_scores) > max_per_image:
            cut = np.sort(all_scores)[-max_per_image]
            for j in range(1, num_classes):
                keep = cls_dets[j][:, 4] >= cut
                cls_dets[j] = cls_dets[j][keep]
                if mask_probs is not None:
                    mask_probs[j] = mask_probs[j][keep]
                if rows is not None and rows.get(j) is not None:
                    rows[j] = rows[j][keep]
    if rows is not None:
        return cls_dets, mask_probs, rows
    return cls_dets, mask_probs


# ----------------------------------------------------------------- prepare
def prepare_request(
    im: np.ndarray,
    cfg: Config,
    ladder: BucketLadder,
    deadline: Optional[float] = None,
    model: Optional[str] = None,
) -> Request:
    """Original RGB image → bucket-padded :class:`Request`: resize to the
    dataset SCALES, uint8-quantize (TEST.UINT8_TRANSFER) or normalize, pad
    into the smallest bucket; an oversize image raises ``BucketOverflow``.
    Runs in the submitting thread, so host preparation overlaps the
    device's work on earlier batches."""
    im = np.asarray(im, np.float32)
    orig_hw = (int(im.shape[0]), int(im.shape[1]))
    target, max_size = cfg.dataset.SCALES[0]
    im, scale = resize_im(im, target, max_size)
    h, w = im.shape[:2]
    bucket = ladder.select(h, w)
    if cfg.TEST.UINT8_TRANSFER:
        im = quantize_uint8(im)
    else:
        im = normalize(im, cfg.network.PIXEL_MEANS, cfg.network.PIXEL_STDS)
    return Request(
        image=pad_to_bucket(im, bucket),
        im_info=np.array([h, w, scale], np.float32),
        orig_hw=orig_hw,
        bucket=bucket,
        enqueue_t=time.monotonic(),
        deadline=deadline,
        model=model,
    )


# ------------------------------------------------------------------ runner
@dataclasses.dataclass
class ServeHandle:
    """Result of :meth:`ServeRunner.dispatch`: the forward is enqueued and
    its outputs' batched device → host copy started behind it
    (:class:`~mx_rcnn_tpu_torch.core.tester.PendingFetch`), nothing waited
    for.  :meth:`ServeRunner.complete` reads it."""

    outputs: PendingFetch
    model: str
    signature: Tuple
    bucket: Tuple[int, int]
    dispatch_t: float


class _ModelSlot:
    """One model family's device-facing state on one runner: its module
    behind a :class:`Predictor`, holding whatever version this runner last
    synced to.  ``lock`` is held by every forward of the module while it
    enqueues and by every weight swap, so a swap lands between batches."""

    def __init__(self, model_id, predictor, version, cfg, num_classes,
                 uint8: bool, precision: str = "f32"):
        self.model_id = model_id
        self.predictor = predictor
        self.version = int(version)
        self.cfg = cfg
        self.num_classes = int(num_classes)
        self.uint8 = bool(uint8)
        self.precision = precision  # signature tag: "f32" | "bf16" | "int8"
        self.lock = make_lock("_ModelSlot.lock")


class ServeRunner:
    """Device-facing predict path shared by the engine, the CLI and tests.

    Two construction modes:

    * single model: ``ServeRunner(model, params, cfg, ...)`` builds a
      private one-entry registry under
      :data:`~mx_rcnn_tpu_torch.serve.registry.DEFAULT_MODEL`;
    * shared registry: ``ServeRunner(registry=reg, ...)`` serves every
      family in ``reg``; requests carry ``model=`` and each family gets
      its own :class:`_ModelSlot`, all accounted in one signature cache
      keyed ``(model, shape, dtype, precision)``.

    ``device`` is where every slot's module runs: the card unless the
    caller names another (``"cpu"`` runs the kernels' plain versions).
    ``params`` may be any form
    :func:`~mx_rcnn_tpu_torch.serve.registry.as_state_dict` takes."""

    def __init__(
        self,
        model=None,
        params=None,
        cfg: Optional[Config] = None,
        num_classes: Optional[int] = None,
        ladder: Optional[BucketLadder] = None,
        max_batch: int = 4,
        registry=None,
        device=None,
        mask_canvas: Optional[bool] = None,
        precision: Optional[Union[str, Dict[str, str]]] = None,
    ):
        from mx_rcnn_tpu_torch.serve.registry import DEFAULT_MODEL, ModelRegistry

        if registry is None:
            if model is None or params is None or cfg is None:
                raise ValueError("ServeRunner needs (model, params, cfg) or registry=")
            registry = ModelRegistry()
            registry.register(DEFAULT_MODEL, model, cfg, params)
        self.registry = registry
        self.device = resolve_device(device)
        self.default_model = registry.default_model
        self.cfg = cfg if cfg is not None else registry.entry(self.default_model).cfg
        self._num_classes_override = num_classes
        self.num_classes = self.cfg.dataset.NUM_CLASSES if num_classes is None else num_classes
        self.ladder = ladder if ladder is not None else BucketLadder(self.cfg.SHAPE_BUCKETS)
        self.max_batch = int(max_batch)
        self.uint8 = bool(self.cfg.TEST.UINT8_TRANSFER)
        self.compile_cache = CompileCache()
        self._mask_canvas = mask_canvas
        # serve-graph precision: a string applies to every model, a dict
        # assigns per model
        self._precision = precision
        # "model:precision" → last gate report
        self.parity: Dict[str, Dict] = {}
        self._slots: Dict[str, _ModelSlot] = {}
        self._slots_lock = make_lock("ServeRunner._slots_lock")
        self._staged: Dict[Tuple[str, int], Dict[str, torch.Tensor]] = {}  # (model, ver)
        self.served_buckets: Dict[str, set] = {}
        self.swaps_applied = 0
        # counters, cumulative; written under _stats_lock (two completion
        # threads complete at once), read unlocked by snapshots
        self._stats_lock = make_lock("ServeRunner._stats_lock")
        self.split_dispatches = 0
        self.split_completes = 0
        self.fetch_stall_s = 0.0  # wall time blocked in complete()'s fetch
        # bytes of every complete()'s host copy, per model and in total
        self.fetch_bytes_total = 0
        self.fetch_bytes_by_model: Dict[str, int] = {}
        self.last_fetch_bytes = 0
        # dispatch → complete wall per batch (enqueue, device work and the
        # fetch), attributed to the serving model
        self.device_ms_total = 0.0
        self.device_ms_by_model: Dict[str, float] = {}
        self.last_device_ms = 0.0
        # mask paste + RLE host wall and the mask payload it consumed
        self.pastes = 0
        self.paste_ms_total = 0.0
        self.paste_bytes_total = 0
        self.paste_ms_by_model: Dict[str, float] = {}
        self.paste_bytes_by_model: Dict[str, int] = {}
        self.last_paste_ms = 0.0
        self.last_paste_bytes = 0
        # build the default slot eagerly: construction fails fast on a bad
        # config, and single-model callers read .predictor at once
        self._slot(self.default_model)

    # ---- registry resolution
    def _precision_for(self, model_id: str) -> str:
        """Signature precision tag for ``model_id`` ("f32"/"bf16"/"int8")."""
        p = self._precision
        if isinstance(p, dict):
            p = p.get(model_id)
        tag = _PRECISION_TAGS.get(p)
        if tag is None:
            raise ValueError(f"unknown serve precision {p!r}")
        return tag

    def _parity_key(self, model_id: str, precision: str) -> str:
        return f"{model_id}:{precision}"

    def _module(self, model_id: str, cfg: Config, state: Dict[str, torch.Tensor]):
        """A new module of the registered model's class at ``cfg`` on this
        runner's device, holding ``state``.  Built on the meta device, so
        no random initialisation runs for weights that are overwritten."""
        with torch.device("meta"):
            m = type(self.registry.entry(model_id).model)(cfg)
        m = m.to_empty(device=self.device)
        m.load_state_dict(state)
        return m

    def _int8_state(self, model_id: str, version: int) -> Dict[str, torch.Tensor]:
        """The int8 rung's weights of a version: the registry's quantized
        tree, dequantized and carried into the module's layout."""
        from mx_rcnn_tpu_torch.core.quantize import dequantize_tree
        from mx_rcnn_tpu_torch.utils.bridge import flax_state_dict

        qtree = self.registry.quantized_tree(model_id, version)
        return flax_state_dict(dequantize_tree(qtree), self.registry.live(model_id).params)

    def _slot(self, model_id: str) -> _ModelSlot:
        s = self._slots.get(model_id)
        if s is not None:
            return s
        with self._slots_lock:
            s = self._slots.get(model_id)
            if s is not None:
                return s
            e = self.registry.entry(model_id)
            live = self.registry.live(model_id)
            cfg = e.cfg
            precision = self._precision_for(model_id)
            if precision == "bf16":
                # the inference graph of bench.py: bf16 compute with the BN
                # affine folded into the conv kernels; the tensor names are
                # the same, so the registry's f32 params load as they are
                cfg = cfg.replace(network=dataclasses.replace(
                    cfg.network, COMPUTE_DTYPE="bfloat16", FOLD_BN=True))
            if model_id == self.default_model and self._num_classes_override is not None:
                n_cls = self._num_classes_override
            else:
                n_cls = cfg.dataset.NUM_CLASSES
            post = None
            if cfg.TEST.DEVICE_POSTPROCESS:
                from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess

                use_canvas = (getattr(cfg.TEST, "MASK_CANVAS", False) if self._mask_canvas is None
                              else self._mask_canvas)
                post = make_test_postprocess(
                    cfg, n_cls, cfg.TEST.SCORE_THRESH, max_out=cfg.TEST.DET_PER_CLASS,
                    paste=bool(use_canvas and cfg.network.USE_MASK))
            if precision == "int8":
                # scales folded once per version by the registry, shared by
                # every runner; the slot holds the dequantized weights
                self.registry.enable_quantization(model_id)
                state = self._int8_state(model_id, live.version)
            else:
                state = live.params
            predictor = Predictor(self._module(model_id, cfg, state), postprocess=post,
                                  device=self.device)
            s = _ModelSlot(model_id, predictor, live.version, cfg, n_cls,
                           bool(cfg.TEST.UINT8_TRANSFER), precision=precision)
            self._slots[model_id] = s
            return s

    def _load_into(self, slot: _ModelSlot, state: Dict[str, torch.Tensor]) -> None:
        """Copy ``state`` into the slot's module in place (caller holds the
        slot lock).  The copies queue on this thread's current stream, the
        default one the forwards use, behind every forward already
        dispatched; the folded-BN cache sees the tensors' versions move and
        refolds at the next forward."""
        with torch.no_grad():
            for k, t in slot.predictor.model.state_dict().items():
                t.copy_(state[k], non_blocking=True)

    def _sync(self, slot: _ModelSlot) -> None:
        """Apply a committed (or rolled-back) version flip: copy the
        registry's live version into the slot's module, between batches."""
        live = self.registry.live(slot.model_id)
        if live.version == slot.version:
            return
        with slot.lock:
            live = self.registry.live(slot.model_id)
            if live.version == slot.version:
                return
            staged = self._staged.pop((slot.model_id, live.version), None)
            # any other staged copy of this model is a candidate that lost
            # (rolled back or cancelled): drop it now
            for k in [k for k in self._staged if k[0] == slot.model_id]:
                self._staged.pop(k, None)
            if staged is None:
                staged = (self._int8_state(slot.model_id, live.version)
                          if slot.precision == "int8" else live.params)
            self._load_into(slot, staged)
            slot.version = live.version
            self.swaps_applied += 1

    @property
    def predictor(self) -> Predictor:
        """The default model's predictor (single-model surface)."""
        return self._slot(self.default_model).predictor

    # ---- request/batch plumbing
    def make_request(self, im: np.ndarray, deadline: Optional[float] = None,
                     model: Optional[str] = None) -> Request:
        if model is None:
            return prepare_request(im, self.cfg, self.ladder, deadline)
        return prepare_request(im, self.registry.entry(model).cfg, self.ladder, deadline,
                               model=model)

    def assemble(self, requests: List[Request]) -> Dict[str, np.ndarray]:
        """(model, bucket)-homogeneous requests → a host batch padded to
        ``max_batch`` (pad slots replicate slot 0, so every bucket keeps one
        input shape and pad work is never a fresh code path)."""
        n = len(requests)
        if not 0 < n <= self.max_batch:
            raise ValueError(f"batch of {n} vs max_batch={self.max_batch}")
        bh, bw = requests[0].bucket
        if any(r.bucket != (bh, bw) for r in requests):
            raise ValueError("mixed buckets in one batch")
        mid = requests[0].model
        if any(r.model != mid for r in requests):
            raise ValueError("mixed models in one batch")
        uint8 = self._slot(self.default_model if mid is None else mid).uint8
        images = np.zeros((self.max_batch, bh, bw, 3), np.uint8 if uint8 else np.float32)
        im_info = np.zeros((self.max_batch, 3), np.float32)
        orig_hw = np.zeros((self.max_batch, 2), np.float32)
        for i, r in enumerate(requests):
            images[i] = r.image
            im_info[i] = r.im_info
            orig_hw[i] = r.orig_hw
        for i in range(n, self.max_batch):
            images[i] = images[0]
            im_info[i] = im_info[0]
            orig_hw[i] = orig_hw[0]
        return {"images": images, "im_info": im_info, "orig_hw": orig_hw}

    def _signature(self, batch: Dict[str, np.ndarray], model: Optional[str] = None) -> Tuple:
        mid = self.default_model if model is None else model
        return (
            mid,
            tuple(batch["images"].shape),
            str(batch["images"].dtype),
            self._precision_for(mid),
        )

    def dispatch(self, batch: Dict[str, np.ndarray], model: Optional[str] = None) -> ServeHandle:
        """First half of the predict path: sync the slot to the live
        version, account the signature, enqueue the forward (under the slot
        lock) and start its outputs' device → host copy.  Returns without
        waiting for the device."""
        mid = self.default_model if model is None else model
        slot = self._slot(mid)
        self._sync(slot)
        sig = self._signature(batch, mid)
        self.compile_cache.record(sig)
        bucket = tuple(batch["images"].shape[1:3])
        t0 = time.monotonic()
        with slot.lock:
            fetch = PendingFetch(slot.predictor.predict_async(batch))
        with self._stats_lock:
            self.served_buckets.setdefault(mid, set()).add(bucket)
            self.split_dispatches += 1
        return ServeHandle(outputs=fetch, model=mid, signature=sig, bucket=bucket,
                           dispatch_t=t0)

    def complete(self, handle: ServeHandle) -> Dict[str, np.ndarray]:
        """Second half: wait for the handle's copy (its event only, no
        device-wide synchronize, so other threads' forwards go on) and
        return the outputs as host numpy arrays that own their memory."""
        t0 = time.monotonic()
        out = handle.outputs.result()
        done = time.monotonic()
        nbytes = sum(int(v.nbytes) for v in out.values())
        dt_ms = (done - handle.dispatch_t) * 1000.0
        with self._stats_lock:
            self.fetch_stall_s += done - t0
            self.split_completes += 1
            self.last_fetch_bytes = nbytes
            self.fetch_bytes_total += nbytes
            self.fetch_bytes_by_model[handle.model] = (
                self.fetch_bytes_by_model.get(handle.model, 0) + nbytes)
            self.last_device_ms = dt_ms
            self.device_ms_total += dt_ms
            self.device_ms_by_model[handle.model] = (
                self.device_ms_by_model.get(handle.model, 0.0) + dt_ms)
        return out

    def run(self, batch: Dict[str, np.ndarray], model: Optional[str] = None
            ) -> Dict[str, np.ndarray]:
        """Blocking forward through ``model``'s slot (the default model when
        None): exactly :meth:`complete` ∘ :meth:`dispatch`."""
        return self.complete(self.dispatch(batch, model=model))

    def _probe_request(self, model_id: str, bucket: Tuple[int, int]) -> Request:
        bh, bw = bucket
        uint8 = self._slot(model_id).uint8
        return Request(
            image=np.zeros((bh, bw, 3), np.uint8 if uint8 else np.float32),
            im_info=np.array([bh, bw, 1.0], np.float32),
            orig_hw=(bh, bw),
            bucket=(bh, bw),
            model=None if model_id == self.default_model else model_id,
        )

    def warmup(self, buckets=None, models=None) -> int:
        """Run every serving rung once; returns the signature count.

        Default: every registered model × every ladder rung.  ``buckets``
        narrows it: a dict ``{model: iterable of (H, W)}`` warms exactly
        those rungs; a plain iterable applies to ``models`` (the default
        model when unset).  On the card the kernels' libraries are built
        first (``build_all``), so no build lands inside a timed window, and
        the first forward of each rung settles cuDNN's choices.  A bf16 or
        int8 slot then passes :meth:`check_parity` or raises.  After
        warmup, ``compile_cache.misses`` must not grow."""
        if self.device.type == "cuda":
            from mx_rcnn_tpu_torch.ops import nms, roi_align, roi_align_stream
            from mx_rcnn_tpu_torch.utils.cuda_build import build_all

            build_all((nms.library, roi_align.library, roi_align_stream.library))
        if isinstance(buckets, dict):
            per = {m: sorted(bs) for m, bs in buckets.items() if bs}
            if not per:
                per = {m: list(self.ladder) for m in self.registry.model_ids()}
        elif buckets is not None:
            per = {m: sorted(buckets) for m in (models if models else [self.default_model])}
        else:
            per = {m: list(self.ladder) for m in (models if models else self.registry.model_ids())}
        for mid, rungs in per.items():
            slot = self._slot(mid)
            self._sync(slot)
            for bucket in rungs:
                self.run(self.assemble([self._probe_request(mid, tuple(bucket))]), model=mid)
            if (slot.precision in ("bf16", "int8")
                    and self._parity_key(mid, slot.precision) not in self.parity):
                self.check_parity(mid)
        return self.compile_cache.misses

    # ---- serve-graph precision parity gate
    def _parity_batch(self, mid: str, bucket: Tuple[int, int]) -> Dict:
        """Deterministic noise probe batch (zeros would make the comparison
        vacuous: no proposal clears the score threshold)."""
        bh, bw = bucket
        slot = self._slot(mid)
        rng = np.random.RandomState(0)
        im = rng.randint(0, 256, (bh, bw, 3)).astype(np.uint8 if slot.uint8 else np.float32)
        req = Request(
            image=im,
            im_info=np.array([bh, bw, 1.0], np.float32),
            orig_hw=(bh, bw),
            bucket=(bh, bw),
            model=None if mid == self.default_model else mid,
        )
        return self.assemble([req])

    def check_parity(self, model: Optional[str] = None,
                     bucket: Optional[Tuple[int, int]] = None) -> Dict:
        """Gate a reduced-precision rung (bf16 compute or int8 weights) on
        detection parity with the f32 graph.

        One deterministic probe batch (the smallest ladder rung unless
        ``bucket`` says otherwise) runs through the model's slot AND a
        transient f32 module of the registered class holding the live
        params, with the slot's postprocess flavor; the detections are
        compared with :func:`detection_parity` (and for a mask family the
        matched pairs' grids with :func:`mask_parity`).  Outside the
        tolerance → :class:`PrecisionParityError`.  The f32 module runs off
        the serving path and is not recorded in the signature cache.  The
        report lands in ``self.parity["model:precision"]``."""
        mid = self.default_model if model is None else model
        slot = self._slot(mid)
        if slot.precision not in ("bf16", "int8"):
            report = {"precision": slot.precision, "checked": False}
            self.parity[self._parity_key(mid, slot.precision)] = report
            return report
        bucket = tuple(bucket) if bucket else next(iter(self.ladder))
        batch = self._parity_batch(mid, bucket)
        e = self.registry.entry(mid)
        live = self.registry.live(mid)
        self._sync(slot)
        with slot.lock:
            fetch = PendingFetch(slot.predictor.predict_async(batch))
        out_rp = fetch.result()
        post = None
        if "det_boxes" in out_rp:
            from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess

            post = make_test_postprocess(
                e.cfg, slot.num_classes, e.cfg.TEST.SCORE_THRESH,
                max_out=e.cfg.TEST.DET_PER_CLASS, paste="det_canvas" in out_rp)
        ref = Predictor(self._module(mid, e.cfg, live.params), postprocess=post,
                        device=self.device)
        out_f32 = ref.predict(batch)
        del ref
        thresh = float(slot.cfg.TEST.SCORE_THRESH)
        dets_rp, masks_rp = self.detections_for(out_rp, batch, 0, model=model, with_masks=True)
        ref_dets, ref_masks = detections_from_output(
            out_f32, batch["im_info"][0], tuple(batch["orig_hw"][0]), e.cfg, slot.num_classes)
        ref_dets, ref_masks = cap_detections(ref_dets, e.cfg.TEST.MAX_PER_IMAGE, ref_masks)
        report = detection_parity(ref_dets, dets_rp, thresh, margin=PARITY_MARGIN)
        report.update(precision=slot.precision, checked=True, bucket=list(bucket),
                      box_tol_px=PARITY_BOX_TOL, score_tol=PARITY_SCORE_TOL)
        mask_ok = True
        if e.cfg.network.USE_MASK:
            report.update(mask_parity(ref_dets, ref_masks or {}, dets_rp, masks_rp or {},
                                      thresh, margin=PARITY_MARGIN))
            report["mask_tol"] = PARITY_MASK_TOL
            mask_ok = report["max_mask_prob_delta"] <= PARITY_MASK_TOL
        ok = (report["unmatched_confident"] == 0
              and report["max_box_delta_px"] <= PARITY_BOX_TOL
              and report["max_score_delta"] <= PARITY_SCORE_TOL
              and mask_ok)
        report["ok"] = ok
        self.parity[self._parity_key(mid, slot.precision)] = report
        if not ok:
            raise PrecisionParityError(
                f"{slot.precision} serve graph for model {mid!r} outside parity "
                f"tolerance vs f32: {report}")
        return report

    # ---- hot swap (the SwapController's target surface)
    def _stage(self, slot: _ModelSlot, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A device copy of ``state`` beside the slot's live weights, each
        tensor with its live twin's layout (channels_last kernels)."""
        with torch.no_grad():
            return {k: torch.empty_like(t).copy_(state[k])
                    for k, t in slot.predictor.model.state_dict().items()}

    def _predict_with(self, slot: _ModelSlot, placed: Dict[str, torch.Tensor],
                      batch: Dict) -> Dict[str, np.ndarray]:
        with slot.lock:
            fetch = PendingFetch(slot.predictor.predict_async(batch, params=placed))
        return fetch.result()

    def warm_version(self, model: Optional[str], version: int, params, buckets=None,
                     abort=None) -> int:
        """Stage CANDIDATE params on the device, off the live path, and
        drive them through this runner's served signatures for ``model``
        (the slot's module with the candidate's tensors: zero new
        signatures).  The staged copy is parked under ``(model, version)``
        for :meth:`_sync` to load at commit.  ``abort`` (the controller's
        cancel hook) is called before the device copy and between rungs.
        Returns the number of rungs warmed."""
        from mx_rcnn_tpu_torch.serve.registry import UnknownVersion, as_state_dict

        mid = self.default_model if model is None else model
        slot = self._slot(mid)
        if abort is not None:
            abort()
        if slot.precision == "int8":
            # the slot's own form, from the registry's per-version fold
            # (made once on the swap's restore path); a version outside the
            # registry is quantized here
            try:
                state = self._int8_state(mid, int(version))
            except UnknownVersion:
                from mx_rcnn_tpu_torch.core.quantize import dequantize_tree, quantize_tree
                from mx_rcnn_tpu_torch.utils.bridge import flax_state_dict, state_dict_to_flax

                live = self.registry.live(mid).params
                state = flax_state_dict(
                    dequantize_tree(quantize_tree(state_dict_to_flax(as_state_dict(
                        params, self.registry.entry(mid).model)))), live)
        else:
            state = as_state_dict(params, self.registry.entry(mid).model)
        placed = self._stage(slot, state)
        if buckets is None:
            buckets = sorted(self.served_buckets.get(mid, ())) or list(self.ladder)
        warmed = 0
        for bucket in buckets:
            if abort is not None:
                abort()
            self._predict_with(slot, placed, self.assemble([self._probe_request(mid, tuple(bucket))]))
            warmed += 1
        self._staged[(mid, int(version))] = placed
        return warmed

    def canary(self, model: Optional[str] = None) -> int:
        """One probe batch through the LIVE path (smallest served rung):
        forces :meth:`_sync` onto the just-committed version and proves the
        swapped slot serves.  Raising here is the rollback trigger."""
        mid = self.default_model if model is None else model
        served = sorted(self.served_buckets.get(mid, ()))
        bucket = served[0] if served else next(iter(self.ladder))
        self.run(self.assemble([self._probe_request(mid, bucket)]), model=mid)
        return 1

    def discard_version(self, model: Optional[str], version: int) -> None:
        """Drop a losing candidate's staged device copy (rollback or
        cancel cleanup)."""
        mid = self.default_model if model is None else model
        self._staged.pop((mid, int(version)), None)

    def run_version(self, batch: Dict[str, np.ndarray], model: Optional[str] = None,
                    version: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Blocking forward through an EXPLICIT version: the live slot when
        ``version`` is the live one (or None), else the staged candidate
        parked by :meth:`warm_version`, on the same module and rungs (zero
        new signatures).  Raises
        :class:`~mx_rcnn_tpu_torch.serve.registry.UnknownVersion` when the
        version is neither live nor staged."""
        from mx_rcnn_tpu_torch.serve.registry import UnknownVersion

        mid = self.default_model if model is None else model
        slot = self._slot(mid)
        self._sync(slot)
        if version is None or int(version) == slot.version:
            return self.run(batch, model=mid)
        placed = self._staged.get((mid, int(version)))
        if placed is None:
            raise UnknownVersion(
                f"model {mid!r} v{int(version)} is neither live (v{slot.version}) nor "
                f"staged on this runner")
        self.compile_cache.record(self._signature(batch, mid))
        with self._stats_lock:
            self.served_buckets.setdefault(mid, set()).add(tuple(batch["images"].shape[1:3]))
        return self._predict_with(slot, placed, batch)

    # ---- per-image postprocess
    def detections_for(
        self,
        out: Dict[str, np.ndarray],
        batch: Dict[str, np.ndarray],
        index: int,
        orig_hw: Optional[Tuple[float, float]] = None,
        thresh: Optional[float] = None,
        model: Optional[str] = None,
        with_masks: bool = False,
    ) -> ClsDets:
        """Per-image capped detections; ``with_masks=True`` returns
        ``(cls_dets, mask_probs)`` instead (mask_probs None for box
        families)."""
        slot = self._slot(self.default_model if model is None else model)
        if orig_hw is None:
            orig_hw = tuple(batch["orig_hw"][index])
        cls_dets, mask_probs = detections_from_output(
            out, batch["im_info"][index], orig_hw, slot.cfg, slot.num_classes, index=index,
            thresh=thresh)
        cls_dets, mask_probs = cap_detections(cls_dets, slot.cfg.TEST.MAX_PER_IMAGE, mask_probs)
        if with_masks:
            return cls_dets, mask_probs
        return cls_dets

    def mask_rles_for(
        self,
        out: Dict[str, np.ndarray],
        batch: Dict[str, np.ndarray],
        index: int,
        orig_hw: Optional[Tuple[float, float]] = None,
        thresh: Optional[float] = None,
        model: Optional[str] = None,
    ):
        """Per-image capped detections + CANVAS-space mask RLEs: ``(cls_dets,
        rles)`` with ``rles[j]`` aligned row for row with ``cls_dets[j]``, in
        the bucket canvas the image was padded to.  Two paths, identical
        bytes by construction: the device canvas (``det_canvas`` in ``out``;
        the host only RLE-encodes) and the host paste of each survivor's
        LOGIT grid (``eval/segm.py::canvas_rles``).  Accounts the paste's
        host wall and mask payload per model."""
        from mx_rcnn_tpu_torch.eval.segm import canvas_rles
        from mx_rcnn_tpu_torch.native import rle as rle_mod

        if "det_masks" not in out:
            raise ValueError(
                "mask_rles_for needs the device-postprocess mask outputs (det_masks); "
                "raw-head batches have no canvas contract")
        mid = self.default_model if model is None else model
        slot = self._slot(mid)
        if orig_hw is None:
            orig_hw = tuple(batch["orig_hw"][index])
        cls_dets, _probs, rows = detections_from_output(
            out, batch["im_info"][index], orig_hw, slot.cfg, slot.num_classes, index=index,
            thresh=thresh, with_rows=True)
        cls_dets, _probs, rows = cap_detections(
            cls_dets, slot.cfg.TEST.MAX_PER_IMAGE, _probs, rows=rows)
        midx = np.asarray(out["det_mask_idx"][index])
        lut = {int(f): p for p, f in enumerate(midx) if f >= 0}
        max_out_dim = out["det_boxes"].shape[2]
        hc = int(batch["images"].shape[1])
        wc = int(batch["images"].shape[2])
        scale = float(batch["im_info"][index][2])
        canvas = out.get("det_canvas")
        rles: Dict[int, list] = {}
        t0 = time.monotonic()
        if canvas is not None:
            cv = np.asarray(canvas[index])
            nbytes = int(cv.nbytes)
            empty = np.zeros((hc, wc), np.uint8)
            for j in range(1, slot.num_classes):
                out_j = []
                for rr in rows[j]:
                    p = lut.get((j - 1) * max_out_dim + int(rr))
                    # an unmapped row exists only past the device's max_det
                    # budget; its device canvas would be all zeros too
                    out_j.append(rle_mod.encode(np.ascontiguousarray(cv[p]) if p is not None
                                                else empty))
                rles[j] = out_j
        else:
            grids_all = np.asarray(out["det_masks"][index])
            nbytes = int(grids_all.nbytes)
            fill = np.full(grids_all.shape[1:], MASK_FILL, np.float32)
            for j in range(1, slot.num_classes):
                grids = [grids_all[lut[(j - 1) * max_out_dim + int(rr)]]
                         if (j - 1) * max_out_dim + int(rr) in lut else fill
                         for rr in rows[j]]
                rles[j] = canvas_rles(grids, cls_dets[j], scale, hc, wc)
        dt = time.monotonic() - t0
        with self._stats_lock:
            self.pastes += 1
            self.last_paste_ms = dt * 1000.0
            self.last_paste_bytes = nbytes
            self.paste_ms_total += dt * 1000.0
            self.paste_bytes_total += nbytes
            self.paste_ms_by_model[mid] = self.paste_ms_by_model.get(mid, 0.0) + dt * 1000.0
            self.paste_bytes_by_model[mid] = self.paste_bytes_by_model.get(mid, 0) + nbytes
        return cls_dets, rles

    # ---- synchronous single image (demo path)
    def detect(self, im: np.ndarray, thresh: Optional[float] = None) -> ClsDets:
        req = self.make_request(im)
        batch = self.assemble([req])
        out = self.run(batch)
        return self.detections_for(out, batch, 0, thresh=thresh)


def detect_single(
    predictor: Predictor,
    im: np.ndarray,
    cfg: Config,
    num_classes: int,
    thresh: Optional[float] = None,
) -> ClsDets:
    """One-shot detection of one RGB image with a caller-owned
    :class:`Predictor`.  Batch of 1, no cross-class cap.  ``thresh`` applies
    on the host flavor (a Predictor without the device postprocess); the
    device postprocess carries its own."""
    req = prepare_request(im, cfg, BucketLadder(cfg.SHAPE_BUCKETS))
    batch = {
        "images": req.image[None],
        "im_info": req.im_info[None],
        "orig_hw": np.asarray([req.orig_hw], np.float32),
    }
    out = predictor.predict(batch)
    cls_dets, _ = detections_from_output(
        out, batch["im_info"][0], req.orig_hw, cfg, num_classes, thresh=thresh
    )
    return cls_dets
