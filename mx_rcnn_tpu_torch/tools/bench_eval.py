"""Inference throughput benchmark: the flagship test forward with its
detection postprocess, and the host data-plane benchmark (port of
``mx_rcnn_tpu/tools/bench_eval.py``).

Usage: python -m mx_rcnn_tpu_torch.tools.bench_eval [--batch 8] [--images 64]
    [--host_path] [--smoke] [--data_plane] [--cpu]
    [--assembly_workers N] [--postprocess_workers N] [--prepared_cache N]
Prints one JSON line.

Modes:

- default: the flagship model, uint8 image transfer and the device-side
  per-class decode + NMS after the forward (``ops/postprocess.py``): only
  the keep lists come back to the host;
- ``--host_path``: the reference-style loop: float32 upload, the full head
  outputs fetched, per-class C NMS on the host (``native/hostops.py``);
- ``--smoke``: a CPU-feasible model size (256² bucket, shrunk RPN budgets,
  4 classes);
- ``--data_plane``: the host stages alone: flagship-size assembly and the
  real per-class host postprocess around a stub device that stalls
  ``--stub_device_ms`` a batch.  The serial configuration and the
  overlapped one (assembly pool, prepared-canvas cache, completion pool)
  run in one process over the same seeded stream; the report gives both,
  the speedup and whether their detections are byte-identical.

Runs on the card unless ``--cpu``.  The metric names are the JAX tool's
(``eval_imgs_per_sec_per_chip_<network>``, unit ``imgs/sec/chip``): here a
chip is one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import zlib
from typing import List, Optional


def _smoke_shrink(cfg):
    """CPU-feasible eval sizing: 256² bucket, shrunk proposal budgets, 4
    classes."""
    return cfg.replace(
        SHAPE_BUCKETS=((256, 256),),
        dataset=dataclasses.replace(cfg.dataset, NUM_CLASSES=4, SCALES=((256, 256),)),
        TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=32),
    )


# ------------------------------------------------------------- data plane
class _StubPredictor:
    """Device stand-in for the data-plane benchmark: stalls (releasing the
    interpreter lock, like a device round trip) for a fixed time a batch,
    then returns deterministic pseudo head outputs derived from the batch's
    pixels, so the postprocess does its real work and two sweeps over one
    stream give bitwise-identical detections."""

    def __init__(self, stall_s: float, num_classes: int, rois: int = 32):
        self.stall_s = stall_s
        self.num_classes = num_classes
        self.rois = rois

    def _outputs(self, batch):
        import numpy as np

        n = batch["images"].shape[0]
        im_info = np.asarray(batch["im_info"])
        # seeded from a strided pixel sample, not im_info: a uniform-size
        # roidb has equal im_info rows in every batch, and equal pseudo
        # outputs would let a wrong-slot accumulation pass the bitwise check
        sample = np.ascontiguousarray(np.asarray(batch["images"])[:, ::64, ::64])
        seed = zlib.crc32(sample.tobytes()) & 0x7FFFFFFF
        rng = np.random.RandomState(seed)
        r, k = self.rois, self.num_classes
        h = im_info[:, 0][:, None, None]
        w = im_info[:, 1][:, None, None]
        xy = rng.uniform(0.0, 0.8, (n, r, 2))
        wh = rng.uniform(0.05, 0.2, (n, r, 2))
        rois = np.concatenate(
            [xy[..., :1] * w, xy[..., 1:] * h,
             (xy[..., :1] + wh[..., :1]) * w,
             (xy[..., 1:] + wh[..., 1:]) * h],
            axis=-1,
        ).astype(np.float32)
        return {
            "rois": rois,
            "roi_valid": np.ones((n, r), np.float32),
            "cls_prob": rng.dirichlet(np.ones(k), size=(n, r)).astype(np.float32),
            "bbox_deltas": (rng.standard_normal((n, r, 4 * k)) * 0.05).astype(np.float32),
        }

    def predict(self, batch):
        out = self._outputs(batch)
        time.sleep(self.stall_s)
        return out

    def predict_async(self, batch):
        return self.predict(batch)


def data_plane_report(
    images: int = 64,
    batch: int = 8,
    stub_device_ms: float = 110.0,
    assembly_workers: int = 2,
    postprocess_workers: int = 2,
    prepared_cache: int = 128,
    in_flight: int = 2,
    network: str = "resnet",
    detections_out: Optional[List] = None,
) -> dict:
    """The host stages around a stub device at the flagship image size; →
    the report dict.

    Both sweeps run in this process over the same seeded stream:
    ``baseline`` is serial assembly on the one prefetch thread, the
    postprocess inline on the dispatch thread and no prepared cache;
    ``overlapped`` the assembly pool, the prepared-canvas LRU and the
    completion pool.  Their accumulated per-image detections are compared
    byte for byte.  ``detections_out``, a list, receives the baseline
    sweep's per-image detections (each image's per-class arrays)."""
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import pipelined
    from mx_rcnn_tpu_torch.data import loader as loader_mod
    from mx_rcnn_tpu_torch.data.assembler import CompletionPool
    from mx_rcnn_tpu_torch.data.loader import TestLoader, set_prepared_cache
    from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from mx_rcnn_tpu_torch.serve.runner import cap_detections, detections_from_output

    cfg = generate_config(network, "PascalVOC")
    # the host path on purpose: float32 normalize in assembly and the full
    # per-class host NMS in completion (the device postprocess moves that
    # work onto the card, which a stub cannot represent)
    cfg = cfg.replace(
        TEST=dataclasses.replace(cfg.TEST, DEVICE_POSTPROCESS=False, UINT8_TRANSFER=False))
    h, w = cfg.SHAPE_BUCKETS[0]
    num_classes = cfg.dataset.NUM_CLASSES
    imdb = SyntheticDataset(num_images=images, num_classes=num_classes,
                            image_size=(h - 8, w - 24), max_boxes=6)
    roidb = imdb.gt_roidb()
    loader = TestLoader(roidb, cfg, batch_size=batch)
    # flagship-shaped outputs: the host decode + NMS cost is real only at
    # the real roi count (TEST.RPN_POST_NMS_TOP_N)
    predictor = _StubPredictor(stub_device_ms / 1000.0, num_classes,
                               rois=cfg.TEST.RPN_POST_NMS_TOP_N)

    def sweep(aw: int, pw: int):
        """One full pass → (elapsed s, per-image detections, detection
        bytes, stats)."""
        slots = [None] * images
        stats: dict = {}
        completion = CompletionPool(pw, name="bench-complete")
        stream = loader.iter_batched(assembly_workers=aw)

        def post(idxs, recs, batch_, out):
            for k, (i, rec) in enumerate(zip(idxs, recs)):
                cls_dets, _ = detections_from_output(
                    out, batch_["im_info"][k], (rec["height"], rec["width"]),
                    cfg, num_classes, index=k)
                cls_dets, _ = cap_detections(cls_dets, cfg.TEST.MAX_PER_IMAGE)
                slots[i] = cls_dets

        t0 = time.perf_counter()
        try:
            for (idxs, recs), batch_, out in pipelined(
                predictor,
                (((idxs, recs), batch_) for idxs, recs, batch_ in stream),
                in_flight=in_flight,
                feed_depth=0,  # stub device: nothing to stage
                stats_out=stats,
                mode="threads",
            ):
                completion.submit(post, idxs, recs, batch_, out)
            completion.drain()
        finally:
            completion.close()
            if hasattr(stream, "stats"):
                stats["assembly"] = stream.stats()
            stream.close()
        dt = time.perf_counter() - t0
        stats["completion"] = completion.stats()
        det_bytes = b"".join(d.tobytes() for per_im in slots for d in (per_im or [])[1:])
        return dt, slots, det_bytes, stats

    set_prepared_cache(0)
    sweep(0, 0)  # render-LRU warmup: the serial steady state
    base_dt, base_slots, base_bytes, base_stats = sweep(0, 0)
    if detections_out is not None:
        detections_out.extend(base_slots)

    set_prepared_cache(prepared_cache)
    sweep(assembly_workers, postprocess_workers)  # fill the cache
    over_dt, _, over_bytes, over_stats = sweep(assembly_workers, postprocess_workers)
    cache = loader_mod._PREPARED_CACHE
    cache_stats = {"entries": len(cache), "hits": cache.hits, "misses": cache.misses}
    set_prepared_cache(0)

    return {
        "images": images,
        "batch": batch,
        "stub_device_ms": stub_device_ms,
        "in_flight": in_flight,
        "assembly_workers": assembly_workers,
        "postprocess_workers": postprocess_workers,
        "prepared_cache": prepared_cache,
        "baseline_imgs_per_sec": round(images / base_dt, 3),
        "overlapped_imgs_per_sec": round(images / over_dt, 3),
        "speedup": round(base_dt / over_dt, 3),
        "byte_identical": base_bytes == over_bytes,
        "baseline": base_stats,
        "overlapped": over_stats,
        "prepared_cache_stats": cache_stats,
    }


# ------------------------------------------------------------ model bench
def bench(args) -> dict:
    """The model-inclusive modes: one warm-up sweep (kernel builds, the
    prepared cache's fill), then one timed sweep over ``args.images``
    synthetic images → the JSON line's dict."""
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import Predictor, im_detect, pipelined, resolve_device
    from mx_rcnn_tpu_torch.data.assembler import CompletionPool
    from mx_rcnn_tpu_torch.data.loader import TestLoader, set_prepared_cache
    from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from mx_rcnn_tpu_torch.models import build_model
    from mx_rcnn_tpu_torch.native.hostops import nms_host

    cfg = generate_config(args.network, "PascalVOC")
    cfg = cfg.replace(
        network=dataclasses.replace(cfg.network, COMPUTE_DTYPE=args.compute_dtype),
        TEST=dataclasses.replace(cfg.TEST, DEVICE_POSTPROCESS=not args.host_path,
                                 UINT8_TRANSFER=not args.host_path),
    )
    if args.smoke:
        cfg = _smoke_shrink(cfg)
    if args.prepared_cache:
        set_prepared_cache(args.prepared_cache)
    h, w = cfg.SHAPE_BUCKETS[0]
    imdb = SyntheticDataset(num_images=args.images, num_classes=cfg.dataset.NUM_CLASSES,
                            image_size=(h - 8, w - 24),  # inside the padded canvas
                            max_boxes=6)
    roidb = imdb.gt_roidb()
    device = resolve_device("cpu" if args.cpu else None)
    # seeded random weights drawn on the device (the card's draw takes a
    # fraction of the CPU's)
    with torch.device(device):
        model = build_model(cfg, generator=torch.Generator(device=device).manual_seed(0))
    if cfg.TEST.DEVICE_POSTPROCESS:
        from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess

        predictor = Predictor(model, postprocess=make_test_postprocess(
            cfg, imdb.num_classes, 0.05, max_out=cfg.TEST.DET_PER_CLASS), device=device)
    else:
        predictor = Predictor(model, device=device)
    loader = TestLoader(roidb, cfg, batch_size=args.batch)

    def sweep(stats_out=None):
        # the overlapped eval loop (core/tester.py::pipelined): --in_flight
        # forwards in motion, the device feed's next-batch copy, the
        # assembly stage and the completion pool's host NMS
        n_det_slots = np.zeros(args.images, np.int64)
        completion = CompletionPool(args.postprocess_workers, name="bench-complete")
        stream = loader.iter_batched(assembly_workers=args.assembly_workers)

        def post(idxs, recs, batch, out):
            for k, (i, rec) in enumerate(zip(idxs, recs)):
                det = im_detect(out, batch["im_info"][k], (rec["height"], rec["width"]), index=k)
                n = 0
                for j in range(1, imdb.num_classes):
                    keep = np.where(det["scores"][:, j] > 0.05)[0]
                    cls = np.hstack([det["boxes"][keep, j * 4:(j + 1) * 4],
                                     det["scores"][keep, j:j + 1]]).astype(np.float32)
                    n += len(nms_host(cls, cfg.TEST.NMS))
                n_det_slots[i] = n

        try:
            for (idxs, recs), batch, out in pipelined(
                predictor,
                (((idxs, recs), batch) for idxs, recs, batch in stream),
                in_flight=args.in_flight,
                feed_depth=args.feed_depth,
                stats_out=stats_out,
            ):
                if "det_valid" in out:
                    for k, i in enumerate(idxs):
                        n_det_slots[i] = int(np.asarray(out["det_valid"][k]).sum())
                    continue
                completion.submit(post, idxs, recs, batch, out)
            completion.drain()
        finally:
            completion.close()
            if stats_out is not None:
                if hasattr(stream, "stats"):
                    stats_out["assembly"] = stream.stats()
                stats_out["completion"] = completion.stats()
            stream.close()
        return int(n_det_slots.sum())

    sweep()  # warm-up: kernel builds, cuDNN plans, the prepared cache
    stage_stats: dict = {}
    t0 = time.perf_counter()
    n_det = sweep(stats_out=stage_stats)
    dt = time.perf_counter() - t0
    return {
        "metric": f"eval_imgs_per_sec_per_chip_{args.network}",
        "value": round(args.images / dt, 3),
        "unit": "imgs/sec/chip",
        "batch": args.batch,
        "smoke": bool(args.smoke),
        "detections": int(n_det),
        "path": "host" if args.host_path else "device",
        "stages": stage_stats or None,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Eval throughput (PyTorch port)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--network", default="resnet")
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--host_path", action="store_true",
                    help="reference-style f32 upload + host NMS loop")
    ap.add_argument("--smoke", action="store_true",
                    help="CPU-feasible model sizing (256² bucket)")
    ap.add_argument("--data_plane", action="store_true",
                    help="host-stage benchmark around a stub device; "
                         "prints baseline vs overlapped + bitwise check")
    ap.add_argument("--stub_device_ms", type=float, default=110.0,
                    help="stub device stall per batch in --data_plane")
    ap.add_argument("--in_flight", type=int, default=2,
                    help="forwards in motion in the eval pipeline")
    ap.add_argument("--feed_depth", type=int, default=2,
                    help="device-feed staging depth (0 = host batches straight to the model)")
    ap.add_argument("--assembly_workers", type=int, default=None,
                    help="batch-assembly pool size (default: MX_RCNN_ASSEMBLY_WORKERS, "
                         "0 = serial prefetch)")
    ap.add_argument("--postprocess_workers", type=int, default=0,
                    help="completion pool size for the host postprocess")
    ap.add_argument("--prepared_cache", type=int, default=0,
                    help="prepared-canvas LRU entries (0 = off)")
    ap.add_argument("--cpu", action="store_true", help="run the model on the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.data_plane:
        report = data_plane_report(
            images=args.images,
            batch=args.batch,
            stub_device_ms=args.stub_device_ms,
            assembly_workers=2 if args.assembly_workers is None else args.assembly_workers,
            postprocess_workers=args.postprocess_workers or 2,
            prepared_cache=args.prepared_cache or 128,
            in_flight=args.in_flight,
            network=args.network,
        )
        line = {"metric": "eval_data_plane_imgs_per_sec",
                "value": report["overlapped_imgs_per_sec"], "unit": "imgs/sec", **report}
    else:
        line = bench(args)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
