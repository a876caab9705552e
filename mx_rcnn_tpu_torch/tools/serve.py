"""Serving load test / endpoint smoke CLI (port of
``mx_rcnn_tpu/tools/serve.py``).

Builds the online stack (ladder → batcher → engine → runner), drives it
with the deterministic synthetic load generator, and prints the report:
p50/p95/p99 latency, throughput, batch occupancy, and the signature
counters that prove the bucket ladder held (one signature a rung after
warmup, and not one more).  Runs on the card; ``--cpu`` runs the kernels'
plain versions on the CPU.

Examples::

  # CPU smoke at a tiny config (no checkpoint needed)
  python -m mx_rcnn_tpu_torch.tools.serve --cpu --small --requests 32

  # a params pickle at full width on the card, with a report file
  python -m mx_rcnn_tpu_torch.tools.serve --network resnet --params final.pkl \\
      --requests 256 --concurrency 16 --out serve_report.json

  # a second family through the same batcher, hot-swapped mid-load to a
  # checkpoint the port's train CLI wrote
  python -m mx_rcnn_tpu_torch.tools.serve --small \\
      --model tenant=resnet50:random:1 --swap tenant=ckpts/epoch_0002

The replica pool, tenants, autoscaler, socket frontend, fleet and cascade
flags of the JAX CLI are later slices of the port (ROADMAP item 15): they
are accepted by the parser only to exit with an error that says so.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import threading
import time

import torch

from mx_rcnn_tpu_torch.config import NETWORKS, Config, generate_config
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.serve.engine import ServingEngine
from mx_rcnn_tpu_torch.serve.loadgen import DEFAULT_SIZES, run_load
from mx_rcnn_tpu_torch.serve.registry import DEFAULT_MODEL, ModelRegistry
from mx_rcnn_tpu_torch.serve.runner import ServeRunner
from mx_rcnn_tpu_torch.utils.precision import full_float32

logger = logging.getLogger(__name__)

SMALL_SIZES = ((72, 96), (96, 128), (64, 80))

# flags of the JAX CLI whose paths are later slices: (flag, what it needs)
_LATER_SLICES = (
    ("replicas", "the replica pool"),
    ("force_pool", "the replica pool"),
    ("inflight_depth", "the replica pool"),
    ("cascade", "the confidence-gated cascade"),
    ("tenant", "the tenancy module"),
    ("autoscale_max", "the autoscaler"),
    ("autoscale_min", "the autoscaler"),
    ("frontend_port", "the socket frontend"),
    ("fleet", "the fleet gateway"),
    ("backend", "the fleet gateway"),
    ("port_file", "the fleet gateway"),
)


def small_config(network: str) -> Config:
    """Tiny CPU-runnable config: 96×128 and 128×128 buckets, so mixed-size
    load exercises a real ladder."""
    cfg = generate_config(network, "PascalVOC")
    net_over = {"FIXED_PARAMS": ()}
    if not cfg.network.USE_FPN:
        net_over["ANCHOR_SCALES"] = (2, 4, 8)
    if cfg.network.depth > 50 and cfg.network.name == "resnet":
        net_over["depth"] = 50
    return cfg.replace(
        SHAPE_BUCKETS=((96, 128), (128, 128)),
        network=dataclasses.replace(cfg.network, **net_over),
        dataset=dataclasses.replace(cfg.dataset, NUM_CLASSES=4, SCALES=((96, 128),)),
        TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=32,
                                 SCORE_THRESH=0.05),
    )


def random_params(cfg: Config, seed: int = 0):
    """A seeded random model's ``state_dict`` (the no-checkpoint path:
    latency numbers stay valid; detections are noise)."""
    return build_model(cfg, generator=torch.Generator().manual_seed(seed)).state_dict()


def load_model_source(src: str, default_network: str, small: bool, dataset: str):
    """``--model NAME=SPEC`` source → (model, cfg, params, digest).  SPEC is
    ``[network:]source`` with source a committed checkpoint directory
    (manifest-verified before registering) or ``random[:seed]``; the
    network defaults to ``--network``."""
    network, source = default_network, src
    head, _, rest = src.partition(":")
    if rest and head in NETWORKS:
        network, source = head, rest
    cfg = small_config(network) if small else generate_config(network, dataset)
    model = build_model(cfg)
    if source.startswith("random"):
        _, _, seed_s = source.partition(":")
        return model, cfg, random_params(cfg, int(seed_s) if seed_s else 0), None
    from mx_rcnn_tpu_torch.core.checkpoint import restore_tree, verify_manifest

    tree = restore_tree(source)
    man = verify_manifest(source, tree=tree)  # the register-time trust gate
    return model, cfg, tree, man.get("checksum")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serving load test (PyTorch port)")
    p.add_argument("--network", default="resnet50",
                   choices=["vgg", "resnet", "resnet50", "resnet152", "resnet_fpn",
                            "mask_resnet_fpn"])
    p.add_argument("--dataset", default="PascalVOC",
                   choices=["PascalVOC", "PascalVOC0712", "coco"])
    p.add_argument("--params", default=None,
                   help="params pickle (random init when omitted — latency numbers are "
                        "still valid)")
    p.add_argument("--small", action="store_true",
                   help="tiny config + small images for a smoke run")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain versions of the kernels) instead of the card")
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--linger_ms", type=float, default=5.0)
    p.add_argument("--max_queue", type=int, default=64)
    p.add_argument("--in_flight", type=int, default=2)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--deadline_ms", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lane_mix", type=int, default=0, metavar="N",
                   help="tag one in N requests interactive (two-lane SLO scheduling); 0 = "
                        "untagged single-lane traffic")
    p.add_argument("--interactive_linger_ms", type=float, default=0.0,
                   help="linger for the interactive lane (default 0: dispatch the moment a "
                        "device slot frees)")
    p.add_argument("--bulk_age_limit", type=float, default=2.0,
                   help="seconds a bulk batch may wait before it takes the next slot "
                        "unconditionally (anti-starvation)")
    p.add_argument("--precision", default="float32", choices=["float32", "bfloat16", "int8"],
                   help="serve-graph precision; bfloat16 also folds BN, int8 serves "
                        "per-channel weight-quantized params; both are parity-gated against "
                        "f32 at warmup")
    p.add_argument("--response_cache", type=int, default=0, metavar="N",
                   help="idempotent response cache capacity (entries); 0 disables")
    p.add_argument("--model", action="append", default=[], metavar="NAME=[network:]SRC",
                   help="register an extra model family (repeatable); SRC is a committed "
                        "checkpoint dir or random[:seed]")
    p.add_argument("--swap", default=None, metavar="MODEL=CKPT_DIR",
                   help="hot-swap MODEL to the checkpoint mid-load (the 'swap <model> "
                        "<ckpt>' admin command)")
    p.add_argument("--out", default=None, help="write the report JSON here")
    later = p.add_argument_group("later slices of the port (ROADMAP item 15): each exits "
                                 "with an error")
    later.add_argument("--replicas", type=int, default=None)
    later.add_argument("--force_pool", action="store_true")
    later.add_argument("--inflight_depth", type=int, default=None)
    later.add_argument("--cascade", default=None)
    later.add_argument("--tenant", action="append", default=[])
    later.add_argument("--autoscale_max", type=int, default=None)
    later.add_argument("--autoscale_min", type=int, default=None)
    later.add_argument("--frontend_port", type=int, default=None)
    later.add_argument("--fleet", type=int, default=None)
    later.add_argument("--backend", action="store_true")
    later.add_argument("--port_file", default=None)
    args = p.parse_args(argv)
    for flag, needs in _LATER_SLICES:
        if getattr(args, flag) not in (None, False, []):
            p.error(f"--{flag} needs {needs}, a later slice of the port (ROADMAP item 15)")
    return args


def main(argv=None):
    """The serving CLI → the load report (also printed as JSON)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", stream=sys.stderr)
    full_float32()
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.small:
        cfg = small_config(args.network)
        sizes = SMALL_SIZES
    else:
        cfg = generate_config(args.network, args.dataset)
        sizes = DEFAULT_SIZES
    model = build_model(cfg)
    if args.params:
        from mx_rcnn_tpu_torch.tools.test import load_flax_params

        params = load_flax_params(args.params)
    else:
        params = random_params(cfg, 0)
        logger.warning("no --params — serving a random-init model")

    # every family, the default and each --model, lives in ONE registry;
    # the runner resolves (model, version) per batch
    registry = ModelRegistry()
    registry.register(DEFAULT_MODEL, model, cfg, params)
    load_models = None
    if args.model:
        load_models = [None]
        for spec in args.model:
            name, _, src = spec.partition("=")
            if not src:
                raise SystemExit(f"--model needs NAME=SRC, got {spec!r}")
            t_model, t_cfg, t_params, digest = load_model_source(
                src, args.network, args.small, args.dataset)
            registry.register(name, t_model, t_cfg, t_params, digest=digest, source=src)
            load_models.append(name)
            logger.info("registered model %r from %s", name, src)

    precision = None if args.precision == "float32" else args.precision
    runner = ServeRunner(registry=registry, max_batch=args.max_batch, precision=precision,
                         device=device)
    response_cache = None
    if args.response_cache > 0:
        from mx_rcnn_tpu_torch.serve.respcache import ResponseCache

        response_cache = ResponseCache(capacity=args.response_cache)
    engine = ServingEngine(
        runner,
        max_linger=args.linger_ms / 1000.0,
        max_queue=args.max_queue,
        in_flight=args.in_flight,
        interactive_linger=args.interactive_linger_ms / 1000.0,
        bulk_age_limit=args.bulk_age_limit,
        response_cache=response_cache,
    )
    logger.info("warming up %d bucket(s) x %d model(s) on %s...", len(runner.ladder),
                len(registry.model_ids()), runner.device)
    swap_result = {}

    def run_swap():
        # fire once the load is mid-flight, then block through the admin
        # surface so the report carries the whole result
        smodel, _, sckpt = args.swap.partition("=")
        t_end = time.monotonic() + 120.0
        while engine.metrics.completed < max(1, args.requests // 3) and time.monotonic() < t_end:
            time.sleep(0.005)
        t0 = time.monotonic()
        try:
            out = engine.admin(f"swap {smodel} {sckpt}")
            swap_result.update(out, wall_s=round(time.monotonic() - t0, 4))
        except Exception as e:  # noqa: BLE001 — report it, don't kill the load
            swap_result.update(error=repr(e))

    # --lane_mix N: a lane menu with one "interactive" per N-1 untagged
    # entries; run_load draws uniformly, so ~1/N of requests jump lanes
    load_lanes = None
    if args.lane_mix > 0:
        load_lanes = ["interactive"] + [None] * max(1, args.lane_mix - 1)

    with engine:
        swapper = None
        if args.swap:
            swapper = threading.Thread(target=run_swap, name="admin-swap")
            swapper.start()
        report = run_load(
            engine,
            num_requests=args.requests,
            concurrency=args.concurrency,
            sizes=sizes,
            seed=args.seed,
            deadline_s=args.deadline_ms / 1000.0 if args.deadline_ms is not None else None,
            models=load_models,
            lanes=load_lanes,
        )
        if swapper is not None:
            swapper.join()
            report["swap"] = swap_result
    report["device"] = str(runner.device)
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        logger.info("wrote %s", args.out)
    return report


if __name__ == "__main__":
    main()
