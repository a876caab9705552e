"""Time the hand-written kernels on the card, CUDA kernel by CUDA kernel, on
seeded synthetic inputs at the train and serving shapes: NMS (kernel 1), the
resident ROIAlign forward and backward (kernels 2 and 3) and the streamed
ones (kernels 4 and 5), and kernel 2 on kernel 4's tensors.

    python -m mx_rcnn_tpu_torch.tools.kernel_bench

``chip_smoke.py`` times the kernels on the tensors the paths feed them; this
script times them on inputs it makes itself, so that two versions of the
kernels can be compared in one run on one card: run it once from each
checkout (``env PYTHONPATH=<checkout> python <this file>`` imports the
package of that checkout; the store floor is left out where a checkout's
library does not export it).  For each case it prints the wrapper's device
time (calls captured in a CUDA graph, CUDA events) and the device time of
each CUDA kernel the wrapper launches (torch.profiler).  Besides: for NMS
the same boxes with every row invalid, which leaves pass 1 whole and pass 2
no survivor to carry; for kernel 2 a store-only kernel of the same output
bytes (the card's practical floor for the function; it runs on no path);
for kernel 3 the wrapper launched eagerly as well.  The ptxas lines
(registers, spills) of every library come first, then a digest of each
kernel's SASS (``cuobjdump``: equal digests in two checkouts mean the
same machine code); the last line is one JSON object of every number.

``--bf16`` times the bf16 backwards (kernels 3 and 5 on a bf16 cotangent)
and the bf16 forwards (kernels 2 and 4 on bf16 maps, beside the float32
instance on the same values) on the same synthetic cases, and the serving
forward at 1, 2 and 4 images of 300 rois; ``--cases FILE`` times instead
the cases in FILE (a ``torch.save`` of a list of dicts: ``kind``
"resident" or "stream", ``label``, ``g``, ``rois``, ``shape``, ``pooled``,
``scale``, ``s``, ``valid_hw`` for a backward; ``kind`` "resident_fwd" or
"stream_fwd", ``label``, ``feat``, ``rois``, ``pooled``, ``scale``, ``s``,
``valid_hw`` for a forward; ``chip_smoke.py --save-bwd-cases`` and
``--save-fwd-cases`` write the bf16 paths' captured calls) and prints a
sha256 of each output, so that two checkouts' kernels are timed on the same
tensors and equal digests show equal bits; ``--sass-dump DIR`` writes each
library's whole SASS into DIR.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from mx_rcnn_tpu_torch.ops import nms as nms_mod
from mx_rcnn_tpu_torch.ops import roi_align as roi_mod
from mx_rcnn_tpu_torch.ops import roi_align_stream as stream_mod
from mx_rcnn_tpu_torch.utils.cuda_build import ptr, stream_of
from mx_rcnn_tpu_torch.ops.anchors import shifted_anchors

CANVAS_HW = (608, 1024)


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
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def kernel_ms(fn, reps: int = 10) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` launches (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0][:60]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def jittered(rng, anchors: np.ndarray, spread: float) -> np.ndarray:
    """Anchors moved and resized by a relative ``spread``, clipped to the
    canvas: the shape of proposals from an RPN near its initialization."""
    w = anchors[:, 2] - anchors[:, 0] + 1.0
    h = anchors[:, 3] - anchors[:, 1] + 1.0
    cx = anchors[:, 0] + 0.5 * w + rng.randn(len(w)) * spread * w
    cy = anchors[:, 1] + 0.5 * h + rng.randn(len(h)) * spread * h
    w = w * np.exp(rng.randn(len(w)) * spread)
    h = h * np.exp(rng.randn(len(h)) * spread)
    boxes = np.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], 1)
    hh, ww = CANVAS_HW
    return np.clip(boxes, 0, [ww - 1, hh - 1, ww - 1, hh - 1]).astype(np.float32)


def smooth_scores(rng, boxes: np.ndarray) -> np.ndarray:
    """Scores that vary smoothly over the canvas (20 random bumps of 60 px),
    as an RPN's objectness does: the top-k of a level then clusters, and
    neighbours suppress each other."""
    hh, ww = CANVAS_HW
    centres = rng.rand(20, 2) * [ww, hh]
    amp = rng.rand(20)
    ctr = np.stack([boxes[:, 0] + boxes[:, 2], boxes[:, 1] + boxes[:, 3]], 1) / 2
    d2 = ((ctr[:, None] - centres[None]) ** 2).sum(-1)
    return (amp * np.exp(-d2 / (2 * 60.0 ** 2))).sum(1) + rng.rand(len(boxes)) * 0.05


def top_k_sorted(rng, boxes: np.ndarray, k: int):
    scores = smooth_scores(rng, boxes)
    order = np.argsort(-scores, kind="stable")[:k]
    return boxes[order], scores[order]


def fpn_union(rng) -> np.ndarray:
    """(1, 9504, 4) boxes in descending score order: the top 2400 of each of
    P2..P5 and all of P6 (one scale, three ratios), as the FPN train step's
    union of its levels' top-k."""
    hh, ww = CANVAS_HW
    boxes, scores = [], []
    for stride in (4, 8, 16, 32, 64):
        a = shifted_anchors(-(-hh // stride), -(-ww // stride), stride, scales=(8,))
        b, s = top_k_sorted(rng, jittered(rng, a, 0.01), 2400)
        boxes.append(b)
        scores.append(s)
    boxes, scores = np.concatenate(boxes), np.concatenate(scores)
    return boxes[np.argsort(-scores, kind="stable")][None]


def c4_proposals(rng, p: int, n: int) -> np.ndarray:
    """(p, n, 4): the top n of the C4 anchors (stride 16, scales 8/16/32),
    jittered, in descending score order."""
    hh, ww = CANVAS_HW
    a = shifted_anchors(hh // 16, ww // 16, 16)
    return np.stack([top_k_sorted(rng, jittered(rng, a, 0.01), n)[0] for _ in range(p)])


def class_boxes(rng, p: int, n: int) -> np.ndarray:
    xy = rng.rand(p, n, 2) * [450.0, 360.0]
    wh = rng.rand(p, n, 2) * 120.0 + 2.0
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def nms_cases(rng, dev):
    """(label, boxes, valid, thresh, max_keep) on the card, boxes sorted."""
    union = torch.from_numpy(fpn_union(rng)).to(dev)
    train = torch.from_numpy(c4_proposals(rng, 1, 12000)).to(dev)
    serve = torch.from_numpy(c4_proposals(rng, 2, 6000)).to(dev)
    classes = torch.from_numpy(class_boxes(rng, 40, 300)).to(dev)
    ones = lambda b: torch.ones(b.shape[:2], dtype=torch.bool, device=dev)  # noqa: E731
    return [
        ("FPN union 1x9504, no stop", union, ones(union), 0.7, 0),
        ("FPN union, every row invalid (pass 1 alone)", union, ~ones(union), 0.7, 0),
        ("C4 train 1x12000, keep 2000", train, ones(train), 0.7, 2000),
        ("serving 2x6000, keep 300", serve, ones(serve), 0.7, 300),
        ("classes 40x300", classes, ones(classes), 0.3, 0),
    ]


def stream_rois(rng, r: int) -> np.ndarray:
    """(1, r, 4) rois as the FPN train step samples them from a random
    network's proposals: clustered in one 450 x 280 px region of the canvas,
    a quarter near two gt boxes, the rest anchor-shaped (32..128 px scales,
    ratios 0.5 / 1 / 2, the small ones most often), slightly moved."""
    gts = np.array([[126, 121, 485, 295], [250, 200, 520, 400]], np.float32)
    n_fg = r // 4
    fg = gts[rng.randint(0, 2, n_fg)]
    fg = fg + rng.randn(n_fg, 4) * np.tile(fg[:, 2:] - fg[:, :2], 2) * 0.05
    scale = np.array([32.0, 64.0, 128.0])[rng.choice(3, r - n_fg, p=[0.6, 0.3, 0.1])]
    ratio = np.array([0.5, 1.0, 2.0])[rng.randint(0, 3, r - n_fg)]
    wh = np.stack([scale * np.sqrt(2.0 / ratio), scale * np.sqrt(ratio / 2.0)], 1)
    ctr = rng.rand(r - n_fg, 2) * [450.0, 280.0] + [100.0, 120.0]
    bg = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)
    rois = np.concatenate([fg, bg]).astype(np.float32)
    hh, ww = CANVAS_HW
    return np.clip(rois, 0, [ww - 1, hh - 1, ww - 1, hh - 1]).astype(np.float32)[None]


def stream_cases(rng, dev):
    """(label, g, rois, feat_shape, scale) at FPN's P2 and P3."""
    rois = torch.from_numpy(stream_rois(rng, 128)).to(dev)
    out = []
    for level, (h, w) in ((2, (152, 256)), (3, (76, 128))):
        g = torch.from_numpy(rng.randn(1, 128, 14, 14, 256).astype(np.float32)).to(dev)
        out.append((f"P{level} g 1x128x14x14x256 -> 1x{h}x{w}x256", g, rois, (1, h, w, 256),
                    1.0 / 2 ** level))
    return out


def serving_rois(rng, b: int, r: int) -> np.ndarray:
    """(b, r, 4): r of the anchors of a 64 x 64 map at stride 16 (scales
    8/16/32, ratios 0.5/1/2), moved and resized a little, inside a 1024 x
    1024 canvas: the serving path's 300 proposals after NMS, spread over
    the image, 128 to 724 px a side."""
    a = shifted_anchors(64, 64, 16)
    out = []
    for _ in range(b):
        boxes = jittered(rng, a[rng.choice(len(a), r, replace=False)], 0.05)
        out.append(np.clip(boxes, 0, 1023))
    return np.stack(out).astype(np.float32)


def resident_cases(rng, dev):
    """(label, feat shape, rois, valid_hw, scale) of kernels 2 and 3: the
    serving call (2 images, 300 rois each, valid_hw), C4 train (the clustered
    train rois) and FPN's P4 and P5 (the same rois)."""
    train = torch.from_numpy(stream_rois(rng, 128)).to(dev)
    serve = torch.from_numpy(serving_rois(rng, 2, 300)).to(dev)
    valid_hw = torch.tensor([[600.0, 1000.0], [1000.0, 600.0]], device=dev)
    return [
        ("serving 2x64x64x1024, 2x300 rois, valid_hw", (2, 64, 64, 1024), serve, valid_hw, 1 / 16),
        ("C4 train 1x38x64x1024, 128 rois", (1, 38, 64, 1024), train, None, 1 / 16),
        ("FPN P4 1x38x64x256, 128 rois", (1, 38, 64, 256), train, None, 1 / 16),
        ("FPN P5 1x19x32x256, 128 rois", (1, 19, 32, 256), train, None, 1 / 32),
    ]


def ptxas_lines(lib) -> list:
    return [line.strip() for line in lib.ptxas_log.splitlines()
            if "Used" in line or "spill" in line or "Compiling entry" in line]


def sass_digests(lib) -> dict:
    """{kernel's mangled name past its file's anonymous namespace: "sha256
    prefix of its SASS instructions, N instructions"} from ``cuobjdump``
    (empty where the toolkit lacks it): two checkouts' digests of a kernel
    are equal when its machine code is."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    dump = subprocess.run([tool, "-sass", str(lib.library_path())], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", dump)[1:]:
        name, body = func.split("\n", 1)
        name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", name.strip())
        ins = [m.group(1) for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s*([^;]*?)\s*;", body)]
        digest = hashlib.sha256("\n".join(" ".join(i.split()) for i in ins).encode()).hexdigest()
        out[name] = f"{digest[:12]}, {len(ins)} instructions"
    return out


def roi_fwd_bench(label, shape, rois, valid_hw, scale, reps, dev) -> dict:
    """Kernel 2 at one case: the wrapper, and the store floor of its output
    bytes."""
    rng = np.random.RandomState(sum(shape))
    feat = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    call = lambda: roi_mod.roi_align(feat, rois, (14, 14), scale, 2, valid_hw)  # noqa: E731
    out = call()
    res = {"ms": graph_ms(call, reps), "kernels_ms": kernel_ms(call), "out_mb": out.numel() * 4e-6}
    floor = getattr(roi_mod.library.lib(), "roi_align_store_floor", None)
    if floor is not None:
        floor.argtypes = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p)
        floor.restype = ctypes.c_int

        def store_floor():
            rc = floor(ptr(out), out.numel(), stream_of(out))
            if rc:
                raise RuntimeError(f"launch failed with cudaError {rc}")

        res["store_floor_ms"] = graph_ms(store_floor, reps)
    print(f"  roi_align_fwd {label}: {res['ms']:.4f} ms (graph)"
          + (f", store floor {res['store_floor_ms']:.4f}" if "store_floor_ms" in res else "")
          + "; " + ", ".join(f"{k} {v:.4f}" for k, v in res["kernels_ms"].items()), flush=True)
    return res


def eager_ms(fn, reps: int = 20) -> float:
    """Device ms a call of ``fn`` launched eagerly, CUDA events around
    ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def roi_bwd_bench(label, shape, rois, valid_hw, scale, reps, dev) -> dict:
    """Kernel 3 at one case: the wrapper, graph-captured and eager."""
    rng = np.random.RandomState(sum(shape) + 1)
    b, h, w, c = shape
    g = torch.from_numpy(rng.randn(b, rois.shape[1], 14, 14, c).astype(np.float32)).to(dev)
    call = lambda: roi_mod._roi_align_bwd_cuda(g, rois, shape, (14, 14), scale, 2, valid_hw)  # noqa: E731
    res = {"ms": graph_ms(call, reps), "eager_ms": eager_ms(call), "kernels_ms": kernel_ms(call)}
    print(f"  roi_align_bwd {label}: {res['ms']:.4f} ms (graph), {res['eager_ms']:.4f} (eager); "
          + ", ".join(f"{k} {v:.4f}" for k, v in res["kernels_ms"].items()), flush=True)
    return res


def stream_fwd_bench(label, feat, rois, scale, reps) -> dict:
    """Kernel 4 at one case: the wrapper, and kernel 2's wrapper on the same
    tensors (the resident tap rule: no zeros for the inverted rois, so its
    output is not compared)."""
    fwd = lambda: stream_mod._roi_align_stream_cuda(feat, rois, (14, 14), scale, 2)  # noqa: E731
    res = {"ms": graph_ms(fwd, reps), "kernels_ms": kernel_ms(fwd)}
    resident = lambda: roi_mod.roi_align(feat, rois, (14, 14), scale, 2)  # noqa: E731
    res["resident_kernel2_ms"] = graph_ms(resident, reps)
    print(f"  roi_align_stream_fwd {label}: {res['ms']:.4f} ms (graph); "
          + ", ".join(f"{k} {v:.4f}" for k, v in res["kernels_ms"].items())
          + f"; kernel 2 on the same tensors {res['resident_kernel2_ms']:.4f}", flush=True)
    return res


def out_digest(t: torch.Tensor) -> str:
    """A sha256 prefix of a tensor's bytes: equal digests, equal bits."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def fwd_case_bench(case, reps) -> dict:
    """A forward of one saved case through the package's wrapper for its
    map's dtype (kernel 2, or kernel 4 for "stream_fwd"): graph ms, each
    CUDA kernel's ms, the output's digest and, where the package has one,
    the bf16 launch plan."""
    feat, rois = case["feat"].cuda(), case["rois"].cuda()
    valid_hw = None if case.get("valid_hw") is None else case["valid_hw"].cuda()
    pooled, scale, s = tuple(case["pooled"]), case["scale"], case["s"]
    if case["kind"] == "stream_fwd":
        call = lambda: stream_mod.roi_align_stream(feat, rois, pooled, scale, s)  # noqa: E731
    else:
        call = lambda: roi_mod.roi_align(feat, rois, pooled, scale, s, valid_hw)  # noqa: E731
    res = {"ms": graph_ms(call, reps), "kernels_ms": kernel_ms(call), "feat": list(feat.shape),
           "rois": list(rois.shape), "dtype": str(feat.dtype), "sha256": out_digest(call())}
    plan = getattr(roi_mod, "fwd_bf16_plan", None)
    if plan is not None and feat.dtype == torch.bfloat16:
        b, h, w, c = feat.shape
        res["plan"] = plan(b, h, w, c, rois.shape[1], pooled, s)
        print(f"    plan {res['plan']}", flush=True)
    print(f"  {case['kind']} {case['label']} feat {tuple(feat.shape)} rois {tuple(rois.shape)} "
          f"{feat.dtype}: {res['ms']:.4f} ms (graph), sha256 {res['sha256']}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in res["kernels_ms"].items()), flush=True)
    return res


def bf16_fwd_bench(label, feat, rois, valid_hw, scale, reps, stream=False) -> dict:
    """A bf16 forward on synthetic tensors (kernel 2, or 4 with ``stream``),
    and the float32 instance on the same values."""
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        case = {"kind": "stream_fwd" if stream else "resident_fwd", "label": f"{label} {dtype}",
                "feat": feat.to(dtype), "rois": rois, "pooled": (14, 14), "scale": scale, "s": 2,
                "valid_hw": valid_hw}
        res[str(dtype).split(".")[-1]] = fwd_case_bench(case, reps)
    return res


def bwd_case_bench(case, reps) -> dict:
    """A backward of one saved case through the package's wrapper for its
    cotangent's dtype: graph ms, each CUDA kernel's ms and the output's
    digest."""
    g, rois, shape = case["g"].cuda(), case["rois"].cuda(), tuple(case["shape"])
    valid_hw = None if case.get("valid_hw") is None else case["valid_hw"].cuda()
    pooled, scale, s = tuple(case["pooled"]), case["scale"], case["s"]
    if case["kind"] == "stream":
        call = lambda: stream_mod._roi_align_stream_bwd_cuda(g, rois, shape, pooled, scale, s)  # noqa: E731
    else:
        call = lambda: roi_mod._roi_align_bwd_cuda(g, rois, shape, pooled, scale, s, valid_hw)  # noqa: E731
    out = call()
    res = {"ms": graph_ms(call, reps), "kernels_ms": kernel_ms(call), "g": list(g.shape),
           "dtype": str(g.dtype), "out_dtype": str(out.dtype), "sha256": out_digest(out)}
    plan = getattr(roi_mod.library.lib(), "roi_align_bwd_bf16_plan", None)
    if plan is not None and g.dtype == torch.bfloat16:
        out = (ctypes.c_longlong * 5)()
        plan.argtypes = (ctypes.c_int,) * 8 + (ctypes.c_void_p,)
        plan.restype = ctypes.c_int
        b, h, w, c = shape
        if plan(b, h, w, c, g.shape[1], pooled[0], pooled[1], s, out) == 0:
            res["plan"] = dict(zip(("smem_bytes", "cluster", "tile_rows", "stages", "blocks"),
                                   list(out)))
            print(f"    plan {res['plan']}", flush=True)
    print(f"  {case['kind']} bwd {case['label']} g {tuple(g.shape)} {g.dtype}: {res['ms']:.4f} ms "
          f"(graph), sha256 {res['sha256']}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in res["kernels_ms"].items()), flush=True)
    return res


def sass_dump(lib, out_dir: str) -> None:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "-sass", str(lib.library_path())], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{lib.source.stem}.sass"), "w") as f:
        f.write(dump)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20, help="calls in each timed CUDA graph")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true",
                    help="also time the bf16 backwards and forwards")
    ap.add_argument("--cases", help="time only the saved cases in this file")
    ap.add_argument("--sass-dump", help="write each library's SASS into this directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {smi} | package {nms_mod.__file__}", flush=True)
    result = {"card": smi, "package": nms_mod.__file__, "ptxas": {}, "sass": {}, "nms": {},
              "roi_fwd": {}, "roi_bwd": {}, "stream_fwd": {}, "stream_bwd": {}}
    for lib in (nms_mod.library, roi_mod.library, stream_mod.library):
        lib.lib()
        result["ptxas"][lib.source.name] = ptxas_lines(lib)
        for line in result["ptxas"][lib.source.name]:
            print(f"  {lib.source.name}: {line}", flush=True)
        result["sass"][lib.source.name] = sass_digests(lib)
        for name, digest in result["sass"][lib.source.name].items():
            print(f"  {lib.source.name} SASS {name[:90]}: {digest}", flush=True)
        if args.sass_dump:
            sass_dump(lib, args.sass_dump)
    if args.cases:
        result["cases"] = {
            c["label"]: (fwd_case_bench if c["kind"].endswith("_fwd") else bwd_case_bench)(
                c, args.reps) for c in torch.load(args.cases, weights_only=False)}
        print(json.dumps(result), flush=True)
        return 0
    result["bf16_bwd"], result["bf16_fwd"] = {}, {}
    rng = np.random.RandomState(args.seed)
    for label, boxes, valid, thresh, max_keep in nms_cases(rng, dev):
        call = lambda: nms_mod.nms_mask_sorted(boxes, valid, thresh, max_keep)  # noqa: E731
        kept = int(call().sum())
        ms = graph_ms(call, args.reps)
        per = kernel_ms(call)
        result["nms"][label] = {"kept": kept, "ms": ms, "kernels_ms": per}
        print(f"  nms {label} {tuple(boxes.shape)}: kept {kept}, {ms:.4f} ms (graph); "
              + ", ".join(f"{k} {v:.4f}" for k, v in per.items()), flush=True)
    for label, shape, rois, valid_hw, scale in resident_cases(rng, dev):
        result["roi_fwd"][label] = roi_fwd_bench(label, shape, rois, valid_hw, scale, args.reps, dev)
        if args.bf16:
            feat = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
            result["bf16_fwd"][label] = bf16_fwd_bench(label, feat, rois, valid_hw, scale,
                                                       args.reps)
        if valid_hw is None:
            result["roi_bwd"][label] = roi_bwd_bench(label, shape, rois, valid_hw, scale,
                                                     args.reps, dev)
            if args.bf16:
                g = torch.from_numpy(rng.randn(shape[0], rois.shape[1], 14, 14, shape[3])
                                     .astype(np.float32)).to(dev, torch.bfloat16)
                result["bf16_bwd"][label] = bwd_case_bench(
                    {"kind": "resident", "label": label, "g": g, "rois": rois, "shape": shape,
                     "pooled": (14, 14), "scale": scale, "s": 2}, args.reps)
    for label, g, rois, shape, scale in stream_cases(rng, dev):
        feat = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
        result["stream_fwd"][label] = stream_fwd_bench(label, feat, rois, scale, args.reps)
        if args.bf16:
            result["bf16_fwd"][f"stream {label}"] = bf16_fwd_bench(
                f"stream {label}", feat, rois, None, scale, args.reps, stream=True)
        call = lambda: stream_mod._roi_align_stream_bwd_cuda(g, rois, shape, (14, 14), scale, 2)  # noqa: E731
        ms = graph_ms(call, args.reps)
        per = kernel_ms(call)
        result["stream_bwd"][label] = {"ms": ms, "kernels_ms": per}
        print(f"  roi_align_stream_bwd {label}: {ms:.4f} ms (graph); "
              + ", ".join(f"{k} {v:.4f}" for k, v in per.items()), flush=True)
        if args.bf16:
            result["bf16_bwd"][f"stream {label}"] = bwd_case_bench(
                {"kind": "stream", "label": f"stream {label}", "g": g.to(torch.bfloat16),
                 "rois": rois, "shape": shape, "pooled": (14, 14), "scale": scale, "s": 2},
                args.reps)
    if args.bf16:
        # the serving forward's time against its blocks: 1, 2 and 4 images of
        # 300 rois (2400 blocks of 14 warps an image at the first bf16 launch shape)
        for b in (1, 2, 4):
            feat = torch.from_numpy(rng.randn(b, 64, 64, 1024).astype(np.float32)).to(dev)
            rois = torch.from_numpy(serving_rois(rng, b, 300)).to(dev)
            valid_hw = torch.tensor([[600.0, 1000.0], [1000.0, 600.0]] * 2, device=dev)[:b]
            result["bf16_fwd"][f"serving {b} images"] = bf16_fwd_bench(
                f"serving {b}x64x64x1024, {b}x300 rois", feat, rois, valid_hw, 1 / 16, args.reps)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
