"""The PyTorch port imports and runs where JAX, Flax, OpenCV, PIL and the
JAX package cannot be imported (it serves a request and a mask request, a
bf16 request, requests through the serving engine by ``tools/serve.py``,
runs a data-parallel step over a one-rank gloo group, runs two steps of the
integration gate, trains a step of the C4 (float32 and bf16) and of the mask
network through its CLI, runs the alternate
training CLI, evaluates through ``tools/test.py``, decodes a JPEG and writes
a PNG), and ``chip_smoke.py`` refuses
to report without a card or outside the repository."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# makes every import of the named top-level packages fail in the child
BLOCK = """
import sys
_BLOCKED = ("jax", "jaxlib", "flax", "orbax", "mx_rcnn_tpu", "cv2", "PIL")
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ImportError("blocked: " + name)
        return None
for _m in list(sys.modules):
    if _m.split(".")[0] in _BLOCKED:
        del sys.modules[_m]
sys.meta_path.insert(0, _Block())
"""


def run_blocked(code: str, timeout: int = 600) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", BLOCK + code], cwd=ROOT, capture_output=True,
        text=True, timeout=timeout,
    )


def test_every_port_module_and_chip_smoke_import_without_jax():
    r = run_blocked("""
import importlib, pkgutil
import mx_rcnn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mx_rcnn_tpu_torch.__path__, "mx_rcnn_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
assert not any(m.split(".")[0] in _BLOCKED for m in sys.modules)
print(len(names))
""")
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20


def test_port_serves_a_request_without_jax():
    r = run_blocked("""
import dataclasses, numpy as np, torch
torch.set_num_threads(2)
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.tester import Predictor
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess
from mx_rcnn_tpu_torch.serve.runner import detect_single
cfg = generate_config("resnet50", "PascalVOC")
cfg = cfg.replace(dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
                  SHAPE_BUCKETS=((96, 128), (128, 96)),
                  TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16))
pred = Predictor(FasterRCNN(cfg), make_test_postprocess(cfg, 21, cfg.TEST.SCORE_THRESH, 10), device="cpu")
im = (np.random.RandomState(0).rand(60, 80, 3) * 255).astype(np.uint8)
dets = detect_single(pred, im, cfg, 21)
assert len(dets) == 21 and all(np.isfinite(d).all() for d in dets[1:])
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def test_port_serves_a_mask_request_without_jax():
    """Mask R-CNN FPN: one request through the Predictor with the device
    canvas paste, the host mask branch of ``detections_from_output`` and
    the image-space RLEs (the C RLE library), and the canvas RLEs."""
    r = run_blocked("""
import dataclasses, numpy as np, torch
torch.set_num_threads(2)
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.tester import Predictor
from mx_rcnn_tpu_torch.eval.segm import canvas_rles, rles_for_detections
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.native import rle
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess
from mx_rcnn_tpu_torch.serve.buckets import BucketLadder
from mx_rcnn_tpu_torch.serve.runner import cap_detections, detections_from_output, prepare_request
cfg = generate_config("mask_resnet_fpn", "coco")
cfg = cfg.replace(network=dataclasses.replace(cfg.network, depth=50),
                  dataset=dataclasses.replace(cfg.dataset, SCALES=((128, 128),)),
                  SHAPE_BUCKETS=((128, 128),),
                  TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16))
pp = make_test_postprocess(cfg, 81, cfg.TEST.SCORE_THRESH, 10, paste=True)
pred = Predictor(build_model(cfg), pp, device="cpu")
im = (np.random.RandomState(0).rand(90, 120, 3) * 255).astype(np.uint8)
req = prepare_request(im, cfg, BucketLadder(cfg.SHAPE_BUCKETS))
batch = {"images": req.image[None], "im_info": req.im_info[None],
         "orig_hw": np.asarray([req.orig_hw], np.float32)}
out = pred.predict(batch)
assert out["det_canvas"].shape == (1, 100, 128, 128)
dets, probs = detections_from_output(out, batch["im_info"][0], req.orig_hw, cfg, 81)
dets, probs = cap_detections(dets, cfg.TEST.MAX_PER_IMAGE, probs)
n = 0
for j in range(1, 81):
    assert probs[j].shape == (len(dets[j]), 28, 28)
    n += len(rles_for_detections(probs[j], dets[j], 90, 120))
    canvas_rles(out["det_masks"][0][:1], dets[j][:1], float(req.im_info[2]), 128, 128)
assert n > 0 and rle.backend() == "c"
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def test_port_trains_a_step_without_jax(tmp_path):
    r = run_blocked(f"""
import dataclasses, math, torch
torch.set_num_threads(2)
import mx_rcnn_tpu_torch.tools.train_end2end as cli
from mx_rcnn_tpu_torch.config import generate_config
def tiny(network, dataset):
    cfg = generate_config("resnet50", dataset)
    return cfg.replace(dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
                       SHAPE_BUCKETS=((96, 128), (128, 96)),
                       TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=200,
                                                 RPN_POST_NMS_TOP_N=32, BATCH_ROIS=16,
                                                 RPN_BATCH_SIZE=32))
cli.generate_config = tiny
out = cli.main(["--cpu", "1", "--synthetic", "8", "--max_steps", "1",
                "--prefix", {str(tmp_path / "e2e")!r}])
assert out["steps"] == 1, out
assert all(math.isfinite(v) for v in out["history"][0].values()), out
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def test_port_runs_a_gloo_dp_step_without_jax():
    """Every ``parallel`` module imports, and a world-1 gloo group runs the
    DP train step (the all-reduce, the aux mean, the update)."""
    r = run_blocked("""
import importlib, numpy as np, torch
torch.set_num_threads(2)
for n in ("distributed", "mesh", "elastic", "dist_smoke"):
    importlib.import_module("mx_rcnn_tpu_torch.parallel." + n)
from mx_rcnn_tpu_torch.core.pipeline import batch_to_device
from mx_rcnn_tpu_torch.core.train import create_train_state, make_optimizer
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.parallel import distributed
from mx_rcnn_tpu_torch.parallel.dist_smoke import free_port, small_c4_cfg
from mx_rcnn_tpu_torch.parallel.mesh import make_mesh, make_parallel_train_step, replicate
distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, cpu=True)
assert distributed.backend() == "gloo"
cfg = small_c4_cfg()
model = build_model(cfg, generator=torch.Generator().manual_seed(0)).train()
mesh = make_mesh()
state = replicate(create_train_state(model, make_optimizer(cfg, model, lambda s: 1e-3)), mesh)
rng = np.random.RandomState(0)
gt = np.zeros((1, 4, 5), np.float32); gt[0, 0] = [8, 8, 40, 40, 1]
batch = {"images": rng.rand(1, 64, 64, 3).astype(np.float32),
         "im_info": np.asarray([[64, 64, 1.0]], np.float32), "gt_boxes": gt,
         "gt_valid": gt[..., 4] > 0, "sample_seeds": np.asarray([0], np.int32)}
step = make_parallel_train_step(mesh)
state, aux = step(state, batch_to_device(batch, "cpu"), 3)
assert np.isfinite(float(aux["loss"])) and state.step == 1 and step.comm["all_reduces"] == 1
distributed.shutdown()
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def test_port_runs_the_integration_gate_without_jax():
    """The gate, calibration and measuring tools import, and a 2-step CPU
    ``run_gate`` trains C4 and evaluates it through the full eval stack."""
    r = run_blocked("""
import importlib, numpy as np, torch
torch.set_num_threads(2)
for n in ("utils.bn_calibrate", "tools.integration_gate", "tools.profile_step",
          "tools.bench_eval", "tools.check_data", "tools.bench_coco_eval"):
    importlib.import_module("mx_rcnn_tpu_torch." + n)
from mx_rcnn_tpu_torch.tools.integration_gate import run_gate
out = run_gate("resnet50", num_images=2, steps=2, eval_every=2, target=0, device="cpu")
assert out["steps"] == 2 and np.isfinite(out["gate"]) and out["per_eval"][0][0] == 2
assert not any(m.split(".")[0] in _BLOCKED for m in sys.modules)
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def test_port_serves_a_bf16_request_without_jax():
    """One request through the bf16, folded-BN C4 graph (COMPUTE_DTYPE
    bfloat16, FOLD_BN): finite detections, float32 at the postprocess."""
    r = run_blocked("""
import dataclasses, numpy as np, torch
torch.set_num_threads(2)
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.tester import Predictor
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess
from mx_rcnn_tpu_torch.serve.runner import detect_single
cfg = generate_config("resnet50", "PascalVOC")
cfg = cfg.replace(network=dataclasses.replace(cfg.network, COMPUTE_DTYPE="bfloat16", FOLD_BN=True),
                  dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
                  SHAPE_BUCKETS=((96, 128), (128, 96)),
                  TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16))
pred = Predictor(FasterRCNN(cfg), make_test_postprocess(cfg, 21, cfg.TEST.SCORE_THRESH, 10), device="cpu")
im = (np.random.RandomState(0).rand(60, 80, 3) * 255).astype(np.uint8)
dets = detect_single(pred, im, cfg, 21)
assert len(dets) == 21 and all(d.dtype == np.float32 and np.isfinite(d).all() for d in dets[1:])
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def test_port_trains_a_bf16_step_without_jax(tmp_path):
    """``train_end2end --compute_dtype bfloat16`` with FOLD_BN from the
    config: one step."""
    r = run_blocked(f"""
import dataclasses, math, torch
torch.set_num_threads(2)
import mx_rcnn_tpu_torch.tools.train_end2end as cli
from mx_rcnn_tpu_torch.config import generate_config
def tiny(network, dataset):
    cfg = generate_config("resnet50", dataset)
    return cfg.replace(network=dataclasses.replace(cfg.network, FOLD_BN=True),
                       dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
                       SHAPE_BUCKETS=((96, 128), (128, 96)),
                       TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=200,
                                                 RPN_POST_NMS_TOP_N=32, BATCH_ROIS=16,
                                                 RPN_BATCH_SIZE=32))
cli.generate_config = tiny
out = cli.main(["--cpu", "1", "--synthetic", "8", "--max_steps", "1", "--compute_dtype",
                "bfloat16", "--prefix", {str(tmp_path / "e2e")!r}])
assert out["steps"] == 1 and out["state"].model.cfg.network.COMPUTE_DTYPE == "bfloat16", out
assert all(math.isfinite(v) for v in out["history"][0].values()), out
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def test_port_serves_a_vgg_request_without_jax():
    """One request through VGG-16 (ROIPooling, fc6/fc7): finite
    detections of every class."""
    r = run_blocked("""
import dataclasses, numpy as np, torch
torch.set_num_threads(2)
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.tester import Predictor
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess
from mx_rcnn_tpu_torch.serve.runner import detect_single
cfg = generate_config("vgg", "PascalVOC")
cfg = cfg.replace(dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
                  SHAPE_BUCKETS=((96, 128), (128, 96)),
                  TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16))
pred = Predictor(build_model(cfg), make_test_postprocess(cfg, 21, cfg.TEST.SCORE_THRESH, 10), device="cpu")
im = (np.random.RandomState(0).rand(60, 80, 3) * 255).astype(np.uint8)
dets = detect_single(pred, im, cfg, 21)
assert len(dets) == 21 and all(np.isfinite(d).all() for d in dets[1:])
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def test_port_trains_a_vgg_step_without_jax(tmp_path):
    """``train_end2end --network vgg``: one step at 192 × 192 (VGG's
    smallest anchors, 128 px, fit), conv1/conv2 frozen."""
    r = run_blocked(f"""
import dataclasses, math, torch
torch.set_num_threads(2)
import mx_rcnn_tpu_torch.tools.train_end2end as cli
from mx_rcnn_tpu_torch.config import generate_config
def tiny(network, dataset):
    assert network == "vgg"
    cfg = generate_config(network, dataset)
    return cfg.replace(dataset=dataclasses.replace(cfg.dataset, SCALES=((192, 192),)),
                       SHAPE_BUCKETS=((192, 192),),
                       TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=200,
                                                 RPN_POST_NMS_TOP_N=32, BATCH_ROIS=16,
                                                 RPN_BATCH_SIZE=32))
cli.generate_config = tiny
out = cli.main(["--cpu", "1", "--network", "vgg", "--synthetic", "4", "--max_steps", "1",
                "--prefix", {str(tmp_path / "e2e")!r}])
model = out["state"].model
assert out["steps"] == 1 and type(model.backbone).__name__ == "VGGBackbone", out
assert all(math.isfinite(v) for v in out["history"][0].values()), out
assert [n for n, p in model.named_parameters() if not p.requires_grad] == [
    f"backbone.conv{{b}}_{{i}}.{{t}}" for b in (1, 2) for i in (1, 2) for t in ("weight", "bias")]
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def test_port_runs_alternate_training_without_jax(tmp_path):
    """The four-stage alternate CLI at a tiny size, one step a stage: its
    artifacts, and the combined tree loads into the port's FasterRCNN."""
    r = run_blocked(f"""
import dataclasses, os, torch
torch.set_num_threads(2)
import mx_rcnn_tpu_torch.tools.train_alternate as cli
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch
from mx_rcnn_tpu_torch.utils.combine_model import load_params
def tiny(network, dataset):
    cfg = generate_config("resnet50", dataset)
    return cfg.replace(network=dataclasses.replace(cfg.network, ANCHOR_SCALES=(2, 4, 8)),
                       dataset=dataclasses.replace(cfg.dataset, SCALES=((128, 128),)),
                       SHAPE_BUCKETS=((128, 128),),
                       TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=200,
                                                 RPN_POST_NMS_TOP_N=32, BATCH_ROIS=16,
                                                 RPN_BATCH_SIZE=32, FLIP=False),
                       TEST=dataclasses.replace(cfg.TEST, PROPOSAL_PRE_NMS_TOP_N=200,
                                                PROPOSAL_POST_NMS_TOP_N=32))
cli.generate_config = tiny
out_dir = {str(tmp_path / "alt")!r}
final = cli.main(["--cpu", "1", "--synthetic", "2", "--max_steps", "1", "--out_dir", out_dir])
names = sorted(os.listdir(out_dir))
assert names == ["final.pkl", "proposals1.pkl", "proposals2.pkl", "rcnn1.pkl", "rcnn2.pkl",
                 "rpn1.pkl", "rpn2.pkl", "run_meta.json"], names
flax_to_torch(load_params(os.path.join(out_dir, "final.pkl")), FasterRCNN(tiny("resnet", "PascalVOC")))
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def test_port_trains_a_mask_step_without_jax(tmp_path):
    """``--network mask_resnet_fpn --dataset coco``: one step on synthetic
    polygon records and their flipped copies, the gt masks rasterized by the
    C RLE library."""
    r = run_blocked(f"""
import dataclasses, math, torch
torch.set_num_threads(2)
import mx_rcnn_tpu_torch.tools.train_end2end as cli
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.native import rle
def tiny(network, dataset):
    cfg = generate_config(network, dataset)
    assert cfg.network.USE_MASK
    return cfg.replace(network=dataclasses.replace(cfg.network, depth=50),
                       dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
                       SHAPE_BUCKETS=((96, 128), (128, 96)),
                       TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=200,
                                                 RPN_POST_NMS_TOP_N=32, BATCH_ROIS=16,
                                                 RPN_BATCH_SIZE=32))
cli.generate_config = tiny
out = cli.main(["--network", "mask_resnet_fpn", "--dataset", "coco", "--cpu", "1",
                "--synthetic", "2", "--max_steps", "1", "--prefix", {str(tmp_path / "e2e")!r}])
assert out["steps"] == 1, out
hist = out["history"][0]
assert "MaskBCELoss" in hist and all(math.isfinite(v) for v in hist.values()), out
assert rle.backend() == "c"
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def test_port_checkpoints_resumes_and_evaluates_without_jax(tmp_path):
    """A C4 CLI step saved under ``--prefix`` (``epoch_0001``), one more
    after ``--resume`` (``epoch_0002``), then ``tools/test.py --prefix``
    on the newest dump."""
    r = run_blocked(f"""
import dataclasses, os, torch
torch.set_num_threads(2)
import mx_rcnn_tpu_torch.tools.test as test_cli
import mx_rcnn_tpu_torch.tools.train_end2end as train_cli
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.checkpoint import restorable_checkpoints
def tiny(network, dataset):
    cfg = generate_config("resnet50", dataset)
    return cfg.replace(dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
                       SHAPE_BUCKETS=((96, 128), (128, 96)),
                       TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=200,
                                                 RPN_POST_NMS_TOP_N=32, BATCH_ROIS=16,
                                                 RPN_BATCH_SIZE=32),
                       TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=100,
                                                RPN_POST_NMS_TOP_N=16))
train_cli.generate_config = test_cli.generate_config = tiny
prefix = {str(tmp_path / "e2e")!r}
args = ["--cpu", "1", "--synthetic", "1", "--no_flip", "--prefix", prefix]
first = train_cli.main(args + ["--epochs", "1"])
assert first["steps"] == 1 and restorable_checkpoints(prefix) == [(1, 0)], first
again = train_cli.main(args + ["--epochs", "2", "--resume"])
assert again["begin"] == (1, 0) and again["steps"] == 1, again
assert restorable_checkpoints(prefix) == [(2, 0), (1, 0)]
assert os.path.exists(os.path.join(prefix, "run_meta.json"))
out = test_cli.main(["--cpu", "1", "--synthetic", "1", "--prefix", prefix])
assert 0.0 <= out["mAP"] <= 1.0, out
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert "loaded checkpoint epoch 2" in r.stdout
    assert r.stdout.split()[-1] == "ok"


def test_port_evaluates_without_jax(tmp_path):
    """``tools/test.py`` on 2 synthetic images on the CPU, from a params
    pickle written by the bridge, with the host C NMS."""
    r = run_blocked(f"""
import dataclasses, torch
torch.set_num_threads(2)
import mx_rcnn_tpu_torch.tools.test as cli
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.native import hostops
from mx_rcnn_tpu_torch.utils.bridge import torch_to_flax
from mx_rcnn_tpu_torch.utils.combine_model import save_params
def tiny(network, dataset):
    cfg = generate_config("resnet50", dataset)
    return cfg.replace(dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
                       SHAPE_BUCKETS=((96, 128), (128, 96)),
                       TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=100,
                                                RPN_POST_NMS_TOP_N=16))
cli.generate_config = tiny
path = {str(tmp_path / "params.pkl")!r}
save_params(path, torch_to_flax(build_model(tiny("resnet", "PascalVOC"))))
out = cli.main(["--cpu", "1", "--synthetic", "2", "--params", path])
assert 0.0 <= out["mAP"] <= 1.0, out
assert hostops.backend() == "c"
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert "mAP:" in r.stdout
    assert r.stdout.split()[-1] == "ok"


def test_port_decodes_a_jpeg_and_writes_a_png_without_jax(tmp_path):
    """A fixture JPEG decoded to its manifest hash (cv2's decode) and the
    overlay written as a PNG, with OpenCV and PIL blocked."""
    r = run_blocked(f"""
import hashlib, json, zlib
import numpy as np
from mx_rcnn_tpu_torch.data.image import load_image
from mx_rcnn_tpu_torch.utils.visualize import draw_detections, save_image
entry = json.load(open("tests/fixtures/jpeg/manifest.json"))["files"][0]
im = load_image("tests/fixtures/jpeg/" + entry["name"])
assert hashlib.sha256(im.astype(np.uint8).tobytes()).hexdigest() == entry["sha256"]
dets = {{"dog": np.array([[10, 20, 200, 150, 0.9]], np.float32)}}
out = {str(tmp_path / "o.png")!r}
save_image(out, draw_detections(im, dets))
data = open(out, "rb").read()
assert data[:8] == b"\\x89PNG\\r\\n\\x1a\\n"
h, w = im.shape[:2]
raw = zlib.decompress(data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8])
assert len(raw) == h * (1 + 3 * w)
print("ok")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def _no_result(r: subprocess.CompletedProcess) -> bool:
    for line in r.stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return False
        except (ValueError, AttributeError):
            continue
    return True


def test_port_serves_through_the_engine_and_cli_without_jax():
    """Requests through ``ServingEngine`` (two families, both lanes, the
    response cache) by ``tools/serve.py --cpu``."""
    r = run_blocked("""
import torch
torch.set_num_threads(2)
from mx_rcnn_tpu_torch.tools import serve
rep = serve.main(["--cpu", "--small", "--requests", "4", "--concurrency", "2", "--max_batch", "1",
                  "--model", "second=resnet50:random:1", "--lane_mix", "2",
                  "--response_cache", "4"])
e = rep["engine"]
assert rep["outcomes"]["ok"] == 4 and e["requests"]["completed"] == 4, rep["outcomes"]
assert e["compile"]["misses"] == 4 and e["response_cache"]["capacity"] == 4
assert not any(m.split(".")[0] in _BLOCKED for m in sys.modules)
print("ok")
""")
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split()[-1] == "ok"


def test_chip_smoke_fails_without_a_card():
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert r.returncode != 0
    assert _no_result(r)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode != 0
    assert _no_result(r)
