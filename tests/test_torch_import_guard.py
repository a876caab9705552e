"""The PyTorch port imports and runs where JAX, Flax, OpenCV and the JAX
package cannot be imported (it serves a request and trains a step through
its CLI), and ``chip_smoke.py`` refuses to report without a card or outside
the repository."""

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
_BLOCKED = ("jax", "jaxlib", "flax", "mx_rcnn_tpu", "cv2")
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


def test_port_trains_a_step_without_jax():
    r = run_blocked("""
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
out = cli.main(["--cpu", "1", "--synthetic", "8", "--max_steps", "1"])
assert out["steps"] == 1, out
assert all(math.isfinite(v) for v in out["history"][0].values()), out
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
