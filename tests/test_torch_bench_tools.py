"""The port's measuring tools against the JAX package's: ``bench_eval``'s
data plane (a tiny stream around the stub device: the serial sweep's
detections byte-equal to JAX's, the overlapped sweep's to the serial one's)
and ``_smoke_shrink``; ``check_data``'s probes on the fixture trees of
``tests/test_datasets.py::TestCheckDataProbe``; ``bench_coco_eval``'s
synthetic set and COCOeval's 12 stats."""

import dataclasses
import json
import os
from unittest import mock

import numpy as np
import pytest

import mx_rcnn_tpu.serve.runner as jrunner
from mx_rcnn_tpu.data import loader as jloader
from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.eval.coco_eval import COCOEvalBbox as JCOCOEvalBbox
from mx_rcnn_tpu.tools import bench_coco_eval as jbce
from mx_rcnn_tpu.tools import bench_eval as jbe
from mx_rcnn_tpu.tools import check_data as jcd
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.eval.coco_eval import COCOEvalBbox
from mx_rcnn_tpu_torch.tools import bench_coco_eval as tbce
from mx_rcnn_tpu_torch.tools import bench_eval as tbe
from mx_rcnn_tpu_torch.tools import check_data as tcd
from tests.test_datasets import voc_devkit  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def clean_render_cache():
    """The JAX render LRU keys renders without their size: start without
    another file's renders (the same synthetic uris at another size), and
    drop this file's."""
    jloader._RENDER_CACHE.clear()
    yield
    jloader._RENDER_CACHE.clear()


def _bytes(slots):
    return b"".join(d.tobytes() for per_im in slots for d in (per_im or [])[1:])


def test_data_plane_detections_equal_jax():
    """4 flagship-size images in batches of 2, a 1 ms stub: the port's serial
    sweep's per-image detections are JAX's byte for byte (JAX's recorded at
    its ``cap_detections``, in stream order, from its first serial sweep)."""
    got = []
    report = tbe.data_plane_report(images=4, batch=2, stub_device_ms=1.0, detections_out=got)
    assert report["byte_identical"] is True
    assert report["images"] == 4 and report["baseline_imgs_per_sec"] > 0
    assert report["overlapped"]["completion"]["completed"] == 2
    recorded, orig = [], jrunner.cap_detections

    def record(*a, **k):
        out = orig(*a, **k)
        recorded.append(out[0])
        return out

    with mock.patch.object(jrunner, "cap_detections", record):
        jreport = jbe.data_plane_report(images=4, batch=2, stub_device_ms=1.0)
    assert jreport["byte_identical"] is True
    assert set(report) == set(jreport)
    want = _bytes(recorded[:4])
    assert len(want) > 0 and _bytes(got) == want


def test_smoke_shrink_equals_jax():
    got = tbe._smoke_shrink(generate_config("resnet", "PascalVOC"))
    want = jbe._smoke_shrink(j_generate_config("resnet", "PascalVOC"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_voc_probe_equals_jax(voc_devkit):  # noqa: F811
    assert tcd.probe_voc(voc_devkit) == jcd.probe_voc(voc_devkit)
    assert not tcd.probe_voc(voc_devkit)[0]
    base = os.path.join(voc_devkit, "VOC2007")
    for idx in ("000001", "000002"):
        with open(os.path.join(base, "JPEGImages", f"{idx}.jpg"), "wb") as f:
            f.write(b"\xff\xd8\xff\xd9")
    with open(os.path.join(base, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("000002\n")
    assert tcd.probe_voc(voc_devkit) == jcd.probe_voc(voc_devkit)
    assert tcd.probe_voc(voc_devkit)[0]
    assert tcd.probe_voc(voc_devkit, ("2007", "2012")) == jcd.probe_voc(voc_devkit,
                                                                       ("2007", "2012"))


def test_coco_probe_equals_jax(tmp_path):
    root = str(tmp_path / "coco")
    states = [tcd.probe_coco(root) == jcd.probe_coco(root)]
    (tmp_path / "coco" / "annotations").mkdir(parents=True)
    (tmp_path / "coco" / "val2017").mkdir()
    (tmp_path / "coco" / "train2017").mkdir()
    ds = {"images": [{"id": 1, "file_name": "a.jpg", "height": 4, "width": 4}],
          "annotations": [], "categories": [{"id": 1, "name": "x"}]}
    for split in ("train2017", "val2017"):
        with open(tmp_path / "coco" / "annotations" / f"instances_{split}.json", "w") as f:
            json.dump(ds, f)
    (tmp_path / "coco" / "val2017" / "a.jpg").write_bytes(b"\xff\xd8\xff\xd9")
    states.append(tcd.probe_coco(root) == jcd.probe_coco(root))
    assert not tcd.probe_coco(root)[0]
    (tmp_path / "coco" / "train2017" / "b.jpg").write_bytes(b"\xff\xd8\xff\xd9")
    states.append(tcd.probe_coco(root) == jcd.probe_coco(root))
    assert all(states) and tcd.probe_coco(root)[0]


def test_recipes_name_the_port_clis():
    assert tcd.RECIPES.keys() == jcd.RECIPES.keys()
    for name, (cmd, target) in tcd.RECIPES.items():
        assert cmd == jcd.RECIPES[name][0].replace("mx_rcnn_tpu.", "mx_rcnn_tpu_torch.")
        assert target == jcd.RECIPES[name][1]


def test_check_data_cli(voc_devkit, capsys):  # noqa: F811
    root = os.path.dirname(voc_devkit)
    assert tcd.main(["--data_root", root]) == 1
    assert "NOT READY" in capsys.readouterr().out
    base = os.path.join(voc_devkit, "VOC2007")
    for idx in ("000001", "000002"):
        with open(os.path.join(base, "JPEGImages", f"{idx}.jpg"), "wb") as f:
            f.write(b"\xff\xd8\xff\xd9")
    with open(os.path.join(base, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("000002\n")
    assert tcd.main(["--data_root", root]) == 0
    out = capsys.readouterr().out
    assert "READY." in out and "mx_rcnn_tpu_torch.tools.train_end2end" in out


def test_synthetic_coco_and_stats_equal_jax():
    got = tbce.synthetic_coco(50, 80, 6, 14)
    want = jbce.synthetic_coco(50, 80, 6, 14)
    assert got == want
    stats = COCOEvalBbox(*got).evaluate(verbose=False)
    ref = JCOCOEvalBbox(*want).evaluate(verbose=False)
    assert len(stats) == 12 and stats == ref
    assert all(np.isfinite(v) for v in stats.values())


def test_bench_coco_eval_cli(capsys):
    out = tbce.main(["--images", "20", "--cats", "5"])
    assert out["evaluate_s"] > 0 and len(out["stats"]) == 12
    assert "20 imgs × 5 cats" in capsys.readouterr().out


@pytest.mark.parametrize("argv,path", [([], "device"), (["--host_path"], "host")])
def test_bench_eval_smoke_cli(argv, path, monkeypatch):
    """``--smoke --cpu`` at 4 images: the JAX tool's JSON line (ResNet-50,
    the constructors' default init: the seeded truncated normal of every
    kernel takes longer than the sweeps on this CPU)."""
    import mx_rcnn_tpu_torch.config as tconfig
    import mx_rcnn_tpu_torch.models.faster_rcnn as tfr

    small = generate_config("resnet50", "PascalVOC")
    monkeypatch.setattr(tconfig, "generate_config", lambda net, ds: small)
    monkeypatch.setattr(tfr, "init_weights", lambda model, generator: None)
    line = tbe.main(["--smoke", "--cpu", "--images", "4", "--batch", "2",
                     "--compute_dtype", "float32"] + argv)
    assert line["metric"] == "eval_imgs_per_sec_per_chip_resnet"
    assert line["unit"] == "imgs/sec/chip" and line["value"] > 0
    assert line["path"] == path and line["smoke"] is True and line["batch"] == 2
