"""``tools/profile_step.py`` on a small config on the CPU: ``profile()``
gives the JAX tool's rows (``report[...]`` in its ``main``) and
``ablate()`` its printed row labels, each with a finite wall time > 0 (no
device time off the card); the flagship batch is ``__graft_entry__``'s."""

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import torch

import mx_rcnn_tpu.tools.profile_step as jprofile
from __graft_entry__ import _batch as j_batch
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.tools import profile_step as tprofile

torch.set_num_threads(2)
SOURCE = Path(jprofile.__file__).read_text()


def small_cfg():
    cfg = generate_config("resnet50", "PascalVOC")
    return cfg.replace(
        SHAPE_BUCKETS=((128, 128),),
        TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=400, RPN_POST_NMS_TOP_N=64,
                                  BATCH_ROIS=16),
    )


def _rows_hold(rows):
    for name, v in rows.items():
        assert math.isfinite(v["wall_ms"]) and v["wall_ms"] > 0, name
        assert v["device_ms"] is None, name


def test_profile_rows_are_jax_rows():
    rows = tprofile.profile(small_cfg(), "cpu", iters=1, dtype="float32", warmup=1)
    rate = rows.pop("imgs/sec (full step)")
    assert set(rows) == set(re.findall(r'report\["(\w+)"\]', SOURCE))
    assert len(rows) == 11 and math.isfinite(rate) and rate > 0
    _rows_hold(rows)


def test_ablate_rows_are_jax_rows():
    b = 2
    labels = [lab.strip().replace("{b}", str(b))
              for lab in re.findall(r'print\(f"([^"]+?)\s*:\s*"', SOURCE)]
    rows = tprofile.ablate(small_cfg(), "cpu", iters=1, dtype="bfloat16", batch=b)
    assert list(rows) == labels and len(labels) == 7
    _rows_hold(rows)


def test_flagship_batch_is_graft_entrys():
    cfg = generate_config("resnet", "PascalVOC")
    got = tprofile.flagship_batch(cfg, 2, 608, 1024)
    want = j_batch(cfg, 2, 608, 1024)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
