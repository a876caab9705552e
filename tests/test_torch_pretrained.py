"""``utils/pretrained.py`` of the PyTorch port against the JAX package's on
random torchvision-named state dicts (``tests/test_pretrained.py``'s
``fake_resnet_sd`` / ``fake_vgg_sd``; no weights are on disk): the imported
trees (ResNet-50/101 in the C4 and FPN layouts, VGG-16 with fc6's CHW → HWC
rows), a port model after ``apply_pretrained`` bitwise equal to
``flax_to_torch`` of JAX's ``apply_pretrained``, the checkpoint formats, the
shape check, and ``--pretrained`` on the training CLIs (the torchvision
pixel statistics in ``run_meta.json``).  Every comparison is exact: the
import only moves and permutes float32 values."""

import dataclasses
import functools
import pickle

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.utils import pretrained as jpre
from mx_rcnn_tpu_torch.config import generate_config as t_generate_config
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.tools import train_end2end as e2e_cli
from mx_rcnn_tpu_torch.utils import pretrained as tpre
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, torch_to_flax
from mx_rcnn_tpu_torch.utils.run_meta import load_run_meta
from tests.test_pretrained import fake_resnet_sd, fake_vgg_sd

torch.set_num_threads(2)

# (config name, importer network, depth, FPN layout)
CASES = {
    "resnet50": ("resnet50", "resnet", 50, False),
    "resnet101": ("resnet", "resnet", 101, False),
    "resnet50_fpn": ("resnet_fpn", "resnet", 50, True),
    "vgg16": ("vgg", "vgg", 16, False),
}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@functools.lru_cache(maxsize=None)
def fake_sd(case, seed=0):
    """The case's random torchvision state dict (shared: do not write into
    it)."""
    rng = np.random.RandomState(seed)
    _, network, depth, _ = CASES[case]
    return fake_vgg_sd(rng) if network == "vgg" else fake_resnet_sd(rng, depth)


def meta_model(case):
    """The case's port model (FasterRCNN, or FPNFasterRCNN), built on the
    meta device and filled with seeded numpy values (the seeded init of
    VGG-16's fc6 alone takes ~10 s on the CPU)."""
    name = CASES[case][0]
    with torch.device("meta"):
        model = build_model(t_generate_config(name, "PascalVOC"))
    model = model.to_empty(device="cpu")
    gen = np.random.default_rng(1)
    model.load_state_dict({k: torch.from_numpy(gen.standard_normal(tuple(t.shape),
                                                                   dtype=np.float32))
                           for k, t in model.state_dict().items()})
    return model


@pytest.mark.parametrize("case", list(CASES))
def test_import_trees_equal_jax(case):
    """The imported {backbone, top_head} trees leaf for leaf, bitwise."""
    _, network, depth, fpn = CASES[case]
    sd = fake_sd(case)
    if network == "vgg":
        got, ref = tpre.import_vgg16(sd), jpre.import_vgg16(sd)
    else:
        got, ref = tpre.import_resnet(sd, depth, fpn), jpre.import_resnet(sd, depth, fpn)
    for g, r in zip(got, ref):
        g, r = dict(_leaves(g)), dict(_leaves(r))
        assert set(g) == set(r)
        for p in r:
            assert g[p].dtype == r[p].dtype == np.float32
            np.testing.assert_array_equal(g[p], r[p], err_msg="/".join(p))
    if fpn:
        assert got[1] == {} and "stage4" in got[0]


def test_vgg_fc6_reads_the_roi_in_hwc_order():
    """fc6 of the imported VGG-16 on an (R, 7, 7, 512) roi flattened in
    (h, w, c) order is torchvision's fc6 on the same roi in (c, h, w)
    order."""
    sd = fake_sd("vgg16")
    _, top = tpre.import_vgg16(sd)
    roi = np.random.RandomState(2).rand(2, 7, 7, 512).astype(np.float32)
    ours = roi.reshape(2, -1) @ top["fc6"]["kernel"]
    theirs = roi.transpose(0, 3, 1, 2).reshape(2, -1) @ sd["classifier.0.weight"].T
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_apply_pretrained_equals_jax_bitwise(case):
    """``apply_pretrained`` on a port model: every tensor equal to
    ``flax_to_torch`` of JAX's ``apply_pretrained`` of the same model's
    tree; the backbone (and the C4 / VGG top head) replaced, the RPN and
    RCNN heads (and FPN's neck) as they were."""
    _, network, depth, fpn = CASES[case]
    sd = fake_sd(case)
    model = meta_model(case)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ref = jpre.apply_pretrained(torch_to_flax(model), sd, network, depth, fpn=fpn)
    tpre.apply_pretrained(model, sd, network, depth, fpn=fpn)
    twin = flax_to_torch(ref, meta_model(case))
    replaced = ("backbone",) if fpn else ("backbone", "top_head")
    for k, v in model.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k
        assert torch.equal(v, before[k]) != k.startswith(replaced), k


@pytest.mark.parametrize("fmt", [".pth", ".pt", ".npz", ".pkl"])
def test_checkpoint_formats_round_trip(tmp_path, fmt):
    """A torchvision state dict saved by ``torch.save`` (read back
    weights-only), as an ``.npz`` or as a pickled dict reads back to the
    same arrays, as JAX's ``load_state_dict`` reads it."""
    sd = fake_sd("resnet50")
    path = str(tmp_path / f"ckpt{fmt}")
    if fmt in (".pth", ".pt"):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    elif fmt == ".npz":
        np.savez(path, **sd)
    else:
        with open(path, "wb") as f:
            pickle.dump(sd, f)
    got, ref = tpre.load_state_dict(path), jpre.load_state_dict(path)
    assert set(got) == set(ref) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k], v)
        np.testing.assert_array_equal(got[k], ref[k])


def test_shape_mismatch_raises():
    """A checkpoint of another width raises, naming the tensor; one of
    another depth misses names and raises too."""
    sd = dict(fake_sd("resnet50"))
    sd["conv1.weight"] = sd["conv1.weight"][:32]
    model = meta_model("resnet50")
    with pytest.raises(ValueError, match="conv0"):
        tpre.apply_pretrained(model, sd, "resnet", 50)
    with pytest.raises(KeyError):
        tpre.apply_pretrained(model, fake_sd("resnet50"), "resnet", 101)


def test_torchvision_pixel_stats_equal_jax():
    assert tpre.torchvision_pixel_stats() == jpre.torchvision_pixel_stats()


def _tiny(network, dataset):
    cfg = t_generate_config("resnet50", dataset)
    return cfg.replace(dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
                       SHAPE_BUCKETS=((96, 128), (128, 96)),
                       TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=200,
                                                 RPN_POST_NMS_TOP_N=32, BATCH_ROIS=16,
                                                 RPN_BATCH_SIZE=32))


def test_train_end2end_pretrained_imports_and_records_pixel_stats(monkeypatch, tmp_path):
    """``train_end2end --pretrained`` starts from the checkpoint's backbone
    (the frozen conv0 still equal to it after a step), trains with the
    torchvision pixel statistics and writes them to ``run_meta.json``."""
    sd = fake_sd("resnet50")
    ckpt = str(tmp_path / "r50.npz")
    np.savez(ckpt, **sd)
    monkeypatch.setattr(e2e_cli, "generate_config", _tiny)
    seen = {}
    real_fit = e2e_cli.fit

    def spy(model, cfg, *a, **k):
        seen["cfg"], seen["model"] = cfg, model
        return real_fit(model, cfg, *a, **k)

    monkeypatch.setattr(e2e_cli, "fit", spy)
    prefix = str(tmp_path / "e2e")
    out = e2e_cli.main(["--cpu", "1", "--synthetic", "4", "--max_steps", "1", "--pretrained",
                        ckpt, "--prefix", prefix])
    assert out["steps"] == 1
    means, stds = tpre.torchvision_pixel_stats()
    meta = load_run_meta(prefix)
    assert tuple(meta["PIXEL_MEANS"]) == means and tuple(meta["PIXEL_STDS"]) == stds
    assert seen["cfg"].network.PIXEL_MEANS == means
    conv0 = torch_to_flax(seen["model"])["backbone"]["conv0"]["kernel"]
    np.testing.assert_array_equal(conv0, sd["conv1.weight"].transpose(2, 3, 1, 0))
