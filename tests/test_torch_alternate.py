"""Alternate training in the PyTorch port on the CPU against the JAX package,
on the same numpy-seeded inputs and bridged weights: the host geometry and
target statistics, proposal recall, the proposal roidbs and the loaders'
``proposal_count`` batches, proposal dumps across the two packages, the two
stage graphs (bridge, test forwards, one train step each under FIXED_PARAMS
and FIXED_PARAMS_SHARED with JAX's draws), ``test_rpn``, ``combine_model``,
the four-stage ``alternate_train`` and the stage CLIs, at the size of
``tests/test_alternate.py::tiny_alt_cfg`` (ResNet-50, 128 × 128)."""

import copy
import dataclasses
import functools
import logging
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mx_rcnn_tpu.core.fit import merge_params as j_merge_params
from mx_rcnn_tpu.core.train import is_frozen_path as j_is_frozen_path
from mx_rcnn_tpu.core.train import make_lr_schedule as j_make_lr_schedule
from mx_rcnn_tpu.core.train import make_optimizer as j_make_optimizer
from mx_rcnn_tpu.data import ds_utils as j_ds_utils
from mx_rcnn_tpu.data import loader as jloader
from mx_rcnn_tpu.data.imdb import IMDB as JIMDB
from mx_rcnn_tpu.eval.recall import proposal_recall as j_proposal_recall
from mx_rcnn_tpu.models import FasterRCNN as JFasterRCNN
from mx_rcnn_tpu.models.stage_models import FastRCNN as JFastRCNN
from mx_rcnn_tpu.models.stage_models import RPNOnly as JRPNOnly
from mx_rcnn_tpu.tools.reeval import reeval as j_reeval
from mx_rcnn_tpu.tools.test_rpn import test_rpn as j_test_rpn
from mx_rcnn_tpu.utils import bbox_stats as j_bbox_stats
from mx_rcnn_tpu.utils.combine_model import combine_model as j_combine_model
from mx_rcnn_tpu.utils.combine_model import load_params as j_load_params
from mx_rcnn_tpu.utils.load_data import load_proposal_roidb as j_load_proposal_roidb
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.fit import merge_params
from mx_rcnn_tpu_torch.core.tester import Predictor, generate_proposals
from mx_rcnn_tpu_torch.data import ds_utils
from mx_rcnn_tpu_torch.data import loader as tloader
from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.eval.recall import proposal_recall
from mx_rcnn_tpu_torch.models import stage_models as tsm
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.models.stage_models import FastRCNN, RPNOnly
from mx_rcnn_tpu_torch.utils.pretrained import torchvision_pixel_stats
from mx_rcnn_tpu_torch.tools import reeval as reeval_cli
from mx_rcnn_tpu_torch.tools import test as test_cli
from mx_rcnn_tpu_torch.tools import test_rpn as test_rpn_cli
from mx_rcnn_tpu_torch.tools import train_alternate as alt_cli
from mx_rcnn_tpu_torch.tools import train_rcnn as train_rcnn_cli
from mx_rcnn_tpu_torch.tools import train_rpn as train_rpn_cli
from mx_rcnn_tpu_torch.utils import bbox_stats
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, grads_to_flax, torch_to_flax
from mx_rcnn_tpu_torch.utils.combine_model import combine_model, load_params, save_params
from mx_rcnn_tpu_torch.utils.load_data import attach_proposals, load_proposal_roidb
from mx_rcnn_tpu_torch.utils.run_meta import load_run_meta
from tests.test_alternate import tiny_alt_cfg
from tests.test_model import tiny_batch
from tests.test_nms import random_dets
from tests.test_pretrained import fake_resnet_sd
from tests.test_torch_model import _perturb, _tame_rpn, port_cfg, uint8_batch

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def stage_cfg():
    """``tiny_alt_cfg`` with one image a batch: ResNet-50 at 128 × 128, 4
    classes, anchors of 32–128 px, 400 → 64 train and 200 → 64 dump
    proposals."""
    cfg = tiny_alt_cfg()
    return cfg.replace(TRAIN=dataclasses.replace(cfg.TRAIN, BATCH_IMAGES=1))


@pytest.fixture(autouse=True)
def clean_render_cache():
    """The JAX render LRU keys renders without their size: start without
    another file's renders, and drop this file's."""
    jloader._RENDER_CACHE.clear()
    yield
    jloader._RENDER_CACHE.clear()


@pytest.fixture(scope="module")
def roidb():
    return SyntheticDataset(num_images=4, num_classes=4, image_size=(128, 128),
                            max_boxes=2).gt_roidb()


def random_proposals(rng, rec, n):
    """(n, 5) score-descending proposals of a record, in its image: jittered
    copies of its gt boxes, then random boxes."""
    h, w = rec["height"], rec["width"]
    rows = []
    for k in range(n):
        if k < n // 2 and len(rec["boxes"]):
            box = rec["boxes"][k % len(rec["boxes"])] + rng.randn(4) * 4
        else:
            x1, y1 = rng.rand() * (w - 40), rng.rand() * (h - 40)
            box = [x1, y1, x1 + 10 + rng.rand() * 30, y1 + 10 + rng.rand() * 30]
        rows.append(np.clip(box, 0, [w - 1, h - 1, w - 1, h - 1]))
    scores = np.sort(rng.rand(n))[::-1]
    return np.hstack([np.asarray(rows, np.float32).reshape(n, 4),
                      scores[:, None]]).astype(np.float32)


# ----------------------------------------------------------- host pieces
@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_np_overlaps_matches(rng, case):
    a, _ = random_dets(rng, 40)
    b, _ = random_dets(rng, 7)
    if case == "degenerate":
        a[:5] = [[5, 5, 5, 5], [10, 10, 8, 12], [0, 0, 0, 0], [3, 3, 2, 2], [1, 1, 50, 50]]
        b[:2] = [[5, 5, 5, 5], [3, 3, 2, 2]]
    got = bbox_stats.np_overlaps(a, b)
    ref = j_bbox_stats.np_overlaps(a, b)
    assert got.dtype == np.float32 and got.shape == (40, 7)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert bbox_stats.np_overlaps(a[:0], b).shape == (0, 7)


def test_np_transform_matches(rng):
    ex, _ = random_dets(rng, 50)
    gt, _ = random_dets(rng, 50)
    ex[0] = [5, 5, 5, 5]
    gt[1] = [7, 7, 6, 6]
    np.testing.assert_allclose(bbox_stats.np_transform(ex, gt), j_bbox_stats.np_transform(ex, gt),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["global", "per_class", "no_foreground"])
def test_compute_bbox_stats_matches(roidb, kind):
    """Means and stds within 1e-6 of JAX's; without a fg proposal both
    fall back to the config's defaults (tiled per class)."""
    jcfg = stage_cfg()
    rng = np.random.RandomState(4)
    if kind == "no_foreground":
        rdb = [dict(r, proposals=np.tile([[0, 0, 3, 3]], (5, 1)).astype(np.float32))
               for r in roidb]
    else:
        rdb = attach_proposals(roidb, [random_proposals(rng, r, 30) for r in roidb])
    for per_class in ((False, True) if kind == "no_foreground" else (kind == "per_class",)):
        got = bbox_stats.compute_bbox_stats(rdb, port_cfg(jcfg), per_class=per_class)
        ref = j_bbox_stats.compute_bbox_stats(rdb, jcfg, per_class=per_class)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]), rtol=1e-6, atol=1e-6)
        if kind == "no_foreground":
            row = (tuple(jcfg.TRAIN.BBOX_STDS),)
            assert tuple(got[1]) == (row * jcfg.dataset.NUM_CLASSES if per_class else row[0])
        elif per_class:
            assert len(got[0]) == jcfg.dataset.NUM_CLASSES
            assert tuple(got[1][0]) == tuple(jcfg.TRAIN.BBOX_STDS)


def _jax_stats_floored(ref, jcfg):
    """JAX's (means, stds) with the port's floor applied: a coordinate whose
    std is below ``STD_FLOOR`` × the default std takes the defaults."""
    means, stds = np.asarray(ref[0], np.float64), np.asarray(ref[1], np.float64)
    d_means, d_stds = np.asarray(jcfg.TRAIN.BBOX_MEANS), np.asarray(jcfg.TRAIN.BBOX_STDS)
    low = stds < bbox_stats.STD_FLOOR * d_stds
    return np.where(low, d_means, means), np.where(low, d_stds, stds), low


def _lone_class_roidb(roidb, seed, planted, per_class=True):
    """The roidb with random proposals, none of them fg for the first gt's
    class (for any class unless ``per_class``), and ``planted`` offsets of
    the first gt box added to the first record's proposals."""
    rng = np.random.RandomState(seed)
    lone = int(roidb[0]["gt_classes"][0])
    props = []
    for rec in roidb:
        p = random_proposals(rng, rec, 30)
        ov = bbox_stats.np_overlaps(p[:, :4], rec["boxes"])
        fg = ov.max(1) >= 0.5
        if per_class:
            fg &= np.asarray(rec["gt_classes"])[ov.argmax(1)] == lone
        props.append(p[~fg])
    extra = np.hstack([roidb[0]["boxes"][:1] + np.asarray(planted, np.float32),
                       np.full((len(planted), 1), 0.9, np.float32)])
    props[0] = np.vstack([extra, props[0]]).astype(np.float32)
    return attach_proposals(roidb, props), lone


def test_compute_bbox_stats_keeps_the_defaults_for_a_class_seen_once(roidb):
    """On a flipped proposal roidb where one class has a single fg proposal
    (and its mirror), JAX's std of the pair is 1e-8 in dy, dw and dh: the
    port keeps the defaults there and JAX's dx, and agrees with JAX to 1e-6
    on every other class and on the unsplit stats."""
    jcfg = stage_cfg()
    rdb, lone = _lone_class_roidb(roidb, 8, [[1, 1, 2, 1]])
    rdb = IMDB.append_flipped_images(rdb)
    got = bbox_stats.compute_bbox_stats(rdb, port_cfg(jcfg), per_class=True)
    ref = j_bbox_stats.compute_bbox_stats(rdb, jcfg, per_class=True)
    means, stds, low = _jax_stats_floored(ref, jcfg)
    assert ref[1][lone][1] < 1e-7 and ref[1][lone][2] < 1e-7 and ref[1][lone][3] < 1e-7
    assert low[lone].tolist() == [False, True, True, True] and low.sum() == 3
    assert got[1][lone][1:] == tuple(jcfg.TRAIN.BBOX_STDS)[1:]
    assert got[0][lone][1:] == tuple(jcfg.TRAIN.BBOX_MEANS)[1:]
    np.testing.assert_allclose(np.asarray(got[1]), stds, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got[0]), means, atol=1e-6)
    np.testing.assert_allclose(bbox_stats.compute_bbox_stats(rdb, port_cfg(jcfg)),
                               j_bbox_stats.compute_bbox_stats(rdb, jcfg), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("per_class", [True, False], ids=["per_class", "global"])
def test_compute_bbox_stats_keeps_the_defaults_where_the_spread_collapses(roidb, per_class):
    """Two distinct unflipped fg proposals with equal vertical offsets and
    heights (the only fg deltas of their class, or of the roidb): JAX's
    std is 1e-8 in dy and dh, the port keeps the defaults there and agrees
    with JAX to 1e-6 elsewhere."""
    jcfg = stage_cfg()
    rdb, lone = _lone_class_roidb(roidb, 9, [[3, 1, 5, 1], [-4, 1, 1, 1]], per_class)
    got = bbox_stats.compute_bbox_stats(rdb, port_cfg(jcfg), per_class=per_class)
    ref = j_bbox_stats.compute_bbox_stats(rdb, jcfg, per_class=per_class)
    means, stds, low = _jax_stats_floored(ref, jcfg)
    row = (lambda t: t[lone]) if per_class else (lambda t: t)
    assert row(ref[1])[1] < 1e-7 and row(ref[1])[3] < 1e-7 and row(ref[1])[0] > 1e-2
    assert row(low).tolist() == [False, True, False, True] and low.sum() == 2
    assert row(got[1])[1] == jcfg.TRAIN.BBOX_STDS[1] and row(got[1])[3] == jcfg.TRAIN.BBOX_STDS[3]
    np.testing.assert_allclose(np.asarray(got[1]), stds, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got[0]), means, atol=1e-6)


@pytest.mark.parametrize("fn", ["unique_boxes", "filter_small_boxes"])
def test_ds_utils_match(rng, fn):
    boxes = np.round(rng.rand(60, 4) * 20).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    boxes[30:40] = boxes[:10]
    args = (boxes, 1.0) if fn == "unique_boxes" else (boxes, 8)
    got, ref = getattr(ds_utils, fn)(*args), getattr(j_ds_utils, fn)(*args)
    np.testing.assert_array_equal(got, ref)
    assert 0 < len(got) < len(boxes)
    np.testing.assert_array_equal(getattr(ds_utils, fn)(boxes[:0], 1.0), np.zeros((0,), np.int64))


def test_proposal_recall_matches(roidb):
    """Exactly JAX's recall at each budget, an image without proposals and
    one whose covering proposal ranks last included."""
    rng = np.random.RandomState(5)
    props = [random_proposals(rng, r, 40) for r in roidb]
    props[1] = np.zeros((0, 5), np.float32)
    props[2] = np.vstack([props[2][20:], props[2][:20]])
    for thresh in (0.5, 0.7):
        got = proposal_recall(props, roidb, top_ns=(5, 20, 40), iou_thresh=thresh)
        assert got == j_proposal_recall(props, roidb, top_ns=(5, 20, 40), iou_thresh=thresh)
    assert 0 < got["recall@40"] < 1


def test_merge_params_matches_jax():
    """The donor's shared top-level subtrees replace the model's, the rest
    stay: RPN → FastRCNN shares only the backbone; a whole tree replaces
    everything."""
    tcfg = port_cfg(stage_cfg())
    model = FastRCNN(tcfg, torch.Generator().manual_seed(1))
    rcnn = torch_to_flax(model)
    rpn = torch_to_flax(RPNOnly(tcfg, torch.Generator().manual_seed(2)))
    got, ref = torch_to_flax(merge_params(model, rpn)), j_merge_params(rcnn, rpn)
    assert set(got) == set(ref) == {"backbone", "top_head", "rcnn"}
    for k in got:
        a, b = dict(_leaves(got[k])), dict(_leaves(ref[k]))
        assert a.keys() == b.keys() and all(np.array_equal(a[p], b[p]) for p in a)
    for p, a in _leaves(rpn["backbone"]):
        np.testing.assert_array_equal(dict(_leaves(got["backbone"]))[p], a)
    for p, a in _leaves(rcnn["rcnn"]):
        np.testing.assert_array_equal(dict(_leaves(got["rcnn"]))[p], a)
    whole = torch_to_flax(merge_params(FastRCNN(tcfg, torch.Generator().manual_seed(3)), rcnn))
    whole = dict(_leaves(whole))
    assert all(np.array_equal(whole[p], a) for p, a in _leaves(rcnn))
    with pytest.raises(KeyError, match="no Flax leaf"):
        merge_params(model, {"backbone": {"conv0": rpn["backbone"]["conv0"]}})


@pytest.mark.parametrize("fixed", ["FIXED_PARAMS", "FIXED_PARAMS_SHARED"])
def test_optimizer_freezes_the_stage_trees_as_jax_masks_them(fixed):
    """``make_optimizer(fixed_params=)`` leaves trainable exactly the leaves
    JAX's mask trains; FIXED_PARAMS_SHARED freezes the whole C4 backbone."""
    jcfg = stage_cfg()
    tcfg = port_cfg(jcfg)
    pattern = getattr(jcfg.network, fixed)
    for model in (RPNOnly(tcfg), FastRCNN(tcfg)):
        ttrain.make_optimizer(tcfg, model, lambda k: 0.1, fixed_params=pattern)
        trainable = {tuple(n.split(".")) for n, p in model.named_parameters() if p.requires_grad}
        ref = {path[:-1] + ("weight" if path[-1] == "kernel" else path[-1],)
               for path, _ in _leaves(torch_to_flax(model)) if not j_is_frozen_path(path, pattern)}
        assert trainable == ref
        assert any(p[0] == "backbone" for p in trainable) == (fixed == "FIXED_PARAMS")


# ---------------------------------------------------- loaders and dumps
@pytest.fixture(scope="module")
def proposal_roidb(roidb):
    rng = np.random.RandomState(6)
    return attach_proposals(roidb, [random_proposals(rng, r, n) for r, n in zip(roidb, (8, 20, 0, 13))])


def test_make_batch_with_proposals_is_jaxs(proposal_roidb):
    """proposals scaled by im_info[2] and cut or padded to the count, and
    prop_valid, bitwise; at a resize factor other than 1 too."""
    jcfg = stage_cfg()
    for scales in (((128, 128),), ((96, 96),)):
        j = jcfg.replace(dataset=dataclasses.replace(jcfg.dataset, SCALES=scales))
        recs = proposal_roidb[:2] + proposal_roidb[3:]
        got = tloader.make_batch(recs, port_cfg(j), (128, 128), seeds=[0, 1, 2], proposal_count=16)
        ref = jloader.make_batch(recs, j, (128, 128), seeds=[0, 1, 2], proposal_count=16)
        for key in ("im_info", "gt_boxes", "gt_valid", "sample_seeds", "proposals", "prop_valid"):
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        assert got["prop_valid"].sum(1).tolist() == [8, 16, 13]


@pytest.mark.parametrize("workers", [0, 1])
def test_train_loader_with_proposals_matches_jax(proposal_roidb, workers):
    """The epoch's batches, serially and from an assembly process: the
    proposal keys bitwise as JAX's loader's (which runs serially)."""
    jcfg = stage_cfg()
    rdb = IMDB.append_flipped_images(proposal_roidb)
    tl = tloader.TrainLoader(rdb, port_cfg(jcfg), 1, seed=3, prefetch=0, assembly_workers=workers,
                             proposal_count=16)
    jl = jloader.TrainLoader(rdb, jcfg, 1, seed=3, prefetch=0, assembly_workers=0,
                             proposal_count=16)
    try:
        got, ref = list(iter(tl)), list(iter(jl))
    finally:
        tl.close()
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        for key in ("sample_seeds", "im_info", "gt_boxes", "proposals", "prop_valid"):
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)
    assert sum(int(g["prop_valid"].sum()) for g in got) == 2 * (8 + 16 + 0 + 13)


def test_dumps_cross_between_the_packages(proposal_roidb, roidb, tmp_path):
    """A dump the JAX package wrote reads into the port's proposal roidb and
    the other way round; the flipped proposal roidbs are equal."""
    rng = np.random.RandomState(7)
    dump = [random_proposals(rng, r, 9) for r in roidb]
    path = tmp_path / "props.pkl"
    with open(path, "wb") as f:
        pickle.dump(dump, f, pickle.HIGHEST_PROTOCOL)
    got = IMDB.append_flipped_images(load_proposal_roidb(list(roidb), str(path), top_n=6))
    ref = JIMDB.append_flipped_images(j_load_proposal_roidb(list(roidb), str(path), top_n=6))
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        assert g["proposals"].dtype == np.float32 and g["flipped"] == r["flipped"]
        np.testing.assert_array_equal(g["proposals"], r["proposals"])
        np.testing.assert_array_equal(g["boxes"], r["boxes"])
    w = roidb[0]["width"]
    np.testing.assert_array_equal(got[4]["proposals"][:, 0], w - got[0]["proposals"][:, 2] - 1)
    # the port's dump (generate_proposals) holds numpy arrays only
    model = flax_to_torch(_tame_rpn(torch_to_flax(RPNOnly(port_cfg(stage_cfg())))),
                          RPNOnly(port_cfg(stage_cfg())))
    out = tmp_path / "port.pkl"
    props = generate_proposals(Predictor(model, device="cpu"),
                               tloader.TestLoader(roidb, port_cfg(stage_cfg())),
                               port_cfg(stage_cfg()), dump_path=str(out))
    back = j_load_proposal_roidb(list(roidb), str(out))
    assert all(type(p) is np.ndarray and p.dtype == np.float32 and p.shape[1] == 5 for p in props)
    for rec, p in zip(back, props):
        np.testing.assert_array_equal(rec["proposals"], p[:, :4])


# ------------------------------------------------------------ the graphs
@pytest.fixture(scope="module")
def stage_trees():
    """(JAX cfg, port cfg, the RPNOnly and FastRCNN trees of the port's
    seeded init with perturbed BN (and a tamed RPN), their JAX shapes)."""
    jcfg = stage_cfg()
    tcfg = port_cfg(jcfg)
    rpn = _tame_rpn(_perturb(torch_to_flax(RPNOnly(tcfg, torch.Generator().manual_seed(0))),
                             np.random.RandomState(1)))
    rcnn = _perturb(torch_to_flax(FastRCNN(tcfg, torch.Generator().manual_seed(0))),
                    np.random.RandomState(2))
    batch = proposal_batch(np.random.RandomState(0))
    keys = {"params": jax.random.key(0), "sampling": jax.random.key(1)}
    shapes = {
        "rpn": jax.eval_shape(lambda: JRPNOnly(jcfg).init(
            keys, batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
            train=True))["params"],
        "rcnn": jax.eval_shape(lambda: JFastRCNN(jcfg).init(keys, train=True, **batch))["params"],
    }
    return jcfg, tcfg, {"rpn": rpn, "rcnn": rcnn}, shapes


def proposal_batch(rng, p=64):
    """``tiny_batch`` (one 128 × 128 image, two gt boxes) with ``p``
    proposals: jittered copies of the gt boxes, then random boxes, and a
    few off the image's valid extent or inverted."""
    batch = {k: np.array(v) for k, v in tiny_batch(rng).items()}
    rec = {"height": 128, "width": 128, "boxes": batch["gt_boxes"][0, :2, :4]}
    props = random_proposals(rng, rec, p)[:, :4]
    props[-3] = [100.0, 100.0, 140.0, 150.0]
    props[-2] = [50.0, 50.0, 40.0, 45.0]
    batch["proposals"] = props[None]
    batch["prop_valid"] = np.ones((1, p), bool)
    batch["prop_valid"][0, -1] = False
    return batch


@pytest.mark.parametrize("kind", ["rpn", "rcnn"])
def test_bridge_round_trip_is_exact_on_the_stage_trees(stage_trees, kind):
    """The port's stage modules give the JAX stage trees leaf for leaf and
    shape for shape, and the round trip is exact."""
    _, tcfg, trees, shapes = stage_trees
    ref = dict(_leaves(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes[kind]))))
    got = dict(_leaves(trees[kind]))
    assert set(got) == set(ref)
    assert all(a.shape == ref[p].shape for p, a in got.items())
    assert {p[0] for p in got} == ({"backbone", "rpn"} if kind == "rpn"
                                   else {"backbone", "top_head", "rcnn"})
    model = (RPNOnly if kind == "rpn" else FastRCNN)(tcfg)
    back = dict(_leaves(torch_to_flax(flax_to_torch(trees[kind], model))))
    for path, a in got.items():
        np.testing.assert_array_equal(back[path], a, err_msg="/".join(path))


def test_rpn_only_test_forward_matches(stage_trees):
    """Equal validity, rois within 1e-4 px, scores within 1e-4, on uint8
    images one of which has bucket padding (the JAX graph masks none)."""
    jcfg, tcfg, trees, _ = stage_trees
    images, im_info, _ = uint8_batch(np.random.RandomState(3))
    ref = jax.jit(lambda p, x, i: JRPNOnly(jcfg).apply({"params": p}, x, i))(
        trees["rpn"], jnp.asarray(images), jnp.asarray(im_info))
    model = flax_to_torch(trees["rpn"], RPNOnly(tcfg)).eval()
    with torch.inference_mode():
        got = model(T(images), T(im_info))
    assert set(got) == {"rois", "roi_scores", "roi_valid"}
    tv, jv = got["roi_valid"].numpy(), np.asarray(ref["roi_valid"])
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum(1).min() >= 8
    np.testing.assert_allclose(got["rois"].numpy()[tv], np.asarray(ref["rois"])[jv], atol=1e-4)
    np.testing.assert_allclose(got["roi_scores"].numpy()[tv], np.asarray(ref["roi_scores"])[jv],
                               atol=1e-4)


def test_fast_rcnn_test_forward_matches_with_the_canvas_clamp(stage_trees):
    """The given proposals pooled with the canvas clamp (no ``valid_hw``):
    class probabilities within 1e-4, de-normalized deltas within 1e-3 (per
    class statistics on), rois and validity passed through, on proposals
    that reach past the image's valid extent; the same batch with the
    valid-extent clamp gives other features there."""
    jcfg, tcfg, trees, _ = stage_trees
    k = jcfg.dataset.NUM_CLASSES
    stats = dict(BBOX_MEANS_PER_CLASS=tuple((0.01 * c, 0.0, -0.01, 0.02) for c in range(k)),
                 BBOX_STDS_PER_CLASS=tuple((0.1, 0.1 + 0.01 * c, 0.2, 0.2) for c in range(k)))
    jcfg = jcfg.replace(TRAIN=dataclasses.replace(jcfg.TRAIN, **stats))
    tcfg = port_cfg(jcfg)
    batch = proposal_batch(np.random.RandomState(4))
    batch["im_info"][0, :2] = [100.0, 110.0]
    ref = jax.jit(lambda p, b: JFastRCNN(jcfg).apply({"params": p}, **b))(
        trees["rcnn"], {k: jnp.asarray(v) for k, v in batch.items()})
    model = flax_to_torch(trees["rcnn"], FastRCNN(tcfg)).eval()
    tb = {k: T(v) for k, v in batch.items()}
    with torch.inference_mode():
        got = model(tb["images"], tb["im_info"], proposals=tb["proposals"],
                    prop_valid=tb["prop_valid"])
    np.testing.assert_array_equal(got["rois"].numpy(), batch["proposals"])
    np.testing.assert_array_equal(got["roi_valid"].numpy(), np.asarray(ref["roi_valid"]))
    assert not got["roi_scores"].any()
    np.testing.assert_allclose(got["cls_prob"].numpy(), np.asarray(ref["cls_prob"]), atol=1e-4)
    np.testing.assert_allclose(got["bbox_deltas"].numpy(), np.asarray(ref["bbox_deltas"]),
                               atol=1e-3)
    from mx_rcnn_tpu_torch.ops import roi_align as troi

    feat = torch.randn(1, 8, 8, 4)
    rois = tb["proposals"][:, -3:-2]
    canvas = troi.roi_align_plain(feat, rois, (2, 2), 1.0 / 16, 2, None)
    valid = troi.roi_align_plain(feat, rois, (2, 2), 1.0 / 16, 2, tb["im_info"][:, :2])
    assert not torch.allclose(canvas, valid)


def test_stage_models_refuse_what_is_not_ported():
    """FastRCNN without the batch's proposals raises.  The VGG-16 stage
    graphs are ported: both build (on the meta device: fc6 is 411 MB) with
    VGG's widths."""
    tcfg = port_cfg(stage_cfg())
    vgg = tcfg.replace(network=dataclasses.replace(tcfg.network, name="vgg"))
    with torch.device("meta"):
        rpn, rcnn = RPNOnly(vgg), FastRCNN(vgg)
    assert rpn.rpn.rpn_conv.in_channels == 512 and not hasattr(rpn, "top_head")
    assert rcnn.rcnn.cls_score.in_features == 4096
    with pytest.raises(ValueError, match="proposals"):
        FastRCNN(tcfg)(torch.zeros(1, 128, 128, 3), torch.tensor([[128.0, 128.0, 1.0]]))


# --------------------------------------------------- one train step each
@functools.lru_cache(maxsize=None)
def _jax_step(kind):
    """JAX's loss, aux and gradients of one stage step from the stage tree,
    with its sampling key, and the draws its sampler takes."""
    jcfg = stage_cfg()
    tcfg = port_cfg(jcfg)
    trees = {"rpn": _tame_rpn(_perturb(torch_to_flax(RPNOnly(tcfg, torch.Generator().manual_seed(0))),
                                       np.random.RandomState(1))),
             "rcnn": _perturb(torch_to_flax(FastRCNN(tcfg, torch.Generator().manual_seed(0))),
                              np.random.RandomState(2))}
    params_np = trees[kind]
    batch = proposal_batch(np.random.RandomState(1))
    if kind == "rpn":
        batch = {k: v for k, v in batch.items() if k not in ("proposals", "prop_valid")}
    batch["sample_seeds"] = np.asarray([0], np.int32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = (JRPNOnly if kind == "rpn" else JFastRCNN)(jcfg)
    params = jax.tree.map(jnp.asarray, params_np)
    step_key = jax.random.fold_in(jax.random.key(7), 0)

    def loss_fn(p):
        return jmodel.apply({"params": p}, train=True, rngs={"sampling": step_key}, **jb)

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    key = jmodel.apply({"params": params}, method=lambda m: m.make_rng("sampling"),
                       rngs={"sampling": step_key})
    k0 = jax.random.fold_in(key, 0)
    if kind == "rpn":
        n = 8 * 8 * jcfg.network.NUM_ANCHORS
        u = [jax.random.uniform(k, (n,)) for k in jax.random.split(k0)]
        names = tsm.ANCHOR_DRAWS
    else:
        n = batch["proposals"].shape[1] + batch["gt_boxes"].shape[1]
        u = [jax.random.uniform(k, (n,)) for k in jax.random.split(k0, 3)]
        names = tsm.ROI_DRAWS
    draws = {name: T(np.asarray(x))[None] for name, x in zip(names, u)}
    return jcfg, tcfg, params_np, batch, float(loss), {k: float(v) for k, v in aux.items()}, \
        jax.tree.map(np.asarray, grads), draws


@pytest.fixture(scope="module", params=[("rpn", "FIXED_PARAMS"), ("rpn", "FIXED_PARAMS_SHARED"),
                                        ("rcnn", "FIXED_PARAMS"), ("rcnn", "FIXED_PARAMS_SHARED")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def stage_step(request):
    """One port step of a stage graph under a freeze set, with JAX's draws,
    beside JAX's loss, aux, gradients and optax update under that set."""
    kind, fixed_name = request.param
    jcfg, tcfg, params_np, batch, j_loss, j_aux, j_grads, draws = _jax_step(kind)
    fixed = getattr(jcfg.network, fixed_name)
    params = jax.tree.map(jnp.asarray, params_np)
    tx = j_make_optimizer(jcfg, j_make_lr_schedule(jcfg, 10), fixed_params=fixed)
    updates, _ = tx.update(jax.tree.map(jnp.asarray, j_grads), tx.init(params), params)
    j_new = jax.tree.map(np.asarray, optax.apply_updates(params, updates))

    model = flax_to_torch(params_np, (RPNOnly if kind == "rpn" else FastRCNN)(tcfg))
    pristine = copy.deepcopy(model)
    opt = ttrain.make_optimizer(tcfg, model, ttrain.make_lr_schedule(tcfg, 10), fixed_params=fixed)
    tb = {k: T(v) for k, v in batch.items() if k != "sample_seeds"}
    extra = {k: tb[k] for k in ("proposals", "prop_valid") if k in tb}
    opt.zero_grad()
    loss, aux = model(tb["images"], tb["im_info"], tb["gt_boxes"], tb["gt_valid"], train=True,
                      draws=draws, **extra)
    loss.backward()
    grads = grads_to_flax(model)
    opt.step()
    return dict(kind=kind, fixed=fixed, j_loss=j_loss, j_aux=j_aux, j_grads=j_grads,
                j_new=j_new, params_np=params_np, loss=float(loss.detach()),
                aux={k: float(v.detach()) for k, v in aux.items()}, grads=grads, model=model,
                pristine=pristine)


def test_stage_step_losses_and_aux_match(stage_step):
    """Losses and aux within 1e-4 relative; the counts equal and live."""
    s = stage_step
    assert set(s["aux"]) == set(s["j_aux"])
    np.testing.assert_allclose(s["loss"], s["j_loss"], rtol=1e-4)
    for k, v in s["aux"].items():
        np.testing.assert_allclose(v, s["j_aux"][k], rtol=1e-4, atol=1e-6, err_msg=k)
    count = "num_fg_anchors" if s["kind"] == "rpn" else "num_fg_rois"
    assert int(s["aux"][count]) == int(s["j_aux"][count]) > 0


def test_stage_step_gradients_match(stage_step):
    """Every trainable leaf's gradient within 2e-3 of the leaf's largest
    (and 1e-6 absolute); no gradient for a frozen leaf."""
    s = stage_step
    got = dict(_leaves(s["grads"]))
    ref = dict(_leaves(s["j_grads"]))
    trainable = {p for p in ref if not ttrain.is_frozen_path(p, s["fixed"])}
    assert set(got) == trainable and trainable
    for path in trainable:
        scale = float(np.abs(ref[path]).max())
        err = float(np.abs(got[path] - ref[path]).max())
        assert err <= 2e-3 * scale + 1e-6, ("/".join(path), err, scale)


def test_stage_step_updated_params_match(stage_step):
    """After one MXNet SGD step: trainable leaves within 1e-5 relative of
    JAX's, frozen leaves bitwise unmoved on both sides."""
    s = stage_step
    got = dict(_leaves(torch_to_flax(s["model"])))
    new = dict(_leaves(s["j_new"]))
    old = dict(_leaves(s["params_np"]))
    frozen = {p for p in new if ttrain.is_frozen_path(p, s["fixed"])}
    assert (("backbone", "stage3", "unit1", "conv1", "kernel") in frozen) == ("stage3" in s["fixed"])
    for path in new:
        if path in frozen:
            np.testing.assert_array_equal(new[path], old[path])
            np.testing.assert_array_equal(got[path], old[path])
        else:
            np.testing.assert_allclose(got[path], new[path], rtol=1e-5, atol=1e-7,
                                       err_msg="/".join(path))


# ----------------------------------------------- test_rpn and the combine
def test_test_rpn_dump_and_recall_match_jax(roidb, tmp_path):
    """``test_rpn`` on the same weights: per image the same number of
    proposals, boxes within 1e-3 px and scores within 1e-4 in original
    image coordinates, dumps of the same layout and equal recall (the
    TEST.PROPOSAL_* budgets: 200 → 64)."""
    jcfg = stage_cfg()
    tcfg = port_cfg(jcfg)
    tree = _tame_rpn(_perturb(torch_to_flax(RPNOnly(tcfg, torch.Generator().manual_seed(3))),
                              np.random.RandomState(3)))
    got, got_rec = test_rpn_cli.test_rpn(tcfg, roidb, tree, dump_path=str(tmp_path / "t.pkl"),
                                         device="cpu")
    ref, ref_rec = j_test_rpn(jcfg, roidb, jax.tree.map(jnp.asarray, tree),
                              dump_path=str(tmp_path / "j.pkl"))
    assert got_rec == ref_rec and set(got_rec) == {"recall@64"}
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype == np.float32
        assert 8 <= len(g) <= jcfg.TEST.PROPOSAL_POST_NMS_TOP_N
        np.testing.assert_allclose(g[:, :4], r[:, :4], atol=1e-3)
        np.testing.assert_allclose(g[:, 4], r[:, 4], atol=1e-4)
    # each package reads the other's dump into its proposal roidb
    for rec, r in zip(load_proposal_roidb(list(roidb), str(tmp_path / "j.pkl")), ref):
        np.testing.assert_array_equal(rec["proposals"], r[:, :4])
    for rec, g in zip(j_load_proposal_roidb(list(roidb), str(tmp_path / "t.pkl")), got):
        np.testing.assert_array_equal(rec["proposals"], g[:, :4])


def test_generate_proposals_batched_matches_one_at_a_time(roidb):
    tcfg = port_cfg(stage_cfg())
    model = flax_to_torch(_tame_rpn(torch_to_flax(RPNOnly(tcfg))), RPNOnly(tcfg))
    pred = Predictor(model, device="cpu")
    one = generate_proposals(pred, tloader.TestLoader(roidb, tcfg), tcfg)
    two = generate_proposals(pred, tloader.TestLoader(roidb, tcfg, batch_size=2), tcfg)
    for a, b in zip(one, two):
        np.testing.assert_allclose(a, b, atol=1e-3)


@pytest.fixture(scope="module")
def combined(stage_trees):
    jcfg, tcfg, trees, _ = stage_trees
    return jcfg, tcfg, combine_model(trees["rpn"], trees["rcnn"]), trees


def test_combine_model_is_jaxs(combined):
    """The combined tree is JAX's, subtree for subtree (the backbone the
    RPN's)."""
    _, _, final, trees = combined
    ref = j_combine_model(trees["rpn"], trees["rcnn"])
    assert set(final) == set(ref) == {"backbone", "rpn", "top_head", "rcnn"}
    for k in final:
        assert final[k] is ref[k]
    assert final["backbone"] is trees["rpn"]["backbone"]


def test_combined_tree_runs_through_both_packages(combined):
    """The combined tree loads into both FasterRCNNs, whose test forwards
    agree (the C4 test forward's bars)."""
    jcfg, tcfg, final, _ = combined
    images, im_info, _ = uint8_batch(np.random.RandomState(5))
    ref = jax.jit(lambda p, x, i: JFasterRCNN(jcfg).apply({"params": p}, x, i))(
        final, jnp.asarray(images), jnp.asarray(im_info))
    model = flax_to_torch(final, FasterRCNN(tcfg)).eval()
    with torch.inference_mode():
        got = model(T(images), T(im_info))
    tv, jv = got["roi_valid"].numpy(), np.asarray(ref["roi_valid"])
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 0
    np.testing.assert_allclose(got["rois"].numpy()[tv], np.asarray(ref["rois"])[jv], atol=1e-4)
    np.testing.assert_allclose(got["cls_prob"].numpy()[tv], np.asarray(ref["cls_prob"])[jv],
                               atol=1e-4)


# ------------------------------------------------------------ the tools
def _small(network, dataset):
    assert network == "resnet" and dataset == "PascalVOC"
    return port_cfg(stage_cfg())


@pytest.fixture(scope="module")
def alternate_run(roidb, tmp_path_factory):
    """``alternate_train`` at the tiny size on the CPU, two steps a stage,
    flipped copies on (TRAIN.FLIP), one torch thread (bitwise runs), from a
    seeded FasterRCNN tree with a tamed RPN as the donor of stages 1 and 3
    (the untamed random RPN's deltas clip every proposal below the minimum
    size on raw-pixel inputs, as in the JAX package)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = port_cfg(stage_cfg())
        cfg = cfg.replace(TRAIN=dataclasses.replace(cfg.TRAIN, FLIP=True))
        out_dir = tmp_path_factory.mktemp("alt")
        donor = _tame_rpn(torch_to_flax(FasterRCNN(cfg, torch.Generator().manual_seed(5))))
        final = alt_cli.alternate_train(cfg, list(roidb), epochs_rpn=1, epochs_rcnn=1,
                                        pretrained_donor=donor, max_steps=2,
                                        out_dir=str(out_dir), device="cpu")
    finally:
        torch.set_num_threads(threads)
    return cfg, out_dir, final


def test_alternate_train_writes_the_jax_artifacts(alternate_run):
    cfg, out_dir, final = alternate_run
    names = {"rpn1.pkl", "rcnn1.pkl", "rpn2.pkl", "rcnn2.pkl", "final.pkl", "proposals1.pkl",
             "proposals2.pkl", "run_meta.json"}
    assert names <= {p.name for p in out_dir.iterdir()}
    assert set(final) == {"backbone", "rpn", "top_head", "rcnn"}
    for name in ("proposals1.pkl", "proposals2.pkl"):
        props = load_params(str(out_dir / name))
        assert len(props) == 4 and all(p.dtype == np.float32 and p.shape[1] == 5 for p in props)
        if name == "proposals1.pkl":
            assert all(len(p) > 0 for p in props)
    meta = load_run_meta(str(out_dir / "final.pkl"))
    assert len(meta["BBOX_STDS_PER_CLASS"]) == cfg.dataset.NUM_CLASSES


def test_alternate_train_freezes_the_shared_convolutions(alternate_run):
    """Stage 4 keeps Fast R-CNN-1's FIXED_PARAMS_SHARED leaves and stage 5
    RPN-2's, bitwise; the final backbone is RPN-2's, and the heads moved."""
    cfg, out_dir, final = alternate_run
    trees = {n: load_params(str(out_dir / f"{n}.pkl")) for n in ("rpn1", "rcnn1", "rpn2", "rcnn2")}
    shared = cfg.network.FIXED_PARAMS_SHARED
    for stage, donor in (("rpn2", "rcnn1"), ("rcnn2", "rpn2")):
        got, ref = dict(_leaves(trees[stage]["backbone"])), dict(_leaves(trees[donor]["backbone"]))
        frozen = [p for p in got if ttrain.is_frozen_path(("backbone",) + p, shared)]
        assert len(frozen) == len(got)
        for p in frozen:
            np.testing.assert_array_equal(got[p], ref[p], err_msg=f"{stage} {'/'.join(p)}")
    for p, a in _leaves(final["backbone"]):
        np.testing.assert_array_equal(a, dict(_leaves(trees["rpn2"]["backbone"]))[p])
    rcnn_init = torch_to_flax(FastRCNN(cfg, torch.Generator().manual_seed(3)))
    assert not np.array_equal(final["rcnn"]["cls_score"]["kernel"],
                              rcnn_init["rcnn"]["cls_score"]["kernel"])
    assert not np.array_equal(trees["rpn1"]["backbone"]["stage2"]["unit1"]["conv1"]["kernel"],
                              trees["rcnn1"]["backbone"]["stage2"]["unit1"]["conv1"]["kernel"])


def test_alternate_final_loads_in_jax_and_evaluates_with_its_run_meta(alternate_run, monkeypatch):
    """JAX's ``load_params`` reads ``final.pkl`` (numpy leaves, the
    FasterRCNN tree); ``tools/test.py --params final.pkl`` applies the
    run_meta's per-class statistics and evaluates."""
    cfg, out_dir, _ = alternate_run
    tree = j_load_params(str(out_dir / "final.pkl"))
    shapes = jax.eval_shape(lambda: JFasterRCNN(stage_cfg()).init(
        jax.random.key(0), jnp.zeros((1, 128, 128, 3)), jnp.ones((1, 3))))["params"]
    ref = dict(_leaves(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))))
    got = dict(_leaves(tree))
    assert set(got) == set(ref) and all(type(tree["rcnn"][k]["kernel"]) is np.ndarray
                                        for k in tree["rcnn"])
    seen = {}
    real = test_cli.pred_eval

    def spy(predictor, loader, imdb, cfg_used, **kw):
        seen["cfg"] = cfg_used
        return real(predictor, loader, imdb, cfg_used, **kw)

    monkeypatch.setattr(test_cli, "generate_config", _small)
    monkeypatch.setattr(test_cli, "pred_eval", spy)
    results = test_cli.main(["--cpu", "1", "--synthetic", "2", "--params",
                             str(out_dir / "final.pkl")])
    meta = load_run_meta(str(out_dir))
    assert seen["cfg"].TRAIN.BBOX_STDS_PER_CLASS == tuple(tuple(r) for r in meta["BBOX_STDS_PER_CLASS"])
    assert seen["cfg"].TRAIN.BBOX_STDS_PER_CLASS != cfg.TRAIN.BBOX_STDS_PER_CLASS
    assert "mAP" in results and np.isfinite(results["mAP"])


def test_stage_cli_chain_on_the_cpu(monkeypatch, tmp_path, caplog):
    """``train_rpn`` → ``test_rpn`` → ``train_rcnn --proposals --init`` with
    ``--prefix`` under tmp_path, then ``tools/test.py --dump`` of the
    combined tree and ``reeval``, whose results equal JAX's ``reeval`` of
    the same dump; ``train_rpn --pretrained`` seeds the backbone from a
    torchvision checkpoint and records its pixel statistics;
    ``train_alternate --cpu 2`` trains on the CPU."""
    for mod in (train_rpn_cli, test_rpn_cli, train_rcnn_cli, test_cli, reeval_cli):
        monkeypatch.setattr(mod, "generate_config", _small)
    rpn, props, rcnn = (str(tmp_path / n) for n in ("rpn.pkl", "props.pkl", "rcnn.pkl"))
    common = ["--cpu", "1", "--synthetic", "3"]
    tree = train_rpn_cli.main(common + ["--epochs", "1", "--max_steps", "1", "--out", rpn,
                                        "--prefix", str(tmp_path / "p_rpn")])
    assert set(tree) == {"backbone", "rpn"} and load_run_meta(rpn) is not None
    proposals, recalls = test_rpn_cli.main(common + ["--params", rpn, "--dump", props])
    assert len(proposals) == 3 and set(recalls) == {"recall@64"}
    rcnn_tree, cfg_used = train_rcnn_cli.main(
        common + ["--proposals", props, "--init", rpn, "--epochs", "1", "--max_steps", "1",
                  "--out", rcnn, "--prefix", str(tmp_path / "p_rcnn"),
                  "--stream_log", str(tmp_path / "stream.log")])
    assert set(rcnn_tree) == {"backbone", "top_head", "rcnn"}
    assert cfg_used.TRAIN.BBOX_STDS_PER_CLASS is not None
    assert len((tmp_path / "stream.log").read_text().splitlines()) == 1
    for p, a in _leaves(rcnn_tree["backbone"]["conv0"]):
        np.testing.assert_array_equal(a, tree["backbone"]["conv0"][p[0]])
    final = tmp_path / "final" / "final.pkl"
    final.parent.mkdir()
    save_params(str(final), combine_model(tree, rcnn_tree))
    dets = str(tmp_path / "dets.pkl")
    test_cli.main(common + ["--params", str(final), "--dump", dets])
    got = reeval_cli.main(["--synthetic", "3", "--detections", dets])
    from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset

    jimdb = JSyntheticDataset(num_images=3, num_classes=4)
    assert got == j_reeval(jimdb, dets)
    sd = fake_resnet_sd(np.random.RandomState(0), 50)
    ckpt, rpn_pt = str(tmp_path / "r50.npz"), str(tmp_path / "rpn_pt.pkl")
    np.savez(ckpt, **sd)
    pt_tree = train_rpn_cli.main(common + ["--pretrained", ckpt, "--epochs", "1", "--max_steps",
                                           "1", "--out", rpn_pt])
    np.testing.assert_array_equal(pt_tree["backbone"]["conv0"]["kernel"],
                                  sd["conv1.weight"].transpose(2, 3, 1, 0))
    assert tuple(load_run_meta(rpn_pt)["PIXEL_MEANS"]) == torchvision_pixel_stats()[0]
    # --cpu N trains on the CPU at any N, as the JAX stage CLIs (no mesh)
    seen = {}
    monkeypatch.setattr(alt_cli, "generate_config", _small)
    monkeypatch.setattr(alt_cli, "alternate_train",
                        lambda cfg, roidb, **kw: seen.update(kw, n=len(roidb)) or {})
    alt_cli.main(["--cpu", "2", "--synthetic", "3", "--out_dir", str(tmp_path / "alt2")])
    assert seen["device"] == "cpu" and seen["n"] == 3
