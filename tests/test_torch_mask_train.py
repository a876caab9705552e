"""The PyTorch port's Mask R-CNN training slice on the CPU against the JAX
package, on the same numpy-seeded inputs and bridged weights: the flip of
polygon and RLE records (``append_flipped_images``) and their synthetic
render, the box-frame gt masks (``data/masks.py``) and the loader's
``gt_masks``, the device mask targets (``ops/mask_targets.py``), one mask
train step with JAX's sampling draws injected (with gt masks and with
rectangle targets: losses, aux, every gradient, the mask head's transposed
conv included, the updated parameters), ``mask_iou_probe``, the COCO reader
(``data/coco.py``) on an annotation fixture, and ``tools/train_end2end.py
--network mask_resnet_fpn`` on the CPU.

The model is ``tests/test_fpn.py::fpn_cfg`` (ResNet-50 FPN, a 128 × 128
canvas, 4 classes, 16 rois of which 4 are the mask branch's) with
``USE_MASK``."""

import copy
import dataclasses
import json
import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mx_rcnn_tpu.core.train import make_lr_schedule as j_make_lr_schedule
from mx_rcnn_tpu.core.train import make_optimizer as j_make_optimizer
from mx_rcnn_tpu.data import coco as jcoco
from mx_rcnn_tpu.data import loader as jloader
from mx_rcnn_tpu.data import masks as jmasks
from mx_rcnn_tpu.data import synthetic as jsynthetic
from mx_rcnn_tpu.data.imdb import IMDB as JIMDB
from mx_rcnn_tpu.models.fpn import FPNFasterRCNN as JFPNFasterRCNN
from mx_rcnn_tpu.ops import mask_targets as jmt
from mx_rcnn_tpu_torch.config import generate_config as t_generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.fit import batch_digest
from mx_rcnn_tpu_torch.core.pipeline import batch_to_device
from mx_rcnn_tpu_torch.data import coco as tcoco
from mx_rcnn_tpu_torch.data import loader as tloader
from mx_rcnn_tpu_torch.data import masks as tmasks
from mx_rcnn_tpu_torch.data import synthetic as tsynthetic
from mx_rcnn_tpu_torch.data.imdb import IMDB
from mx_rcnn_tpu_torch.models import build_model
from mx_rcnn_tpu_torch.models import faster_rcnn as tfr
from mx_rcnn_tpu_torch.models import fpn as tfpn
from mx_rcnn_tpu_torch.native import rle
from mx_rcnn_tpu_torch.ops import losses as tlosses
from mx_rcnn_tpu_torch.ops import mask_targets as tmt
from mx_rcnn_tpu_torch.utils import load_data
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, grads_to_flax, torch_to_flax
from tests.test_fpn import fpn_batch, fpn_cfg
from tests.test_torch_model import _perturb, _tame_rpn, port_cfg

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_same(a, b, where="record"):
    """Structural equality of roidb values: dicts key by key, lists and
    tuples item by item, arrays by dtype, shape and bytes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (where, type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes(), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def counts_to_string(cnts):
    """COCO's compressed RLE counts (pycocotools' ``rleToString``): 5-bit
    chunks with a continuation bit, each count after the second a delta
    from the one two before."""
    out = []
    for i, x in enumerate(cnts):
        x = int(x) - (int(cnts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def box_mask_rle(h, w, x1, y1, x2, y2):
    m = np.zeros((h, w), np.uint8)
    m[y1:y2 + 1, x1:x2 + 1] = 1
    return rle.encode(m)


# ------------------------------------------------------------- the flip
def mixed_records():
    """Two synthetic polygon records, a record with an RLE gt (list counts,
    compressed string counts and an ``hflip``-tagged one), a None gt and
    proposals, and a box-only record."""
    polys = tsynthetic.SyntheticDataset(num_images=2, num_classes=4, image_size=(128, 192),
                                        with_masks=True).gt_roidb()
    crowd = box_mask_rle(100, 90, 10, 20, 40, 60)
    text = {"size": [100, 90], "counts": counts_to_string(
        box_mask_rle(100, 90, 50, 5, 80, 30)["counts"])}
    mixed = {
        "image": "a.jpg", "height": 100, "width": 90, "flipped": False,
        "boxes": np.array([[10, 20, 40, 60], [50, 5, 80, 30], [0, 0, 89, 99], [49, 20, 79, 60]],
                          np.float32),
        "gt_classes": np.array([1, 2, 3, 1], np.int32),
        "segmentation": [crowd, text, None, {**crowd, "hflip": True}],
        "proposals": np.array([[1, 2, 30, 40], [60, 10, 88, 90]], np.float32),
    }
    plain = {"image": "b.jpg", "height": 50, "width": 70, "flipped": False,
             "boxes": np.array([[5, 6, 30, 40]], np.float32), "gt_classes": np.array([2], np.int32),
             "proposals": np.zeros((0, 4), np.float32)}
    return polys + [mixed, plain]


def test_append_flipped_images_matches_jax():
    """Record by record equal to JAX's: polygons flipped eagerly, RLE gts
    tagged ``hflip`` (a tagged one untagged), None kept, proposals flipped;
    the flipped gt masks mirror the originals."""
    recs = mixed_records()
    got = IMDB.append_flipped_images(copy.deepcopy(recs))
    ref = JIMDB.append_flipped_images(copy.deepcopy(recs))
    assert len(got) == len(ref) == 2 * len(recs)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert_same(g, r, f"record {i}")
    flipped = got[len(recs):]
    assert all(isinstance(p, np.ndarray) for p in flipped[0]["segmentation"][0])
    assert [s.get("hflip") for s in flipped[2]["segmentation"] if s] == [True, True, False]
    for orig, flip in zip(recs[:3], flipped[:3]):
        a = tmasks.record_gt_masks(orig, 4, 32)
        b = tmasks.record_gt_masks(flip, 4, 32)
        n = len(orig["boxes"])
        # the RLE path resizes by nearest sample, whose cell centres are not
        # mirror images of each other in the box frame
        exact = [j for j, s in enumerate(orig["segmentation"]) if not isinstance(s, dict)]
        np.testing.assert_array_equal(b[exact], a[exact][..., ::-1])
        assert b[:n].any(axis=(1, 2)).all()


def test_flipped_polygon_render_matches_jax():
    """The port's render of a flipped polygon record equals JAX's render of
    the same record bit for bit; before the repair the port's flipped record
    kept its unflipped polygons and painted them, clipped to the flipped
    boxes."""
    recs = tsynthetic.SyntheticDataset(num_images=2, num_classes=4, image_size=(128, 192),
                                       with_masks=True).gt_roidb()
    got = IMDB.append_flipped_images(recs)[2:]
    ref = JIMDB.append_flipped_images(copy.deepcopy(recs))[2:]
    for g, r in zip(got, ref):
        assert g["flipped"]
        im = tsynthetic.synthetic_image(g, g["synthetic_seed"])
        want = jsynthetic.synthetic_image(r, r["synthetic_seed"])
        assert im.tobytes() == want.tobytes()
        assert tloader.load_record_image(g).tobytes() == want.tobytes()


# ------------------------------------------------------------ gt masks
BOX = [10.0, 20.0, 73.0, 99.0]


def _mask_cases():
    from mx_rcnn_tpu_torch.data.synthetic import shape_polygon

    full = np.zeros((120, 100), np.uint8)
    full[30:90, 5:60] = 1
    full[50:70, 20:40] = 0
    enc = rle.encode(full)
    text = {"size": enc["size"], "counts": counts_to_string(enc["counts"])}
    crowd_box = [4.0, 25.0, 70.0, 95.0]
    return {
        "ellipse": ("frame", [shape_polygon("ellipse", BOX)], BOX, 64),
        "triangle": ("frame", [shape_polygon("triangle", BOX, t=0.3)], BOX, 28),
        "two polygons": ("frame", [shape_polygon("rect", [12, 22, 30, 50]),
                                   shape_polygon("ellipse", [40, 60, 70, 95])], BOX, 64),
        "degenerate": ("frame", [[10.0, 20.0, 30.0, 40.0]], BOX, 16),
        "rle crowd": ("frame", enc, crowd_box, 64),
        "rle string counts": ("frame", text, crowd_box, 48),
        "rle hflip": ("frame", {**enc, "hflip": True}, crowd_box, 64),
        "rle_to_bitmap": ("bitmap", text, None, None),
        "rle_to_bitmap hflip": ("bitmap", {**text, "hflip": True}, None, None),
    }


@pytest.mark.parametrize("case", list(_mask_cases()))
def test_box_frame_masks_match_jax(case):
    """``polygons_to_box_frame`` (polygons, the degenerate rectangle
    fallback, the RLE crowd path) and ``rle_to_bitmap`` (compressed counts,
    ``hflip``): bitwise equal."""
    kind, segm, box, m = _mask_cases()[case]
    if kind == "bitmap":
        got, ref = tmasks.rle_to_bitmap(segm), jmasks.rle_to_bitmap(segm)
    else:
        got = tmasks.polygons_to_box_frame(segm, box, m)
        ref = jmasks.polygons_to_box_frame(segm, box, m)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.mean() <= 1
    if case == "degenerate":
        assert got.all()


def test_record_gt_masks_and_flip_segmentations_match_jax():
    """``record_gt_masks`` (None gts → rectangle, more gts than slots, a
    box-only record → None) and ``flip_segmentations`` on every kind of
    gt: bitwise / structurally equal."""
    recs = mixed_records()
    for rec in recs:
        for max_gt, m in ((4, 32), (2, 64)):
            got, ref = tmasks.record_gt_masks(rec, max_gt, m), jmasks.record_gt_masks(rec, max_gt, m)
            if "segmentation" not in rec:
                assert got is None and ref is None
                continue
            np.testing.assert_array_equal(got, ref)
        if "segmentation" in rec:
            assert_same(tmasks.flip_segmentations(rec["segmentation"], rec["width"]),
                        jmasks.flip_segmentations(rec["segmentation"], rec["width"]))
    assert tmasks.record_gt_masks(recs[2], 4, 32)[2].all()        # the None gt
    assert tmasks.flip_segmentations(None, 10) is None


def mask_cfgs():
    """(port cfg, JAX cfg): ``fpn_cfg`` with the mask head."""
    jcfg = fpn_cfg()
    jcfg = jcfg.replace(network=dataclasses.replace(jcfg.network, USE_MASK=True))
    return port_cfg(jcfg), jcfg


def test_make_batch_gt_masks_match_jax():
    """``make_batch(with_masks=True)``'s ``gt_masks`` (n, MAX_GT_BOXES, 64,
    64) uint8 bitwise equal to JAX's, a box-only record's all ones; the
    boxes equal; a box network's batch has none."""
    cfg, jcfg = mask_cfgs()
    recs = mixed_records()
    recs = [recs[0], recs[1], dict(recs[-1], height=128, width=128)]
    images = [np.zeros((r["height"], r["width"], 3), np.float32) for r in recs]
    got = tloader.make_batch(recs, cfg, (128, 128), images=images, with_masks=True)
    ref = jloader.make_batch(recs, jcfg, (128, 128), images=images, with_masks=True)
    assert got["gt_masks"].shape == (3, 4, 64, 64) and got["gt_masks"].dtype == np.uint8
    np.testing.assert_array_equal(got["gt_masks"], ref["gt_masks"])
    np.testing.assert_array_equal(got["gt_boxes"], ref["gt_boxes"])
    assert got["gt_masks"][2].all()
    covered = got["gt_masks"][:2][got["gt_valid"][:2]].mean(axis=(1, 2))
    assert ((covered > 0.2) & (covered < 1.0)).any() and (covered > 0.2).all()
    assert "gt_masks" not in tloader.make_batch(recs, cfg, (128, 128), images=images)


@pytest.mark.parametrize("workers", [0, 1])
def test_train_loader_carries_gt_masks(workers):
    """A mask network's TrainLoader batches carry ``gt_masks``, from the
    consumer's thread and from an assembly process alike (the process
    builds the C RLE library or finds it built)."""
    cfg, _ = mask_cfgs()
    recs = tsynthetic.SyntheticDataset(num_images=2, num_classes=4, image_size=(128, 128),
                                       with_masks=True).gt_roidb()
    loader = tloader.TrainLoader(recs, cfg, batch_size=2, shuffle=False, prefetch=0,
                                 assembly_workers=workers)
    try:
        batch = next(iter(loader))
    finally:
        loader.close()
    ref = tloader.make_batch(recs, cfg, (128, 128), seeds=[0, 1], with_masks=True)
    assert batch["gt_masks"].shape == (2, 4, 64, 64)
    np.testing.assert_array_equal(batch["gt_masks"], ref["gt_masks"])


def test_feed_and_digest_carry_gt_masks():
    """``batch_to_device`` hands ``gt_masks`` on as a uint8 tensor and the
    batch digest covers its bytes."""
    cfg, _ = mask_cfgs()
    recs = tsynthetic.SyntheticDataset(num_images=1, num_classes=4, image_size=(128, 128),
                                       with_masks=True).gt_roidb()
    batch = tloader.make_batch(recs, cfg, (128, 128), seeds=[0], with_masks=True)
    placed = batch_to_device(batch, "cpu")
    assert placed["gt_masks"].dtype == torch.uint8
    np.testing.assert_array_equal(placed["gt_masks"].numpy(), batch["gt_masks"])
    other = dict(batch, gt_masks=batch["gt_masks"].copy())
    other["gt_masks"][0, 0, 0, 0] ^= 1
    assert batch_digest(other) != batch_digest(batch)


# ---------------------------------------------------------- mask targets
def _target_case(rng, r=40, m=64):
    """Rois around random gt boxes (jittered, shrunk, grown, degenerate,
    off the gt) and random blob bitmaps."""
    gt = np.zeros((r, 4), np.float32)
    x1, y1 = rng.uniform(0, 300, r), rng.uniform(0, 200, r)
    gt[:, 0], gt[:, 1] = x1, y1
    gt[:, 2], gt[:, 3] = x1 + rng.uniform(10, 200, r), y1 + rng.uniform(10, 150, r)
    gt = np.round(gt)
    rois = gt + rng.uniform(-30, 30, (r, 4)).astype(np.float32)
    rois[:4] = gt[:4]                                      # roi == gt box
    rois[4] = [gt[4, 0], gt[4, 1], gt[4, 0], gt[4, 1]]     # a single pixel
    rois[5] = [gt[5, 2] + 20, gt[5, 3] + 20, gt[5, 2] + 60, gt[5, 3] + 70]   # off the gt
    coarse = rng.rand(r, 8, 8) > 0.5
    masks = np.repeat(np.repeat(coarse, m // 8, 1), m // 8, 2).astype(np.uint8)
    return rois.astype(np.float32), gt.astype(np.float32), masks


def test_crop_resize_masks_matches_jax(rng):
    """Soft targets within 1e-6; the binarized targets equal except cells
    whose soft value lies within 1e-6 of 0.5 (counted and printed); the
    roi-equals-gt rows sample the bitmap exactly."""
    rois, gt, masks = _target_case(rng)
    got = tmt.crop_resize_masks(T(rois), T(gt), T(masks), 28).numpy()
    ref = np.asarray(jmt.crop_resize_masks(jnp.asarray(rois), jnp.asarray(gt),
                                           jnp.asarray(masks), 28))
    assert got.shape == ref.shape == (40, 28, 28)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    near = np.abs(ref - 0.5) <= 1e-6
    diff = (got >= 0.5) != (ref >= 0.5)
    print(f"crop_resize_masks: {int(diff.sum())} binarized cells differ, {int(near.sum())} "
          f"cells lie within 1e-6 of 0.5 (of {ref.size})")
    assert not (diff & ~near).any()
    assert 0.2 < (ref >= 0.5).mean() < 0.8 and not ref[5].any()
    # batched over images: the same numbers
    batched = tmt.crop_resize_masks(T(rois).reshape(2, 20, 4), T(gt).reshape(2, 20, 4),
                                    T(masks).reshape(2, 20, 64, 64), 28)
    np.testing.assert_array_equal(batched.reshape(40, 28, 28).numpy(), got)


def test_rasterize_box_masks_matches_jax(rng):
    """Equal except cells whose centre lies within 1e-4 px of a gt box edge
    (counted and printed)."""
    rois, gt, _ = _target_case(rng)
    got = tmt.rasterize_box_masks(T(rois), T(gt), 28).numpy()
    ref = np.asarray(jmt.rasterize_box_masks(jnp.asarray(rois), jnp.asarray(gt), 28))
    fr = (np.arange(28, dtype=np.float64) + 0.5) / 28
    w = np.maximum(rois[:, 2] - rois[:, 0] + 1.0, 1.0)
    h = np.maximum(rois[:, 3] - rois[:, 1] + 1.0, 1.0)
    cx = rois[:, 0, None] + fr * w[:, None] - 0.5
    cy = rois[:, 1, None] + fr * h[:, None] - 0.5
    near_x = (np.abs(cx - gt[:, 0, None]) < 1e-4) | (np.abs(cx - gt[:, 2, None]) < 1e-4)
    near_y = (np.abs(cy - gt[:, 1, None]) < 1e-4) | (np.abs(cy - gt[:, 3, None]) < 1e-4)
    near = near_y[:, :, None] | near_x[:, None, :]
    diff = got != ref
    print(f"rasterize_box_masks: {int(diff.sum())} cells differ, {int(near.sum())} cell "
          f"centres lie within 1e-4 px of a box edge (of {ref.size})")
    assert not (diff & ~near).any()
    assert ref[:4].mean() > 0.5 and not ref[5].any() and got.dtype == np.float32


def test_select_class_and_sigmoid_bce_match_jax(rng):
    """The mask loss's pieces: ``select_class`` exactly JAX's
    ``one_hot_select``; ``sigmoid_bce`` within 1e-6 of optax's form."""
    from mx_rcnn_tpu.models.fpn import optax_sigmoid_bce
    from mx_rcnn_tpu.ops.losses import one_hot_select

    x = (rng.randn(2, 3, 5, 5, 7) * 8).astype(np.float32)
    cls = rng.randint(0, 7, (2, 3)).astype(np.int32)
    got = tlosses.select_class(T(x), T(cls)[..., None, None]).numpy()
    ref = np.asarray(one_hot_select(jnp.asarray(x), jnp.asarray(cls)[..., None, None]))
    np.testing.assert_array_equal(got, ref)
    y = (rng.rand(2, 3, 5, 5) > 0.5).astype(np.float32)
    np.testing.assert_allclose(tlosses.sigmoid_bce(T(got), T(y)).numpy(),
                               np.asarray(optax_sigmoid_bce(jnp.asarray(ref), jnp.asarray(y))),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- one train step
def gt_masks_for(batch, m=64):
    """Box-frame bitmaps of an ellipse and a triangle in the batch's two gt
    boxes (``fpn_batch``), through JAX's rasterizer."""
    from mx_rcnn_tpu.data.synthetic import shape_polygon

    gt = np.asarray(batch["gt_boxes"])
    out = np.zeros(gt.shape[:2] + (m, m), np.uint8)
    for i in range(gt.shape[0]):
        for j, kind in enumerate(("ellipse", "triangle")):
            out[i, j] = jmasks.polygons_to_box_frame([shape_polygon(kind, gt[i, j])], gt[i, j], m)
    return out


@pytest.fixture(scope="module")
def mask_trees():
    """(JAX cfg, port cfg, the port model's Flax tree with perturbed BN and
    a tamed RPN, a port model holding it; copy the model, since building
    another draws its 50176-input ``fc1`` again)."""
    cfg, jcfg = mask_cfgs()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    assert isinstance(model, tfpn.FPNFasterRCNN) and hasattr(model, "mask_head")
    params_np = _tame_rpn(_perturb(torch_to_flax(model), np.random.RandomState(1)))
    return jcfg, cfg, params_np, flax_to_torch(params_np, model)


def _anchor_count(cfg, h, w):
    net = cfg.network
    per_cell = len(net.ANCHOR_RATIOS) * len(net.FPN_ANCHOR_SCALES)
    return sum(-(-h // s) * -(-w // s) for s in net.FPN_FEAT_STRIDES) * per_cell


@pytest.fixture(scope="module", params=["gt_masks", "rectangles"])
def mask_step(request, mask_trees):
    """One JAX mask train step (value_and_grad, then its optax update) and
    one port step from the same weights and batch, with the JAX step's
    sampling draws injected into the port; with the batch's gt masks, or
    without them (rectangle targets)."""
    jcfg, tcfg, params_np, model = mask_trees
    batch = fpn_batch(np.random.RandomState(1))
    batch["sample_seeds"] = jnp.asarray([0], jnp.int32)
    if request.param == "gt_masks":
        batch["gt_masks"] = jnp.asarray(gt_masks_for(batch))
    jmodel = JFPNFasterRCNN(jcfg)
    params = jax.tree.map(jnp.asarray, params_np)
    step_key = jax.random.fold_in(jax.random.key(7), 0)

    def loss_fn(p):
        return jmodel.apply({"params": p}, train=True, rngs={"sampling": step_key}, **batch)

    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = j_make_optimizer(jcfg, j_make_lr_schedule(jcfg, 10))
    j_new = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        j_grads, params)

    # the draws train_forward makes: its key, split per image seed, then
    # per sampler (tests/test_torch_fpn.py::fpn_step)
    key = jmodel.apply({"params": params}, method=lambda m: m.make_rng("sampling"),
                       rngs={"sampling": step_key})
    t = jcfg.TRAIN
    n_anchors = _anchor_count(jcfg, 128, 128)
    n_cand = t.RPN_POST_NMS_TOP_N + batch["gt_boxes"].shape[1]
    k_anchor, k_roi = jax.random.split(jax.random.fold_in(key, 0), 2)
    u = [jax.random.uniform(k, (n_anchors,)) for k in jax.random.split(k_anchor)]
    u += [jax.random.uniform(k, (n_cand,)) for k in jax.random.split(k_roi, 3)]
    draws = {name: T(np.asarray(x))[None] for name, x in zip(tfr.DRAW_NAMES, u)}

    model = copy.deepcopy(model)
    tb = {k: T(v) for k, v in batch.items() if k != "sample_seeds"}
    pristine = copy.deepcopy(model)
    captured = {}
    orig = tfpn.sample_rois
    tfpn.sample_rois = lambda *a, **k: captured.setdefault("rois", orig(*a, **k))
    try:
        opt = ttrain.make_optimizer(tcfg, model, ttrain.make_lr_schedule(tcfg, 10))
        opt.zero_grad()
        t_loss, t_aux = model(tb["images"], tb["im_info"], tb["gt_boxes"], tb["gt_valid"],
                              train=True, draws=draws, gt_masks=tb.get("gt_masks"))
        t_loss.backward()
        t_grads = grads_to_flax(model)
        opt.step()
    finally:
        tfpn.sample_rois = orig
    return {
        "kind": request.param,
        "jax": dict(loss=j_loss, aux=j_aux, grads=j_grads, params=params, new_params=j_new),
        "port": dict(loss=t_loss.detach(), aux={k: v.detach() for k, v in t_aux.items()},
                     grads=t_grads, model=model, pristine=pristine, cfg=tcfg,
                     samples=captured["rois"]),
    }


def test_mask_step_losses_and_aux_match(mask_step):
    """``MaskBCELoss``, the total loss and every aux within 1e-4 relative;
    the counts equal; the mask branch saw fg rois."""
    j, p = mask_step["jax"], mask_step["port"]
    assert set(p["aux"]) == set(j["aux"]) and "MaskBCELoss" in p["aux"]
    np.testing.assert_allclose(float(p["loss"]), float(j["loss"]), rtol=1e-4)
    for k, v in p["aux"].items():
        np.testing.assert_allclose(float(v), float(j["aux"][k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("num_fg_rois", "num_valid_props", "num_fg_anchors"):
        assert int(p["aux"][k]) == int(j["aux"][k])
    nfg = int(round(p["cfg"].TRAIN.FG_FRACTION * p["cfg"].TRAIN.BATCH_ROIS))
    assert 0 < int((p["samples"].labels[:, :nfg] > 0).sum()) <= nfg
    assert float(p["aux"]["MaskBCELoss"]) > 0


def test_mask_step_gradients_match(mask_step):
    """Every trainable leaf's gradient within 2e-3 of the leaf's largest
    (and 1e-6 absolute), the FPN step's bar, the mask head's included: its
    transposed conv's gradient through ``grads_to_flax``'s spatial flip."""
    j, p = mask_step["jax"], mask_step["port"]
    got = dict(_leaves(p["grads"]))
    ref = dict(_leaves(jax.tree.map(np.asarray, j["grads"])))
    trainable = {path for path in ref
                 if not ttrain.is_frozen_path(path, p["cfg"].network.FIXED_PARAMS)}
    assert set(got) == trainable
    assert {path[0] for path in got} == {"backbone", "neck", "rpn", "top_head", "rcnn",
                                         "mask_head"}
    assert ("mask_head", "mask_deconv", "kernel") in got
    for path in trainable:
        scale = float(np.abs(ref[path]).max())
        err = float(np.abs(got[path] - ref[path]).max())
        assert err <= 2e-3 * scale + 1e-6, ("/".join(path), err, scale)
    deconv = ref[("mask_head", "mask_deconv", "kernel")]
    assert np.abs(deconv - deconv[::-1, ::-1]).max() > 0.1 * np.abs(deconv).max()


def test_mask_step_updated_params_match(mask_step):
    """After one MXNet SGD step: trainable leaves within 1e-5 relative of
    JAX's, frozen leaves unchanged on both sides, every mask head kernel
    moved."""
    j, p = mask_step["jax"], mask_step["port"]
    got = dict(_leaves(torch_to_flax(p["model"])))
    new = dict(_leaves(jax.tree.map(np.asarray, j["new_params"])))
    old = dict(_leaves(jax.tree.map(np.asarray, j["params"])))
    pristine = dict(_leaves(torch_to_flax(p["pristine"])))
    frozen = {path for path in new if ttrain.is_frozen_path(path, p["cfg"].network.FIXED_PARAMS)}
    for path in new:
        if path in frozen:
            np.testing.assert_array_equal(new[path], old[path])
            np.testing.assert_array_equal(got[path], pristine[path])
        else:
            np.testing.assert_allclose(got[path], new[path], rtol=1e-5, atol=1e-7,
                                       err_msg="/".join(path))
    assert all(not np.array_equal(got[path], pristine[path])
               for path in new if path[0] == "mask_head" and path[-1] == "kernel")


def test_mask_iou_probe_matches_jax(mask_trees):
    """IoU of the masks predicted at the gt boxes against the resampled gt
    bitmaps: equal to JAX's; ``gt_valid`` passed through."""
    jcfg, tcfg, params_np, model = mask_trees
    batch = fpn_batch(np.random.RandomState(2))
    masks = gt_masks_for(batch)
    jmodel = JFPNFasterRCNN(jcfg)
    ref_iou, ref_valid = jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, method=JFPNFasterRCNN.mask_iou_probe))(
        params_np, batch["images"], batch["im_info"], batch["gt_boxes"], batch["gt_valid"],
        jnp.asarray(masks))
    iou, valid = model.mask_iou_probe(T(batch["images"]), T(batch["im_info"]),
                                      T(batch["gt_boxes"]), T(batch["gt_valid"]), T(masks))
    assert iou.shape == (1, 4) and iou.dtype == torch.float32
    np.testing.assert_allclose(iou.numpy(), np.asarray(ref_iou), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert (iou.numpy()[0, :2] > 0).all()


# ---------------------------------------------------------- the COCO reader
def write_coco(root, malformed=True):
    """``annotations/instances_val2017.json`` under ``root``: three images
    (one without annotations), non-contiguous category ids, polygon gts
    (one of two parts, one past the image edge), RLE gts (list and
    compressed string counts), an RLE crowd and a polygon crowd, a
    zero-area and a sub-pixel box, and a malformed and an empty
    segmentation (polygons instead without ``malformed``: the segm protocol
    rasterizes every gt's segmentation)."""
    (root / "annotations").mkdir()
    h1, w1, h2, w2 = 120, 160, 100, 90
    crowd = box_mask_rle(h1, w1, 60, 70, 100, 110)
    rle_gt = box_mask_rle(h2, w2, 40, 50, 80, 90)
    text_gt = box_mask_rle(h1, w1, 5, 80, 45, 115)
    anns = [
        dict(id=1, image_id=5, category_id=1, bbox=[10.5, 20.0, 40.0, 30.0], area=1200.0,
             iscrowd=0, segmentation=[[10.5, 20, 50.5, 20, 50.5, 50, 10.5, 50]]),
        dict(id=2, image_id=5, category_id=3, bbox=[100.0, 60.0, 80.0, 70.0], area=2000.0,
             iscrowd=0, segmentation=[[100, 60, 159, 60, 159, 119], [120, 100, 150, 100, 140, 80]]),
        dict(id=3, image_id=5, category_id=7, bbox=[60.0, 70.0, 41.0, 41.0], area=1681.0,
             iscrowd=1, segmentation=crowd),
        dict(id=4, image_id=5, category_id=7, bbox=[5.0, 80.0, 41.0, 36.0], area=1476.0,
             iscrowd=0, segmentation={"size": text_gt["size"],
                                      "counts": counts_to_string(text_gt["counts"])}),
        dict(id=5, image_id=2, category_id=1, bbox=[5.0, 5.0, 20.0, 30.0], area=600.0,
             iscrowd=0, segmentation="garbage" if malformed else [[5, 5, 25, 5, 15, 35]]),
        dict(id=6, image_id=2, category_id=3, bbox=[30.0, 10.0, 20.0, 20.0], area=400.0,
             iscrowd=0, segmentation=[] if malformed else [[30, 10, 50, 10, 50, 30]]),
        dict(id=7, image_id=2, category_id=7, bbox=[10.0, 60.0, 10.0, 10.0], area=0.0,
             iscrowd=0, segmentation=[[10, 60, 20, 60, 20, 70]]),
        dict(id=8, image_id=2, category_id=1, bbox=[60.0, 5.0, 0.5, 10.0], area=5.0, iscrowd=0,
             segmentation=[[60, 5, 60.5, 5, 60.5, 15]]),
        dict(id=9, image_id=2, category_id=3, bbox=[40.0, 50.0, 41.0, 41.0], area=1681.0,
             iscrowd=0, segmentation=rle_gt),
        dict(id=10, image_id=2, category_id=7, bbox=[0.0, 0.0, 30.0, 30.0], area=900.0,
             iscrowd=1, segmentation=[[0, 0, 30, 0, 30, 30, 0, 30]]),
    ]
    data = {
        "images": [dict(id=5, file_name="000005.jpg", height=h1, width=w1),
                   dict(id=2, file_name="000002.jpg", height=h2, width=w2),
                   dict(id=9, file_name="000009.jpg", height=80, width=80)],
        "categories": [dict(id=7, name="cat"), dict(id=1, name="person"), dict(id=3, name="car")],
        "annotations": anns,
    }
    (root / "annotations" / "instances_val2017.json").write_text(json.dumps(data))
    return root


@pytest.fixture(scope="module")
def coco_tree(tmp_path_factory):
    return write_coco(tmp_path_factory.mktemp("coco"))


def _coco_pair(coco_tree, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    return (tcoco.COCO("val2017", str(tmp_path / "port"), str(coco_tree)),
            jcoco.COCO("val2017", str(tmp_path / "jax"), str(coco_tree)))


def test_coco_gt_roidb_matches_jax(coco_tree, tmp_path):
    """The roidb equal to JAX's record by record (crowds out, xywh →
    clipped x1y1x2y2, malformed and empty segmentations None, the
    zero-area box dropped), read again from the pickle cache, and the
    flipped roidb equal too."""
    port, ref = _coco_pair(coco_tree, tmp_path)
    assert port.classes == ref.classes == ["__background__", "person", "car", "cat"]
    assert port.image_set_index == ref.image_set_index == [2, 5, 9]
    got, want = port.gt_roidb(), ref.gt_roidb()
    assert_same(got, want)
    assert [len(r["boxes"]) for r in got] == [4, 3, 0]
    assert got[0]["segmentation"][:2] == [None, None]
    assert got[1]["boxes"][1].tolist() == [100.0, 60.0, 159.0, 119.0]
    assert (tmp_path / "port" / "cache" / "coco_val2017_gt_roidb.pkl").exists()
    assert_same(tcoco.COCO("val2017", str(tmp_path / "port"), str(coco_tree)).gt_roidb(), want)
    assert_same(IMDB.append_flipped_images(got), JIMDB.append_flipped_images(want))
    assert got[1]["image"].endswith("val2017/000005.jpg")
    # the fixture writes no image files: the decoder's read names the file, as JAX's
    with pytest.raises(FileNotFoundError, match="000005.jpg"):
        tloader.load_record_image(got[1])


def test_coco_evaluate_detections_matches_jax(tmp_path):
    """Box and segm statistics equal to JAX's within 1e-6 on the same
    detections and RLEs: jittered gts, a duplicate, false positives, a
    detection on the crowd; ``save_json`` writes every result."""
    tree = tmp_path / "tree"
    tree.mkdir()
    port, ref = _coco_pair(write_coco(tree, malformed=False), tmp_path)
    rng = np.random.RandomState(3)
    n_img = len(port.image_set_index)
    dets = [[np.zeros((0, 5), np.float32) for _ in range(n_img)] for _ in range(4)]
    masks = [[[] for _ in range(n_img)] for _ in range(4)]
    for i, rec in enumerate(port.gt_roidb()):
        h, w = rec["height"], rec["width"]
        extra = [([60, 70, 100, 110], 3), ([2, 2, 30, 30], 1), ([10, 10, 50, 60], 2)]
        boxes = [(b.tolist(), int(c)) for b, c in zip(rec["boxes"], rec["gt_classes"])]
        for box, cls in boxes + boxes[:1] + extra:
            b = np.clip(np.asarray(box, np.float32) + rng.uniform(-3, 3, 4), 0,
                        [w - 1, h - 1, w - 1, h - 1])
            if b[2] < b[0] or b[3] < b[1]:
                continue
            dets[cls][i] = np.vstack([dets[cls][i], [*b, rng.uniform(0.05, 1.0)]]).astype(np.float32)
            masks[cls][i].append(box_mask_rle(h, w, *(int(v) for v in b)))
    json_path = tmp_path / "results.json"
    got = port.evaluate_detections(dets, save_json=str(json_path), all_masks=masks)
    want = ref.evaluate_detections(dets, all_masks=masks)
    assert set(got) == set(want) and len(got) == 24
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
    assert 0 < got["AP"] < 1 and 0 < got["segm_AP"] < 1
    assert len(json.loads(json_path.read_text())) == sum(len(d) for c in dets for d in c)


def test_load_gt_roidb_reads_coco(coco_tree, tmp_path):
    """``get_imdb`` of a COCO config gives the reader; ``load_gt_roidb``
    flips its records and drops the image without gts."""
    cfg = t_generate_config("mask_resnet_fpn", "coco")
    cfg = cfg.replace(dataset=dataclasses.replace(cfg.dataset, root_path=str(tmp_path),
                                                  dataset_path=str(coco_tree)))
    (imdb,) = load_data.get_imdb(cfg, "val2017")
    assert isinstance(imdb, tcoco.COCO) and imdb.num_classes == 4
    _, roidb = load_data.load_gt_roidb(cfg, "val2017", flip=True)
    assert len(roidb) == 4 and [r["flipped"] for r in roidb] == [False, False, True, True]


# ---------------------------------------------------------------- the CLI
def small_mask_cfg(network, dataset):
    """``generate_config`` of the mask network at CPU size: ResNet-50
    depth, a 96 × 128 canvas, few proposals and rois."""
    cfg = t_generate_config(network, dataset)
    assert network == "mask_resnet_fpn" and dataset == "coco" and cfg.network.USE_MASK
    return cfg.replace(
        network=dataclasses.replace(cfg.network, depth=50),
        dataset=dataclasses.replace(cfg.dataset, SCALES=((96, 128),)),
        SHAPE_BUCKETS=((96, 128), (128, 96)),
        TRAIN=dataclasses.replace(cfg.TRAIN, RPN_PRE_NMS_TOP_N=400, RPN_POST_NMS_TOP_N=32,
                                  BATCH_ROIS=16, RPN_BATCH_SIZE=32))


def test_cli_trains_the_mask_network_on_the_cpu(monkeypatch, tmp_path):
    """``--network mask_resnet_fpn --dataset coco --synthetic 2`` trains one
    step through ``fit`` on polygon records and their flipped copies, its
    batches carrying ``gt_masks``; every loss finite, ``MaskBCELoss``
    among them."""
    from mx_rcnn_tpu_torch.tools import train_end2end as cli

    seen = []
    orig = ttrain.train_step

    def spy(state, batch, *a, **k):
        seen.append(tuple(batch["gt_masks"].shape))
        return orig(state, batch, *a, **k)

    monkeypatch.setattr(cli, "generate_config", small_mask_cfg)
    monkeypatch.setattr("mx_rcnn_tpu_torch.core.fit.train_step", spy)
    out = cli.main(["--network", "mask_resnet_fpn", "--dataset", "coco", "--cpu", "1",
                    "--synthetic", "2", "--max_steps", "1", "--prefix", str(tmp_path / "e2e")])
    assert out["steps"] == 1 and seen == [(1, 100, 64, 64)]
    hist = out["history"][0]
    assert "MaskBCELoss" in hist and hist["MaskBCELoss"] > 0
    assert all(math.isfinite(v) for v in hist.values())


def test_cli_on_coco_reaches_the_reader_then_the_decoder(monkeypatch, coco_tree, tmp_path):
    """Without ``--synthetic`` the CLI reads the COCO annotations and stops
    at the first image, which the decoder refuses: the tree's files are
    PNGs, which the port does not read."""
    import shutil

    from mx_rcnn_tpu_torch.tools import train_end2end as cli

    tree = tmp_path / "coco"
    shutil.copytree(coco_tree, tree)
    (tree / "val2017").mkdir()
    for name in ("000002.jpg", "000005.jpg", "000009.jpg"):
        (tree / "val2017" / name).write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(16))

    def on_fixture(network, dataset):
        cfg = small_mask_cfg(network, dataset)
        return cfg.replace(dataset=dataclasses.replace(
            cfg.dataset, root_path=str(tmp_path), dataset_path=str(tree),
            image_set="val2017"))

    monkeypatch.setattr(cli, "generate_config", on_fixture)
    with pytest.raises(NotImplementedError, match="PNG file.*item 7"):
        cli.main(["--network", "mask_resnet_fpn", "--dataset", "coco", "--cpu", "1",
                  "--max_steps", "1", "--prefix", str(tmp_path / "e2e")])
    assert (tmp_path / "cache" / "coco_val2017_gt_roidb.pkl").exists()
    with open(tmp_path / "cache" / "coco_val2017_gt_roidb.pkl", "rb") as f:
        assert len(pickle.load(f)) == 3
