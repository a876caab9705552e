"""The PyTorch port's eval loop on the CPU against the JAX package:
``im_detect``, ``cap_detections`` and the host branch of
``detections_from_output`` bit for bit on ``tests/test_postprocess.py``'s
fake head outputs, the device branch against the host branch at that file's
bars, and ``pred_eval`` on ``tests/test_model.py::tiny_cfg`` with bridged
weights against JAX's ``pred_eval`` on the same 5 synthetic images (same
keep counts, scores within 1e-5, boxes within 1e-3 px, mAP within 1e-6),
then the port's loop settings against each other."""

import dataclasses
import functools
import pickle

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core.tester import Predictor as JPredictor
from mx_rcnn_tpu.core.tester import im_detect as j_im_detect
from mx_rcnn_tpu.core.tester import pred_eval as j_pred_eval
from mx_rcnn_tpu.data import loader as jloader
from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from mx_rcnn_tpu.models import FasterRCNN as JFasterRCNN
from mx_rcnn_tpu.serve.runner import cap_detections as j_cap_detections
from mx_rcnn_tpu.serve.runner import detections_from_output as j_detections_from_output
from mx_rcnn_tpu_torch.core import tester
from mx_rcnn_tpu_torch.core.tester import Predictor, fetch_outputs, im_detect, pred_eval
from mx_rcnn_tpu_torch.data import loader as tloader
from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from mx_rcnn_tpu_torch.eval.voc_eval import voc_eval
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess
from mx_rcnn_tpu_torch.serve.runner import cap_detections, detect_single, detections_from_output
from mx_rcnn_tpu_torch.tools.demo import demo_net
from mx_rcnn_tpu_torch.utils.bridge import flax_to_torch, torch_to_flax
from tests.test_model import tiny_cfg
from tests.test_postprocess import _fake_outputs
from tests.test_torch_model import _perturb, _tame_rpn, port_cfg

torch.set_num_threads(2)

K = 5


def _fake(seed):
    out, im_info = _fake_outputs(np.random.RandomState(seed), k=K)
    orig_hw = np.floor(im_info[:, :2] / im_info[:, 2:3]).astype(np.float32)
    return out, im_info, orig_hw


def _cfg():
    jcfg = j_generate_config("resnet50", "PascalVOC")
    jcfg = jcfg.replace(TEST=dataclasses.replace(jcfg.TEST, MAX_PER_IMAGE=10))
    return jcfg, port_cfg(jcfg)


# ------------------------------------------------------------- host decode
@pytest.mark.parametrize("seed", [0, 1])
def test_im_detect_bit_identical(seed):
    out, im_info, orig_hw = _fake(seed)
    for b in range(2):
        got = im_detect(out, im_info[b], tuple(orig_hw[b]), index=b)
        ref = j_im_detect(out, im_info[b], tuple(orig_hw[b]), index=b)
        assert set(got) == set(ref) == {"scores", "boxes"}
        for key in ref:
            assert got[key].tobytes() == np.asarray(ref[key]).tobytes(), key
    # a mask model's outputs: the sigmoid of the valid rois' logits too
    masked = dict(out, mask_logits=np.random.RandomState(seed).randn(2, 64, 3, 3, K)
                  .astype(np.float32) * 3)
    got = im_detect(masked, im_info[1], tuple(orig_hw[1]), index=1)
    ref = j_im_detect(masked, im_info[1], tuple(orig_hw[1]), index=1)
    assert set(got) == set(ref) == {"scores", "boxes", "mask_probs"}
    assert got["mask_probs"].tobytes() == ref["mask_probs"].tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_branch_and_cap_bit_identical(seed):
    """Raw head outputs → host decode, threshold and C NMS → cap: the same
    arrays, bit for bit, as JAX's."""
    jcfg, cfg = _cfg()
    out, im_info, orig_hw = _fake(seed)
    for b in range(2):
        got, masks = detections_from_output(out, im_info[b], tuple(orig_hw[b]), cfg, K,
                                            index=b, thresh=0.05)
        ref, _ = j_detections_from_output(out, im_info[b], tuple(orig_hw[b]), jcfg, K,
                                          index=b, thresh=0.05)
        assert got[0] is None and masks is None
        assert sum(len(d) for d in got[1:]) > cfg.TEST.MAX_PER_IMAGE
        for j in range(1, K):
            assert got[j].tobytes() == ref[j].tobytes(), f"image {b} class {j}"
        got, _ = cap_detections(got, cfg.TEST.MAX_PER_IMAGE)
        ref, _ = j_cap_detections(ref, jcfg.TEST.MAX_PER_IMAGE)
        assert sum(len(d) for d in got[1:]) == cfg.TEST.MAX_PER_IMAGE
        for j in range(1, K):
            assert got[j].tobytes() == ref[j].tobytes(), f"image {b} class {j} capped"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_branch_matches_host_branch(seed):
    """The device postprocess (decode + batched NMS in torch) keeps the
    host loop's sets: scores rtol 1e-5, boxes rtol 1e-4 / atol 1e-3
    (``tests/test_postprocess.py``'s bars); ``with_rows`` gives each kept
    row's det-grid slot."""
    _, cfg = _cfg()
    out, im_info, orig_hw = _fake(seed)
    dev = make_test_postprocess(cfg, K, 0.05, max_out=32)(
        {k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(im_info),
        torch.from_numpy(orig_hw))
    dev = fetch_outputs(dev)
    for b in range(2):
        d_dets, _, rows = detections_from_output(dev, im_info[b], tuple(orig_hw[b]), cfg, K,
                                                 index=b, with_rows=True)
        h_dets, _ = detections_from_output(out, im_info[b], tuple(orig_hw[b]), cfg, K,
                                           index=b, thresh=0.05)
        for j in range(1, K):
            np.testing.assert_array_equal(rows[j], np.where(dev["det_valid"][b][j - 1])[0])
            d, h = d_dets[j], h_dets[j]
            assert len(d) == len(h), f"image {b} class {j}"
            d, h = d[np.argsort(-d[:, 4], kind="stable")], h[np.argsort(-h[:, 4], kind="stable")]
            np.testing.assert_allclose(d[:, 4], h[:, 4], rtol=1e-5)
            np.testing.assert_allclose(d[:, :4], h[:, :4], rtol=1e-4, atol=1e-3)


def test_fetch_outputs_keeps_dtypes_and_shapes():
    out = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": torch.tensor([True, False]),
           "c": torch.tensor([[7, -8]]), "d": torch.zeros((0, 4))}
    got = fetch_outputs(out)
    for k, v in out.items():
        assert got[k].dtype == v.numpy().dtype and got[k].shape == tuple(v.shape)
        np.testing.assert_array_equal(got[k], v.numpy())
    assert fetch_outputs({}) == {}


# ----------------------------------------------------------- pred_eval
def _eval_cfgs():
    """``tiny_cfg`` adapted as ``tests/test_eval.py``'s batched pred_eval
    test adapts it: one 128 × 128 bucket, 4 classes, threshold 0."""
    jcfg = tiny_cfg()
    jcfg = jcfg.replace(
        SHAPE_BUCKETS=((128, 128),),
        TEST=dataclasses.replace(jcfg.TEST, SCORE_THRESH=0.0),
        dataset=dataclasses.replace(jcfg.dataset, NUM_CLASSES=4, SCALES=((128, 128),),
                                    MAX_GT_BOXES=8),
    )
    return jcfg, port_cfg(jcfg)


def _dataset(cls):
    return cls(num_images=5, num_classes=4, image_size=(128, 128), max_boxes=2)


@pytest.fixture(scope="module")
def bridged_eval():
    """(JAX cfg, port cfg, Flax params, port model): seeded port weights
    with perturbed BN and biases and a tamed RPN, the same on both sides."""
    jcfg, cfg = _eval_cfgs()
    model = FasterRCNN(cfg, torch.Generator().manual_seed(0))
    params_np = _tame_rpn(_perturb(torch_to_flax(model), np.random.RandomState(1)))
    return jcfg, cfg, params_np, flax_to_torch(params_np, model).eval()


@pytest.fixture(scope="module")
def runs(bridged_eval, tmp_path_factory):
    """JAX's pred_eval and the port's in five settings on the same 5
    images: batch 1 with the CPU defaults (async, feed depth 2, device
    postprocess, dump), batch 2 with 2 completion threads, the threads
    mode, feed depth 0, and the host branch with 2 completion threads."""
    jcfg, cfg, params_np, model = bridged_eval
    roidb = _dataset(SyntheticDataset).gt_roidb()
    imdb = _dataset(SyntheticDataset)
    jimdb = _dataset(JSyntheticDataset)
    out = {}
    # the JAX render LRU keys renders without their size: start without
    # another file's renders, and drop this file's
    jloader._RENDER_CACHE.clear()
    try:
        out["jax"] = j_pred_eval(JPredictor(JFasterRCNN(jcfg), params_np),
                                 jloader.TestLoader(roidb, jcfg), jimdb, jcfg)
    finally:
        jloader._RENDER_CACHE.clear()
    dump = str(tmp_path_factory.mktemp("eval") / "all_boxes.pkl")
    pred = Predictor(model, device="cpu")
    stats = {}
    out["port"] = pred_eval(pred, tloader.TestLoader(roidb, cfg), imdb, cfg, dump_path=dump,
                            stats_out=stats)
    out["stats"], out["dump"] = stats, dump
    out["batch 2"] = pred_eval(pred, tloader.TestLoader(roidb, cfg, batch_size=2), imdb, cfg,
                               postprocess_workers=2)
    orig = tester.pipelined
    for label, knobs in (("threads", {"mode": "threads"}), ("feed 0", {"feed_depth": 0})):
        tester.pipelined = functools.partial(orig, **knobs)
        try:
            out[label] = pred_eval(pred, tloader.TestLoader(roidb, cfg), imdb, cfg)
        finally:
            tester.pipelined = orig
    host = cfg.replace(TEST=dataclasses.replace(cfg.TEST, DEVICE_POSTPROCESS=False))
    out["host"] = pred_eval(pred, tloader.TestLoader(roidb, host), imdb, host,
                            postprocess_workers=2)
    return out


def test_pred_eval_matches_jax(runs):
    (got, results), (ref, ref_results) = runs["port"], runs["jax"]
    kept = 0
    for j in range(1, 4):
        for i in range(5):
            g, r = got[j][i], np.asarray(ref[j][i])
            assert g.shape == r.shape, f"class {j} image {i}"
            np.testing.assert_allclose(g[:, 4], r[:, 4], atol=1e-5, err_msg=f"class {j} image {i}")
            np.testing.assert_allclose(g[:, :4], r[:, :4], atol=1e-3, err_msg=f"class {j} image {i}")
            kept += len(g)
    assert kept >= 10
    assert set(results) == set(ref_results)
    for k, v in ref_results.items():
        assert abs(results[k] - v) <= 1e-6, k
    # random weights score ~0 against the synthetic gt, so the mAP is also
    # held on gts placed at JAX's detections in images 0, 2 and 4, jittered
    # by 2 px (those of images 1 and 3 are false positives)
    rng = np.random.RandomState(7)
    annots = {}
    for i in range(5):
        gts = [(np.asarray(ref[j][i])[:, :4] if i % 2 == 0 else np.zeros((0, 4)), j)
               for j in range(1, 4)]
        boxes = np.vstack([b for b, _ in gts]) + rng.randn(sum(len(b) for b, _ in gts), 4) * 2
        annots[i] = {"boxes": boxes.astype(np.float32),
                     "gt_classes": np.concatenate([np.full(len(b), j) for b, j in gts])}
    aps = [(voc_eval({i: got[j][i] for i in range(5)}, annots, j)[2],
            voc_eval({i: np.asarray(ref[j][i]) for i in range(5)}, annots, j)[2])
           for j in range(1, 4)]
    assert 0.1 < np.mean([r for _, r in aps]) < 0.99
    for g, r in aps:
        assert abs(g - r) <= 1e-6
    st = runs["stats"]
    assert st["completion"]["completed"] == 5 and st["feed"]["mode"] == "async"
    assert st["feed"]["fed"] == 5 and len(st["feed"]["wait_ms"]) == 5


@pytest.mark.parametrize("setting", ["threads", "feed 0"])
def test_pred_eval_loop_settings_give_the_same_boxes(runs, setting):
    """The same forwards in another dispatch mode or without the device
    feed: the same all_boxes, bit for bit."""
    (got, results), (ref, ref_results) = runs[setting], runs["port"]
    for j in range(1, 4):
        for i in range(5):
            np.testing.assert_array_equal(got[j][i], ref[j][i], err_msg=f"class {j} image {i}")
    assert results == ref_results


def test_pred_eval_batch_2_matches_batch_1(runs):
    """Batched forwards: the CPU convolutions of a batch of 2 round
    differently from a batch of 1 (~1e-5 px here), so the bars are the
    JAX comparison's: same keep counts, scores within 1e-5, boxes within
    1e-3 px, mAP within 1e-6."""
    (got, results), (ref, ref_results) = runs["batch 2"], runs["port"]
    for j in range(1, 4):
        for i in range(5):
            g, r = got[j][i], ref[j][i]
            assert g.shape == r.shape, f"class {j} image {i}"
            np.testing.assert_allclose(g[:, 4], r[:, 4], atol=1e-5, err_msg=f"class {j} image {i}")
            np.testing.assert_allclose(g[:, :4], r[:, :4], atol=1e-3, err_msg=f"class {j} image {i}")
    for k, v in ref_results.items():
        assert abs(results[k] - v) <= 1e-6, k


def test_pred_eval_host_branch_matches_device_branch(runs):
    """DEVICE_POSTPROCESS off: im_detect + C NMS on the host, at
    ``tests/test_postprocess.py``'s bars."""
    (got, results), (ref, _) = runs["host"], runs["port"]
    for j in range(1, 4):
        for i in range(5):
            g, r = got[j][i], ref[j][i]
            assert len(g) == len(r), f"class {j} image {i}"
            g, r = g[np.argsort(-g[:, 4], kind="stable")], r[np.argsort(-r[:, 4], kind="stable")]
            np.testing.assert_allclose(g[:, 4], r[:, 4], rtol=1e-5)
            np.testing.assert_allclose(g[:, :4], r[:, :4], rtol=1e-4, atol=1e-3)


def test_pred_eval_dump_round_trips(runs):
    with open(runs["dump"], "rb") as f:
        dumped = pickle.load(f)
    ref = runs["port"][0]
    assert len(dumped) == 4
    for j in range(4):
        for i in range(5):
            np.testing.assert_array_equal(dumped[j][i], ref[j][i])


def test_detect_single_gives_pred_evals_detections(bridged_eval, runs):
    """The same rendered pixels through ``detect_single`` (prepare_request)
    and through ``pred_eval`` (TestLoader) give the same detections once
    capped; ``demo_net`` names them."""
    _, cfg, _, model = bridged_eval
    rec = _dataset(SyntheticDataset).gt_roidb()[0]
    pp = make_test_postprocess(cfg, 4, cfg.TEST.SCORE_THRESH, max_out=cfg.TEST.DET_PER_CLASS)
    pred = Predictor(model, pp, device="cpu")
    im = tloader.load_record_image(rec)
    dets, _ = cap_detections(detect_single(pred, im, cfg, 4), cfg.TEST.MAX_PER_IMAGE)
    for j in range(1, 4):
        np.testing.assert_array_equal(dets[j], runs["port"][0][j][0])
    named = demo_net(pred, im, cfg, ("__background__", "a", "b", "c"), vis_thresh=0.0)
    assert set(named) == {n for j, n in enumerate("abc", 1) if len(dets[j])}


def test_pred_eval_refuses_what_is_not_ported(bridged_eval):
    _, cfg, _, model = bridged_eval
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Predictor(model)


def test_predictor_takes_staged_tensors_without_a_copy():
    t = torch.zeros(3)
    assert tester._on_device(t, torch.device("cpu")) is t
    assert tester._on_device(np.zeros(2, np.float32), torch.device("cpu")).dtype == torch.float32
