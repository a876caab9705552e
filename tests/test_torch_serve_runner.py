"""The port's ``ServeRunner`` on the CPU against the JAX package's functions
below its own runner (whose tests cannot run here): JAX's ``Predictor``
(``test_forward``) with ``make_test_postprocess``, ``detections_from_output``,
``cap_detections`` and ``detect_single``, on the same bridged weights, for a
tiny ResNet-50 C4 model and a tiny Mask R-CNN FPN model.

Tolerances: the port serves a padded batch of 2 where JAX's
``detect_single`` runs a batch of 1, and the two packages' CPU
convolutions round differently through a calibrated random ResNet-50, so
detections are held at ``tests/test_torch_fpn_infer.py``'s bars: same keep
counts, scores within 1e-4, boxes within 1e-3 px (the mask model's grids
within 1e-4 of the largest logit, ``tests/test_torch_mask.py``'s).  Bitwise claims are made only
between two runs of the port on one input.

Also: ``run == complete(dispatch)``; one signature a rung after warmup and
none after more batches; the bf16 and int8 rungs' parity gates (JAX's
default tolerances) passing on weights whose detections their rounding
leaves in place, and refusing a perturbed rung; the int8 rung against JAX
on ``dequantize_tree(quantize_tree(params))``; ``detection_parity`` /
``mask_parity`` against JAX's on the same numpy detections; a hot swap from
a checkpoint with no new signature; and the three swap fault kinds rolling
back."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core.quantize import dequantize_tree as j_dequantize_tree
from mx_rcnn_tpu.core.quantize import quantize_tree as j_quantize_tree
from mx_rcnn_tpu.core.tester import Predictor as JPredictor
from mx_rcnn_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from mx_rcnn_tpu.models import FasterRCNN as JFasterRCNN
from mx_rcnn_tpu.models.fpn import FPNFasterRCNN as JFPNFasterRCNN
from mx_rcnn_tpu.ops.postprocess import make_test_postprocess as j_make_postprocess
from mx_rcnn_tpu.serve import runner as j_runner
from mx_rcnn_tpu_torch.core.checkpoint import save_checkpoint
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm
from mx_rcnn_tpu_torch.serve import runner as t_runner
from mx_rcnn_tpu_torch.serve.batcher import Request
from mx_rcnn_tpu_torch.serve.buckets import BucketLadder, BucketOverflow
from mx_rcnn_tpu_torch.serve.registry import DEFAULT_MODEL, SwapRolledBack, VersionState
from mx_rcnn_tpu_torch.serve.runner import PrecisionParityError, ServeRunner, prepare_request
from mx_rcnn_tpu_torch.utils import faults
from mx_rcnn_tpu_torch.utils.bridge import flax_state_dict, torch_to_flax
from tests.test_torch_fpn_infer import calibrated_model, dataset, first_batch, small_cfgs
from tests.test_torch_model import port_cfg

torch.set_num_threads(2)

K = 4
MAX_BATCH = 2
BUCKETS = ((64, 64), (96, 96))
# images of both buckets at scale 1 (the resize's rounding is held against
# cv2 in tests/test_torch_images.py; a 1-level pixel difference moves this
# random network's scores by ~1e-2): (64, 64) pads into 64 × 64, (64, 90)
# and (90, 64) into 96 × 96
IMAGE_HW = ((64, 64), (64, 90), (90, 64))


def c4_cfgs():
    """(JAX cfg, port cfg): ResNet-50 C4 at CPU size, ``tests/test_serve_runner.py``'s."""
    jcfg = j_generate_config("resnet50", "PascalVOC")
    jcfg = jcfg.replace(
        SHAPE_BUCKETS=BUCKETS,
        network=dataclasses.replace(jcfg.network, ANCHOR_SCALES=(2, 4, 8), FIXED_PARAMS=()),
        dataset=dataclasses.replace(jcfg.dataset, NUM_CLASSES=K, SCALES=((64, 96),)),
        TEST=dataclasses.replace(jcfg.TEST, RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16,
                                 SCORE_THRESH=0.05),
    )
    return jcfg, port_cfg(jcfg)


def calibrated_c4(cfg, images=None):
    """Seeded C4 weights with confident detections on ``images`` (the test
    images by default; the random network's scores saturate on images it
    was not calibrated on): the RPN output layers scaled by 1e-3 (proposals
    near their anchors), every frozen BN's moments set to its input's on a
    batch of the images (prepared and padded into the largest bucket), and
    the class logits centred and scaled to unit deviation there, so fg
    scores spread over (0, 1).  → (model, its Flax tree)."""
    model = FasterRCNN(cfg, torch.Generator().manual_seed(0)).eval()
    if images is None:
        images = [_image(k) for k in range(len(IMAGE_HW))]
    reqs = [prepare_request(im, cfg, BucketLadder([BUCKETS[-1]])) for im in images]
    images = torch.from_numpy(np.stack([r.image for r in reqs]))
    im_info = torch.from_numpy(np.stack([r.im_info for r in reqs]))
    with torch.no_grad():
        for layer in (model.rpn.rpn_cls_score, model.rpn.rpn_bbox_pred):
            layer.weight.mul_(1e-3)

    def set_moments(bn, args):
        bn.mean.copy_(args[0].mean(dim=(0, 2, 3)))
        bn.var.copy_(args[0].var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_moments) for m in model.modules()
             if isinstance(m, FrozenBatchNorm)]
    seen = []
    hooks.append(model.rcnn.cls_score.register_forward_hook(
        lambda m, i, o: seen.append((o.mean(0), o.std(0).mean()))))
    try:
        with torch.no_grad():
            model(images, im_info)
    finally:
        for h in hooks:
            h.remove()
    mu, sd = seen[0]
    with torch.no_grad():
        model.rcnn.cls_score.weight.div_(sd)
        model.rcnn.cls_score.bias.sub_(mu).div_(sd)
    model._constants.clear()
    return model, torch_to_flax(model)


def gate_c4(cfg):
    """Seeded C4 weights on which bf16 compute and int8 weights leave the
    detections in place, so the parity gates compare confident detections
    and pass: every frozen BN moved as JAX's exact-rewrite test moves it
    (N(0, 0.05), var to |var + N| + 0.5), the class and objectness scores
    bias-only (the same for every roi: no ordering flips by rounding), class
    1 at probability ~0.6, and the box deltas of both heads scaled small.
    → (model, its Flax tree)."""
    model = FasterRCNN(cfg, torch.Generator().manual_seed(0)).eval()
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                for leaf in ("scale", "bias", "mean", "var"):
                    t = getattr(m, leaf)
                    t.add_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.05))
                    if leaf == "var":
                        t.abs_().add_(0.5)
        model.rpn.rpn_cls_score.weight.zero_()
        model.rpn.rpn_bbox_pred.weight.mul_(1e-3)
        model.rcnn.cls_score.weight.zero_()
        model.rcnn.cls_score.bias.copy_(torch.tensor([0.0, 1.5, 0.0, 0.0]))
        model.rcnn.bbox_pred.weight.mul_(1e-2)
    return model, torch_to_flax(model)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _image(k):
    h, w = IMAGE_HW[k]
    return np.random.RandomState(10 + k).randint(0, 256, (h, w, 3)).astype(np.float32)


def _held(got, ref, score_tol=1e-4, box_tol=1e-3, label=""):
    """Per-class detections: same counts, scores and boxes within the bars
    (rows in score order, which the tolerance cannot reorder here)."""
    n = 0
    for j in range(1, len(ref)):
        g, r = got[j], np.asarray(ref[j])
        assert g.shape == r.shape, f"{label} class {j}: {g.shape} vs {r.shape}"
        g, r = g[np.argsort(-g[:, 4], kind="stable")], r[np.argsort(-r[:, 4], kind="stable")]
        np.testing.assert_allclose(g[:, 4], r[:, 4], atol=score_tol, rtol=0, err_msg=label)
        np.testing.assert_allclose(g[:, :4], r[:, :4], atol=box_tol, rtol=0, err_msg=label)
        n += len(g)
    return n


# ------------------------------------------------------------------- C4
@pytest.fixture(scope="module")
def c4():
    """(JAX cfg, port cfg, calibrated model, its Flax tree, the warmed-up
    f32 runner, JAX's postprocess, JAX's model)."""
    jcfg, cfg = c4_cfgs()
    model, params_np = calibrated_c4(cfg)
    runner = ServeRunner(model, params_np, cfg, max_batch=MAX_BATCH, device="cpu")
    assert runner.warmup() == len(BUCKETS)
    jpp = j_make_postprocess(jcfg, K, jcfg.TEST.SCORE_THRESH, max_out=jcfg.TEST.DET_PER_CLASS)
    return jcfg, cfg, model, params_np, runner, jpp, JFasterRCNN(jcfg)


@pytest.fixture(scope="module")
def jax_dets(c4):
    """JAX's ``detect_single`` + ``cap_detections`` of every image, with
    the f32 params and with ``dequantize_tree(quantize_tree(params))``
    (params are a jit argument: one compile a bucket serves both)."""
    jcfg, _, _, params_np, _, jpp, jmodel = c4
    out = {}
    for label, params in (("f32", params_np),
                          ("int8", j_dequantize_tree(j_quantize_tree(params_np)))):
        pred = JPredictor(jmodel, params, postprocess=jpp)
        out[label] = [j_runner.cap_detections(
            j_runner.detect_single(pred, _image(k), jcfg, K), jcfg.TEST.MAX_PER_IMAGE)[0]
            for k in range(len(IMAGE_HW))]
    return out


@pytest.mark.parametrize("k", range(len(IMAGE_HW)))
def test_runner_matches_jax_detect_single(c4, jax_dets, k):
    runner = c4[4]
    got = runner.detect(_image(k))
    assert got[0] is None and len(got) == K
    assert _held(got, jax_dets["f32"][k], label=f"image {k}") > 0


def test_batch_of_two_requests_matches_jax(c4, jax_dets):
    """Two requests of one bucket in one batch: each slot's detections."""
    runner = c4[4]
    reqs = [runner.make_request(_image(k)) for k in (1, 2)]
    assert reqs[0].bucket == reqs[1].bucket == BUCKETS[1]
    batch = runner.assemble(reqs)
    out = runner.run(batch)
    for slot, k in enumerate((1, 2)):
        _held(runner.detections_for(out, batch, slot), jax_dets["f32"][k], label=f"slot {slot}")


def test_run_is_complete_of_dispatch(c4):
    runner = c4[4]
    batch = runner.assemble([runner.make_request(_image(1))])
    a = runner.run(batch)
    h = runner.dispatch(batch)
    assert h.signature == runner._signature(batch) and h.bucket == BUCKETS[1]
    b = runner.complete(h)
    assert set(a) == set(b) == {"det_boxes", "det_scores", "det_valid"}
    for key in a:
        assert a[key].tobytes() == b[key].tobytes(), key
    assert runner.last_fetch_bytes == sum(v.nbytes for v in b.values())
    assert runner.split_dispatches == runner.split_completes


def test_assemble_pads_with_slot_zero_and_refuses_mixes(c4):
    runner = c4[4]
    r0, r1 = runner.make_request(_image(0)), runner.make_request(_image(1))
    batch = runner.assemble([r0])
    assert batch["images"].shape == (MAX_BATCH,) + BUCKETS[0] + (3,)
    assert batch["images"][1].tobytes() == batch["images"][0].tobytes()
    np.testing.assert_array_equal(batch["im_info"][1], batch["im_info"][0])
    with pytest.raises(ValueError, match="mixed buckets"):
        runner.assemble([r0, r1])
    with pytest.raises(ValueError, match="max_batch"):
        runner.assemble([r0] * (MAX_BATCH + 1))


def test_signatures_are_the_rungs_and_stay(c4):
    """One signature a (model, bucket, precision) rung after warmup; none
    after more batches of every fill, nor after an oversize request."""
    runner = c4[4]
    before = runner.compile_cache.snapshot()
    assert before["misses"] == len(BUCKETS)
    assert sorted(s[1] for s in runner.compile_cache.keys) == sorted(
        (MAX_BATCH,) + b + (3,) for b in BUCKETS)
    assert all(s[0] == DEFAULT_MODEL and s[3] == "f32" for s in runner.compile_cache.keys)
    for ks in ((0,), (1, 2), (1,)):
        runner.run(runner.assemble([runner.make_request(_image(k)) for k in ks]))
    with pytest.raises(BucketOverflow):
        prepare_request(_image(0), runner.cfg, BucketLadder([(32, 32)]))
    after = runner.compile_cache.snapshot()
    assert after["misses"] == before["misses"] and after["hits"] > before["hits"]


def test_int8_rung_matches_jax_dequantized(c4, jax_dets):
    """The int8 rung holds the registry's per-channel quantized tree,
    dequantized: against JAX's forward on ``dequantize_tree(quantize_tree(
    params))`` at the f32 bars.  Its signatures carry ``int8``; the
    registry folds once per version."""
    _, cfg, model, params_np, *_ = c4
    r8 = ServeRunner(model, params_np, cfg, max_batch=MAX_BATCH, device="cpu", precision="int8")
    reg = r8.registry
    qtree = reg.quantized_tree(DEFAULT_MODEL)
    assert reg.quantized_tree(DEFAULT_MODEL) is qtree
    got, ref = dict(_flat(qtree)), dict(_flat(j_quantize_tree(params_np)))
    assert set(got) == set(ref) and any(p[-1] == "int8_q" for p in got)
    for path, a in ref.items():
        assert got[path].tobytes() == np.asarray(a).tobytes(), path
    for k in range(len(IMAGE_HW)):
        _held(r8.detect(_image(k)), jax_dets["int8"][k], label=f"int8 image {k}")
    assert all(s[3] == "int8" for s in r8.compile_cache.keys)


# ------------------------------------------------------------ parity gates
@pytest.fixture(scope="module")
def gate_weights():
    _, cfg = c4_cfgs()
    return (cfg,) + gate_c4(cfg)


@pytest.mark.parametrize("precision,tag", [("bfloat16", "bf16"), ("int8", "int8")])
def test_parity_gate_passes_then_refuses_a_perturbed_rung(gate_weights, precision, tag):
    """Warmup runs the gate at JAX's default tolerances (box 4 px, score 0.1,
    margin 0.1) against a transient f32 module: it compares confident
    detections and passes.  The same rung with its box regression restored
    to the raw head's scale (a perturbed rung: boxes move tens of px) is
    refused with PrecisionParityError."""
    cfg, model, params_np = gate_weights
    runner = ServeRunner(model, params_np, cfg, max_batch=MAX_BATCH, device="cpu",
                         precision=precision, ladder=BucketLadder(BUCKETS[:1]))
    assert runner.warmup() == 1
    report = runner.parity[f"{DEFAULT_MODEL}:{tag}"]
    assert report["checked"] and report["ok"] and report["precision"] == tag
    assert (report["box_tol_px"], report["score_tol"], report["margin"]) == (4.0, 0.1, 0.1)
    assert report["unmatched_confident"] == 0 and report["max_box_delta_px"] <= 4.0
    b = runner._parity_batch(DEFAULT_MODEL, BUCKETS[0])
    dets = runner.detections_for(runner.run(b), b, 0)
    assert sum(int((d[:, 4] >= 0.15).sum()) for d in dets[1:]) >= 3  # not vacuous
    assert all(s[3] == tag for s in runner.compile_cache.keys)
    slot = runner._slot(DEFAULT_MODEL)
    with torch.no_grad():
        slot.predictor.model.rcnn.bbox_pred.weight.mul_(100.0)
    with pytest.raises(PrecisionParityError, match=tag):
        runner.check_parity()
    assert runner.parity[f"{DEFAULT_MODEL}:{tag}"]["ok"] is False


def test_parity_tolerances_are_jax_defaults():
    """The gate's tolerances are the JAX runner's defaults, unchanged, and
    the port's runner takes no knob that would move or skip them."""
    import inspect

    j = inspect.signature(j_runner.ServeRunner.__init__).parameters
    assert (t_runner.PARITY_BOX_TOL, t_runner.PARITY_SCORE_TOL, t_runner.PARITY_MARGIN,
            t_runner.PARITY_MASK_TOL) == (
        j["parity_box_tol"].default, j["parity_score_tol"].default,
        j["parity_margin"].default, j["parity_mask_tol"].default)
    t = inspect.signature(ServeRunner.__init__).parameters
    assert not [n for n in t if n.startswith("parity") or n == "device_postprocess"]


def _random_dets(rng, k=4, n=6, jitter=0.0):
    out = [None]
    for _ in range(1, k):
        xy = rng.uniform(0, 80, (n, 2))
        wh = rng.uniform(8, 30, (n, 2))
        box = np.hstack([xy, xy + wh]) + rng.randn(n, 4) * jitter
        out.append(np.hstack([box, rng.uniform(0, 1, (n, 1))]).astype(np.float32))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_parity_functions_match_jax(seed):
    rng = np.random.RandomState(seed)
    ref = _random_dets(rng)
    test = [None] + [d + np.hstack([rng.randn(len(d), 4) * (seed + 0.5),
                                    rng.randn(len(d), 1) * 0.03]).astype(np.float32)
                     for d in ref[1:]]
    if seed == 3:
        test[2] = test[2][:2]
    for thresh, margin in ((0.05, 0.1), (0.3, 0.0)):
        assert t_runner.detection_parity(ref, test, thresh, margin) == \
            j_runner.detection_parity(ref, test, thresh, margin)
    masks_r = {j: rng.rand(len(ref[j]), 7, 7).astype(np.float32) for j in range(1, 4)}
    masks_t = {j: np.clip(masks_r[j][:len(test[j])] + rng.randn(len(test[j]), 7, 7) * 0.05, 0, 1)
               for j in range(1, 4)}
    got = t_runner.mask_parity(ref, masks_r, test, masks_t, 0.05)
    assert got == j_runner.mask_parity(ref, masks_r, test, masks_t, 0.05)
    assert got["mask_pairs"] > 0


# ------------------------------------------------------------------ swaps
def _v2_state(model):
    """The model's tensors with the class logits rescaled: a new version
    whose detections differ."""
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state["rcnn.cls_score.weight"] *= 1.5
    return state


@pytest.fixture(scope="module")
def swap_env(c4, tmp_path_factory):
    """A fresh f32 runner on the calibrated weights and a committed v2
    checkpoint of the port's train-state layout."""
    _, cfg, model, params_np, *_ = c4
    runner = ServeRunner(model, params_np, cfg, max_batch=MAX_BATCH, device="cpu")
    runner.warmup()
    prefix = str(tmp_path_factory.mktemp("swap"))
    ckpt = save_checkpoint(prefix, {"model": _v2_state(model), "momentum": {}, "count": 3}, 2)
    return runner, model, ckpt


def _detect_all(runner):
    return [runner.detect(_image(1))]


def _same(a, b):
    return all(x is None and y is None or x.tobytes() == y.tobytes()
               for da, db in zip(a, b) for x, y in zip(da, db))


@pytest.mark.parametrize("kind,stage", [("swap_verify_fail", "verify"),
                                        ("swap_warm_fail", "warm"),
                                        ("canary_fail", "canary")])
def test_swap_faults_roll_back(swap_env, monkeypatch, kind, stage):
    """An injected fault at each stage retires the candidate, the previous
    version keeps serving bit for bit, and no signature is added."""
    runner, _, ckpt = swap_env
    reg = runner.registry
    live = reg.live().version
    before = _detect_all(runner)
    misses = runner.compile_cache.misses
    monkeypatch.setenv(faults.ENV_VAR, f"{kind}@*")
    faults.reset()
    try:
        with pytest.raises(SwapRolledBack) as e:
            reg.swap(DEFAULT_MODEL, ckpt, target=runner, block=True, timeout=300)
    finally:
        monkeypatch.delenv(faults.ENV_VAR)
        faults.reset()
    assert e.value.stage == stage and isinstance(e.value.cause, faults.InjectedSwapFault)
    assert reg.live().version == live
    cand = reg.entry().versions[-1]
    assert cand.state is VersionState.RETIRED and cand.params is None
    assert not runner._staged
    assert _same(_detect_all(runner), before)
    assert runner.compile_cache.misses == misses


def test_swap_from_a_checkpoint_adds_no_signature(swap_env):
    """A committed port checkpoint swaps in between batches: v2 serves
    exactly what a runner built on v2 serves, with no new signature; the
    superseded version's params are released."""
    runner, model, ckpt = swap_env
    reg = runner.registry
    before = _detect_all(runner)
    misses = runner.compile_cache.misses
    v_old, applied = reg.live().version, runner.swaps_applied
    res = reg.swap(DEFAULT_MODEL, ckpt, target=runner, block=True, timeout=300)
    assert res["previous"] == v_old and res["version"] == reg.live().version > v_old
    assert res["warmed"] == len(BUCKETS) and res["canary_probes"] == 1
    after = _detect_all(runner)
    assert not _same(after, before)
    fresh = ServeRunner(model, _v2_state(model), runner.cfg, max_batch=MAX_BATCH, device="cpu")
    assert _same(after, _detect_all(fresh))
    assert runner.compile_cache.misses == misses and runner.swaps_applied == applied + 1
    old = [v for v in reg.entry().versions if v.version == v_old][0]
    assert old.state is VersionState.RETIRED and old.params is None


def test_swap_refuses_another_structure(swap_env, tmp_path):
    runner, model, _ = swap_env
    state = {k: v for k, v in model.state_dict().items() if not k.startswith("rcnn.bbox")}
    ckpt = save_checkpoint(str(tmp_path), {"model": state, "momentum": {}, "count": 0}, 1)
    live = runner.registry.live().version
    with pytest.raises(SwapRolledBack) as e:
        runner.registry.swap(DEFAULT_MODEL, ckpt, target=runner, block=True, timeout=300)
    assert e.value.stage == "verify" and runner.registry.live().version == live


# ------------------------------------------------------------- mask FPN
@pytest.fixture(scope="module")
def mask_env():
    """(port cfg, JAX cfg, the runner with the device canvas, a batch of 2
    requests, the JAX postprocess's outputs on JAX's forward of it)."""
    cfg, jcfg = small_cfgs("mask_resnet_fpn")
    k = cfg.dataset.NUM_CLASSES
    batch = first_batch(cfg, dataset(JSyntheticDataset, with_masks=True).gt_roidb())
    model, params_np = calibrated_model(cfg, batch, seed=1)
    runner = ServeRunner(model, params_np, cfg, max_batch=2, device="cpu", mask_canvas=True)
    reqs = [Request(image=batch["images"][i], im_info=batch["im_info"][i],
                    orig_hw=tuple(int(x) for x in batch["orig_hw"][i]),
                    bucket=tuple(batch["images"].shape[1:3])) for i in range(2)]
    jpp = j_make_postprocess(jcfg, k, jcfg.TEST.SCORE_THRESH, max_out=jcfg.TEST.DET_PER_CLASS)
    ref = jax.tree.map(np.asarray, JPredictor(JFPNFasterRCNN(jcfg), params_np,
                                              postprocess=jpp).predict(dict(batch)))
    return cfg, jcfg, runner, reqs, ref


def test_mask_runner_matches_jax(mask_env):
    """Detections and mask probabilities of both slots against JAX's
    ``detections_from_output`` + ``cap_detections`` of JAX's outputs."""
    cfg, jcfg, runner, reqs, ref = mask_env
    k = cfg.dataset.NUM_CLASSES
    batch = runner.assemble(reqs)
    out = runner.run(batch)
    assert {"det_masks", "det_mask_idx", "det_canvas"} <= set(out)
    largest = float(np.abs(ref["det_masks"][ref["det_mask_valid"]]).max())
    n = 0
    for i in range(2):
        dets, probs = runner.detections_for(out, batch, i, with_masks=True)
        rd, rp = j_runner.detections_from_output(ref, batch["im_info"][i],
                                                 tuple(batch["orig_hw"][i]), jcfg, k, index=i)
        rd, rp = j_runner.cap_detections(rd, jcfg.TEST.MAX_PER_IMAGE, rp)
        n += _held(dets, rd, label=f"mask slot {i}")
        for j in range(1, k):
            order_g = np.argsort(-dets[j][:, 4], kind="stable")
            order_r = np.argsort(-np.asarray(rd[j])[:, 4], kind="stable")
            # the sigmoid's slope is at most 1/4: probabilities within a
            # quarter of the logits' bar
            np.testing.assert_allclose(probs[j][order_g], np.asarray(rp[j])[order_r],
                                       atol=0.25e-4 * largest, rtol=0)
    assert n > 5


def test_mask_rles_device_canvas_equals_host_paste(mask_env):
    """``mask_rles_for`` on the device canvas and on the host paste of the
    same forward's grids (``eval/segm.py::canvas_rles``): the same RLEs,
    byte for byte, and each class's list row for row with its detections;
    the paste counters move."""
    cfg, _, runner, reqs, _ = mask_env
    k = cfg.dataset.NUM_CLASSES
    host = ServeRunner(registry=runner.registry, max_batch=2, device="cpu", mask_canvas=False)
    batch = runner.assemble(reqs)
    out, out_h = runner.run(batch), host.run(batch)
    pastes = runner.pastes
    total = 0
    for i in range(2):
        dets, rles = runner.mask_rles_for(out, batch, i)
        dets_h, rles_h = host.mask_rles_for(out_h, batch, i)
        for j in range(1, k):
            assert dets[j].tobytes() == dets_h[j].tobytes()
            assert len(rles[j]) == len(dets[j])
            assert rles[j] == rles_h[j], f"slot {i} class {j}"
            total += len(rles[j])
    assert total > 0
    assert runner.pastes == pastes + 2 and runner.paste_bytes_total > 0


def test_flax_state_dict_round_trip(c4):
    """The registry's Flax-tree path: a Flax tree becomes the model's
    state_dict exactly."""
    _, _, model, params_np, *_ = c4
    state = flax_state_dict(params_np, model.state_dict())
    for key, t in model.state_dict().items():
        assert state[key].numpy().tobytes() == t.contiguous().numpy().tobytes(), key
