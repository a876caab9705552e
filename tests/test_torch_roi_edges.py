"""The tap rule of the resident ROIAlign (kernels 2 and 3) on the edge rois,
on the CPU: the port's plain forward and backward against the Pallas kernels
in interpret mode (canvas clamp, the train step's) and against the JAX gather
path with ``valid_hw`` (the eval path's), on the same numpy-seeded inputs.

The rois are the cases the kernels' per-roi taps and tables must reproduce:
the whole canvas, sub-cell, past the border, degenerate, inverted (width and
height floor at 1, so an inverted roi taps the cells at its clamped x1/y1
and is not empty), above and left of the map, and at the far corner; with
``valid_hw`` clamps that put the upper tap on the lower one (lo == hi).
Forwards within 1e-5, backwards within 1e-4 (float32 sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.ops.pallas.roi_align import roi_align_pallas
from mx_rcnn_tpu.ops.roi_align import roi_align as j_roi_align
from mx_rcnn_tpu_torch.ops import roi_align as troi

# xdist runs several workers on the same cores
torch.set_num_threads(2)

SCALE = 1.0 / 16


def edge_rois(rng, b, h_img, w_img, n_random=3):
    """(b, 9 + n_random, 4) image-coordinate rois on an (h_img, w_img)
    canvas: the edge cases, then random ones."""
    edges = np.array([
        [0, 0, w_img - 1, h_img - 1],                  # the whole canvas
        [5, 5, 5.5, 5.5],                              # sub-cell
        [w_img - 2, h_img - 2, w_img + 50, h_img + 50],  # past the border
        [0, 0, 0, 0],                                  # degenerate
        [w_img * 0.6, 40, w_img * 0.4, 90],            # inverted along x
        [100, 100, 60, 60],                            # inverted along both
        [37, 41, 36, 40],                              # inverted inside a cell
        [-80, -60, -20, -10],                          # above and left of the map
        [w_img - 1, h_img - 1, w_img + 300, h_img + 300],  # at the far corner
    ], np.float32)
    out = []
    for _ in range(b):
        xy = rng.rand(n_random, 2) * [w_img, h_img]
        wh = rng.rand(n_random, 2) * [w_img / 2, h_img / 2]
        out.append(np.concatenate([edges, np.concatenate([xy, xy + wh], -1)]))
    return np.stack(out).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


# (h, w): a map whose canvas is 16x larger; valid_hw (per image) clamps the
# samples to ceil(valid / 16) cells, below the map's extent in every case
# but the first image's rows, so lo == hi at the clamped edge
MAP_HW = (12, 16)
VALID_HW = np.array([[192.0, 100.0], [100.0, 33.0]], np.float32)


def _inputs(rng, c, pooled):
    b = 2
    h, w = MAP_HW
    feat = rng.randn(b, h, w, c).astype(np.float32)
    rois = edge_rois(rng, b, h / SCALE, w / SCALE)
    cot = rng.randn(b, rois.shape[1], *pooled, c).astype(np.float32)
    return feat, rois, cot


@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_plain_forward_matches_pallas_on_edge_rois(rng, pooled):
    feat, rois, _ = _inputs(rng, 128, pooled)
    got = troi.roi_align(T(feat), T(rois), pooled, SCALE, 2).numpy()
    ref = roi_align_pallas(jnp.asarray(feat), jnp.asarray(rois), pooled, SCALE, 2, True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    # the inverted rois are not empty: they pool the cells at x1/y1
    assert (np.abs(got[:, 4:7]).reshape(2, 3, -1).max(-1) > 0.0).all()


@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_plain_backward_matches_pallas_grad_on_edge_rois(rng, pooled):
    feat, rois, cot = _inputs(rng, 128, pooled)
    jr, jc = jnp.asarray(rois), jnp.asarray(cot)
    ref = jax.grad(
        lambda f: (roi_align_pallas(f, jr, pooled, SCALE, 2, True) * jc).sum())(jnp.asarray(feat))
    got = troi.roi_align_bwd_plain(T(cot), T(rois), feat.shape, pooled, SCALE, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    # the cells at an inverted roi's clamped x1/y1 get its gradient
    one = troi.roi_align_bwd_plain(T(cot[:, 5:6]), T(rois[:, 5:6]), feat.shape, pooled, SCALE, 2)
    assert float(one[:, 6:8, 6:8].abs().min()) > 0.0


@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_plain_forward_matches_gather_with_valid_hw_on_edge_rois(rng, pooled):
    feat, rois, _ = _inputs(rng, 16, pooled)
    got = troi.roi_align(T(feat), T(rois), pooled, SCALE, 2, T(VALID_HW)).numpy()
    for i in range(feat.shape[0]):
        ref = j_roi_align(jnp.asarray(feat[i]), jnp.asarray(rois[i]), pooled, SCALE, 2,
                          valid_hw=jnp.asarray(VALID_HW[i]))
        np.testing.assert_allclose(got[i], np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_plain_backward_matches_gather_grad_with_valid_hw_on_edge_rois(rng, pooled):
    feat, rois, cot = _inputs(rng, 16, pooled)
    jr, jc, jv = jnp.asarray(rois), jnp.asarray(cot), jnp.asarray(VALID_HW)
    ref = jax.grad(lambda f: sum(
        (j_roi_align(f[i], jr[i], pooled, SCALE, 2, valid_hw=jv[i]) * jc[i]).sum()
        for i in range(feat.shape[0])))(jnp.asarray(feat))
    got = troi.roi_align_bwd_plain(T(cot), T(rois), feat.shape, pooled, SCALE, 2, T(VALID_HW))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    # nothing lands past the valid extent: rows >= ceil(100 / 16) = 7 of the
    # second image, columns >= ceil(33 / 16) = 3
    assert float(got[1, 7:].abs().max()) == 0.0 and float(got[1, :, 3:].abs().max()) == 0.0
