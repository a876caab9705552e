"""The port's plain ROIAlign versions against the JAX package at the sample
ratios and pooled widths the CUDA forwards now take (kernels 2 and 4: any
s, any pooled width), on the CPU, on the same numpy-seeded inputs.

- ``roi_align_stream_plain`` (kernel 4's plain version) against the
  streaming Pallas kernel in interpret mode, with 8-row blocks so the rois
  straddle blocks, the last one ragged: bar 1e-4, as ``tests/test_torch_fpn.py``
  sets for interpret mode; the inverted roi pools to zeros in both.
- ``roi_align_plain`` (kernel 2's) without ``valid_hw`` against the resident
  Pallas kernel in interpret mode and the gather path, and with
  ``valid_hw`` against the gather path: within 1e-5.
- The plain backwards against ``jax.grad`` of the two Pallas kernels at
  s = 5: within 1e-4 (float32 sums in other orders).

Maps are at most 32 × 32 with at most 32 channels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.ops.pallas import roi_align_stream as j_stream
from mx_rcnn_tpu.ops.pallas.roi_align import roi_align_pallas
from mx_rcnn_tpu.ops.roi_align import roi_align as j_roi_align
from mx_rcnn_tpu_torch.ops import roi_align as troi
from mx_rcnn_tpu_torch.ops import roi_align_stream as tstream
from tests.test_torch_roi_edges import edge_rois

# xdist runs several workers on the same cores
torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def small_row_blocks(monkeypatch):
    """8-row blocks in the JAX streaming kernel, so its rois straddle
    several blocks, the last one ragged."""
    monkeypatch.setattr(j_stream, "_pick_hblk", lambda w, cblk, budget=0: 8)


def _stream_case(rng, h, w, c, scale):
    """One image's (h, w, c) map and the edge rois on its canvas (three of
    them inverted, scaled x2 < x1; one off the map)."""
    feat = rng.randn(1, h, w, c).astype(np.float32)
    return feat, edge_rois(rng, 1, h / scale, w / scale)


# (sample ratio, pooled): three ratios, one of them above the old s <= 4
# limit, and a width above the old pw <= 32 limit
STREAM_CASES = [(1, (7, 7)), (3, (7, 7)), (5, (7, 7)), (2, (7, 40)), (5, (3, 40))]


@pytest.mark.parametrize("s,pooled", STREAM_CASES)
def test_stream_plain_matches_pallas_interpret(small_row_blocks, s, pooled):
    feat, rois = _stream_case(np.random.RandomState(s), 27, 16, 16, 0.25)
    ref = np.asarray(j_stream.roi_align_stream(jnp.asarray(feat), jnp.asarray(rois), pooled,
                                               0.25, s, True))
    got = tstream.roi_align_stream_plain(T(feat), T(rois), pooled, 0.25, s).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    inverted = ~tstream.valid_rois(T(rois), 0.25).numpy()
    assert inverted.sum() >= 1
    assert not got[inverted].any() and not ref[inverted].any()


def test_stream_plain_bwd_matches_pallas_vjp_at_s5(small_row_blocks):
    feat, rois = _stream_case(np.random.RandomState(7), 26, 20, 8, 0.25)
    cot = np.random.RandomState(8).randn(1, rois.shape[1], 7, 7, 8).astype(np.float32)
    _, vjp = jax.vjp(lambda f: j_stream.roi_align_stream(f, jnp.asarray(rois), (7, 7), 0.25, 5,
                                                         True), jnp.asarray(feat))
    (ref,) = vjp(jnp.asarray(cot))
    got = tstream.roi_align_stream_bwd_plain(T(cot), T(rois), feat.shape, (7, 7), 0.25, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


SCALE = 1.0 / 16
MAP_HW = (12, 16)
VALID_HW = np.array([[150.0, 100.0], [100.0, 33.0]], np.float32)


def _resident_case(rng, c):
    h, w = MAP_HW
    feat = rng.randn(2, h, w, c).astype(np.float32)
    return feat, edge_rois(rng, 2, h / SCALE, w / SCALE)


@pytest.mark.parametrize("s", [1, 3, 5])
def test_plain_matches_pallas_and_gather_on_the_canvas(s):
    feat, rois = _resident_case(np.random.RandomState(10 + s), 32)
    got = troi.roi_align_plain(T(feat), T(rois), (7, 7), SCALE, s).numpy()
    ref = roi_align_pallas(jnp.asarray(feat), jnp.asarray(rois), (7, 7), SCALE, s, True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    for i in range(feat.shape[0]):
        gather = j_roi_align(jnp.asarray(feat[i]), jnp.asarray(rois[i]), (7, 7), SCALE, s)
        np.testing.assert_allclose(got[i], np.asarray(gather), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 3, 5])
def test_plain_matches_gather_with_valid_hw(s):
    feat, rois = _resident_case(np.random.RandomState(20 + s), 16)
    got = troi.roi_align_plain(T(feat), T(rois), (7, 7), SCALE, s, T(VALID_HW)).numpy()
    for i in range(feat.shape[0]):
        ref = j_roi_align(jnp.asarray(feat[i]), jnp.asarray(rois[i]), (7, 7), SCALE, s,
                          valid_hw=jnp.asarray(VALID_HW[i]))
        np.testing.assert_allclose(got[i], np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_plain_matches_pallas_at_a_wide_pool():
    """Pooled (7, 40) at s = 2, above kernel 2's old widths too."""
    feat, rois = _resident_case(np.random.RandomState(30), 8)
    got = troi.roi_align_plain(T(feat), T(rois), (7, 40), SCALE, 2).numpy()
    ref = roi_align_pallas(jnp.asarray(feat), jnp.asarray(rois), (7, 40), SCALE, 2, True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_plain_bwd_matches_pallas_grad_at_s5():
    feat, rois = _resident_case(np.random.RandomState(40), 8)
    cot = np.random.RandomState(41).randn(2, rois.shape[1], 7, 7, 8).astype(np.float32)
    jr, jc = jnp.asarray(rois), jnp.asarray(cot)
    ref = jax.grad(lambda f: (roi_align_pallas(f, jr, (7, 7), SCALE, 5, True) * jc).sum())(
        jnp.asarray(feat))
    got = troi.roi_align_bwd_plain(T(cot), T(rois), feat.shape, (7, 7), SCALE, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
