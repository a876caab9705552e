"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  Marked ``gpu``; each test decides inside itself whether a card
is present and skips without one.  No JAX here, so on the machine with the
card they run without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from mx_rcnn_tpu_torch.ops import nms as tnms
from mx_rcnn_tpu_torch.ops import roi_align as troi

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _boxes(rng, p, n, span, side):
    xy = rng.rand(p, n, 2) * span
    wh = rng.rand(p, n, 2) * side + 1.0
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))


@pytest.mark.parametrize("p,n,thresh,max_keep", [
    (1, 1, 0.5, 0), (2, 63, 0.3, 0), (3, 64, 0.7, 0), (2, 65, 0.5, 0),
    (4, 1000, 0.5, 0), (2, 2000, 0.7, 100),
])
def test_nms_kernel_matches_plain(card, p, n, thresh, max_keep):
    rng = np.random.RandomState(n)
    boxes = _boxes(rng, p, n, 300.0, 80.0).to(card)
    valid = torch.from_numpy(rng.rand(p, n) > 0.2).to(card)
    before = tnms.kernel.launches
    got = tnms.nms_mask_sorted(boxes, valid, thresh, max_keep)
    assert tnms.kernel.launches == before + 1
    ref = tnms.nms_mask_sorted_plain(boxes, valid, thresh, max_keep)
    assert torch.equal(got, ref)


def test_nms_unsorted_contract_matches_cpu(card):
    rng = np.random.RandomState(0)
    boxes = _boxes(rng, 6, 300, 400.0, 120.0)
    scores = torch.from_numpy(rng.rand(6, 300).astype(np.float32))
    valid = scores > 0.2
    got = tnms.nms(boxes.to(card), scores.to(card), 0.3, 100, valid.to(card))
    ref = tnms.nms(boxes, scores, 0.3, 100, valid)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("with_valid_hw", [False, True])
@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_roi_align_kernel_matches_plain(card, with_valid_hw, pooled):
    rng = np.random.RandomState(1)
    b, h, w, c = 2, 20, 30, 260
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(card)
    xy = rng.rand(b, 40, 2) * [w * 16, h * 16]
    wh = rng.rand(b, 40, 2) * 200
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, 0] = [0, 0, 0, 0]
    rois[:, 1] = [w * 16 - 2, h * 16 - 2, w * 16 + 50, h * 16 + 50]
    rois = torch.from_numpy(rois).to(card)
    valid_hw = torch.tensor([[200.0, 330.0], [h * 16, 150.0]], device=card) if with_valid_hw else None
    before = troi.kernel.launches
    got = troi.roi_align(feat, rois, pooled, 1.0 / 16, 2, valid_hw)
    assert troi.kernel.launches == before + 1
    ref = troi.roi_align_plain(feat, rois, pooled, 1.0 / 16, 2, valid_hw)
    assert float((got - ref).abs().max()) <= 1e-5


def test_roi_align_kernel_refuses_unaligned_channels(card):
    feat = torch.zeros((1, 4, 4, 6), device=card)
    rois = torch.zeros((1, 2, 4), device=card)
    with pytest.raises(ValueError):
        troi.roi_align(feat, rois, (7, 7))


@pytest.mark.parametrize("with_valid_hw", [False, True])
@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_roi_align_bwd_kernel_matches_plain(card, with_valid_hw, pooled):
    """Kernel 3 through autograd (RoIAlignFunction's backward) against the
    plain scatter-add.  Both sum with atomics in a run-dependent order, and
    a float32 sum's rounding grows with the sum of its terms' magnitudes:
    |Δ| ≤ 1e-4 · max(1, Σ|terms|), Σ|terms| being the plain backward of |g|
    (the weights are ≥ 0)."""
    rng = np.random.RandomState(2)
    b, h, w, c = 2, 20, 30, 260
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(card).requires_grad_()
    xy = rng.rand(b, 40, 2) * [w * 16, h * 16]
    wh = rng.rand(b, 40, 2) * 200
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, 0] = [0, 0, 0, 0]
    rois[:, 1] = [w * 16 - 2, h * 16 - 2, w * 16 + 50, h * 16 + 50]
    rois[:, 2] = [700, 500, 650, 450]
    rois = torch.from_numpy(rois).to(card)
    valid_hw = torch.tensor([[200.0, 330.0], [h * 16, 150.0]], device=card) if with_valid_hw else None
    g = torch.from_numpy(rng.randn(b, 40, *pooled, c).astype(np.float32)).to(card)
    fwd, bwd = troi.kernel.launches, troi.bwd_kernel.launches
    (troi.roi_align(feat, rois, pooled, 1.0 / 16, 2, valid_hw) * g).sum().backward()
    assert (troi.kernel.launches, troi.bwd_kernel.launches) == (fwd + 1, bwd + 1)
    ref = troi.roi_align_bwd_plain(g, rois, feat.shape, pooled, 1.0 / 16, 2, valid_hw)
    mag = troi.roi_align_bwd_plain(g.abs(), rois, feat.shape, pooled, 1.0 / 16, 2, valid_hw)
    assert float(((feat.grad - ref).abs() / mag.clamp_min(1.0)).max()) <= 1e-4


def test_roi_align_bwd_kernel_refuses_a_misshapen_cotangent(card):
    g = torch.zeros((1, 2, 7, 7, 8), device=card)
    rois = torch.zeros((1, 3, 4), device=card)
    with pytest.raises(ValueError):
        troi._roi_align_bwd_cuda(g, rois, (1, 4, 4, 8), (7, 7), 1.0 / 16, 2, None)
