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
from mx_rcnn_tpu_torch.ops import roi_align_stream as tstream

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


def _nms_plain_contract(boxes, scores, thresh):
    """``nms_mask``'s contract with the plain sweep, on the same device: the
    stable descending sort, the plain keep mask, scattered back."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    keep = tnms.nms_mask_sorted_plain(b, torch.ones_like(scores, dtype=torch.bool), thresh)
    return torch.zeros_like(keep).scatter(-1, order, keep)


def test_nms_kernel_at_the_fpn_union_shape(card):
    """One unsorted problem of 9504 boxes (the FPN train step's union of its
    levels' top-k) through ``nms_mask``, thousands of survivors, no stop."""
    from mx_rcnn_tpu_torch.tools.kernel_bench import fpn_union

    rng = np.random.RandomState(7)
    boxes = torch.from_numpy(fpn_union(rng)).to(card)
    scores = torch.from_numpy(rng.rand(1, boxes.shape[1]).astype(np.float32)).to(card)
    got = tnms.nms_mask(boxes, scores, 0.7)
    ref = _nms_plain_contract(boxes, scores, 0.7)
    assert int(ref.sum()) > 1000
    assert torch.equal(got, ref)


def _chunk0_survivors():
    """Sorted boxes whose greedy sweep keeps some but not all of the first
    64 rows, and the survivors' rows."""
    rng = np.random.RandomState(8)
    boxes = _boxes(rng, 1, 700, 200.0, 60.0)
    valid = torch.ones((1, 700), dtype=torch.bool)
    full = tnms.nms_mask_sorted_plain(boxes, valid, 0.5)
    return boxes, valid, torch.nonzero(full[0]).flatten()


@pytest.mark.parametrize("where", ["mid chunk", "chunk end", "next chunk's first", "past the last"])
def test_nms_kernel_stops_at_max_keep(card, where):
    """``max_keep`` reached inside a 64-box chunk, at the last survivor of a
    chunk, at the first of the next, and never: the first ``max_keep``
    survivors of the full sweep."""
    boxes, valid, surv = _chunk0_survivors()
    k64 = int((surv < 64).sum())
    assert 2 < k64 < 64
    max_keep = {"mid chunk": k64 - 2, "chunk end": k64, "next chunk's first": k64 + 1,
                "past the last": len(surv) + 5}[where]
    got = tnms.nms_mask_sorted(boxes.to(card), valid.to(card), 0.5, max_keep)
    ref = tnms.nms_mask_sorted_plain(boxes, valid, 0.5, max_keep)
    assert int(ref.sum()) == min(max_keep, len(surv))
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("case", ["N=1", "N=63", "N=64", "N=65", "all invalid",
                                  "all suppressed by the first", "P=40"])
def test_nms_kernel_edge_cases(card, case):
    rng = np.random.RandomState(9)
    n = int(case[2:]) if case.startswith("N=") else 300
    p = 40 if case == "P=40" else 1
    boxes = _boxes(rng, p, n, 300.0, 120.0)
    valid = torch.ones((p, n), dtype=torch.bool)
    if case == "all invalid":
        valid[:] = False
    if case == "all suppressed by the first":
        boxes[:, 0] = torch.tensor([0.0, 0.0, 1000.0, 1000.0])
        boxes[:, 1:] = torch.tensor([1.0, 1.0, 999.0, 999.0])
    got = tnms.nms_mask_sorted(boxes.to(card), valid.to(card), 0.3)
    ref = tnms.nms_mask_sorted_plain(boxes, valid, 0.3)
    if case == "all suppressed by the first":
        assert int(ref.sum()) == 1
    assert torch.equal(got.cpu(), ref)


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
    plain scatter-add.  The plain version sums with atomics in a
    run-dependent order, the kernel in its own fixed order, and a float32
    sum's rounding grows with the sum of its terms' magnitudes: |Δ| ≤ 1e-4 ·
    max(1, Σ|terms|), Σ|terms| being the plain backward of |g| (the weights
    are ≥ 0)."""
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


def _edge_rois(rng, b, r, h_img, w_img):
    """(b, r, 4) rois on an (h_img, w_img) canvas: random, then the edge
    cases of kernels 2 and 3's tap rule: the whole canvas, sub-cell, past
    the border, degenerate, inverted along x, along both axes and inside
    one cell, above and left of the map, and at the far corner."""
    xy = rng.rand(b, r, 2) * [w_img, h_img]
    wh = rng.rand(b, r, 2) * [w_img / 2, h_img / 2]
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, 0] = [0, 0, w_img - 1, h_img - 1]
    rois[:, 1] = [5, 5, 5.5, 5.5]
    rois[:, 2] = [w_img - 2, h_img - 2, w_img + 50, h_img + 50]
    rois[:, 3] = [0, 0, 0, 0]
    rois[:, 4] = [300, 40, 200, 90]
    rois[:, 5] = [100, 100, 60, 60]
    rois[:, 6] = [37, 41, 36, 40]
    rois[:, 7] = [-80, -60, -20, -10]
    rois[:, 8] = [w_img - 1, h_img - 1, w_img + 300, h_img + 300]
    return torch.from_numpy(rois)


# (b, h, w, c, rois, valid_hw): at the train path's width, C = 1024 with 128
# rois; and two images whose valid_hw clamps put lo == hi (ceil(100 / 16) =
# 7 < 9 rows, ceil(33 / 16) = 3 < 13 columns), pooled 7 on a small map
_RESIDENT_EDGE_CASES = {
    "C=1024, 128 rois, canvas": (1, 38, 64, 1024, 128, None),
    "C=1024, 128 rois, valid_hw": (1, 38, 64, 1024, 128, [[600.0, 800.0]]),
    "B=2, valid_hw lo == hi": (2, 9, 13, 8, 12, [[100.0, 130.0], [144.0, 33.0]]),
}


@pytest.mark.parametrize("case", list(_RESIDENT_EDGE_CASES))
def test_roi_align_kernels_at_the_edge_rois(card, case):
    """Kernel 2 against its plain version (max |Δ| ≤ 1e-5), kernel 3 against
    the plain scatter-add (|Δ| ≤ 1e-4 · max(1, Σ|terms|)) and bit-identical
    across two launches, on the edge rois."""
    b, h, w, c, r, vh = _RESIDENT_EDGE_CASES[case]
    rng = np.random.RandomState(12)
    pooled = (14, 14) if c == 1024 else (7, 7)
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(card)
    rois = _edge_rois(rng, b, r, h * 16.0, w * 16.0).to(card)
    valid_hw = None if vh is None else torch.tensor(vh, device=card)
    got = troi.roi_align(feat, rois, pooled, 1.0 / 16, 2, valid_hw)
    ref = troi.roi_align_plain(feat, rois, pooled, 1.0 / 16, 2, valid_hw)
    assert float((got - ref).abs().max()) <= 1e-5
    g = torch.from_numpy(rng.randn(b, r, *pooled, c).astype(np.float32)).to(card)
    shape = (b, h, w, c)
    dfeat = troi._roi_align_bwd_cuda(g, rois, shape, pooled, 1.0 / 16, 2, valid_hw)
    again = troi._roi_align_bwd_cuda(g, rois, shape, pooled, 1.0 / 16, 2, valid_hw)
    ref = troi.roi_align_bwd_plain(g, rois, shape, pooled, 1.0 / 16, 2, valid_hw)
    mag = troi.roi_align_bwd_plain(g.abs(), rois, shape, pooled, 1.0 / 16, 2, valid_hw)
    assert float(((dfeat - ref).abs() / mag.clamp_min(1.0)).max()) <= 1e-4
    assert torch.equal(dfeat, again)


def test_roi_align_bwd_kernel_writes_every_element(card):
    """Kernel 3's launcher on a dfeat buffer and a scratch pre-filled with
    NaN / garbage: the cells no roi reaches come back as exact zeros, the
    rest matches the plain version."""
    from mx_rcnn_tpu_torch.utils.cuda_build import ptr, stream_of

    rng = np.random.RandomState(13)
    b, h, w, c, pooled = 2, 30, 40, 1024, (7, 7)
    rois = torch.tensor([[[0.0, 0.0, 300.0, 200.0], [100.0, 60.0, 310.0, 230.0]],
                         [[16.0, 16.0, 100.0, 50.0], [50.0, 40.0, 20.0, 10.0]]], device=card)
    g = torch.from_numpy(rng.randn(b, 2, *pooled, c).astype(np.float32)).to(card)
    dfeat = torch.full((b, h, w, c), float("nan"), device=card)
    scratch = troi.bwd_scratch(b, h, w, 2, pooled, 2, card).fill_(0xA5)
    troi.bwd_kernel(ptr(g), ptr(rois), ptr(None), b, h, w, c, 2, *pooled, 2, 1.0 / 16,
                    ptr(scratch), ptr(dfeat), stream_of(g))
    torch.cuda.synchronize()
    assert not torch.isnan(dfeat).any()
    assert float(dfeat[:, 16:, 21:].abs().max()) == 0.0
    ref = troi.roi_align_bwd_plain(g, rois, (b, h, w, c), pooled, 1.0 / 16, 2)
    mag = troi.roi_align_bwd_plain(g.abs(), rois, (b, h, w, c), pooled, 1.0 / 16, 2)
    assert float(((dfeat - ref).abs() / mag.clamp_min(1.0)).max()) <= 1e-4


def _stream_rois(rng, b, r, h, w, scale):
    """Rois over a (h, w) map at ``scale``: random, the whole canvas,
    sub-cell, past the border, degenerate, inverted (x2 < x1) and fully off
    the map."""
    h_img, w_img = h / scale, w / scale
    xy = rng.rand(b, r, 2) * [w_img, h_img]
    wh = rng.rand(b, r, 2) * [w_img / 2, h_img / 2]
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, 0] = [0, 0, w_img - 1, h_img - 1]
    rois[:, 1] = [5, 5, 5.5, 5.5]
    rois[:, 2] = [w_img - 2, h_img - 2, w_img + 50, h_img + 50]
    rois[:, 3] = [0, 0, 0, 0]
    rois[:, 4] = [300, 40, 200, 90]
    rois[:, 5] = [-80, -60, -20, -10]
    return torch.from_numpy(rois)


@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_roi_align_stream_kernel_matches_plain(card, pooled):
    """Kernel 4 against its plain version (C = 260: a partial channel slice;
    inverted rois pool to zeros): max |Δ| ≤ 1e-5."""
    rng = np.random.RandomState(3)
    b, h, w, c = 2, 45, 61, 260
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(card)
    rois = _stream_rois(rng, b, 40, h, w, 0.25).to(card)
    before = tstream.fwd_kernel.launches
    got = tstream.roi_align_stream(feat, rois, pooled, 0.25, 2)
    assert tstream.fwd_kernel.launches == before + 1
    ref = tstream.roi_align_stream_plain(feat, rois, pooled, 0.25, 2)
    assert float((got - ref).abs().max()) <= 1e-5
    assert not got[:, 4].any()


@pytest.mark.parametrize("pooled", [(7, 7), (14, 14)])
def test_roi_align_stream_bwd_kernel_matches_plain_and_repeats(card, pooled):
    """Kernel 5 through autograd (RoIAlignStreamFunction's backward) against
    the plain scatter-add, |Δ| ≤ 1e-4 · max(1, Σ|terms|) (the plain version
    sums with atomics, in a run-dependent order); and two launches give
    bit-identical dfeat (no atomics, a fixed sum order)."""
    rng = np.random.RandomState(4)
    b, h, w, c = 2, 45, 61, 260
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(card).requires_grad_()
    rois = _stream_rois(rng, b, 40, h, w, 0.25).to(card)
    g = torch.from_numpy(rng.randn(b, 40, *pooled, c).astype(np.float32)).to(card)
    fwd, bwd = tstream.fwd_kernel.launches, tstream.bwd_kernel.launches
    (tstream.roi_align_stream(feat, rois, pooled, 0.25, 2) * g).sum().backward()
    assert (tstream.fwd_kernel.launches, tstream.bwd_kernel.launches) == (fwd + 1, bwd + 1)
    ref = tstream.roi_align_stream_bwd_plain(g, rois, feat.shape, pooled, 0.25, 2)
    mag = tstream.roi_align_stream_bwd_plain(g.abs(), rois, feat.shape, pooled, 0.25, 2)
    assert float(((feat.grad - ref).abs() / mag.clamp_min(1.0)).max()) <= 1e-4
    again = tstream._roi_align_stream_bwd_cuda(g, rois, feat.shape, pooled, 0.25, 2)
    assert torch.equal(again, feat.grad)


def test_roi_align_stream_kernels_refuse_bad_inputs(card):
    with pytest.raises(ValueError):
        tstream.roi_align_stream(torch.zeros((1, 4, 4, 6), device=card),
                                 torch.zeros((1, 2, 4), device=card), (7, 7))
    g = torch.zeros((1, 2, 7, 7, 8), device=card)
    with pytest.raises(ValueError):
        tstream._roi_align_stream_bwd_cuda(g, torch.zeros((1, 3, 4), device=card),
                                           (1, 4, 4, 8), (7, 7), 0.25, 2)
    with pytest.raises(ValueError):
        tstream._roi_align_stream_bwd_cuda(g, torch.zeros((1, 2, 4), device=card),
                                           (1, 4, 4, 6), (7, 7), 0.25, 2)


def _bwd_case(rng, case):
    """(g, rois, feat_shape, pooled) of one kernel 5 case, on the CPU."""
    b, h, w, c, r, pooled = 1, 40, 100, 64, 40, (7, 7)
    if case == "B=2, C=260":
        b, c = 2, 260
    if case == "pooled (14, 7)":
        pooled = (14, 7)
    if case == "R=300":
        r = 300
    rois = _stream_rois(rng, b, r, h, w, 0.25).numpy()
    if case == "tile edges":
        # rois across the edges of the tiles (2 x 8 cells): map rows 8k
        # and columns 16k are such edges
        for i in range(r):
            x, y = 16.0 * (1 + i % 5) - 0.5 - i % 3, 8.0 * (1 + i % 4) - 0.5
            rois[:, i] = np.array([x, y, x + 1.0 + i % 7, y + 1.0 + i % 5]) * 4.0
    if case == "tiny rois on one tile":
        xy = rng.rand(b, r, 2) * [12.0, 6.0]
        rois = np.concatenate([xy, xy + rng.rand(b, r, 2) * 2.0], -1).astype(np.float32) * 4.0
    g = rng.randn(b, r, *pooled, c).astype(np.float32)
    return torch.from_numpy(g), torch.from_numpy(rois.astype(np.float32)), (b, h, w, c), pooled


@pytest.mark.parametrize("case", ["tile edges", "tiny rois on one tile", "R=300", "pooled (14, 7)",
                                  "C=64", "B=2, C=260"])
def test_roi_align_stream_bwd_kernel_cases(card, case):
    """Kernel 5 against the plain scatter-add, |Δ| ≤ 1e-4 · max(1, Σ|terms|),
    and bit-identical across two launches."""
    g, rois, shape, pooled = _bwd_case(np.random.RandomState(10), case)
    g, rois = g.to(card), rois.to(card)
    got = tstream._roi_align_stream_bwd_cuda(g, rois, shape, pooled, 0.25, 2)
    again = tstream._roi_align_stream_bwd_cuda(g, rois, shape, pooled, 0.25, 2)
    ref = tstream.roi_align_stream_bwd_plain(g, rois, shape, pooled, 0.25, 2)
    mag = tstream.roi_align_stream_bwd_plain(g.abs(), rois, shape, pooled, 0.25, 2)
    assert float(((got - ref).abs() / mag.clamp_min(1.0)).max()) <= 1e-4
    assert torch.equal(got, again)


def test_roi_align_stream_bwd_kernel_writes_every_element(card):
    """The launcher on a dfeat buffer pre-filled with NaN: the region no roi
    reaches comes back zero, the rest matches the plain version."""
    from mx_rcnn_tpu_torch.utils.cuda_build import ptr, stream_of

    rng = np.random.RandomState(11)
    b, h, w, c, pooled = 1, 30, 40, 8, (7, 7)
    rois = torch.tensor([[[0.0, 0.0, 40.0, 30.0], [20.0, 8.0, 44.0, 36.0]]], device=card)
    g = torch.from_numpy(rng.randn(b, 2, *pooled, c).astype(np.float32)).to(card)
    dfeat = torch.full((b, h, w, c), float("nan"), device=card)
    scratch = tstream.bwd_scratch(b, h, w, 2, pooled, 2, card)
    tstream.bwd_kernel(ptr(g), ptr(rois), b, h, w, c, 2, *pooled, 2, 0.25, ptr(scratch), ptr(dfeat),
                       stream_of(g))
    torch.cuda.synchronize()
    assert not torch.isnan(dfeat).any()
    assert float(dfeat[:, 15:, 20:].abs().max()) == 0.0
    ref = tstream.roi_align_stream_bwd_plain(g, rois, (b, h, w, c), pooled, 0.25, 2)
    mag = tstream.roi_align_stream_bwd_plain(g.abs(), rois, (b, h, w, c), pooled, 0.25, 2)
    assert float(((dfeat - ref).abs() / mag.clamp_min(1.0)).max()) <= 1e-4


@pytest.mark.parametrize("pooled", [(7, 7), (14, 14), (7, 40)])
def test_roi_align_stream_kernel_is_exact(card, pooled):
    """Kernel 4 (the forward template under the streamed tap rule) against
    its plain version, bit for bit: max |Δ| = 0 (the kernel adds in the
    plain version's order), at a pooled width past the old limit of 32 too.
    The rois include the whole canvas, sub-cell, past the border,
    degenerate, inverted and off the map; the inverted ones come back
    exactly zero."""
    rng = np.random.RandomState(14)
    b, h, w, c = 2, 45, 61, 260
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(card)
    rois = _stream_rois(rng, b, 40, h, w, 0.25).to(card)
    before = tstream.fwd_kernel.launches
    got = tstream.roi_align_stream(feat, rois, pooled, 0.25, 2)
    assert tstream.fwd_kernel.launches == before + 1
    ref = tstream.roi_align_stream_plain(feat, rois, pooled, 0.25, 2)
    assert float((got - ref).abs().max()) == 0.0
    inverted = ~tstream.valid_rois(rois, 0.25)
    assert int(inverted.sum()) == 2
    assert torch.equal(got[inverted], torch.zeros_like(got[inverted]))


@pytest.mark.parametrize("s", [5, 6])
@pytest.mark.parametrize("kernel", ["2, canvas", "2, valid_hw", "4"])
def test_roi_align_forward_kernels_at_large_sample_ratios(card, kernel, s):
    """Kernels 2 (with and without valid_hw) and 4 at s > 4, the forward
    template's run-time instance, against their plain versions: max |Δ| ≤
    1e-5."""
    rng = np.random.RandomState(15)
    b, h, w, c = 2, 30, 40, 260
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(card)
    if kernel == "4":
        rois = _stream_rois(rng, b, 24, h, w, 0.25).to(card)
        got = tstream.roi_align_stream(feat, rois, (7, 7), 0.25, s)
        ref = tstream.roi_align_stream_plain(feat, rois, (7, 7), 0.25, s)
        assert not got[~tstream.valid_rois(rois, 0.25)].any()
    else:
        rois = _edge_rois(rng, b, 24, h * 16.0, w * 16.0).to(card)
        valid_hw = torch.tensor([[300.0, 500.0], [h * 16.0, 150.0]], device=card) \
            if kernel == "2, valid_hw" else None
        got = troi.roi_align(feat, rois, (7, 7), 1.0 / 16, s, valid_hw)
        ref = troi.roi_align_plain(feat, rois, (7, 7), 1.0 / 16, s, valid_hw)
    assert float((got - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("kernel", [3, 5])
def test_roi_align_backward_kernels_at_s5(card, kernel):
    """Kernels 3 and 5 (their tables take any s) at s = 5 against the plain
    scatter-add, |Δ| ≤ 1e-4 · max(1, Σ|terms|), and bit-identical across
    two launches."""
    rng = np.random.RandomState(16)
    b, h, w, c, pooled = 2, 30, 40, 260, (7, 7)
    if kernel == 3:
        rois = _edge_rois(rng, b, 24, h * 16.0, w * 16.0).to(card)
        run = lambda g: troi._roi_align_bwd_cuda(g, rois, (b, h, w, c), pooled, 1.0 / 16, 5, None)  # noqa: E731
        plain = lambda g: troi.roi_align_bwd_plain(g, rois, (b, h, w, c), pooled, 1.0 / 16, 5)  # noqa: E731
    else:
        rois = _stream_rois(rng, b, 24, h, w, 0.25).to(card)
        run = lambda g: tstream._roi_align_stream_bwd_cuda(g, rois, (b, h, w, c), pooled, 0.25, 5)  # noqa: E731
        plain = lambda g: tstream.roi_align_stream_bwd_plain(g, rois, (b, h, w, c), pooled, 0.25, 5)  # noqa: E731
    g = torch.from_numpy(rng.randn(b, 24, *pooled, c).astype(np.float32)).to(card)
    got, again = run(g), run(g)
    ref, mag = plain(g), plain(g.abs())
    assert float(((got - ref).abs() / mag.clamp_min(1.0)).max()) <= 1e-4
    assert torch.equal(got, again)


def test_roi_align_forward_kernels_refuse_a_zero_sample_ratio(card):
    feat = torch.zeros((1, 4, 4, 8), device=card)
    rois = torch.zeros((1, 2, 4), device=card)
    with pytest.raises(ValueError):
        troi.roi_align(feat, rois, (7, 7), 1.0 / 16, 0)
    with pytest.raises(ValueError):
        tstream.roi_align_stream(feat, rois, (7, 7), 0.25, 0)


def test_serving_engine_on_the_card_matches_detect_single(card):
    """The serving stack on the card: a small ResNet-50 C4 behind
    ``ServeRunner`` + ``ServingEngine``, each request's detections against
    ``detect_single`` on the card (same keep counts, scores within 1e-4,
    boxes within 1e-3 px: a padded batch of 2 against a batch of 1, cuDNN's
    choices per shape), NMS and kernel 2 launched by the served forwards,
    and no new signature after warmup."""
    import dataclasses

    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import Predictor
    from mx_rcnn_tpu_torch.models import build_model
    from mx_rcnn_tpu_torch.ops.postprocess import make_test_postprocess
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.serve.runner import ServeRunner, detect_single

    cfg = generate_config("resnet50", "PascalVOC")
    cfg = cfg.replace(
        SHAPE_BUCKETS=((96, 128), (128, 96)),
        dataset=dataclasses.replace(cfg.dataset, NUM_CLASSES=4, SCALES=((96, 128),)),
        TEST=dataclasses.replace(cfg.TEST, RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=32,
                                 SCORE_THRESH=0.05),
    )
    model = build_model(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in (model.rpn.rpn_cls_score, model.rpn.rpn_bbox_pred):
            layer.weight.mul_(1e-3)
    runner = ServeRunner(model, model.state_dict(), cfg, max_batch=2)
    assert runner.device.type == "cuda"
    assert runner.warmup() == 2
    pred = Predictor(model, make_test_postprocess(cfg, 4, 0.05, cfg.TEST.DET_PER_CLASS))
    rng = np.random.RandomState(0)
    images = [(rng.rand(h, w, 3) * 255).astype(np.uint8)
              for h, w in ((96, 128), (128, 96), (90, 120), (100, 80))]
    before = (tnms.kernel.launches, troi.kernel.launches)
    with ServingEngine(runner, max_linger=0.02, in_flight=2) as eng:
        futs = [eng.submit(im) for im in images]
        served = [f.result(timeout=300) for f in futs]
    assert tnms.kernel.launches > before[0] and troi.kernel.launches > before[1]
    assert runner.compile_cache.misses == 2
    for im, got in zip(images, served):
        ref = detect_single(pred, im, cfg, 4)
        for j in range(1, 4):
            g, r = got[j], ref[j]
            assert g.shape == r.shape
            g, r = g[np.argsort(-g[:, 4], kind="stable")], r[np.argsort(-r[:, 4], kind="stable")]
            np.testing.assert_allclose(g[:, 4], r[:, 4], atol=1e-4, rtol=0)
            np.testing.assert_allclose(g[:, :4], r[:, :4], atol=1e-3, rtol=0)
