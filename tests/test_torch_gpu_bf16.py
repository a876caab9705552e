"""The bf16 instances of the port's ROIAlign kernels (2–5) against their
plain PyTorch versions, on the card, and the wrappers' refusal of dtypes no
kernel is built for.  Marked ``gpu``; each test decides inside itself
whether a card is present and skips without one.  No JAX here, so on the
machine with the card they run without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py tests/test_torch_gpu_bf16.py
"""

import numpy as np
import pytest
import torch

from mx_rcnn_tpu_torch.ops import roi_align as troi
from mx_rcnn_tpu_torch.ops import roi_align_stream as tstream

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _stream_rois(rng, b, r, h, w, scale):
    """Rois over a (h, w) map at ``scale``: random, the whole canvas,
    sub-cell, past the border, degenerate and off the map."""
    h_img, w_img = h / scale, w / scale
    xy = rng.rand(b, r, 2) * [w_img, h_img]
    wh = rng.rand(b, r, 2) * [w_img / 2, h_img / 2]
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, 1] = [0, 0, w_img - 1, h_img - 1]
    rois[:, 2] = [5, 5, 5.5, 5.5]
    rois[:, 3] = [w_img - 2, h_img - 2, w_img + 50, h_img + 50]
    rois[:, 4] = [0, 0, 0, 0]
    rois[:, 5] = [-80, -60, -20, -10]
    return torch.from_numpy(rois)


@pytest.mark.parametrize("with_valid_hw", [False, True])
def test_bf16_roi_align_kernels_match_plain(card, with_valid_hw):
    """Kernels 2 and 3's bf16 instances through ``RoIAlignFunction`` on a
    bf16 map: a bf16 output equal to the plain version's (the same float32
    sums, rounded once), a bf16 gradient equal to the plain float32
    backward of the bf16 cotangent rounded once (the kernel's float32
    dfeat within the backward's float32 bar), only the bf16 counters moved."""
    rng = np.random.RandomState(3)
    b, h, w, c = 2, 20, 30, 260
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(card, torch.bfloat16)
    xy = rng.rand(b, 40, 2) * [w * 16, h * 16]
    rois = torch.from_numpy(np.concatenate([xy, xy + rng.rand(b, 40, 2) * 200], -1)
                            .astype(np.float32)).to(card)
    valid_hw = torch.tensor([[200.0, 330.0], [h * 16, 150.0]], device=card) if with_valid_hw else None
    counts = [k.launches for k in (troi.kernel, troi.bwd_kernel, troi.kernel_bf16,
                                   troi.bwd_kernel_bf16)]
    f = feat.clone().requires_grad_()
    got = troi.roi_align(f, rois, (14, 14), 1.0 / 16, 2, valid_hw)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, troi.roi_align_plain(feat, rois, (14, 14), 1.0 / 16, 2, valid_hw))
    g = torch.from_numpy(rng.randn(*got.shape).astype(np.float32)).to(card, torch.bfloat16)
    got.backward(g)
    after = [k.launches for k in (troi.kernel, troi.bwd_kernel, troi.kernel_bf16,
                                  troi.bwd_kernel_bf16)]
    assert [a - b for a, b in zip(after, counts)] == [0, 0, 1, 1]
    dfeat = troi._roi_align_bwd_cuda(g, rois, feat.shape, (14, 14), 1.0 / 16, 2, valid_hw)
    ref = troi.roi_align_bwd_plain(g, rois, feat.shape, (14, 14), 1.0 / 16, 2, valid_hw)
    mag = troi.roi_align_bwd_plain(g.abs(), rois, feat.shape, (14, 14), 1.0 / 16, 2, valid_hw)
    assert dfeat.dtype == torch.float32 and f.grad.dtype == torch.bfloat16
    assert float(((dfeat - ref).abs() / mag.clamp_min(1.0)).max()) <= 1e-4
    assert torch.equal(f.grad, dfeat.bfloat16())


def test_bf16_roi_align_stream_kernels_match_plain(card):
    """Kernels 4 and 5's bf16 instances: the forward equal to the plain
    version's (an inverted roi pools to zeros), the backward's float32
    dfeat within the float32 bar of the plain backward of the bf16
    cotangent and bit-identical across two launches."""
    rng = np.random.RandomState(4)
    feat = torch.from_numpy(rng.randn(1, 40, 100, 64).astype(np.float32)).to(card, torch.bfloat16)
    rois = _stream_rois(rng, 1, 40, 40, 100, 0.25).to(card)
    rois[0, 0] = torch.tensor([60.0, 20.0, 40.0, 50.0])
    got = tstream.roi_align_stream(feat, rois, (7, 7), 0.25, 2)
    assert got.dtype == torch.bfloat16 and not got[0, 0].any()
    assert torch.equal(got, tstream.roi_align_stream_plain(feat, rois, (7, 7), 0.25, 2))
    g = torch.from_numpy(rng.randn(*got.shape).astype(np.float32)).to(card, torch.bfloat16)
    dfeat = tstream._roi_align_stream_bwd_cuda(g, rois, feat.shape, (7, 7), 0.25, 2)
    again = tstream._roi_align_stream_bwd_cuda(g, rois, feat.shape, (7, 7), 0.25, 2)
    ref = tstream.roi_align_stream_bwd_plain(g, rois, feat.shape, (7, 7), 0.25, 2)
    mag = tstream.roi_align_stream_bwd_plain(g.abs(), rois, feat.shape, (7, 7), 0.25, 2)
    assert dfeat.dtype == torch.float32 and torch.equal(dfeat, again)
    assert float(((dfeat - ref).abs() / mag.clamp_min(1.0)).max()) <= 1e-4


def test_kernels_take_only_the_dtypes_they_are_built_for(card):
    """No wrapper converts a dtype: a float16 map and float64 rois raise."""
    rois = torch.zeros((1, 2, 4), device=card)
    with pytest.raises(TypeError):
        troi.roi_align(torch.zeros((1, 4, 4, 8), device=card, dtype=torch.float16), rois, (7, 7))
    with pytest.raises(TypeError):
        tstream.roi_align_stream(torch.zeros((1, 4, 4, 8), device=card), rois.double(), (7, 7))
