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
    dfeat = troi._roi_align_bwd_cuda(g, rois, feat.shape, (14, 14), 1.0 / 16, 2, valid_hw,
                                     f32_sum=True)
    ref = troi.roi_align_bwd_plain(g, rois, feat.shape, (14, 14), 1.0 / 16, 2, valid_hw)
    mag = troi.roi_align_bwd_plain(g.abs(), rois, feat.shape, (14, 14), 1.0 / 16, 2, valid_hw)
    assert dfeat.dtype == torch.float32 and f.grad.dtype == torch.bfloat16
    assert float(((dfeat - ref).abs() / mag.clamp_min(1.0)).max()) <= 1e-4
    assert torch.equal(f.grad, dfeat.bfloat16())


def test_bf16_roi_align_stream_kernels_match_plain(card):
    """Kernels 4 and 5's bf16 instances: the forward equal to the plain
    version's (an inverted roi pools to zeros), the backward's float32
    epilogue within the float32 bar of the plain backward of the bf16
    cotangent and bit-identical across two launches, the path's bf16
    dfeat its rounding."""
    rng = np.random.RandomState(4)
    feat = torch.from_numpy(rng.randn(1, 40, 100, 64).astype(np.float32)).to(card, torch.bfloat16)
    rois = _stream_rois(rng, 1, 40, 40, 100, 0.25).to(card)
    rois[0, 0] = torch.tensor([60.0, 20.0, 40.0, 50.0])
    got = tstream.roi_align_stream(feat, rois, (7, 7), 0.25, 2)
    assert got.dtype == torch.bfloat16 and not got[0, 0].any()
    assert torch.equal(got, tstream.roi_align_stream_plain(feat, rois, (7, 7), 0.25, 2))
    g = torch.from_numpy(rng.randn(*got.shape).astype(np.float32)).to(card, torch.bfloat16)
    dfeat = tstream._roi_align_stream_bwd_cuda(g, rois, feat.shape, (7, 7), 0.25, 2, f32_sum=True)
    again = tstream._roi_align_stream_bwd_cuda(g, rois, feat.shape, (7, 7), 0.25, 2, f32_sum=True)
    ref = tstream.roi_align_stream_bwd_plain(g, rois, feat.shape, (7, 7), 0.25, 2)
    mag = tstream.roi_align_stream_bwd_plain(g.abs(), rois, feat.shape, (7, 7), 0.25, 2)
    assert dfeat.dtype == torch.float32 and torch.equal(dfeat, again)
    assert float(((dfeat - ref).abs() / mag.clamp_min(1.0)).max()) <= 1e-4
    path = tstream._roi_align_stream_bwd_cuda(g, rois, feat.shape, (7, 7), 0.25, 2)
    assert path.dtype == torch.bfloat16 and torch.equal(path, dfeat.bfloat16())


def _bwd_rois(rng, b, r, h, w, scale):
    """``_stream_rois`` plus an inverted roi, one wholly off the canvas and
    one on the map's last cells (r >= 9)."""
    rois = _stream_rois(rng, b, r, h, w, scale).numpy()
    h_img, w_img = h / scale, w / scale
    rois[:, 6] = [w_img * 0.6, h_img * 0.5, w_img * 0.3, h_img * 0.7]
    rois[:, 7] = [w_img + 40, h_img + 40, w_img + 90, h_img + 80]
    rois[:, 8] = [w_img - 3, h_img - 3, w_img - 1, h_img - 1]
    return torch.from_numpy(rois)


# (label, stream?, (b, h, w, c), r, pooled, s, valid_hw?): the path shapes
# (C4 1024 channels, FPN 256; R = 128 and the mask branch's 32), C % 8 != 0
# (the producer's plain copies), s = 5, pooled 7, R = 0, C > 1024 (two channel
# groups a tile) and a map so small that clusters of 8 blocks share each tile
BF16_BWD_CASES = [
    ("C4 train", False, (1, 38, 64, 1024), 128, (14, 14), 2, False),
    ("C4 train valid_hw", False, (1, 38, 64, 1024), 128, (14, 14), 2, True),
    ("P4 mask branch", False, (1, 38, 64, 256), 32, (14, 14), 2, False),
    ("P2", True, (1, 152, 256, 256), 128, (14, 14), 2, False),
    ("P3 mask branch", True, (1, 76, 128, 256), 32, (14, 14), 2, False),
    ("C % 8 == 4", False, (2, 20, 30, 260), 40, (14, 14), 2, True),
    ("stream C % 8 == 4", True, (1, 40, 100, 68), 40, (7, 7), 2, False),
    ("s = 5", True, (2, 24, 40, 128), 20, (14, 14), 5, False),
    ("pooled 7", False, (2, 24, 40, 512), 20, (7, 7), 3, True),
    ("R = 0", False, (1, 12, 20, 128), 0, (14, 14), 2, False),
    ("C > 1024", False, (1, 12, 20, 1280), 16, (7, 7), 2, True),
    ("tiny map", True, (1, 5, 7, 64), 12, (14, 14), 2, False),
]


@pytest.mark.parametrize("case", BF16_BWD_CASES, ids=[c[0] for c in BF16_BWD_CASES])
def test_bf16_backward_epilogues_match_plain(card, case):
    """Kernels 3 and 5 on a bf16 g: the float32 epilogue within the float32
    bar of the plain backward of the same g, the path's bf16 dfeat its
    round-to-nearest-even bit for bit, two launches of each bit-identical,
    zeros where no roi taps, the path counter moved once a call and the
    float32 epilogue's only by the gate calls."""
    _, stream, shape, r, pooled, s, with_valid = case
    b, h, w, c = shape
    scale = 0.25 if stream else 1.0 / 16
    rng = np.random.RandomState(sum(shape) + r)
    rois = (_bwd_rois(rng, b, max(r, 9), h, w, scale)[:, :r]).to(card)
    g = torch.from_numpy(rng.randn(b, r, *pooled, c).astype(np.float32)).to(card, torch.bfloat16)
    valid_hw = None
    if with_valid:
        valid_hw = torch.tensor([[h / scale * 0.7, w / scale * 0.9]] * b, device=card)
    if stream:
        mod = tstream

        def run(**kw):
            return tstream._roi_align_stream_bwd_cuda(g, rois, shape, pooled, scale, s, **kw)

        def plain(gg):
            return tstream.roi_align_stream_bwd_plain(gg, rois, shape, pooled, scale, s)
    else:
        mod = troi

        def run(**kw):
            return troi._roi_align_bwd_cuda(g, rois, shape, pooled, scale, s, valid_hw, **kw)

        def plain(gg):
            return troi.roi_align_bwd_plain(gg, rois, shape, pooled, scale, s, valid_hw)
    before = (mod.bwd_kernel_bf16.launches, mod.bwd_kernel_bf16_f32.launches)
    f32, f32_again = run(f32_sum=True), run(f32_sum=True)
    path, path_again = run(), run()
    torch.cuda.synchronize()
    assert (mod.bwd_kernel_bf16.launches - before[0],
            mod.bwd_kernel_bf16_f32.launches - before[1]) == (2, 2)
    assert f32.dtype == torch.float32 and path.dtype == torch.bfloat16
    ref, mag = plain(g), plain(g.abs())
    assert float(((f32 - ref).abs() / mag.clamp_min(1.0)).max()) <= 1e-4
    assert torch.equal(f32, f32_again) and torch.equal(path, path_again)
    assert torch.equal(path, f32.bfloat16())
    assert not f32[mag == 0].any()


def test_bf16_backward_launches_no_cast(card):
    """Autograd through both functions on bf16 maps runs only the backward
    kernels (their table and tile launches): no dtype cast after them."""
    rng = np.random.RandomState(6)
    feat = torch.from_numpy(rng.randn(1, 40, 100, 256).astype(np.float32)).to(card, torch.bfloat16)
    rois = _bwd_rois(rng, 1, 24, 40, 100, 0.25).to(card)
    for fn in (tstream.roi_align_stream, troi.roi_align):
        f = feat.clone().requires_grad_()
        out = fn(f, rois, (7, 7), 0.25, 2)
        g = torch.ones_like(out)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            out.backward(g)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if e.device_type.name == "CUDA"}
        assert f.grad.dtype == torch.bfloat16
        assert names and all("roi_table_kernel" in n or "roi_align_stage_bwd_kernel" in n
                             for n in names), names


def test_kernels_take_only_the_dtypes_they_are_built_for(card):
    """No wrapper converts a dtype: a float16 map and float64 rois raise."""
    rois = torch.zeros((1, 2, 4), device=card)
    with pytest.raises(TypeError):
        troi.roi_align(torch.zeros((1, 4, 4, 8), device=card, dtype=torch.float16), rois, (7, 7))
    with pytest.raises(TypeError):
        tstream.roi_align_stream(torch.zeros((1, 4, 4, 8), device=card), rois.double(), (7, 7))
