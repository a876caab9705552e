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


def exact_order(feat, rois, pooled, scale, s, valid_hw=None, stream=False):
    """The forwards' arithmetic spelled out on the card: per sample the y
    lerps at both x taps, the x lerp, the sum with the sample rows outer,
    then / s² (true division: a device tensor), rounded once to bf16; no op
    fuses another (each is its own PyTorch call)."""
    b, h, w, c = feat.shape
    ph, pw = pooled
    (ylo, yhi, wy0, wy1), (xlo, xhi, wx0, wx1) = troi._roi_taps(rois, h, w, pooled, scale, s,
                                                                 valid_hw)
    f = feat.float()
    out = torch.empty((b, rois.shape[1], ph, pw, c), dtype=torch.bfloat16, device=feat.device)
    for i in range(b):
        acc = torch.zeros((rois.shape[1], ph, pw, c), device=feat.device)
        for iy in range(s):
            yl, yh = ylo[i][:, iy::s, None], yhi[i][:, iy::s, None]
            a0, a1 = wy0[i][:, iy::s, None, None], wy1[i][:, iy::s, None, None]
            for ix in range(s):
                xl, xh = xlo[i][:, None, ix::s], xhi[i][:, None, ix::s]
                lo = f[i][yl, xl] * a0 + f[i][yh, xl] * a1
                hi = f[i][yl, xh] * a0 + f[i][yh, xh] * a1
                acc = acc + (lo * wx0[i][:, None, ix::s, None] + hi * wx1[i][:, None, ix::s, None])
        out[i] = (acc / torch.tensor(float(s * s), device=feat.device)).bfloat16()
    if stream:
        keep = tstream.valid_rois(rois, scale)[..., None, None, None]
        out = torch.where(keep, out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out


# (label, stream?, (b, h, w, c), r, pooled, s, valid_hw?): the path's widths
# (1024, 256) at a one-wave roi count and a small one, C % 8 == 4 (8-byte
# lanes), s = 1..5 (5: the run-time instance), pooled 7 and 15 (three row
# groups), R = 0
BF16_FWD_CASES = [
    ("C4 1024", False, (1, 38, 64, 1024), 128, (14, 14), 2, True),
    ("P2 256 stream", True, (1, 152, 256, 256), 128, (14, 14), 2, False),
    ("P4 256 few rois", False, (1, 38, 64, 256), 9, (14, 14), 2, False),
    ("C % 8 == 4", False, (2, 20, 30, 260), 40, (14, 14), 2, True),
    ("stream C % 8 == 4", True, (1, 40, 100, 68), 40, (7, 7), 2, False),
    ("s = 1", True, (2, 24, 40, 128), 20, (14, 14), 1, False),
    ("s = 3", False, (2, 24, 40, 128), 20, (14, 14), 3, True),
    ("s = 4", True, (1, 24, 40, 264), 20, (7, 7), 4, False),
    ("s = 5", False, (2, 24, 40, 136), 20, (14, 14), 5, True),
    ("s = 5 stream", True, (1, 24, 40, 128), 20, (7, 7), 5, False),
    ("pooled 15", False, (1, 24, 40, 64), 12, (15, 9), 2, False),
    ("R = 0", True, (1, 12, 20, 128), 0, (14, 14), 2, False),
]


@pytest.mark.parametrize("case", BF16_FWD_CASES, ids=[c[0] for c in BF16_FWD_CASES])
def test_bf16_forwards_match_plain(card, case):
    """Kernels 2 and 4 on bf16 maps: bit for bit the exact-order arithmetic
    at every s, torch.equal to the plain versions at s = 1, 2 (their mean
    sums as the kernels do there) and within chip_smoke.py's bar at the
    other s (1e-5, then one bf16 ulp: their mean sums in another order),
    two launches bit-identical, inverted rois zeros under kernel 4's rule,
    the launch plan the library's, only the bf16 forward's counter moved."""
    _, stream, shape, r, pooled, s, with_valid = case
    b, h, w, c = shape
    scale = 0.25 if stream else 1.0 / 16
    rng = np.random.RandomState(sum(shape) + r + s)
    feat = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(card, torch.bfloat16)
    rois = (_bwd_rois(rng, b, max(r, 9), h, w, scale)[:, :r]).to(card)
    valid_hw = None
    if with_valid:
        valid_hw = torch.tensor([[h / scale * 0.7, w / scale * 0.9]] * b, device=card)
    assert troi.fwd_bf16_plan_of_library(b, h, w, c, r, pooled, s) == troi.fwd_bf16_plan(
        b, h, w, c, r, pooled, s)
    kernels = (troi.kernel, troi.kernel_bf16, tstream.fwd_kernel, tstream.fwd_kernel_bf16)
    before = [k.launches for k in kernels]
    if stream:
        got = tstream.roi_align_stream(feat, rois, pooled, scale, s)
        again = tstream.roi_align_stream(feat, rois, pooled, scale, s)
        plain = tstream.roi_align_stream_plain(feat, rois, pooled, scale, s)
    else:
        got = troi.roi_align(feat, rois, pooled, scale, s, valid_hw)
        again = troi.roi_align(feat, rois, pooled, scale, s, valid_hw)
        plain = troi.roi_align_plain(feat, rois, pooled, scale, s, valid_hw)
    torch.cuda.synchronize()
    moved = [k.launches - n for k, n in zip(kernels, before)]
    assert moved == ([0, 0, 0, 2] if stream else [0, 2, 0, 0])
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    assert torch.equal(got, exact_order(feat, rois, pooled, scale, s, valid_hw, stream))
    if s <= 2:
        assert torch.equal(got, plain)
    else:  # beyond float32's bar, one bf16 ulp of the larger magnitude (BF16_FWD_ULPS)
        ulp = 2.0 ** -7 * torch.maximum(got.float().abs(), plain.float().abs()).clamp_min(
            2.0 ** -126)
        assert ((got.float() - plain.float()).abs() - 1e-5 <= ulp).all()
    if stream and r > 6:
        assert not got[:, 6].any()  # the inverted roi


def test_kernels_take_only_the_dtypes_they_are_built_for(card):
    """No wrapper converts a dtype: a float16 map and float64 rois raise."""
    rois = torch.zeros((1, 2, 4), device=card)
    with pytest.raises(TypeError):
        troi.roi_align(torch.zeros((1, 4, 4, 8), device=card, dtype=torch.float16), rois, (7, 7))
    with pytest.raises(TypeError):
        tstream.roi_align_stream(torch.zeros((1, 4, 4, 8), device=card), rois.double(), (7, 7))
