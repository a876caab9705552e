"""The bf16 ROIAlign forwards (kernels 2 and 4 on bf16 maps,
``csrc/roi_align_fwd_bf16.cuh``), emulated in numpy on the CPU, where the
CUDA kernel cannot run.

The emulation follows the kernel block by block as its launch plan
(``ops/roi_align.py::fwd_bf16_plan``) lays the blocks out: a block takes an
(image, roi, channel slice, group of rows), a warp one output row, a lane one
vector of 8 channels (4 where C % 8 == 4).  Warp 0's layout of the roi's
sample columns is repeated with its 32-lane prefix sums and the carry between
chunks; each row walks the distinct columns in order, keeping the sample
rows' y lerps of the last two columns, and sums each bin's x lerps with the
sample rows outer.  Every operation is one float32 rounding, as on the card
(the build contracts nothing into FMAs); the output rounds to bf16 once.

It is held bit for bit against an exact-order reference (y lerp at both x
taps, x lerp, the sum sample rows outer, / s²: what the float32 template of
``csrc/roi_align_fwd.cuh`` computes), against the port's plain versions with
``torch.equal`` at s = 1 (one sample a bin) and within one bf16 ulp at the
other ratios (on the CPU their mean sums the samples in pairs,
(x00 + x01) + (x10 + x11) at s = 2; the card's plain version sums as the
kernel does at s = 2, and ``tests/test_torch_gpu_bf16.py`` holds the kernels
to it with ``torch.equal``), and against the JAX package's Pallas forwards in
interpret mode on bf16 maps within ROADMAP rule 6's 0.05 (its bf16 branch
rounds weights and row sums to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.ops.pallas import roi_align as j_resident
from mx_rcnn_tpu.ops.pallas import roi_align_stream as j_stream
from mx_rcnn_tpu_torch.ops import roi_align as troi
from mx_rcnn_tpu_torch.ops import roi_align_stream as tstream

F = np.float32
LANES = 32


# ------------------------------------------------------------ the taps
def axis_taps(c1, c2, nbins, s, lim_f, size):
    """Each sample's (lo, hi, w_lo, w_hi) along one axis, as sample_tap
    (roi_align_taps.cuh) computes them in float32."""
    bin_sz = F(max(F(c2 - c1), F(1.0)) / F(nbins))
    lim_i = int(lim_f)
    taps = []
    for k in range(nbins * s):
        g = F(c1 + F(F(F(k) + F(0.5)) / F(s)) * bin_sz)
        g = F(min(max(g, F(0.0)), F(lim_f - F(1.0))))
        lo_f = F(np.floor(g))
        lo = int(lo_f)
        hi = min(lo + 1, lim_i - 1)
        w_hi = F(g - lo_f)
        taps.append((max(0, min(lo, size - 1)), max(0, min(hi, size - 1)), F(F(1.0) - w_hi), w_hi))
    return taps


def limits(valid_hw, i, scale, h, w):
    if valid_hw is None:
        return F(h), F(w)
    return (F(min(np.ceil(F(F(valid_hw[i][0]) * F(scale))), F(h))),
            F(min(np.ceil(F(F(valid_hw[i][1]) * F(scale))), F(w))))


def scaled(roi, scale):
    return [F(F(v) * F(scale)) for v in roi]


def x_schedule(taps):
    """Warp 0's layout: (cols, steps), steps[k] = (need, two, w_lo, w_hi),
    by 32-lane chunks with the kernel's prefix sums and carry."""
    cols, steps = [], []
    count, last_hi = 0, -1
    for base in range(0, len(taps), LANES):
        chunk = taps[base:base + LANES]
        prev = [last_hi] + [t[1] for t in chunk[:-1]]
        n = [int(t[0] > p) + int(t[1] > t[0] and t[1] > p) for t, p in zip(chunk, prev)]
        incl = np.cumsum(n)
        for t, p, nk, ik in zip(chunk, prev, n, incl):
            lo_new = t[0] > p
            pos = count + ik - nk
            if lo_new:
                assert len(cols) == pos
                cols.append(t[0])
            if t[1] > t[0] and t[1] > p:
                assert len(cols) == pos + lo_new
                cols.append(t[1])
            steps.append((count + int(ik) - 1, int(t[1] != t[0]), t[2], t[3]))
        count += int(incl[-1])
        last_hi = chunk[-1][1]
    return cols, steps


# ------------------------------------------------------------ the walk
def emulate(feat, rois, pooled, scale, s, valid_hw=None, stream=False, coverage=None):
    """The kernel's bf16 output (B, R, PH, PW, C) as uint16 bits."""
    feat = np.asarray(torch.as_tensor(feat).float(), F)
    rois = np.asarray(rois, F)
    b, h, w, c = feat.shape
    r = rois.shape[1]
    ph_n, pw_n = pooled
    plan = troi.fwd_bf16_plan(b, h, w, c, r, pooled, s)
    kch = plan["vec_bytes"] // 2
    cv = c // kch
    out = np.full((b, r, ph_n, pw_n, c), np.nan, F)
    for i in range(b):
        lim_h, lim_w = limits(valid_hw, i, scale, h, w)
        for k in range(r):
            x1, y1, x2, y2 = scaled(rois[i, k], scale)
            inverted = stream and not (x2 >= x1)
            xt = axis_taps(x1, x2, pw_n, s, lim_w, w)
            yt = axis_taps(y1, y2, ph_n, s, lim_h, h)
            cols, steps = x_schedule(xt)
            for sl in range(plan["slices"]):
                vecs = [v for v in range(sl * LANES, (sl + 1) * LANES) if v < cv]
                ch = np.concatenate([np.arange(v * kch, (v + 1) * kch) for v in vecs])
                for g in range(plan["groups"]):
                    for warp in range(plan["warps"]):
                        ph = g * plan["warps"] + warp
                        if ph >= ph_n:
                            continue
                        if coverage is not None:
                            coverage[i, k, ph][:, ch] += 1
                        if inverted:
                            out[i, k, ph][:, ch] = 0.0
                            continue
                        rows = yt[ph * s:(ph + 1) * s]
                        if s > troi.FWD_BF16_MAX_S:
                            out[i, k, ph][:, ch] = _walk_any_s(feat[i][..., ch], rows, xt, pw_n, s)
                        else:
                            out[i, k, ph][:, ch] = _walk(feat[i][..., ch], rows, cols, steps,
                                                         pw_n, s)
    return bf16_bits(out)


def _walk(f, rows, cols, steps, pw_n, s):
    """One warp's row: the column walk, (PW, lanes' channels) float32."""
    v = [None, None]  # the y lerps of the even and the odd columns
    j = -1
    res = []
    for pw in range(pw_n):
        acc = np.zeros(f.shape[-1], F)
        held = {}
        for ix in range(s):
            need, two, wl, wh = steps[pw * s + ix]
            while j < need:
                j += 1
                x = cols[j]
                v[j & 1] = [f[lo, x] * ty_lo + f[hi, x] * ty_hi for lo, hi, ty_lo, ty_hi in rows]
            hi_v = v[j & 1]
            lo_v = v[(j - 1) & 1] if two else hi_v
            xl = [lo_v[iy] * wl + hi_v[iy] * wh for iy in range(s)]
            acc = acc + xl[0]
            if ix < s - 1:
                for iy in range(1, s):
                    held[iy, ix] = xl[iy]
            else:
                for iy in range(1, s):
                    for i2 in range(s - 1):
                        acc = acc + held[iy, i2]
                    acc = acc + xl[iy]
        res.append(acc / F(s * s))
    return np.stack(res)


def _walk_any_s(f, rows, xt, pw_n, s):
    """The run-time instance's row: each sample's 4 cells, the same order."""
    res = []
    for pw in range(pw_n):
        acc = np.zeros(f.shape[-1], F)
        for lo_y, hi_y, wyl, wyh in rows:
            for ix in range(s):
                lo_x, hi_x, wxl, wxh = xt[pw * s + ix]
                lo = f[lo_y, lo_x] * wyl + f[hi_y, lo_x] * wyh
                hi = f[lo_y, hi_x] * wyl + f[hi_y, hi_x] * wyh
                acc = acc + (lo * wxl + hi * wxh)
        res.append(acc / F(s * s))
    return np.stack(res)


def exact_order(feat, rois, pooled, scale, s, valid_hw=None, stream=False):
    """The float32 template's arithmetic, sample by sample, as bf16 bits."""
    feat = np.asarray(torch.as_tensor(feat).float(), F)
    rois = np.asarray(rois, F)
    b, h, w, c = feat.shape
    r = rois.shape[1]
    out = np.zeros((b, r) + tuple(pooled) + (c,), F)
    for i in range(b):
        lim_h, lim_w = limits(valid_hw, i, scale, h, w)
        for k in range(r):
            x1, y1, x2, y2 = scaled(rois[i, k], scale)
            if stream and not (x2 >= x1):
                continue
            xt = axis_taps(x1, x2, pooled[1], s, lim_w, w)
            yt = axis_taps(y1, y2, pooled[0], s, lim_h, h)
            for ph in range(pooled[0]):
                out[i, k, ph] = _walk_any_s(feat[i], yt[ph * s:(ph + 1) * s], xt, pooled[1], s)
    return bf16_bits(out)


def bf16_bits(v):
    """float32 → bf16 bits, round to nearest even (torch's rounding)."""
    return torch.from_numpy(np.ascontiguousarray(v, F)).bfloat16().view(torch.int16).numpy().view(
        np.uint16)


def bits(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


# ------------------------------------------------------------ the cases
def case_rois(rng, b, r, h, w, scale):
    """Random rois plus the edge cases: the whole canvas, sub-cell, past the
    border, degenerate, off the canvas, inverted, wholly past the canvas,
    narrower than a cell (every sample in two columns)."""
    h_img, w_img = h / scale, w / scale
    xy = rng.rand(b, r, 2) * [w_img, h_img]
    wh = rng.rand(b, r, 2) * [w_img * 0.8, h_img * 0.8]
    rois = np.concatenate([xy, xy + wh], -1).astype(F)
    edge = [[0, 0, w_img - 1, h_img - 1], [5, 5, 5.5, 5.5],
            [w_img - 2, h_img - 2, w_img + 50, h_img + 50], [0, 0, 0, 0],
            [-80, -60, -20, -10], [w_img * 0.6, h_img * 0.5, w_img * 0.3, h_img * 0.7],
            [w_img + 40, h_img + 40, w_img + 90, h_img + 80],
            [w_img * 0.3, h_img * 0.3, w_img * 0.3 + 0.4 / scale, h_img * 0.5]]
    n = min(r, len(edge))
    rois[:, :n] = np.asarray(edge[:n], F)
    return rois


def make_case(seed, b, r, h, w, c, scale):
    rng = np.random.RandomState(seed)
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(F)).bfloat16()
    return feat, case_rois(rng, b, r, h, w, scale)


VALID_HW = [[150.0, 170.0], [96.0, 60.0]]

# (seed, b, r, h, w, c, pooled, s): C % 8 == 0 and == 4, one and several
# slices, 7x7 and 14x14 (two row groups), s = 1..5 (5: the run-time instance)
CASES = [
    (0, 2, 10, 9, 13, 8, (14, 14), 2),
    (1, 1, 9, 10, 12, 12, (7, 7), 2),
    (2, 1, 9, 8, 11, 36, (7, 7), 1),
    (3, 1, 9, 10, 12, 260, (7, 7), 2),
    (4, 1, 9, 10, 12, 8, (14, 14), 3),
    (5, 1, 9, 10, 12, 12, (7, 7), 4),
    (6, 1, 9, 10, 12, 8, (7, 7), 5),
]
IDS = ["c8-14x14", "c12", "c36-s1", "c260", "s3", "c12-s4", "s5"]


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_walk_is_the_exact_order_bit_for_bit(case, stream):
    """The walk by column (or the run-time instance past s = 4) gives the
    float32 template's bits under both tap rules, every output written once
    by the plan's blocks, inverted rois zeros under kernel 4's rule."""
    seed, b, r, h, w, c, pooled, s = case
    scale = 0.25 if stream else 1.0 / 16
    feat, rois = make_case(seed, b, r, h, w, c, scale)
    cover = np.zeros((b, r) + pooled + (c,), np.int32)
    got = emulate(feat, rois, pooled, scale, s, stream=stream, coverage=cover)
    assert (cover == 1).all()
    assert np.array_equal(got, exact_order(feat, rois, pooled, scale, s, stream=stream))
    if stream:
        assert not got[:, 5].any()  # the inverted roi
    else:
        assert got[:, 5].any()  # it taps the cells at its clamped x1 / y1


def test_valid_hw_clamp_bit_for_bit():
    """Kernel 2's valid_hw clamp (lo == hi at the clamped edge)."""
    feat, rois = make_case(7, 2, 10, 9, 13, 12, 1.0 / 16)
    for s in (2, 3):
        got = emulate(feat, rois, (7, 7), 1.0 / 16, s, VALID_HW)
        assert np.array_equal(got, exact_order(feat, rois, (7, 7), 1.0 / 16, s, VALID_HW))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_walk_against_the_port_plain_versions(case):
    """torch.equal to roi_align_plain / roi_align_stream_plain at s = 1;
    within one bf16 ulp of them at the other sample ratios, where their
    mean sums the float32 samples in another order."""
    seed, b, r, h, w, c, pooled, s = case
    for stream in (False, True):
        scale = 0.25 if stream else 1.0 / 16
        feat, rois = make_case(seed + 20, b, r, h, w, c, scale)
        valid_hw = None if stream else torch.tensor(VALID_HW[:b])
        got = emulate(feat, rois, pooled, scale, s, valid_hw, stream=stream)
        if stream:
            plain = tstream.roi_align_stream_plain(feat, torch.from_numpy(rois), pooled, scale, s)
        else:
            plain = troi.roi_align_plain(feat, torch.from_numpy(rois), pooled, scale, s, valid_hw)
        if s == 1:
            assert torch.equal(torch.from_numpy(got.view(np.int16)).view(torch.bfloat16), plain)
        else:  # beyond float32's bar, one bf16 ulp of the larger magnitude
            g = torch.from_numpy(got.view(np.int16)).view(torch.bfloat16).float()
            ulp = 2.0 ** -7 * torch.maximum(g.abs(), plain.float().abs()).clamp_min(2.0 ** -126)
            assert ((g - plain.float()).abs() - 1e-5 <= ulp).all()


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[3], CASES[6]],
                         ids=["c8-14x14", "c12", "c260", "s5"])
def test_walk_against_the_jax_pallas_forwards(case):
    """Against _roi_align_fwd_impl and the streamed _fwd_impl (interpret
    mode) on bf16 maps, within ROADMAP rule 6's 0.05."""
    seed, b, r, h, w, c, pooled, s = case
    for stream, impl in ((False, j_resident._roi_align_fwd_impl), (True, j_stream._fwd_impl)):
        scale = 0.25 if stream else 1.0 / 16
        feat, rois = make_case(seed + 40, b, r, h, w, c, scale)
        got = emulate(feat, rois, pooled, scale, s, stream=stream)
        ref = np.asarray(impl(jnp.asarray(feat.float().numpy(), jnp.bfloat16), jnp.asarray(rois),
                              pooled, scale, s, True).astype(jnp.float32), F)
        g = torch.from_numpy(got.view(np.int16)).view(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(g, ref, rtol=0.05, atol=0.05)


def test_r0_and_off_canvas_rois():
    """R = 0 launches no block; rois wholly past the canvas clamp every
    sample to the last row and column (kernel 2) or pool to that cell's
    value too (kernel 4: x2 >= x1, not inverted)."""
    feat, _ = make_case(8, 1, 1, 6, 9, 8, 0.25)
    assert troi.fwd_bf16_plan(1, 6, 9, 8, 0, (7, 7), 2)["blocks"] == 0
    assert emulate(feat, np.zeros((1, 0, 4), F), (7, 7), 0.25, 2).shape == (1, 0, 7, 7, 8)
    rois = np.array([[[300.0, 200.0, 360.0, 260.0], [-90.0, -80.0, -20.0, -10.0]]], F)
    for stream in (False, True):
        got = emulate(feat, rois, (7, 7), 0.25, 2, stream=stream)
        corner = bf16_bits(feat[0, 5, 8].float().numpy())
        origin = bf16_bits(feat[0, 0, 0].float().numpy())
        assert (got[0, 0] == corner).all() and (got[0, 1] == origin).all()


@pytest.mark.parametrize("pooled,s", [((7, 7), 2), ((14, 14), 3), ((7, 40), 1), ((14, 14), 5)])
def test_x_schedule_lists_each_tapped_column_once(pooled, s):
    """Warp 0's layout, 32 samples a chunk with the carry: the tapped
    columns once each, increasing, and every sample's lower and upper taps
    at cols[need - two] and cols[need], on random and edge rois."""
    rng = np.random.RandomState(9)
    h, w = 19, 23
    rois = case_rois(rng, 1, 40, h, w, 0.25)[0]
    for roi in rois:
        x1, _, x2, _ = scaled(roi, 0.25)
        taps = axis_taps(x1, x2, pooled[1], s, F(w), w)
        cols, steps = x_schedule(taps)
        assert cols == sorted({t[0] for t in taps} | {t[1] for t in taps})
        for (lo, hi, wl, wh), (need, two, sl, sh) in zip(taps, steps):
            assert (cols[need - two], cols[need]) == (lo, hi) and (sl, sh) == (wl, wh)


@pytest.mark.parametrize("shape", [(2, 64, 64, 1024, 300, (14, 14), 2),
                                   (1, 152, 256, 256, 128, (14, 14), 2),
                                   (1, 20, 30, 260, 40, (14, 14), 5),
                                   (3, 5, 7, 12, 9, (15, 4), 1)])
def test_plan_covers_every_output_once(shape):
    """The plan's blocks, warps and lanes against a brute force over every
    (image, roi, row, bin, channel): each computed exactly once; 16-byte
    lanes where C % 8 == 0."""
    b, h, w, c, r, pooled, s = shape
    plan = troi.fwd_bf16_plan(b, h, w, c, r, pooled, s)
    kch = plan["vec_bytes"] // 2
    assert plan["vec_bytes"] == (16 if c % 8 == 0 else 8)
    assert plan["blocks"] == b * r * plan["slices"] * plan["groups"]
    rows = np.zeros(pooled[0], np.int32)
    for g in range(plan["groups"]):
        for warp in range(plan["warps"]):
            if g * plan["warps"] + warp < pooled[0]:
                rows[g * plan["warps"] + warp] += 1
    chans = np.zeros(c, np.int32)
    for sl in range(plan["slices"]):
        for lane in range(LANES):
            vec = sl * LANES + lane
            if vec < c // kch:
                chans[vec * kch:(vec + 1) * kch] += 1
    assert (rows == 1).all() and (chans == 1).all()
    assert plan["smem"] == 16 * pooled[1] * s + 16 * plan["warps"] * s + 8 * pooled[1] * s
