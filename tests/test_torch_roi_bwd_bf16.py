"""The arithmetic of the bf16 ROIAlign backwards (kernels 3 and 5 on a bf16
cotangent, ``csrc/roi_align_bwd_bf16.cuh``), emulated in numpy on the CPU,
where the CUDA kernel cannot run.

The emulation repeats the kernel's steps: the per-roi tables of
``roi_table_kernel`` (each sample's taps in float32, merged per (cell, bin)
in the kernel's merge order), then per dfeat cell the kernel's fixed sum
order (the rois in order, split over a cluster's blocks by r % groups and
the blocks' partial sums added in block order; then the bin rows in order;
per bin row u = the column's bins in order, each a fused multiply-add),
the division by s², and the bf16 epilogue (round to nearest even).  A
fused multiply-add is emulated in float64 (the product of two float32s is
exact there) and rounded to float32: it can round twice where the card
rounds once, an ulp at most, well inside every bar below.

It is held against the JAX package's Pallas backwards in interpret mode on a
bf16 cotangent (as ``tests/test_pallas_roi_align.py`` runs them), and
against the port's plain backwards, each within 1e-5 · max(1, Σ|terms|)
(float32 sums in another order; the card's gate is 1e-4).  The per-tile roi
list the kernel builds (extent test, then the tile's entries) has a twin
here, checked against a brute-force test on the taps.
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
BAR = 1e-5


# ------------------------------------------------------------ the tables
def _axis_taps(c1, c2, nbins, s, lim_f, size):
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
        w_lo = F(F(1.0) - w_hi)
        taps.append((max(0, min(lo, size - 1)), max(0, min(hi, size - 1)), w_lo, w_hi))
    return taps


def _merge(taps, s):
    """merge_entries: the (cell, bin, weight) entries sorted by (cell, bin),
    equal keys summed in the kernel's order (lower taps before upper)."""
    n = len(taps)
    i = j = 0
    out = []
    while i < n or j < n:
        lower = j >= n or (i < n and (taps[i][0] < taps[j][1]
                                      or (taps[i][0] == taps[j][1] and i // s <= j // s)))
        if lower:
            cell, b, w = taps[i][0], i // s, taps[i][2]
            i += 1
        else:
            cell, b, w = taps[j][1], j // s, taps[j][3]
            j += 1
        if out and out[-1][0] == cell and out[-1][1] == b:
            out[-1][2] = F(out[-1][2] + w)
        else:
            out.append([cell, b, w])
    return out


def tables(rois, shape, pooled, scale, s, valid_hw, stream):
    """Per (image, roi): (y entries, x entries) as roi_table_kernel writes
    them (empty for an inverted roi under kernel 5's rule)."""
    b, h, w, _ = shape
    out = []
    for i in range(b):
        if valid_hw is None:
            lim_h, lim_w = F(h), F(w)
        else:
            lim_h = F(min(np.ceil(F(F(valid_hw[i, 0]) * F(scale))), F(h)))
            lim_w = F(min(np.ceil(F(F(valid_hw[i, 1]) * F(scale))), F(w)))
        row = []
        for roi in rois[i]:
            x1, y1, x2, y2 = (F(v * F(scale)) for v in roi)
            if stream and x2 < x1:
                row.append(([], []))
                continue
            row.append((_merge(_axis_taps(y1, y2, pooled[0], s, lim_h, h), s),
                        _merge(_axis_taps(x1, x2, pooled[1], s, lim_w, w), s)))
        out.append(row)
    return out


def _dense(entries, size, nbins):
    m = np.zeros((size, nbins), F)
    for cell, b, w in entries:
        m[cell, b] = w
    return m


def _fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(F)


def emulate(g, rois, shape, pooled, scale, s, valid_hw=None, stream=False, groups=1):
    """The kernel's float32 dfeat (B, H, W, C) of a bf16 g, in its sum order."""
    b, h, w, c = shape
    ph, pw = pooled
    g = np.asarray(torch.as_tensor(g).float(), F)
    tabs = tables(np.asarray(rois, F), shape, pooled, scale, s,
                  None if valid_hw is None else np.asarray(valid_hw, F), stream)
    out = np.zeros(shape, F)
    for i in range(b):
        parts = [np.zeros((h, w, c), F) for _ in range(groups)]
        for r, (ye, xe) in enumerate(tabs[i]):
            if not ye or not xe:
                continue
            wy, wx = _dense(ye, h, ph), _dense(xe, w, pw)
            u = np.zeros((ph, w, c), F)  # u[ph, x] over the column's bins in order
            for q in range(pw):
                u = _fma(wx[None, :, q, None], g[i, r, :, q, None, :], u)
            acc = parts[r % groups]
            for p in range(ph):  # the bin rows in order; a row without p adds nothing
                wyp = wy[:, p, None, None]
                acc[...] = np.where(wyp != 0, _fma(wyp, u[p][None], acc), acc)
        v = parts[0]
        for part in parts[1:]:
            v = (v + part).astype(F)
        out[i] = v / F(s * s)
    return out


def bf16_rne(v):
    """The epilogue's rounding of float32 to bf16 bits (finite values):
    round to nearest, ties to even."""
    bits = np.asarray(v, F).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def tile_rois(tabs, i, y0, y1, x0, x1, h, w):
    """The rois the kernel's tile [y0, y1) x [x0, x1) of image i sums, in
    order: those whose entries' extent meets the tile (the block's ballot)
    and that have entries in the tile's rows and columns (the producer's
    test)."""
    out = []
    for r, (ye, xe) in enumerate(tabs[i]):
        if not ye or not xe:
            continue  # the extent (0, -1, 0, -1) meets no tile
        if not (ye[0][0] < y1 and ye[-1][0] >= y0 and xe[0][0] < x1 and xe[-1][0] >= x0):
            continue
        if any(y0 <= e[0] < min(y1, h) for e in ye) and any(x0 <= e[0] < min(x1, w) for e in xe):
            out.append(r)
    return out


# ------------------------------------------------------------ the cases
def _rois(rng, b, r, h, w, scale):
    """Random rois plus the edge cases: the whole canvas, sub-cell, past the
    border, degenerate, off the canvas, inverted, wholly past the canvas."""
    h_img, w_img = h / scale, w / scale
    xy = rng.rand(b, r, 2) * [w_img, h_img]
    wh = rng.rand(b, r, 2) * [w_img / 2, h_img / 2]
    rois = np.concatenate([xy, xy + wh], -1).astype(F)
    edge = [[0, 0, w_img - 1, h_img - 1], [5, 5, 5.5, 5.5],
            [w_img - 2, h_img - 2, w_img + 50, h_img + 50], [0, 0, 0, 0],
            [-80, -60, -20, -10], [w_img * 0.6, h_img * 0.5, w_img * 0.3, h_img * 0.7],
            [w_img + 40, h_img + 40, w_img + 90, h_img + 80]]
    n = min(r, len(edge))
    if n:
        rois[:, :n] = np.asarray(edge[:n], F)
    return rois


def _case(seed, b, r, h, w, c, pooled, scale):
    rng = np.random.RandomState(seed)
    rois = _rois(rng, b, r, h, w, scale)
    g = torch.from_numpy(rng.randn(b, r, *pooled, c).astype(F)).bfloat16()
    return rois, g, (b, h, w, c)


CASES = [  # (seed, b, r, h, w, c, pooled, scale, s)
    (0, 2, 9, 12, 16, 8, (7, 7), 0.25, 2),
    (1, 1, 12, 10, 14, 16, (14, 14), 0.25, 2),
    (2, 2, 8, 9, 11, 8, (7, 7), 0.5, 3),
    (3, 1, 0, 6, 8, 8, (7, 7), 0.25, 2),
]
IDS = ["7x7", "14x14", "s3", "R0"]


def _bar(got, ref, mag):
    return float((np.abs(got - ref) / np.maximum(mag, 1.0)).max()) if got.size else 0.0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulation_matches_jax_resident_backward(case):
    """Kernel 3's arithmetic against _roi_align_bwd_impl (interpret mode) on
    a bf16 g, canvas clamp: inverted rois tap their clamped x1/y1."""
    seed, b, r, h, w, c, pooled, scale, s = case
    rois, g, shape = _case(seed, b, r, h, w, c, pooled, scale)
    got = emulate(g, rois, shape, pooled, scale, s)
    ref = np.zeros(shape, F)  # the Pallas kernel takes no empty roi set: R = 0 adds nothing
    if r:
        ref = np.asarray(j_resident._roi_align_bwd_impl(
            shape, jnp.float32, jnp.asarray(rois), jnp.asarray(g.float().numpy(), jnp.bfloat16),
            pooled, scale, s, True), F)
    mag = troi.roi_align_bwd_plain(g.abs(), torch.from_numpy(rois), shape, pooled, scale,
                                   s).numpy()
    assert _bar(got, ref, mag) <= BAR


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulation_matches_jax_stream_backward(case):
    """Kernel 5's arithmetic against the streamed _bwd_impl (interpret mode)
    on a bf16 g: an inverted roi adds nothing."""
    seed, b, r, h, w, c, pooled, scale, s = case
    rois, g, shape = _case(seed + 10, b, r, h, w, c, pooled, scale)
    got = emulate(g, rois, shape, pooled, scale, s, stream=True)
    ref = np.zeros(shape, F)
    if r:
        ref = np.asarray(j_stream._bwd_impl(
            shape, jnp.float32, jnp.asarray(rois), jnp.asarray(g.float().numpy(), jnp.bfloat16),
            pooled, scale, s, True), F)
    mag = tstream.roi_align_stream_bwd_plain(g.abs(), torch.from_numpy(rois), shape, pooled,
                                             scale, s).numpy()
    assert _bar(got, ref, mag) <= BAR
    if r > 5:  # the inverted roi (index 5) alone adds nothing
        only = torch.zeros_like(g)
        only[:, 5] = g[:, 5]
        assert not emulate(only, rois, shape, pooled, scale, s, stream=True).any()


@pytest.mark.parametrize("with_valid_hw", [False, True])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulation_matches_port_plain_backwards(case, with_valid_hw):
    """Against roi_align_bwd_plain (both clamps) and roi_align_stream_bwd_plain."""
    seed, b, r, h, w, c, pooled, scale, s = case
    rois, g, shape = _case(seed + 20, b, r, h, w, c, pooled, scale)
    t_rois = torch.from_numpy(rois)
    valid_hw = None
    if with_valid_hw:
        valid_hw = torch.tensor([[h / scale * 0.6, w / scale * 0.8], [h / scale, w / scale * 0.5]]
                                [:b], dtype=torch.float32)
    got = emulate(g, rois, shape, pooled, scale, s, valid_hw)
    ref = troi.roi_align_bwd_plain(g, t_rois, shape, pooled, scale, s, valid_hw).numpy()
    mag = troi.roi_align_bwd_plain(g.abs(), t_rois, shape, pooled, scale, s, valid_hw).numpy()
    assert _bar(got, ref, mag) <= BAR
    if not with_valid_hw:
        got = emulate(g, rois, shape, pooled, scale, s, stream=True)
        ref = tstream.roi_align_stream_bwd_plain(g, t_rois, shape, pooled, scale, s).numpy()
        mag = tstream.roi_align_stream_bwd_plain(g.abs(), t_rois, shape, pooled, scale, s).numpy()
        assert _bar(got, ref, mag) <= BAR


@pytest.mark.parametrize("groups", [2, 4, 8])
def test_cluster_split_stays_within_the_bar(groups):
    """A cluster's blocks sum r % groups == k and add in block order: another
    order, within the same bar of the single block's sums."""
    rois, g, shape = _case(4, 1, 20, 12, 16, 8, (7, 7), 0.25)
    one = emulate(g, rois, shape, (7, 7), 0.25, 2)
    split = emulate(g, rois, shape, (7, 7), 0.25, 2, groups=groups)
    mag = troi.roi_align_bwd_plain(g.abs(), torch.from_numpy(rois), shape, (7, 7), 0.25,
                                   2).numpy()
    assert _bar(split, one, mag) <= BAR
    assert not split[mag == 0].any()


def test_off_canvas_rois_add_to_the_border_cells_only():
    """Rois wholly past the canvas clamp every sample to the last row and
    column: only those cells get gradient."""
    rois = np.array([[[300.0, 200.0, 360.0, 260.0], [-90.0, -80.0, -20.0, -10.0]]], F)
    g = torch.ones(1, 2, 7, 7, 8).bfloat16()
    got = emulate(g, rois, (1, 12, 16, 8), (7, 7), 0.25, 2)
    nz = np.argwhere(got.any(-1)[0])
    assert {tuple(p) for p in nz} == {(11, 15), (0, 0)}


def test_bf16_epilogue_is_torch_round_to_nearest_even():
    """The epilogue's rounding equals ``.to(torch.bfloat16)`` bit for bit on
    the emulated sums and on ties, subnormals and large values."""
    rois, g, shape = _case(5, 2, 9, 12, 16, 8, (7, 7), 0.25)
    sums = emulate(g, rois, shape, (7, 7), 0.25, 2).ravel()
    ties = np.array([0x3F808000, 0x3F818000, 0x00018000, 0x7F7F7FFF, 0x80008000, 0xBF808001],
                    np.uint32).view(F)
    for v in (sums, ties, np.random.RandomState(6).randn(4096).astype(F) * 1e-3):
        want = torch.from_numpy(v).bfloat16().view(torch.int16).numpy().view(np.uint16)
        assert np.array_equal(bf16_rne(v), want)


@pytest.mark.parametrize("tile", [(2, 4), (8, 4), (16, 4)])
def test_tile_roi_list_matches_brute_force(tile):
    """The tile's roi list (extent test, then entries in its rows and
    columns) against a brute force over the taps: the rois with a sample
    tapping one of the tile's rows and one of its columns."""
    th, tw = tile
    b, r, h, w = 2, 24, 19, 22
    scale = 0.25
    rng = np.random.RandomState(7)
    rois = _rois(rng, b, r, h, w, scale)
    for stream in (False, True):
        tabs = tables(rois, (b, h, w, 8), (7, 7), scale, 2, None, stream)
        (ylo, yhi, _, _), (xlo, xhi, _, _) = troi._roi_taps(torch.from_numpy(rois), h, w,
                                                            (7, 7), scale, 2, None)
        ylo, yhi, xlo, xhi = (t.numpy() for t in (ylo, yhi, xlo, xhi))
        live = ~tstream.valid_rois(torch.from_numpy(rois), scale).numpy() if stream else None
        for i in range(b):
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    want = []
                    for k in range(r):
                        if stream and live[i, k]:
                            continue
                        ys = set(ylo[i, k]) | set(yhi[i, k])
                        xs = set(xlo[i, k]) | set(xhi[i, k])
                        if ys & set(range(y0, y0 + th)) and xs & set(range(x0, x0 + tw)):
                            want.append(k)
                    assert tile_rois(tabs, i, y0, y0 + th, x0, x0 + tw, h, w) == want


@pytest.mark.parametrize("route", ["resident", "stream"])
def test_cpu_bf16_autograd_returns_the_plain_bf16_gradient(route):
    """On the CPU both functions run their plain versions: a bf16 map's
    gradient is bf16, the plain version's own autograd, within one bf16 ulp
    of the float32 plain backward rounded."""
    rois, g, shape = _case(8, 2, 9, 12, 16, 8, (7, 7), 0.25)
    rng = np.random.RandomState(9)
    feat = torch.from_numpy(rng.randn(*shape).astype(F)).bfloat16()
    t_rois = torch.from_numpy(rois)
    fn, plain, bwd = {
        "resident": (troi.roi_align, troi.roi_align_plain, troi.roi_align_bwd_plain),
        "stream": (tstream.roi_align_stream, tstream.roi_align_stream_plain,
                   tstream.roi_align_stream_bwd_plain),
    }[route]
    f1, f2 = feat.clone().requires_grad_(), feat.clone().requires_grad_()
    fn(f1, t_rois, (7, 7), 0.25, 2).backward(g)
    plain(f2, t_rois, (7, 7), 0.25, 2).backward(g)
    assert f1.grad.dtype == torch.bfloat16 and torch.equal(f1.grad, f2.grad)
    ref = bwd(g, t_rois, shape, (7, 7), 0.25, 2)
    ulp = 2.0 ** -7 * ref.abs().clamp_min(1e-30)
    assert ((f1.grad.float() - ref).abs() <= ulp + 1e-6).all()
