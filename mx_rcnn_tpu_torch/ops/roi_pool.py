"""Exact MXNet ROIPooling (port of ``roi_pool`` / ``_maxpool_one_roi`` of
``mx_rcnn_tpu/ops/roi_align.py``), the VGG-16 family's ROI_MODE.

Each roi is quantized to feature cells with ``round(x·scale)`` (half to
even, as ``jnp.round``), its extent is ``max(x2 − x1 + 1, 1)`` cells, and bin
``b`` of ``n`` spans ``[floor(start + b·size/n), ceil(start + (b+1)·size/n))``,
clipped to ``[0, lim]``, where ``lim`` is the canvas or, under ``valid_hw``,
``ceil(valid·scale)`` (the JAX package's ``_feat_limits``).  A bin's output
is its cells' maximum; an empty bin gives 0 and takes no gradient.

The JAX function takes the maximum in two stages, over the rows of each bin
row, then over the columns of each bin column, and its gradient splits a
tied maximum evenly at each stage: among the tied rows of a column, then
among the tied columns.  JAX computes both as masked contractions of an
(R, ph, H, W, C) tensor; here:

- the forward reads the maxima from a two-dimensional sparse table of the
  map (:func:`_range_max_table`: level (i, j) holds the maximum of the
  2^i × 2^j window at each cell), four lookups a bin.  It is pure
  selection, so it is bit for bit the JAX forward, and it holds one table
  of (log₂H + 1)(log₂W + 1) maps per image, never a tensor of the rois'
  size;
- the backward recomputes the first stage's maxima from a sparse table of
  the rows and writes JAX's VJP out (:func:`_pool_backward`): a maximum's
  cotangent split evenly among its tied cells, stage by stage, as the VJP
  of XLA's ``max``; one chunk of rois at a time (:data:`CHUNK_ELEMENTS`
  cells of its (n, ph, H, W, C) tie mask).

:class:`RoIPoolFunction` saves only the map, the rois and ``valid_hw``.
These are plain PyTorch operations on either device: the JAX package leaves
``roi_pool`` to XLA, so it has no TPU kernel to port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# cells of one chunk's (n, ph, H, W, C) tie mask in the backward
CHUNK_ELEMENTS = 1 << 26


def _bin_edges(start, extent, nbins: int, lim):
    """(N,) roi starts and extents in cells → the (N, nbins) [lo, hi) cell
    edges of each bin, clipped to [0, lim], as float32.

    The arithmetic is XLA's for the JAX expression ``floor(start + b ·
    (extent / nbins))``: the division becomes a product with the float32
    reciprocal of ``nbins``, and ``start + b · size`` rounds once (a fused
    multiply-add; the float64 sum of two float32 products is exact here)."""
    b = torch.arange(nbins + 1, dtype=torch.float64, device=start.device)
    size = extent * float(np.float32(1.0 / nbins))  # the float32 reciprocal, exactly
    edges = (start.double()[:, None] + b * size.double()[:, None]).float()
    lo = torch.floor(edges[:, :-1]).clamp_min(0)
    hi = torch.ceil(edges[:, 1:]).clamp_min(0)
    lim = lim[:, None]
    return torch.minimum(lo, lim), torch.minimum(hi, lim)


def _limits(n: int, feat_hw, valid_hw: Optional[torch.Tensor], spatial_scale: float, device):
    """(N,) float32 clip limits of the rows and the columns: the canvas, or
    ``min(ceil(valid·scale), canvas)`` of each roi's image."""
    if valid_hw is None:
        return tuple(torch.full((n,), float(s), device=device) for s in feat_hw)
    return tuple(torch.ceil(valid_hw[:, i].float() * spatial_scale).clamp_max(float(feat_hw[i]))
                 for i in (0, 1))


def bin_edges(rois: torch.Tensor, pooled: Tuple[int, int], spatial_scale: float, feat_hw,
              valid_hw: Optional[torch.Tensor] = None):
    """(N, 4) image-coordinate rois (and their images' (N, 2) ``valid_hw``)
    → the rows' and the columns' (N, ph) / (N, pw) float32 (lo, hi) bin
    edges in feature cells."""
    q = torch.round(rois.float() * spatial_scale)
    x1, y1, x2, y2 = q.unbind(-1)
    lim_h, lim_w = _limits(rois.shape[0], feat_hw, valid_hw, spatial_scale, rois.device)
    rows = _bin_edges(y1, torch.clamp_min(y2 - y1 + 1.0, 1.0), pooled[0], lim_h)
    cols = _bin_edges(x1, torch.clamp_min(x2 - x1 + 1.0, 1.0), pooled[1], lim_w)
    return rows, cols


def _masks(edges, size: int) -> torch.Tensor:
    """(N, nb) edges → (N, nb, size) bool: cell i lies in bin b."""
    lo, hi = edges
    i = torch.arange(size, dtype=torch.float32, device=lo.device)
    return (i >= lo[..., None]) & (i < hi[..., None])


def _pool_backward(feat, tmp, mh, mw, g) -> torch.Tensor:
    """The VJP of JAX's two masked maxima for a chunk of n rois: (H, W, C)
    map, its (n, ph, W, C) first-stage maxima ``tmp`` (finfo.min in an
    empty bin row), (n, ph, H) row and (n, pw, W) column masks, (n, ph, pw,
    C) cotangent → the chunk's (H, W, C) gradient.  Each stage hands a
    maximum's cotangent to its tied cells, ``g / count`` each (the VJP of
    XLA's ``max``): among a bin column's tied columns, then among a column's
    tied rows; an empty bin takes none."""
    neg = torch.finfo(feat.dtype).min
    t2 = torch.where(mw[:, None, :, :, None], tmp[:, :, None], neg)          # (n, ph, pw, W, C)
    tied2 = t2 == t2.amax(dim=3, keepdim=True)
    empty = (~mh.any(-1))[:, :, None] | (~mw.any(-1))[:, None, :]
    gq = (g / tied2.sum(dim=3)).masked_fill(empty[..., None], 0)
    g_tmp = (tied2 * gq[:, :, :, None]).sum(dim=2)                          # (n, ph, W, C)
    tied1 = mh[..., None, None] & (feat == tmp[:, :, None])                 # (n, ph, H, W, C)
    w1 = g_tmp / tied1.sum(dim=2).clamp_min(1)
    return (tied1 * w1[:, :, None]).sum(dim=(0, 1))


def _floor_log2(n: torch.Tensor) -> torch.Tensor:
    """floor(log₂ n) of a non-negative integer tensor (0 at n = 0), exact
    below 2^24."""
    return (torch.frexp(n.float().clamp_min(1))[1] - 1).long()


def _row_max(feat: torch.Tensor, rows) -> torch.Tensor:
    """JAX's first stage from a sparse table of the rows: (H, W, C) map and
    (n, ph) row edges → (n, ph, W, C), each bin row's maximum over its
    rows, finfo.min in an empty bin row (the masked maximum's value)."""
    h, w, c = feat.shape
    flat = _levels(feat, 0).reshape(-1, w, c)
    lo, hi = rows[0].long(), rows[1].long()
    length = (hi - lo).clamp_min(0)
    k = _floor_log2(length)
    a, b = k * h + lo.clamp_max(h - 1), k * h + (hi - (1 << k)).clamp(0, h - 1)
    tmp = torch.maximum(flat[a.reshape(-1)], flat[b.reshape(-1)]).reshape(lo.shape + (w, c))
    return tmp.masked_fill((length == 0)[..., None, None], torch.finfo(feat.dtype).min)


def _levels(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sparse-table levels of ``x`` along ``dim``: level k holds the maximum
    of the 2^k cells from each cell on (cells past the end keep the last
    level's value and are never read), stacked in a new leading dim."""
    n = x.shape[dim]
    out = [x]
    k = 1
    while 2 * k <= n:
        prev = out[-1]
        nxt = prev.clone()
        nxt.narrow(dim, 0, n - k).copy_(torch.maximum(prev.narrow(dim, 0, n - k),
                                                      prev.narrow(dim, k, n - k)))
        out.append(nxt)
        k *= 2
    return torch.stack(out)


def _range_max_table(feat: torch.Tensor) -> torch.Tensor:
    """(H, W, C) → (Lh, Lw, H, W, C) two-dimensional sparse table."""
    return _levels(_levels(feat, 1), 1)


def _table_pool(feat: torch.Tensor, rows, cols) -> torch.Tensor:
    """One image's (H, W, C) map and its rois' (n, ph) / (n, pw) bin edges
    → (n, ph, pw, C): each bin's maximum as four lookups in the sparse
    table, 0 in an empty bin."""
    h, w, c = feat.shape
    table = _range_max_table(feat)
    lw = table.shape[1]
    flat = table.reshape(-1, c)
    (rlo, rhi), (clo, chi) = ((e[0].long(), e[1].long()) for e in (rows, cols))
    rlen, clen = (rhi - rlo).clamp_min(0), (chi - clo).clamp_min(0)
    kh, kw = _floor_log2(rlen), _floor_log2(clen)                   # (n, ph), (n, pw)
    ra, rb = rlo.clamp_max(h - 1), (rhi - (1 << kh)).clamp(0, h - 1)
    ca, cb = clo.clamp_max(w - 1), (chi - (1 << kw)).clamp(0, w - 1)
    base = ((kh * lw)[:, :, None] + kw[:, None, :]) * h             # (n, ph, pw)

    def at(r, col):
        return flat[((base + r[:, :, None]) * w + col[:, None, :]).reshape(-1)]

    out = torch.maximum(torch.maximum(at(ra, ca), at(ra, cb)),
                        torch.maximum(at(rb, ca), at(rb, cb)))
    out = out.reshape(rlo.shape[0], rlo.shape[1], clo.shape[1], c)
    empty = (rlen == 0)[:, :, None] | (clen == 0)[:, None, :]
    return out.masked_fill(empty[..., None], 0)


def _chunk(n_rois: int, pooled, hw, c: int) -> int:
    per_roi = pooled[0] * hw[0] * hw[1] * c
    return max(1, min(n_rois, CHUNK_ELEMENTS // max(per_roi, 1)))


class RoIPoolFunction(torch.autograd.Function):
    """(B, H, W, C) map × (B, R, 4) rois → (B, R, ph, pw, C); saves the
    map, the rois and ``valid_hw``, and recomputes what its backward needs
    chunk by chunk."""

    @staticmethod
    def forward(ctx, feat, rois, pooled, spatial_scale, valid_hw):
        b, h, w, c = feat.shape
        r = rois.shape[1]
        ctx.save_for_backward(feat, rois, valid_hw)
        ctx.meta = (pooled, spatial_scale)
        out = feat.new_empty((b, r) + tuple(pooled) + (c,))
        for i in range(b):
            rows, cols = bin_edges(rois[i], pooled, spatial_scale, (h, w),
                                   None if valid_hw is None else valid_hw[i].expand(r, 2))
            out[i] = _table_pool(feat[i], rows, cols)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        feat, rois, valid_hw = ctx.saved_tensors
        pooled, spatial_scale = ctx.meta
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        b, h, w, c = feat.shape
        r = rois.shape[1]
        n = _chunk(r, pooled, (h, w), c)
        dfeat = torch.zeros_like(feat)
        for i in range(b):
            rows, cols = bin_edges(rois[i], pooled, spatial_scale, (h, w),
                                   None if valid_hw is None else valid_hw[i].expand(r, 2))
            mh, mw = _masks(rows, h), _masks(cols, w)
            tmp = _row_max(feat[i], rows)
            for s in range(0, r, n):
                dfeat[i] += _pool_backward(feat[i], tmp[s:s + n], mh[s:s + n], mw[s:s + n],
                                           g[i, s:s + n])
        return dfeat, None, None, None, None


def roi_pool(
    feat: torch.Tensor,
    rois: torch.Tensor,
    pooled: Tuple[int, int] = (7, 7),
    spatial_scale: float = 1.0 / 16.0,
    valid_hw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, W, C) float32 or bfloat16 map + (B, R, 4) float32
    image-coordinate rois → (B, R, ph, pw, C) max-pooled, of the map's
    dtype, differentiable in ``feat``.  ``valid_hw`` (B, 2): the true
    pre-padding image sizes, which clip the bins instead of the canvas."""
    return RoIPoolFunction.apply(feat, rois, tuple(pooled), float(spatial_scale), valid_hw)
