"""ROIAlign forward and backward (port of the box path of
``mx_rcnn_tpu/ops/roi_align.py`` and of ``ops/pallas/roi_align.py``).

:func:`roi_align` is the batched, differentiable forward: CUDA tensors go
through :class:`RoIAlignFunction`, whose forward launches kernel 2 and whose
backward launches kernel 3 (both in ``csrc/roi_align.cu``); CPU tensors run
:func:`roi_align_plain`, which torch autograd differentiates.  With
``valid_hw`` the samples clamp to the valid feature extent (the gather path
``roi_align`` of the JAX package, which the eval forward takes); without it
they clamp to the canvas (the Pallas kernel ``roi_align_pallas``, which the
train step takes).  :func:`roi_align_bwd_plain` is the backward's plain
version: an explicit scatter-add over the same taps.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mx_rcnn_tpu_torch.utils.cuda_build import (
    CudaKernel,
    CudaLibrary,
    kernel_input,
    ptr,
    stream_of,
)

# both launchers take (in, rois, valid_hw, b, h, w, c, r, ph, pw, s, scale,
# out, stream)
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
)
library = CudaLibrary("roi_align.cu")
kernel = CudaKernel(library, "roi_align_fwd", _ARGTYPES)
bwd_kernel = CudaKernel(library, "roi_align_bwd", _ARGTYPES)


def _feat_limits(size: int, valid: Optional[torch.Tensor], scale: float, batch: int, device):
    """Per-image (float, int) clamp limits along one axis: the canvas
    extent, or ``min(ceil(valid·scale), size)`` (``_feat_limits`` of the JAX
    package: the clamp lands at the same cell on every bucket)."""
    if valid is None:
        lim = torch.full((batch,), float(size), dtype=torch.float32, device=device)
    else:
        lim = torch.clamp_max(torch.ceil(valid.float() * scale), float(size))
    return lim, lim.to(torch.int64)


def _axis_taps(c1, c2, nbins: int, s: int, lim_f, lim_i):
    """(B, R) scaled roi edges → per-sample (lo, hi, w_lo, w_hi), each
    (B, R, nbins·s), with the gather twin's op order."""
    # divisors as device tensors: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, one rounding off IEEE division
    nb, sr = torch.tensor([float(nbins), float(s)], device=c1.device)
    bin_sz = torch.clamp_min(c2 - c1, 1.0) / nb
    k = torch.arange(nbins * s, dtype=torch.float32, device=c1.device)
    g = c1[..., None] + (k + 0.5) / sr * bin_sz[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=c1.device)
    g = torch.minimum(torch.maximum(g, zero), (lim_f - 1.0)[:, None, None])
    lo_f = torch.floor(g)
    lo = lo_f.to(torch.int64)
    hi = torch.minimum(lo + 1, (lim_i - 1)[:, None, None])
    w_hi = g - lo_f
    return lo, hi, 1.0 - w_hi, w_hi


def _roi_taps(rois, hf: int, wf: int, pooled, spatial_scale: float, s: int, valid_hw):
    """(B, R, 4) image-coordinate rois → the y taps (B, R, ph·s) and the x
    taps (B, R, pw·s) of every sample, as ``(lo, hi, w_lo, w_hi)``."""
    b = rois.shape[0]
    r = rois.float() * spatial_scale
    vh = None if valid_hw is None else valid_hw[:, 0]
    vw = None if valid_hw is None else valid_hw[:, 1]
    lh_f, lh_i = _feat_limits(hf, vh, spatial_scale, b, rois.device)
    lw_f, lw_i = _feat_limits(wf, vw, spatial_scale, b, rois.device)
    return (_axis_taps(r[..., 1], r[..., 3], pooled[0], s, lh_f, lh_i),
            _axis_taps(r[..., 0], r[..., 2], pooled[1], s, lw_f, lw_i))


def roi_align_plain(
    feat: torch.Tensor,
    rois: torch.Tensor,
    pooled: Tuple[int, int] = (14, 14),
    spatial_scale: float = 1.0 / 16.0,
    sample_ratio: int = 2,
    valid_hw: Optional[torch.Tensor] = None,
    chunk: int = 32,
) -> torch.Tensor:
    """Plain PyTorch ROIAlign: (B, H, W, C) × (B, R, 4) → (B, R, ph, pw, C),
    on any device.  The two-stage separable gather of the JAX gather path
    (rows, then columns, then the mean of the s×s samples), ``chunk`` rois
    at a time to bound the (chunk, ph·s, W, C) row intermediate."""
    b, hf, wf, c = feat.shape
    r = rois.shape[1]
    ph, pw = pooled
    s = sample_ratio
    (ylo, yhi, wy0, wy1), (xlo, xhi, wx0, wx1) = _roi_taps(
        rois, hf, wf, pooled, spatial_scale, s, valid_hw
    )

    out = feat.new_empty((b, r, ph, pw, c))
    for i in range(b):
        f = feat[i]
        for j0 in range(0, r, chunk):
            sl = slice(j0, min(j0 + chunk, r))
            n = sl.stop - sl.start
            rows = (
                f[ylo[i, sl]] * wy0[i, sl, :, None, None]
                + f[yhi[i, sl]] * wy1[i, sl, :, None, None]
            )                                                  # (n, ph*s, W, C)
            ri = torch.arange(n, device=feat.device)[:, None, None]
            yi = torch.arange(ph * s, device=feat.device)[None, :, None]
            cols = (
                rows[ri, yi, xlo[i, sl][:, None, :]] * wx0[i, sl][:, None, :, None]
                + rows[ri, yi, xhi[i, sl][:, None, :]] * wx1[i, sl][:, None, :, None]
            )                                                  # (n, ph*s, pw*s, C)
            out[i, sl] = cols.reshape(n, ph, s, pw, s, c).mean(dim=(2, 4))
    return out


def roi_align_bwd_plain(
    g: torch.Tensor,
    rois: torch.Tensor,
    feat_shape,
    pooled: Tuple[int, int] = (14, 14),
    spatial_scale: float = 1.0 / 16.0,
    sample_ratio: int = 2,
    valid_hw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch backward of ROIAlign: (B, R, ph, pw, C) cotangent →
    (B, H, W, C) f32 feature gradient, on any device.

    An explicit scatter-add (``index_add_``) over the taps of
    :func:`roi_align_plain`: each bin's ``g / (s·s)`` times ``w_x`` times
    ``w_y`` into each of a sample's 4 cells (one cell takes both weights
    where a clamp makes ``lo == hi``).  32 rois at a time bound the
    (32, ph·s, pw·s, C) sample intermediate."""
    b, hf, wf, c = feat_shape
    r = rois.shape[1]
    s = sample_ratio
    (ylo, yhi, wy0, wy1), (xlo, xhi, wx0, wx1) = _roi_taps(
        rois, hf, wf, pooled, spatial_scale, s, valid_hw
    )
    dfeat = torch.zeros((b * hf * wf, c), dtype=torch.float32, device=g.device)
    # a device tensor: IEEE division, as the kernel divides
    count = torch.tensor(float(s * s), device=g.device)
    for i in range(b):
        for j0 in range(0, r, 32):
            sl = slice(j0, min(j0 + 32, r))
            # the mean's adjoint: each bin's g / (s·s) at its s×s samples
            gs = (g[i, sl].float() / count).repeat_interleave(s, 1).repeat_interleave(s, 2)
            for yi, wy in ((ylo, wy0), (yhi, wy1)):
                for xi, wx in ((xlo, wx0), (xhi, wx1)):
                    v = gs * wx[i, sl][:, None, :, None] * wy[i, sl][:, :, None, None]
                    cell = (i * hf + yi[i, sl])[:, :, None] * wf + xi[i, sl][:, None, :]
                    dfeat.index_add_(0, cell.reshape(-1), v.reshape(-1, c))
    return dfeat.reshape(b, hf, wf, c)


def _kernel_valid_hw(valid_hw, b):
    if valid_hw is None:
        return None
    valid_hw = kernel_input("valid_hw", valid_hw, torch.float32, 2)
    if tuple(valid_hw.shape) != (b, 2):
        raise ValueError(f"valid_hw {tuple(valid_hw.shape)} != ({b}, 2)")
    return valid_hw


def _roi_align_cuda(feat, rois, pooled, spatial_scale, sample_ratio, valid_hw):
    feat = kernel_input("feat", feat, torch.float32, 4)
    rois = kernel_input("rois", rois, torch.float32, 3)
    b, h, w, c = feat.shape
    if c % 4 or rois.shape[0] != b or rois.shape[2] != 4:
        raise ValueError(
            f"feat {tuple(feat.shape)} (C % 4 == 0) / rois {tuple(rois.shape)}"
        )
    valid_hw = _kernel_valid_hw(valid_hw, b)
    r = rois.shape[1]
    ph, pw = pooled
    out = torch.empty((b, r, ph, pw, c), dtype=torch.float32, device=feat.device)
    with torch.cuda.device(feat.device):
        kernel(
            ptr(feat), ptr(rois), ptr(valid_hw), b, h, w, c, r, ph, pw,
            int(sample_ratio), float(spatial_scale), ptr(out), stream_of(feat),
        )
    kernel.launches += 1
    return out


def _roi_align_bwd_cuda(g, rois, feat_shape, pooled, spatial_scale, sample_ratio, valid_hw):
    g = kernel_input("g", g, torch.float32, 5)
    rois = kernel_input("rois", rois, torch.float32, 3)
    b, h, w, c = feat_shape
    r = rois.shape[1]
    ph, pw = pooled
    if c % 4 or tuple(g.shape) != (b, r, ph, pw, c) or tuple(rois.shape) != (b, r, 4):
        raise ValueError(
            f"g {tuple(g.shape)} / rois {tuple(rois.shape)} / feat {tuple(feat_shape)} (C % 4 == 0)"
        )
    valid_hw = _kernel_valid_hw(valid_hw, b)
    with torch.cuda.device(g.device):
        # zero-filled on PyTorch's current stream, the stream of the launch
        dfeat = torch.zeros((b, h, w, c), dtype=torch.float32, device=g.device)
        bwd_kernel(
            ptr(g), ptr(rois), ptr(valid_hw), b, h, w, c, r, ph, pw,
            int(sample_ratio), float(spatial_scale), ptr(dfeat), stream_of(g),
        )
    bwd_kernel.launches += 1
    return dfeat


class RoIAlignFunction(torch.autograd.Function):
    """ROIAlign on CUDA tensors: the forward launches kernel 2, the
    backward kernel 3.  ``rois`` and ``valid_hw`` get no gradient, as the
    JAX vjp returns zeros for the rois (proposals are a stop-gradient input
    of the second stage)."""

    @staticmethod
    def forward(ctx, feat, rois, pooled, spatial_scale, sample_ratio, valid_hw):
        ctx.save_for_backward(rois, valid_hw)
        ctx.meta = (tuple(feat.shape), feat.dtype, pooled, spatial_scale, sample_ratio)
        return _roi_align_cuda(feat, rois, pooled, spatial_scale, sample_ratio, valid_hw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        rois, valid_hw = ctx.saved_tensors
        shape, dtype, pooled, spatial_scale, sample_ratio = ctx.meta
        dfeat = None
        if ctx.needs_input_grad[0]:
            dfeat = _roi_align_bwd_cuda(
                g, rois, shape, pooled, spatial_scale, sample_ratio, valid_hw
            ).to(dtype)
        return dfeat, None, None, None, None, None


def roi_align(
    feat: torch.Tensor,
    rois: torch.Tensor,
    pooled: Tuple[int, int] = (14, 14),
    spatial_scale: float = 1.0 / 16.0,
    sample_ratio: int = 2,
    valid_hw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, W, C) feature + (B, R, 4) image-coordinate rois →
    (B, R, ph, pw, C), differentiable in ``feat``.  ``valid_hw`` (B, 2):
    true pre-padding image sizes."""
    if feat.device.type == "cpu":
        return roi_align_plain(
            feat, rois, pooled, spatial_scale, sample_ratio, valid_hw
        )
    return RoIAlignFunction.apply(feat, rois, pooled, spatial_scale, sample_ratio, valid_hw)


def extract_roi_features_batched(
    feat: torch.Tensor,
    rois: torch.Tensor,
    mode: str,
    pooled: Tuple[int, int],
    spatial_scale: float,
    sample_ratio: int = 2,
    valid_hw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dispatch on config ROI_MODE; only 'roi_align' is ported so far."""
    if mode == "roi_align":
        return roi_align(feat, rois, pooled, spatial_scale, sample_ratio, valid_hw)
    if mode == "roi_pool":
        raise NotImplementedError("roi_pool (the VGG-16 family) is not ported yet")
    raise ValueError(f"unknown ROI_MODE {mode!r}")
