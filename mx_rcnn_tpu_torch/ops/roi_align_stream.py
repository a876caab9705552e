"""Streamed ROIAlign, forward and backward (port of
``mx_rcnn_tpu/ops/pallas/roi_align_stream.py``): the function the JAX package
routes the maps over its resident kernels' budget to (FPN's P2 and P3 in the
train step; ``ops/roi_align.py::extract_roi_features_batched``).

It is :func:`~mx_rcnn_tpu_torch.ops.roi_align.roi_align_plain` clamped to the
canvas, with one rule of its own: a roi whose scaled ``x2 < x1`` (the TPU
kernels' filler) pools to zeros and gets no gradient.  CUDA tensors go
through :class:`RoIAlignStreamFunction`, whose forward launches kernel 4 (the
template of ``csrc/roi_align_fwd.cuh`` under the streamed tap rule, kernel
2's code, or on bf16 maps ``csrc/roi_align_fwd_bf16.cuh``'s, with kernel 2's
bf16 launch plan) and whose backward launches kernel 5 (both exported by
``csrc/roi_align_stream.cu``; the backward is deterministic, and takes a
scratch for its per-roi tables, :func:`bwd_scratch`); CPU tensors run
:func:`roi_align_stream_plain`, which torch autograd differentiates, and
:func:`roi_align_stream_bwd_plain` is the backward's plain version.  As in
``ops/roi_align.py``, float32 and bfloat16 features each have their own
instance of each kernel (:data:`FWD_KERNELS`, :data:`BWD_KERNELS`); the
backward writes dfeat in the cotangent's dtype (the bf16 kernel rounds each
float32 sum once as it stores it), and :data:`bwd_kernel_bf16_f32`, its
float32 epilogue, is the card's gates' measuring aid, on no path.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mx_rcnn_tpu_torch.ops.roi_align import roi_align_bwd_plain, roi_align_plain, table_scratch
from mx_rcnn_tpu_torch.utils.cuda_build import (
    CudaKernel,
    CudaLibrary,
    kernel_input,
    ptr,
    stream_of,
)

# the forward launcher takes (feat, rois, b, h, w, c, r, ph, pw, s, scale,
# out, stream); the backward's takes (g, rois, ..., scale, scratch, dfeat,
# stream)
_SHAPE_ARGS = (ctypes.c_int,) * 8 + (ctypes.c_float,)
library = CudaLibrary("roi_align_stream.cu")
fwd_kernel = CudaKernel(
    library, "roi_align_stream_fwd",
    (ctypes.c_void_p, ctypes.c_void_p) + _SHAPE_ARGS + (ctypes.c_void_p, ctypes.c_void_p),
)
bwd_kernel = CudaKernel(
    library, "roi_align_stream_bwd",
    (ctypes.c_void_p, ctypes.c_void_p) + _SHAPE_ARGS + (ctypes.c_void_p,) * 3,
)
fwd_kernel_bf16 = CudaKernel(library, "roi_align_stream_fwd_bf16", fwd_kernel.argtypes)
bwd_kernel_bf16 = CudaKernel(library, "roi_align_stream_bwd_bf16", bwd_kernel.argtypes)
# the bf16 backward with a float32 epilogue: its sums unrounded, for the gates
bwd_kernel_bf16_f32 = CudaKernel(library, "roi_align_stream_bwd_bf16_f32", bwd_kernel.argtypes)
# the instance for each feature (forward) or cotangent (backward) dtype
FWD_KERNELS = {torch.float32: fwd_kernel, torch.bfloat16: fwd_kernel_bf16}
BWD_KERNELS = {torch.float32: bwd_kernel, torch.bfloat16: bwd_kernel_bf16}


def valid_rois(rois: torch.Tensor, spatial_scale: float) -> torch.Tensor:
    """(B, R) bool: the rois whose scaled ``x2 >= x1`` (the rest are the
    TPU kernels' inverted fillers)."""
    r = rois.float() * spatial_scale
    return r[..., 2] >= r[..., 0]


def roi_align_stream_plain(
    feat: torch.Tensor,
    rois: torch.Tensor,
    pooled: Tuple[int, int] = (7, 7),
    spatial_scale: float = 0.25,
    sample_ratio: int = 2,
) -> torch.Tensor:
    """Plain PyTorch streamed ROIAlign: (B, H, W, C) × (B, R, 4) →
    (B, R, ph, pw, C), on any device: the canvas-clamped ROIAlign, zeros for
    inverted rois."""
    out = roi_align_plain(feat, rois, pooled, spatial_scale, sample_ratio)
    keep = valid_rois(rois, spatial_scale)[..., None, None, None]
    return torch.where(keep, out, torch.zeros((), dtype=out.dtype, device=out.device))


def roi_align_stream_bwd_plain(
    g: torch.Tensor,
    rois: torch.Tensor,
    feat_shape,
    pooled: Tuple[int, int] = (7, 7),
    spatial_scale: float = 0.25,
    sample_ratio: int = 2,
) -> torch.Tensor:
    """Plain PyTorch backward: (B, R, ph, pw, C) cotangent → (B, H, W, C) f32,
    on any device: the scatter-add of ``roi_align_bwd_plain`` with the
    inverted rois dropped."""
    keep = valid_rois(rois, spatial_scale)[..., None, None, None]
    g = torch.where(keep, g.float(), torch.zeros((), device=g.device))
    return roi_align_bwd_plain(g, rois, feat_shape, pooled, spatial_scale, sample_ratio)


def bwd_scratch(b, h, w, r, pooled, sample_ratio, device) -> torch.Tensor:
    """The scratch kernel 5 takes: one table per (image, roi), which its
    set-up kernel writes and its tile kernel reads."""
    return table_scratch(library, "roi_align_stream_bwd_scratch_bytes", b, h, w, r, pooled,
                         sample_ratio, device)


def _roi_align_stream_cuda(feat, rois, pooled, spatial_scale, sample_ratio):
    feat = kernel_input("feat", feat, tuple(FWD_KERNELS), 4)
    launch = FWD_KERNELS[feat.dtype]
    rois = kernel_input("rois", rois, torch.float32, 3)
    b, h, w, c = feat.shape
    ph, pw = pooled
    if c % 4 or rois.shape[0] != b or rois.shape[2] != 4 or sample_ratio < 1:
        raise ValueError(
            f"feat {tuple(feat.shape)} (C % 4 == 0) / rois {tuple(rois.shape)} / "
            f"sample_ratio {sample_ratio} (>= 1)"
        )
    r = rois.shape[1]
    out = torch.empty((b, r, ph, pw, c), dtype=feat.dtype, device=feat.device)
    with torch.cuda.device(feat.device):
        launch(
            ptr(feat), ptr(rois), b, h, w, c, r, ph, pw, int(sample_ratio),
            float(spatial_scale), ptr(out), stream_of(feat),
        )
    launch.launches += 1
    return out


def _roi_align_stream_bwd_cuda(g, rois, feat_shape, pooled, spatial_scale, sample_ratio,
                               f32_sum=False):
    """The dfeat of a cotangent ``g`` of either dtype (kernel 5), of ``g``'s
    dtype; ``f32_sum`` takes a bf16 ``g``'s float32 sums unrounded (the
    gates' float32-epilogue instance)."""
    g = kernel_input("g", g, tuple(BWD_KERNELS), 5)
    f32_sum = f32_sum and g.dtype == torch.bfloat16
    launch = bwd_kernel_bf16_f32 if f32_sum else BWD_KERNELS[g.dtype]
    rois = kernel_input("rois", rois, torch.float32, 3)
    b, h, w, c = feat_shape
    r = rois.shape[1]
    ph, pw = pooled
    if c % 4 or tuple(g.shape) != (b, r, ph, pw, c) or tuple(rois.shape) != (b, r, 4):
        raise ValueError(
            f"g {tuple(g.shape)} / rois {tuple(rois.shape)} / feat {tuple(feat_shape)} (C % 4 == 0)"
        )
    # every element is written by the kernel: no zero fill
    dtype = torch.float32 if f32_sum else g.dtype
    dfeat = torch.empty((b, h, w, c), dtype=dtype, device=g.device)
    with torch.cuda.device(g.device):
        scratch = bwd_scratch(b, h, w, r, pooled, sample_ratio, g.device)
        launch(
            ptr(g), ptr(rois), b, h, w, c, r, ph, pw, int(sample_ratio),
            float(spatial_scale), ptr(scratch), ptr(dfeat), stream_of(g),
        )
    launch.launches += 1
    return dfeat


class RoIAlignStreamFunction(torch.autograd.Function):
    """Streamed ROIAlign on CUDA tensors: the forward launches kernel 4, the
    backward kernel 5, each in the feature's dtype (the bf16 backward
    rounds its float32 sums into a bf16 dfeat itself).  ``rois`` get no gradient, as the JAX
    vjp returns zeros for them."""

    @staticmethod
    def forward(ctx, feat, rois, pooled, spatial_scale, sample_ratio):
        ctx.save_for_backward(rois)
        ctx.meta = (tuple(feat.shape), pooled, spatial_scale, sample_ratio)
        return _roi_align_stream_cuda(feat, rois, pooled, spatial_scale, sample_ratio)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (rois,) = ctx.saved_tensors
        shape, pooled, spatial_scale, sample_ratio = ctx.meta
        dfeat = None
        if ctx.needs_input_grad[0]:
            dfeat = _roi_align_stream_bwd_cuda(g, rois, shape, pooled, spatial_scale,
                                               sample_ratio)
        return dfeat, None, None, None, None


def roi_align_stream(
    feat: torch.Tensor,
    rois: torch.Tensor,
    pooled: Tuple[int, int] = (7, 7),
    spatial_scale: float = 0.25,
    sample_ratio: int = 2,
) -> torch.Tensor:
    """(B, H, W, C) feature + (B, R, 4) image-coordinate rois →
    (B, R, ph, pw, C), differentiable in ``feat``; inverted rois pool to
    zeros."""
    if feat.device.type == "cpu":
        return roi_align_stream_plain(feat, rois, pooled, spatial_scale, sample_ratio)
    return RoIAlignStreamFunction.apply(feat, rois, pooled, spatial_scale, sample_ratio)
