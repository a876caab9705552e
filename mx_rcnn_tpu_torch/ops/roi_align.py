"""ROIAlign forward and backward (port of the box path of
``mx_rcnn_tpu/ops/roi_align.py`` and of ``ops/pallas/roi_align.py``).

:func:`roi_align` is the batched, differentiable forward: CUDA tensors go
through :class:`RoIAlignFunction`, whose forward launches kernel 2 (the
template of ``csrc/roi_align_fwd.cuh`` under the resident tap rule on float32
maps, ``csrc/roi_align_fwd_bf16.cuh``'s on bf16 ones; any sample ratio and
pooled size) and whose backward launches kernel 3 (both
exported by ``csrc/roi_align.cu``; the backward is deterministic, and takes
a scratch for its per-roi tables, :func:`bwd_scratch`); CPU tensors run
:func:`roi_align_plain`, which torch autograd differentiates.  With
``valid_hw`` the samples clamp to the valid feature extent (the gather path
``roi_align`` of the JAX package, which the eval forward takes); without it
they clamp to the canvas (the Pallas kernel ``roi_align_pallas``, which the
train step takes).  :func:`roi_align_bwd_plain` is the backward's plain
version: an explicit scatter-add over the same taps.

Features are float32 or bfloat16 (the compute dtype), each dtype its own
instance of each kernel with its own launch count (:data:`FWD_KERNELS`,
:data:`BWD_KERNELS`): taps, weights and sums in float32, the forward's output
rounded once to the feature's dtype (the bf16 forward is
``csrc/roi_align_fwd_bf16.cuh``, which computes what the float32 template
would on the same bf16 values, its launch plan :func:`fwd_bf16_plan`); the
backward reads a cotangent of that
dtype and writes dfeat in it, the bf16 kernel rounding each float32 sum once
as it stores it (the JAX package's ``_roi_align_bwd_impl`` casts its float32
sum outside the kernel: the same values).  The bf16 backward's float32
epilogue (:data:`bwd_kernel_bf16_f32`, the same sums unrounded) is a
measuring aid for the card's gates, on no path.  No tensor is converted to
reach a kernel: another dtype raises.

:func:`extract_roi_features_batched` routes as the JAX package does: maps
that :func:`fits_vmem` go to :func:`roi_align` (kernels 2/3), larger ones in
a differentiated graph to ``ops/roi_align_stream.py`` (kernels 4/5).
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

# the forward launcher takes (feat, rois, valid_hw, b, h, w, c, r, ph, pw, s,
# scale, out, stream); the backward's (g, rois, valid_hw, ..., scale,
# scratch, dfeat, stream)
_IN_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 8 + (ctypes.c_float,)
library = CudaLibrary("roi_align.cu")
kernel = CudaKernel(library, "roi_align_fwd", _IN_ARGS + (ctypes.c_void_p,) * 2)
bwd_kernel = CudaKernel(library, "roi_align_bwd", _IN_ARGS + (ctypes.c_void_p,) * 3)
kernel_bf16 = CudaKernel(library, "roi_align_fwd_bf16", _IN_ARGS + (ctypes.c_void_p,) * 2)
bwd_kernel_bf16 = CudaKernel(library, "roi_align_bwd_bf16", _IN_ARGS + (ctypes.c_void_p,) * 3)
# the bf16 backward with a float32 epilogue: its sums unrounded, for the gates
bwd_kernel_bf16_f32 = CudaKernel(library, "roi_align_bwd_bf16_f32", bwd_kernel_bf16.argtypes)
# the instance for each feature (forward) or cotangent (backward) dtype
FWD_KERNELS = {torch.float32: kernel, torch.bfloat16: kernel_bf16}
BWD_KERNELS = {torch.float32: bwd_kernel, torch.bfloat16: bwd_kernel_bf16}


# the bf16 forward's launch plan (csrc/roi_align_fwd_bf16.cuh): warps a block,
# one output row each; sample ratios with a compiled-in instance (larger ones
# take the run-time instance)
FWD_BF16_WARPS, FWD_BF16_MAX_S = 7, 4
_LANES = 32
_TAP_BYTES = 16  # a Tap or an XStep


def fwd_bf16_plan(b: int, h: int, w: int, c: int, r: int, pooled, sample_ratio: int) -> dict:
    """The launch plan of the bf16 forwards (kernels 2 and 4 on bf16 maps),
    from the shapes only, as the library's ``roi_align_fwd_bf16_plan``
    computes it: ``vec_bytes`` of a lane (16, eight channels; 8, four, where
    C % 8 == 4 and a cell's stride is not 16-byte aligned), ``warps`` a
    block, row ``groups`` and channel ``slices`` a roi, the ``blocks`` and a
    block's dynamic shared memory ``smem`` in bytes.  Block (image, roi,
    slice k, group g) computes the output rows g·warps + warp, lane l the
    channels of vector 32·k + l."""
    ph, pw = pooled
    s = int(sample_ratio)
    if s < 1 or c % 4 or min(b, c, r, ph, pw) < 0 or min(h, w) < 1:
        raise ValueError(f"no plan for {(b, h, w, c, r, ph, pw, s)}")
    vec_bytes = 16 if c % 8 == 0 else 8
    cv = c // (vec_bytes // 2)
    groups = -(-ph // FWD_BF16_WARPS)
    slices = -(-cv // _LANES)
    nx = pw * s
    # the x steps, the block's rows' y taps, the distinct columns (at most 2 nx)
    return {"vec_bytes": vec_bytes, "warps": FWD_BF16_WARPS, "groups": groups, "slices": slices,
            "blocks": r * groups * slices * b,
            "smem": _TAP_BYTES * nx + _TAP_BYTES * FWD_BF16_WARPS * s + 4 * 2 * nx}


def fwd_bf16_plan_of_library(b, h, w, c, r, pooled, sample_ratio) -> dict:
    """:func:`fwd_bf16_plan` as the built library computes it (card only)."""
    fn = library.lib().roi_align_fwd_bf16_plan
    fn.argtypes, fn.restype = (ctypes.c_int,) * 8 + (ctypes.c_void_p,), ctypes.c_int
    out = (ctypes.c_longlong * 6)()
    rc = fn(b, h, w, c, r, pooled[0], pooled[1], int(sample_ratio), out)
    if rc:
        raise ValueError(f"roi_align_fwd_bf16_plan failed with cudaError {rc}")
    return dict(zip(("vec_bytes", "warps", "groups", "slices", "blocks", "smem"), list(out)))


def table_scratch(lib: CudaLibrary, function: str, b, h, w, r, pooled, sample_ratio, device):
    """The scratch of a table backward (kernel 3, or kernel 5 in
    ``ops/roi_align_stream.py``): one table per (image, roi), which its
    set-up kernel writes and its tile kernel reads; ``function`` is the
    library's export that sizes it."""
    fn = getattr(lib.lib(), function)
    fn.argtypes, fn.restype = (ctypes.c_int,) * 7, ctypes.c_longlong
    nbytes = fn(b, h, w, r, pooled[0], pooled[1], int(sample_ratio))
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


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
    at a time to bound the (chunk, ph·s, W, C) row intermediate.  Taps,
    weights and sums are float32 whatever the feature's dtype; the output,
    of the feature's dtype, rounds each sum once.  Differentiated, a
    bfloat16 map's gradient is summed in float32 and rounded once."""
    b, hf, wf, c = feat.shape
    r = rois.shape[1]
    ph, pw = pooled
    s = sample_ratio
    (ylo, yhi, wy0, wy1), (xlo, xhi, wx0, wx1) = _roi_taps(
        rois, hf, wf, pooled, spatial_scale, s, valid_hw
    )

    out = feat.new_empty((b, r, ph, pw, c))
    for i in range(b):
        f = feat[i].float()
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
    feat = kernel_input("feat", feat, tuple(FWD_KERNELS), 4)
    launch = FWD_KERNELS[feat.dtype]
    rois = kernel_input("rois", rois, torch.float32, 3)
    b, h, w, c = feat.shape
    if c % 4 or rois.shape[0] != b or rois.shape[2] != 4 or sample_ratio < 1:
        raise ValueError(
            f"feat {tuple(feat.shape)} (C % 4 == 0) / rois {tuple(rois.shape)} / "
            f"sample_ratio {sample_ratio} (>= 1)"
        )
    valid_hw = _kernel_valid_hw(valid_hw, b)
    r = rois.shape[1]
    ph, pw = pooled
    out = torch.empty((b, r, ph, pw, c), dtype=feat.dtype, device=feat.device)
    with torch.cuda.device(feat.device):
        launch(
            ptr(feat), ptr(rois), ptr(valid_hw), b, h, w, c, r, ph, pw,
            int(sample_ratio), float(spatial_scale), ptr(out), stream_of(feat),
        )
    launch.launches += 1
    return out


def bwd_scratch(b, h, w, r, pooled, sample_ratio, device) -> torch.Tensor:
    """The scratch kernel 3 takes (its per-roi tables)."""
    return table_scratch(library, "roi_align_bwd_scratch_bytes", b, h, w, r, pooled,
                         sample_ratio, device)


def _roi_align_bwd_cuda(g, rois, feat_shape, pooled, spatial_scale, sample_ratio, valid_hw,
                        f32_sum=False):
    """The dfeat of a cotangent ``g`` of either dtype (kernel 3), of ``g``'s
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
    valid_hw = _kernel_valid_hw(valid_hw, b)
    # every element is written by the kernel: no zero fill
    dtype = torch.float32 if f32_sum else g.dtype
    dfeat = torch.empty((b, h, w, c), dtype=dtype, device=g.device)
    with torch.cuda.device(g.device):
        scratch = bwd_scratch(b, h, w, r, pooled, sample_ratio, g.device)
        launch(
            ptr(g), ptr(rois), ptr(valid_hw), b, h, w, c, r, ph, pw,
            int(sample_ratio), float(spatial_scale), ptr(scratch), ptr(dfeat), stream_of(g),
        )
    launch.launches += 1
    return dfeat


class RoIAlignFunction(torch.autograd.Function):
    """ROIAlign on CUDA tensors: the forward launches kernel 2, the
    backward kernel 3, each in the feature's dtype (the bf16 backward
    rounds its float32 sums into a bf16 dfeat itself).  ``rois`` and
    ``valid_hw`` get no gradient, as the JAX vjp returns zeros for the rois
    (proposals are a stop-gradient input of the second stage)."""

    @staticmethod
    def forward(ctx, feat, rois, pooled, spatial_scale, sample_ratio, valid_hw):
        ctx.save_for_backward(rois, valid_hw)
        ctx.meta = (tuple(feat.shape), pooled, spatial_scale, sample_ratio)
        return _roi_align_cuda(feat, rois, pooled, spatial_scale, sample_ratio, valid_hw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        rois, valid_hw = ctx.saved_tensors
        shape, pooled, spatial_scale, sample_ratio = ctx.meta
        dfeat = None
        if ctx.needs_input_grad[0]:
            dfeat = _roi_align_bwd_cuda(g, rois, shape, pooled, spatial_scale, sample_ratio,
                                        valid_hw)
        return dfeat, None, None, None, None, None


def roi_align(
    feat: torch.Tensor,
    rois: torch.Tensor,
    pooled: Tuple[int, int] = (14, 14),
    spatial_scale: float = 1.0 / 16.0,
    sample_ratio: int = 2,
    valid_hw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, W, C) float32 or bfloat16 feature + (B, R, 4) float32
    image-coordinate rois → (B, R, ph, pw, C) of the feature's dtype,
    differentiable in ``feat``.  ``valid_hw`` (B, 2): true pre-padding image
    sizes."""
    if feat.device.type == "cpu":
        return roi_align_plain(
            feat, rois, pooled, spatial_scale, sample_ratio, valid_hw
        )
    return RoIAlignFunction.apply(feat, rois, pooled, spatial_scale, sample_ratio, valid_hw)


# The JAX package's routing between its two Pallas ROIAlign kernels
# (``mx_rcnn_tpu/ops/pallas/roi_align.py::_cblk, _VMEM_BUDGET,
# _resident_bytes, fits_vmem``), reproduced so that each TPU kernel's
# counterpart sits at the same call site.  Whether the H100 wants another
# split is a later, measured question.
_VMEM_BUDGET = 8 * 2**20

_RBLK = 8  # rois per grid step of the resident TPU kernels


def _cblk(c: int, largest: int = 512) -> int:
    for blk in (512, 256, 128):
        if blk <= largest and c % blk == 0:
            return blk
    return c


def _resident_bytes(h: int, w: int, blk: int, esize: int, pooled_max: int = 14) -> int:
    """The resident TPU kernels' per-step working set: the (H, W, blk)
    slab plus the f32 stacked roi-block intermediate."""
    pooled_stack = _RBLK * pooled_max
    return (h * w * esize + pooled_stack * h * 4) * blk


def fits_vmem(h: int, w: int, c: int, pooled_max: int = 14) -> bool:
    """True iff the JAX package sends an (H, W, C) map to its resident
    kernels (here kernels 2/3) rather than its streaming ones (4/5).  It
    takes no dtype: the JAX function sizes the float32 backward, so a
    bfloat16 map routes as a float32 one."""
    return _resident_bytes(h, w, _cblk(c, largest=128), 4, pooled_max) <= _VMEM_BUDGET


def extract_roi_features_batched(
    feat: torch.Tensor,
    rois: torch.Tensor,
    mode: str,
    pooled: Tuple[int, int],
    spatial_scale: float,
    sample_ratio: int = 2,
    fwd_only: bool = False,
    valid_hw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, W, C) × (B, R, 4) → (B, R, ph, pw, C), dispatched on config
    ROI_MODE (only 'roi_align' is ported).

    Without ``valid_hw`` a map that :func:`fits_vmem` goes to
    :func:`roi_align` (kernels 2/3 on CUDA tensors), a larger one in a graph
    that differentiates it (``fwd_only`` False) to
    :func:`~mx_rcnn_tpu_torch.ops.roi_align_stream.roi_align_stream`
    (kernels 4/5), whose rule for inverted rois differs.  Everything else
    goes to :func:`roi_align`.  CPU tensors take each route's plain
    version."""
    if mode == "roi_pool":
        raise NotImplementedError("roi_pool (the VGG-16 family) is not ported yet")
    if mode != "roi_align":
        raise ValueError(f"unknown ROI_MODE {mode!r}")
    if valid_hw is None and not fwd_only and not fits_vmem(
        feat.shape[1], feat.shape[2], feat.shape[3], pooled_max=max(pooled)
    ):
        from mx_rcnn_tpu_torch.ops import roi_align_stream as stream

        return stream.roi_align_stream(feat, rois, pooled, spatial_scale, sample_ratio)
    return roi_align(feat, rois, pooled, spatial_scale, sample_ratio, valid_hw)
