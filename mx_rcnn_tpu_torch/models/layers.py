"""Shared NN building blocks (port of ``mx_rcnn_tpu/models/layers.py``).

Inside the modules activations are NCHW tensors (kept ``channels_last`` in
memory by the Predictor); the image, the feature map into ROIAlign and its
pooled output stay NHWC at the public functions, as in the JAX package.
Every BN is frozen: an affine ``x·mul + add`` from stored moments, eps 2e-5.

The compute dtype (``cfg.network.COMPUTE_DTYPE``, :func:`compute_dtype`) is
Flax's ``dtype`` beside ``param_dtype=float32``: a layer casts its input and
its parameters to it at use, so parameters, their gradients and the
optimizer's state stay float32 and only the activations are bfloat16; the
heads hand float32 out, as the JAX modules do.  ``FOLD_BN`` folds each
frozen BN into the conv before it (:func:`fold_conv_bn`,
:class:`ConvBNFolder`, :func:`make_conv_bn`): an exact rewrite under the
same parameter names.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 2e-5


def compute_dtype(cfg) -> torch.dtype:
    """The config's COMPUTE_DTYPE as a torch dtype (the JAX package's
    ``_dtype_of``)."""
    name = cfg.network.COMPUTE_DTYPE
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"COMPUTE_DTYPE {name!r}: float32 or bfloat16")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class FrozenBatchNorm(nn.Module):
    """y = (x − mean)/sqrt(var + eps)·γ + β, folded into one multiply-add
    with ``mul = scale·rsqrt(var + eps)``, ``add = bias − mean·mul`` as in
    the JAX module: ``mul`` and ``add`` in float32, cast to ``dtype`` and
    applied in ``dtype``.  The four tensors are buffers named like its
    params."""

    def __init__(self, channels: int, eps: float = BN_EPS, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def thaw_affine(self) -> None:
        """Make ``scale`` and ``bias`` trainable parameters, with the same
        names and values (``state_dict`` keys unchanged), as the JAX package
        trains them under a freeze set without ``"bn"``; ``mean`` / ``var``
        stay buffers."""
        for k in ("scale", "bias"):
            if k in self._buffers:
                self.register_parameter(k, nn.Parameter(self._buffers.pop(k)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = self.scale * torch.rsqrt(self.var + self.eps)
        add = self.bias - self.mean * mul
        dt = self.dtype
        return x.to(dt) * mul.to(dt)[None, :, None, None] + add.to(dt)[None, :, None, None]


class _CastAtUse:
    """Flax's ``dtype`` beside ``param_dtype=float32`` for a torch layer: the
    input, the kernel and the bias cast to ``compute_dtype`` at use, the
    output in that dtype.  In float32 the layer is torch's own."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def _cast(self, x: torch.Tensor):
        dt = self.compute_dtype
        return x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt)


class Conv2d(_CastAtUse, nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (Flax's ``nn.Conv``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*self._cast(x))


class ConvTranspose2d(_CastAtUse, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype`` (Flax's
    ``nn.ConvTranspose``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(*self._cast(x), self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class Linear(_CastAtUse, nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (Flax's ``nn.Dense``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*self._cast(x))


def conv(cin: int, cout: int, kernel: int, stride: int = 1, bias: bool = False,
         dtype: torch.dtype = torch.float32) -> Conv2d:
    """k×k conv with explicit symmetric ``(k−1)//2`` padding (not SAME: at
    stride 2 SAME pads (0, 1), every public checkpoint family pads
    symmetrically), computing in ``dtype``."""
    return Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=bias,
                  compute_dtype=dtype)


def _rows(w: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """An (O, I, kh, kw) kernel as an (O, I·kh·kw) view in its memory order
    (contiguous or channels_last), and the permutation of that order."""
    perm = (0, 1, 2, 3)
    if not w.is_contiguous() and w.is_contiguous(memory_format=torch.channels_last):
        perm = (0, 2, 3, 1)
    return w.permute(perm).reshape(w.shape[0], -1), perm


def _unrows(rows: torch.Tensor, like: torch.Tensor, perm: Tuple[int, ...]) -> torch.Tensor:
    """The inverse of :func:`_rows`: ``rows`` as a view of ``like``'s shape
    in ``like``'s memory order."""
    inverse = [perm.index(i) for i in range(4)]
    return rows.reshape([like.shape[i] for i in perm]).permute(inverse)


def fold_conv_bn(pairs: Sequence[Tuple[nn.Conv2d, FrozenBatchNorm]], dtype: torch.dtype
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each (conv, frozen BN) pair folded into one conv, ``(W·mul, add)``:
    both computed in float32, then cast to ``dtype`` (the JAX package's
    ``fused_conv_bn``).  Gradients reach the kernels through the fold; the
    BN buffers take none.

    The list takes a few launches in all, not a few per pair: the BN vectors
    are concatenated and ``mul`` and ``add`` computed once, and the kernels
    are grouped by row length (I·kh·kw), each group concatenated, scaled and
    cast at once and split back into views in each kernel's memory order."""
    bns = [bn for _, bn in pairs]
    (eps,) = {bn.eps for bn in bns}
    sizes = [bn.scale.numel() for bn in bns]
    scale, bias, mean, var = (torch.cat([getattr(bn, k) for bn in bns])
                              for k in ("scale", "bias", "mean", "var"))
    mul = scale * torch.rsqrt(var + eps)
    muls = torch.split(mul, sizes)
    adds = torch.split((bias - mean * mul).to(dtype), sizes)
    rows = [_rows(c.weight) for c, _ in pairs]
    groups: Dict[tuple, List[int]] = {}
    for i, (r, _) in enumerate(rows):
        groups.setdefault((r.shape[1], r.device), []).append(i)
    out: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = [None] * len(pairs)
    for idx in groups.values():
        w = torch.cat([rows[i][0] for i in idx]) * torch.cat([muls[i] for i in idx])[:, None]
        for i, piece in zip(idx, torch.split(w.to(dtype), [sizes[i] for i in idx])):
            out[i] = (_unrows(piece, pairs[i][0].weight, rows[i][1]), adds[i])
    return out


def _version_key(tensors: Sequence[torch.Tensor]) -> Optional[tuple]:
    """(address, version) of each tensor, which changes when one is replaced
    or written in place; None where a tensor keeps no version (an inference
    tensor)."""
    if any(t.is_inference() for t in tensors):
        return None
    return tuple((t.data_ptr(), t._version) for t in tensors)


class ConvBNFolder:
    """The folded kernels of a module's (conv, frozen BN) pairs, refolded
    only when needed.

    A pair whose kernel or BN affine takes a gradient in this forward (grad
    mode on and ``requires_grad``) is folded anew, into the autograd graph.
    Every other pair (inference, frozen layers) is folded once and kept
    until its kernel or a BN buffer is written or replaced (its
    ``_version`` or address changes), so a served model folds once.  Each
    call folds what it must in one :func:`fold_conv_bn` per kind."""

    def __init__(self, pairs: Sequence[Tuple[nn.Conv2d, FrozenBatchNorm]], dtype: torch.dtype):
        self.pairs = list(pairs)
        self.dtype = dtype
        self._cache: Dict[int, tuple] = {}

    def fold(self) -> Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]]:
        """{conv: (folded kernel, add)} for every pair."""
        graph = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()
        out, fresh, stale = {}, [], []
        for i, (c, bn) in enumerate(self.pairs):
            if graph and (c.weight.requires_grad or bn.scale.requires_grad):
                fresh.append(i)
                continue
            key = _version_key((c.weight, bn.scale, bn.bias, bn.mean, bn.var))
            hit = self._cache.get(i)
            if key is not None and hit is not None and hit[:2] == (key, inference):
                out[c] = hit[2]
            else:
                stale.append((i, key))
        if stale:
            with torch.no_grad():
                folded = fold_conv_bn([self.pairs[i] for i, _ in stale], self.dtype)
            for (i, key), f in zip(stale, folded):
                out[self.pairs[i][0]] = f
                if key is None:
                    self._cache.pop(i, None)
                else:
                    self._cache[i] = (key, inference, f)
        if fresh:
            for i, f in zip(fresh, fold_conv_bn([self.pairs[i] for i in fresh], self.dtype)):
                out[self.pairs[i][0]] = f
        return out


def make_conv_bn(folded: Optional[Dict] = None):
    """→ ``cbn(x, conv, bn)``: the one conv → frozen-BN wiring of both
    graphs (the JAX package's ``make_conv_bn``).  Unfolded (``folded``
    None): the conv, then the BN affine.  Folded: the conv with
    ``folded[conv]``'s kernel, its ``add`` as the conv's bias."""
    if folded is None:
        def cbn(x: torch.Tensor, conv_: Conv2d, bn: FrozenBatchNorm) -> torch.Tensor:
            return bn(conv_(x))
    else:
        def cbn(x: torch.Tensor, conv_: Conv2d, bn: FrozenBatchNorm) -> torch.Tensor:
            w, add = folded[conv_]
            return conv_._conv_forward(x.to(w.dtype), w, add)
    return cbn


_PIXEL_STATS: Dict = {}


def _pixel_stats(means, stds, device):
    """(means, 1 / stds) on ``device``, built once per (stats, device): a
    copy from host memory in every forward would make the host wait for the
    card."""
    key = (means, stds, device)
    if key not in _PIXEL_STATS:
        m = torch.tensor(means, dtype=torch.float32, device=device)
        _PIXEL_STATS[key] = (m, 1.0 / torch.tensor(stds, dtype=torch.float32, device=device))
    return _PIXEL_STATS[key]


def normalize_images(images: torch.Tensor, im_info: torch.Tensor, cfg) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB → normalized float32 with the bucket padding
    re-zeroed from ``im_info``; float batches pass through untouched."""
    if images.dtype != torch.uint8:
        return images
    dev = images.device
    means, inv_stds = _pixel_stats(tuple(cfg.network.PIXEL_MEANS), tuple(cfg.network.PIXEL_STDS),
                                   dev)
    out = (images.float() - means) * inv_stds
    bh, bw = images.shape[1], images.shape[2]
    rows = torch.arange(bh, dtype=torch.float32, device=dev)[None, :, None, None]
    cols = torch.arange(bw, dtype=torch.float32, device=dev)[None, None, :, None]
    mask = (rows < im_info[:, 0, None, None, None]) & (cols < im_info[:, 1, None, None, None])
    return out * mask


def make_pad_mask(im_info: torch.Tensor, canvas_hw):
    """→ ``fn(x)`` zeroing NCHW feature cells that sit on bucket padding.

    Cell (y, x) at stride s is valid iff ``s·y < h`` (and ``s·x < w``); the
    stride is the canvas/feature ratio snapped to a power of two."""
    ch, cw = float(canvas_hw[0]), float(canvas_hw[1])

    def snap(ratio: float) -> float:
        return float(2 ** round(math.log2(ratio))) if ratio > 1.0 else 1.0

    def apply(x: torch.Tensor) -> torch.Tensor:
        fh, fw = x.shape[2], x.shape[3]
        sy, sx = snap(ch / fh), snap(cw / fw)
        rows = torch.arange(fh, dtype=torch.float32, device=x.device) * sy
        cols = torch.arange(fw, dtype=torch.float32, device=x.device) * sx
        ok = (rows[None, :, None] < im_info[:, 0, None, None]) & (
            cols[None, None, :] < im_info[:, 1, None, None]
        )
        return x * ok[:, None].to(x.dtype)

    return apply


def pad_feat_to_ladder(feat: torch.Tensor, stride: int, shape_buckets) -> torch.Tensor:
    """Zero-pad a (B, H, W, C) feature map to the bucket ladder's max extent
    at this stride, so the second stage sees one shape on every bucket."""
    if not shape_buckets:
        return feat
    th = max(feat.shape[1], max(-(-bh // stride) for bh, _ in shape_buckets))
    tw = max(feat.shape[2], max(-(-bw // stride) for _, bw in shape_buckets))
    if (th, tw) == (feat.shape[1], feat.shape[2]):
        return feat
    return F.pad(feat, (0, 0, 0, tw - feat.shape[2], 0, th - feat.shape[1]))
