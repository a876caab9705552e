"""int8 weight-only quantization for the serve-graph compression ladder
(port of ``mx_rcnn_tpu/core/quantize.py``, bit for bit on the same tree).

The rung below bf16: every weight matrix/kernel is stored as int8 with a
per-output-channel symmetric scale, and the serve graph's weights are the
dequantized ``q.astype(f32) * scale``.  Activations and accumulation stay
f32 (weight-only quantization), so the numerics are the f32 graph's with
~2^-7 relative weight error — small enough to pass the same warmup
detection/mask parity gate that guards bf16, which is exactly the
contract: a rung that drifts refuses to serve.  As in the JAX package,
this is not an int8 kernel: the runner dequantizes once, when it builds
or swaps a slot, and the forward runs the f32 graph.

Quantization layout
-------------------

The functions take a Flax-layout tree (nested dicts of numpy arrays, the
layout ``utils/bridge.py::state_dict_to_flax`` gives a ``state_dict``),
where the output-channel axis is LAST on every kernel (conv ``(kh, kw,
in, out)``, dense ``(in, out)``), so the scale is the per-last-axis absmax
over 127 with ``keepdims=True`` and dequantization is a plain broadcast
multiply for any rank.  Only floating leaves with ``ndim >= 2`` quantize
(the weights); biases, BN affine/stats and other vectors stay f32.

A quantized leaf is a plain dict ``{"int8_q": int8[...], "int8_scale":
f32[..., 1-per-channel]}``, so the quantized tree's structure is a pure
function of the f32 tree's: the registry's swap-time structure gate (f32
vs f32) stays the one authority.  Scales are computed once per ``(model,
version)`` by the registry
(:meth:`~mx_rcnn_tpu_torch.serve.registry.ModelRegistry.quantized_tree`),
never per slot and never on the predict path.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

#: the two keys that make a dict a quantized-leaf container — checked
#: exactly (a params sub-dict that happened to carry these names would
#: be a collision; no flax module in this repo names params this way)
QKEYS = frozenset({"int8_q", "int8_scale"})


def is_quantized_leaf(x: Any) -> bool:
    """True for the ``{"int8_q", "int8_scale"}`` container produced by
    :func:`quantize_leaf` (usable as a ``tree_map`` ``is_leaf``)."""
    return isinstance(x, dict) and set(x.keys()) == QKEYS


def quantize_leaf(w: np.ndarray) -> Dict[str, np.ndarray]:
    """One weight array → per-output-channel symmetric int8.

    ``scale[c] = absmax(w[..., c]) / 127`` (keepdims, so dequantization
    broadcasts for any rank); zero channels get scale 1.0 so the
    round-trip is exact zeros instead of 0/0."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(range(w.ndim - 1))
    amax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    scale = np.where(scale > 0.0, scale, np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return {"int8_q": q, "int8_scale": scale}


def _should_quantize(leaf: Any) -> bool:
    arr = np.asarray(leaf)
    return arr.ndim >= 2 and np.issubdtype(arr.dtype, np.floating)


def _tree_map(fn, tree: Any, is_leaf=None) -> Any:
    """``fn`` over the leaves of a tree of nested dicts, lists and tuples
    (``is_leaf`` stops the descent at a node)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def _tree_leaves(tree: Any, is_leaf=None) -> list:
    out: list = []
    _tree_map(out.append, tree, is_leaf)
    return out


def quantize_tree(params: Any) -> Any:
    """f32 params tree → mixed tree: every ``ndim >= 2`` float leaf
    becomes a quantized-leaf container, everything else passes through
    as numpy (host-side)."""

    def q(leaf):
        if _should_quantize(leaf):
            return quantize_leaf(np.asarray(leaf))
        return np.asarray(leaf)

    return _tree_map(q, params)


def dequantize_tree(params: Any) -> Any:
    """Mixed quantized tree → f32 tree: each quantized leaf's
    ``int8_q.astype(f32) * int8_scale``."""

    def dq(x):
        if is_quantized_leaf(x):
            return x["int8_q"].astype(np.float32) * x["int8_scale"]
        return x

    return _tree_map(dq, params, is_leaf=is_quantized_leaf)


def quantization_stats(params: Any, qtree: Any) -> Dict[str, Any]:
    """Byte accounting + worst-case round-trip error of a quantized
    tree vs its f32 source — the compression-ladder evidence the bench
    records (int8 rung ≈ 4x smaller weights)."""
    f32_bytes = sum(int(np.asarray(leaf).nbytes) for leaf in _tree_leaves(params))
    q_bytes = 0
    max_rel_err = 0.0
    quantized = 0
    for leaf in _tree_leaves(qtree, is_leaf=is_quantized_leaf):
        if is_quantized_leaf(leaf):
            quantized += 1
            q_bytes += int(leaf["int8_q"].nbytes + leaf["int8_scale"].nbytes)
            # per-leaf worst-case |dequant - orig| <= scale/2 by
            # construction; report the bound relative to the leaf absmax
            amax = float(np.max(leaf["int8_scale"]) * 127.0)
            if amax > 0:
                max_rel_err = max(
                    max_rel_err, float(np.max(leaf["int8_scale"])) / 2.0 / amax
                )
        else:
            q_bytes += int(np.asarray(leaf).nbytes)
    return {
        "f32_bytes": f32_bytes,
        "int8_bytes": q_bytes,
        "compression_x": round(f32_bytes / q_bytes, 3) if q_bytes else None,
        "quantized_leaves": quantized,
        "max_rel_round_err_bound": round(max_rel_err, 6),
    }
