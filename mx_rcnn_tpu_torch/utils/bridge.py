"""Parameter bridge between a Flax parameter tree and the port's modules.

``params_np`` is the Flax tree as nested dicts of numpy arrays (the caller
runs ``jax.tree.map(np.asarray, params)``); no JAX is imported here, so the
bridge also runs where JAX is absent.  The port's module names follow the
Flax tree (top level ``backbone``, ``top_head``, ``rpn``, ``rcnn``, and in
FPN models ``neck`` and ``mask_head``), so a leaf at path ``a/b/kernel`` is
the tensor ``a.b.weight``:

- an HWIO conv kernel becomes an OIHW weight;
- a Dense kernel (in, out) becomes a Linear weight (out, in);
- the mask head's ``ConvTranspose`` kernel (HWIO) becomes a
  ``ConvTranspose2d`` weight (in, out, kh, kw), flipped in both spatial axes
  (``models/heads.py::MaskHead``);
- biases and the frozen-BN ``scale/bias/mean/var`` map one to one.

A whole train state crosses too (:func:`flax_state_to_torch`,
:func:`torch_state_to_flax`): the JAX ``TrainState``'s ``step`` is the
port's update count, its ``params`` the model's tensors, and the optax
``trace`` under ``multi_transform``'s ``"train"`` branch each trainable
tensor's momentum buffer, in the same layouts as the weights.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# Flax ConvTranspose modules: HWIO kernels that torch's ConvTranspose2d
# holds as (in, out, kh, kw), flipped in both spatial axes (models/heads.py)
_TRANSPOSED = ("mask_deconv",)


def _to_torch_layout(path: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return a
    if path[-2] in _TRANSPOSED:
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


def flax_to_torch(params_np: Dict, model: nn.Module, partial: bool = False) -> nn.Module:
    """Load a Flax tree into ``model``; every leaf and every tensor of the
    model must be matched, with equal shapes.  ``partial``: only the
    model's tensors under the tree's top-level names must be matched, and
    the others stay as they are."""
    state = model.state_dict()
    new = {}
    for path, a in _leaves(params_np):
        leaf = path[-1]
        key = ".".join(path[:-1] + ("weight" if leaf == "kernel" else leaf,))
        if key not in state:
            raise KeyError(f"Flax leaf {'/'.join(path)} has no tensor {key} in the model")
        t = np.array(_to_torch_layout(path, a), dtype=np.float32, order="C")
        if t.shape != tuple(state[key].shape):
            raise ValueError(f"{key}: Flax {a.shape} → {t.shape} != model {tuple(state[key].shape)}")
        new[key] = torch.from_numpy(t)
    missing = sorted(k for k in set(state) - set(new) if not partial or k.split(".")[0] in params_np)
    if missing:
        raise KeyError(f"model tensors with no Flax leaf: {missing[:5]} (+{max(len(missing) - 5, 0)})")
    model.load_state_dict(new, strict=not partial)
    return model


def _flax_tree(named: Iterator[Tuple[str, torch.Tensor]]) -> Dict:
    """Dotted names and tensors → a Flax-layout tree of numpy arrays."""
    tree: Dict = {}
    for key, t in named:
        *mods, leaf = key.split(".")
        a = t.detach().cpu().numpy()
        if leaf == "weight":
            leaf = "kernel"
            if mods[-1] in _TRANSPOSED:
                a = a.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


def torch_to_flax(model: nn.Module) -> Dict:
    """The model's tensors as a Flax-layout tree of numpy arrays."""
    return _flax_tree(iter(model.state_dict().items()))


def grads_to_flax(model: nn.Module) -> Dict:
    """The ``.grad`` of every parameter that has one, as a Flax-layout tree
    of numpy arrays (the same transposes as :func:`torch_to_flax`)."""
    return _flax_tree((k, p.grad) for k, p in model.named_parameters() if p.grad is not None)


def _torch_path(name: str) -> Tuple[str, ...]:
    """A dotted tensor name → its Flax path (``weight`` is ``kernel``)."""
    *mods, leaf = name.split(".")
    return tuple(mods) + ("kernel" if leaf == "weight" else leaf,)


def _jax_state_parts(state_np: Any) -> Tuple[int, Dict, Dict]:
    """(step, params, trace) of a JAX ``TrainState`` with numpy leaves (its
    ``opt_state`` the ``multi_transform`` of ``mx_rcnn_tpu/core/train.py``:
    the trace is the ``TraceState`` in the ``"train"`` branch's chain, where
    the frozen leaves are ``MaskedNode``s) or of a
    :func:`torch_state_to_flax` dict."""
    if isinstance(state_np, dict):
        return int(state_np["step"]), state_np["params"], state_np["trace"]
    chain = state_np.opt_state.inner_states["train"].inner_state
    traces = [s.trace for s in chain if hasattr(s, "trace")]
    if len(traces) != 1:
        raise ValueError(f"the train branch holds {len(traces)} trace states, not 1")
    return int(np.asarray(state_np.step)), state_np.params, traces[0]


def flax_state_to_torch(state_np: Any, train_state) -> Any:
    """Load a JAX train state (numpy leaves, see :func:`_jax_state_parts`)
    into the port's ``TrainState`` in place: the weights
    (:func:`flax_to_torch`), every trainable tensor's momentum buffer from
    the trace (none at step 0, as before the port's first update: optax's
    first trace is the gradient, as from a zero trace) and the count."""
    step, params, trace = _jax_state_parts(state_np)
    flax_to_torch(params, train_state.model)
    leaves = dict(_leaves(trace))
    momentum = {}
    for name, p in zip(train_state.names, train_state.optimizer.params):
        path = _torch_path(name)
        if step == 0:
            momentum[name] = None
            continue
        if path not in leaves:
            raise KeyError(f"{name}: no trace leaf {'/'.join(path)} in the JAX state")
        t = np.array(_to_torch_layout(path, leaves[path]), dtype=np.float32, order="C")
        if t.shape != tuple(p.shape):
            raise ValueError(f"{name}: trace {t.shape} != parameter {tuple(p.shape)}")
        momentum[name] = torch.from_numpy(t)
    return train_state.load_state_tree({
        "model": {k: v.detach() for k, v in train_state.model.state_dict().items()},
        "momentum": momentum,
        "count": step,
    })


def torch_state_to_flax(train_state) -> Dict:
    """The port's train state as ``{"step", "params", "trace"}``: the update
    count, the model's tensors (:func:`torch_to_flax`) and the trainable
    tensors' momentum buffers as a Flax-layout tree (zeros before a tensor's
    first update, optax's initial trace)."""
    opt = train_state.optimizer
    named = []
    for name, p in zip(train_state.names, opt.params):
        buf = opt.sgd.state[p].get("momentum_buffer")
        named.append((name, torch.zeros_like(p) if buf is None else buf))
    return {"step": np.int32(opt.count), "params": torch_to_flax(train_state.model),
            "trace": _flax_tree(iter(named))}
