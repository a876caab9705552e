"""Parameter bridge between a Flax parameter tree and the port's modules.

``params_np`` is the Flax tree as nested dicts of numpy arrays (the caller
runs ``jax.tree.map(np.asarray, params)``); no JAX is imported here, so the
bridge also runs where JAX is absent.  The port's module names follow the
Flax tree (top level ``backbone``, ``top_head``, ``rpn``, ``rcnn``), so a
leaf at path ``a/b/kernel`` is the tensor ``a.b.weight``:

- an HWIO conv kernel becomes an OIHW weight;
- a Dense kernel (in, out) becomes a Linear weight (out, in);
- biases and the frozen-BN ``scale/bias/mean/var`` map one to one.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _to_torch_layout(leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return a
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


def flax_to_torch(params_np: Dict, model: nn.Module) -> nn.Module:
    """Load a Flax tree into ``model``; every leaf and every tensor of the
    model must be matched, with equal shapes."""
    state = model.state_dict()
    new = {}
    for path, a in _leaves(params_np):
        leaf = path[-1]
        key = ".".join(path[:-1] + ("weight" if leaf == "kernel" else leaf,))
        if key not in state:
            raise KeyError(f"Flax leaf {'/'.join(path)} has no tensor {key} in the model")
        t = np.array(_to_torch_layout(leaf, a), dtype=np.float32, order="C")
        if t.shape != tuple(state[key].shape):
            raise ValueError(f"{key}: Flax {a.shape} → {t.shape} != model {tuple(state[key].shape)}")
        new[key] = torch.from_numpy(t)
    missing = sorted(set(state) - set(new))
    if missing:
        raise KeyError(f"model tensors with no Flax leaf: {missing[:5]} (+{max(len(missing) - 5, 0)})")
    model.load_state_dict(new)
    return model


def _flax_tree(named: Iterator[Tuple[str, torch.Tensor]]) -> Dict:
    """Dotted names and tensors → a Flax-layout tree of numpy arrays."""
    tree: Dict = {}
    for key, t in named:
        *mods, leaf = key.split(".")
        a = t.detach().cpu().numpy()
        if leaf == "weight":
            leaf = "kernel"
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
