"""Parameter trees: the weight bridge from the JAX package's trees, a tree
map, and a thin `nn.Module` container that registers a tree's tensors.

A parameter tree is nested dicts and lists whose leaves are tensors,
`QTensor`s or None, with the JAX package's key names ("layers", "wqkv",
"w13", "fast_output", ...). `params_from_jax_numpy` takes such a tree already
converted to numpy by the caller (so this module needs no JAX) and returns the
same tree of torch tensors, `QTensor` leaves kept.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch
from torch import nn

from smoltts_torch.ops.quant import QTensor


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply `fn` to every tensor leaf (each field of a QTensor is a leaf)."""
    if isinstance(tree, QTensor):
        return QTensor(q=fn(tree.q), scale=fn(tree.scale))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _is_qtensor_like(node) -> bool:
    # A QTensor that went through numpy conversion keeps its fields (the
    # caller's tree map rebuilds NamedTuples), but it is not this module's
    # QTensor class: match it by its field names.
    return isinstance(node, tuple) and getattr(node, "_fields", None) == ("q", "scale")


def params_from_jax_numpy(tree: Any) -> Any:
    """numpy tree (from `jax.tree.map(np.asarray, params)`) -> torch tree on
    the CPU. bfloat16 leaves come out of JAX as numpy arrays of dtype
    `bfloat16` (ml_dtypes); they are carried bit for bit."""

    def leaf(a):
        a = np.array(a)  # a writable copy: JAX hands out read-only buffers
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    def walk(node):
        if _is_qtensor_like(node):
            q, s = node
            return QTensor(q=leaf(q), scale=leaf(s))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if node is None:
            return None
        return leaf(node)

    return walk(tree)


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, QTensor):
        return [(prefix + ".q", tree.q), (prefix + ".scale", tree.scale)]
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flatten(v, f"{prefix}.{k}" if prefix else str(k))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}.{i}" if prefix else str(i))
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


class TensorTree(nn.Module):
    """Registers every tensor of a parameter tree as a buffer, so
    `.to(device)` and `state_dict()` work; `.tree()` rebuilds the nested
    tree over the module's current tensors."""

    def __init__(self, tree: Any):
        super().__init__()
        self._skeleton = tree_map(lambda t: None, tree)
        self._names = []
        for name, t in _flatten(tree):
            key = name.replace(".", "__")
            self.register_buffer(key, t)
            self._names.append(name)

    def tree(self) -> Any:
        lookup = {n: getattr(self, n.replace(".", "__")) for n in self._names}

        def build(node, prefix):
            if isinstance(node, QTensor):
                return QTensor(q=lookup[prefix + ".q"], scale=lookup[prefix + ".scale"])
            if isinstance(node, dict):
                return {k: build(v, f"{prefix}.{k}" if prefix else str(k)) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(
                    build(v, f"{prefix}.{i}" if prefix else str(i)) for i, v in enumerate(node)
                )
            return lookup.get(prefix)

        return build(self._skeleton, "")
