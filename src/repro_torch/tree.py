"""Minimal pytree helpers for the port's parameter trees.

Parameters are nested ``dict`` / ``tuple`` / ``list`` containers whose
leaves are tensors, :class:`~repro_torch.core.quantize.QTensor` s or
plain values — the same shapes as the reference's JAX pytrees, so paths
(``layers/0/mixer/wq``) and quantization policies carry over unchanged.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``fn(path, leaf)`` over every leaf; containers are rebuilt with the
    same type.  Paths join keys and tuple indices with ``/``."""
    def join(k):
        return f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn(leaf, *other_leaves)`` over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]
