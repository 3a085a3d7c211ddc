"""Pytrees of tensors in JAX's leaf order.

``jax.tree.flatten`` orders a dict's leaves by **sorted** key, while
``torch.utils._pytree`` keeps insertion order.  The arena layout and the
leaf order must match the JAX package's, so the port flattens with its
own sorted-key walk.  Dicts, lists and tuples are nodes, ``None`` is an
empty node, anything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable


def _walk(t: Any, leaves: list) -> Any:
    if isinstance(t, dict):
        keys = sorted(t)
        return (dict, keys, [_walk(t[k], leaves) for k in keys])
    if isinstance(t, (list, tuple)):
        return (type(t), None, [_walk(v, leaves) for v in t])
    if t is None:
        return (None, None, [])
    leaves.append(t)
    return None


def _build(spec: Any, it) -> Any:
    if spec is None:
        return next(it)
    kind, keys, children = spec
    if kind is None:
        return None
    vals = [_build(c, it) for c in children]
    return dict(zip(keys, vals)) if kind is dict else kind(vals)


# Module-level recursion, not nested closures: a recursive closure is a
# reference cycle, and a cycle holding the leaves would keep gigabytes of
# device memory alive until the cyclic garbage collector happens to run.
def flatten(tree: Any) -> tuple[list, Any]:
    """Leaves in JAX's order, and the structure to rebuild the tree."""
    leaves: list = []
    spec = _walk(tree, leaves)
    return leaves, spec


def unflatten(spec: Any, leaves: list) -> Any:
    """Inverse of :func:`flatten`."""
    return _build(spec, iter(leaves))


def map_leaves(fn: Callable, tree: Any) -> Any:
    leaves, spec = flatten(tree)
    return unflatten(spec, [fn(l) for l in leaves])


def _walk_paths(t: Any, path: tuple, out: list) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _walk_paths(t[k], path + (k,), out)
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            _walk_paths(v, path + (i,), out)
    elif t is not None:
        out.append(path)


def paths(tree: Any) -> list[tuple]:
    """Each leaf's path of dict keys and sequence indices, in
    :func:`flatten`'s order."""
    out: list = []
    _walk_paths(tree, (), out)
    return out


def map_with_path(fn: Callable, tree: Any) -> Any:
    """``fn(path, leaf)`` over every leaf (``jax.tree_util.
    tree_map_with_path``), paths as :func:`paths` gives them."""
    leaves, spec = flatten(tree)
    return unflatten(spec, [fn(p, l) for p, l in zip(paths(tree), leaves)])
