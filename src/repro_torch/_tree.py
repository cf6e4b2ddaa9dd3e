"""Parameter and state trees: leaves in ``jax.tree.flatten`` order.

The port keeps the JAX package's trees as nested dicts of tensors, and a
train state as a dataclass.  ``jax.tree.flatten`` visits a dict's keys in
sorted order, a registered dataclass's fields in declaration order, lists
and tuples in order, and finds no leaf in ``None``; :func:`leaves` and
:func:`rebuild` do the same, so that optimizer states line up leaf by leaf
and the two packages' checkpoints hold their arrays in one order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, List


def _is_dataclass(x: Any) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    if _is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in leaves(getattr(tree, f.name))]
    return [tree]


def rebuild(tree: Any, new_leaves: Iterable[Any]) -> Any:
    """``tree`` with its leaves, in :func:`leaves` order, replaced."""
    it = iter(new_leaves)

    def go(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: go(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        if _is_dataclass(node):
            return dataclasses.replace(node, **{
                f.name: go(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        return next(it)

    return go(tree)


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)
