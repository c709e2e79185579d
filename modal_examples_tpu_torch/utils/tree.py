"""Nested containers of tensors (the JAX package's pytrees): dicts, lists,
tuples and dataclass instances, with every other value a leaf.

``leaves`` and ``map`` walk them in one fixed order (dict insertion order,
dataclass field order), so a flat list of leaves and a structure rebuild
each other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


def _children(node) -> list | None:
    if isinstance(node, dict):
        return list(node.values())
    if isinstance(node, (list, tuple)):
        return list(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [getattr(node, f.name) for f in dataclasses.fields(node)]
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(node.keys(), children))
    if isinstance(node, (list, tuple)):
        return type(node)(children)
    return dataclasses.replace(node, **{f.name: c for f, c in zip(dataclasses.fields(node), children)})


def leaves(tree) -> list:
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in leaves(kid)]


def map(fn: Callable, tree, *rest) -> Any:  # noqa: A001 - the pytree name
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (same
    structure), rebuilt in ``tree``'s structure."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    for o in others:
        if o is None or len(o) != len(kids):
            raise ValueError("trees differ in structure")
    return _rebuild(tree, [map(fn, k, *(o[i] for o in others)) for i, k in enumerate(kids)])


def unflatten(tree, flat: list) -> Any:
    """``flat`` (as :func:`leaves` of a tree of this structure) in ``tree``'s
    structure."""
    n = len(leaves(tree))
    if len(flat) != n:
        raise ValueError(f"{len(flat)} leaves for a structure of {n}")
    it = iter(flat)
    return map(lambda _: next(it), tree)
