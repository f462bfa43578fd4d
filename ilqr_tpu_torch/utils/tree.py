"""Nested containers of tensors, walked leaf by leaf.

The JAX package walks its pytrees with ``jax.tree``; the port's state is
plain Python containers of tensors: dicts, lists, tuples, NamedTuples and
dataclasses (``Scenario``, ``SolveStats``). Anything else is a leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied to the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure), in a container of the same
    structure."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, *(r[k] for r in rest))) for k, v in tree.items())
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree``, in ``tree_map``'s order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out
