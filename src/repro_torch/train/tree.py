"""Nested dicts, lists and tuples of tensors: the port's parameter and
training-state trees."""
from __future__ import annotations

from typing import Any, Callable, Dict, List


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *others)`` over the leaves of ``tree``, rebuilt in its
    structure. Each tree of ``rest`` is read alongside up to ``tree``'s
    leaves, so its subtree there (a leaf, or a dict such as Adafactor's
    {"r", "c"}) is what ``fn`` gets."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves in ``tree_map``'s order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/0/c": leaf}: each leaf under its path of dict keys and list
    indices joined by "/", the reference checkpoint's key format."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out
