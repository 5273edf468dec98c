"""Trees of tensors walked as ``jax.tree`` walks them.

The train state, the optimizer state and a checkpoint are the reference's
pytrees: nested dicts and lists (or tuples) whose leaves are tensors.  JAX
flattens a dict in sorted key order and a list in index order, and that
order is part of the contract: ``clip_by_global_norm`` sums the leaves'
norms in it, and a checkpoint names each leaf by its path in it
(``params/user_w/0``).  Anything that is not a dict, list or tuple is a
leaf.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves", "leaves_upto", "leaves_with_paths", "path_key", "tree_map", "unflatten"]


def _children(node) -> list | None:
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves_with_paths(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` of every leaf, in JAX's order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += leaves_with_paths(v, prefix + (k,))
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def leaves_upto(tree: Any, like: Any) -> list:
    """``tree`` flattened up to ``like``'s structure: the subtree of ``tree``
    at each leaf of ``like``, in JAX's order."""
    kids = _children(like)
    if kids is None:
        return [tree]
    out = []
    for k, v in kids:
        out += leaves_upto(tree[k], v)
    return out


def path_key(path: tuple) -> str:
    """A leaf's name in a checkpoint: the reference's ``_flatten_with_paths``
    joins dict keys and list indices with ``/``."""
    return "/".join(str(p) for p in path)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree``; each of ``rest`` is flattened up
    to ``tree``'s structure, so a subtree of it arrives whole where
    ``tree`` has a leaf (as ``jax.tree.map`` does)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def unflatten(like: Any, new_leaves: list) -> Any:
    """``like``'s structure with ``new_leaves`` in JAX's leaf order."""
    it = iter(new_leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        built = {k: build(v) for k, v in kids}
        if isinstance(node, dict):
            return {k: built[k] for k in node}
        out = [built[i] for i in range(len(node))]
        return out if isinstance(node, list) else tuple(out)

    try:
        out = build(like)
    except StopIteration:
        raise ValueError("fewer leaves than the tree holds") from None
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
