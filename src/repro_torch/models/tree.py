"""Parameter, optimizer and cache trees: nested dicts, lists and tuples of
tensors (or numpy arrays), walked in the JAX package's pytree order.

Dict keys are visited sorted, lists and tuples in order, so a flattened
leaf list, a gradient norm summed over it and a checkpoint's keys
(`keystr`, e.g. ``['params']['groups'][0]['b0']['wq']``) line up leaf for
leaf with the reference's `jax.tree_util` walks.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(tree):
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def flatten_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(keystr, leaf)] in pytree order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, sub in kids:
        out.extend(flatten_with_path(sub, prefix + key))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree):
    """fn over the leaves of `tree`, keeping its dict, list and tuple
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def unflatten_like(like, new_leaves: list):
    """`like`'s structure with its leaves replaced, in pytree order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
