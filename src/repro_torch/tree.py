"""Nested dicts, lists and tuples of tensors (the port's pytrees)."""

from __future__ import annotations


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, in ``map_tree``'s order."""
    out = []
    map_tree(out.append, tree)
    return out


def map_tree_with_keys(fn, tree, keys: tuple[str, ...] = ()):
    """``map_tree`` whose ``fn(keys, leaf)`` also gets the leaf's path: each
    dict key, and each list or tuple index, as a string."""
    if isinstance(tree, dict):
        return {k: map_tree_with_keys(fn, v, keys + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree_with_keys(fn, v, keys + (str(i),))
                          for i, v in enumerate(tree))
    return fn(keys, tree)
