"""Nested-dict helpers: the port's stand-in for ``jax.tree``.

Params, gradients and optimizer moments are nested dicts of tensors.
Leaves are visited in sorted key-path order, the order ``jax.tree`` uses
for dicts, so anything drawn leaf by leaf (noise) has one fixed order.
"""
from __future__ import annotations


def leaf_paths(tree, prefix=()) -> list:
    """Key paths of every leaf, in sorted order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaf_paths(tree[k], prefix + (k,)))
        return out
    return [prefix]


def get_subtree(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def set_subtree(tree: dict, path: tuple, value):
    """Functionally set a nested dict entry, creating intermediate dicts."""
    if len(path) == 1:
        out = dict(tree)
        out[path[0]] = value
        return out
    out = dict(tree)
    out[path[0]] = set_subtree(tree.get(path[0], {}), path[1:], value)
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of same-shaped ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def from_paths(paths, values) -> dict:
    """Nested dict with ``values`` at ``paths``."""
    tree: dict = {}
    for p, v in zip(paths, values):
        tree = set_subtree(tree, p, v)
    return tree
