"""Nested dicts as trees (the port's stand-in for ``jax.tree``): parameters,
BN state, solver history and ParamSpecs are dicts of dicts whose leaves are
tensors, arrays or tuples."""

from __future__ import annotations


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts with the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]
