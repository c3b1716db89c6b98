"""Parameter trees: the dicts and lists of tensors that hold a model's
parameters, its gradients and its optimizer state.

The port's counterpart of ``jax.tree_util`` for the walks that the optimizer
and the train step make. Dicts and lists are the nodes (the parameter tree
has no other); anything else, a tuple too, is a leaf. The checkpoint's
path-keyed flattening (``checkpoint.manager._flatten``) keeps its own walk:
it orders dict keys as ``jax.tree_util`` does, which these walks need not.
"""

from __future__ import annotations

__all__ = ["tree_leaves", "tree_map"]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out
