"""Small utilities (reference: utils.py), and the walk over parameter
trees in the JAX package's flatten order."""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


def sample_n(lst: Sequence, n: int,
             rng: np.random.Generator | None = None) -> List:
    """Sample n items without replacement (reference: utils.py:23-27 —
    dead code there, kept for API completeness)."""
    rng = rng or np.random.default_rng()
    idx = rng.choice(len(lst), n, replace=False)
    return [lst[i] for i in idx]


def tree_leaves(tree) -> List:
    """The leaves of a nested dict/list tree in ``jax.tree_util`` flatten
    order: dict keys sorted, lists in order; ``None`` has no leaf, and
    anything else (a tensor, an array, a shape tuple) is one."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_fill(tree, leaves: Iterator):
    """``tree`` with each leaf replaced by the next of ``leaves``, taken in
    :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_fill(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_fill(v, leaves) for v in tree]
    return next(leaves)
