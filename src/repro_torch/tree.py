"""Minimal pytree helpers over nested dicts / lists / tuples of tensors.

The port keeps the JAX package's parameter structure — ``units`` is a list
of dicts of tensors and ``head`` a dict — so optimizer states, FedAvg and
the bridge can mirror it leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in a deterministic (insertion / index) order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves, rebuild) where ``rebuild(new_leaves)`` restores the
    structure with the given leaves in :func:`tree_leaves` order."""
    leaves = tree_leaves(tree)

    def rebuild(new_leaves):
        it = iter(new_leaves)
        return tree_map(lambda _: next(it), tree)

    return leaves, rebuild
