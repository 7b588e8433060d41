"""Model aggregation (twin of the parts of ``repro.core.aggregation`` the
ported rounds use): the |D_n|-weighted sum of paper Eq. 1 over a list of
replica trees or over a stacked leading replica axis, FedAvg over that axis
(paper Eq. 1/2, the FL round's merge), its survivor-weighted and
staleness-discounted forms (the fault and streaming planes), and the
sample-weighted edge->cloud merge of the multi-RSU hierarchy over the
stacked edge models.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


def weighted_sum(trees: Sequence[Any], weights: Sequence[float]) -> Any:
    """sum_i w_i * tree_i, leaf-wise in float32 (the FedAvg numerator).
    A zero weight excludes a replica."""
    if len(trees) != len(weights) or not trees:
        raise ValueError(f"{len(trees)} trees vs {len(weights)} weights")

    def f(*leaves):
        acc = None
        for w, a in zip(weights, leaves):
            term = a.to(torch.float32) * float(w)   # w rounds to float32
            acc = term if acc is None else acc + term
        return acc

    return tree_map(f, trees[0], *trees[1:])


def stacked_weighted_sum(stacked_tree: Any, weights) -> Any:
    """The FedAvg numerator over a stacked leading replica axis: every leaf
    carries the replicas on axis 0 and is reduced with float32 weights in
    one tensordot.  A zero weight excludes a replica."""
    w = torch.as_tensor(np.asarray(weights, np.float32),
                        device=tree_leaves(stacked_tree)[0].device)
    return tree_map(lambda a: torch.tensordot(w, a.to(torch.float32),
                                              dims=([0], [0])),
                    stacked_tree)


def stacked_fedavg(stacked_tree: Any, weights) -> Any:
    """Weighted mean over the stacked leading axis: the float32 numerator
    over the float32 sum of the weights (which need not be normalised)."""
    w = np.asarray(weights, np.float32)
    den = float(np.sum(w, dtype=np.float32))
    num = stacked_weighted_sum(stacked_tree, w)
    return tree_map(lambda n, ref: (n / den).to(ref.dtype), num,
                    stacked_tree)


def survivor_weighted_sum(stacked_tree: Any, weights, survivors) -> Any:
    """The partial-aggregation numerator: a failed replica's weight is
    zeroed by the bool ``survivors`` mask before the same tensordot as
    :func:`stacked_weighted_sum`, so it folds in as an exact +0."""
    w = (np.asarray(weights, np.float32)
         * np.asarray(survivors, bool).astype(np.float32))
    return stacked_weighted_sum(stacked_tree, w)


def _renormalised(stacked_tree: Any, w: np.ndarray, fallback: Any) -> Any:
    total = np.float32(np.sum(w, dtype=np.float32))
    if not total > 0.0:
        return fallback
    # a where, not max(total, 1): surviving weight in (0, 1) (fractional
    # weights under staleness discounts) must still renormalise exactly
    num = stacked_weighted_sum(stacked_tree, w)
    return tree_map(lambda n, fb: (n / float(total)).to(fb.dtype), num,
                    fallback)


def survivor_fedavg(stacked_tree: Any, weights, survivors,
                    fallback: Any) -> Any:
    """Survivor-weighted FedAvg: the weighted mean over the surviving
    replicas, renormalised over them; ``fallback`` (the pre-round model)
    when none survives."""
    w = (np.asarray(weights, np.float32)
         * np.asarray(survivors, bool).astype(np.float32))
    return _renormalised(stacked_tree, w, fallback)


def discounted_survivor_fedavg(stacked_tree: Any, weights, survivors,
                               discounts, fallback: Any) -> Any:
    """Staleness-weighted survivor FedAvg: each replica's weight is also
    scaled by its discount (the staleness kernel of its buffered age).
    With every discount exactly 1.0 this is :func:`survivor_fedavg` bit
    for bit (``w * 1.0 == w``)."""
    w = (np.asarray(weights, np.float32)
         * np.asarray(survivors, bool).astype(np.float32)
         * np.asarray(discounts, np.float32))
    return _renormalised(stacked_tree, w, fallback)


def stacked_cloud_merge(edge_stack: Any, weights: Sequence[float],
                        fallback: Any) -> Any:
    """Cloud tier over the RSUs' edge models stacked on a leading axis (the
    engine's (R, P) planes, or any tree of such leaves; twin of the
    reference's ``stacked_cloud_merge``): ``sum_r w_r edge_r / max(sum_r
    w_r, 1)`` in one tensordot per leaf with float32 weights (the samples
    each edge absorbed since the last merge).  Zero-weight RSUs fold in as
    +0; with every weight zero the ``fallback`` (the previous global
    model) is returned unchanged."""
    w = np.asarray(weights, dtype=np.float32)
    total = np.float32(w.sum(dtype=np.float32))
    if not total > 0.0:
        return fallback
    num = stacked_weighted_sum(edge_stack, w)
    den = float(max(total, np.float32(1.0)))
    return tree_map(lambda nm, ref: (nm / den).to(ref.dtype), num, fallback)
