"""Model aggregation (twin of the parts of ``repro.core.aggregation`` the
split rounds use): the |D_n|-weighted sum of paper Eq. 1 over a list of
replica trees, and the sample-weighted edge->cloud merge of the multi-RSU
hierarchy.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.tree import tree_map


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


def cloud_merge(edge_trees: Sequence[Any], weights: Sequence[float],
                fallback: Any) -> Any:
    """Cloud tier over the RSUs' edge models (twin of
    ``stacked_cloud_merge``): ``sum_r w_r edge_r / max(sum_r w_r, 1)`` with
    float32 weights (the samples each edge absorbed since the last merge).
    Zero-weight RSUs are excluded; with every weight zero the ``fallback``
    tree (the previous global model) is returned unchanged."""
    w = np.asarray(weights, dtype=np.float32)
    total = np.float32(w.sum(dtype=np.float32))
    if not total > 0.0:
        return fallback
    served = np.nonzero(w > 0.0)[0]
    num = weighted_sum([edge_trees[r] for r in served], w[served])
    den = float(max(total, np.float32(1.0)))
    return tree_map(lambda nm, ref: (nm / den).to(ref.dtype), num, fallback)
