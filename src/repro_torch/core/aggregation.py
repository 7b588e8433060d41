"""Model aggregation (twin of the part of ``repro.core.aggregation`` the
single-RSU split round uses): the |D_n|-weighted sum of paper Eq. 1 over a
list of replica trees.
"""
from __future__ import annotations

from typing import Any, Sequence

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
