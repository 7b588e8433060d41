"""Cut-layer selection strategies (twin of ``repro.core.adaptive``, the host
numpy strategies ``FederationSim`` accepts).

``paper_threshold`` is the paper's Eq. 3 (rate bands -> cut in {2,4,6,8}),
text-consistent by default (high rate -> early cut) and as printed behind
``literal_eq3=True``.  ``latency_optimal``, ``energy_aware`` and
``memory_constrained`` are the reference's beyond-paper strategies.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.cost import SplitProfile, sfl_round_cost_arrays

DEFAULT_CUTS = (2, 4, 6, 8)
DEFAULT_THRESHOLDS = (60e6, 110e6, 160e6, 260e6)


def paper_threshold(rates_bps: Sequence[float],
                    thresholds: Sequence[float] = DEFAULT_THRESHOLDS,
                    cuts: Sequence[int] = DEFAULT_CUTS,
                    literal_eq3: bool = False) -> List[int]:
    """Eq. 3: banded rate -> cut layer, per vehicle."""
    rates = np.asarray(rates_bps, dtype=np.float64)
    band = np.digitize(rates, np.asarray(thresholds[:3]), right=True)
    cuts_arr = np.asarray(cuts)
    if literal_eq3:
        out = cuts_arr[band]
    else:
        out = cuts_arr[len(cuts) - 1 - band]
    return [int(c) for c in out]


def _cost_matrix(profile: SplitProfile, rates_bps, client_flops,
                 server_flops: float, n_batches: int, batch: int,
                 local_epochs: int, candidate_cuts):
    """(n_vehicles, n_cuts) RoundCostArrays via one broadcast evaluation."""
    cuts = np.asarray(list(candidate_cuts), dtype=np.int64)
    rates = np.atleast_1d(np.asarray(rates_bps, dtype=np.float64))[:, None]
    flops = np.atleast_1d(np.asarray(client_flops,
                                     dtype=np.float64))[:, None]
    return cuts, sfl_round_cost_arrays(profile, cuts[None, :], n_batches,
                                       batch, rates, flops, server_flops,
                                       local_epochs)


def latency_optimal(profile: SplitProfile, rates_bps, client_flops,
                    server_flops: float, n_batches: int, batch: int,
                    local_epochs: int = 1,
                    candidate_cuts: Optional[Sequence[int]] = None
                    ) -> List[int]:
    cuts, costs = _cost_matrix(profile, rates_bps, client_flops, server_flops,
                               n_batches, batch, local_epochs,
                               candidate_cuts or range(1, profile.n_units))
    return [int(c) for c in cuts[np.argmin(costs.latency, axis=1)]]


def energy_aware(profile: SplitProfile, rates_bps, client_flops,
                 server_flops: float, n_batches: int, batch: int,
                 local_epochs: int = 1, latency_weight: float = 0.5,
                 candidate_cuts: Optional[Sequence[int]] = None
                 ) -> List[int]:
    cuts, costs = _cost_matrix(profile, rates_bps, client_flops, server_flops,
                               n_batches, batch, local_epochs,
                               candidate_cuts or range(1, profile.n_units))
    lat, en = costs.latency, costs.energy_j
    score = (latency_weight * lat / lat.max(axis=1, keepdims=True)
             + (1 - latency_weight) * en / en.max(axis=1, keepdims=True))
    return [int(c) for c in cuts[np.argmin(score, axis=1)]]


def max_cut_for_budget(profile: SplitProfile,
                       budget_bytes: Union[float, Sequence[float]]
                       ) -> np.ndarray:
    """Largest cut whose vehicle-side params fit each budget (>= 1)."""
    cum = np.cumsum(np.asarray(profile.unit_param_bytes, dtype=np.float64))
    budgets = np.atleast_1d(np.asarray(budget_bytes, dtype=np.float64))
    return np.maximum(np.searchsorted(cum, budgets, side="right"), 1)


def memory_constrained(profile: SplitProfile,
                       budget_bytes: Union[float, Sequence[float]],
                       inner: Callable[..., List[int]], *args,
                       **kwargs) -> List[int]:
    """Clamp any strategy's cuts so the vehicle-side model fits the budget."""
    cuts = np.asarray(inner(*args, **kwargs))
    return [int(c) for c in np.minimum(cuts,
                                       max_cut_for_budget(profile,
                                                          budget_bytes))]
