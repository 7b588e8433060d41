"""Cut-layer selection strategies (twin of ``repro.core.adaptive``, the host
numpy strategies ``FederationSim`` and ``ScenarioEngine`` accept).

``paper_threshold`` is the paper's Eq. 3 (rate bands -> cut in {2,4,6,8}),
text-consistent by default (high rate -> early cut) and as printed behind
``literal_eq3=True``.  ``latency_optimal``, ``energy_aware`` and
``memory_constrained`` are the reference's beyond-paper strategies;
``residence_aware`` is the scenario engine's deadline rule (paper §II-C).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.cost import (BWD_FWD_RATIO, SplitProfile,
                                   sfl_round_cost_arrays)

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


def latency_matrix(profile: SplitProfile, rates_bps, client_flops,
                   server_flops: float, n_batches: int, batch: int,
                   local_epochs: int, candidate_cuts) -> np.ndarray:
    """(n, k) float32 analytic round latency per candidate cut: the
    reference's traced twin (``latency_matrix_traced``) in float32 numpy,
    operation for operation, so that a deadline test on it flips exactly
    where the reference's does."""
    cuts = np.asarray(list(candidate_cuts), dtype=np.int64)
    fwd_cum = np.concatenate([[0.0], np.cumsum(profile.unit_fwd_flops)])
    bytes_cum = np.concatenate([[0.0], np.cumsum(profile.unit_param_bytes)])
    smashed = np.asarray(profile.smashed_bytes_per_sample)[cuts - 1] * batch
    steps = n_batches * local_epochs
    updown = 2.0 * (steps * smashed + bytes_cum[cuts])          # (k,) f64
    c_fwd = fwd_cum[cuts] * batch
    s_fwd = (fwd_cum[-1] - fwd_cum[cuts] + profile.head_flops) * batch
    rates = np.asarray(rates_bps, np.float32)[:, None]
    flops = np.asarray(client_flops, np.float32)[:, None]
    scale = np.float32(steps * (1 + BWD_FWD_RATIO))
    t_client = (scale * np.asarray(c_fwd, np.float32)[None, :]) / flops
    t_server = scale * np.asarray(s_fwd / server_flops, np.float32)[None, :]
    t_comm = np.asarray(updown, np.float32)[None, :] \
        / np.maximum(rates / np.float32(8.0), np.float32(1e-9))
    return (t_client + t_server) + t_comm


SKIP = 0  # sentinel cut: the vehicle sits this round out


def residence_aware(profile: SplitProfile, rates_bps: Sequence[float],
                    client_flops: Sequence[float], server_flops: float,
                    n_batches: int, batch: int, local_epochs: int,
                    residence_s: Sequence[float],
                    candidate_cuts: Optional[Sequence[int]] = None
                    ) -> List[int]:
    """Deadline-aware selection: among candidate cuts (ascending), the
    smallest cut -- the most work pushed to the RSU -- whose analytic round
    latency fits the vehicle's remaining residence time; :data:`SKIP` when
    none fits (the vehicle would leave coverage mid-round)."""
    cand = sorted(candidate_cuts or range(1, profile.n_units))
    cuts, costs = _cost_matrix(profile, rates_bps, client_flops, server_flops,
                               n_batches, batch, local_epochs, cand)
    res = np.asarray(residence_s, dtype=np.float64)[:, None]
    feasible = costs.latency <= res
    first = np.argmax(feasible, axis=1)          # smallest feasible cut
    out = np.where(feasible.any(axis=1), cuts[first], SKIP)
    return [int(c) for c in out]


def strategy_max_cut(strategy: str, n_units: int,
                     candidate_cuts: Optional[Sequence[int]] = None) -> int:
    """Upper bound on the cut a scenario strategy can emit: ``paper`` /
    ``paper-literal`` pick from :data:`DEFAULT_CUTS` (clipped to U-1),
    ``residence`` searches ``candidate_cuts`` (default ``1..U-1``).  The
    reference sizes its super-step replica planes with it; the port's
    per-replica loop keeps exactly the units before each cut."""
    top = max(n_units - 1, 1)
    if strategy in ("paper", "paper-literal"):
        return min(max(DEFAULT_CUTS), top)
    cand = sorted(candidate_cuts or range(1, n_units))
    return min(max(cand), top) if cand else top


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
