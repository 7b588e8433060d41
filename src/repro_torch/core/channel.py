"""Wireless channel model (twin of ``repro.core.channel``, host numpy paths).

Shannon-capacity rates with log-distance path loss supply the per-vehicle,
per-round rates that drive the paper's cut rule (Eq. 3) and the latency /
energy accounting.  numpy throughout, so it replays the reference exactly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class VehicleProfile:
    """Static per-vehicle characteristics."""
    compute_flops: float = 20e9
    tx_power_w: float = 0.5
    compute_power_w: float = 15.0
    x0_m: float = -200.0
    speed_mps: float = 15.0
    memory_budget_bytes: float = float("inf")


@dataclasses.dataclass
class ChannelConfig:
    bandwidth_hz: float = 10e6
    noise_dbm_hz: float = -174.0
    path_loss_exp: float = 3.0
    ref_gain_db: float = -30.0
    rsu_range_m: float = 400.0
    fading_std_db: float = 4.0


RSU_HEIGHT_M = 10.0


def _shannon_rate(cfg: ChannelConfig, d, tx_power_w, fading_db):
    """B log2(1 + SNR) with log-distance path loss."""
    pl_db = (-cfg.ref_gain_db
             + 10 * cfg.path_loss_exp * np.log10(np.maximum(d, 1.0))
             + fading_db)
    p_rx_dbm = 10 * np.log10(np.asarray(tx_power_w) * 1e3) - pl_db
    noise_dbm = cfg.noise_dbm_hz + 10 * np.log10(cfg.bandwidth_hz)
    snr = 10 ** ((p_rx_dbm - noise_dbm) / 10)
    return cfg.bandwidth_hz * np.log2(1.0 + snr)


def rates_from_distance(cfg: ChannelConfig, d_m, tx_power_w,
                        seed: int | None = None) -> np.ndarray:
    """Vectorized Shannon rates; ``seed`` draws one shadow-fading sample per
    vehicle."""
    d = np.asarray(d_m, dtype=np.float64)
    if seed is not None and cfg.fading_std_db > 0:
        fading = np.random.default_rng(seed).normal(0.0, cfg.fading_std_db,
                                                    size=d.shape)
    else:
        fading = 0.0
    return _shannon_rate(cfg, d, tx_power_w, fading)


def make_fleet(n: int, seed: int = 0,
               memory_budget_bytes: float | Tuple[float, float] | None = None
               ) -> List[VehicleProfile]:
    """Heterogeneous fleet: compute speeds and mobility vary per vehicle."""
    rng = np.random.default_rng(seed)
    fleet = []
    for _ in range(n):
        fleet.append(VehicleProfile(
            compute_flops=float(rng.uniform(5e9, 50e9)),
            tx_power_w=float(rng.uniform(0.2, 1.0)),
            compute_power_w=float(rng.uniform(8.0, 25.0)),
            x0_m=float(rng.uniform(-350.0, -50.0)),
            speed_mps=float(rng.uniform(8.0, 30.0)),
        ))
    if memory_budget_bytes is not None:
        if isinstance(memory_budget_bytes, tuple):
            lo, hi = memory_budget_bytes
            budgets = rng.uniform(lo, hi, size=n)
        else:
            budgets = np.full(n, float(memory_budget_bytes))
        for v, b in zip(fleet, budgets):
            v.memory_budget_bytes = float(b)
    return fleet


def fleet_arrays(fleet: Sequence[VehicleProfile]) -> dict:
    """Column-major view of a fleet: one np array per attribute."""
    return {
        "compute_flops": np.array([v.compute_flops for v in fleet]),
        "tx_power_w": np.array([v.tx_power_w for v in fleet]),
        "compute_power_w": np.array([v.compute_power_w for v in fleet]),
        "x0_m": np.array([v.x0_m for v in fleet]),
        "speed_mps": np.array([v.speed_mps for v in fleet]),
        "memory_budget_bytes": np.array([v.memory_budget_bytes
                                         for v in fleet]),
    }


def sample_round_rates(cfg: ChannelConfig, fleet, t: float, seed: int
                       ) -> np.ndarray:
    """Per-vehicle Shannon rates at time t, vectorized over the fleet."""
    fa = fleet if isinstance(fleet, dict) else fleet_arrays(fleet)
    x = fa["x0_m"] + fa["speed_mps"] * t
    d = np.sqrt(x * x + RSU_HEIGHT_M ** 2)
    return rates_from_distance(cfg, d, fa["tx_power_w"], seed)


def in_range_mask(cfg: ChannelConfig, fleet, t: float) -> np.ndarray:
    """Vehicles inside RSU coverage at time t -> bool (n,)."""
    fa = fleet if isinstance(fleet, dict) else fleet_arrays(fleet)
    return np.abs(fa["x0_m"] + fa["speed_mps"] * t) <= cfg.rsu_range_m
