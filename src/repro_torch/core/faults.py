"""Fault plane of the single-RSU engine (twin of the host parts of
``repro.core.faults``).

Seeded failure processes of the paper's vehicular setting (§II-C):

- **mid-round dropout** (per vehicle): the vehicle performs only a prefix
  of its local steps and its update never reaches the merge; the RSU keeps
  the server-side steps it already took;
- **upload loss** (per vehicle): full local work, but the model upload is
  lost; compute and transmit are charged, the update is not merged;
- **deadline straggler** and **RSU outage**: scenario-engine concepts,
  validated here and refused by the single-RSU engine;
- ``coverage``: the deterministic in-range test (the legacy
  ``mobility_dropout``).

:func:`sample_faults_host` is the numpy draw the single-RSU engine uses,
bit-identical to the reference's.  The traced sampler and its helpers
(``drop_steps``, ``ensure_rsu_up``, ``rescue_mask``) serve the fused and
scenario engines and are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# separates the fault stream from the batch-index and fading streams
FAULT_SALT = 0xFA17


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded failure processes; all defaults means no faults."""

    dropout_rate: float = 0.0        # P[vehicle drops mid-round]
    upload_loss_rate: float = 0.0    # P[client update lost after local work]
    straggler_factor: float = 0.0    # >0: deadline = factor * residence_s
    rsu_outage_rate: float = 0.0     # P[RSU misses the round entirely]
    staleness_discount: float = 0.5  # weight multiplier for banked updates
    coverage: bool = False           # in-range test (FederationSim)
    seed: int = 0

    def __post_init__(self):
        for name in ("dropout_rate", "upload_loss_rate", "rsu_outage_rate"):
            v = getattr(self, name)
            if not 0.0 <= float(v) < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v!r}")
        if not 0.0 <= float(self.staleness_discount) <= 1.0:
            raise ValueError(
                f"staleness_discount must be in [0, 1], got "
                f"{self.staleness_discount!r}")
        if float(self.straggler_factor) < 0.0:
            raise ValueError(
                f"straggler_factor must be >= 0, got "
                f"{self.straggler_factor!r}")

    @property
    def stochastic(self) -> bool:
        """Any sampled failure process active."""
        return (float(self.dropout_rate) > 0.0
                or float(self.upload_loss_rate) > 0.0
                or float(self.straggler_factor) > 0.0
                or float(self.rsu_outage_rate) > 0.0)

    @property
    def enabled(self) -> bool:
        return self.stochastic or self.coverage


def sample_faults_host(cfg: FaultConfig, rnd: int, n_vehicles: int):
    """One round of failures: (drop bool (n,), drop_frac float (n,) in
    [0, 1), lost bool (n,)), from a numpy generator seeded by the fault
    seed and the round."""
    rng = np.random.default_rng((cfg.seed ^ FAULT_SALT) * 1_000_003 + rnd)
    drop = rng.random(n_vehicles) < cfg.dropout_rate
    drop_frac = rng.random(n_vehicles)
    lost = rng.random(n_vehicles) < cfg.upload_loss_rate
    return drop, drop_frac, lost
