"""Fault plane of the single-RSU engine (twin of the host parts of
``repro.core.faults``).

Seeded failure processes of the paper's vehicular setting (§II-C):

- **mid-round dropout** (per vehicle): the vehicle performs only a prefix
  of its local steps and its update never reaches the merge; the RSU keeps
  the server-side steps it already took;
- **upload loss** (per vehicle): full local work, but the model upload is
  lost; compute and transmit are charged, the update is not merged;
- **deadline straggler** (per vehicle, scenario engine only): the
  analytic round latency at the chosen cut exceeds ``straggler_factor x
  residence``; the update lands in a staleness bank and merges next round
  at ``staleness_discount``;
- **RSU outage** (per RSU, scenario engine only): the whole cohort sits the
  round out;
- ``coverage``: the deterministic in-range test (the legacy
  ``mobility_dropout``, single-RSU engine only).

:func:`sample_faults_host` is the numpy draw the single-RSU engine uses,
bit-identical to the reference's.  :func:`sample_scenario_faults_host` is
the scenario engine's draw of one round: the reference draws it with
threefry inside its program, the port with numpy on the host, from an
independent stream with the same distributions (the reference's own
convention for its host twins).  :func:`drop_steps`,
:func:`ensure_rsu_up` and :func:`rescue_mask` turn a draw into the round's
plan, as numpy functions: the port plans each window on the host.
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


def sample_scenario_faults_host(cfg: FaultConfig, rnd: int, n_vehicles: int,
                                n_rsus: int):
    """One scenario round of failures: ``(drop, drop_frac, lost,
    rsu_down)``, bool (n,), float32 (n,) in [0, 1), bool (n,), bool (R,),
    with the distributions of the reference's traced sampler.  The first
    three come from the generator of :func:`sample_faults_host`, the RSU
    outages after them."""
    rng = np.random.default_rng((cfg.seed ^ FAULT_SALT) * 1_000_003 + rnd)
    drop = rng.random(n_vehicles) < cfg.dropout_rate
    drop_frac = rng.random(n_vehicles).astype(np.float32)
    lost = rng.random(n_vehicles) < cfg.upload_loss_rate
    rsu_down = rng.random(n_rsus) < cfg.rsu_outage_rate
    return drop, drop_frac, lost, rsu_down


def drop_steps(drop, drop_frac, steps: int) -> np.ndarray:
    """Per-vehicle performed local steps: ``floor(frac * steps)`` in
    float32 when dropped (possibly 0), the full ``steps`` otherwise.  int32
    (n,)."""
    frac = np.asarray(drop_frac, np.float32)
    partial = np.floor(frac * np.float32(steps)).astype(np.int32)
    return np.where(np.asarray(drop, bool), partial,
                    np.int32(steps)).astype(np.int32)


def ensure_rsu_up(rsu_down) -> np.ndarray:
    """Never let an outage take the whole network down: if every RSU drew
    an outage this round, RSU 0 is kept up."""
    down = np.asarray(rsu_down, bool)
    keep = down.all() & (np.arange(down.shape[0]) == 0)
    return down & ~keep


def rescue_mask(sched, failed) -> np.ndarray:
    """At-least-one-participant guarantee: a bool (n,) mask selecting the
    first scheduled vehicle iff the failures would wipe every scheduled
    vehicle (the engine clears that vehicle's failure bits); all False
    when any survivor exists or nothing is scheduled."""
    sched = np.asarray(sched, bool)
    surv = sched & ~np.asarray(failed, bool)
    none_left = sched.any() & ~surv.any()
    first = int(np.argmax(sched))
    return none_left & sched & (np.arange(sched.shape[0]) == first)
