"""Streaming plane (twin of ``repro.core.streaming``): who is present each
round, and how a buffered update is discounted by its age.

The paper's future-directions case: vehicles arrive, train and vanish
continuously, so a server that waits for the slowest survivor wastes what
everyone else already finished.  Two pieces live here; their consequences
(the presence gate before cut selection, the per-RSU StreamBuffer of the
``streaming`` server schedule) live in :mod:`repro_torch.core.fedsim` and
:mod:`repro_torch.core.superstep`.

- **Presence**: a per-vehicle Markov toggle chain.  Each round every
  vehicle flips its presence bit with probability ``churn_rate``
  (``churn_source="markov"``), or presence follows coverage
  (``"mobility"``: a vehicle with ``serving_rsu == -1`` has left the
  stream).  The reference draws the toggles with threefry inside its
  program; :func:`sample_toggles_host` is its numpy twin, bit-identical to
  the reference's own host twin.  A vehicle not admitted this round looks
  like one outside coverage (:func:`gate_presence`).
- **Staleness kernel**: the discount of a pending delta of age ``s``
  rounds: ``constant`` (exactly 1.0) or ``poly`` (``1/(1+s)**alpha``,
  float32).

With ``churn_rate`` 0 and the ``markov`` source (``churning`` False) and a
schedule other than ``streaming``, the engine runs none of this.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# separates the streaming stream from the batch-index, fading and fault
# streams
STREAM_SALT = 0xB0FF

STALENESS_KERNELS = ("constant", "poly")

# where departures come from: the seeded toggle chain, or the scenario's
# coverage (serving_rsu == -1)
CHURN_SOURCES = ("markov", "mobility")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Seeded streaming processes; all defaults means no streaming."""

    buffer_size: int = 4       # B: buffered deltas per RSU before a merge
    churn_rate: float = 0.0    # P[vehicle toggles presence each round]
    kernel: str = "constant"   # staleness discount: constant | poly
    alpha: float = 0.5         # poly kernel exponent: 1/(1+s)**alpha
    seed: int = 0
    churn_source: str = "markov"  # markov (toggle chain) | mobility

    def __post_init__(self):
        if self.kernel not in STALENESS_KERNELS:
            raise ValueError(
                f"kernel must be one of {STALENESS_KERNELS}, got "
                f"{self.kernel!r}")
        if self.churn_source not in CHURN_SOURCES:
            raise ValueError(
                f"churn_source must be one of {CHURN_SOURCES}, "
                f"got {self.churn_source!r}")
        if not 0.0 <= float(self.churn_rate) < 1.0:
            raise ValueError(
                f"churn_rate must be in [0, 1), got {self.churn_rate!r}")
        if self.churn_source == "mobility" and float(self.churn_rate) > 0.0:
            raise ValueError(
                "churn_source='mobility' derives departures from coverage; "
                "churn_rate must stay 0 (the Markov chain is the 'markov' "
                "source)")
        if int(self.buffer_size) < 1:
            raise ValueError(
                f"buffer_size must be >= 1, got {self.buffer_size!r}")
        if float(self.alpha) < 0.0:
            raise ValueError(f"alpha must be >= 0, got {self.alpha!r}")

    @property
    def churning(self) -> bool:
        """Any presence process active (a toggle chain or coverage)."""
        return float(self.churn_rate) > 0.0 or self.churn_source == "mobility"


def sample_toggles_host(cfg: StreamConfig, rnd: int, n_vehicles: int):
    """One round of presence toggles, bool (n,): True where the vehicle
    flips between present and departed, from a numpy generator seeded by
    the stream seed and the round."""
    rng = np.random.default_rng((cfg.seed ^ STREAM_SALT) * 1_000_003 + rnd)
    return rng.random(n_vehicles) < cfg.churn_rate


def gate_presence(serving, rates, residence, admit):
    """A vehicle not admitted this round looks like one outside coverage:
    ``serving = -1``, rate 0, residence 0 (int32 / float32 / float32, as
    the reference's)."""
    admit = np.asarray(admit, bool)
    return (np.where(admit, serving, -1).astype(np.int32),
            np.where(admit, rates, 0.0).astype(np.float32),
            np.where(admit, residence, 0.0).astype(np.float32))


def staleness_kernel(kind: str, alpha: float, staleness) -> np.ndarray:
    """float32 discount of a buffered delta of age ``staleness`` rounds:
    ``constant`` is exactly 1.0 (a weight times it is unchanged),
    ``poly`` ``(1 + s) ** -alpha``."""
    s = np.asarray(staleness, np.float32)
    if kind == "constant":
        return np.ones_like(s)
    if kind == "poly":
        return ((np.float32(1.0) + s)
                ** np.float32(-float(alpha))).astype(np.float32)
    raise ValueError(f"unknown staleness kernel {kind!r}")
