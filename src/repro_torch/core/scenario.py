"""Multi-RSU mobility scenarios: per-round fleet state (twin of the host
numpy paths of ``repro.core.scenario``).

A scenario holds a static RSU deployment and answers
``fleet_state(t, seed)`` -- positions, velocities, serving RSU (``-1`` =
outside every cell), uplink Shannon rates to the serving RSU and the time
left inside its cell -- as numpy vectors over the fleet.  It is a pure
function of ``(t, seed)``, so rounds replay exactly, and the arithmetic is
the reference's, so the states are equal bit for bit
(``tests/test_torch_scenario.py``).  ``ScenarioEngine`` reads it on the
host every round.

Scenarios: ``highway_corridor`` (RSUs along a multi-lane road, vehicles
wrapping around it), ``highway_zipf`` (the same with a Zipf-skewed initial
cell load), ``urban_grid`` (Manhattan blocks with pseudo-random turns and
intersection dwell), ``trace_replay`` (deterministic array-driven
trajectories; :func:`crossing_trace` is the handover fixture) and
``city`` (:class:`CityGrid`, a lattice of hundreds of RSU cells with
Zipf cell popularity and orbit mobility: the scale-out / paging fixture).

Handover moves a vehicle's RSU association only: its data shard and its
wire error-feedback residual are keyed by vehicle and travel with it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core import channel

RSU_HEIGHT_M = channel.RSU_HEIGHT_M

# residence cap: a vehicle dwelling (v=0) inside coverage would otherwise
# report an infinite deadline; every consumer treats >= this as no deadline
RESIDENCE_CAP_S = 1e6


@dataclasses.dataclass
class FleetState:
    """Per-round fleet snapshot: (n,) or (n, 2) arrays over the fleet;
    ``serving_rsu == -1`` marks a vehicle outside every RSU's coverage."""
    t: float
    positions: np.ndarray      # (n, 2) planar position, metres
    velocities: np.ndarray     # (n, 2) metres/second
    serving_rsu: np.ndarray    # (n,) int32 cell index, -1 = uncovered
    rates_bps: np.ndarray      # (n,) uplink Shannon rate to the serving RSU
    residence_s: np.ndarray    # (n,) remaining time inside the serving cell

    @property
    def active(self) -> np.ndarray:
        return self.serving_rsu >= 0

    @property
    def n_vehicles(self) -> int:
        return self.positions.shape[0]


def apply_presence(state: FleetState, present) -> FleetState:
    """Arrivals and departures over any scenario: a departed vehicle looks
    like one outside coverage (``serving_rsu = -1``, rate 0, residence 0;
    int32 / float32 / float32, as the reference's)."""
    present = np.asarray(present, bool)
    return FleetState(
        t=state.t, positions=state.positions, velocities=state.velocities,
        serving_rsu=np.where(present, state.serving_rsu, -1).astype(np.int32),
        rates_bps=np.where(present, state.rates_bps, 0.0).astype(np.float32),
        residence_s=np.where(present, state.residence_s,
                             0.0).astype(np.float32))


# --------------------------------------------------------------------------
# shared vectorized geometry
# --------------------------------------------------------------------------

def nearest_rsu(positions: np.ndarray, rsu_positions: np.ndarray,
                range_m: float):
    """Nearest RSU within coverage: (serving (n,) int32 with -1 =
    uncovered, planar distance to the nearest RSU (n,))."""
    diff = positions[:, None, :] - rsu_positions[None, :, :]
    d2 = np.einsum("nmd,nmd->nm", diff, diff)
    serving = np.argmin(d2, axis=1)
    dmin = np.sqrt(d2[np.arange(len(positions)), serving])
    return np.where(dmin <= range_m, serving, -1).astype(np.int32), dmin


def coverage_exit_time(positions: np.ndarray, velocities: np.ndarray,
                       centers: np.ndarray, range_m: float) -> np.ndarray:
    """Time until each vehicle, at constant velocity, leaves the disc of
    radius ``range_m`` around its serving RSU (capped at RESIDENCE_CAP_S
    for parked or dwelling vehicles)."""
    rel = positions - centers
    a = np.einsum("nd,nd->n", velocities, velocities)
    b = 2.0 * np.einsum("nd,nd->n", rel, velocities)
    c = np.einsum("nd,nd->n", rel, rel) - range_m ** 2
    disc = np.maximum(b * b - 4.0 * a * c, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_exit = (-b + np.sqrt(disc)) / (2.0 * a)
    t_exit = np.where(a > 1e-12, t_exit, RESIDENCE_CAP_S)
    return np.clip(t_exit, 0.0, RESIDENCE_CAP_S)


def _rates_to_serving(ch: channel.ChannelConfig, planar_dist: np.ndarray,
                      tx_power_w: np.ndarray, serving: np.ndarray,
                      seed: int) -> np.ndarray:
    """Uplink Shannon rates to the serving RSU (RSU height folded in);
    uncovered vehicles get rate 0."""
    d = np.sqrt(planar_dist ** 2 + RSU_HEIGHT_M ** 2)
    rates = channel.rates_from_distance(ch, d, tx_power_w, seed)
    return np.where(serving >= 0, rates, 0.0)


def _resolve_fleet(n: int, seed: int, fleet) -> Dict[str, np.ndarray]:
    if fleet is None:
        fleet = channel.make_fleet(n, seed)
    if not isinstance(fleet, dict):
        fleet = channel.fleet_arrays(fleet)
    return fleet


# --------------------------------------------------------------------------
# highway corridor
# --------------------------------------------------------------------------

@dataclasses.dataclass
class HighwayCorridor:
    """N RSUs every ``rsu_spacing_m`` along a straight multi-lane road.
    Vehicles drive at per-lane speeds (plus per-vehicle jitter) and wrap
    around the corridor (a wrap is one departure plus one fresh arrival).
    ``load_skew="zipf"`` starts a vehicle in segment s with probability
    ~ 1/(s+1): one crowded cell, a sparse tail."""
    name: str = "highway_corridor"
    n_vehicles: int = 8
    n_rsus: int = 4
    rsu_spacing_m: float = 700.0
    n_lanes: int = 3
    lane_speeds_mps: Sequence[float] = (24.0, 31.0, 38.0)
    lane_width_m: float = 3.7
    seed: int = 0
    load_skew: Optional[str] = None         # None (uniform) | "zipf"
    ch: channel.ChannelConfig = dataclasses.field(
        default_factory=channel.ChannelConfig)
    fleet: Optional[object] = None          # VehicleProfile list or arrays

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.fleet_arrays = _resolve_fleet(self.n_vehicles, self.seed,
                                           self.fleet)
        self.road_len_m = self.n_rsus * self.rsu_spacing_m
        rsu_x = (np.arange(self.n_rsus) + 0.5) * self.rsu_spacing_m
        self.rsu_positions = np.stack([rsu_x, np.zeros_like(rsu_x)], axis=-1)
        self._lane = rng.integers(0, self.n_lanes, size=self.n_vehicles)
        base = np.asarray(self.lane_speeds_mps)[self._lane]
        self._speed = base * rng.uniform(0.9, 1.1, size=self.n_vehicles)
        if self.load_skew is None:
            self._x0 = rng.uniform(0.0, self.road_len_m,
                                   size=self.n_vehicles)
        elif self.load_skew == "zipf":
            w = 1.0 / (np.arange(self.n_rsus) + 1.0)
            seg = rng.choice(self.n_rsus, size=self.n_vehicles,
                             p=w / w.sum())
            self._x0 = ((seg + rng.uniform(0.0, 1.0, size=self.n_vehicles))
                        * self.rsu_spacing_m)
        else:
            raise ValueError(f"unknown load_skew {self.load_skew!r}; "
                             f"expected None or 'zipf'")
        self._y = (self._lane - (self.n_lanes - 1) / 2.0) * self.lane_width_m

    def fleet_state(self, t: float, seed: int) -> FleetState:
        x = (self._x0 + self._speed * t) % self.road_len_m
        pos = np.stack([x, self._y], axis=-1)
        vel = np.stack([self._speed, np.zeros_like(self._speed)], axis=-1)
        serving, dist = nearest_rsu(pos, self.rsu_positions,
                                    self.ch.rsu_range_m)
        rates = _rates_to_serving(self.ch, dist,
                                  self.fleet_arrays["tx_power_w"], serving,
                                  seed)
        centers = self.rsu_positions[np.maximum(serving, 0)]
        # residence ends at the cell border or at the corridor wrap (a
        # departure: the vehicle re-enters at the road start)
        t_exit = coverage_exit_time(pos, vel, centers, self.ch.rsu_range_m)
        t_wrap = (self.road_len_m - x) / np.maximum(self._speed, 1e-9)
        res = np.where(serving >= 0, np.minimum(t_exit, t_wrap), 0.0)
        return FleetState(t, pos, vel, serving, rates, res)


# --------------------------------------------------------------------------
# urban grid
# --------------------------------------------------------------------------

_DIRS = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.int64)  # ENWS


@dataclasses.dataclass
class UrbanGrid:
    """Manhattan grid of ``grid_size`` x ``grid_size`` intersections
    ``block_m`` apart: vehicles traverse one block at a time, dwell
    ``dwell_s`` at each intersection and turn pseudo-randomly (U-turn at
    the boundary); RSUs sit at every ``rsu_every``-th intersection.  The
    trajectory is a pure function of (vehicle, block index, seed)."""
    name: str = "urban_grid"
    n_vehicles: int = 8
    grid_size: int = 5
    block_m: float = 250.0
    dwell_s: float = 4.0
    speed_mps: float = 12.0
    rsu_every: int = 2
    seed: int = 0
    ch: channel.ChannelConfig = dataclasses.field(
        default_factory=channel.ChannelConfig)
    fleet: Optional[object] = None

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.fleet_arrays = _resolve_fleet(self.n_vehicles, self.seed,
                                           self.fleet)
        n = self.n_vehicles
        self._node0 = rng.integers(0, self.grid_size, size=(n, 2))
        self._h0 = rng.integers(0, 4, size=n)
        self._speed = self.speed_mps * rng.uniform(0.85, 1.15, size=n)
        ticks = np.arange(0, self.grid_size, self.rsu_every)
        gx, gy = np.meshgrid(ticks, ticks, indexing="ij")
        self.rsu_positions = (np.stack([gx.ravel(), gy.ravel()], axis=-1)
                              * self.block_m).astype(np.float64)

    def _kinematics(self, t: float):
        """Vectorized block walk: (pos (n,2) m, step_dir (n,2), moving)."""
        n = self.n_vehicles
        per_block = self.block_m / self._speed + self.dwell_s
        k = np.floor(t / per_block).astype(np.int64)      # completed blocks
        frac = t - k * per_block
        offset = np.minimum(frac * self._speed, self.block_m)
        moving = frac * self._speed < self.block_m

        node = self._node0.copy()
        h = self._h0.copy()
        cur_dir = np.zeros((n, 2), dtype=np.int64)
        k_max = int(k.max(initial=0))
        for j in range(k_max + 1):
            if j > 0:
                turn = np.random.default_rng(
                    self.seed * 7919 + j).integers(-1, 2, size=n)
                h = (h + turn) % 4
            step = _DIRS[h]
            out = ((node + step < 0) | (node + step >= self.grid_size)
                   ).any(axis=-1)
            h = np.where(out, (h + 2) % 4, h)
            step = _DIRS[h]
            at = j == k                      # the current segment
            cur_dir = np.where(at[:, None], step, cur_dir)
            done = j < k                     # block completed: advance node
            node = np.where(done[:, None], node + step, node)
        pos = node * self.block_m + cur_dir * offset[:, None]
        return pos.astype(np.float64), cur_dir.astype(np.float64), moving

    def fleet_state(self, t: float, seed: int) -> FleetState:
        pos, cur_dir, moving = self._kinematics(t)
        vel = cur_dir * (self._speed * moving)[:, None]
        serving, dist = nearest_rsu(pos, self.rsu_positions,
                                    self.ch.rsu_range_m)
        rates = _rates_to_serving(self.ch, dist,
                                  self.fleet_arrays["tx_power_w"], serving,
                                  seed)
        # residence at the nominal (non-dwelling) velocity: a vehicle paused
        # at an intersection still has a finite deadline along its heading
        nominal = cur_dir * self._speed[:, None]
        centers = self.rsu_positions[np.maximum(serving, 0)]
        res = np.where(serving >= 0,
                       coverage_exit_time(pos, nominal, centers,
                                          self.ch.rsu_range_m), 0.0)
        return FleetState(t, pos, vel, serving, rates, res)


# --------------------------------------------------------------------------
# city grid (scale-out fixture)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CityGrid:
    """City-scale deployment: a ``grid_x`` x ``grid_y`` lattice of RSU cells
    serving thousands of vehicles.

    Each vehicle is anchored to a home cell drawn from the Zipf popularity
    law over the flattened cell index (``load_skew="zipf"``; uniform with
    ``None``) and follows an eccentric orbit around that cell's centre: the
    radius breathes between ``r0*(1 - ecc)`` and ``r0*(1 + ecc)`` while the
    phase advances at an individual angular rate.  The radius band
    straddles the coverage radius, so vehicles swing through the gaps
    between cells (``serving_rsu == -1``: the signal mobility churn turns
    into departures) and wide orbits hand over to neighbouring cells.

    Every kinematic quantity is closed-form in ``t``, the fleet's
    attributes are drawn one column at a time, and association floors onto
    the lattice (O(n), no vehicle x RSU distance matrix).  The draws follow
    the reference's order from ``np.random.default_rng(seed)``, so every
    field of the fleet state is the reference's bit for bit."""
    name: str = "city"
    n_vehicles: int = 4096
    grid_x: int = 16
    grid_y: int = 16
    cell_m: float = 900.0        # lattice pitch; > 2*rsu_range_m leaves gaps
    orbit_frac: Sequence[float] = (0.35, 1.15)  # mean orbit r / rsu_range_m
    eccentricity: float = 0.45   # radial breathing amplitude, x mean radius
    speed_mps: float = 14.0
    seed: int = 0
    load_skew: Optional[str] = "zipf"       # "zipf" | None (uniform)
    ch: channel.ChannelConfig = dataclasses.field(
        default_factory=channel.ChannelConfig)
    fleet: Optional[object] = None

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = self.n_vehicles
        self.n_rsus = self.grid_x * self.grid_y
        self.fleet_arrays = (self._vector_fleet(rng) if self.fleet is None
                             else _resolve_fleet(n, self.seed, self.fleet))
        gx, gy = np.meshgrid(np.arange(self.grid_x), np.arange(self.grid_y),
                             indexing="ij")
        self.rsu_positions = ((np.stack([gx.ravel(), gy.ravel()], axis=-1)
                               + 0.5) * self.cell_m).astype(np.float64)
        if self.load_skew is None:
            home = rng.integers(0, self.n_rsus, size=n)
        elif self.load_skew == "zipf":
            w = 1.0 / (np.arange(self.n_rsus) + 1.0)
            home = rng.choice(self.n_rsus, size=n, p=w / w.sum())
        else:
            raise ValueError(f"unknown load_skew {self.load_skew!r}; "
                             f"expected None or 'zipf'")
        self._center = self.rsu_positions[home]
        lo, hi = self.orbit_frac
        self._radius = self.ch.rsu_range_m * rng.uniform(lo, hi, size=n)
        self._phase = rng.uniform(0.0, 2.0 * np.pi, size=n)
        speed = self.speed_mps * rng.uniform(0.85, 1.15, size=n)
        spin = rng.choice(np.array([-1.0, 1.0]), size=n)
        self._omega = spin * speed / np.maximum(self._radius, 1e-9)
        # radial breathing r(t) = r0 * (1 + ecc * sin(nu t + psi)), at a
        # rate incommensurate with the sweep so crossings do not phase-lock
        self._nu = np.abs(self._omega) * rng.uniform(0.4, 0.9, size=n)
        self._psi = rng.uniform(0.0, 2.0 * np.pi, size=n)

    def _vector_fleet(self, rng) -> Dict[str, np.ndarray]:
        """``channel.make_fleet`` + ``fleet_arrays`` drawn one column at a
        time (the same attribute distributions, no per-vehicle loop)."""
        n = self.n_vehicles
        return {
            "compute_flops": rng.uniform(5e9, 50e9, size=n),
            "tx_power_w": rng.uniform(0.2, 1.0, size=n),
            "compute_power_w": rng.uniform(8.0, 25.0, size=n),
            "x0_m": rng.uniform(-350.0, -50.0, size=n),
            "speed_mps": rng.uniform(8.0, 30.0, size=n),
            "memory_budget_bytes": np.full(n, float("inf")),
        }

    def _associate(self, pos: np.ndarray):
        """The nearest centre of a square lattice is the enclosing cell:
        floor and clip, O(n).  Returns (serving (n,) int32, distance)."""
        ij = np.floor(pos / self.cell_m).astype(np.int64)
        ij = np.clip(ij, 0, [self.grid_x - 1, self.grid_y - 1])
        flat = ij[:, 0] * self.grid_y + ij[:, 1]
        rel = pos - self.rsu_positions[flat]
        dist = np.sqrt(np.einsum("nd,nd->n", rel, rel))
        serving = np.where(dist <= self.ch.rsu_range_m, flat, -1)
        return serving.astype(np.int32), dist

    def fleet_state(self, t: float, seed: int) -> FleetState:
        theta = self._phase + self._omega * t
        ct, st = np.cos(theta), np.sin(theta)
        breathe = self._nu * t + self._psi
        r = self._radius * (1.0 + self.eccentricity * np.sin(breathe))
        dr = self._radius * self.eccentricity * self._nu * np.cos(breathe)
        pos = self._center + r[:, None] * np.stack([ct, st], -1)
        vel = (dr[:, None] * np.stack([ct, st], -1)
               + (r * self._omega)[:, None] * np.stack([-st, ct], -1))
        serving, dist = self._associate(pos)
        rates = _rates_to_serving(self.ch, dist,
                                  self.fleet_arrays["tx_power_w"], serving,
                                  seed)
        # residence linearises the orbit at the current velocity: the same
        # tangent-line deadline as every other scenario
        centers = self.rsu_positions[np.maximum(serving, 0)]
        res = np.where(serving >= 0,
                       coverage_exit_time(pos, vel, centers,
                                          self.ch.rsu_range_m), 0.0)
        return FleetState(t, pos, vel, serving, rates, res)


# --------------------------------------------------------------------------
# trace replay
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TraceReplay:
    """Deterministic trajectories: ``positions[i]`` is the fleet at
    ``times[i]``.  Association, residence and (fading-free by default)
    rates are precomputed per trace step, so a test knows the exact round a
    handover happens."""
    times: np.ndarray            # (T,) strictly increasing
    positions: np.ndarray        # (T, n, 2)
    rsu_positions: np.ndarray    # (n_rsus, 2)
    name: str = "trace_replay"
    ch: channel.ChannelConfig = dataclasses.field(default_factory=lambda:
                                                  channel.ChannelConfig(
                                                      fading_std_db=0.0))
    fleet: Optional[object] = None
    seed: int = 0

    def __post_init__(self):
        self.times = np.asarray(self.times, dtype=np.float64)
        self.positions = np.asarray(self.positions, dtype=np.float64)
        self.rsu_positions = np.asarray(self.rsu_positions, dtype=np.float64)
        T, n, _ = self.positions.shape
        if self.times.shape != (T,):
            raise ValueError(f"times {self.times.shape} do not match "
                             f"positions {self.positions.shape}")
        self.n_vehicles = n
        self.fleet_arrays = _resolve_fleet(n, self.seed, self.fleet)
        serving = np.empty((T, n), dtype=np.int32)
        dist = np.empty((T, n))
        for i in range(T):
            serving[i], dist[i] = nearest_rsu(self.positions[i],
                                              self.rsu_positions,
                                              self.ch.rsu_range_m)
        self._serving, self._dist = serving, dist
        # velocities: forward finite difference over the trace
        vel = np.zeros_like(self.positions)
        if T > 1:
            dt = np.diff(self.times)[:, None, None]
            vel[:-1] = np.diff(self.positions, axis=0) / np.maximum(dt, 1e-9)
            vel[-1] = vel[-2]
        self._vel = vel
        # residence[i] = min(time until the serving cell next changes along
        # the trace, geometric coverage-exit time at the current velocity)
        res = np.empty((T, n))
        dt_end = (self.times[-1] - self.times[-2]) if T > 1 else 0.0
        next_change = np.full(n, self.times[-1] + dt_end)
        for i in range(T - 1, -1, -1):
            if i < T - 1:
                changed = serving[i + 1] != serving[i]
                next_change = np.where(changed, self.times[i + 1],
                                       next_change)
            geo = coverage_exit_time(self.positions[i], vel[i],
                                     self.rsu_positions[np.maximum(
                                         serving[i], 0)],
                                     self.ch.rsu_range_m)
            res[i] = np.minimum(next_change - self.times[i], geo)
        self._residence = np.clip(res, 0.0, RESIDENCE_CAP_S)

    def _step(self, t: float) -> int:
        return int(np.clip(np.searchsorted(self.times, t, side="right") - 1,
                           0, len(self.times) - 1))

    def fleet_state(self, t: float, seed: int) -> FleetState:
        i = self._step(t)
        serving = self._serving[i]
        rates = _rates_to_serving(self.ch, self._dist[i],
                                  self.fleet_arrays["tx_power_w"], serving,
                                  seed)
        return FleetState(float(self.times[i]), self.positions[i],
                          self._vel[i], serving, rates,
                          np.where(serving >= 0, self._residence[i], 0.0))


def crossing_trace(n_vehicles: int, n_rsus: int = 2, t_end: float = 120.0,
                   n_steps: int = 60, rsu_spacing_m: float = 600.0,
                   speed_mps: float = 20.0, seed: int = 0,
                   ch: Optional[channel.ChannelConfig] = None,
                   fleet=None) -> TraceReplay:
    """Deterministic linear trace: the fleet drives the corridor end to
    end, crossing every cell boundary (the handover fixture)."""
    rng = np.random.default_rng(seed)
    times = np.linspace(0.0, t_end, n_steps)
    x0 = rng.uniform(-0.25 * rsu_spacing_m, 0.25 * rsu_spacing_m, n_vehicles)
    speeds = speed_mps * rng.uniform(0.9, 1.1, n_vehicles)
    x = x0[None, :] + speeds[None, :] * times[:, None]
    y = np.zeros_like(x)
    rsu_x = (np.arange(n_rsus) + 0.5) * rsu_spacing_m
    rsus = np.stack([rsu_x, np.zeros_like(rsu_x)], axis=-1)
    return TraceReplay(times, np.stack([x, y], axis=-1), rsus, seed=seed,
                       fleet=fleet,
                       ch=ch or channel.ChannelConfig(fading_std_db=0.0))


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

def highway_corridor(n_vehicles: int, seed: int = 0, **kw) -> HighwayCorridor:
    return HighwayCorridor(n_vehicles=n_vehicles, seed=seed, **kw)


def urban_grid(n_vehicles: int, seed: int = 0, **kw) -> UrbanGrid:
    return UrbanGrid(n_vehicles=n_vehicles, seed=seed, **kw)


def trace_replay(n_vehicles: int, seed: int = 0, **kw) -> TraceReplay:
    return crossing_trace(n_vehicles, seed=seed, **kw)


def highway_zipf(n_vehicles: int, seed: int = 0, **kw) -> HighwayCorridor:
    """Highway corridor with a Zipf-skewed initial cell load."""
    kw.setdefault("load_skew", "zipf")
    kw.setdefault("name", "highway_zipf")
    return HighwayCorridor(n_vehicles=n_vehicles, seed=seed, **kw)


def city(n_vehicles: int, seed: int = 0, **kw) -> CityGrid:
    """City-scale RSU lattice with Zipf cell popularity, orbit mobility
    and geometric coverage gaps: the scale-out / paging fixture."""
    return CityGrid(n_vehicles=n_vehicles, seed=seed, **kw)


SCENARIOS = {
    "highway_corridor": highway_corridor,
    "highway_zipf": highway_zipf,
    "urban_grid": urban_grid,
    "trace_replay": trace_replay,
    "city": city,
}
# scenarios of the reference that the port does not run yet
NOT_PORTED = ()


def make_scenario(name: str, n_vehicles: int, seed: int = 0, **kw):
    if name in NOT_PORTED:
        raise NotImplementedError(f"scenario {name!r}: not ported yet; "
                                  f"ported: {sorted(SCENARIOS)}")
    try:
        return SCENARIOS[name](n_vehicles, seed=seed, **kw)
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"available: {sorted(SCENARIOS)}") from None
