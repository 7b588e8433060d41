"""Declarative experiment specs (twin of ``repro.api.spec``).

Same groups, field names, defaults and JSON as the reference, so a spec
saved by ``repro.api`` loads here.  The device is deliberately *not* a spec
field (it is a keyword of ``run`` / ``build_engine``), so the JSON stays
identical to the reference's.

Validation covers what the port can run: the single-RSU engine (every
scheme, every ``cohort_parallel`` mode, its fault plane) and the multi-RSU
scenario engine (the sequential, parallel and streaming schedules,
super-step windows, both slot layouts, the fault plane and presence churn)
with the ported models and scenarios, with the reference's messages for
combinations no engine can run.  A scenario, a non-default value of a
plane that is not ported yet, or a multi-process topology raises "not
ported yet".  ``runtime.precompile`` is accepted and does nothing: the port
runs eagerly and compiles nothing but its kernels, at first use.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.api import registry
from repro_torch.core.fedsim import SimConfig

__all__ = [
    "TrainConfig", "AdaptiveConfig", "FleetConfig", "RuntimeConfig",
    "FaultsConfig", "StreamConfig", "ExperimentSpec",
    "SIM_CONFIG_FIELD_MAP",
]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The learning loop (paper defaults: batch 16, 5 local epochs,
    lr 1e-4)."""
    scheme: str = "asfl"
    batch_size: int = 16
    local_epochs: int = 5
    local_steps: Optional[int] = None
    lr: float = 1e-4
    rounds: int = 10
    optimizer: str = "adam"
    eval_every: int = 1
    compress_smashed: bool = False
    server_schedule: str = "sequential"
    wire: str = "none"
    wire_k: float = 0.25


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Cut-layer selection — the 'adaptive' in ASFL."""
    strategy: str = "paper"
    cut: int = 4


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The fleet and where it drives (``single_rsu`` / None, or a multi-RSU
    scenario with its builder keywords and edge->cloud cadence)."""
    n_vehicles: int = 4
    scenario: Optional[str] = registry.SINGLE_RSU
    scenario_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    cloud_sync_every: int = 1
    round_interval_s: float = 5.0
    mobility_dropout: bool = False
    server_flops: float = 2e12
    per_vehicle_samples: int = 64
    test_samples: int = 256
    data_seed: int = 0
    memory_budget_bytes: Optional[Union[float, Tuple[float, float]]] = None


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs: ``cohort_parallel`` picks the single-RSU engine's
    replica schedule; of the reference's XLA knobs only the defaults run
    here."""
    seed: int = 0
    cohort_parallel: str = "auto"
    superstep: int = 1
    slot_capacity: str = "pow2"
    superstep_layout: str = "ragged"
    precompile: bool = True
    compilation_cache_dir: Optional[str] = None
    mesh_devices: Union[int, str] = 1
    fleet_axis: str = "auto"
    mesh_shape: str = "auto"
    page_slots: int = 0
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0


@dataclasses.dataclass(frozen=True)
class FaultsConfig:
    """The fault plane: coverage, dropout and upload loss on the single-RSU
    engine; dropout, upload loss, deadline stragglers with the staleness
    bank and RSU outages on a multi-RSU scenario (coverage there is the
    scenario's own, serving_rsu == -1).  All defaults: no faults."""
    coverage: bool = False
    dropout_rate: float = 0.0
    upload_loss_rate: float = 0.0
    straggler_factor: float = 0.0
    rsu_outage_rate: float = 0.0
    staleness_discount: float = 0.5
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """The streaming plane of a multi-RSU scenario: presence churn (a
    seeded toggle chain at ``churn_rate``, or coverage with
    ``churn_source="mobility"``) on any schedule, and the StreamBuffer of
    ``train.server_schedule="streaming"`` (``buffer_size`` deltas per RSU,
    discounted by ``kernel`` / ``alpha``).  All defaults: no streaming."""
    buffer_size: int = 4
    churn_rate: float = 0.0
    kernel: str = "constant"
    alpha: float = 0.5
    seed: int = 0
    churn_source: str = "markov"


# SimConfig field -> (spec group, group field), as in the reference
SIM_CONFIG_FIELD_MAP: Dict[str, Tuple[str, str]] = {
    "scheme": ("train", "scheme"),
    "batch_size": ("train", "batch_size"),
    "local_epochs": ("train", "local_epochs"),
    "local_steps": ("train", "local_steps"),
    "lr": ("train", "lr"),
    "rounds": ("train", "rounds"),
    "optimizer": ("train", "optimizer"),
    "eval_every": ("train", "eval_every"),
    "compress_smashed": ("train", "compress_smashed"),
    "server_schedule": ("train", "server_schedule"),
    "wire": ("train", "wire"),
    "wire_k": ("train", "wire_k"),
    "adaptive_strategy": ("adaptive", "strategy"),
    "cut": ("adaptive", "cut"),
    "n_clients": ("fleet", "n_vehicles"),
    "round_interval_s": ("fleet", "round_interval_s"),
    "mobility_dropout": ("fleet", "mobility_dropout"),
    "server_flops": ("fleet", "server_flops"),
    "fault_coverage": ("faults", "coverage"),
    "fault_dropout": ("faults", "dropout_rate"),
    "fault_upload_loss": ("faults", "upload_loss_rate"),
    "fault_straggler": ("faults", "straggler_factor"),
    "fault_rsu_outage": ("faults", "rsu_outage_rate"),
    "fault_staleness_discount": ("faults", "staleness_discount"),
    "fault_seed": ("faults", "seed"),
    "stream_buffer_size": ("stream", "buffer_size"),
    "stream_churn_rate": ("stream", "churn_rate"),
    "stream_kernel": ("stream", "kernel"),
    "stream_alpha": ("stream", "alpha"),
    "stream_seed": ("stream", "seed"),
    "stream_churn_source": ("stream", "churn_source"),
    "seed": ("runtime", "seed"),
    "cohort_parallel": ("runtime", "cohort_parallel"),
    "superstep": ("runtime", "superstep"),
    "slot_capacity": ("runtime", "slot_capacity"),
    "superstep_layout": ("runtime", "superstep_layout"),
    "compilation_cache_dir": ("runtime", "compilation_cache_dir"),
    "mesh_devices": ("runtime", "mesh_devices"),
    "fleet_axis": ("runtime", "fleet_axis"),
    "mesh_shape": ("runtime", "mesh_shape"),
    "page_slots": ("runtime", "page_slots"),
}

_GROUP_TYPES = {"train": TrainConfig, "adaptive": AdaptiveConfig,
                "fleet": FleetConfig, "runtime": RuntimeConfig,
                "faults": FaultsConfig, "stream": StreamConfig}


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One experiment: model x scenario x strategy x schedule plus the
    nested config groups.  ``repro_torch.api.run(spec)`` runs it."""
    model: str = "resnet18"
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    adaptive: AdaptiveConfig = dataclasses.field(
        default_factory=AdaptiveConfig)
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    faults: FaultsConfig = dataclasses.field(default_factory=FaultsConfig)
    stream: StreamConfig = dataclasses.field(default_factory=StreamConfig)
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def engine_kind(self) -> str:
        sc = self.fleet.scenario
        return (registry.FEDERATION
                if sc in (None, registry.SINGLE_RSU) else registry.SCENARIO)

    def __post_init__(self):
        sc = self.fleet.scenario
        if sc in registry.NOT_PORTED_SCENARIOS:
            raise NotImplementedError(
                f"fleet.scenario={sc!r}: not ported yet; scenarios: "
                f"{registry.scenario_names()} (None == single_rsu)")
        if sc is not None and sc not in registry.SCENARIOS:
            raise ValueError(
                f"unknown scenario {sc!r}; registered: "
                f"{registry.scenario_names()} (None == single_rsu)")
        engine = self.engine_kind
        rt = self.runtime
        meshy = rt.mesh_devices == "auto" \
            or (isinstance(rt.mesh_devices, int) and rt.mesh_devices > 1)
        if meshy and engine == registry.FEDERATION:
            # combinations the reference refuses whatever the mesh; the
            # mesh itself is not ported yet (to_sim_config raises)
            if self.train.scheme in ("cl", "sl"):
                raise ValueError(
                    f"scheme {self.train.scheme!r} is an inherently "
                    f"sequential chain (one traveling model); "
                    f"runtime.mesh_devices={rt.mesh_devices} has "
                    f"nothing to shard — use fl | sfl | asfl or "
                    f"mesh_devices=1")
            if rt.cohort_parallel in ("scan", "unroll"):
                raise ValueError(
                    f"runtime.cohort_parallel={rt.cohort_parallel!r} "
                    f"serializes the replica axis the mesh shards; "
                    f"with mesh_devices > 1 use 'vmap' (or 'auto')")
        self.to_sim_config()        # field validity + not-ported planes
        entry = registry.model_entry(self.model)

        strat = registry.STRATEGIES.get(self.adaptive.strategy)
        if strat is None:
            raise ValueError(
                f"unknown adaptive strategy {self.adaptive.strategy!r}; "
                f"registered: {' | '.join(sorted(registry.STRATEGIES))}")
        # the strategy is consumed whenever cuts are adaptive (asfl on the
        # single-RSU engine; always on the scenario engine)
        consumed = engine == registry.SCENARIO or self.train.scheme == "asfl"
        if consumed and engine not in strat.engines:
            ok = sorted(n for n, s in registry.STRATEGIES.items()
                        if engine in s.engines)
            raise ValueError(
                f"adaptive strategy {strat.name!r} is not executable by the "
                f"{engine} engine (fleet.scenario={sc!r}); strategies this "
                f"engine supports: {' | '.join(ok)}")
        sched = registry.SCHEDULES.get(self.train.server_schedule)
        if sched is None:
            raise ValueError(
                f"unknown server schedule {self.train.server_schedule!r}; "
                f"registered: {' | '.join(sorted(registry.SCHEDULES))}")
        if engine not in sched.engines:
            ok = sorted(n for n, s in registry.SCHEDULES.items()
                        if engine in s.engines)
            raise ValueError(
                f"server schedule {sched.name!r} is not executable by the "
                f"{engine} engine (fleet.scenario={sc!r}); schedules this "
                f"engine supports: {' | '.join(ok)} (the parallel and "
                f"streaming schedules need a multi-RSU scenario)")
        wire = registry.WIRES.get(self.train.wire)
        if wire is None:
            raise ValueError(
                f"unknown wire scheme {self.train.wire!r}; registered: "
                f"{registry.wire_names()}")
        fl = self.faults
        if engine == registry.SCENARIO:
            if self.train.scheme != "asfl":
                raise ValueError(
                    f"scheme {self.train.scheme!r} is not executable by the "
                    f"multi-RSU scenario engine (fleet.scenario={sc!r}); it "
                    f"runs the adaptive split flow only: scheme='asfl'. "
                    f"Use fleet.scenario='single_rsu' for cl | fl | sl | "
                    f"sfl")
            if self.fleet.mobility_dropout:
                raise ValueError(
                    "fleet.mobility_dropout is the single-RSU interruption "
                    "model; multi-RSU scenarios model coverage through the "
                    "scenario itself (serving_rsu == -1)")
            if self.fleet.memory_budget_bytes is not None:
                raise ValueError(
                    "fleet.memory_budget_bytes feeds the single-RSU "
                    "'memory' strategy; the scenario engine's strategies "
                    "are: " + " | ".join(sorted(
                        n for n, s in registry.STRATEGIES.items()
                        if registry.SCENARIO in s.engines)))
            if fl.coverage:
                raise ValueError(
                    "faults.coverage is the single-RSU §II-C in-range "
                    "test; multi-RSU scenarios model coverage through the "
                    "scenario itself (serving_rsu == -1)")
        else:
            if self.runtime.superstep > 1:
                raise ValueError(
                    f"runtime.superstep={self.runtime.superstep} fuses "
                    f"multi-RSU rounds; the single-RSU engine dispatches "
                    f"per round — set a fleet.scenario "
                    f"({registry.scenario_names()}) or superstep=1")
            if self.fleet.cloud_sync_every != 1:
                raise ValueError(
                    "fleet.cloud_sync_every is the multi-RSU edge->cloud "
                    "cadence; the single-RSU engine aggregates at its one "
                    "RSU every round (leave it at 1 or set a scenario)")
            if fl.straggler_factor > 0.0 or fl.rsu_outage_rate > 0.0:
                raise ValueError(
                    "faults.straggler_factor / faults.rsu_outage_rate need "
                    "a multi-RSU scenario (residence deadlines and RSU "
                    "outages are scenario concepts); the single-RSU engine "
                    "supports dropout_rate / upload_loss_rate / coverage")
            if ((fl.dropout_rate > 0.0 or fl.upload_loss_rate > 0.0)
                    and self.train.scheme not in ("sfl", "asfl")):
                raise ValueError(
                    f"stochastic fault injection is wired into the "
                    f"split-federation round (sfl | asfl); scheme "
                    f"{self.train.scheme!r} does not support it")
            if self.stream.churn_rate > 0.0 \
                    or self.stream.churn_source == "mobility":
                raise ValueError(
                    "presence churn (stream.churn_rate > 0 or "
                    "stream.churn_source='mobility') needs a multi-RSU "
                    "scenario (continuous arrivals/departures live on the "
                    "scenario engine's presence plane); the single-RSU "
                    "engine models interruption via fleet.mobility_dropout")
            if rt.page_slots > 0:
                raise ValueError(
                    "runtime.page_slots pages the multi-RSU super-step's "
                    "compacted slot axis; set a fleet.scenario (and "
                    "superstep_layout='ragged' with a parallel or "
                    "streaming schedule), or leave it at 0")
        if rt.page_slots < 0 or not isinstance(rt.page_slots, int):
            raise ValueError(
                f"runtime.page_slots={rt.page_slots!r} must be an int >= 0")
        if rt.page_slots > 0 and engine == registry.SCENARIO \
                and (rt.superstep_layout != "ragged"
                     or self.train.server_schedule == "sequential"):
            raise ValueError(
                "runtime.page_slots pages the RAGGED layout's compacted "
                "slot axis under the parallel/streaming schedules; the "
                "dense layout and the sequential chain have no compacted "
                "axis to page — set superstep_layout='ragged' and a "
                "non-sequential train.server_schedule, or page_slots=0")
        if (rt.coordinator_address is not None or rt.num_processes != 1
                or rt.process_id != 0):
            raise NotImplementedError(
                "multi-process runs (runtime.coordinator_address / "
                "num_processes / process_id): not ported yet")
        if self.train.scheme in ("sl", "sfl") \
                and not 1 <= self.adaptive.cut <= entry.n_units - 1:
            raise ValueError(
                f"adaptive.cut={self.adaptive.cut} is out of range for "
                f"model {self.model!r} ({entry.n_units} units): fixed cuts "
                f"must be in [1, {entry.n_units - 1}]")
        for field in ("per_vehicle_samples", "test_samples"):
            if getattr(self.fleet, field) < 1:
                raise ValueError(f"fleet.{field}="
                                 f"{getattr(self.fleet, field)!r} must be "
                                 f">= 1")
        if self.fleet.per_vehicle_samples < self.train.batch_size \
                and self.train.local_steps is None:
            raise ValueError(
                f"fleet.per_vehicle_samples={self.fleet.per_vehicle_samples}"
                f" < train.batch_size={self.train.batch_size} with "
                f"epoch-driven local steps; raise per_vehicle_samples or "
                f"set train.local_steps")

    def to_sim_config(self) -> SimConfig:
        kw = {}
        for sim_field, (group, field) in SIM_CONFIG_FIELD_MAP.items():
            kw[sim_field] = getattr(getattr(self, group), field)
        return SimConfig(**kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **dumps_kw) -> str:
        return json.dumps(self.to_dict(), **dumps_kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        kw = dict(d)
        for group, typ in _GROUP_TYPES.items():
            if group in kw and isinstance(kw[group], dict):
                kw[group] = typ(**kw[group])
        # JSON has no tuples: restore the (lo, hi) budget pair
        fleet = kw.get("fleet")
        if isinstance(fleet, FleetConfig) \
                and isinstance(fleet.memory_budget_bytes, list):
            kw["fleet"] = dataclasses.replace(
                fleet, memory_budget_bytes=tuple(fleet.memory_budget_bytes))
        return cls(**kw)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))
