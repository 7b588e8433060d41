"""``run(spec)``: the port's front door (twin of ``repro.api.runner``).

Routes a spec to :class:`~repro_torch.core.fedsim.FederationSim` (single
RSU) or :class:`~repro_torch.core.fedsim.ScenarioEngine` (a multi-RSU
scenario) on the requested device (``cuda`` unless ``device="cpu"``; raises
without a card), drives it, and returns a :class:`RunResult` with the
reference's keys.  ``diagnostics`` also names the device, the kernels'
launch counts during the run, the client batch steps and the bytes that
crossed the wire.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.api import registry
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core import channel
from repro_torch.core.fedsim import (FederationSim, RoundMetrics,
                                     ScenarioEngine, ScenarioRoundMetrics)
from repro_torch.device import DeviceLike, device_name, resolve_device

__all__ = ["RunResult", "run", "build_engine"]


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return float(o)


@dataclasses.dataclass
class RunResult:
    """Everything one experiment produced.  ``final_params`` is the trained
    global model ``(units, head)`` as host numpy arrays in the reference's
    layout (HWIO convolutions; an LM's periods stacked on an axis of size 1);
    not serialized by :meth:`save`."""
    spec: ExperimentSpec
    engine_kind: str
    history: List[Any]
    totals: Dict[str, float]
    timing: Dict[str, float]
    diagnostics: Dict[str, Any]
    final_params: Any = dataclasses.field(default=None, repr=False)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "spec": self.spec.to_dict(),
            "engine_kind": self.engine_kind,
            "history": [dataclasses.asdict(m) for m in self.history],
            "totals": self.totals,
            "timing": self.timing,
            "diagnostics": self.diagnostics,
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, default=_json_default)
        return path

    @classmethod
    def load(cls, path: str) -> "RunResult":
        with open(path) as f:
            d = json.load(f)
        metrics_cls = (ScenarioRoundMetrics
                       if d["engine_kind"] == registry.SCENARIO
                       else RoundMetrics)
        return cls(spec=ExperimentSpec.from_dict(d["spec"]),
                   engine_kind=d["engine_kind"],
                   history=[metrics_cls(**m) for m in d["history"]],
                   totals=d["totals"], timing=d["timing"],
                   diagnostics=d["diagnostics"])


def build_engine(spec: ExperimentSpec, *, device: DeviceLike = None):
    """The engine a spec routes to, on ``device`` (``cuda`` by default)."""
    dev = resolve_device(device)
    entry = registry.model_entry(spec.model)
    model = entry.build(**spec.model_kwargs)
    f = spec.fleet
    clients, test = entry.make_data(f.n_vehicles, f.per_vehicle_samples,
                                    f.test_samples, f.data_seed)
    cfg = spec.to_sim_config()
    if spec.engine_kind == registry.SCENARIO:
        kw = dict(f.scenario_kwargs)
        kw.setdefault("seed", spec.runtime.seed)
        sc = registry.build_scenario(f.scenario, f.n_vehicles, **kw)
        return ScenarioEngine(model, clients, test, cfg, sc,
                              cloud_sync_every=f.cloud_sync_every,
                              device=dev)
    fleet = None
    if f.memory_budget_bytes is not None:
        fleet = channel.make_fleet(f.n_vehicles, cfg.seed,
                                   memory_budget_bytes=f.memory_budget_bytes)
    return FederationSim(model, clients, test, cfg, fleet=fleet, device=dev)


def _totals(history) -> Dict[str, float]:
    accs = [m.test_acc for m in history if np.isfinite(m.test_acc)]
    totals = {
        "rounds": len(history),
        "comm_bytes": float(sum(m.comm_bytes for m in history)),
        "energy_j": float(sum(m.energy_j for m in history)),
        "sim_time_s": float(sum(m.sim_time_s for m in history)),
        "final_loss": float(history[-1].loss) if history else float("nan"),
        "final_acc": float(accs[-1]) if accs else float("nan"),
    }
    if history:
        totals["survivor_frac"] = float(np.mean(
            [m.survivor_frac for m in history]))
        totals["lost_update_bytes"] = float(sum(
            m.lost_update_bytes for m in history))
        totals["n_dropout"] = int(sum(m.n_dropout for m in history))
        totals["n_upload_lost"] = int(sum(m.n_upload_lost for m in history))
        totals["n_straggler"] = int(sum(
            getattr(m, "n_straggler", 0) for m in history))
        # the streaming plane: sample weight absorbed into the models (the
        # goodput numerator), buffered merges and arrivals
        totals["absorbed_samples"] = float(sum(
            getattr(m, "absorbed_samples", 0.0) for m in history))
        totals["stream_merges"] = int(sum(
            getattr(m, "stream_merges", 0) for m in history))
        totals["n_arrived"] = int(sum(
            getattr(m, "n_arrived", 0) for m in history))
    return totals


def run(spec: ExperimentSpec, *, device: DeviceLike = None,
        on_round: Optional[Callable[[Any], None]] = None,
        on_cloud_merge: Optional[Callable[[int, Any], None]] = None,
        on_stream_merge: Optional[Callable[[Any, Any], None]] = None
        ) -> RunResult:
    """Execute a spec end to end on ``device`` (``cuda`` by default) and
    return a :class:`RunResult`; ``on_round(metrics)`` fires per round and,
    on a multi-RSU scenario, ``on_cloud_merge(rnd, engine)`` after every
    cloud sync and ``on_stream_merge(metrics, engine)`` after every round
    in which a StreamBuffer fired."""
    engine = build_engine(spec, device=device)
    scenario = isinstance(engine, ScenarioEngine)
    counted = engine if scenario else engine.engine
    launches0 = kernels.launch_counts()
    steps0, bytes0 = counted.batch_steps, counted.wire_bytes
    t0 = time.perf_counter()
    if scenario:
        history = engine.run(on_round=on_round,
                             on_cloud_merge=on_cloud_merge,
                             on_stream_merge=on_stream_merge)
    else:
        history = engine.run(on_round=on_round)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    run_s = time.perf_counter() - t0
    n = max(len(history), 1)
    timing = {"warmup_s": 0.0, "run_s": run_s, "round_s": run_s / n,
              "rounds_per_s": n / run_s if run_s else 0.0}
    launches = kernels.launch_counts()
    diagnostics: Dict[str, Any] = {
        "model": spec.model, "wire": spec.train.wire,
        "mode": counted.mode,
        "n_rsus": engine.n_rsus if scenario else 1}
    if scenario:
        diagnostics.update(compile_fallbacks=0,
                           superstep_layout=spec.runtime.superstep_layout,
                           occupancy=engine.occupancy_stats())
    diagnostics.update({
        "mesh_devices": 1, "fleet_axis": None, "mesh_shape": None,
        "n_processes": 1, "device": device_name(engine.device),
        "kernel_launches": {k: launches[k] - launches0[k] for k in launches},
        "client_batch_steps": counted.batch_steps - steps0,
        "wire_bytes": counted.wire_bytes - bytes0,
    })
    if spec.runtime.page_slots > 0:
        diagnostics["page_slots"] = spec.runtime.page_slots
    stale_key = ("stale_merged" if spec.faults.straggler_factor > 0.0
                 else "stream_stale"
                 if spec.train.server_schedule == "streaming" else None)
    if stale_key is not None:
        # the staleness histogram: banked straggler weight merged per
        # round, or the buffered age mass the StreamBuffer merged
        counts, edges = np.histogram(
            [float(getattr(m, stale_key, 0.0)) for m in history], bins=8)
        diagnostics["staleness_hist"] = {"counts": counts.tolist(),
                                         "edges": edges.tolist()}
    totals = _totals(history)
    totals["goodput_samples_per_s"] = (
        totals.get("absorbed_samples", 0.0) / run_s if run_s else 0.0)
    return RunResult(spec=spec, engine_kind=spec.engine_kind,
                     history=list(history), totals=totals, timing=timing,
                     diagnostics=diagnostics,
                     final_params=engine.model.params_to_numpy(
                         engine.units, engine.head))
