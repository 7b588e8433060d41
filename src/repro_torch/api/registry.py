"""String-keyed registries of the port's front door (twin of
``repro.api.registry``, holding what is ported so far).

Models ``resnet18``, ``mlp9`` and every text arch of the reference
(``smollm-360m``, ``mamba2-780m``, ``gemma3-4b``, ``recurrentgemma-2b``,
``deepseek-v2-lite-16b`` (MLA, MoE), and in bfloat16 ``qwen3-14b``,
``command-r-35b`` and ``dbrx-132b`` (MoE): a ``TransformerUnitModel`` of
the reduced config by default, ``model_kwargs={"reduced": False}`` for the
full stack; an arch in ``configs.SERVE_ONLY``, none today, would be "not
ported yet");
scenarios ``single_rsu`` (the
single-RSU ``FederationSim``) and the ported multi-RSU scenarios of
``core/scenario.py`` (the ``ScenarioEngine``); every cut strategy and wire
scheme and server schedule of the reference as metadata (which engine may
run it: ``sequential`` on both engines, ``parallel`` and ``streaming`` on
the scenario engine).  A name the reference knows but the port does not
is refused with "not ported yet".
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch import configs as _configs
from repro_torch.core import scenario as _scenario
from repro_torch.core.fedsim import (FEDERATION_STRATEGIES,
                                     SCENARIO_STRATEGIES, SERVER_SCHEDULES,
                                     WIRE_SCHEMES)

FEDERATION = "federation"   # single-RSU FederationSim / CohortEngine
SCENARIO = "scenario"       # multi-RSU ScenarioEngine
SINGLE_RSU = "single_rsu"   # the scenario key that routes to FederationSim


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """A federated model: ``UnitModel`` builder + its fleet-data builder
    ``make_data(n_vehicles, per_vehicle, n_test, seed)``."""
    name: str
    build: Callable[..., Any]
    make_data: Callable[[int, int, int, int], Tuple[list, dict]]
    n_units: int
    description: str = ""


def _build_resnet(**kw):
    from repro_torch.core.fedsim import ResNetModel
    return ResNetModel(**kw)


def _resnet_data(n_vehicles, per_vehicle, n_test, seed):
    from repro_torch.data.pipeline import make_federated_data
    return make_federated_data(seed, n_train=per_vehicle * n_vehicles,
                               n_test=n_test, n_clients=n_vehicles)


def _build_mlp9(**kw):
    from repro_torch.models.mlp_unit import MLPUnitModel
    return MLPUnitModel(**kw)


def _mlp9_data(n_vehicles, per_vehicle, n_test, seed):
    from repro_torch.models.mlp_unit import make_mlp_fleet_data
    return make_mlp_fleet_data(n_vehicles, per_vehicle, seed=seed,
                               n_test=n_test)


def make_lm_fleet_data(n_vehicles: int, per_vehicle: int, n_test: int,
                       seed: int, vocab_size: int, seq_len: int = 8):
    """Synthetic next-token shards for the LM UnitModels: ``images`` are
    token ids (n, seq), ``labels`` the shifted next tokens (the fedsim
    batch convention, core/lm_unit.py).  numpy ``default_rng``: the
    reference's shards bit for bit."""
    import numpy as np

    from repro_torch.data.pipeline import ClientDataset

    rng = np.random.default_rng(seed)

    def shard(n):
        toks = rng.integers(0, vocab_size, size=(n, seq_len + 1))
        return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))

    clients = []
    for i in range(n_vehicles):
        x, y = shard(per_vehicle)
        clients.append(ClientDataset(x, y, i))
    xt, yt = shard(n_test)
    return clients, {"images": xt, "labels": yt}


def _arch_model_entry(arch_id: str) -> ModelEntry:
    from repro_torch.configs import get_config
    cfg = get_config(arch_id)
    reduced_cfg = cfg.reduced()
    # unit granularity (core/lm_unit.py): embedding + one unit per period
    n_units = 1 + reduced_cfg.n_periods + (1 if reduced_cfg.tail else 0)

    def build(reduced: bool = True):
        from repro_torch.core.lm_unit import TransformerUnitModel
        c = get_config(arch_id)
        return TransformerUnitModel(c.reduced() if reduced else c)

    def make_data(n_vehicles, per_vehicle, n_test, seed):
        return make_lm_fleet_data(n_vehicles, per_vehicle, n_test, seed,
                                  vocab_size=reduced_cfg.vocab_size)

    return ModelEntry(
        name=arch_id, build=build, make_data=make_data, n_units=n_units,
        description=f"{cfg.family} LM ({cfg.source}); reduced config by "
                    f"default, model_kwargs={{'reduced': False}} for full")


def _text_arch_entries() -> Dict[str, ModelEntry]:
    from repro_torch.configs import ARCH_IDS, SERVE_ONLY, get_config
    return {a: _arch_model_entry(a) for a in ARCH_IDS
            if get_config(a).frontend == "none" and a not in SERVE_ONLY}


MODELS: Dict[str, ModelEntry] = {
    "resnet18": ModelEntry(
        "resnet18", _build_resnet, _resnet_data, n_units=9,
        description="the paper's ResNet18 over 32x32x3 (9 split points)"),
    "mlp9": ModelEntry(
        "mlp9", _build_mlp9, _mlp9_data, n_units=9,
        description="9-unit split MLP (models/mlp_unit.py)"),
    **_text_arch_entries(),
}
# the reference's arch ids the port does not train yet: the archs it
# serves only (none)
NOT_PORTED_MODELS = _configs.SERVE_ONLY


def model_entry(name: str) -> ModelEntry:
    if name in NOT_PORTED_MODELS:
        raise ValueError(f"model {name!r} is not ported yet; ported models: "
                         f"{' | '.join(sorted(MODELS))}")
    if name not in MODELS:
        raise ValueError(f"model {name!r} is unknown or not ported yet; "
                         f"ported models: {' | '.join(sorted(MODELS))}")
    return MODELS[name]


# the single-RSU entry is None: the router dispatches it to FederationSim
SCENARIOS: Dict[str, Optional[Callable[..., Any]]] = {
    SINGLE_RSU: None, **_scenario.SCENARIOS}
NOT_PORTED_SCENARIOS = _scenario.NOT_PORTED


def scenario_names() -> str:
    return " | ".join(sorted(SCENARIOS))


def build_scenario(name: str, n_vehicles: int, seed: int = 0, **kw):
    if SCENARIOS.get(name) is None:
        raise ValueError(f"{name!r} is not a multi-RSU scenario; "
                         f"registered: {scenario_names()}")
    return SCENARIOS[name](n_vehicles, seed=seed, **kw)


@dataclasses.dataclass(frozen=True)
class StrategyEntry:
    name: str
    engines: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class WireEntry:
    name: str
    engines: Tuple[str, ...]


STRATEGIES: Dict[str, StrategyEntry] = {
    name: StrategyEntry(name, tuple(
        kind for kind, names in ((FEDERATION, FEDERATION_STRATEGIES),
                                 (SCENARIO, SCENARIO_STRATEGIES))
        if name in names))
    for name in sorted(set(FEDERATION_STRATEGIES) | set(SCENARIO_STRATEGIES))
}
WIRES: Dict[str, WireEntry] = {
    name: WireEntry(name, (FEDERATION, SCENARIO)) for name in WIRE_SCHEMES}


@dataclasses.dataclass(frozen=True)
class ScheduleEntry:
    name: str
    engines: Tuple[str, ...]


# the reference's server schedules and the engines that may run them
SCHEDULES: Dict[str, ScheduleEntry] = {
    "sequential": ScheduleEntry("sequential", (FEDERATION, SCENARIO)),
    "parallel": ScheduleEntry("parallel", (SCENARIO,)),
    "streaming": ScheduleEntry("streaming", (SCENARIO,))}
assert set(SCHEDULES) == set(SERVER_SCHEDULES)


def wire_names() -> str:
    return " | ".join(sorted(WIRES))
