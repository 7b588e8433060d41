"""``repro_torch.api`` — the port's declarative front door.

    from repro_torch import api

    spec = api.ExperimentSpec(train=api.TrainConfig(rounds=2,
                                                    wire="topk_int8"))
    result = api.run(spec)                 # on cuda; device="cpu" for CPU
    result.save("run.json")

Specs are JSON-compatible with ``repro.api``: a spec saved there loads here.
"""
from repro_torch.api.registry import (  # noqa: F401
    FEDERATION, MODELS, SCENARIO, SCENARIOS, SCHEDULES, SINGLE_RSU,
    STRATEGIES, WIRES, ModelEntry, model_entry)
from repro_torch.api.runner import RunResult, build_engine, run  # noqa: F401
from repro_torch.api.spec import (  # noqa: F401
    SIM_CONFIG_FIELD_MAP, AdaptiveConfig, ExperimentSpec, FaultsConfig,
    FleetConfig, RuntimeConfig, StreamConfig, TrainConfig)

__all__ = [
    "ExperimentSpec", "TrainConfig", "AdaptiveConfig", "FleetConfig",
    "RuntimeConfig", "FaultsConfig", "StreamConfig", "SIM_CONFIG_FIELD_MAP",
    "MODELS", "SCENARIOS", "SCHEDULES", "STRATEGIES", "WIRES", "ModelEntry",
    "model_entry", "FEDERATION", "SCENARIO", "SINGLE_RSU",
    "run", "build_engine", "RunResult",
]
