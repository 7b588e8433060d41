"""The port's front door: specs saved by repro.api load in repro_torch.api
with equal fields; RunResult keeps the reference's keys; a tiny resnet18
ASFL round runs end to end through repro_torch.api.run on device="cpu";
the numpy data paths replay the reference exactly."""
import dataclasses

import numpy as np
import pytest

import repro.api as JAPI
from _torch_parity import cap_torch_threads
from repro.api import runner as JRUN
from repro.data import partition as JP
from repro.data import pipeline as JD
from repro_torch import api as TAPI
from repro_torch.core import fedsim as TF
from repro_torch.data import partition as TP
from repro_torch.data import pipeline as TD

cap_torch_threads()


@pytest.mark.parametrize("spec_kw", [
    {},
    {"model": "mlp9",
     "train": {"rounds": 3, "wire": "topk_int8", "wire_k": 0.3,
               "optimizer": "sgd", "lr": 1e-2, "local_steps": 2},
     "adaptive": {"strategy": "latency"},
     "fleet": {"n_vehicles": 6, "per_vehicle_samples": 32,
               "memory_budget_bytes": [1e6, 5e6]}},
    {"train": {"scheme": "sfl", "wire": "int8", "eval_every": 0},
     "adaptive": {"cut": 6}, "runtime": {"seed": 3}},
])
def test_spec_saved_by_repro_api_loads_here(spec_kw):
    groups = {"train": JAPI.TrainConfig, "adaptive": JAPI.AdaptiveConfig,
              "fleet": JAPI.FleetConfig, "runtime": JAPI.RuntimeConfig}
    kw = {k: (groups[k](**v) if k in groups else v)
          for k, v in spec_kw.items()}
    if "fleet" in kw and isinstance(kw["fleet"].memory_budget_bytes, list):
        kw["fleet"] = dataclasses.replace(
            kw["fleet"],
            memory_budget_bytes=tuple(kw["fleet"].memory_budget_bytes))
    js = JAPI.ExperimentSpec(**kw)
    ts = TAPI.ExperimentSpec.from_json(js.to_json())
    assert ts.to_dict() == js.to_dict()
    assert ts.to_json() == js.to_json()
    assert TAPI.ExperimentSpec.from_json(ts.to_json()) == ts
    assert dataclasses.asdict(ts.to_sim_config()) \
        == dataclasses.asdict(js.to_sim_config())


def test_spec_groups_and_result_keys_match_reference():
    for name in ("TrainConfig", "AdaptiveConfig", "FleetConfig",
                 "RuntimeConfig", "FaultsConfig", "StreamConfig",
                 "ExperimentSpec"):
        jf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(JAPI, name))]
        tf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(TAPI, name))]
        assert jf == tf, name
    assert TAPI.SIM_CONFIG_FIELD_MAP == JAPI.SIM_CONFIG_FIELD_MAP
    assert [f.name for f in dataclasses.fields(TAPI.RunResult)] \
        == [f.name for f in dataclasses.fields(JAPI.RunResult)]
    from repro.core.fedsim import RoundMetrics as JM
    assert [f.name for f in dataclasses.fields(TF.RoundMetrics)] \
        == [f.name for f in dataclasses.fields(JM)]


def test_spec_refuses_what_is_not_ported():
    for runtime in ({"num_processes": 2}, {"mesh_devices": 2}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            TAPI.ExperimentSpec(
                model="mlp9", fleet=TAPI.FleetConfig(
                    n_vehicles=6, scenario="highway_corridor"),
                runtime=TAPI.RuntimeConfig(**runtime))
    # ported: the city lattice, with slot paging on the parallel schedule
    TAPI.ExperimentSpec(
        model="mlp9", fleet=TAPI.FleetConfig(n_vehicles=64, scenario="city"),
        train=TAPI.TrainConfig(server_schedule="parallel"),
        runtime=TAPI.RuntimeConfig(page_slots=8))
    assert TAPI.registry.NOT_PORTED_SCENARIOS == ()
    # ported: faults and the streaming schedule on a scenario
    for kw in ({"faults": TAPI.FaultsConfig(dropout_rate=0.1)},
               {"train": TAPI.TrainConfig(server_schedule="streaming")}):
        TAPI.ExperimentSpec(
            model="mlp9", fleet=TAPI.FleetConfig(
                n_vehicles=6, scenario="highway_corridor"), **kw)
    # the parallel and streaming schedules need a scenario; like the
    # reference, the single-RSU engine cannot run them
    for schedule in ("parallel", "streaming"):
        with pytest.raises(ValueError, match="not executable"):
            TAPI.ExperimentSpec(train=TAPI.TrainConfig(
                scheme="cl", server_schedule=schedule))
    # the bfloat16 archs and the MLA / MoE archs train (as in the
    # reference's registry); an id neither registry knows is refused
    for model in ("qwen3-14b", "deepseek-v2-lite-16b", "dbrx-132b"):
        TAPI.ExperimentSpec(model=model)
    with pytest.raises(ValueError, match="not ported yet"):
        TAPI.ExperimentSpec(model="qwen3_14b")
    with pytest.raises(ValueError):
        TAPI.ExperimentSpec(adaptive=TAPI.AdaptiveConfig(
            strategy="residence"))


def test_resnet18_round_runs_through_api_on_cpu(tmp_path):
    spec = TAPI.ExperimentSpec(
        train=TAPI.TrainConfig(rounds=1, batch_size=4, local_steps=1,
                               eval_every=0, wire="topk_int8"),
        fleet=TAPI.FleetConfig(per_vehicle_samples=16, test_samples=8))
    res = TAPI.run(spec, device="cpu")
    (m,) = res.history
    assert np.isfinite(m.loss) and m.loss > 0
    assert set(m.cuts) <= {2, 4, 6, 8} and len(m.cuts) == 4
    assert m.comm_bytes > 0 and m.sim_time_s > 0 and m.energy_j > 0
    assert res.diagnostics["device"] == "cpu"
    assert res.diagnostics["client_batch_steps"] == 4
    assert set(res.diagnostics["kernel_launches"].values()) == {0}
    assert set(res.totals) == set(JRUN._totals(res.history)) \
        | {"goodput_samples_per_s"}
    units, head = res.final_params
    assert units[0]["conv"].shape == (3, 3, 3, 64)       # HWIO, as repro's
    assert head["w"].shape == (512, 10)
    back = TAPI.RunResult.load(res.save(str(tmp_path / "run.json")))
    assert back.spec == spec
    assert [(m.loss, m.cuts, m.comm_bytes) for m in back.history] \
        == [(m.loss, m.cuts, m.comm_bytes) for m in res.history]
    assert back.to_dict()["diagnostics"] == res.diagnostics


def test_numpy_data_paths_replay_the_reference():
    for seed in (0, 7):
        assert np.array_equal(JD.sample_batch_indices(37, 16, seed),
                              TD.sample_batch_indices(37, 16, seed))
        assert np.array_equal(JD.sample_batch_indices(5, 16, seed),
                              TD.sample_batch_indices(5, 16, seed))
        assert np.array_equal(JD.epoch_batch_indices(37, 8, seed),
                              TD.epoch_batch_indices(37, 8, seed))
        labels = np.random.default_rng(seed).integers(0, 10, size=256)
        for a, b in zip(JP.label_skew_power_law(seed, labels, 4),
                        TP.label_skew_power_law(seed, labels, 4)):
            assert np.array_equal(a, b)
    clients, test = TD.make_federated_data(0, n_train=256, n_test=32)
    assert [c.images.shape[1:] for c in clients] == [(32, 32, 3)] * 4
    assert test["images"].dtype == np.float32
    assert sum(len(c) for c in clients) > 0
