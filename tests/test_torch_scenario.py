"""The multi-RSU slice on the CPU: the port's scenarios, residence rule,
batch-index stream and cloud merge against the reference's host paths
(exactly equal: numpy on both sides), and the port's ScenarioEngine
(device="cpu") against repro.core.fedsim.ScenarioEngine at superstep=1 on
the sequential schedule, from the same initial parameters
(``bridge.params_to_torch``) and the reference's threefry draws injected
through the engine's ``batch_indices`` / ``fleet_states`` seams.

Engine settings as tests/test_superstep.py:23-28 (asfl, paper cuts, sgd
lr 1e-2, local_steps 2, batch 8, 4 rounds), on mlp9.  The adam case runs at
lr 1e-3, the lr of tests/test_torch_fedsim_adam.py: at 1e-2 adam turns
gradients that are float32 noise (different sum orders) into full-size
steps of either sign, which moved five weights of 23,000 by up to 1.4e-4.

Tolerances: cuts, RSU loads, handover / skip counts and comm_bytes equal;
per-round loss and final global parameters within 1e-5 (float32 sums in
another order, through the codec: measured <= 3e-7); sim_time_s and
energy_j within 1e-6 relative (the reference's float32 rates come from its
traced program); test accuracy (every sync round) within one of the 64
test samples."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (cap_torch_threads, jax_params_np, leaves_np,
                           max_abs_diff, port_leaves_np)
from repro import api as JAPI
from repro.core import adaptive as JA
from repro.core import aggregation as JAg
from repro.core import channel as JCh
from repro.core import cost as JC
from repro.core import fedsim as JF
from repro.core import scenario as JS
from repro.data import pipeline as JP
from repro.models import mlp_unit as JM
from repro_torch import api as TAPI
from repro_torch import bridge
from repro_torch.core import adaptive as TA
from repro_torch.core import aggregation as TAg
from repro_torch.core import channel as TCh
from repro_torch.core import cost as TC
from repro_torch.core import fedsim as TF
from repro_torch.core import scenario as TS
from repro_torch.data import pipeline as TP
from repro_torch.models import mlp_unit as TM

cap_torch_threads()

ROUNDS, INTERVAL, STEPS, BATCH = 4, 5.0, 2, 8


# ------------------------------------------------------------ host paths
SCENARIO_CASES = [("highway_corridor", 12, {}), ("highway_zipf", 12, {}),
                  ("urban_grid", 8, {}),
                  ("trace_replay", 5, {"n_rsus": 3, "n_steps": 30})]


@pytest.mark.parametrize("name,n,kw", SCENARIO_CASES,
                         ids=[c[0] for c in SCENARIO_CASES])
def test_fleet_state_equals_reference(name, n, kw):
    js = JS.make_scenario(name, n, seed=3, **kw)
    ts = TS.make_scenario(name, n, seed=3, **kw)
    np.testing.assert_array_equal(ts.rsu_positions, js.rsu_positions)
    for key in js.fleet_arrays:
        np.testing.assert_array_equal(ts.fleet_arrays[key],
                                      js.fleet_arrays[key])
    for rnd, t in enumerate((0.0, 5.0, 37.5, 90.0, 121.0)):
        a, b = js.fleet_state(t, 1000 + rnd), ts.fleet_state(t, 1000 + rnd)
        assert a.t == b.t
        for f in ("positions", "velocities", "serving_rsu", "rates_bps",
                  "residence_s"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                          err_msg=f"{name} t={t} {f}")


def test_crossing_trace_equals_reference():
    a = JS.crossing_trace(4, n_rsus=3, seed=2)
    b = TS.crossing_trace(4, n_rsus=3, seed=2)
    for f in ("times", "positions", "rsu_positions", "_serving", "_dist",
              "_vel", "_residence"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def test_residence_rule_batch_indices_and_cut_bound_equal_reference():
    fa = JCh.fleet_arrays(JCh.make_fleet(16, seed=4))
    rng = np.random.default_rng(0)
    rates = rng.uniform(1e6, 3e8, 16)
    residence = rng.uniform(0.0, 30.0, 16)
    for jp, tp in ((JC.resnet_profile(), TC.resnet_profile()),
                   (JM.MLPUnitModel().profile(),
                    TM.MLPUnitModel().profile())):
        for nb, batch, ep in ((2, 8, 1), (4, 16, 5)):
            assert TA.residence_aware(
                tp, rates, fa["compute_flops"], 2e12, nb, batch, ep,
                residence) == JA.residence_aware(
                jp, rates, fa["compute_flops"], 2e12, nb, batch, ep,
                residence)
    for strat in ("paper", "paper-literal", "residence"):
        for units in (5, 9):
            assert TA.strategy_max_cut(strat, units) \
                == JA.strategy_max_cut(strat, units)
    lengths = np.array([24, 7, 64, 1])
    np.testing.assert_array_equal(
        TP.fleet_batch_indices(lengths, 3, 8, 11),
        JP.fleet_batch_indices(lengths, 3, 8, 11))


@pytest.mark.parametrize("weights", [[3.0, 0.0, 5.0], [0.0, 0.0, 0.0]])
def test_cloud_merge_matches_reference(weights):
    rng = np.random.default_rng(1)
    edges = [{"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=3).astype(np.float32)} for _ in range(3)]
    prev = {"w": np.ones((4, 3), np.float32), "b": np.zeros(3, np.float32)}
    want = JAg.stacked_cloud_merge(
        jax.tree.map(lambda *a: jnp.stack(a), *edges),
        jnp.asarray(weights), prev)
    got = TAg.stacked_cloud_merge(
        {k: torch.from_numpy(np.stack([e[k] for e in edges])) for k in prev},
        weights, {k: torch.from_numpy(v) for k, v in prev.items()})
    for k in prev:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- engine parity
def _two_cell_trace(module):
    """tests/test_scenario.py's fixture: vehicle 0 drives RSU0 -> RSU1,
    vehicle 1 parks inside RSU0."""
    times = np.arange(ROUNDS + 1, dtype=np.float64) * INTERVAL
    x0 = np.linspace(300.0, 900.0, len(times))
    x1 = np.full(len(times), 250.0)
    x = np.stack([x0, x1], axis=-1)
    pos = np.stack([x, np.zeros_like(x)], axis=-1)
    rsus = np.array([[300.0, 0.0], [900.0, 0.0]])
    ch = module.channel.ChannelConfig(fading_std_db=0.0, rsu_range_m=320.0)
    return module.scenario.TraceReplay(times, pos, rsus, ch=ch, seed=0)


class _Mods:
    def __init__(self, channel, scenario):
        self.channel, self.scenario = channel, scenario


def _traced_states(sc, seed):
    """The reference's in-program fleet states of a traced-mobility
    scenario, as port FleetStates."""
    key = jax.random.PRNGKey(seed ^ 0x5EED5EED)

    def states(rnd):
        st = sc.traced_fleet_state(jnp.float32(rnd) * INTERVAL,
                                   jax.random.fold_in(key, rnd))
        return TS.FleetState(float(st.t), *(np.asarray(a) for a in (
            st.positions, st.velocities, st.serving_rsu, st.rates_bps,
            st.residence_s)))

    return states


def _run_both(scenario, wire, optimizer, lr, sync=2):
    kw = dict(scheme="asfl", adaptive_strategy="paper", rounds=ROUNDS,
              local_steps=STEPS, batch_size=BATCH, lr=lr,
              optimizer=optimizer, round_interval_s=INTERVAL, eval_every=1,
              superstep=1, wire=wire)
    if scenario == "trace":
        jsc = _two_cell_trace(_Mods(JCh, JS))
        tsc = _two_cell_trace(_Mods(TCh, TS))
    else:
        jsc = JS.make_scenario("urban_grid", 8, seed=0)
        tsc = TS.make_scenario("urban_grid", 8, seed=0)
    n = jsc.n_vehicles
    jc, jt = JM.make_mlp_fleet_data(n, 24, seed=0, n_test=64)
    tc, tt = TM.make_mlp_fleet_data(n, 24, seed=0, n_test=64)
    je = JF.ScenarioEngine(JM.MLPUnitModel(), jc, jt, JF.SimConfig(**kw),
                           jsc, cloud_sync_every=sync)
    lengths = np.array([len(c) for c in jc])
    base = jax.random.PRNGKey(0)

    def batch_indices(rnd):
        return np.asarray(JP.fleet_batch_indices_traced(
            jax.random.fold_in(base, rnd), lengths, STEPS, BATCH))

    te = TF.ScenarioEngine(
        TM.MLPUnitModel(), tc, tt, TF.SimConfig(**kw), tsc,
        cloud_sync_every=sync, device="cpu", batch_indices=batch_indices,
        fleet_states=(_traced_states(jsc, 0) if je.programs.traced_mobility
                      else None))
    te.set_params(*bridge.params_to_torch(*jax_params_np(je.units,
                                                         je.head)))
    serving = [(np.asarray(je._host_state(r).serving_rsu)
                if not je.programs.traced_mobility else None,
                te.fleet_states(r).serving_rsu) for r in range(ROUNDS)]
    return je, je.run(), te, te.run(), serving


PARITY = [("trace", "none", "sgd", 1e-2), ("trace", "int8", "sgd", 1e-2),
          ("trace", "topk_int8", "sgd", 1e-2),
          ("urban", "topk_int8", "sgd", 1e-2),
          ("trace", "topk_int8", "adam", 1e-3)]


@pytest.mark.parametrize("scenario,wire,optimizer,lr", PARITY,
                         ids=["-".join(c[:3]) for c in PARITY])
def test_scenario_engine_matches_reference(scenario, wire, optimizer, lr):
    je, jh, te, th, serving = _run_both(scenario, wire, optimizer, lr)
    assert len(jh) == len(th) == ROUNDS
    for ref_srv, port_srv in serving:
        if ref_srv is not None:
            np.testing.assert_array_equal(port_srv, ref_srv)
    for a, b in zip(jh, th):
        assert b.cuts == a.cuts
        assert b.rsu_loads == a.rsu_loads
        assert (b.n_scheduled, b.n_skipped, b.n_handover) \
            == (a.n_scheduled, a.n_skipped, a.n_handover)
        assert b.comm_bytes == a.comm_bytes
        np.testing.assert_allclose(b.sim_time_s, a.sim_time_s, rtol=1e-6)
        np.testing.assert_allclose(b.energy_j, a.energy_j, rtol=1e-6)
        assert abs(a.loss - b.loss) <= 1e-5
        assert np.isnan(a.test_acc) == np.isnan(b.test_acc)
        if not np.isnan(a.test_acc):
            assert abs(a.test_acc - b.test_acc) <= 1 / 64
    assert max_abs_diff(leaves_np(je.units, je.head),
                        port_leaves_np(te.units, te.head)) <= 1e-5
    if scenario == "trace":      # the fixture's handover really happened
        assert sum(m.n_handover for m in th) >= 1
        assert th[-1].rsu_loads == [1, 1]
    if wire == "topk_int8":      # residuals were carried, one per vehicle
        assert all(r is not None for r in te.wire_res)
        np.testing.assert_array_equal(te.wire_cut, th[-1].cuts)


def test_error_feedback_residual_resets_on_cut_change(monkeypatch):
    """A vehicle's residual is dropped when its cut changes (its layout is
    the smashed shape at that cut) and kept otherwise."""
    cfg = TF.SimConfig(rounds=2, local_steps=1, batch_size=8, lr=1e-2,
                       optimizer="sgd", wire="topk_int8", eval_every=0)
    sc = _two_cell_trace(_Mods(TCh, TS))
    clients, test = TM.make_mlp_fleet_data(2, 24, seed=0, n_test=16)
    eng = TF.ScenarioEngine(TM.MLPUnitModel(), clients, test, cfg, sc,
                            device="cpu")
    m0 = eng.run_round(0)
    kept = [r.clone() for r in eng.wire_res]
    seen = []
    real = TF.sfl_message_flow

    def spy(*args):
        seen.append(args[10])
        return real(*args)

    monkeypatch.setattr(TF, "sfl_message_flow", spy)
    m1 = eng.run_round(1)
    assert m0.cuts[1] == m1.cuts[1] and m0.cuts[0] != m1.cuts[0]
    # slots run in (cut, vehicle) order within an RSU: vehicle 1 (cut 2)
    # first with its residual, vehicle 0 (new cut) from zero
    assert len(seen) == 2 and seen[1] is None
    assert torch.equal(seen[0], kept[1])


# ------------------------------------------------------------ front door
def _scenario_spec(api, **fleet):
    return api.ExperimentSpec(
        model="mlp9",
        train=api.TrainConfig(rounds=1, local_steps=1, batch_size=8,
                              lr=1e-2, optimizer="sgd", wire="topk_int8"),
        fleet=api.FleetConfig(n_vehicles=3, scenario="trace_replay",
                              scenario_kwargs={"n_steps": 10},
                              cloud_sync_every=1, per_vehicle_samples=16,
                              test_samples=16, **fleet),
        runtime=api.RuntimeConfig(seed=7, precompile=False))


def test_scenario_spec_cross_loads_and_routes_to_the_port_engine():
    jspec = _scenario_spec(JAPI)
    tspec = TAPI.ExperimentSpec.from_json(jspec.to_json())
    assert tspec.engine_kind == TAPI.SCENARIO
    assert JAPI.ExperimentSpec.from_json(tspec.to_json()) == jspec
    eng = TAPI.build_engine(tspec, device="cpu")
    assert isinstance(eng, TF.ScenarioEngine)
    assert eng.cloud_sync_every == 1 and eng.n_rsus == 2
    assert eng.scenario.seed == 7                 # runtime.seed by default
    ref = JS.make_scenario("trace_replay", 3, seed=7, n_steps=10)
    np.testing.assert_array_equal(eng.scenario.positions, ref.positions)


def test_scenario_spec_refuses_what_is_not_ported():
    base = _scenario_spec(TAPI)
    # not ported: the mesh and multi-process runs
    for runtime in ({"mesh_devices": 2}, {"num_processes": 2}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            dataclasses.replace(base, runtime=dataclasses.replace(
                base.runtime, **runtime))
    # ported: the city lattice and slot paging, the window, the schedules,
    # the slot layouts, the fault and streaming planes
    dataclasses.replace(base, fleet=dataclasses.replace(
        base.fleet, scenario="city"), runtime=dataclasses.replace(
            base.runtime, page_slots=4), train=dataclasses.replace(
                base.train, server_schedule="parallel"))
    dataclasses.replace(base, runtime=dataclasses.replace(
        base.runtime, slot_capacity="tight8", superstep_layout="dense",
        superstep=2), train=dataclasses.replace(
            base.train, server_schedule="parallel"))
    for change in (
            {"train": dataclasses.replace(base.train,
                                          server_schedule="streaming")},
            {"faults": TAPI.FaultsConfig(dropout_rate=0.1)},
            {"stream": TAPI.StreamConfig(churn_rate=0.2)}):
        dataclasses.replace(base, **change)
    with pytest.raises(ValueError, match="asfl"):
        dataclasses.replace(base, train=dataclasses.replace(
            base.train, scheme="sfl"))
    with pytest.raises(ValueError, match="not executable"):
        dataclasses.replace(base, adaptive=TAPI.AdaptiveConfig(
            strategy="latency"))


def test_scenario_run_result_has_the_reference_keys(tmp_path):
    ref = JAPI.run(_scenario_spec(JAPI))
    res = TAPI.run(_scenario_spec(TAPI), device="cpu")
    assert res.engine_kind == ref.engine_kind == TAPI.SCENARIO
    assert set(res.totals) == set(ref.totals)
    assert set(ref.diagnostics) <= set(res.diagnostics)
    assert set(res.diagnostics["occupancy"]) \
        == set(ref.diagnostics["occupancy"])
    assert [f.name for f in dataclasses.fields(TF.ScenarioRoundMetrics)] \
        == [f.name for f in dataclasses.fields(JF.ScenarioRoundMetrics)]
    (m,) = res.history
    assert m.rsu_loads == ref.history[0].rsu_loads
    assert sum(m.rsu_loads) == m.n_scheduled
    assert res.diagnostics["client_batch_steps"] == m.n_scheduled
    back = TAPI.RunResult.load(res.save(str(tmp_path / "run.json")))
    assert isinstance(back.history[0], TF.ScenarioRoundMetrics)
    assert json.loads(json.dumps(back.history[0].cuts)) == m.cuts
