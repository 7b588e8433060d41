"""The single-RSU fault plane on the port's FederationSim (mlp9, 4
vehicles, device="cpu") against repro.core.fedsim.FederationSim: the host
fault draw bit for bit, asfl runs with mid-round dropout, upload loss and
the coverage test (equal fault counters, survivor_frac,
lost_update_bytes, costs to rtol=1e-12, sgd parameters within 1e-5 on
wire="none" and 1e-4 on topk_int8, under both replica schedules), the
wire carrying exactly the smashed bytes the cost model charges for the
steps performed, and the reference's refusals.  The multi-RSU scenario
engine takes every fault field but coverage, as the reference's
(tests/test_torch_faults_scenario.py holds it to the reference)."""
import dataclasses

import numpy as np
import pytest

from _torch_parity import assert_sims_agree, cap_torch_threads, run_both
from repro.core import faults as JFa
from repro_torch import api as TAPI
from repro_torch.core import channel as TCh
from repro_torch.core import cost as TC
from repro_torch.core import faults as TFa
from repro_torch.core import fedsim as TF
from repro_torch.models import mlp_unit as TM

cap_torch_threads()

# the default fault seed; round_interval_s=12 takes vehicle 1 out of
# coverage in round 2
FAULTS = dict(fault_dropout=0.35, fault_upload_loss=0.3, fault_coverage=True,
              round_interval_s=12.0)


def test_sample_faults_host_is_the_reference_draw():
    for seed in (0, 1, 7):
        for rates in ((0.35, 0.3), (0.0, 0.5), (0.9, 0.0)):
            jc = JFa.FaultConfig(dropout_rate=rates[0],
                                 upload_loss_rate=rates[1], seed=seed)
            tc = TFa.FaultConfig(dropout_rate=rates[0],
                                 upload_loss_rate=rates[1], seed=seed)
            assert (jc.stochastic, jc.enabled) == (tc.stochastic, tc.enabled)
            for rnd in range(4):
                for a, b in zip(JFa.sample_faults_host(jc, rnd, 9),
                                TFa.sample_faults_host(tc, rnd, 9)):
                    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert TFa.FAULT_SALT == JFa.FAULT_SALT
    assert TFa.FaultConfig(coverage=True).enabled
    for bad in (dict(dropout_rate=1.0), dict(upload_loss_rate=-0.1),
                dict(staleness_discount=1.5), dict(straggler_factor=-1.0)):
        with pytest.raises(ValueError):
            JFa.FaultConfig(**bad)
        with pytest.raises(ValueError):
            TFa.FaultConfig(**bad)


def _performed(cfg, sim, rnd, participants):
    """Steps each participant ran (the engine's rule, from the draw)."""
    fc = cfg.fault_config()
    drop, dfrac, lost = TFa.sample_faults_host(fc, rnd, len(sim.clients))
    lost = lost & ~drop
    if all(drop[ci] or lost[ci] for ci in participants):
        drop[participants[0]] = False
    steps = [sim._local_steps(sim.clients[ci]) for ci in participants]
    return [int(dfrac[ci] * n) if drop[ci] else n
            for ci, n in zip(participants, steps)]


@pytest.mark.parametrize("wire,mode", [("none", "unroll"), ("none", "vmap"),
                                       ("topk_int8", "vmap")])
def test_asfl_faults_match_jax(wire, mode):
    js, jh, ts, th = run_both("sgd", wire, 1e-2, rounds=3,
                              cohort_parallel=mode, **FAULTS)
    assert_sims_agree(js, jh, ts, th, wire)
    for a, b in zip(jh, th):
        assert (a.n_dropout, a.n_upload_lost, a.survivor_frac,
                a.lost_update_bytes) == (b.n_dropout, b.n_upload_lost,
                                         b.survivor_frac, b.lost_update_bytes)
    assert sum(m.n_dropout for m in th) > 0
    assert sum(m.n_upload_lost for m in th) > 0
    assert min(m.survivor_frac for m in th) < 1.0
    # the coverage test left a vehicle out of round 2
    cfg = ts.cfg
    want = 0.0
    for m in th:
        inr = TCh.in_range_mask(ts.ch, ts.fleet_arr,
                                m.round * cfg.round_interval_s)
        part = [int(i) for i in np.nonzero(inr)[0]] or [0]
        assert len(part) == (3 if m.round == 2 else 4)
        up, down = TC.effective_comm_bytes(
            ts.profile, np.asarray(m.cuts)[part],
            _performed(cfg, ts, m.round, part), cfg.batch_size, wire,
            include_model_transfer=False)
        want += float(np.sum(up + down))
    assert ts.engine.wire_bytes == want
    assert ts.engine.batch_steps < 3 * 4 * 4


def test_reference_refusals():
    clients, test = TM.make_mlp_fleet_data(4, 16, seed=0, n_test=8)

    def sim(**kw):
        return TF.FederationSim(TM.MLPUnitModel(), clients, test,
                                TF.SimConfig(**kw), device="cpu")

    for kw in (dict(fault_straggler=1.0), dict(fault_rsu_outage=0.1)):
        with pytest.raises(ValueError, match="single-RSU engine"):
            sim(**kw)
    for scheme in ("cl", "fl", "sl"):
        with pytest.raises(ValueError, match="does not support it"):
            sim(scheme=scheme, fault_upload_loss=0.2)
        sim(scheme=scheme, fault_coverage=True)   # coverage alone is fine
    with pytest.raises(ValueError, match="legacy spelling of fault_coverage"):
        TF.SimConfig(mobility_dropout=True, fault_coverage=True)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        TF.SimConfig(fault_dropout=1.0)
    assert TF.SimConfig(mobility_dropout=True).fault_config().coverage
    # presence churn is the scenario engine's, as in the reference
    for kw in ({"stream_churn_rate": 0.1},
               {"stream_churn_source": "mobility"}):
        with pytest.raises(ValueError, match="multi-RSU"):
            sim(**kw)
    # the reference's single-RSU engine refuses the streaming schedule
    with pytest.raises(ValueError, match="multi-RSU"):
        sim(server_schedule="streaming")
    with pytest.raises(ValueError, match="sequential chain"):
        TAPI.ExperimentSpec(train=TAPI.TrainConfig(scheme="sl"),
                            runtime=TAPI.RuntimeConfig(mesh_devices=2))
    with pytest.raises(ValueError, match="scenario concepts"):
        TAPI.ExperimentSpec(faults=TAPI.FaultsConfig(rsu_outage_rate=0.1))
    with pytest.raises(ValueError, match="does not support it"):
        TAPI.ExperimentSpec(train=TAPI.TrainConfig(scheme="cl"),
                            faults=TAPI.FaultsConfig(dropout_rate=0.1))


def test_scenario_engine_takes_faults_as_the_reference():
    """The scenario engine takes every fault field of the reference's
    scenario engine, from the spec and from SimConfig, and refuses the
    coverage test with the reference's ValueError."""
    spec = TAPI.ExperimentSpec(
        model="mlp9", train=TAPI.TrainConfig(rounds=1, local_steps=1),
        fleet=TAPI.FleetConfig(n_vehicles=6, scenario="highway_corridor"))
    for faults in (TAPI.FaultsConfig(dropout_rate=0.1),
                   TAPI.FaultsConfig(upload_loss_rate=0.2),
                   TAPI.FaultsConfig(straggler_factor=0.5),
                   TAPI.FaultsConfig(rsu_outage_rate=0.3),
                   TAPI.FaultsConfig(seed=3, staleness_discount=0.25)):
        eng = TAPI.build_engine(dataclasses.replace(spec, faults=faults),
                                device="cpu")
        assert eng.faults == TFa.FaultConfig(**dataclasses.asdict(faults))
        assert eng.fz == eng.faults.stochastic
    with pytest.raises(ValueError, match="scenario itself"):
        dataclasses.replace(spec, faults=TAPI.FaultsConfig(coverage=True))
    eng = TAPI.build_engine(spec, device="cpu")
    test = {"images": np.zeros((1, 48), np.float32),
            "labels": np.zeros(1, np.int64)}
    for field, value in (("fault_dropout", 0.1), ("fault_upload_loss", 0.1),
                         ("fault_straggler", 0.1), ("fault_rsu_outage", 0.1),
                         ("fault_staleness_discount", 0.25),
                         ("fault_seed", 2)):
        cfg = dataclasses.replace(eng.cfg, **{field: value})
        TF.ScenarioEngine(eng.model, eng.clients, test, cfg, eng.scenario,
                          device="cpu")
    for field in ("mobility_dropout", "fault_coverage"):
        cfg = dataclasses.replace(eng.cfg, **{field: True})
        with pytest.raises(ValueError, match="serving_rsu == -1"):
            TF.ScenarioEngine(eng.model, eng.clients, test, cfg,
                              eng.scenario, device="cpu")
