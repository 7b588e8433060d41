"""The fault plane on the port's multi-RSU ScenarioEngine (device="cpu")
against repro.core.fedsim.ScenarioEngine: mid-round dropout, upload loss,
deadline stragglers with the staleness bank, and RSU outages, on the
sequential and parallel server schedules and both slot layouts.

The reference draws its faults with threefry inside its program; the port
is fed the same draws (``repro.core.faults.sample_faults_traced``, before
``ensure_rsu_up``) through its ``fault_draws`` seam, and its own logic does
everything after the draw (tests/_torch_planes.py; the cells of
tests/test_torch_parallel.py: urban_grid or the two-cell trace, mlp9,
paper cuts, local steps 2, batch 8, 4 rounds, cloud sync every 2, sgd lr
1e-2).  Round by round from the reference's state: cuts, loads, fault
masks (through every telemetry count), survivor_frac, lost_update_bytes
and comm_bytes equal; loss, parameters, bank numerator and residuals
within 1e-5; the bank weights equal; stale_merged, sim_time_s and
energy_j within 1e-6 relative.  ``FAULTS`` at urban_grid's scale gives
every kind of failure, and a straggler factor of 5e-4 of the residence
time makes some vehicles miss their deadline (measured: the analytic
latency of mlp9 is 1e-4 to 2e-3 of the residence there), so the bank
fills and merges.

The unit parity of the plan's helpers, the survivor merges and the
float32 latency matrix is exact where the reference is exact.  In the
port alone: K = 4 windows equal K = 1 bit for bit under faults, zero rates
train bit for bit whatever ``fault_seed`` says, and the parallel
schedule's codec launches follow its formula under dropouts (per (cut
bucket, local step) with an active slot, per (cut bucket, RSU, local step)
with one)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads
from _torch_planes import build, rounds_match, same_bits
from repro.core import adaptive as JA
from repro.core import aggregation as JAg
from repro.core import channel as JCh
from repro.core import cost as JC
from repro.core import faults as JFa
from repro_torch import api as TAPI
from repro_torch.core import adaptive as TA
from repro_torch.core import aggregation as TAg
from repro_torch.core import cost as TC
from repro_torch.core import faults as TFa
from repro_torch.core import fedsim as TF
from repro_torch.models import mlp_unit as TM

cap_torch_threads()

FAULTS = dict(fault_dropout=0.3, fault_upload_loss=0.2, fault_rsu_outage=0.3,
              fault_straggler=5e-4)


# ------------------------------------------------------------ unit parity
def test_plan_helpers_equal_reference():
    rng = np.random.default_rng(0)
    for steps in (1, 2, 3, 5):
        drop = rng.random(64) < 0.5
        frac = rng.random(64).astype(np.float32)
        frac[:4] = [0.0, 0.99999994, 0.5, 1 / 3]
        np.testing.assert_array_equal(
            TFa.drop_steps(drop, frac, steps),
            np.asarray(JFa.drop_steps(jnp.asarray(drop), jnp.asarray(frac),
                                      steps)))
    for down in ([True, True, True], [False, True, True], [True, False],
                 [False, False], [True]):
        np.testing.assert_array_equal(
            TFa.ensure_rsu_up(np.array(down)),
            np.asarray(JFa.ensure_rsu_up(jnp.asarray(down))))
    for sched, failed in (([1, 1, 0, 1], [1, 1, 0, 1]),
                          ([0, 1, 1, 0], [0, 1, 1, 1]),
                          ([0, 1, 1, 0], [0, 1, 0, 0]),
                          ([0, 0, 0, 0], [1, 1, 1, 1])):
        s, f = np.array(sched, bool), np.array(failed, bool)
        np.testing.assert_array_equal(
            TFa.rescue_mask(s, f),
            np.asarray(JFa.rescue_mask(jnp.asarray(s), jnp.asarray(f))))
    # the host draw: the single-RSU engine's draw first, then the outages
    fc = TFa.FaultConfig(dropout_rate=0.3, upload_loss_rate=0.2,
                         rsu_outage_rate=0.4, seed=5)
    drop, frac, lost, down = TFa.sample_scenario_faults_host(fc, 3, 16, 4)
    for a, b in zip(TFa.sample_faults_host(fc, 3, 16), (drop, frac, lost)):
        np.testing.assert_array_equal(np.asarray(a, b.dtype), b)
    assert down.shape == (4,) and down.dtype == bool
    assert frac.dtype == np.float32


def test_survivor_merges_equal_reference():
    rng = np.random.default_rng(1)
    stack = {"w": rng.normal(size=(5, 4, 3)).astype(np.float32),
             "b": rng.normal(size=(5, 3)).astype(np.float32)}
    tstack = {k: torch.from_numpy(v) for k, v in stack.items()}
    fb = {"w": np.ones((4, 3), np.float32), "b": np.zeros(3, np.float32)}
    tfb = {k: torch.from_numpy(v) for k, v in fb.items()}
    w = np.array([3.0, 1.0, 0.0, 2.0, 5.0], np.float32)
    disc = np.array([1.0, 0.5, 0.25, 0.7071068, 1.0], np.float32)
    for surv in ([1, 0, 1, 1, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1],
                 [0, 1, 0, 0, 0]):
        s = np.array(surv, bool)
        got = TAg.survivor_weighted_sum(tstack, w, s)
        want = JAg.survivor_weighted_sum(stack, w, s)
        for k in stack:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
        for got, want in (
                (TAg.survivor_fedavg(tstack, w, s, tfb),
                 JAg.survivor_fedavg(stack, w, s, fb)),
                (TAg.discounted_survivor_fedavg(tstack, w, s, disc, tfb),
                 JAg.discounted_survivor_fedavg(stack, w, s, disc, fb)),
                # weights in (0, 1) renormalise (a where, not a max)
                (TAg.survivor_fedavg(tstack, w * 0.1, s, tfb),
                 JAg.survivor_fedavg(stack, w * 0.1, s, fb))):
            for k in stack:
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]),
                                           rtol=1e-6, atol=1e-7)
        # a constant kernel is survivor_fedavg bit for bit
        a = TAg.discounted_survivor_fedavg(tstack, w, s, np.ones(5), tfb)
        b = TAg.survivor_fedavg(tstack, w, s, tfb)
        for k in stack:
            assert torch.equal(a[k], b[k])
    assert TAg.survivor_fedavg(tstack, w, np.zeros(5, bool), tfb) is tfb


def test_latency_matrix_equals_reference_bit_for_bit():
    """The straggler test's deadline rule flips exactly where the
    reference's does: the float32 latency matrix is its traced one bit for
    bit, rates down to 1 bit/s included."""
    fa = JCh.fleet_arrays(JCh.make_fleet(64, seed=4))
    rates = np.random.default_rng(2).uniform(1.0, 3e8, 64).astype(
        np.float32)
    rates[:3] = [1.0, 8.0, 3e8]
    for jp, tp in ((JC.resnet_profile(), TC.resnet_profile()),
                   (TM.MLPUnitModel().profile(),
                    TM.MLPUnitModel().profile())):
        for nb, batch, ep in ((2, 8, 1), (4, 16, 5)):
            cand = range(1, tp.n_units)
            want = np.asarray(JA.latency_matrix_traced(
                jp, rates, fa["compute_flops"], 2e12, nb, batch, ep, cand))
            got = TA.latency_matrix(tp, rates, fa["compute_flops"], 2e12,
                                    nb, batch, ep, cand)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


# ----------------------------------------------------- engine parity
ENGINE = [("urban", "sequential", "topk_int8", "ragged", {}),
          ("trace", "sequential", "none", "ragged",
           {"stream_churn_rate": 0.3}),
          ("urban", "parallel", "none", "ragged",
           {"stream_churn_rate": 0.3}),
          ("urban", "parallel", "topk_int8", "dense", {}),
          ("trace", "parallel", "topk_int8", "ragged", {}),
          ("trace", "parallel", "none", "dense", {})]


@pytest.mark.parametrize(
    "scenario,schedule,wire,layout,extra", ENGINE,
    ids=["-".join(c[:4]) + ("-churn" if c[4] else "") for c in ENGINE])
def test_faulted_rounds_match_reference(scenario, schedule, wire, layout,
                                        extra):
    je, te = build(scenario, wire=wire, schedule=schedule, layout=layout,
                   **FAULTS, **extra)
    assert te.fz and not te.sz
    hist = rounds_match(je, te)
    if scenario == "urban":   # the kinds of failure, and the bank merged
        kinds = ("n_dropout", "n_straggler", "n_rsu_down") \
            + (() if extra else ("n_upload_lost",))
        for field in kinds:
            assert sum(getattr(m, field) for m in hist) > 0, field
        assert sum(m.stale_merged for m in hist) > 0
        assert min(m.survivor_frac for m in hist) < 1.0
    for m in hist:
        failed = m.n_dropout + m.n_upload_lost + m.n_straggler
        assert m.n_scheduled == sum(m.rsu_loads)
        assert round(m.survivor_frac * m.n_scheduled) \
            == m.n_scheduled - failed


@pytest.mark.parametrize("schedule", ["sequential", "parallel"])
def test_fault_window_equals_rounds_bit_for_bit(schedule):
    """K = 4: one window of the whole run trains the same bits as four
    windows of one round (a cloud merge and bank merges inside it)."""
    runs = []
    for k in (1, 4):
        cfg = TF.SimConfig(rounds=4, local_steps=2, batch_size=8, lr=1e-2,
                           optimizer="sgd", wire="topk_int8", eval_every=0,
                           superstep=k, server_schedule=schedule, **FAULTS)
        eng = _urban_engine(cfg)
        runs.append((eng, eng.run()))
    (e1, h1), (e4, h4) = runs
    assert [m.loss for m in h1] == [m.loss for m in h4]
    assert [m.n_straggler for m in h1] == [m.n_straggler for m in h4]
    assert sum(m.stale_merged for m in h4) > 0
    same_bits(e1, e4)


def _urban_engine(cfg, n=8):
    from repro_torch.core import scenario as TS
    clients, test = TM.make_mlp_fleet_data(n, 24, seed=0, n_test=16)
    return TF.ScenarioEngine(TM.MLPUnitModel(), clients, test, cfg,
                             TS.make_scenario("urban_grid", n, seed=0),
                             cloud_sync_every=2, device="cpu")


@pytest.mark.parametrize("schedule", ["sequential", "parallel"])
def test_zero_rates_train_bit_for_bit_whatever_the_seed(schedule):
    """With every rate 0 the fault plane does not run: a fault seed and a
    discount change no bit, and the engine holds no bank."""
    runs = []
    for kw in ({}, {"fault_seed": 7, "fault_staleness_discount": 0.25}):
        cfg = TF.SimConfig(rounds=3, local_steps=2, batch_size=8, lr=1e-2,
                           optimizer="sgd", wire="topk_int8", eval_every=0,
                           server_schedule=schedule, **kw)
        eng = _urban_engine(cfg)
        runs.append((eng, eng.run()))
    (e0, h0), (e7, h7) = runs
    assert not e7.fz and not hasattr(e7, "stale_num")
    assert [repr(dataclasses.astuple(m)) for m in h0] \
        == [repr(dataclasses.astuple(m)) for m in h7]       # NaN test_acc
    same_bits(e0, e7)


def test_codec_launches_follow_the_formula_under_dropouts(monkeypatch):
    """Parallel schedule, topk_int8: 2 packs and 2 unpacks per (cut
    bucket, local step) with an active slot, one fused matmul per (cut
    bucket, RSU, local step) with one; the formula's units counted from
    the plans here, independently of the engine's own counters, against
    the wrappers' calls (on the CPU a wrapper runs its plain version)."""
    from repro_torch.kernels import wire as W
    calls = dict.fromkeys(("sparsify_quant_pack", "unpack_dequant",
                           "unpack_dequant_matmul"), 0)
    for name in calls:
        def counted(*a, _real=getattr(W, name), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(W, name, counted)
    cfg = TF.SimConfig(rounds=3, local_steps=3, batch_size=8, lr=1e-2,
                       optimizer="sgd", wire="topk_int8", eval_every=0,
                       server_schedule="parallel", fault_dropout=0.5,
                       fault_rsu_outage=0.2, fault_seed=3)
    eng = _urban_engine(cfg)
    plans = []
    real = eng._plan

    def spy(*args):
        plans.append(real(*args))
        return plans[-1]

    monkeypatch.setattr(eng, "_plan", spy)
    hist = eng.run()
    buckets = runs = 0
    for p in plans:
        for s in range(cfg.local_steps):
            act = (p["cuts"] > 0) & (p["dstep"] > s)
            buckets += len(np.unique(p["cuts"][act]))
            runs += len({(c, r) for c, r in zip(p["cuts"][act],
                                                p["serving"][act])})
    assert sum(m.n_dropout for m in hist) > 0
    assert buckets < sum(len(np.unique(p["cuts"][p["cuts"] > 0]))
                         for p in plans) * cfg.local_steps
    assert (eng.bucket_steps, eng.rsu_bucket_steps) == (buckets, runs)
    assert calls == {"sparsify_quant_pack": 2 * buckets,
                     "unpack_dequant": 2 * buckets,
                     "unpack_dequant_matmul": runs}
    assert eng.batch_steps == sum(
        int(p["dstep"][p["cuts"] > 0].sum()) for p in plans)


def test_api_runs_scenario_faults():
    """The front door: a highway spec with every fault field set runs on
    the CPU (the device is ``cuda`` unless asked), the fault telemetry adds
    up, and the coverage test stays the reference's ValueError."""
    spec = TAPI.ExperimentSpec(
        model="mlp9",
        train=TAPI.TrainConfig(rounds=3, local_steps=2, batch_size=8,
                               lr=1e-2, optimizer="sgd", wire="topk_int8",
                               server_schedule="parallel"),
        fleet=TAPI.FleetConfig(n_vehicles=12, scenario="highway_corridor",
                               cloud_sync_every=2, per_vehicle_samples=16,
                               test_samples=16),
        faults=TAPI.FaultsConfig(dropout_rate=0.2, upload_loss_rate=0.2,
                                 straggler_factor=0.05, rsu_outage_rate=0.3,
                                 staleness_discount=0.25, seed=1),
        runtime=TAPI.RuntimeConfig(seed=7, precompile=False))
    eng = TAPI.build_engine(spec, device="cpu")
    assert eng.fz and eng.faults.staleness_discount == 0.25
    res = TAPI.run(spec, device="cpu")
    for m in res.history:
        assert np.isfinite(m.loss)
        assert m.n_dropout + m.n_upload_lost + m.n_straggler \
            + round(m.survivor_frac * m.n_scheduled) == m.n_scheduled
        assert sum(m.rsu_loads) == m.n_scheduled
    assert res.totals["n_straggler"] == sum(m.n_straggler
                                            for m in res.history)
    assert "staleness_hist" in res.diagnostics
    with pytest.raises(ValueError, match="scenario itself"):
        dataclasses.replace(spec, faults=TAPI.FaultsConfig(coverage=True))
