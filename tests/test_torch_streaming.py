"""The streaming plane on the port's multi-RSU ScenarioEngine (device="cpu")
against repro.core.fedsim.ScenarioEngine: presence churn from the seeded
toggle chain (``markov``) and from coverage (``mobility``) on the
synchronous schedules, and the ``streaming`` server schedule with its
per-RSU StreamBuffer under the ``constant`` and ``poly`` staleness
kernels.

The reference draws its presence toggles (and faults) with threefry inside
its program; the port is fed the same draws through its
``presence_toggles`` / ``fault_draws`` seams (tests/_torch_planes.py).
Round by round from the reference's state (models, residuals, presence
plane, StreamBuffer): cuts, loads, presence and arrival counts, merges,
buffer occupancy, absorbed samples and comm_bytes equal; the buffer's
weights, ages and fill equal; loss, parameters and the buffered deltas
within 1e-5.

The ``topk_int8`` streaming case runs on urban_grid.  On the two-cell
trace with the mobility source, ``topk_int8`` drifts past 1e-5 in round 3
(8.7e-5 on a residual, measured) while ``none`` and ``int8`` agree: float32
sums in another order move one top-k pick or int8 step of the wire, the
drift tests/test_torch_parallel.py describes; the trace's mobility cases
run on ``none``.

In the port alone: the buffer of one slot tracks the parallel schedule
(the reference's ``test_buffer_size_one_tracks_parallel_schedule``), a
K = 4 window equals K = 1 bit for bit with churn, faults and the buffer
on, and zero churn trains bit for bit whatever ``stream_seed`` says."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads
from _torch_planes import build, params, rounds_match, same_bits
from repro.core import scenario as JS
from repro.core import streaming as JSt
from repro_torch.core import fedsim as TF
from repro_torch.core import scenario as TS
from repro_torch.core import streaming as TSt
from repro_torch.models import mlp_unit as TM

cap_torch_threads()

CHAOS = dict(fault_dropout=0.3, fault_rsu_outage=0.2, fault_straggler=5e-4)


# ------------------------------------------------------------ unit parity
def test_stream_config_and_host_toggles_equal_reference():
    assert (TSt.STREAM_SALT, TSt.STALENESS_KERNELS, TSt.CHURN_SOURCES) \
        == (JSt.STREAM_SALT, JSt.STALENESS_KERNELS, JSt.CHURN_SOURCES)
    for kw in (dict(), dict(churn_rate=0.3), dict(churn_source="mobility"),
               dict(buffer_size=1, kernel="poly", alpha=0.0)):
        assert TSt.StreamConfig(**kw).churning \
            == JSt.StreamConfig(**kw).churning
    for bad, match in ((dict(kernel="exp"), "kernel"),
                       (dict(churn_source="gps"), "churn_source"),
                       (dict(churn_rate=1.0), r"\[0, 1\)"),
                       (dict(churn_source="mobility", churn_rate=0.2),
                        "churn_rate must stay 0"),
                       (dict(buffer_size=0), "buffer_size"),
                       (dict(alpha=-1.0), "alpha")):
        for mod in (JSt, TSt):
            with pytest.raises(ValueError, match=match):
                mod.StreamConfig(**bad)
    for seed in (0, 7):
        for rate in (0.2, 0.9):
            jc = JSt.StreamConfig(churn_rate=rate, seed=seed)
            tc = TSt.StreamConfig(churn_rate=rate, seed=seed)
            for rnd in range(3):
                np.testing.assert_array_equal(
                    TSt.sample_toggles_host(tc, rnd, 33),
                    JSt.sample_toggles_host(jc, rnd, 33))


def test_staleness_kernel_and_presence_gate_equal_reference():
    ages = np.array([0, 1, 2, 3, 7, 100], np.int32)
    for kind, alpha in (("constant", 0.5), ("poly", 0.5), ("poly", 0.0),
                        ("poly", 2.0)):
        got = TSt.staleness_kernel(kind, alpha, ages)
        want = np.asarray(JSt.staleness_kernel(kind, alpha, ages))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (TSt.staleness_kernel("constant", 0.5, ages) == 1.0).all()
    with pytest.raises(ValueError):
        TSt.staleness_kernel("exp", 0.5, ages)
    rng = np.random.default_rng(0)
    serving = rng.integers(-1, 4, 32).astype(np.int32)
    rates = rng.uniform(0, 3e8, 32).astype(np.float32)
    res = rng.uniform(0, 60, 32).astype(np.float32)
    admit = rng.random(32) < 0.6
    for a, b in zip(TSt.gate_presence(serving, rates, res, admit),
                    JSt.gate_presence(serving, rates, res, admit)):
        b = np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jst = JS.make_scenario("urban_grid", 32, seed=1).fleet_state(10.0, 3)
    tst = TS.make_scenario("urban_grid", 32, seed=1).fleet_state(10.0, 3)
    ja, ta = JS.apply_presence(jst, admit), TS.apply_presence(tst, admit)
    for f in ("serving_rsu", "rates_bps", "residence_s", "positions"):
        a, b = getattr(ta, f), np.asarray(getattr(ja, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------- engine parity
ENGINE = [
    ("urban", "streaming", "topk_int8", "ragged",
     dict(stream_churn_rate=0.2, stream_buffer_size=2)),
    ("urban", "streaming", "none", "dense",
     dict(stream_churn_rate=0.2, stream_buffer_size=2, stream_kernel="poly",
          stream_alpha=0.5, **CHAOS)),
    ("urban", "sequential", "none", "ragged", dict(stream_churn_rate=0.3)),
    ("gap", "sequential", "none", "ragged",
     dict(stream_churn_source="mobility")),
    ("gap", "parallel", "none", "dense",
     dict(stream_churn_source="mobility")),
    ("gap", "streaming", "none", "ragged",
     dict(stream_churn_source="mobility", stream_buffer_size=2,
          stream_kernel="poly"))]


@pytest.mark.parametrize(
    "scenario,schedule,wire,layout,extra", ENGINE,
    ids=["-".join(c[:4]) + "-" + c[4].get("stream_churn_source", "markov")
         for c in ENGINE])
def test_streaming_rounds_match_reference(scenario, schedule, wire, layout,
                                          extra):
    je, te = build(scenario, wire=wire, schedule=schedule, layout=layout,
                   **extra)
    assert te.cz and te.sz == (schedule == "streaming")
    hist = rounds_match(je, te)
    if scenario == "gap":
        # vehicle 0 leaves coverage in round 1; a synchronous schedule
        # admits its return a round late, streaming at once
        late = schedule != "streaming"
        assert [m.n_scheduled for m in hist] \
            == ([2, 1, 1, 2] if late else [2, 1, 2, 2])
        assert [m.n_arrived for m in hist] == [0, 0, 1, 0]
        assert [m.n_present for m in hist] == [2, 1, 2, 2]
    else:
        assert min(m.n_present for m in hist) < 8       # departures
        if schedule == "sequential":                    # deferred arrivals
            assert sum(m.n_arrived for m in hist) > 0
            assert all(m.n_scheduled <= m.n_present - m.n_arrived
                       for m in hist)
    if schedule == "streaming":
        assert sum(m.stream_merges for m in hist) > 0
        for m in hist:      # absorption happens only when a buffer fires
            assert (m.absorbed_samples > 0) == (m.stream_merges > 0)
            assert 0 <= m.buffer_occupancy < te.n_rsus * 2
        if extra.get("stream_kernel") == "poly" and scenario == "urban":
            assert sum(m.stream_stale for m in hist) > 0
    else:
        assert sum(m.stream_merges for m in hist) == 0


def _urban(cfg, n=8):
    clients, test = TM.make_mlp_fleet_data(n, 24, seed=0, n_test=16)
    return TF.ScenarioEngine(TM.MLPUnitModel(), clients, test, cfg,
                             TS.make_scenario("urban_grid", n, seed=0),
                             cloud_sync_every=2, device="cpu")


def _cfg(**kw):
    base = dict(rounds=4, local_steps=2, batch_size=8, lr=1e-2,
                optimizer="sgd", wire="topk_int8", eval_every=0)
    base.update(kw)
    return TF.SimConfig(**base)


def test_buffer_of_one_tracks_the_parallel_schedule():
    """B = 1 with the constant kernel: every push fires at once, so the
    run tracks the parallel schedule up to the (w d) / w rounding."""
    es = _urban(_cfg(server_schedule="streaming", stream_buffer_size=1,
                     superstep=4))
    ep = _urban(_cfg(server_schedule="parallel", superstep=4))
    hs, hp = es.run(), ep.run()
    for a, b in zip(params(es), params(ep)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose([m.loss for m in hs], [m.loss for m in hp],
                               rtol=1e-5)
    assert all(m.stream_stale == 0.0 for m in hs)
    assert all(m.stream_merges == sum(c > 0 for c in m.rsu_loads)
               for m in hs)


def test_stream_window_equals_rounds_bit_for_bit():
    """K = 4 with churn, faults and the buffer on: one window trains the
    same bits as four windows of one round."""
    runs = []
    for k in (1, 4):
        eng = _urban(_cfg(server_schedule="streaming", superstep=k,
                          stream_churn_rate=0.2, stream_buffer_size=2,
                          stream_kernel="poly", **CHAOS))
        runs.append((eng, eng.run()))
    (e1, h1), (e4, h4) = runs
    assert [m.loss for m in h1] == [m.loss for m in h4]
    assert [m.stream_merges for m in h1] == [m.stream_merges for m in h4]
    assert sum(m.stream_merges for m in h4) > 0
    same_bits(e1, e4)


@pytest.mark.parametrize("schedule", ["sequential", "parallel"])
def test_zero_churn_trains_bit_for_bit_whatever_the_seed(schedule):
    """With churn 0 on a synchronous schedule the streaming plane does not
    run: a stream seed, a kernel and a buffer size change no bit."""
    runs = []
    for kw in ({}, {"stream_seed": 7, "stream_kernel": "poly",
                    "stream_buffer_size": 2}):
        eng = _urban(_cfg(rounds=3, server_schedule=schedule, **kw))
        runs.append((eng, eng.run()))
    (e0, h0), (e7, h7) = runs
    assert not (e7.cz or e7.sz) and not hasattr(e7, "present")
    assert [repr(dataclasses.astuple(m)) for m in h0] \
        == [repr(dataclasses.astuple(m)) for m in h7]       # NaN test_acc
    same_bits(e0, e7)


def test_stream_merge_callback_and_api_totals():
    """``api.run`` of a highway spec on the streaming schedule with churn
    from both sources: the merge callback fires on the rounds that merged,
    and the totals add the streaming telemetry up."""
    from repro_torch import api as TAPI
    for stream in (TAPI.StreamConfig(churn_rate=0.2, buffer_size=2,
                                     kernel="poly"),
                   TAPI.StreamConfig(churn_source="mobility",
                                     buffer_size=2)):
        spec = TAPI.ExperimentSpec(
            model="mlp9",
            train=TAPI.TrainConfig(rounds=4, local_steps=1, batch_size=8,
                                   lr=1e-2, optimizer="sgd",
                                   server_schedule="streaming"),
            fleet=TAPI.FleetConfig(n_vehicles=12,
                                   scenario="highway_corridor",
                                   cloud_sync_every=2,
                                   per_vehicle_samples=16, test_samples=16),
            stream=stream, runtime=TAPI.RuntimeConfig(seed=7, superstep=2))
        merged = []
        res = TAPI.run(spec, device="cpu",
                       on_stream_merge=lambda m, e: merged.append(m.round))
        assert res.diagnostics["mode"] == "streaming"
        assert merged == [m.round for m in res.history if m.stream_merges]
        assert merged and res.totals["stream_merges"] == sum(
            m.stream_merges for m in res.history)
        assert res.totals["n_arrived"] == sum(m.n_arrived
                                              for m in res.history)
        assert "staleness_hist" in res.diagnostics
        assert all(np.isfinite(m.loss) for m in res.history)
    with pytest.raises(ValueError, match="multi-RSU"):
        TAPI.ExperimentSpec(stream=TAPI.StreamConfig(churn_rate=0.2))


def test_engine_state_holds_the_planes_it_runs():
    eng = _urban(_cfg(rounds=1, server_schedule="streaming",
                      stream_buffer_size=3, fault_upload_loss=0.1))
    R, P = eng.n_rsus, eng.plane.size
    assert eng.sbuf.shape == (R, 3, P) and eng.sbuf.dtype == torch.float32
    assert eng.stale_num.shape == (R, P) and eng.stale_den.shape == (R, 10)
    assert not hasattr(eng, "present")
    eng.run()
    assert eng.sbuf_cnt.sum() == (eng.sbuf_w > 0).sum() > 0
