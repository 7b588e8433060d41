"""The super-step window, the slot tables and the layouts of the port's
multi-RSU engine on the CPU (``repro_torch.core.superstep``), beside the
reference's helpers: the cut-prefix bucket, the owned window, the
capacities and ``occupancy_stats()`` equal the reference's; the port's
``ragged`` and ``dense`` layouts and its K = 4 window against K = 1 rounds
agree bit for bit with sgd on the two-cell trace (a handover and a cloud
merge inside the window), on both schedules; the capacity checks raise
before the window is committed; the error-feedback residual restarts on a
cut change; the codec calls of the parallel schedule follow its formula;
what is still not ported raises; and ``repro_torch.api.run`` runs a
parallel scenario spec."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads
from repro import api as JAPI
from repro.core import channel as JCh
from repro.core import fedsim as JF
from repro.core import scenario as JS
from repro.core import superstep as JSS
from repro.models import mlp_unit as JM
from repro_torch import api as TAPI
from repro_torch.core import channel as TCh
from repro_torch.core import fedsim as TF
from repro_torch.core import scenario as TS
from repro_torch.core import superstep as SS
from repro_torch.kernels import wire as W
from repro_torch.models import mlp_unit as TM
from test_torch_scenario import (BATCH, INTERVAL, ROUNDS, STEPS, _Mods,
                                 _two_cell_trace)

cap_torch_threads()


def _cfg(**kw):
    base = dict(scheme="asfl", adaptive_strategy="paper", rounds=ROUNDS,
                local_steps=STEPS, batch_size=BATCH, lr=1e-2,
                optimizer="sgd", round_interval_s=INTERVAL, eval_every=1,
                server_schedule="parallel")
    base.update(kw)
    return TF.SimConfig(**base)


def _engine(sync=2, **kw):
    clients, test = TM.make_mlp_fleet_data(2, 24, seed=0, n_test=64)
    return TF.ScenarioEngine(TM.MLPUnitModel(), clients, test, _cfg(**kw),
                             _two_cell_trace(_Mods(TCh, TS)),
                             cloud_sync_every=sync, device="cpu")


def _state(eng):
    """Everything a run leaves behind, as numpy."""
    leaves = [t.numpy() for u in eng.units for t in u.values()] \
        + [t.numpy() for t in eng.head.values()]
    res = [None if r is None else r.numpy() for r in eng.wire_res]
    return leaves, res, eng.samples.copy(), eng.prev.copy()


def _assert_same(a, b):
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    assert [r is None for r in a[1]] == [r is None for r in b[1]]
    for x, y in zip(a[1], b[1]):
        if x is not None:
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(a[3], b[3])


# ---------------------------------------------------------------- helpers
def test_prefix_bucket_owned_window_and_capacity_equal_reference():
    for c_max in range(0, 20):
        for units in (2, 5, 9, 17):
            assert SS.cut_prefix_bucket(c_max, units) \
                == JSS.cut_prefix_bucket(c_max, units)
    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, 9, size=200))
    for bucket in range(0, 10):
        assert SS.owned_window(ids, bucket) == JSS.owned_window(ids, bucket)
    with pytest.raises(AssertionError, match="contiguous"):
        SS.owned_window(np.array([0, 1, 0]), 1)
    for n in range(0, 70):
        assert SS.round_capacity(n, "pow2") == JF._pow2(max(n, 1))
        assert SS.round_capacity(n, "tight8") == ((max(n, 1) + 7) // 8) * 8
    plane = SS.FlatPlane(*TM.MLPUnitModel().init(torch.Generator()))
    units, head = JM.MLPUnitModel().init(jax.random.PRNGKey(0))
    p = jax.flatten_util.ravel_pytree({"units": units, "head": head})[0]
    assert plane.size == p.size
    bucket = SS.cut_prefix_bucket(8, 9)
    assert SS.owned_window(plane.unit_ids, bucket)[1] \
        == sum(int(np.prod(a.shape)) for u in units[:bucket]
               for a in jax.tree.leaves(u))


def test_slot_tables_lay_out_one_order_under_both_layouts():
    rng = np.random.default_rng(3)
    n, R, U = 40, 4, 9
    serving = rng.integers(-1, R, size=n)
    cuts = np.where(serving >= 0, rng.choice([0, 2, 4, 6, 8], size=n), 0)
    order, seg, counts = SS.slot_sort(serving, cuts, R, U)
    want = [v for r in range(R) for v in sorted(
        np.nonzero((serving == r) & (cuts > 0))[0],
        key=lambda v: (cuts[v], v))]
    assert list(order[:counts.sum()]) == want
    np.testing.assert_array_equal(
        counts, [((serving == r) & (cuts > 0)).sum() for r in range(R)])
    cap = SS.round_capacity(counts.max(), "pow2")
    slots = SS.round_capacity(counts.sum(), "tight8")
    occupied = []
    for layout in ("ragged", "dense"):
        mem, sseg = SS.slot_table_flat(order, seg, counts, layout, cap,
                                       slots)
        assert len(mem) == (slots if layout == "ragged" else R * cap)
        assert set(sseg[sseg >= R]) <= {R}
        occupied.append((mem[sseg < R], sseg[sseg < R]))
        plan = SS.plan_parallel(mem, sseg, cuts, np.full(n, 24), R, U)
        assert plan.n_slots == counts.sum()
        assert [b.cut for b in plan.buckets] == sorted(set(cuts) - {0})
    np.testing.assert_array_equal(occupied[0][0], want)
    np.testing.assert_array_equal(occupied[0][0], occupied[1][0])
    np.testing.assert_array_equal(occupied[0][1], occupied[1][1])
    members, mask = SS.slot_table_seq(order, counts, cap)
    assert [v for r in range(R) for v in members[r][mask[r]]] == want


# --------------------------------------------------- bit for bit, sgd
@pytest.mark.parametrize("wire", ["none", "int8", "topk_int8"])
@pytest.mark.parametrize("schedule", ["sequential", "parallel"])
def test_layouts_and_window_agree_bit_for_bit(schedule, wire):
    """ragged K = 1, dense K = 1, ragged K = 4 and dense K = 4 from one
    seed: the same losses, parameters, residuals, sample counters and
    serving cells, bit for bit; the window holds vehicle 0's handover and
    a cloud merge (after round 1)."""
    runs = []
    for layout, k in (("ragged", 1), ("dense", 1), ("ragged", 4),
                      ("dense", 4), ("ragged", 4)):
        eng = _engine(server_schedule=schedule, wire=wire,
                      superstep_layout=layout, superstep=k,
                      slot_capacity="tight8" if k == 4 else "pow2")
        hist = eng.run()
        runs.append(([m.loss for m in hist], [m.cuts for m in hist],
                     [m.rsu_loads for m in hist], _state(eng)))
    assert sum(1 for c in runs[0][2] if c == [1, 1]) >= 1  # handover
    for other in runs[1:]:
        assert other[0] == runs[0][0]
        assert other[1:3] == runs[0][1:3]
        _assert_same(other[3], runs[0][3])


def test_window_evaluates_at_its_last_synced_round():
    """As the reference: at K = 4 the eval score goes to the window's last
    synced round (the global model then) and the earlier sync reads NaN;
    at K = 1 every sync round is scored, the last with the same value."""
    h1 = _engine(superstep=1).run()
    h4 = _engine(superstep=4).run()
    assert [np.isnan(m.test_acc) for m in h1] == [True, False, True, False]
    assert [np.isnan(m.test_acc) for m in h4] == [True, True, True, False]
    assert h4[3].test_acc == h1[3].test_acc
    calls = []
    eng = _engine(superstep=4)
    eng.run(on_round=lambda m: calls.append(("round", m.round)),
            on_cloud_merge=lambda rnd, e: calls.append(("merge", rnd)))
    assert calls == [("round", 0), ("round", 1), ("merge", 1), ("round", 2),
                     ("round", 3), ("merge", 3)]


# --------------------------------------------------------- occupancy
def _ref_engine(layout, schedule):
    cfg = JF.SimConfig(scheme="asfl", adaptive_strategy="paper",
                       rounds=ROUNDS, local_steps=STEPS, batch_size=BATCH,
                       lr=1e-2, optimizer="sgd", round_interval_s=INTERVAL,
                       eval_every=0, superstep=ROUNDS,
                       server_schedule=schedule, superstep_layout=layout)
    clients, test = JM.make_mlp_fleet_data(2, 24, seed=0, n_test=64)
    return JF.ScenarioEngine(JM.MLPUnitModel(), clients, test, cfg,
                             _two_cell_trace(_Mods(JCh, JS)),
                             cloud_sync_every=2)


@pytest.mark.parametrize("layout", ["ragged", "dense"])
def test_occupancy_stats_equal_reference(layout):
    ref = _ref_engine(layout, "parallel")
    ref.run()
    eng = _engine(superstep_layout=layout, superstep=ROUNDS, eval_every=0)
    eng.run()
    assert eng.occupancy_stats() == ref.occupancy_stats()
    seq = _engine(server_schedule="sequential", superstep_layout=layout)
    seq.run()
    occ = seq.occupancy_stats()
    assert occ["executed_slots"] == seq.n_rsus * occ["slot_capacity"]
    assert occ["owned_plane_frac"] \
        == ref.occupancy_stats()["owned_plane_frac"]


# ------------------------------------------------ overflow before commit
@pytest.mark.parametrize("which", ["per_rsu", "compacted"])
def test_overflow_raises_before_the_window_is_committed(which, monkeypatch):
    """A slot table planned for fewer slots than the fleet occupies raises
    before any round of the window runs: parameters, residuals, counters
    and history stay as they were (round 0 holds two vehicles at RSU 0)."""
    eng = _engine(wire="topk_int8", superstep=2)
    before = _state(eng)
    steps0, bytes0 = eng.batch_steps, eng.wire_bytes
    if which == "per_rsu":
        monkeypatch.setattr(eng, "_capacity", lambda horizon: 1)
        match = "slot capacity 1"
    else:
        monkeypatch.setattr(eng, "_total_slots", lambda horizon: 1)
        match = "compacted capacity 1"
    with pytest.raises(RuntimeError, match=match):
        eng.run()
    _assert_same(_state(eng), before)
    assert (eng.batch_steps, eng.wire_bytes) == (steps0, bytes0)
    assert eng.history == [] and eng._sync_count == 0


# ----------------------------------------------- error-feedback residual
def test_parallel_residual_restarts_on_cut_change(monkeypatch):
    """Round 1 changes vehicle 0's cut (2 -> 4) and keeps vehicle 1's (2):
    vehicle 1's bucket starts from its residual of round 0, vehicle 0's
    from zero."""
    eng = _engine(wire="topk_int8", rounds=2, eval_every=0)
    m0 = eng.run_round(0)
    kept = [r.clone() for r in eng.wire_res]
    seen = {}
    real = SS.ParallelSchedule._page_step

    def spy(self, c, pg, dev, sv, g_srv, cu, x, y, res):
        seen.setdefault(c, (dev["members"].tolist(), res))
        return real(self, c, pg, dev, sv, g_srv, cu, x, y, res)

    monkeypatch.setattr(SS.ParallelSchedule, "_page_step", spy)
    m1 = eng.run_round(1)
    assert m0.cuts == [2, 2] and m1.cuts == [4, 2]
    assert seen[2][0] == [1] and torch.equal(seen[2][1][0], kept[1])
    assert seen[4][0] == [0] and seen[4][1] is None
    assert eng.wire_res[0].shape == kept[0].shape
    np.testing.assert_array_equal(eng.wire_cut, [4, 2])


# ----------------------------------------------------- codec formula
@pytest.mark.parametrize("wire", ["int8", "topk_int8"])
def test_parallel_codec_calls_follow_the_formula(wire, monkeypatch):
    """Per (cut bucket, local step): int8 quantizes and dequantizes twice;
    topk_int8 packs twice and unpacks twice, and mlp9 reads the buffer
    through one fused matmul per RSU in the bucket.  The urban grid has
    several RSUs and cuts in a round."""
    calls = dict.fromkeys(("sparsify_quant_pack", "unpack_dequant",
                           "unpack_dequant_matmul"), 0)
    for name in calls:
        real = getattr(W, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(W, name, counted)
    from repro_torch.kernels import quant as Q
    qcalls = {"quantize_int8": 0, "dequantize_int8": 0}
    for name in qcalls:
        real = getattr(Q, name)

        def qcounted(*a, _real=real, _name=name, **k):
            qcalls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(Q, name, qcounted)
    clients, test = TM.make_mlp_fleet_data(8, 24, seed=0, n_test=16)
    eng = TF.ScenarioEngine(
        TM.MLPUnitModel(), clients, test,
        _cfg(wire=wire, rounds=2, eval_every=0, superstep=2,
             adaptive_strategy="residence"),
        TS.make_scenario("urban_grid", 8, seed=0), device="cpu")
    hist = eng.run()
    b, rb = eng.bucket_steps, eng.rsu_bucket_steps
    assert rb > b > 0 and eng.batch_steps == sum(
        m.n_scheduled for m in hist) * STEPS
    if wire == "int8":
        assert qcalls == {"quantize_int8": 2 * b, "dequantize_int8": 2 * b}
        assert set(calls.values()) == {0}
    else:
        assert calls == {"sparsify_quant_pack": 2 * b,
                         "unpack_dequant": 2 * b,
                         "unpack_dequant_matmul": rb}
        assert set(qcalls.values()) == {0}


# --------------------------------------------------------- refusals
def test_schedules_and_planes_refused_as_the_reference():
    clients, test = TM.make_mlp_fleet_data(2, 24, seed=0, n_test=16)
    sc = _two_cell_trace(_Mods(TCh, TS))
    # the scenario engine runs the streaming schedule and the planes
    eng = TF.ScenarioEngine(TM.MLPUnitModel(), clients, test,
                            _cfg(server_schedule="streaming"), sc,
                            device="cpu")
    assert eng.sz and eng.parallel and eng.mode == "streaming"
    jclients, jtest = JM.make_mlp_fleet_data(4, 16, seed=0, n_test=16)
    tclients, ttest = TM.make_mlp_fleet_data(4, 16, seed=0, n_test=16)
    for kw in ({"server_schedule": "streaming"},):
        with pytest.raises(ValueError, match="ScenarioEngine"):
            JF.FederationSim(JM.MLPUnitModel(), jclients, jtest,
                             JF.SimConfig(**kw))
        with pytest.raises(ValueError, match="ScenarioEngine"):
            TF.FederationSim(TM.MLPUnitModel(), tclients, ttest,
                             TF.SimConfig(**kw), device="cpu")
    for kw in ({"mesh_devices": 2},
               {"fleet_axis": "rsu"}, {"compilation_cache_dir": "x"}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            TF.SimConfig(**kw)
    for kw in ({"stream_buffer_size": 8}, {"stream_churn_rate": 0.1},
               {"fault_dropout": 0.1}):
        TF.ScenarioEngine(TM.MLPUnitModel(), clients, test, _cfg(**kw), sc,
                          device="cpu")
    # the front door, as the reference's: parallel and superstep > 1 need
    # a multi-RSU scenario, and so does streaming
    for mod in (JAPI, TAPI):
        with pytest.raises(ValueError, match="not executable"):
            mod.ExperimentSpec(train=mod.TrainConfig(
                server_schedule="parallel"))
        with pytest.raises(ValueError, match="not executable"):
            mod.ExperimentSpec(train=mod.TrainConfig(
                server_schedule="streaming"))
        with pytest.raises(ValueError, match="superstep"):
            mod.ExperimentSpec(runtime=mod.RuntimeConfig(superstep=2))
    base = _spec(TAPI)
    spec = dataclasses.replace(base, train=dataclasses.replace(
        base.train, server_schedule="streaming"))
    assert TAPI.build_engine(spec, device="cpu").sz


def test_federation_sim_runs_its_round_whatever_the_schedule():
    """The single-RSU engine, as the reference's, takes server_schedule
    'parallel' and superstep > 1 and runs its synchronous round as
    always: the same history and parameters bit for bit."""
    jclients, jtest = JM.make_mlp_fleet_data(4, 16, seed=0, n_test=16)
    JF.FederationSim(JM.MLPUnitModel(), jclients, jtest, JF.SimConfig(
        server_schedule="parallel", superstep=3))
    out = []
    for kw in ({}, {"server_schedule": "parallel", "superstep": 3,
                    "superstep_layout": "dense", "slot_capacity": "tight8"}):
        clients, test = TM.make_mlp_fleet_data(4, 16, seed=0, n_test=16)
        sim = TF.FederationSim(TM.MLPUnitModel(), clients, test,
                               TF.SimConfig(rounds=2, batch_size=8,
                                            local_steps=1, lr=1e-2,
                                            optimizer="sgd", **kw),
                               device="cpu")
        hist = sim.run()
        out.append(([m.loss for m in hist],
                    [t.numpy() for u in sim.units for t in u.values()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------- front door
def _spec(api, **train):
    return api.ExperimentSpec(
        model="mlp9",
        train=api.TrainConfig(rounds=2, local_steps=1, batch_size=8,
                              lr=1e-2, optimizer="sgd", wire="topk_int8",
                              server_schedule="parallel", **train),
        fleet=api.FleetConfig(n_vehicles=6, scenario="highway_corridor",
                              cloud_sync_every=2, per_vehicle_samples=16,
                              test_samples=16),
        runtime=api.RuntimeConfig(seed=7, superstep=2,
                                  superstep_layout="dense",
                                  slot_capacity="tight8", precompile=False))


def test_api_runs_a_parallel_scenario_spec():
    jspec = _spec(JAPI)
    tspec = TAPI.ExperimentSpec.from_json(jspec.to_json())
    assert JAPI.ExperimentSpec.from_json(tspec.to_json()) == jspec
    ref = JAPI.run(jspec)
    res = TAPI.run(tspec, device="cpu")
    eng = TAPI.build_engine(tspec, device="cpu")
    assert eng.parallel and eng.cfg.superstep == 2
    assert eng.layout == "dense" and eng.cfg.slot_capacity == "tight8"
    assert res.diagnostics["mode"] == "parallel"
    assert set(ref.diagnostics) <= set(res.diagnostics)
    assert res.diagnostics["occupancy"]["layout"] == "dense"
    assert set(res.diagnostics["occupancy"]) \
        == set(ref.diagnostics["occupancy"])
    assert set(res.totals) == set(ref.totals)
    assert len(res.history) == len(ref.history) == 2
    for m, r in zip(res.history, ref.history):
        assert np.isfinite(m.loss)
        assert m.rsu_loads == r.rsu_loads      # coverage is geometry
        assert sum(m.rsu_loads) == m.n_scheduled
    assert res.diagnostics["client_batch_steps"] \
        == sum(m.n_scheduled for m in res.history)
    assert np.isnan(res.history[0].test_acc)
    assert 0.0 <= res.history[1].test_acc <= 1.0
