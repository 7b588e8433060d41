"""Slot paging (``page_slots``) of the port's parallel and streaming
schedules on the CPU.

With ``page_slots`` P > 0 on the ``ragged`` layout each local step walks
every cut bucket's (active) slots in windows of P: per page the vehicle
forward and its vjp, the two codec trips, the server vjp and the replica
gradients run for P slots, and each RSU's weighted share goes into the
step's server gradient page by page (``superstep.Page``).  A run of one
RSU that crosses a page is summed in two parts, so paged and unpaged
agree to float32 reassociation, not bit for bit.

* The paged engine against the reference's paged engine on the
  64-vehicle 2 x 2 city (tests/test_fleet_sharding.py's ``_city_engines``
  lattice at ``page_slots=4``), round by round from the reference's state
  (tests/_torch_planes.py): ``none`` and ``topk_int8``, the fault plane,
  and the ``streaming`` schedule with mobility churn.  Cuts, loads,
  counts and bytes equal; losses, parameters, residuals, bank and buffer
  within 1e-5.
* Paged against the port's own unpaged run: a free run on ``none``
  within 1e-6 of the largest parameter (the largest difference recorded
  as a property); ``int8`` and ``topk_int8`` round by round from a shared
  state within 1e-6 of it, as a free run on a quantised wire can flip
  one int8 step; bit for bit where every run lies inside one page.
* K = 4 equal to K = 1 bit for bit when paged, under faults and under
  streaming.
* The refusals, with the reference's texts.
"""
import numpy as np
import pytest
import torch

import _torch_planes as H
from _torch_parity import cap_torch_threads
from repro_torch import api as TAPI
from repro_torch.core import channel as TCh
from repro_torch.core import fedsim as TF
from repro_torch.core import scenario as TS
from repro_torch.core import superstep as SS
from repro_torch.models import mlp_unit as TM

cap_torch_threads()

PAGE = 4
FAULTS = dict(fault_dropout=0.2, fault_upload_loss=0.1, fault_rsu_outage=0.25,
              fault_straggler=2e-3)
STREAM = dict(stream_churn_source="mobility", stream_buffer_size=2,
              stream_kernel="poly")


def _spy_plans(te):
    plans = []
    real = te._plan

    def spy(*args):
        plans.append(real(*args))
        return plans[-1]

    te._plan = spy
    return plans


def _split_runs(plans):
    """Buckets walked in more than one page, and runs split by a page."""
    multi = split = 0
    for p in plans:
        for bk in p["par"].buckets:
            multi += len(bk.pages) > 1
            split += sum(len(pg.runs) for pg in bk.pages) - len(bk.runs)
    return multi, split


# ------------------------------------------------- against the reference
CASES = [("none", "parallel", {}), ("topk_int8", "parallel", {}),
         ("none", "parallel", FAULTS), ("topk_int8", "streaming", STREAM)]


@pytest.mark.parametrize("wire,schedule,extra", CASES,
                         ids=["none", "topk_int8", "faults",
                              "streaming-mobility"])
def test_paged_rounds_match_reference(wire, schedule, extra):
    je, te = H.build("city", wire=wire, schedule=schedule, page_slots=PAGE,
                     **extra)
    assert te.page == PAGE
    plans = _spy_plans(te)
    hist = H.rounds_match(je, te)
    multi, split = _split_runs(plans)
    assert multi > 0 and split > 0        # pages, and runs across them
    occ = te.occupancy_stats()
    assert occ == je.occupancy_stats()
    assert -(-occ["executed_slots"] // PAGE) > 1
    if extra is FAULTS:
        assert sum(m.n_dropout for m in hist) > 0
        assert sum(m.n_straggler for m in hist) > 0
        assert sum(m.n_rsu_down for m in hist) > 0
    if extra is STREAM:
        assert sum(m.stream_merges for m in hist) > 0


# -------------------------------------------- against the unpaged port
def _city_engine(page, wire="none", k=1, **extra):
    sc = TS.make_scenario("city", H.CITY_N, seed=1, grid_x=2, grid_y=2)
    clients, test = TM.make_mlp_fleet_data(H.CITY_N, 24, seed=0, n_test=64)
    kw = dict(scheme="asfl", adaptive_strategy="paper", rounds=H.ROUNDS,
              local_steps=2, batch_size=8, lr=1e-2, optimizer="sgd",
              round_interval_s=5.0, eval_every=0, superstep=k, wire=wire,
              server_schedule="parallel", page_slots=page)
    cfg = TF.SimConfig(**{**kw, **extra})
    return TF.ScenarioEngine(TM.MLPUnitModel(), clients, test, cfg, sc,
                             cloud_sync_every=2, device="cpu")


def _copy_state(src, dst):
    dst.units, dst.head = src.plane.tree(
        src.plane.flatten(src.units, src.head).clone())
    dst.edge_planes = src.edge_planes.clone()
    dst.samples, dst.prev = src.samples.copy(), src.prev.copy()
    dst.wire_cut = src.wire_cut.copy()
    dst.wire_res = [None if r is None else r.clone() for r in src.wire_res]


def _planes(e):
    return torch.cat([e.plane.flatten(e.units, e.head)[None],
                      e.edge_planes])


def test_paged_free_run_within_a_millionth(record_property):
    base, paged = _city_engine(0), _city_engine(PAGE)
    h0, h1 = base.run(), paged.run()
    assert paged.bucket_steps > base.bucket_steps      # it did page
    assert [m.cuts for m in h0] == [m.cuts for m in h1]
    assert [m.comm_bytes for m in h0] == [m.comm_bytes for m in h1]
    a, b = _planes(base), _planes(paged)
    err = float((a - b).abs().max())
    record_property("max_abs_diff", err)
    assert err <= 1e-6 * float(a.abs().max())
    np.testing.assert_allclose([m.loss for m in h1], [m.loss for m in h0],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("wire", ["int8", "topk_int8"])
def test_paged_rounds_match_unpaged_from_a_shared_state(wire,
                                                        record_property):
    """A free run on a quantised wire can flip one int8 step (int8 over 4
    rounds: 3.6e-5); from a shared state each round agrees within a
    millionth of the largest parameter."""
    base, paged = _city_engine(0, wire), _city_engine(PAGE, wire)
    worst = 0.0
    for rnd in range(H.ROUNDS):
        a, b = base.run_round(rnd), paged.run_round(rnd)
        assert (a.cuts, a.rsu_loads, a.comm_bytes) \
            == (b.cuts, b.rsu_loads, b.comm_bytes)
        assert abs(a.loss - b.loss) <= 1e-6
        ref = _planes(base)
        err = float((ref - _planes(paged)).abs().max())
        assert err <= 1e-6 * float(ref.abs().max())
        worst = max(worst, err)
        for r0, r1 in zip(base.wire_res, paged.wire_res):
            assert (r0 is None) == (r1 is None)
            if r0 is not None:
                assert float((r0 - r1).abs().max()) <= 1e-6
        _copy_state(base, paged)
    record_property("max_abs_diff", worst)


def _aligned_trace():
    """Two RSUs, two vehicles in each at mirrored spots with one transmit
    power: one cut, so one bucket whose two runs are the two pages of
    ``page_slots=2``."""
    x = np.array([-60.0, 60.0, 940.0, 1060.0])
    pos = np.zeros((3, 4, 2))
    pos[:, :, 0] = x
    fleet = TCh.fleet_arrays(TCh.make_fleet(4, 0))
    fleet["tx_power_w"] = np.full(4, 0.6)
    return TS.TraceReplay(np.array([0.0, 5.0, 10.0]), pos,
                          np.array([[0.0, 0.0], [1000.0, 0.0]]), fleet=fleet)


@pytest.mark.parametrize("wire", ["none", "topk_int8"])
def test_paged_bit_for_bit_when_runs_fit_pages(wire):
    runs = []
    for page in (0, 2):
        clients, test = TM.make_mlp_fleet_data(4, 24, seed=0, n_test=16)
        cfg = TF.SimConfig(rounds=3, local_steps=2, batch_size=8, lr=1e-2,
                           optimizer="sgd", round_interval_s=5.0,
                           eval_every=0, wire=wire, page_slots=page,
                           server_schedule="parallel")
        eng = TF.ScenarioEngine(TM.MLPUnitModel(), clients, test, cfg,
                                _aligned_trace(), device="cpu")
        plans = _spy_plans(eng)
        hist = eng.run()
        assert all(len(set(m.cuts)) == 1 for m in hist)
        runs.append((eng, hist, plans))
    (e0, h0, _), (e1, h1, plans) = runs
    assert all([len(bk.pages) for bk in p["par"].buckets] == [2]
               for p in plans)
    assert _split_runs(plans) == (len(plans), 0)
    assert torch.equal(_planes(e0), _planes(e1))
    np.testing.assert_allclose([m.loss for m in h1], [m.loss for m in h0],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("extra", [FAULTS, STREAM], ids=["faults",
                                                          "streaming"])
def test_paged_window_equals_rounds_bit_for_bit(extra):
    if extra is STREAM:
        extra = dict(extra, server_schedule="streaming")
    engines = [_city_engine(PAGE, "topk_int8", k, **extra) for k in (4, 1)]
    hists = [e.run() for e in engines]
    assert [m.loss for m in hists[0]] == [m.loss for m in hists[1]]
    H.same_bits(*engines)


# ---------------------------------------------------------- refusals
def test_page_slots_validation():
    with pytest.raises(ValueError, match="page_slots"):
        TF.SimConfig(page_slots=-1)
    with pytest.raises(ValueError, match="RAGGED layout's compacted"):
        TAPI.ExperimentSpec(
            fleet=TAPI.FleetConfig(n_vehicles=8, scenario="highway_corridor"),
            train=TAPI.TrainConfig(server_schedule="parallel"),
            runtime=TAPI.RuntimeConfig(page_slots=4,
                                       superstep_layout="dense"))
    with pytest.raises(ValueError, match="sequential chain have no"):
        TAPI.ExperimentSpec(
            fleet=TAPI.FleetConfig(n_vehicles=8, scenario="highway_corridor"),
            runtime=TAPI.RuntimeConfig(page_slots=4))
    with pytest.raises(ValueError, match="set a fleet.scenario"):
        TAPI.ExperimentSpec(runtime=TAPI.RuntimeConfig(page_slots=4))
    # a slot table that is no whole number of pages cannot page
    serving = np.array([0, 0, 1, 1, 1, 0])
    cuts = np.array([2, 4, 2, 2, 4, 0])
    order, seg, counts = SS.slot_sort(serving, cuts, 2, 9)
    for slots, ok in ((6, False), (8, True), (4, True)):
        mem, sseg = SS.slot_table_flat(order, seg, counts, "ragged", 4,
                                       slots)
        if ok:
            SS.plan_parallel(mem, sseg, cuts, np.full(6, 24), 2, 9, page=4)
        else:
            with pytest.raises(ValueError, match="must divide the per-dev"):
                SS.plan_parallel(mem, sseg, cuts, np.full(6, 24), 2, 9,
                                 page=4)
    assert [SS.page_padded_slots(s, 4) for s in (3, 4, 6, 9)] == [3, 4, 8,
                                                                 12]


def test_api_runs_a_paged_city_spec():
    spec = TAPI.ExperimentSpec(
        model="mlp9",
        train=TAPI.TrainConfig(rounds=2, local_steps=1, batch_size=8,
                               optimizer="sgd", lr=1e-3, eval_every=0,
                               server_schedule="parallel"),
        fleet=TAPI.FleetConfig(n_vehicles=H.CITY_N, scenario="city",
                               scenario_kwargs={"grid_x": 2, "grid_y": 2},
                               per_vehicle_samples=16),
        stream=TAPI.StreamConfig(churn_source="mobility"),
        runtime=TAPI.RuntimeConfig(superstep=2, page_slots=8))
    res = TAPI.run(spec, device="cpu")
    assert res.diagnostics["page_slots"] == 8
    assert res.diagnostics["n_rsus"] == 4
    assert all(np.isfinite(m.loss) for m in res.history)
    assert res.diagnostics["occupancy"]["executed_slots"] > 8
