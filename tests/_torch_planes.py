"""Shared harness of the fault- and streaming-plane parity tests
(tests/test_torch_faults_scenario.py, tests/test_torch_streaming.py): the
reference's and the port's ScenarioEngine on tests/test_torch_parallel.py's
cells (the two-cell trace or urban_grid, mlp9, paper cuts, local steps 2,
batch 8, 4 rounds, cloud sync every 2; tests/test_streaming.py's
coverage-gap trace for the mobility churn source; and a 64-vehicle city
on a 2 x 2 lattice, tests/test_fleet_sharding.py's), the reference's
threefry draws fed to the port through its seams (fleet states, batch indices, the fault
draws before ``ensure_rsu_up``, the presence toggles), and the port's state
compared with and set to the reference's carry after each round: the
models, counters, residuals, and the staleness bank (``stale_num`` /
``stale_den``), the presence plane and the StreamBuffer (``sbuf*``).

The port keeps the bank and the buffer on its own flat plane (units in
order, then the head); the reference keeps them on its ravelled plane
(the head first, dict keys sorted), the sequential bank as per-unit trees.
The helpers convert through the parameter trees.
"""
import jax
import numpy as np
import torch
from jax.flatten_util import ravel_pytree

from _torch_parity import leaves_np, max_abs_diff, port_leaves_np
from repro.core import channel as JCh
from repro.core import faults as JFa
from repro.core import fedsim as JF
from repro.core import scenario as JS
from repro.core import streaming as JSt
from repro.data import pipeline as JP
from repro.models import mlp_unit as JM
from repro_torch import bridge
from repro_torch.core import channel as TCh
from repro_torch.core import fedsim as TF
from repro_torch.core import scenario as TS
from repro_torch.models import mlp_unit as TM
from test_torch_parallel import port_tree
from test_torch_scenario import (BATCH, INTERVAL, ROUNDS, STEPS, _Mods,
                                 _traced_states, _two_cell_trace)

TOL = 1e-5
CITY_N = 64         # vehicles of the reduced city (a 2 x 2 lattice)


def build(scenario, wire="none", schedule="sequential", layout="ragged",
          k=1, optimizer="sgd", lr=1e-2, sync=2, rounds=ROUNDS, **extra):
    """The reference's and the port's engines on one cell from the same
    parameters and draws; ``extra`` are SimConfig fields of both."""
    kw = dict(scheme="asfl", adaptive_strategy="paper", rounds=rounds,
              local_steps=STEPS, batch_size=BATCH, lr=lr,
              optimizer=optimizer, round_interval_s=INTERVAL, eval_every=1,
              superstep=k, wire=wire, server_schedule=schedule,
              superstep_layout=layout, **extra)
    if scenario == "trace":
        jsc = _two_cell_trace(_Mods(JCh, JS))
        tsc = _two_cell_trace(_Mods(TCh, TS))
    elif scenario == "gap":
        jsc = gap_trace(_Mods(JCh, JS))
        tsc = gap_trace(_Mods(TCh, TS))
    elif scenario == "city":     # tests/test_fleet_sharding.py's lattice
        jsc = JS.make_scenario("city", CITY_N, seed=1, grid_x=2, grid_y=2)
        tsc = TS.make_scenario("city", CITY_N, seed=1, grid_x=2, grid_y=2)
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
    pg = je.programs

    def batch_indices(rnd):
        return np.asarray(JP.fleet_batch_indices_traced(
            jax.random.fold_in(base, rnd), lengths, STEPS, BATCH))

    def fault_draws(rnd):
        return tuple(np.asarray(a) for a in JFa.sample_faults_traced(
            pg.faults, rnd, n, pg.n_rsus_padded))

    def presence_toggles(rnd):
        return np.asarray(JSt.sample_toggles_traced(pg.stream, rnd, n))

    te = TF.ScenarioEngine(
        TM.MLPUnitModel(), tc, tt, TF.SimConfig(**kw), tsc,
        cloud_sync_every=sync, device="cpu", batch_indices=batch_indices,
        fleet_states=(_traced_states(jsc, 0) if pg.traced_mobility
                      else None),
        fault_draws=fault_draws, presence_toggles=presence_toggles)
    te.set_params(*port_tree(je.units, je.head))
    return je, te


def gap_trace(module):
    """tests/test_streaming.py's fixture: vehicle 0 is covered by RSU0,
    leaves coverage in round 1 and comes back; vehicle 1 parks inside
    RSU0."""
    times = np.arange(ROUNDS + 1, dtype=np.float64) * INTERVAL
    x0 = np.array([300.0, 600.0] + [300.0] * (len(times) - 2))
    x = np.stack([x0, np.full(len(times), 310.0)], axis=-1)
    pos = np.stack([x, np.zeros_like(x)], axis=-1)
    rsus = np.array([[300.0, 0.0], [900.0, 0.0]])
    ch = module.channel.ChannelConfig(fading_std_db=0.0, rsu_range_m=200.0)
    return module.scenario.TraceReplay(times, pos, rsus, ch=ch, seed=0)


# ---------------------------------------------------- plane conversions
def _ref_flat(je, units, head):
    return np.asarray(ravel_pytree({"units": list(units), "head": head})[0])


def ref_to_port_flat(je, te, flat):
    """A (P,) vector on the reference's plane -> the port's plane."""
    tree = je.programs.unravel(np.asarray(flat, np.float32))
    units, head = port_tree(tree["units"], tree["head"])
    return te.plane.flatten(units, head)


def port_to_ref_flat(je, te, flat):
    units, head = te.plane.tree(flat)
    return _ref_flat(je, *bridge.params_to_numpy(units, head))


def ref_bank_rows(je, te):
    """The reference's bank numerator as (R, P) rows on the port's plane."""
    c, pg = je._carry, je.programs
    P = pg.n_params
    rows = []
    for r in range(te.n_rsus):
        if isinstance(c["stale_num"], list):      # sequential: unit trees
            zero = pg.unravel(np.zeros(P, np.float32))
            units = [jax.tree.map(lambda a, _r=r: np.asarray(a)[_r], t)
                     for t in c["stale_num"]]
            units += [jax.tree.map(np.asarray, u)
                      for u in zero["units"][len(units):]]
            flat = _ref_flat(je, units, jax.tree.map(np.asarray,
                                                      zero["head"]))
        else:                                     # the owned window
            flat = np.zeros(P, np.float32)
            flat[pg.plane_offset:pg.plane_offset + pg.plane_width] = \
                np.asarray(c["stale_num"])[r]
        rows.append(ref_to_port_flat(je, te, flat))
    return torch.stack(rows)


def ref_bank_den(je, te):
    den = np.asarray(je._carry["stale_den"])
    out = np.zeros((te.n_rsus, te.model.n_units + 1), np.float32)
    out[:, :den.shape[1]] = den
    return out


def ref_sbuf(je, te):
    sb = np.asarray(je._carry["sbuf"])
    return torch.stack([torch.stack([ref_to_port_flat(je, te, sb[r, b])
                                     for b in range(sb.shape[1])])
                        for r in range(sb.shape[0])])


# ------------------------------------------------- compare / load state
def ref_edges(je):
    """The reference's edge models as (units, head) trees, on either
    schedule (sequential: a tree of (R, ...) leaves; else flat planes)."""
    edge = je._carry["edge"]
    if isinstance(edge, dict):
        return [jax.tree.map(lambda a, _r=r: np.asarray(a)[_r], edge)
                for r in range(je.n_rsus)]
    return [je.programs.unravel(e) for e in edge]


def assert_planes(je, te, tol=TOL):
    """The port's whole state against the reference's carry: models within
    ``tol``; counters, serving cells and residual cuts equal; residuals
    within ``tol``; then the bank, the presence plane and the
    StreamBuffer."""
    c = je._carry
    assert max_abs_diff(leaves_np(je.units, je.head),
                        port_leaves_np(te.units, te.head)) <= tol
    for g, e in zip(ref_edges(je), te.edges):
        assert max_abs_diff(leaves_np(g["units"], g["head"]),
                            port_leaves_np(e["units"], e["head"])) <= tol
    np.testing.assert_array_equal(te.samples, np.asarray(c["samples"]))
    np.testing.assert_array_equal(te.prev, np.asarray(c["prev"]))
    if "wire_res" in c:
        res = np.asarray(c["wire_res"])
        np.testing.assert_array_equal(te.wire_cut, np.asarray(c["wire_cut"]))
        for v, r in enumerate(te.wire_res):
            if r is None:
                assert not res[v].any()
            else:
                flat = r.reshape(-1).numpy()
                np.testing.assert_allclose(flat, res[v][:flat.size],
                                           atol=tol, rtol=0)
    if te.fz:
        np.testing.assert_array_equal(te.stale_den, ref_bank_den(je, te))
        np.testing.assert_allclose(te.stale_num.numpy(),
                                   ref_bank_rows(je, te).numpy(),
                                   atol=tol, rtol=0)
    else:
        assert "stale_num" not in c
    if te.cz:
        np.testing.assert_array_equal(te.present, np.asarray(c["present"]))
    else:
        assert "present" not in c
    if te.sz:
        np.testing.assert_array_equal(te.sbuf_w, np.asarray(c["sbuf_w"]))
        np.testing.assert_array_equal(te.sbuf_age,
                                      np.asarray(c["sbuf_age"]))
        np.testing.assert_array_equal(te.sbuf_cnt,
                                      np.asarray(c["sbuf_cnt"]))
        np.testing.assert_allclose(te.sbuf.numpy(), ref_sbuf(je, te).numpy(),
                                   atol=tol, rtol=0)
    else:
        assert "sbuf" not in c


def load_planes(je, te):
    """Set the port's whole state to the reference's carry."""
    c = je._carry
    te.units, te.head = port_tree(je.units, je.head)
    te.edges = [dict(zip(("units", "head"),
                         port_tree(g["units"], g["head"])))
                for g in ref_edges(je)]
    te.samples = np.asarray(c["samples"]).copy()
    te.prev = np.asarray(c["prev"]).astype(np.int64)
    if "wire_res" in c:
        te.wire_cut = np.asarray(c["wire_cut"]).astype(np.int64)
        res = np.asarray(c["wire_res"])
        te.wire_res = [None if te.wire_cut[v] < 0 else torch.from_numpy(
            res[v][:BATCH * 64].reshape(BATCH, 64).copy())
            for v in range(len(te.wire_res))]
    if te.fz:
        te.stale_den = ref_bank_den(je, te)
        te.stale_num = ref_bank_rows(je, te)
    if te.cz:
        te.present = np.asarray(c["present"]).copy()
    if te.sz:
        te.sbuf_w = np.asarray(c["sbuf_w"]).copy()
        te.sbuf_age = np.asarray(c["sbuf_age"]).astype(np.int32)
        te.sbuf_cnt = np.asarray(c["sbuf_cnt"]).astype(np.int32)
        te.sbuf = ref_sbuf(je, te)


FAULT_FIELDS = ("n_dropout", "n_upload_lost", "n_straggler", "n_rsu_down",
                "survivor_frac", "lost_update_bytes", "n_present",
                "n_arrived", "stream_merges", "buffer_occupancy",
                "absorbed_samples", "stream_stale")


def assert_round(a, b):
    """One round's metrics: cuts, loads, counts, every fault and stream
    count, survivor_frac, lost_update_bytes and comm_bytes equal; loss
    within TOL; stale_merged, sim_time_s and energy_j within 1e-6
    relative."""
    assert b.cuts == a.cuts, (a.round, a.cuts, b.cuts)
    assert b.rsu_loads == a.rsu_loads
    assert (b.n_scheduled, b.n_skipped, b.n_handover) \
        == (a.n_scheduled, a.n_skipped, a.n_handover)
    for f in FAULT_FIELDS:
        assert getattr(b, f) == getattr(a, f), (a.round, f, getattr(a, f),
                                               getattr(b, f))
    assert b.comm_bytes == a.comm_bytes
    np.testing.assert_allclose(b.stale_merged, a.stale_merged, rtol=1e-6)
    np.testing.assert_allclose(b.sim_time_s, a.sim_time_s, rtol=1e-6)
    np.testing.assert_allclose(b.energy_j, a.energy_j, rtol=1e-6)
    assert abs(a.loss - b.loss) <= TOL, (a.round, a.loss, b.loss)
    assert np.isnan(a.test_acc) == np.isnan(b.test_acc)
    if not np.isnan(a.test_acc):
        assert abs(a.test_acc - b.test_acc) <= 1 / 64


def rounds_match(je, te, rounds=ROUNDS):
    """Round by round from the reference's state; returns the port's
    history."""
    hist = []
    for rnd in range(rounds):
        a, b = je.run_round(rnd), te.run_round(rnd)
        assert_round(a, b)
        assert_planes(je, te)
        load_planes(je, te)
        hist.append(b)
    return hist


def params(te):
    return port_leaves_np(te.units, te.head)


def same_bits(e1, e2):
    """Two port engines hold the same models, bank and buffer bit for
    bit."""
    for a, b in zip(params(e1), params(e2)):
        np.testing.assert_array_equal(a, b)
    for g1, g2 in zip(e1.edges, e2.edges):
        for a, b in zip(port_leaves_np(g1["units"], g1["head"]),
                        port_leaves_np(g2["units"], g2["head"])):
            np.testing.assert_array_equal(a, b)
    for name in ("stale_num", "sbuf"):
        if hasattr(e1, name):
            assert torch.equal(getattr(e1, name), getattr(e2, name))
    for name in ("stale_den", "present", "sbuf_w", "sbuf_age", "sbuf_cnt",
                 "samples", "prev", "wire_cut"):
        if hasattr(e1, name):
            np.testing.assert_array_equal(getattr(e1, name),
                                          getattr(e2, name))
    for r1, r2 in zip(e1.wire_res, e2.wire_res):
        assert (r1 is None) == (r2 is None)
        if r1 is not None:
            assert torch.equal(r1, r2)


__all__ = ["build", "rounds_match", "assert_round", "assert_planes",
           "load_planes", "same_bits", "params", "leaves_np",
           "max_abs_diff", "TOL", "ROUNDS"]
