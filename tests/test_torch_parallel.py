"""The parallel server schedule of the multi-RSU engine on the CPU: the
port's ScenarioEngine(server_schedule="parallel", device="cpu") against
repro.core.fedsim.ScenarioEngine(server_schedule="parallel") from the same
initial parameters, with the reference's threefry fleet states and batch
indices injected through the port's seams (the setup of
tests/test_torch_scenario.py: mlp9, paper cuts, local_steps 2, batch 8, 4
rounds, cloud sync every 2; sgd at lr 1e-2, adam at 1e-3).

Two harnesses.  At K = 1 both engines run round by round, and after each
round the port's whole state is compared with the reference's carry (edge
models, global model, sample counters, last serving cells, error-feedback
residuals and their cuts) and then set to it, so that every round starts
from the reference's state.  A free run cannot be held to 1e-5 on
``topk_int8``: the port's float32 sums in another order (measured <= 1e-6
on the residuals after two rounds) move one value across an int8 rounding
step of the wire in round 2 of the trace, and the round after amplifies
it (1.8e-5 in the loss, 7e-4 in the parameters after 4 rounds), while
from the reference's state every round agrees to 2.4e-7.  At K = 4 the
whole run is one window, compared at its end, on the wires without a
top-k (``none``, ``int8``); ``topk_int8`` at K = 4 equals K = 1 bit for
bit in the port (tests/test_torch_superstep.py).  The cases together run
``ragged`` and ``dense`` on each wire; the reference's own layouts are not
held to each other bit for bit (its losses differ by an ulp under jax
0.9.0, ROADMAP C).

Tolerances (as test_torch_scenario.py): cuts, RSU loads, handover / skip
counts and comm_bytes equal; per-round loss, parameters (and residuals)
within 1e-5; sim_time_s and energy_j within 1e-6 relative; test accuracy
within one of the 64 test samples."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import (cap_torch_threads, jax_params_np, leaves_np,
                           max_abs_diff, port_leaves_np)
from repro.core import channel as JCh
from repro.core import fedsim as JF
from repro.core import scenario as JS
from repro.data import pipeline as JP
from repro.models import mlp_unit as JM
from repro_torch import bridge
from repro_torch.core import channel as TCh
from repro_torch.core import fedsim as TF
from repro_torch.core import scenario as TS
from repro_torch.models import mlp_unit as TM
from test_torch_scenario import (BATCH, INTERVAL, ROUNDS, STEPS, _Mods,
                                 _traced_states, _two_cell_trace)

cap_torch_threads()

TOL = 1e-5


def build_both(scenario, wire, optimizer, lr, layout, k, sync=2):
    """The reference's and the port's parallel engines on one scenario from
    the same parameters and draws."""
    kw = dict(scheme="asfl", adaptive_strategy="paper", rounds=ROUNDS,
              local_steps=STEPS, batch_size=BATCH, lr=lr,
              optimizer=optimizer, round_interval_s=INTERVAL, eval_every=1,
              superstep=k, wire=wire, server_schedule="parallel",
              superstep_layout=layout)
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
    te.set_params(*port_tree(je.units, je.head))
    return je, te


def port_tree(units, head):
    return bridge.params_to_torch(*jax_params_np(units, head))


def ref_edges(je):
    return [je.programs.unravel(e) for e in je._carry["edge"]]


def assert_round(a, b):
    assert b.cuts == a.cuts
    assert b.rsu_loads == a.rsu_loads
    assert (b.n_scheduled, b.n_skipped, b.n_handover) \
        == (a.n_scheduled, a.n_skipped, a.n_handover)
    assert b.comm_bytes == a.comm_bytes
    np.testing.assert_allclose(b.sim_time_s, a.sim_time_s, rtol=1e-6)
    np.testing.assert_allclose(b.energy_j, a.energy_j, rtol=1e-6)
    assert abs(a.loss - b.loss) <= TOL, (a.round, a.loss, b.loss)
    assert np.isnan(a.test_acc) == np.isnan(b.test_acc)
    if not np.isnan(a.test_acc):
        assert abs(a.test_acc - b.test_acc) <= 1 / 64


def assert_state(je, te):
    """The port's carry against the reference's: models within TOL,
    counters, serving cells and residual cuts equal, residuals within
    TOL (each in the smashed shape of its cut: (batch, 64) on mlp9)."""
    c = je._carry
    assert max_abs_diff(leaves_np(je.units, je.head),
                        port_leaves_np(te.units, te.head)) <= TOL
    for g, e in zip(ref_edges(je), te.edges):
        assert max_abs_diff(leaves_np(g["units"], g["head"]),
                            port_leaves_np(e["units"], e["head"])) <= TOL
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
                                           atol=TOL, rtol=0)


def load_state(je, te):
    """Set the port's carry to the reference's."""
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


ROUND_BY_ROUND = [("trace", "none", "sgd", 1e-2, "ragged"),
                  ("trace", "int8", "sgd", 1e-2, "dense"),
                  ("trace", "topk_int8", "sgd", 1e-2, "ragged"),
                  ("trace", "topk_int8", "sgd", 1e-2, "dense"),
                  ("trace", "topk_int8", "adam", 1e-3, "dense"),
                  ("trace", "topk_int8", "adam", 1e-3, "ragged"),
                  ("urban", "topk_int8", "sgd", 1e-2, "ragged")]


@pytest.mark.parametrize(
    "scenario,wire,optimizer,lr,layout", ROUND_BY_ROUND,
    ids=["-".join(c[:3] + c[4:]) for c in ROUND_BY_ROUND])
def test_parallel_rounds_match_reference(scenario, wire, optimizer, lr,
                                         layout):
    je, te = build_both(scenario, wire, optimizer, lr, layout, 1)
    assert te.mode == "parallel"
    hist = []
    for rnd in range(ROUNDS):
        a, b = je.run_round(rnd), te.run_round(rnd)
        assert_round(a, b)
        assert_state(je, te)
        load_state(je, te)
        hist.append(b)
    if scenario == "trace":      # the fixture's handover really happened
        assert sum(m.n_handover for m in hist) >= 1
        assert hist[-1].rsu_loads == [1, 1]
    else:                        # several RSUs and cuts in one round
        assert max(sum(c > 0 for c in m.rsu_loads) for m in hist) >= 2
        assert max(len(set(m.cuts) - {0}) for m in hist) >= 2


WINDOW = [("none", "dense"), ("int8", "ragged"), ("none", "ragged")]


@pytest.mark.parametrize("wire,layout", WINDOW,
                         ids=["-".join(c) for c in WINDOW])
def test_parallel_window_matches_reference(wire, layout):
    """K = 4: the whole run is one window of both engines (a handover and a
    cloud merge inside it), compared round by round and at its end."""
    je, te = build_both("trace", wire, "sgd", 1e-2, layout, 4)
    jh, th = je.run(), te.run()
    assert len(jh) == len(th) == ROUNDS
    for a, b in zip(jh, th):
        assert_round(a, b)
    assert sum(m.n_handover for m in th) >= 1
    assert_state(je, te)
