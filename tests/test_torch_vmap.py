"""The vectorised replica schedule (``cohort_parallel="vmap"``) on the CPU:
the port's vmap against the port's loop (``unroll``) on mlp9 for every wire
and on resnet18, the port's vmap against the reference's vmap schedule on
mlp9, fl under both schedules; wire bytes and client batch steps equal
across schedules, and the mode each cohort_parallel value resolves to.

Shards of unequal size make replicas run different numbers of local steps,
so buckets hold slots that sit steps out (kept as they were, neither their
bytes nor their steps counted).

Tolerance: loss and parameters within 1e-4 with sgd, the reference's own
schedule tolerance (tests/test_engine_parity.py).  resnet18 is held on
``wire="none"``: its vmapped convolutions are grouped convolutions that sum
in another order, and on a codec wire a 1-ulp difference can move a
smashed value by one int8 step (mlp9 holds the codec wires)."""
import dataclasses

import numpy as np
import pytest

from _torch_parity import (assert_sims_agree, cap_torch_threads,
                           max_abs_diff, port_leaves_np, run_both)
from repro_torch.core import cost as TC
from repro_torch.core import fedsim as TF
from repro_torch.data.pipeline import make_federated_data
from repro_torch.models import mlp_unit as TM

cap_torch_threads()

SIZES = (16, 24, 32, 40)
TOL = 1e-4


def _port_sims(model, clients, test, **kw):
    """The port's sim under unroll and under vmap from the same seed."""
    out = {}
    for mode in ("unroll", "vmap"):
        cfg = TF.SimConfig(cohort_parallel=mode, **kw)
        sim = TF.FederationSim(model, clients, test, cfg, device="cpu")
        assert sim.engine.mode == mode
        out[mode] = (sim, sim.run())
    return out


def _assert_schedules_agree(runs):
    (ls, lh), (vs, vh) = runs["unroll"], runs["vmap"]
    for a, b in zip(lh, vh):
        assert a.cuts == b.cuts
        assert (a.comm_bytes, a.sim_time_s, a.energy_j) \
            == (b.comm_bytes, b.sim_time_s, b.energy_j)
        assert abs(a.loss - b.loss) <= TOL
    assert ls.engine.wire_bytes == vs.engine.wire_bytes
    assert ls.engine.batch_steps == vs.engine.batch_steps
    assert max_abs_diff(port_leaves_np(ls.units, ls.head),
                        port_leaves_np(vs.units, vs.head)) <= TOL


def _uneven_mlp():
    clients, test = TM.make_mlp_fleet_data(4, max(SIZES), seed=2, n_test=64)
    return ([dataclasses.replace(c, images=c.images[:n], labels=c.labels[:n])
             for c, n in zip(clients, SIZES)], test)


@pytest.mark.parametrize("scheme,wire", [
    ("asfl", "none"), ("asfl", "int8"), ("asfl", "topk_int8"),
    ("fl", "none")])
def test_vmap_matches_loop_mlp9(scheme, wire):
    clients, test = _uneven_mlp()
    runs = _port_sims(TM.MLPUnitModel(), clients, test, scheme=scheme,
                      n_clients=4, batch_size=8, local_epochs=1, lr=1e-2,
                      rounds=2, optimizer="sgd", wire=wire)
    _assert_schedules_agree(runs)
    steps = runs["vmap"][0].engine.batch_steps
    assert steps == 2 * sum(n // 8 for n in SIZES)
    if scheme == "asfl":
        # the wire carried exactly the cost model's smashed bytes
        sim, hist = runs["vmap"]
        want = 0.0
        for m in hist:
            up, down = TC.effective_comm_bytes(
                sim.profile, m.cuts, [n // 8 for n in SIZES], 8, wire,
                include_model_transfer=False)
            want += float(np.sum(up + down))
        assert sim.engine.wire_bytes == want


def test_vmap_matches_loop_resnet18():
    clients, test = make_federated_data(0, n_train=64, n_test=8)
    runs = _port_sims(TF.ResNetModel(), clients, test, scheme="asfl",
                      batch_size=4, local_steps=1, lr=1e-2, rounds=1,
                      optimizer="sgd", eval_every=0)
    assert len(set(runs["vmap"][1][0].cuts)) > 1      # several buckets
    _assert_schedules_agree(runs)


def test_vmap_matches_jax_vmap_mlp9():
    js, jh, ts, th = run_both("sgd", "topk_int8", 1e-2,
                              cohort_parallel="vmap", sizes=SIZES,
                              per_vehicle=max(SIZES))
    assert js.engine.mode == ts.engine.mode == "vmap"
    assert_sims_agree(js, jh, ts, th, "topk_int8")


def test_fl_vmap_matches_jax_vmap():
    js, jh, ts, th = run_both("adam", "none", 1e-3, scheme="fl",
                              cohort_parallel="vmap", sizes=SIZES,
                              per_vehicle=max(SIZES))
    assert ts.engine.mode == "vmap"
    assert_sims_agree(js, jh, ts, th, "none")


def test_cohort_modes_resolve():
    clients, test = TM.make_mlp_fleet_data(2, 8, seed=0, n_test=8)
    for asked, got in (("auto", "unroll"), ("unroll", "unroll"),
                       ("scan", "scan"), ("vmap", "vmap")):
        sim = TF.FederationSim(TM.MLPUnitModel(), clients, test,
                               TF.SimConfig(cohort_parallel=asked),
                               device="cpu")
        assert sim.engine.mode == got
    with pytest.raises(ValueError, match="cohort_parallel"):
        TF.SimConfig(cohort_parallel="pmap")
