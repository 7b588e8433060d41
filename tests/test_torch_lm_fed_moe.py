"""The MoE archs in the federation engines against the JAX package on the
CPU: ``FederationSim`` sfl on deepseek-v2-lite-16b-smoke (MLA + MoE units;
the units drop the aux loss, as the reference's ``apply_units`` does)
against the reference's: cuts and bytes exact, the loss within LOSS_RTOL
and every unit within PARAM_TOL; ``api.run`` of deepseek-smoke against the
reference's (engine, cuts, bytes; built by each ``build_engine`` from the
reference's units, the loss and every unit); and its ``vmap`` schedule
against ``unroll`` within VMAP_TOL (the dense MoE path and MLA batched
over a bucket's replicas).  The tolerances are those of PERF.md section 2,
"Training parity".  Parameters come from the reference's threefry init
and cross through ``repro_torch.bridge``; the fleet data is the numpy
draw both registries share."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import cap_torch_threads, lm_configs
from repro.api import registry as JR
from repro.api import runner as JRUN
from repro.core import fedsim as JF
from repro.core import lm_unit as JU
from repro_torch import api, bridge
from repro_torch.api import registry as TR
from repro_torch.api import runner as TRUN
from repro_torch.core import fedsim as TF
from repro_torch.core import lm_unit as TU
from test_torch_lm_unit import _unit_drift

cap_torch_threads()

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5        # after one sgd round (absolute)
VMAP_TOL = 1e-4
DEEPSEEK = "deepseek-v2-lite-16b"


def _units(jcfg):
    units, head = JU.TransformerUnitModel(jcfg).init(jax.random.PRNGKey(0))
    return ([jax.tree.map(np.asarray, u) for u in units],
            jax.tree.map(np.asarray, head))


def test_federation_sim_sfl_deepseek_matches_reference():
    """``FederationSim`` sfl, cut 2 (the embedding and the MLA + MoE period
    on the vehicles, the MLA + dense tail on the RSU), 3 vehicles, one sgd
    round, from the same units and data."""
    jcfg, tcfg = lm_configs(DEEPSEEK)
    units, head = _units(jcfg)
    kw = dict(scheme="sfl", cut=2, n_clients=3, batch_size=4, local_steps=2,
              lr=1e-2, rounds=1, optimizer="sgd", wire="none")
    jc, jt = JR.make_lm_fleet_data(3, 8, 16, 0, tcfg.vocab_size)
    tc, tt = TR.make_lm_fleet_data(3, 8, 16, 0, tcfg.vocab_size)
    js = JF.FederationSim(JU.TransformerUnitModel(jcfg), jc, jt,
                          JF.SimConfig(**kw))
    js.units = [jax.tree.map(jnp.asarray, u) for u in units]
    js.head = jax.tree.map(jnp.asarray, head)
    ts = TF.FederationSim(TU.TransformerUnitModel(tcfg), tc, tt,
                          TF.SimConfig(**kw), device="cpu")
    ts.set_params(*bridge.lm_units_to_torch(units, head))
    (a,), (b,) = js.run(), ts.run()
    assert a.cuts == b.cuts == [2, 2, 2]
    assert b.comm_bytes == a.comm_bytes
    assert b.sim_time_s == pytest.approx(a.sim_time_s, rel=1e-12)
    np.testing.assert_allclose(b.loss, a.loss, rtol=LOSS_RTOL)
    assert 0.0 <= b.test_acc <= 1.0
    assert max(_unit_drift(js, ts)) <= PARAM_TOL


def _spec(mode, scheme="asfl"):
    return api.ExperimentSpec(
        model=DEEPSEEK,
        train=api.TrainConfig(scheme=scheme, rounds=1, local_steps=2,
                              batch_size=4, optimizer="sgd", lr=1e-2,
                              wire="none"),
        fleet=api.FleetConfig(n_vehicles=4, per_vehicle_samples=8,
                              test_samples=16),
        runtime=api.RuntimeConfig(cohort_parallel=mode))


def test_api_run_deepseek_matches_reference():
    """``api.run`` on both packages (single RSU, asfl, 4 vehicles): the
    same engine, cuts and wire bytes; built by each ``build_engine`` from
    the reference's units, the round's loss and the final units within
    PARAM_TOL."""
    import repro.api as JAPI
    spec = _spec("unroll")
    jspec = JAPI.ExperimentSpec(
        model=DEEPSEEK,
        train=JAPI.TrainConfig(rounds=1, local_steps=2, batch_size=4,
                               optimizer="sgd", lr=1e-2, wire="none"),
        fleet=JAPI.FleetConfig(n_vehicles=4, per_vehicle_samples=8,
                               test_samples=16),
        runtime=JAPI.RuntimeConfig(cohort_parallel="unroll"))
    a, b = JAPI.run(jspec), api.run(spec, device="cpu")
    assert a.engine_kind == b.engine_kind == TR.FEDERATION
    assert a.history[0].cuts == b.history[0].cuts
    assert b.history[0].comm_bytes == a.history[0].comm_bytes
    assert np.isfinite(b.history[0].loss)
    assert [x.shape for x in jax.tree.leaves(list(b.final_params))] == \
        [x.shape for x in jax.tree.leaves(list(a.final_params))]
    je, te = JRUN.build_engine(jspec), TRUN.build_engine(spec, device="cpu")
    te.set_params(*bridge.lm_units_to_torch(
        [jax.tree.map(np.asarray, u) for u in je.units],
        jax.tree.map(np.asarray, je.head)))
    (ma,), (mb,) = je.run(), te.run()
    assert ma.cuts == mb.cuts
    np.testing.assert_allclose(mb.loss, ma.loss, rtol=LOSS_RTOL)
    assert max(_unit_drift(je, te)) <= PARAM_TOL


@pytest.mark.parametrize("scheme", ["asfl", "fl"])
def test_api_run_deepseek_vmap_equals_unroll(scheme):
    """The ``vmap`` schedule batches a cut bucket's replicas through MLA
    and the MoE's dense path (its gate matrix an out-of-place scatter, its
    one-hots comparisons with an arange): ``asfl``'s vjp of vmap and
    ``fl``'s vmap of grad give the same cuts and bytes as ``unroll``, the
    loss and the final units within VMAP_TOL."""
    runs = {m: api.run(_spec(m, scheme), device="cpu")
            for m in ("unroll", "vmap")}
    a, b = runs["unroll"], runs["vmap"]
    assert b.diagnostics["mode"] == "vmap"
    assert a.history[0].cuts == b.history[0].cuts
    assert a.diagnostics["wire_bytes"] == b.diagnostics["wire_bytes"]
    assert (a.diagnostics["wire_bytes"] > 0) == (scheme == "asfl")
    assert a.history[0].loss == pytest.approx(b.history[0].loss,
                                              abs=VMAP_TOL)
    ua, ub = (jax.tree.leaves(list(r.final_params)) for r in (a, b))
    assert max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(ua, ub)) <= VMAP_TOL
