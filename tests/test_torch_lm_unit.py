"""``TransformerUnitModel`` (core/lm_unit.py) against the JAX package on
the CPU: the units against the monolithic forward and against the
reference's ``apply_units`` / ``head_loss``, ``profile()`` against the
reference's, ``FederationSim`` sfl against the reference's (one round,
sgd, wires ``none`` and ``topk_int8``), ``api.run`` of each arch on
``single_rsu`` (vmap and unroll) and on ``trace_replay``, the registry's
arch entries, and ``evaluate`` over per-token labels.  The trained text
archs: smollm-360m and mamba2-780m, and gemma3-4b (local and global
attention, qk-norm, GeGLU) and recurrentgemma-2b (RG-LRU, local MQA).
Parameters come from the reference's threefry init through
``repro_torch.bridge``; the fleet data is the numpy draw both registries
share."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads, lm_configs
from repro.api import registry as JR
from repro.core import fedsim as JF
from repro.core import lm_unit as JU
from repro_torch import api, bridge
from repro_torch.api import registry as TR
from repro_torch.core import fedsim as TF
from repro_torch.core import lm_unit as TU
from repro_torch.models import transformer as T

cap_torch_threads()

FEAT_TOL = 1e-4     # f32 activations through three periods
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5    # after one sgd round (absolute)
ARCHS = ["smollm-360m", "mamba2-780m", "gemma3-4b", "recurrentgemma-2b"]
# trained in bfloat16 (tests/test_torch_lm_train_bf16.py holds their
# FederationSim to the reference)
BF16_ARCHS = ["qwen3-14b", "command-r-35b"]
# three units past the embedding: smollm / mamba2 at three periods, gemma3
# (5 local + 1 global) and recurrentgemma (R, R, A) at two periods and
# their tails
DEPTH = {"smollm-360m": 3, "mamba2-780m": 3, "gemma3-4b": 16,
         "recurrentgemma-2b": 8}
_cache = {}


def _setup(arch):
    """(jax cfg, port cfg, ref model, port model, ref units / head as
    numpy), the reduced config grown to three units past the
    embedding."""
    if arch not in _cache:
        jcfg, tcfg = lm_configs(arch, n_layers=DEPTH[arch])
        jm, tm = JU.TransformerUnitModel(jcfg), TU.TransformerUnitModel(tcfg)
        units, head = jm.init(jax.random.PRNGKey(0))
        units = [jax.tree.map(np.asarray, u) for u in units]
        head = jax.tree.map(np.asarray, head)
        _cache[arch] = (jcfg, tcfg, jm, tm, units, head)
    return _cache[arch]


def _tokens(cfg, b=3, s=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)


# ------------------------------------------------------------ evaluate
class _Oracle:
    """Predicts every label: the features are the labels, the logits one
    hot of them."""
    n_units = 1

    def apply_units(self, units, x, start):
        return x

    def head_predict(self, head, feats):
        return torch.nn.functional.one_hot(feats.long(), 16).float()


def test_evaluate_divides_by_every_label():
    labels = np.random.default_rng(0).integers(0, 16, size=(300, 8))
    test = {"images": torch.from_numpy(labels),
            "labels": torch.from_numpy(labels)}
    assert TF.evaluate(_Oracle(), [], None, test) == 1.0
    half = dict(test, labels=torch.where(test["labels"] % 2 == 0,
                                         test["labels"], -1))
    want = float(np.mean(labels % 2 == 0))
    assert TF.evaluate(_Oracle(), [], None, half) == want


def test_evaluate_of_row_labels_is_unchanged():
    from repro_torch.models.mlp_unit import MLPUnitModel, make_mlp_fleet_data
    model = MLPUnitModel()
    units, head = model.init(torch.Generator().manual_seed(0))
    _, test = make_mlp_fleet_data(2, 8, n_test=300)
    staged = TF._stage_test(test, torch.device("cpu"))
    with torch.no_grad():
        pred = model.head_predict(head, model.apply_units(
            units, staged["images"], 0)).argmax(-1)
    want = int((pred == staged["labels"]).sum()) / 300
    assert TF.evaluate(model, units, head, staged) == want


# -------------------------------------------------------------- the units
@pytest.mark.parametrize("arch", ARCHS)
def test_units_equal_the_monolithic_forward(arch):
    _, tcfg, _, tm, _, _ = _setup(arch)
    params = T.init_params(torch.Generator().manual_seed(0), tcfg)
    units = [{"embed": params["embed"]}] + [
        period for seg in params["segments"] for period in seg]
    head = {"final_norm": params["final_norm"], "head": params["head"]}
    tok = torch.from_numpy(_tokens(tcfg)[:, :-1].astype(np.int64))
    with torch.no_grad():
        want, _, _ = T.forward(params, tcfg, {"tokens": tok}, "train")
        mid = tm.apply_units(units[:2], tok, 0)
        got = tm.head_predict(head, tm.apply_units(units[2:], mid, 2))
    assert tm.n_units == 4
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    units2, head2 = tm.init(torch.Generator().manual_seed(0))
    layers = [len(pat) for pat, n in T.segments_of(tcfg) for _ in range(n)]
    assert [sorted(u) if isinstance(u, dict) else len(u) for u in units2] \
        == [["embed"]] + layers
    assert sorted(head2) == ["final_norm", "head"]


@pytest.mark.parametrize("arch", ARCHS)
def test_units_match_reference(arch):
    _, tcfg, jm, tm, units, head = _setup(arch)
    tu, th = bridge.lm_units_to_torch(units, head)
    back_u, back_h = bridge.lm_units_to_numpy(tu, th)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(units + [head]), jax.tree.leaves(back_u + [back_h])))
    toks = _tokens(tcfg)
    x, y = toks[:, :-1], toks[:, 1:]
    jsm = jm.apply_units(units[:2], jnp.asarray(x), 0)
    jfe = jm.apply_units(units[2:], jsm, 2)
    jloss, jlogits = jm.head_loss(head, jfe, jnp.asarray(y))
    with torch.no_grad():
        tsm = tm.apply_units(tu[:2], torch.from_numpy(x.astype(np.int64)), 0)
        tfe = tm.apply_units(tu[2:], tsm, 2)
        tloss, tlogits = tm.head_loss(th, tfe,
                                      torch.from_numpy(y.astype(np.int64)))
    np.testing.assert_allclose(tsm.numpy(), np.asarray(jsm), rtol=FEAT_TOL,
                               atol=FEAT_TOL)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=FEAT_TOL, atol=FEAT_TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_profile_matches_reference(arch, reduced):
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    jc, tc = jax_config(arch), get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    a = dataclasses.asdict(JU.TransformerUnitModel(jc).profile())
    b = dataclasses.asdict(TU.TransformerUnitModel(tc).profile())
    assert a.keys() == b.keys() and a["name"] == b["name"]
    for key in a:
        if key != "name":
            np.testing.assert_allclose(np.asarray(b[key], np.float64),
                                       np.asarray(a[key], np.float64),
                                       rtol=1e-12, err_msg=key)


# ------------------------------------------------------ the engines
def _federation_sims(arch, wire):
    """The reference's and the port's FederationSim (sfl, cut 2, 3
    vehicles, one sgd round) from the same units and data; returns (ref
    sim, ref metrics, port sim, port metrics)."""
    jcfg, tcfg, jm, tm, units, head = _setup(arch)
    kw = dict(scheme="sfl", cut=2, n_clients=3, batch_size=4, local_steps=2,
              lr=1e-2, rounds=1, optimizer="sgd", wire=wire)
    jc, jt = JR.make_lm_fleet_data(3, 8, 16, 0, tcfg.vocab_size)
    tc, tt = TR.make_lm_fleet_data(3, 8, 16, 0, tcfg.vocab_size)
    js = JF.FederationSim(jm, jc, jt, JF.SimConfig(**kw))
    js.units, js.head = (list(map(lambda u: jax.tree.map(jnp.asarray, u),
                                  units)), jax.tree.map(jnp.asarray, head))
    ts = TF.FederationSim(tm, tc, tt, TF.SimConfig(**kw), device="cpu")
    ts.set_params(*bridge.lm_units_to_torch(units, head))
    (a,), (b,) = js.run(), ts.run()
    assert a.cuts == b.cuts == [2, 2, 2]
    assert b.comm_bytes == a.comm_bytes
    assert b.sim_time_s == pytest.approx(a.sim_time_s, rel=1e-12)
    np.testing.assert_allclose(b.loss, a.loss, rtol=LOSS_RTOL)
    assert 0.0 <= b.test_acc <= 1.0
    assert b.test_acc == pytest.approx(a.test_acc, abs=1 / 128)
    return js, a, ts, b


def _unit_drift(js, ts):
    """Per unit (embedding, periods, then the head) the largest absolute
    difference of the port's parameters from the reference's."""
    pu, ph = bridge.lm_units_to_numpy(ts.units, ts.head)
    out = []
    for ju, tu in zip(list(js.units) + [js.head], list(pu) + [ph]):
        out.append(max(float(np.abs(np.asarray(x) - y).max()) for x, y in
                       zip(jax.tree.leaves(ju), jax.tree.leaves(tu))))
    return out


# smollm / mamba2 on both wires; gemma3 / recurrentgemma on the dense wire
# (on topk_int8 see the test after this one)
@pytest.mark.parametrize("wire,arch", [
    (w, a) for w in ("none", "topk_int8") for a in ARCHS
    if w == "none" or a in ("smollm-360m", "mamba2-780m")])
def test_federation_sim_sfl_matches_reference(arch, wire):
    js, _, ts, _ = _federation_sims(arch, wire)
    assert max(_unit_drift(js, ts)) <= PARAM_TOL


@pytest.mark.parametrize("arch", ["gemma3-4b", "recurrentgemma-2b"])
def test_federation_sim_sfl_topk_int8_rsu_side_matches_reference(
        arch, record_property):
    """On ``topk_int8`` the codec sits between float32 sums taken in
    another order on the two sides: a top-k choice or an int8 step that
    flips moves the gradient the vehicle receives by a whole quantization
    step, so the vehicle's units drift by more than float32 rounding
    (measured 3.7e-5 for gemma3, 1.6e-4 for recurrentgemma, against 1e-6
    on the dense wire).  Cuts, bytes, time, loss and accuracy are held as
    on the dense wire, the RSU's units and the head to PARAM_TOL; the
    vehicle side's drift is recorded and held finite."""
    js, _, ts, _ = _federation_sims(arch, "topk_int8")
    drift = _unit_drift(js, ts)
    cut = 2                     # the embedding and one period on a vehicle
    record_property("vehicle_drift", max(drift[:cut]))
    assert all(np.isfinite(drift))
    assert max(drift[cut:]) <= PARAM_TOL


def _single_rsu_spec(arch, mode):
    return api.ExperimentSpec(
        model=arch,
        train=api.TrainConfig(rounds=1, local_steps=2, batch_size=4,
                              optimizer="sgd", lr=1e-2, wire="topk_int8"),
        fleet=api.FleetConfig(n_vehicles=4, per_vehicle_samples=8,
                              test_samples=16),
        runtime=api.RuntimeConfig(cohort_parallel=mode))


@pytest.mark.parametrize("arch", ARCHS)
def test_api_run_single_rsu_vmap_equals_unroll(arch):
    runs = {mode: api.run(_single_rsu_spec(arch, mode), device="cpu")
            for mode in ("unroll", "vmap")}
    a, b = runs["unroll"], runs["vmap"]
    assert b.diagnostics["mode"] == "vmap"
    # the reduced config's deepest cut (the paper rule on these rates)
    deepest = TR.model_entry(arch).n_units - 1
    assert a.history[0].cuts == b.history[0].cuts == [deepest] * 4
    assert np.isfinite(a.history[0].loss)
    assert 0.0 <= a.history[0].test_acc <= 1.0
    assert a.history[0].loss == pytest.approx(b.history[0].loss, rel=1e-6)
    assert a.diagnostics["wire_bytes"] == b.diagnostics["wire_bytes"] > 0
    units, head = a.final_params
    ref_units, ref_head = JU.TransformerUnitModel(
        lm_configs(arch)[0]).init(jax.random.PRNGKey(0))
    assert [x.shape for x in jax.tree.leaves([units, head])] == \
        [x.shape for x in jax.tree.leaves([ref_units, ref_head])]


@pytest.mark.parametrize("arch", ARCHS)
def test_api_run_trace_replay(arch):
    spec = api.ExperimentSpec(
        model=arch,
        train=api.TrainConfig(rounds=2, local_steps=1, batch_size=4,
                              optimizer="sgd", lr=1e-2, wire="topk_int8"),
        fleet=api.FleetConfig(n_vehicles=3, scenario="trace_replay",
                              scenario_kwargs={"n_steps": 10},
                              cloud_sync_every=1, per_vehicle_samples=8,
                              test_samples=16),
        runtime=api.RuntimeConfig(seed=7, precompile=False))
    res = api.run(spec, device="cpu")
    assert res.engine_kind == TR.SCENARIO
    for m in res.history:
        assert np.isfinite(m.loss) and 0.0 <= m.test_acc <= 1.0
        assert set(m.cuts) <= set(range(TR.model_entry(arch).n_units))
    assert res.diagnostics["client_batch_steps"] > 0


def test_registry_holds_the_ported_text_archs():
    """Every text arch of the reference is registered as the reference
    registers it: the float32 and bfloat16 ones, and the MLA / MoE archs
    since their training was ported; none is refused as "not ported
    yet"."""
    moe = ["deepseek-v2-lite-16b", "dbrx-132b"]
    for arch in ARCHS + BF16_ARCHS + moe:
        a, b = JR.model_entry(arch), TR.model_entry(arch)
        assert (b.name, b.n_units, b.description) == \
            (a.name, a.n_units, a.description)
        from repro_torch.configs import get_config
        assert b.build().cfg == get_config(arch).reduced()
        assert b.build().n_units == a.build().n_units == b.n_units
        assert b.build(reduced=False).n_units == \
            a.build(reduced=False).n_units
        jc, jt = a.make_data(3, 5, 7, 1)
        tc, tt = b.make_data(3, 5, 7, 1)
        for x, y in zip(jc, tc):
            assert np.array_equal(x.images, y.images)
            assert np.array_equal(x.labels, y.labels)
        assert np.array_equal(np.asarray(jt["images"]), tt["images"])
        assert np.array_equal(np.asarray(jt["labels"]), tt["labels"])
    text = [k for k, e in JR.MODELS.items()
            if k not in ("resnet18", "mlp9")]
    assert sorted(k for k in TR.MODELS if k not in ("resnet18", "mlp9")) \
        == sorted(text) == sorted(ARCHS + BF16_ARCHS + moe)
    assert TR.NOT_PORTED_MODELS == ()
    with pytest.raises(ValueError, match="not ported yet"):
        TR.model_entry("no-such-arch")
