"""MoE training (deepseek-v2-lite-16b's and dbrx-132b's FFN) against the JAX
package on the CPU.

- ``moe_forward``'s gradients in every parameter (the float32 router, the
  experts, the shared expert) and in its input against ``jax.grad`` of the
  reference's, of sum(w * y) plus the aux load-balance loss and of the aux
  alone: on the dense all-experts path (a zero router too, where every
  probability ties and both top-k's pick the lowest experts), and on the
  grouped GShard path with capacity drops, reached by setting
  ``DENSE_PATH_MAX_ELEMENTS`` to 0 on both modules, at capacity factors 0.5
  and 1.25 (one and two groups): each leaf within GRAD_RTOL of its largest
  value, the kept (token, choice) slots exactly the reference's, and no
  gradient reaching a dropped slot's gate.
- The sync-SFL train step (``make_train_step``, cut 1) of
  deepseek-v2-lite-16b-smoke (an MLA + MoE period and the MLA + dense
  tail) and of a float32 replica of dbrx-132b-smoke (``attn_moe``, three
  periods), against the reference's jitted step from the same weights and
  batches: sgd with and without clipping and int8 smashed data, loss (ce +
  aux) within LOSS_RTOL, ``metrics["aux"]`` within AUX_TOL, parameters
  within PARAM_TOL of the largest; deepseek also on the grouped path with
  drops; adamw over three steps, losses within ADAMW_LOSS_TOL.

dbrx-132b-smoke in bfloat16 is held in ``test_torch_lm_train_moe_bf16.py``,
the MoE archs in ``FederationSim`` and ``api.run`` in
``test_torch_lm_fed_moe.py``.

The tolerances are those of PERF.md section 2, "Training parity".
Parameters come from the reference's threefry init and cross through
``repro_torch.bridge``; inputs and batches are numpy draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_grads_close, assert_params_within,
                           cap_torch_threads, grads_vs_jax, jax_lm_params,
                           lm_configs, lm_train_batch, run_train_steps)
from repro.configs.dbrx_132b import CONFIG as JDBRX
from repro.models import moe as JE
from repro_torch.configs.dbrx_132b import CONFIG as TDBRX
from repro_torch.models import moe as E
from test_torch_moe import _ref_keep

cap_torch_threads()

GRAD_RTOL = 1e-5        # of each leaf's largest value
LOSS_RTOL = 1e-5
AUX_TOL = 1e-6
PARAM_TOL = 1e-5        # of the largest parameter
ADAMW_LOSS_TOL = 1e-4
SGD_LR = 1e-2
DEEPSEEK = "deepseek-v2-lite-16b"


def _moe_configs(**moe):
    jcfg, tcfg = lm_configs(DEEPSEEK)
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
                 for c in (jcfg, tcfg))


def _moe_params(jcfg, seed):
    return jax.tree.map(np.asarray, JE.init_moe(jax.random.PRNGKey(seed),
                                                jcfg))


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _objectives(jcfg, tcfg, with_y, n_groups=None):
    """(reference fn, port fn) of (p, x) -> [y.ravel(), aux] (``with_y``),
    or -> [aux]: ``grads_vs_jax`` weighs each entry by a fixed draw."""
    def jfn(p, x):
        y, aux = JE.moe_forward(p, jcfg, x, n_groups)
        return (jnp.concatenate([y.ravel(), aux[None]]) if with_y
                else aux[None])

    def tfn(p, x):
        y, aux = E.moe_forward(p, tcfg, x, n_groups)
        aux = torch.as_tensor(aux).reshape(1)
        return torch.cat([y.reshape(-1), aux]) if with_y else aux
    return jfn, tfn


@pytest.mark.parametrize("with_y", [True, False], ids=["y_and_aux", "aux"])
@pytest.mark.parametrize("router", ["random", "zero"])
def test_dense_path_gradients_match_jax_grad(router, with_y):
    """The dense path (every expert on every token): gradients in the
    router, the experts, the shared expert and x.  A zero router makes
    every probability 1/E: the top-k of both packages takes experts
    0..k-1 and sends the gradient there."""
    jcfg, tcfg = _moe_configs()
    p = _moe_params(jcfg, 1)
    if router == "zero":
        p["router"] = np.zeros_like(p["router"])
    x = _x((2, 9, jcfg.d_model), 2)
    assert E.uses_dense_path(tcfg, 18)
    tout, jout, got, want = grads_vs_jax(*_objectives(jcfg, tcfg, with_y),
                                         (p, x))
    np.testing.assert_allclose(tout, jout, rtol=1e-6, atol=1e-6)
    assert_grads_close(got, want, GRAD_RTOL)
    if not with_y:    # the aux reaches the router (and x) alone
        leaves = jax.tree_util.tree_leaves_with_path((p, x))
        for (path, _), g in zip(leaves, got):
            key = jax.tree_util.keystr(path)
            if "router" in key:
                assert float(g.abs().max()) > 0.0
            elif key != "[1]":
                assert float(g.abs().max()) == 0.0, key


@pytest.mark.parametrize("with_y", [True, False], ids=["y_and_aux", "aux"])
@pytest.mark.parametrize("cf,groups", [(0.5, None), (0.5, 2), (1.25, 2)])
def test_grouped_path_gradients_match_jax_grad(monkeypatch, cf, groups,
                                               with_y):
    """The grouped GShard path, the dense budget 0 on both modules, 600
    tokens in one group or two: gradients as on the dense path; the kept
    slots exactly the reference's (drops at capacity factor 0.5); a
    dropped slot's gate gets no gradient."""
    monkeypatch.setattr(JE, "DENSE_PATH_MAX_ELEMENTS", 0)
    monkeypatch.setattr(E, "DENSE_PATH_MAX_ELEMENTS", 0)
    kept = []
    grouped = E._experts_grouped

    def spy(*args):
        y, keep = grouped(*args)
        kept.append(keep)
        return y, keep
    monkeypatch.setattr(E, "_experts_grouped", spy)
    jcfg, tcfg = _moe_configs(capacity_factor=cf)
    p = _moe_params(jcfg, 3)
    x = _x((2, 300, jcfg.d_model), 4)
    tout, jout, got, want = grads_vs_jax(
        *_objectives(jcfg, tcfg, with_y, groups), (p, x))
    np.testing.assert_allclose(tout, jout, rtol=1e-6, atol=1e-6)
    assert_grads_close(got, want, GRAD_RTOL)
    g = groups or E._pick_groups(600)
    m = tcfg.moe
    cap = E.capacity(600, tcfg) if groups is None else max(
        4, min(int(np.ceil(600 // g * m.top_k / m.n_experts * cf)), 600 // g))
    _, _, ji, _, _ = JE._route(p, jcfg, jnp.asarray(x.reshape(600, -1)))
    assert len(kept) == 1 and kept[0].shape == (g, 600 // g, m.top_k)
    np.testing.assert_array_equal(kept[0].numpy(),
                                  _ref_keep(np.asarray(ji), m.n_experts,
                                            cap, g))
    if cf < 1:
        assert 0 < int(kept[0].sum()) < kept[0].numel()
    # no gradient reaches a dropped slot's gate
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    xt = torch.from_numpy(x.reshape(600, -1))
    _, gates, idx, _ = E._route(tp, tcfg, xt)
    gates = gates.detach().requires_grad_()
    y, keep = grouped(tp, tcfg, xt, gates, idx, groups)
    (dg,) = torch.autograd.grad((y * torch.from_numpy(
        _x(tuple(y.shape), 5))).sum(), gates)
    dg = dg.reshape(keep.shape)
    assert bool((dg[~keep] == 0).all())
    assert float(dg[keep].abs().max()) > 0.0


# ------------------------------------------------------------ the train step
def _step_configs(name):
    """(reference cfg, port cfg): deepseek's smoke config (an MLA + MoE
    period and the tail), or dbrx-smoke grown to three periods in
    float32."""
    if name == "deepseek-smoke":
        return lm_configs(DEEPSEEK)
    return tuple(dataclasses.replace(c.reduced(), n_layers=3,
                                     param_dtype="float32")
                 for c in (JDBRX, TDBRX))


def _aux_close(jm, tm):
    for a, b in zip(jm, tm):
        assert float(b["aux"]) > 0
        np.testing.assert_allclose(float(b["aux"]), float(a["aux"]),
                                   rtol=0, atol=AUX_TOL)
        np.testing.assert_allclose(float(b["ce"]), float(a["ce"]),
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("clip,compress", [(0.0, False), (1.0, False),
                                           (1.0, True)])
@pytest.mark.parametrize("name", ["deepseek-smoke", "dbrx-smoke-f32"])
def test_sgd_train_step_matches_reference(name, clip, compress):
    jcfg, tcfg = _step_configs(name)
    params = jax_lm_params(jcfg)
    jl, tl, jp, tp, jm, tm = run_train_steps(
        jcfg, tcfg, params, 1, lambda i: lm_train_batch(tcfg, s=16, seed=i),
        optimizer="sgd", learning_rate=SGD_LR, grad_clip=clip,
        compress_smashed=compress)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _aux_close(jm, tm)
    assert_params_within(jp, tp, PARAM_TOL)
    if clip:
        np.testing.assert_allclose(float(tm[0]["grad_norm"]),
                                   float(jm[0]["grad_norm"]), rtol=1e-4)


def test_sgd_train_step_on_the_grouped_path_matches_reference(monkeypatch):
    """deepseek-smoke's train step with the dense budget 0 on both
    modules: the grouped path with capacity factor 0.5 drops slots in the
    step's forward and its remat recompute alike."""
    monkeypatch.setattr(JE, "DENSE_PATH_MAX_ELEMENTS", 0)
    monkeypatch.setattr(E, "DENSE_PATH_MAX_ELEMENTS", 0)
    kept = []
    grouped = E._experts_grouped

    def spy(*args):
        y, keep = grouped(*args)
        kept.append(keep)
        return y, keep
    monkeypatch.setattr(E, "_experts_grouped", spy)
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=0.5)) for c in lm_configs(DEEPSEEK))
    params = jax_lm_params(jcfg)
    jl, tl, jp, tp, jm, tm = run_train_steps(
        jcfg, tcfg, params, 1, lambda i: lm_train_batch(tcfg, s=16, seed=i),
        optimizer="sgd", learning_rate=SGD_LR, grad_clip=0.0)
    assert len(kept) == 2 and torch.equal(kept[0], kept[1])   # remat
    assert 0 < int(kept[0].sum()) < kept[0].numel()
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _aux_close(jm, tm)
    assert_params_within(jp, tp, PARAM_TOL)


@pytest.mark.parametrize("name", ["deepseek-smoke", "dbrx-smoke-f32"])
def test_adamw_train_trajectory_matches_reference(name):
    jcfg, tcfg = _step_configs(name)
    params = jax_lm_params(jcfg)
    jl, tl, _, _, jm, tm = run_train_steps(
        jcfg, tcfg, params, 3, lambda i: lm_train_batch(tcfg, s=16, seed=i))
    assert max(abs(a - b) for a, b in zip(jl, tl)) <= ADAMW_LOSS_TOL
    _aux_close(jm, tm)
