"""The ``"dots"`` remat policy (``models.transformer.set_remat_policy``),
the reference's ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
on each checkpointed period: the outputs of matrix products without batch
dims are saved, everything else is recomputed.

- Under ``"dots"`` the port's loss and gradients equal full recompute's
  bit for bit (smollm-360m, mamba2-780m and deepseek-v2-lite-16b (MLA,
  MoE) at their ``-smoke`` widths), and its backward runs no product of
  the forward that has no batch dims again, where full recompute runs them
  (the products counted by ``chip_smoke._gemm_spy``, as the card's check
  counts them).
- Its gradients are within GRAD_TOL of each leaf's largest of ``jax.grad``
  of the reference's ``loss_fn(remat=True)`` under its own
  ``set_remat_policy("dots")`` (smollm, mamba2).

The policy is reset after each test in both packages.  Parameters come
from the port's init and cross to the reference through
``repro_torch.bridge``; batches are numpy draws."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_grads_close, cap_torch_threads,
                           lm_batch_to_torch, lm_configs, lm_train_batch)
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.models import transformer as T
from repro_torch.tree import tree_flatten

cap_torch_threads()

GRAD_TOL = 1e-5


def _chip_smoke():
    """The repo's ``chip_smoke.py`` as a module, for its product spy."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


@pytest.fixture(autouse=True)
def _reset_policy():
    yield
    T.set_remat_policy(None)
    JT.set_remat_policy(None)


def _run(tcfg, params, batch, policy):
    """(loss, gradients, the forward's and the backward's recorded
    products) of ``loss_fn(remat=True)`` under ``policy``."""
    T.set_remat_policy(policy)
    leaves, rebuild = tree_flatten(params)
    req = [t.detach().requires_grad_(True) for t in leaves]
    with CS._gemm_spy() as fwd:
        loss, _ = T.loss_fn(rebuild(req), tcfg, batch, remat=True)
    with CS._gemm_spy() as bwd:
        grads = torch.autograd.grad(loss, req)
    return loss.detach(), grads, fwd.calls, bwd.calls, rebuild


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m",
                                  "deepseek-v2-lite-16b"])
def test_dots_equals_full_recompute_and_runs_no_projection_again(arch):
    _, tcfg = lm_configs(arch, n_layers=2)
    params = T.init_params(torch.Generator().manual_seed(0), tcfg)
    batch = lm_batch_to_torch(lm_train_batch(tcfg, b=2, s=16))
    loss_f, g_f, fwd_f, bwd_f, _ = _run(tcfg, params, batch, None)
    loss_d, g_d, fwd_d, bwd_d, _ = _run(tcfg, params, batch, "dots")
    assert torch.equal(loss_f, loss_d)
    assert all(torch.equal(a, b) for a, b in zip(g_f, g_d))
    assert fwd_f == fwd_d
    proj = {c for c in fwd_f if CS._projection(c)}
    assert proj
    assert sum(c in proj for c in bwd_f) > 0
    assert sum(c in proj for c in bwd_d) == 0
    assert len(bwd_f) - len(bwd_d) == sum(c in proj for c in bwd_f)


def test_set_remat_policy_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown remat policy"):
        T.set_remat_policy("everything")
    T.set_remat_policy("dots")
    assert T.REMAT_POLICY == "dots"


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m"])
def test_dots_gradients_match_the_reference_under_dots(arch):
    jcfg, tcfg = lm_configs(arch, n_layers=2)
    params = T.init_params(torch.Generator().manual_seed(1), tcfg)
    nb = lm_train_batch(tcfg, b=2, s=16, seed=2)
    JT.set_remat_policy("dots")
    ref = bridge.lm_params_to_numpy(params, tcfg)
    want = jax.jit(jax.grad(lambda p, b: JT.loss_fn(p, jcfg, b,
                                                    remat=True)[0]))(
        jax.tree.map(jnp.asarray, ref),
        {k: jnp.asarray(v) for k, v in nb.items()})
    _, grads, _, _, rebuild = _run(tcfg, params, lm_batch_to_torch(nb),
                                   "dots")
    got = bridge.lm_params_to_numpy(rebuild(list(grads)), tcfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert_grads_close([torch.from_numpy(np.asarray(a))
                        for a in jax.tree.leaves(got)],
                       jax.tree.leaves(want), GRAD_TOL)
