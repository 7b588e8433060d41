"""MLA training (deepseek-v2-lite-16b's mixer) against the JAX package on
the CPU, at the reduced MLA dims (kv_lora_rank 64, nope 32, rope 16, v 32):
``mla_train``'s gradients in every parameter -- ``kv_norm``'s scale (the
rmsnorm Function's backward over the latent) among them -- and in its
input, against ``jax.grad`` of the reference's ``mla_train`` at two
sequence lengths, each within GRAD_RTOL of the leaf's largest value (the
float32 sums of two frameworks in another order; PERF.md section 2,
"Training parity"); and remat on = remat off: ``mla_train`` under
``torch.utils.checkpoint`` and a whole deepseek-smoke stack (MLA + MoE
periods, the aux loss out of each checkpointed period) give the same
gradients, the router's included, within REMAT_RTOL of each leaf's
largest (the recompute runs the same ops; CPU reductions over several
threads may reorder).  Parameters come from the reference's threefry init
(``kv_norm`` given a non-unit scale); inputs are numpy draws."""
import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from _torch_parity import (assert_grads_close, cap_torch_threads,
                           grads_vs_jax, jax_lm_params, lm_configs,
                           lm_train_batch)
from repro.models import mla as JM
from repro_torch import bridge
from repro_torch.core import distributed as D
from repro_torch.models import mla as M
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

cap_torch_threads()

GRAD_RTOL = 1e-5    # of each leaf's largest value
REMAT_RTOL = 1e-6
ARCH = "deepseek-v2-lite-16b"


def _setup(seed=0):
    jcfg, tcfg = lm_configs(ARCH)
    p = jax.tree.map(np.asarray, JM.init_mla(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    p["kv_norm"]["scale"] = (1 + 0.2 * rng.normal(
        size=(jcfg.mla.kv_lora_rank,))).astype(np.float32)
    return jcfg, tcfg, p


def _x(cfg, s, seed, b=2):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("s", [16, 37])
def test_mla_train_gradients_match_jax_grad(s):
    """Every parameter's gradient (wq, w_dkv, w_kr, kv_norm, w_uk, w_uv,
    wo) and the input's, of sum(w * mla_train(p, x)) with a fixed numpy w:
    within GRAD_RTOL of each leaf's largest value; the outputs within it
    too."""
    jcfg, tcfg, p = _setup(s)
    x = _x(jcfg, s, s + 1)
    pos_j = np.arange(s, dtype=np.int32)
    pos_t = torch.arange(s, dtype=torch.int32)
    tout, jout, got, want = grads_vs_jax(
        lambda pp, xx: JM.mla_train(pp, jcfg, xx, pos_j),
        lambda pp, xx: M.mla_train(pp, tcfg, xx, pos_t), (p, x))
    big = float(np.abs(jout).max())
    np.testing.assert_allclose(tout, jout, rtol=0, atol=GRAD_RTOL * big)
    assert len(got) == len(want) == 8         # 7 parameters and x
    assert_grads_close(got, want, GRAD_RTOL)
    kv = [i for i, (path, _) in enumerate(
        jax.tree_util.tree_leaves_with_path((p, x)))
        if "kv_norm" in jax.tree_util.keystr(path)]
    assert len(kv) == 1 and float(got[kv[0]].abs().max()) > 0


def _grads(fn, args, w):
    req = [a.detach().clone().requires_grad_() for a in args]
    out = fn(*req)
    return torch.autograd.grad((out * w).sum(), req)


def test_mla_train_under_remat_equals_without():
    """``mla_train`` inside ``torch.utils.checkpoint`` (recomputed in the
    backward, as a remat'd period runs it) against the plain call: the
    same gradients in x and every parameter."""
    _, tcfg, p = _setup(3)
    leaves = [torch.from_numpy(np.array(a)) for a in jax.tree.leaves(p)]
    treedef = jax.tree.structure(p)
    x = torch.from_numpy(_x(tcfg, 23, 4))
    pos = torch.arange(23, dtype=torch.int32)

    def fn(xx, *ls):
        return M.mla_train(jax.tree.unflatten(treedef, ls), tcfg, xx, pos)

    w = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 23, tcfg.d_model)).astype(np.float32))
    plain = _grads(fn, [x] + leaves, w)
    remat = _grads(lambda *a: checkpoint(fn, *a, use_reentrant=False),
                   [x] + leaves, w)
    assert_grads_close(list(remat), [g.numpy() for g in plain], REMAT_RTOL)


def test_deepseek_stack_under_remat_equals_without():
    """The train step's objective (ce + both sides' aux) and gradients of
    deepseek-v2-lite-16b-smoke grown to 3 layers (two MLA + MoE periods and
    the MLA + dense tail; cut 1) with remat on and off: the loss, ce and
    aux within REMAT_RTOL, every gradient within REMAT_RTOL of its leaf's
    largest; the routers' gradients are nonzero, and so is the gradient of
    the aux alone through a checkpointed period (it reaches the router
    through the recompute)."""
    jcfg, tcfg = lm_configs(ARCH, n_layers=3)
    params = bridge.lm_params_to_torch(jax_lm_params(jcfg), tcfg)
    batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
             else torch.from_numpy(v)
             for k, v in lm_train_batch(tcfg, s=16).items()}
    out = {}
    for remat in (True, False):
        grads, leaves, rebuild, m = D.loss_and_grads(
            tcfg, D.DistOptions(cut=1, remat=remat), params, batch)
        out[remat] = (grads, m)
    (g_on, m_on), (g_off, m_off) = out[True], out[False]
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m_on[key]), float(m_off[key]),
                                   rtol=REMAT_RTOL)
    assert float(m_on["aux"]) > 0
    assert_grads_close(g_on, [g.numpy() for g in g_off], REMAT_RTOL)
    routers = [layer["ffn"]["router"] for period in
               rebuild(g_on)["segments"][0] for layer in period]
    assert len(routers) == 2 and all(float(r.abs().max()) > 0
                                     for r in routers)
    # the aux alone, out of one checkpointed period, into its router
    period = params["segments"][0][0]
    router = period[0]["ffn"]["router"]
    x = torch.from_numpy(_x(tcfg, 16, 8))
    pos = torch.arange(16, dtype=torch.int32)
    aux_grads = []
    for remat in (True, False):
        r = router.detach().clone().requires_grad_()
        layer = dict(period[0], ffn=dict(period[0]["ffn"], router=r))
        _, aux, _ = T._scan_segment([(layer,)], tcfg, tcfg.pattern, x,
                                    "train", pos, None, 0, remat=remat)
        aux_grads.append(torch.autograd.grad(aux, r)[0])
    assert float(aux_grads[0].abs().max()) > 0
    assert_grads_close([aux_grads[0]], [aux_grads[1].numpy()], REMAT_RTOL)
    assert len(tree_leaves(params)) == len(g_on)
