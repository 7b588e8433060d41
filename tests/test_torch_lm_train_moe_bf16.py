"""dbrx-132b-smoke in bfloat16 (its MoE router float32) trained against the
JAX package on the CPU, held as the bfloat16 archs are
(``tests/test_torch_lm_train_bf16.py``, whose three checks and BF16_ULPS
it uses): one step's loss (ce + aux) and every gradient, and the step
losses and parameters after 1 sgd / 3 adamw steps, three ways against the
reference run in float32 on the same bfloat16-valued weights.  The
routing of the three sides is compared first and recorded, a token routed
apart held to a near tie.  Parameters come from the reference's threefry
init and cross through ``repro_torch.bridge``; batches are numpy draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (cap_torch_threads, jax_lm_params, lm_train_batch,
                           run_train_steps)
from repro.configs.dbrx_132b import CONFIG as JDBRX
from repro.models import moe as JE
from repro_torch import bridge
from repro_torch.configs.dbrx_132b import CONFIG as TDBRX
from repro_torch.models import moe as E
from test_torch_lm_train_bf16 import BF16_ULPS, _bf16_ulp, _f32, _three_way

cap_torch_threads()

SGD_LR = 1e-2
NEAR_TIE_ULPS = 2       # a routing flip's k-th / (k+1)-th gap, bfloat16


_BF16 = {}


def _dbrx_bf16():
    """(reference bf16 cfg, port bf16 cfg, reference f32 cfg, numpy bf16
    params with the float32 router, the same values in float32), once."""
    if not _BF16:
        jcfg, tcfg = JDBRX.reduced(), TDBRX.reduced()
        j32 = dataclasses.replace(jcfg, param_dtype="float32")
        params = jax_lm_params(jcfg)
        dtypes = {jax.tree_util.keystr(k): a.dtype.name for k, a in
                  jax.tree_util.tree_leaves_with_path(params)}
        assert {d for k, d in dtypes.items() if "router" in k} == \
            {"float32"}
        assert {d for k, d in dtypes.items() if "router" not in k} == \
            {"bfloat16"}
        p32 = jax.tree.map(lambda a: a.astype(np.float32), params)
        _BF16.update(cfgs=(jcfg, tcfg, j32), params=params, p32=p32)
    return _BF16


def _dbrx_batch(seed):
    return lm_train_batch(TDBRX.reduced(), b=4, s=32, seed=seed)


def _routings(monkeypatch, seed):
    """The expert choices of one train-mode forward of the whole model on
    the three sides, per MoE call: (port bf16, reference bf16, reference
    f32); the reference's recorded through an ordered
    ``jax.debug.callback`` (its periods run under ``lax.scan``)."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as T
    batch = _dbrx_batch(seed)
    jcfg, tcfg, j32 = _dbrx_bf16()["cfgs"]
    sink = []
    real_j, real_t = JE._route, E._route

    def jspy(p, cfg, xt):
        res = real_j(p, cfg, xt)
        jax.debug.callback(lambda pr, idx: sink[-1].append(
            (np.asarray(pr), np.asarray(idx))), res[0], res[2], ordered=True)
        return res

    def tspy(p, cfg, xt):
        res = real_t(p, cfg, xt)
        sink[-1].append((res[0].numpy(), res[2].numpy()))
        return res
    monkeypatch.setattr(JE, "_route", jspy)
    monkeypatch.setattr(E, "_route", tspy)
    sink.append([])
    T.forward(bridge.lm_params_to_torch(_dbrx_bf16()["params"], tcfg), tcfg,
              {"tokens": torch.from_numpy(batch["tokens"]).long()}, "train")
    for cfg, key in ((jcfg, "params"), (j32, "p32")):
        sink.append([])
        JT.forward(jax.tree.map(jnp.asarray, _dbrx_bf16()[key]), cfg,
                   {"tokens": jnp.asarray(batch["tokens"])}, "train")
        jax.effects_barrier()
    monkeypatch.setattr(JE, "_route", real_j)
    monkeypatch.setattr(E, "_route", real_t)
    return sink


def test_dbrx_smoke_bf16_routing_is_the_same_three_ways(monkeypatch,
                                                        record_property):
    """Every MoE layer's expert choices for the batches of the tests
    below, on the three sides, against the reference in bfloat16: the
    (token, choice) slots that differ and the tokens whose set of experts
    differs are recorded; each such token must be a near tie, its k-th
    and (k+1)-th probabilities on the reference's side within
    NEAR_TIE_ULPS ulps of bfloat16 (the port's and the reference's
    bfloat16 activations round at other places, and a flip at a clear
    margin would be a fault).  Measured when first run: one token of 384
    on the port (seed 1, a gap of 0.22 ulps), none for the reference in
    float32; the train steps below take it within their bounds.  A token
    whose top two nearly tie may also list the same experts in the other
    order: on the dense path these smokes take, that is the same gated
    sum."""
    k = TDBRX.reduced().moe.top_k
    for seed in range(3):
        port, ref, ref32 = _routings(monkeypatch, seed)
        assert len(port) == len(ref) == len(ref32) == TDBRX.reduced().n_layers
        for side, got in (("port", port), ("ref_f32", ref32)):
            order = sum(int((a != b).sum())
                        for (_, a), (_, b) in zip(got, ref))
            apart = 0
            for (_, a), (probs, b) in zip(got, ref):
                for t in np.where((np.sort(a, -1) != np.sort(b, -1)).any(
                        -1))[0]:
                    top = np.sort(probs[t])[::-1]
                    gap = float(top[k - 1] - top[k])
                    assert gap <= NEAR_TIE_ULPS * _bf16_ulp(
                        float(top[k - 1])), (side, seed, t, top)
                    apart += 1
            record_property(f"{side}_seed{seed}_slots_apart", order)
            record_property(f"{side}_seed{seed}_tokens_routed_apart", apart)


def _value_and_grad_ref(jcfg):
    """The reference train step's loss (ce + aux), jitted with its
    gradient."""
    from repro.core import distributed as JD
    from repro.core import split as JSP

    def loss_fn(params, batch):
        client, server = JSP.split_params(params, jcfg, 1)
        smashed, positions, aux_c, _ = JSP.client_forward(
            client, jcfg, batch, 1, "train")
        logits, aux_s, _ = JSP.server_forward(server, jcfg, smashed,
                                              positions, 1, "train")
        return (JD.weighted_ce(logits, batch["labels"], batch["weights"],
                               jcfg.vocab_size) + aux_c + aux_s)

    return jax.jit(jax.value_and_grad(loss_fn))


def test_dbrx_smoke_bf16_loss_and_gradients_three_way(record_property):
    """One step's loss (ce + aux) and every gradient (bfloat16, the
    router's float32), three ways within BF16_ULPS of bfloat16."""
    from repro_torch.core import distributed as D
    jcfg, tcfg, j32 = _dbrx_bf16()["cfgs"]
    batch = _dbrx_batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rl, rg = _value_and_grad_ref(jcfg)(
        jax.tree.map(jnp.asarray, _dbrx_bf16()["params"]), jb)
    fl, fg = _value_and_grad_ref(j32)(
        jax.tree.map(jnp.asarray, _dbrx_bf16()["p32"]), jb)
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in batch.items()}
    grads, _, rebuild, m = D.loss_and_grads(
        tcfg, D.DistOptions(cut=1),
        bridge.lm_params_to_torch(_dbrx_bf16()["params"], tcfg), tb)
    pg = bridge.lm_params_to_numpy(rebuild(grads), tcfg)
    assert jax.tree.structure(pg) == jax.tree.structure(rg)
    assert float(m["aux"]) > 0
    _three_way([np.float32(m["loss"])], [np.float32(rl)], [np.float32(fl)],
               "loss", record_property, rms=False)
    _three_way(_f32(pg), _f32(rg), _f32(fg), "grads", record_property)


@pytest.mark.parametrize("opt,steps", [("sgd", 1), ("adamw", 3)])
def test_dbrx_smoke_bf16_train_steps_three_way(opt, steps, record_property):
    """The port's train step (bfloat16 parameters, the router and the
    moments float32) and the reference's from the same weights, and the
    reference in float32 on their values: the step losses and the
    parameters after the steps, three ways."""
    from repro.core import distributed as JD
    jcfg, tcfg, j32 = _dbrx_bf16()["cfgs"]
    params, p32 = _dbrx_bf16()["params"], _dbrx_bf16()["p32"]
    opts = (dict(optimizer="sgd", learning_rate=SGD_LR, grad_clip=0.0)
            if opt == "sgd" else {})
    jl, tl, jp, tp, _, _ = run_train_steps(jcfg, tcfg, params, steps,
                                           _dbrx_batch, **opts)
    jopts = JD.DistOptions(cut=1, **opts)
    step = jax.jit(JD.make_train_step(j32, jopts))
    state = {"params": jax.tree.map(jnp.asarray, p32),
             "opt": JD.make_optimizer(jopts).init(p32),
             "step": jnp.zeros((), jnp.int32)}
    fl = []
    for i in range(steps):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in _dbrx_batch(i).items()})
        fl.append(float(m["loss"]))
    dtypes = {jax.tree_util.keystr(k): a.dtype.name for k, a in
              jax.tree_util.tree_leaves_with_path(tp)}
    assert {d for k, d in dtypes.items() if "router" not in k} == \
        {"bfloat16"}
    assert {d for k, d in dtypes.items() if "router" in k} == {"float32"}
    _three_way([np.float32(a) for a in tl], [np.float32(a) for a in jl],
               [np.float32(a) for a in fl], "losses", record_property,
               rms=False)
    _three_way(_f32(tp), _f32(jp), _f32(state["params"]), "params",
               record_property)
    assert BF16_ULPS == 8
