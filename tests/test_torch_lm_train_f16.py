"""float16 parameters against the JAX package on the CPU (its
``DistOptions.param_dtype`` takes any dtype; its optimizer keeps float32
moments and rounds each update back to the parameter's dtype, as the
port's): smollm-360m, mamba2-780m (the SSD scan on float16 inputs) and
dbrx-132b (MoE, its router float32) at their ``-smoke`` widths in
``param_dtype="float16"``, two layers each, so that cut 1 leaves a layer
on each side; also mamba2-780m-smoke trained in bfloat16 and served in
float16.

The two sides round at other places (the reference's attention scores in
16 bits, the port's flash in float32; the SSD's repeat and the cotangent
sums), so, as ``tests/test_torch_lm_train_bf16.py`` holds bfloat16, each
check is three ways against the reference run in float32 on the same
16-bit-valued weights (``_torch_parity.three_way``):

1. port-f16 against reference-f16 and
2. each of them against that float32 run, within F16_ULPS ulps of float16
   at each leaf's largest |value| of the float32 run (a loss: at its own);
3. the port's RMS error against the float32 run at most RMS_RATIO = 1.5
   times the reference's.

They hold one step's loss (ce + aux) and every gradient, the step losses
and the parameters after one sgd step (lr 1e-2) and after three adamw
steps (lr 3e-4, clip 1.0, weight decay 0.01).  One leaf is held otherwise
after adamw: mamba2's ``conv_b`` starts at zero, so its every value is
adam's update, which normalises each element's gradient to about the
learning rate whatever its size, and elements whose gradient is near zero
move by 16-bit rounding on every side (with these weights the reference's
own float16 run lies 5.5e-4, ~1,150 ulps of float16 at the leaf's largest,
from the float32 one).  A leaf that starts at zero is held, after adamw,
to within ZERO_START_RATIO = 2 times the reference's own largest error
against float32 (read: the port 1.3e-5); its gradient is held at F16_ULPS
in the one-step check like every other.  The port runs its donated
``make_train_step``; the reference its train step's body
(``_torch_parity.ref_train``: the step's objective and gradient jitted once
per config, then ``repro.optim``'s clip, update and ``apply_updates``), so
one compile per config serves every check.  F16_ULPS = 16 was set from
the readings of the first run, rounded up to a power of two: the worst,
over the three archs and all checks, was the reference's own parameters
after three adamw steps at 13.9 ulps from float32 (the port's 11.0 from
the reference's and 10.9 from float32; one step's gradients at most 5.5).
The bfloat16 step of mamba2 keeps the bfloat16 file's 8 ulps.

Serving: mamba2-780m-smoke in float16, prefill and two decode steps at cut
1, its logits three ways within 8 ulps of float16 (the bfloat16 serving
tests' BF16_ULPS).  And the entry points take float16: ``make_train_step``
(donated), ``launch.train.train``, ``TransformerUnitModel`` and a
``FederationSim`` sfl round, ``launch.serve.serve``.

Parameters are the port's float32 init (seed 0) in the reference's layout
(``repro_torch.bridge``), cast to the dtypes the reference's
``init_params`` gives the 16-bit config; batches are numpy draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (cap_torch_threads, f32_leaves,
                           lm_batch_to_torch, lm_configs, lm_params_in,
                           lm_stream, lm_train_batch, ref_loss_and_grad,
                           ref_train, three_way)
from repro.core import distributed as JD
from repro_torch import bridge
from repro_torch.core import distributed as D
from repro_torch.models import transformer as T

cap_torch_threads()

SGD_LR = 1e-2
F16_ULPS = 16
BF16_ULPS = 8
RMS_RATIO = 1.5
ZERO_START_RATIO = 2
ARCHS = ("smollm-360m", "mamba2-780m", "dbrx-132b")
ROWS, SEQ = 4, 16
_cache = {}


def _setup(arch, dtype="float16"):
    """(reference cfg in ``dtype``, port cfg, reference float32 cfg, numpy
    params in ``dtype`` (the MoE router and the SSM's A_log / D / dt_bias
    float32), the same values in float32), once."""
    key = (arch, dtype)
    if arch not in _cache:
        j32, t32 = lm_configs(arch, n_layers=2, param_dtype="float32")
        _cache[arch] = (j32, bridge.lm_params_to_numpy(
            T.init_params(torch.Generator().manual_seed(0), t32), t32))
    if key not in _cache:
        j32, init32 = _cache[arch]
        jcfg, tcfg = lm_configs(arch, n_layers=2, param_dtype=dtype)
        params = lm_params_in(jcfg, init32)
        assert dtype in {a.dtype.name for a in jax.tree.leaves(params)}
        p32 = jax.tree.map(lambda a: a.astype(np.float32), params)
        _cache[key] = (jcfg, tcfg, j32, params, p32)
    return _cache[key]


def _port_train(tcfg, params, steps, batch_fn, **opts):
    """The port's donated train step from numpy ``params``: (losses,
    params as numpy in the reference's layout)."""
    topts = D.DistOptions(cut=1, **opts)
    tparams = bridge.lm_params_to_torch(params, tcfg)
    state = {"params": tparams, "opt": D.make_optimizer(topts).init(tparams),
             "step": torch.zeros((), dtype=torch.int32)}
    step = D.make_train_step(tcfg, topts)
    losses = []
    for i in range(steps):
        state, m = step(state, lm_batch_to_torch(batch_fn(i)))
        losses.append(float(m["loss"]))
    assert {t.dtype for t in jax.tree.leaves(state["opt"].get("m", []))} <= \
        {torch.float32}
    return losses, bridge.lm_params_to_numpy(state["params"], tcfg)


def _batch(arch, seed):
    return lm_train_batch(_setup(arch)[1], b=ROWS, s=SEQ, seed=seed)


@pytest.mark.parametrize("arch", ARCHS)
def test_f16_loss_and_gradients_three_way(arch, record_property):
    """One step's objective (ce + aux) and every gradient, each gradient
    in its parameter's dtype, three ways."""
    jcfg, tcfg, j32, params, p32 = _setup(arch)
    batch = _batch(arch, 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rl, rg = ref_loss_and_grad(jcfg)(jax.tree.map(jnp.asarray, params), jb)
    fl, fg = ref_loss_and_grad(j32)(jax.tree.map(jnp.asarray, p32), jb)
    tparams = bridge.lm_params_to_torch(params, tcfg)
    grads, leaves, rebuild, m = D.loss_and_grads(
        tcfg, D.DistOptions(cut=1), tparams, lm_batch_to_torch(batch))
    assert [g.dtype for g in grads] == [t.dtype for t in leaves]
    pg = bridge.lm_params_to_numpy(rebuild(grads), tcfg)
    assert jax.tree.structure(pg) == jax.tree.structure(rg)
    assert [a.dtype for a in jax.tree.leaves(pg)] == \
        [a.dtype for a in jax.tree.leaves(rg)]
    three_way([np.float32(m["loss"])], [np.float32(rl)], [np.float32(fl)],
              "loss", "float16", F16_ULPS, RMS_RATIO, record_property,
              rms=False)
    three_way(f32_leaves(pg), f32_leaves(rg), f32_leaves(fg), "grads",
              "float16", F16_ULPS, RMS_RATIO, record_property)


@pytest.mark.parametrize("opt,steps", [("sgd", 1), ("adamw", 3)])
@pytest.mark.parametrize("arch", ARCHS)
def test_f16_train_steps_three_way(arch, opt, steps, record_property):
    """The port's donated train step (float16 parameters, float32
    moments) and the reference's from the same weights, and the reference
    in float32 on their values: the step losses and the parameters after
    the steps, three ways; each parameter keeps its dtype."""
    jcfg, tcfg, j32, params, p32 = _setup(arch)
    opts = (dict(optimizer="sgd", learning_rate=SGD_LR, grad_clip=0.0)
            if opt == "sgd" else {})
    batch = lambda i: _batch(arch, i)
    tl, tp = _port_train(tcfg, params, steps, batch, **opts)
    jl, jp = ref_train(jcfg, params, steps, batch, **opts)
    fl, fp = ref_train(j32, p32, steps, batch, **opts)
    assert [a.dtype for a in jax.tree.leaves(tp)] == \
        [a.dtype for a in jax.tree.leaves(params)]
    three_way([np.float32(a) for a in tl], [np.float32(a) for a in jl],
              [np.float32(a) for a in fl], "losses", "float16", F16_ULPS,
              RMS_RATIO, record_property, rms=False)
    _params_three_way(tp, jp, fp, p32 if opt == "adamw" else None,
                      "float16", F16_ULPS, record_property)


def _params_three_way(port, ref, f32, start, dtype, ulps, record_property):
    """Parameters after the steps three ways; given the ``start`` weights,
    a leaf that starts at zero is held instead to ZERO_START_RATIO times
    the reference's own largest error against float32 (the module
    docstring)."""
    zero = ([not np.any(a) for a in f32_leaves(start)] if start is not None
            else [False] * len(jax.tree.leaves(f32)))
    sides = [f32_leaves(t) for t in (port, ref, f32)]
    three_way(*([a for a, z in zip(side, zero) if not z] for side in sides),
              "params", dtype, ulps, RMS_RATIO, record_property)
    for i, (p, r, f) in enumerate(zip(*sides)):
        if zero[i]:
            port_err = float(np.abs(p - f).max())
            ref_err = float(np.abs(r - f).max())
            record_property(f"zero_start_leaf{i}_port_ref_err_vs_f32",
                            (port_err, ref_err))
            assert port_err <= ZERO_START_RATIO * ref_err, (i, port_err,
                                                            ref_err)


def test_mamba2_bf16_train_step_three_way(record_property):
    """mamba2-780m-smoke in bfloat16 (the SSD scan on bfloat16 inputs): one
    sgd step's losses and parameters three ways within BF16_ULPS of
    bfloat16."""
    jcfg, tcfg, j32, params, p32 = _setup("mamba2-780m", "bfloat16")
    opts = dict(optimizer="sgd", learning_rate=SGD_LR, grad_clip=0.0)
    batch = lambda i: _batch("mamba2-780m", i)
    tl, tp = _port_train(tcfg, params, 1, batch, **opts)
    jl, jp = ref_train(jcfg, params, 1, batch, **opts)
    fl, fp = ref_train(j32, p32, 1, batch, **opts)
    three_way([np.float32(a) for a in tl], [np.float32(a) for a in jl],
              [np.float32(a) for a in fl], "losses", "bfloat16", BF16_ULPS,
              RMS_RATIO, record_property, rms=False)
    _params_three_way(tp, jp, fp, None, "bfloat16", BF16_ULPS,
                      record_property)


def _serve_ref(jcfg, params, prompt, steps, cap):
    opts = JD.DistOptions(cut=1)
    prefill = jax.jit(JD.make_prefill_step(jcfg, opts, cap))
    decode = jax.jit(JD.make_decode_step(jcfg, opts, cap))
    p = jax.tree.map(jnp.asarray, params)
    logits, caches = prefill(p, {k: jnp.asarray(v) for k, v in
                                 prompt.items()})
    out = [np.asarray(logits, dtype=np.float32)]
    for i, b in enumerate(steps):
        logits, caches = decode(p, {k: jnp.asarray(v) for k, v in b.items()},
                                caches, jnp.asarray(SEQ + i))
        out.append(np.asarray(logits, dtype=np.float32))
    return out


def test_mamba2_f16_serving_three_way(record_property):
    """mamba2-780m-smoke in float16 served at cut 1 (prefill + 2 decode
    steps; the prefill's SSD scan on float16 inputs, decode's recurrence):
    every step's logits three ways within 8 ulps of float16."""
    jcfg, tcfg, j32, params, p32 = _setup("mamba2-780m")
    prompt, steps = lm_stream(tcfg, 2, SEQ, steps=2, seed=5)
    cap = SEQ + 2
    ref = _serve_ref(jcfg, params, prompt, steps, cap)
    f32 = _serve_ref(j32, p32, prompt, steps, cap)
    tp = bridge.lm_params_to_torch(params, tcfg)
    opts = D.DistOptions(cut=1)
    with torch.no_grad():
        logits, caches = D.make_prefill_step(tcfg, opts, cap)(
            tp, lm_batch_to_torch(prompt))
        port = [logits]
        for i, b in enumerate(steps):
            logits, caches = D.make_decode_step(tcfg, opts, cap)(
                tp, lm_batch_to_torch(b), caches, SEQ + i)
            port.append(logits)
    assert {t.dtype for t in port} == {torch.float16}
    three_way([t.float().numpy() for t in port], ref, f32, "logits",
              "float16", F16_ULPS, RMS_RATIO, record_property)


def test_f16_parameters_train_and_serve_through_the_entry_points():
    """float16 configs are trainable (``check_trainable``) and run through
    the donated ``make_train_step`` (parameters float16, moments
    float32), ``launch.train.train``, ``TransformerUnitModel`` in a
    ``FederationSim`` sfl round and ``launch.serve.serve``; a non-float
    dtype is still refused by ``check_trainable`` and ``DistOptions``."""
    from repro_torch.configs import check_trainable, get_config
    from repro_torch.core import fedsim as TF
    from repro_torch.core.lm_unit import TransformerUnitModel
    from repro_torch.api import registry as TR
    from repro_torch.launch import serve as SV
    from repro_torch.launch import train as TRN
    cfg = dataclasses.replace(get_config("smollm-360m-smoke"),
                              param_dtype="float16")
    check_trainable(cfg)
    D.DistOptions(param_dtype="float16")
    D.DistOptions(param_dtype=torch.float16)
    for bad in ("float64", "int32"):
        with pytest.raises(NotImplementedError, match=f"{bad} parameters"):
            check_trainable(dataclasses.replace(cfg, param_dtype=bad))
        with pytest.raises(NotImplementedError, match="not ported yet"):
            D.DistOptions(param_dtype=bad)
    res = TRN.train(cfg, steps=2, batch=4, seq=16, device="cpu")
    state = res["state"]
    assert {t.dtype for t in jax.tree.leaves(state["opt"]["m"])} == \
        {torch.float32}
    assert T.init_params(torch.Generator(), cfg)["embed"].dtype == \
        torch.float16 == state["params"]["embed"].dtype
    assert all(np.isfinite(m["loss"]) for m in res["metrics"])
    model = TransformerUnitModel(cfg)
    clients, test = TR.make_lm_fleet_data(2, 4, 8, 0, cfg.vocab_size)
    sim = TF.FederationSim(model, clients, test, TF.SimConfig(
        scheme="sfl", cut=1, n_clients=2, batch_size=4, local_steps=1,
        lr=1e-2, rounds=1, optimizer="sgd"), device="cpu")
    assert {t.dtype for t in jax.tree.leaves(sim.units[1])} == \
        {torch.float16}
    (r,) = sim.run()
    assert np.isfinite(r.loss)
    out = SV.serve(cfg, T.init_params(torch.Generator(), cfg), batch=2,
                   prompt_len=8, decode_steps=2)
    assert out["logits"].dtype == torch.float16
    assert bool(torch.isfinite(out["logits"]).all())
