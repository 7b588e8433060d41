"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
numpy inputs handed to both packages, leaves compared as numpy."""
import dataclasses
import os

import jax
import numpy as np
import torch

from repro.core import fedsim as JF
from repro.models import mlp_unit as JM
from repro_torch import bridge
from repro_torch.core import fedsim as TF
from repro_torch.models import mlp_unit as TM


def cap_torch_threads():
    """Under pytest-xdist several workers share the machine's cores: one
    intra-op torch thread per worker keeps torch's OpenMP pool from
    oversubscribing them (measured: 138 s -> 56 s for these files at -n 6).
    Call at module import; a single-process run keeps torch's default."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def ulp_np(x, dtype):
    """One ulp of ``dtype`` ("bfloat16": 8 significant bits, "float16":
    11, subnormal below 2^-14; "float32": 0, no allowance) at each |x|, as
    float32."""
    if dtype == "float32":
        return np.zeros(np.shape(x), np.float32)
    bits, tiny = {"bfloat16": (7, 2.0 ** -126),
                  "float16": (10, 2.0 ** -14)}[dtype]
    e = np.floor(np.log2(np.maximum(np.abs(np.asarray(x, np.float32)),
                                    tiny)))
    return np.exp2(e - bits).astype(np.float32)


def low_precision(a, dtype):
    """A float32 numpy array rounded once to ``dtype`` ("bfloat16",
    "float16"): (the numpy array the reference takes, ``ml_dtypes`` for
    bfloat16; the port's tensor of the same bits)."""
    import jax.numpy as jnp
    arr = np.asarray(jnp.asarray(a).astype(dtype))
    return arr, bridge._tensor(arr)


def jax_params_np(units, head):
    """Reference params -> numpy leaves (the bridge's input form)."""
    return ([jax.tree.map(np.asarray, u) for u in units],
            jax.tree.map(np.asarray, head))


def port_params_from_jax(units, head, device="cpu"):
    return bridge.params_to_torch(*jax_params_np(units, head), device=device)


def leaves_np(units, head):
    """Flat list of numpy leaves in the reference's (sorted-key) order."""
    return jax.tree.leaves(list(units)) + jax.tree.leaves(head)


def port_leaves_np(units, head):
    """The port's params as reference-layout numpy leaves, same order."""
    u, h = bridge.params_to_numpy(units, head)
    return leaves_np(u, h)


def max_abs_diff(a_leaves, b_leaves):
    assert len(a_leaves) == len(b_leaves)
    return max(float(np.max(np.abs(np.asarray(a, np.float64)
                                   - np.asarray(b, np.float64))))
               for a, b in zip(a_leaves, b_leaves))


# tolerance on loss and parameters per wire (see test_torch_fedsim.py)
WIRE_TOL = {"none": 1e-5, "int8": 1e-4, "topk_int8": 1e-4}


def run_both(opt, wire, lr, rounds=2, per_vehicle=32, sizes=None,
             **extra):
    """The reference's and the port's FederationSim (mlp9, 4 vehicles) on
    the same data from the reference's initial parameters; ``sizes`` cuts
    the shards to unequal lengths (vehicles then run different numbers of
    local steps).  Returns (ref sim, ref history, port sim, port
    history)."""
    kw = dict(scheme="asfl", n_clients=4, batch_size=8, local_epochs=1,
              lr=lr, rounds=rounds, optimizer=opt, wire=wire)
    kw.update(extra)
    jc, jt = JM.make_mlp_fleet_data(4, per_vehicle, seed=0, n_test=64)
    tc, tt = TM.make_mlp_fleet_data(4, per_vehicle, seed=0, n_test=64)
    if sizes is not None:
        jc = [dataclasses.replace(c, images=c.images[:n], labels=c.labels[:n])
              for c, n in zip(jc, sizes)]
        tc = [dataclasses.replace(c, images=c.images[:n], labels=c.labels[:n])
              for c, n in zip(tc, sizes)]
    js = JF.FederationSim(JM.MLPUnitModel(), jc, jt, JF.SimConfig(**kw))
    ts = TF.FederationSim(TM.MLPUnitModel(), tc, tt, TF.SimConfig(**kw),
                          device="cpu")
    ts.set_params(*bridge.params_to_torch(*jax_params_np(js.units,
                                                         js.head)))
    return js, js.run(), ts, ts.run()


def assert_sims_agree(js, jh, ts, th, wire):
    tol = WIRE_TOL[wire]
    assert len(jh) == len(th)
    for a, b in zip(jh, th):
        assert a.cuts == b.cuts
        np.testing.assert_allclose(b.comm_bytes, a.comm_bytes, rtol=1e-12)
        np.testing.assert_allclose(b.sim_time_s, a.sim_time_s, rtol=1e-12)
        np.testing.assert_allclose(b.energy_j, a.energy_j, rtol=1e-12)
        assert abs(a.loss - b.loss) <= tol
        assert 0.0 <= b.test_acc <= 1.0
    assert max_abs_diff(leaves_np(js.units, js.head),
                        port_leaves_np(ts.units, ts.head)) <= tol


# ------------------------------------------------------------- LM lane
def lm_configs(arch, **changes):
    """(reference cfg, port cfg) of the reduced ``arch`` with the same
    ``dataclasses.replace`` changes on both sides."""
    import dataclasses

    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config as port_config
    return (dataclasses.replace(jax_config(arch).reduced(), **changes),
            dataclasses.replace(port_config(arch).reduced(), **changes))


def jax_lm_params(jcfg, seed=0):
    """Reference LM params (threefry init) with numpy leaves."""
    from repro.models import transformer as JT
    init = jax.jit(JT.init_params, static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))


def lm_stream(cfg, rows, prompt, steps=0, seed=0):
    """(prompt batch of ``prompt`` positions, ``steps`` decode batches) of
    numpy draws for ``cfg``'s frontend: ``tokens``; ``n_patches`` patch
    embeddings (0.02 x a normal draw) and ``prompt - n_patches`` tokens
    for vision; ``codes`` (rows, K, s) for audio."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        codes = rng.integers(0, cfg.vocab_size, size=(
            rows, cfg.n_codebooks, prompt + steps)).astype(np.int32)
        return ({"codes": codes[:, :, :prompt]},
                [{"codes": codes[:, :, prompt + i:prompt + i + 1]}
                 for i in range(steps)])
    n_text = prompt - (cfg.n_patches if cfg.frontend == "vision" else 0)
    tok = rng.integers(0, cfg.vocab_size,
                       size=(rows, n_text + steps)).astype(np.int32)
    first = {"tokens": tok[:, :n_text]}
    if cfg.frontend == "vision":
        first["patch_embeds"] = (0.02 * rng.normal(
            size=(rows, cfg.n_patches, cfg.d_model))).astype(np.float32)
    return first, [{"tokens": tok[:, n_text + i:n_text + i + 1]}
                   for i in range(steps)]


def lm_batch_to_torch(batch):
    """A numpy LM batch as the port takes it (int32 ids as int64)."""
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def assert_lm_caches_close(jax_caches, port_caches, tol):
    """Reference caches (segments of stacked per-pattern dicts) against the
    port's (segments of periods of per-pattern dicts)."""
    assert len(jax_caches) == len(port_caches)
    for jseg, tseg in zip(jax_caches, port_caches):
        assert (jseg is None) == (tseg is None)
        if jseg is None:
            continue
        assert len(tseg) == np.asarray(
            jax.tree.leaves(jseg)[0]).shape[0]
        for i, period in enumerate(tseg):
            for j, layer in enumerate(period):
                assert set(layer) == set(jseg[j])
                for key, val in layer.items():
                    ref = np.asarray(jseg[j][key])[i]
                    if key == "pos":
                        assert int(ref) == val
                    else:
                        np.testing.assert_allclose(
                            val.numpy(), ref, rtol=tol, atol=tol,
                            err_msg=f"cache {key} period {i} layer {j}")


FLEET_STATE_FIELDS = ("positions", "velocities", "serving_rsu", "rates_bps",
                      "residence_s")


def assert_fleet_states_equal(ref, port):
    """Two scenarios' FleetStates (reference, port): every field equal bit
    for bit, dtypes included."""
    assert port.t == ref.t
    for f in FLEET_STATE_FIELDS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)


# ------------------------------------------------------- LM train step
def lm_train_batch(cfg, b=4, s=32, n_clients=2, seed=0):
    """A numpy train batch of ``s`` positions for ``cfg``'s frontend (the
    reference's ``synth_batch`` shapes): ``tokens`` and next-token
    ``labels``; for vision ``n_patches`` patch embeddings (0.02 x a normal
    draw) before ``s - n_patches`` tokens; for audio ``codes`` (b, K, s)
    alone; and power-law |D_n| ``weights``, ``b // n_clients`` rows a
    client."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        out = {"codes": rng.integers(0, cfg.vocab_size, size=(
            b, cfg.n_codebooks, s)).astype(np.int32)}
    else:
        n_text = s - (cfg.n_patches if cfg.frontend == "vision" else 0)
        toks = rng.integers(0, cfg.vocab_size,
                            size=(b, n_text + 1)).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend == "vision":
            out["patch_embeds"] = (0.02 * rng.normal(
                size=(b, cfg.n_patches, cfg.d_model))).astype(np.float32)
    sizes = np.arange(1, n_clients + 1, dtype=np.float32) ** -1.5
    out["weights"] = np.repeat(sizes / sizes.sum(),
                               b // n_clients).astype(np.float32)
    return out


_TRAIN_JITS = {}


def run_train_steps(jcfg, tcfg, params, steps, batch_fn, cut=1, **opts):
    """The reference's jitted ``make_train_step`` and the port's from the
    same numpy ``params`` over ``batch_fn(i)``'s numpy batches (each jit
    cached per config and options).  Returns (ref losses, port losses, ref
    params, port params as numpy, ref metrics, port metrics)."""
    import jax.numpy as jnp

    from repro.core import distributed as JD
    from repro_torch.core import distributed as D
    jopts = JD.DistOptions(cut=cut, **opts)
    topts = D.DistOptions(cut=cut, **opts)
    key = (jcfg, cut, tuple(sorted(opts.items())))
    if key not in _TRAIN_JITS:
        _TRAIN_JITS[key] = jax.jit(JD.make_train_step(jcfg, jopts))
    jstep = _TRAIN_JITS[key]
    jstate = {"params": jax.tree.map(jnp.asarray, params),
              "opt": JD.make_optimizer(jopts).init(params),
              "step": jnp.zeros((), jnp.int32)}
    tparams = bridge.lm_params_to_torch(params, tcfg)
    tstep = D.make_train_step(tcfg, topts)
    tstate = {"params": tparams,
              "opt": D.make_optimizer(topts).init(tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    jl, tl, jm, tm = [], [], [], []
    for i in range(steps):
        b = batch_fn(i)
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jl.append(float(m["loss"]))
        jm.append(m)
        tstate, m = tstep(tstate, lm_batch_to_torch(b))
        tl.append(float(m["loss"]))
        tm.append(m)
    return (jl, tl, jstate["params"],
            bridge.lm_params_to_numpy(tstate["params"], tcfg), jm, tm)


def assert_params_within(ref, port, tol):
    """Every leaf of ``port`` within ``tol`` of the largest value of
    ``ref`` (same tree, numpy leaves)."""
    ra, pa = jax.tree.leaves(ref), jax.tree.leaves(port)
    assert len(ra) == len(pa)
    big = max(float(np.abs(np.asarray(a)).max()) for a in ra)
    worst = max(float(np.abs(np.asarray(a) - b).max())
                for a, b in zip(ra, pa))
    assert worst <= tol * big, (worst, big)


def assert_grads_close(got, want, rtol):
    """Port gradients (torch) against reference ones (jax / numpy), leaf
    by leaf: each within ``rtol`` of that leaf's largest value."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        a = a.detach().numpy()
        assert a.shape == b.shape, (i, a.shape, b.shape)
        big = float(np.abs(b).max())
        assert np.isfinite(a).all(), i
        np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(big, 1e-30),
                                   err_msg=f"leaf {i} (largest {big:g})")


def grads_vs_jax(jfn, tfn, args, seed=99):
    """``jax.grad`` of sum(jfn(*args) * w) and the port's autograd of
    sum(tfn(*args) * w) in every leaf of every argument (numpy trees in;
    the port's as torch tensors, a leaf it does not read getting a zero
    gradient), w a fixed numpy draw.  Returns (port output, reference
    output, port gradients, reference gradients), leaves in the
    reference's order."""
    import jax.numpy as jnp
    jargs = jax.tree.map(jnp.asarray, args)
    jout = jfn(*jargs)
    w = np.random.default_rng(seed).normal(
        size=np.shape(jout)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                    argnums=tuple(range(len(args))))(*jargs)
    targs = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True),
                         args)
    tout = tfn(*targs)
    leaves = jax.tree.leaves(targs)
    got = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), leaves,
                              allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g
           for g, t in zip(got, leaves)]
    return (tout.detach().numpy(), np.asarray(jout), got,
            jax.tree.leaves(want))


# ------------------------------------------------ 16-bit three-way checks
def three_way(port, ref, f32, what, dtype, ulps, rms_ratio=1.5,
              record_property=None, rms=True):
    """The 16-bit three-way check over lists of float32 numpy leaves: the
    port's run and the reference's in ``dtype``, each against the other and
    against the reference run in float32 on the same ``dtype``-valued
    weights (``f32``), within ``ulps`` ulps of ``dtype`` at each leaf's
    largest |value| of ``f32``; and the port's root-mean-square error
    against ``f32`` at most ``rms_ratio`` times the reference's, over every
    element (``rms=False``: the ulp checks alone, for a loss).  Returns
    the worst errors in units of the ulp limit, and the two RMS errors."""
    assert len(port) == len(ref) == len(f32), what
    worst = {"port_ref": 0.0, "port_f32": 0.0, "ref_f32": 0.0}
    for i, (p, r, f) in enumerate(zip(port, ref, f32)):
        assert p.shape == r.shape == f.shape, (what, i)
        assert np.isfinite(p).all(), (what, i)
        tol = ulps * float(ulp_np(np.float32(np.abs(f).max()), dtype))
        for key, a, b in (("port_ref", p, r), ("port_f32", p, f),
                          ("ref_f32", r, f)):
            err = float(np.abs(a - b).max())
            worst[key] = max(worst[key], err / tol)
            assert err <= tol, (what, i, key, err, tol)
    if record_property is not None:
        record_property(f"{what}_worst_over_tol", worst)
    if not rms:
        return worst, None
    errs = {k: float(np.sqrt(np.mean(np.concatenate(
        [np.square(a - f).ravel() for a, f in zip(side, f32)]))))
        for k, side in (("port", port), ("ref", ref))}
    if record_property is not None:
        record_property(f"{what}_rms_vs_f32", errs)
    assert errs["port"] <= rms_ratio * errs["ref"], (what, errs)
    return worst, errs


def f32_leaves(tree):
    """Every leaf of a (numpy or jax) tree as a float32 numpy array."""
    return [np.asarray(a, dtype=np.float32) for a in jax.tree.leaves(tree)]


_OBJECTIVE_JITS = {}


def ref_loss_and_grad(jcfg, cut=1):
    """The reference train step's objective (``ce + aux_c + aux_s``, its
    ``make_train_step``'s loss) jitted with its gradient, once per config
    and cut."""
    from repro.core import distributed as JD
    from repro.core import split as JSP
    if (jcfg, cut) in _OBJECTIVE_JITS:
        return _OBJECTIVE_JITS[jcfg, cut]

    def loss_fn(params, batch):
        client, server = JSP.split_params(params, jcfg, cut)
        smashed, positions, aux_c, _ = JSP.client_forward(
            client, jcfg, batch, cut, "train")
        logits, aux_s, _ = JSP.server_forward(server, jcfg, smashed,
                                              positions, cut, "train")
        return (JD.weighted_ce(logits, batch["labels"], batch["weights"],
                               jcfg.vocab_size) + aux_c + aux_s)

    _OBJECTIVE_JITS[jcfg, cut] = jax.jit(jax.value_and_grad(loss_fn))
    return _OBJECTIVE_JITS[jcfg, cut]


def ref_train(jcfg, params, steps, batch_fn, cut=1, **opts):
    """The reference's train step from numpy ``params`` over
    ``batch_fn(i)``'s batches, its body as ``make_train_step`` runs it:
    the objective and its gradient (:func:`ref_loss_and_grad`, jitted once
    per config, so every optimizer and step count shares one compile),
    then ``clip_by_global_norm``, the optimizer's update and
    ``apply_updates`` of ``repro.optim`` (jitted once per config and
    options).  Returns (losses, params)."""
    import jax.numpy as jnp

    from repro import optim as JO
    from repro.core import distributed as JD
    jopts = JD.DistOptions(cut=cut, **opts)
    opt = JD.make_optimizer(jopts)
    key = ("update", jcfg, cut, tuple(sorted(opts.items())))
    if key not in _TRAIN_JITS:
        def update(grads, state, params):
            if jopts.grad_clip > 0:
                grads, _ = JO.clip_by_global_norm(grads, jopts.grad_clip)
            updates, state = opt.update(grads, state, params)
            return JO.apply_updates(params, updates), state
        _TRAIN_JITS[key] = jax.jit(update)
    objective = ref_loss_and_grad(jcfg, cut)
    params = jax.tree.map(jnp.asarray, params)
    state = opt.init(params)
    losses = []
    for i in range(steps):
        loss, grads = objective(params, {k: jnp.asarray(v) for k, v in
                                         batch_fn(i).items()})
        params, state = _TRAIN_JITS[key](grads, state, params)
        losses.append(float(loss))
    return losses, params


def lm_params_in(jcfg, params32):
    """Reference-layout numpy ``params32`` (float32) cast leaf by leaf to
    the dtypes the reference's ``init_params`` gives ``jcfg`` (its
    ``param_dtype``; the MoE router and the SSM's A_log / D / dt_bias
    float32), read from ``jax.eval_shape`` without a compile."""
    from repro.models import transformer as JT
    shapes = jax.eval_shape(lambda key: JT.init_params(key, jcfg),
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda a, s: np.asarray(
        jax.numpy.asarray(a).astype(s.dtype)), params32, shapes)
