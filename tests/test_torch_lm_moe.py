"""The MLA / MoE family as whole models against the JAX package on the
CPU: deepseek-v2-lite-16b-smoke at 4 layers (three ``mla_moe`` periods and
the ``mla_dense`` tail, so cuts 1 and 2 leave layers on both sides) and a
float32 replica of dbrx-132b-smoke (``attn_moe``, grown to three periods):
configs, ``count_params`` and the tree's size, the cost profile, the
bridge, logits and the loss's ce and aux, split prefill + 3 decode steps
at two cuts (logits and caches within 2e-4), and that both train (only
float16 parameters train too, as in any arch); their training is held to the reference
in ``test_torch_lm_train_moe.py``.  Parameters come from the reference's
threefry init and cross through ``repro_torch.bridge``; inputs are numpy
draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_lm_caches_close, cap_torch_threads,
                           lm_batch_to_torch, lm_stream)
from repro.configs import get_config as jax_config
from repro.configs.dbrx_132b import CONFIG as JDBRX
from repro.core import cost as JC
from repro.core import distributed as JD
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.dbrx_132b import CONFIG as TDBRX
from repro_torch.core import cost as TC
from repro_torch.core import distributed as D
from repro_torch.kernels import LAUNCHES
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

cap_torch_threads()

TOL = 2e-4          # f32 logits and caches through 4 layers
DEEPSEEK = "deepseek-v2-lite-16b"
MODELS = ("deepseek-smoke-4l", "dbrx-smoke-f32")
PROMPT, STEPS = 37, 3
_cache = {}


def _configs(name):
    """(reference cfg, port cfg) of a test model, the same changes on
    both sides."""
    if name == "deepseek-smoke-4l":
        pair = (jax_config(DEEPSEEK).reduced(), get_config(DEEPSEEK).reduced())
        change = dict(n_layers=4)
    else:       # dbrx in float32 (tests/test_torch_serve_bf16.py: bf16)
        pair = (JDBRX.reduced(), TDBRX.reduced())
        change = dict(n_layers=3, param_dtype="float32")
    return tuple(dataclasses.replace(c, **change) for c in pair)


def _setup(name):
    """(jax cfg, port cfg, numpy params, port params), built once."""
    if name not in _cache:
        jcfg, tcfg = _configs(name)
        init = jax.jit(JT.init_params, static_argnums=(1, 2))
        params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg,
                                               jnp.float32))
        _cache[name] = (jcfg, tcfg, params,
                        bridge.lm_params_to_torch(params, tcfg))
    return _cache[name]


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("which", ["", "-smoke"])
@pytest.mark.parametrize("arch", [DEEPSEEK, "dbrx-132b"])
def test_configs_match_reference(arch, which):
    if arch == DEEPSEEK:
        port, ref = get_config(arch + which), jax_config(arch + which)
    else:
        port, ref = ((TDBRX, JDBRX) if not which
                     else (TDBRX.reduced(), JDBRX.reduced()))
    for f in dataclasses.fields(port):
        want, got = getattr(ref, f.name), getattr(port, f.name)
        if f.name in ("moe", "mla") and got is not None:
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    for prop in ("head_dim_", "padded_vocab", "n_periods", "layer_types"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.param_dtype == ("float32" if arch == DEEPSEEK
                                else "bfloat16")


@pytest.mark.parametrize("cfgs", [
    (DEEPSEEK, DEEPSEEK), (DEEPSEEK + "-smoke", DEEPSEEK + "-smoke"),
    "dbrx", "dbrx-smoke"])
def test_count_params_matches_reference(cfgs):
    if cfgs == "dbrx":
        tcfg, jcfg = TDBRX, JDBRX
    elif cfgs == "dbrx-smoke":
        tcfg, jcfg = TDBRX.reduced(), JDBRX.reduced()
    else:
        tcfg, jcfg = get_config(cfgs[0]), jax_config(cfgs[1])
    assert T.count_params(tcfg) == JT.count_params(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert T.uncounted_params(tcfg) == 0
    if cfgs[0] == DEEPSEEK:
        assert T.count_params(tcfg) == 15_706_484_224


@pytest.mark.parametrize("name", MODELS)
def test_tree_holds_count_params_and_the_bridge_round_trips(name):
    """The port's tree (bridged or its own init) holds count_params values
    (nothing of MLA or MoE is left out of the count); the bridge's round
    trip is exact and keeps the float32 router."""
    jcfg, tcfg, params, tparams = _setup(name)
    n_ref = sum(a.size for a in jax.tree.leaves(params))
    n_port = sum(t.numel() for t in tree_leaves(tparams))
    assert n_port == n_ref == T.count_params(tcfg)
    mine = T.init_params(torch.Generator().manual_seed(0), tcfg)
    assert sum(t.numel() for t in tree_leaves(mine)) == n_port
    back = bridge.lm_params_to_numpy(tparams, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    mine_np = bridge.lm_params_to_numpy(mine, tcfg)
    assert jax.tree.structure(mine_np) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(mine_np), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    router = tparams["segments"][0][0][0]["ffn"]["router"]
    assert router.dtype == torch.float32


@pytest.mark.parametrize("cfgs", ["deepseek", "deepseek-smoke", "dbrx"])
def test_cost_profile_matches_reference(cfgs):
    tcfg, jcfg = {"deepseek": (get_config(DEEPSEEK), jax_config(DEEPSEEK)),
                  "deepseek-smoke": (get_config(DEEPSEEK + "-smoke"),
                                     jax_config(DEEPSEEK + "-smoke")),
                  "dbrx": (TDBRX, JDBRX)}[cfgs]
    for seq in (1024, 37):
        for pb in (2, 4):
            a = dataclasses.asdict(JC.arch_profile(jcfg, seq, pb))
            b = dataclasses.asdict(TC.arch_profile(tcfg, seq, pb))
            assert a.keys() == b.keys() and a.pop("name") == b.pop("name")
            for key in a:
                np.testing.assert_allclose(np.asarray(b[key], np.float64),
                                           np.asarray(a[key], np.float64),
                                           rtol=1e-12, err_msg=key)


# ------------------------------------------------------------ whole models
@pytest.mark.parametrize("name", MODELS)
def test_logits_and_loss_match_reference(name):
    """Prefill logits at every position against the reference's
    teacher-forced forward, and the loss with its ce and aux parts."""
    jcfg, tcfg, params, tparams = _setup(name)
    batch = lm_stream(tcfg, 2, PROMPT)[0]
    jlogits, jaux, _ = jax.jit(lambda p, b: JT.forward(p, jcfg, b, "train"))(
        params, batch)
    logits, aux, caches = T.forward(tparams, tcfg, lm_batch_to_torch(batch),
                                    "prefill", capacity=40)
    assert logits.shape == (2, PROMPT, tcfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert all(c is not None for c in caches)
    batch["labels"] = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, size=(2, PROMPT)).astype(np.int32)
    jloss, jparts = jax.jit(lambda p, b: JT.loss_fn(p, jcfg, b))(params,
                                                                 batch)
    tloss, tparts = T.loss_fn(tparams, tcfg, lm_batch_to_torch(batch))
    assert float(tparts["aux"]) > 0
    for got, want in ((tloss, jloss), (tparts["ce"], jparts["ce"]),
                      (tparts["aux"], jparts["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _run(make_prefill, make_decode, params, prompt, steps, to_np, conv):
    cap = PROMPT + STEPS
    prefill, decode = make_prefill(cap), make_decode(cap)
    logits, caches = prefill(params, conv(prompt))
    out = [to_np(logits)]
    for i, batch in enumerate(steps):
        logits, caches = decode(params, conv(batch), caches, PROMPT + i)
        out.append(to_np(logits))
    return out, caches


@pytest.mark.parametrize("cut", [1, 2])
@pytest.mark.parametrize("name", MODELS)
def test_serving_steps_match_reference(name, cut):
    """``make_prefill_step`` / ``make_decode_step``: logits of the prefill
    and 3 decode steps, and the caches after them (MLA's latent c_kv and
    k_rope, attention's K / V), within 2e-4 of the reference's."""
    jcfg, tcfg, params, tparams = _setup(name)
    prompt, steps = lm_stream(tcfg, 2, PROMPT, STEPS, seed=cut)
    before = dict(LAUNCHES)
    port, pc = _run(
        lambda c: D.make_prefill_step(tcfg, D.DistOptions(cut=cut), c),
        lambda c: D.make_decode_step(tcfg, D.DistOptions(cut=cut), c),
        tparams, prompt, steps, lambda t: t.numpy().copy(),
        lm_batch_to_torch)
    assert LAUNCHES == before             # CPU tensors: plain versions only
    ref, jc = _run(
        lambda c: jax.jit(JD.make_prefill_step(jcfg, JD.DistOptions(cut=cut),
                                               c)),
        lambda c: jax.jit(JD.make_decode_step(jcfg, JD.DistOptions(cut=cut),
                                              c)),
        params, prompt, steps, np.asarray, lambda b: b)
    assert port[0].shape == (2, 1, tcfg.padded_vocab)
    for step, (lp, lj) in enumerate(zip(port, ref)):
        np.testing.assert_allclose(lp, lj, rtol=TOL, atol=TOL,
                                   err_msg=f"logits at step {step}")
    for side in (0, 1):
        assert_lm_caches_close(jc[side], pc[side], TOL)


# ------------------------------------------------- training, no refusal
def test_training_deepseek_and_the_16bit_archs_is_accepted(capsys):
    """deepseek-v2-lite-16b (MLA, MoE) and dbrx-132b (MoE, bfloat16)
    train -- ``untrained_features`` is empty for them, ``SERVE_ONLY`` is
    empty, the train step, ``TransformerUnitModel`` and ``launch/train.py``
    take them -- and so does every arch with float16 parameters, while a
    non-float dtype is refused in every arch."""
    from repro_torch.configs import (SERVE_ONLY, check_trainable,
                                     untrained_features)
    from repro_torch.core.lm_unit import TransformerUnitModel
    from repro_torch.launch import train as TR
    assert SERVE_ONLY == ()
    assert untrained_features(get_config(DEEPSEEK)) == []
    assert untrained_features(_configs("dbrx-smoke-f32")[1]) == []
    for cfg in (get_config(DEEPSEEK), get_config(DEEPSEEK + "-smoke"),
                _configs("dbrx-smoke-f32")[1]):
        check_trainable(cfg)
        D.make_train_step(cfg, D.DistOptions())
        if cfg.name.endswith("-smoke"):
            assert TransformerUnitModel(cfg).n_units > 1
    assert TR.main(["--arch", DEEPSEEK, "--smoke", "--steps", "1",
                    "--batch", "4", "--seq", "16", "--device", "cpu"]) == 0
    assert "aux=" in capsys.readouterr().out
    for arch in ("dbrx-132b", "command-r-35b", "qwen3-14b", DEEPSEEK):
        for name in (arch, arch + "-smoke"):
            cfg = get_config(name)
            assert cfg.param_dtype == ("float32" if arch == DEEPSEEK
                                       else "bfloat16")
            assert untrained_features(cfg) == []
            check_trainable(cfg)
            check_trainable(dataclasses.replace(cfg, param_dtype="float16"))
            with pytest.raises(NotImplementedError,
                               match="int32 parameters"):
                check_trainable(dataclasses.replace(cfg,
                                                    param_dtype="int32"))


def test_serve_cli_serves_deepseek_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", DEEPSEEK, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12",
                       "--decode-steps", "2"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {DEEPSEEK}-smoke prefill(12) -> logits (2, 1, 2048)" \
        in out
    assert "decode_ms_per_step=" in out and "device=cpu" in out
