"""The LM lane's configs, bridge and models (smollm-360m: dense GQA
attention; mamba2-780m: SSD) against the JAX package on the CPU, at the
reduced configs grown to three periods so that every cut has layers on
both sides.  Parameters come from the reference's threefry init and cross
through ``repro_torch.bridge``; tokens are numpy draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (cap_torch_threads, jax_lm_params, lm_configs)
from repro.configs import get_config as jax_config
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import split as SP
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

cap_torch_threads()

LOGIT_TOL = 2e-4    # f32 through 3 periods, summed in another order
# (arch, replace): smollm with GQA (4 heads over 2 kv heads), mamba2 with
# two SSM groups; both grown to three periods
VARIANTS = {"smollm-gqa": ("smollm-360m", dict(n_layers=3, n_kv_heads=2)),
            "mamba2": ("mamba2-780m", dict(n_layers=3))}
_cache = {}


def _setup(name):
    """(jax cfg, port cfg, numpy params, port params), built once."""
    if name not in _cache:
        arch, changes = VARIANTS[name]
        jcfg, tcfg = lm_configs(arch, **changes)
        if tcfg.ssm is not None:
            jcfg = dataclasses.replace(
                jcfg, ssm=dataclasses.replace(jcfg.ssm, n_groups=2))
            tcfg = dataclasses.replace(
                tcfg, ssm=dataclasses.replace(tcfg.ssm, n_groups=2))
        params = jax_lm_params(jcfg)
        _cache[name] = (jcfg, tcfg, params,
                        bridge.lm_params_to_torch(params, tcfg))
    return _cache[name]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m",
                                  "smollm-360m-smoke", "mamba2-780m-smoke"])
def test_configs_match_reference(arch):
    port, ref = get_config(arch), jax_config(arch)
    for f in dataclasses.fields(port):
        want, got = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "ssm" and got is not None:
            got, want = dataclasses.asdict(got), {
                k: v for k, v in dataclasses.asdict(want).items()
                if k != "fused_proj"}
            assert ref.ssm.fused_proj      # the port's (only) projection
        assert got == want, f.name
    for prop in ("head_dim_", "padded_vocab", "n_periods", "layer_types"):
        assert getattr(port, prop) == getattr(ref, prop), prop


def test_unported_archs_raise():
    """Every arch id of the reference has a config (the bfloat16 ones
    since their parameters were ported); an unknown id raises; every
    bfloat16 arch trains, dbrx-132b's MoE FFNs too, and so does any arch
    in float16; float64 parameters are refused."""
    from repro_torch.configs import check_trainable
    for name in ("dbrx-132b", "qwen3-14b-smoke"):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            jax_config(name))
    check_trainable(get_config("dbrx-132b"))
    check_trainable(get_config("qwen3-14b-smoke"))
    check_trainable(dataclasses.replace(get_config("dbrx-132b"),
                                        param_dtype="float16"))
    with pytest.raises(NotImplementedError, match="float64 parameters"):
        check_trainable(dataclasses.replace(get_config("dbrx-132b"),
                                            param_dtype="float64"))
    with pytest.raises(NotImplementedError, match="float64 parameters"):
        check_trainable(dataclasses.replace(get_config("qwen3-14b-smoke"),
                                            param_dtype="float64"))
    with pytest.raises(KeyError):
        get_config("no-such-arch")


# ------------------------------------------------------------------ bridge
@pytest.mark.parametrize("name", list(VARIANTS))
def test_bridge_round_trip_is_exact(name):
    _, tcfg, params, tparams = _setup(name)
    back = bridge.lm_params_to_numpy(tparams, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(tparams["segments"][0]) == tcfg.n_periods


def test_init_params_shapes_match_reference():
    jcfg, tcfg, params, _ = _setup("mamba2")
    mine = bridge.lm_params_to_numpy(
        T.init_params(torch.Generator().manual_seed(0), tcfg), tcfg)
    assert jax.tree.structure(mine) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype


# ------------------------------------------------------------------ layers
def test_attention_window_ring_cache_matches_reference():
    """attn_prefill + two attn_decode steps with a window shorter than the
    sequence: the ring-buffer cache (no ported arch has a window yet; the
    unwindowed cache is held by tests/test_torch_serve.py)."""
    window = 6
    jcfg, tcfg, _, _ = _setup("smollm-gqa")
    p = jax.tree.map(np.asarray, JA.init_attn(jax.random.PRNGKey(1), jcfg))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    rng = np.random.default_rng(window)
    x = rng.normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    prefill = jax.jit(JA.attn_prefill, static_argnums=(1, 4, 5))
    decode = jax.jit(JA.attn_decode, static_argnums=(1, 4))
    jy, jc = prefill(p, jcfg, jnp.asarray(x), jnp.asarray(pos), 12, window)
    ty, tc = A.attn_prefill(tp, tcfg, torch.from_numpy(x),
                            torch.from_numpy(pos), 12, window)
    for step in range(3):
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        for key in ("k", "v", "k_pos"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       rtol=1e-5, atol=1e-5)
        assert tc["pos"] == int(jc["pos"])
        xd = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = decode(p, jcfg, jnp.asarray(xd), jc, window)
        ty, tc = A.attn_decode(tp, tcfg, torch.from_numpy(xd), tc, window)


# ------------------------------------------------------------ whole models
@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_logits_match_reference(name):
    """The port's prefill logits at every position against the reference's
    teacher-forced forward (ragged length: not a multiple of the SSD
    chunk)."""
    jcfg, tcfg, params, tparams = _setup(name)
    tok = _tokens(tcfg, 2, 37)
    jlogits, _, _ = jax.jit(lambda p, t: JT.forward(p, jcfg, {"tokens": t},
                                                    "train"))(params, tok)
    logits, _, caches = T.forward(tparams, tcfg,
                                  {"tokens": torch.from_numpy(tok)},
                                  "prefill", capacity=40)
    assert logits.shape == (2, 37, tcfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert all(c is not None for c in caches)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_split_forward_equals_full_forward(name):
    _, tcfg, _, tparams = _setup(name)
    tok = torch.from_numpy(_tokens(tcfg, 2, 12, seed=1))
    full, _, _ = T.forward(tparams, tcfg, {"tokens": tok}, "prefill",
                           capacity=12)
    assert SP.valid_cuts(tcfg) == [1, 2]
    for cut in SP.valid_cuts(tcfg):
        client, server = SP.split_params(tparams, tcfg, cut)
        joined = SP.join_params(client, server, tcfg)
        for key in tparams:
            assert all(a is b for a, b in zip(tree_leaves(joined[key]),
                                              tree_leaves(tparams[key])))
        smashed, positions, _, _ = SP.client_forward(client, tcfg,
                                                     {"tokens": tok}, cut,
                                                     capacity=12)
        logits, _, _ = SP.server_forward(server, tcfg, smashed, positions,
                                         cut, capacity=12)
        np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_then_decode_matches_teacher_forcing(name):
    """Prefill(s-1) + decode(1) reproduces the last logits of prefill(s)
    (as tests/test_archs_smoke.py holds the reference)."""
    _, tcfg, _, tparams = _setup(name)
    s, cap = 33, 48
    tok = torch.from_numpy(_tokens(tcfg, 2, s, seed=2))
    full, _, _ = T.forward(tparams, tcfg, {"tokens": tok}, "prefill",
                           capacity=cap)
    _, _, caches = T.forward(tparams, tcfg, {"tokens": tok[:, :s - 1]},
                             "prefill", capacity=cap)
    dec, _, _ = T.forward(tparams, tcfg, {"tokens": tok[:, s - 1:]},
                          "decode", caches=caches, capacity=cap,
                          pos_offset=s - 1)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_unported_modes_and_kinds_raise():
    _, tcfg, _, tparams = _setup("smollm-gqa")
    tok = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.forward(tparams, tcfg, {"tokens": tok}, "score")
    with pytest.raises(ValueError, match="unknown layer kind"):
        T.init_layer(torch.Generator(), tcfg, "no_such_kind")
