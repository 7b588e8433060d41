"""The LM lane's dense, hybrid, vision and audio families (gemma3-4b:
local + global attention with qk-norm and GeGLU; recurrentgemma-2b: RG-LRU
and local MQA attention; internvl2-1b: the vision stub frontend;
musicgen-large: the audio stub frontend with sinusoidal positions and a
plain GeLU MLP) against the JAX package on the CPU: configs, parameter
counts, the bridge, the new layers, the RG-LRU block, whole-model logits
and the cost profile.  Parameters come from the reference's threefry init
and cross through ``repro_torch.bridge``; inputs are numpy draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (cap_torch_threads, jax_lm_params,
                           lm_batch_to_torch, lm_configs, lm_stream)
from repro.configs import get_config as jax_config
from repro.core import cost as JC
from repro.models import layers as JL
from repro.models import rglru as JR
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import (ARCH_IDS, SERVE_ONLY,
                                 get_config)
from repro_torch.core import cost as TC
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

cap_torch_threads()

FAMILIES = ("gemma3-4b", "recurrentgemma-2b", "internvl2-1b",
            "musicgen-large")
ALL_ARCHS = ("smollm-360m", "mamba2-780m") + FAMILIES
LOGIT_TOL = 2e-4    # f32 through 3 periods, summed in another order
LAYER_TOL = 1e-6
RGLRU_RTOL = 1e-5   # the scan's sums in another order than the reference's
# every family at three periods, so every cut has layers on both sides
VARIANTS = {"gemma3-4b": dict(n_layers=16), "recurrentgemma-2b":
            dict(n_layers=8), "internvl2-1b": dict(n_layers=3),
            "musicgen-large": dict(n_layers=3)}
_cache = {}


def _setup(arch):
    """(jax cfg, port cfg, numpy params, port params), built once."""
    if arch not in _cache:
        jcfg, tcfg = lm_configs(arch, **VARIANTS[arch])
        params = jax_lm_params(jcfg)
        _cache[arch] = (jcfg, tcfg, params,
                        bridge.lm_params_to_torch(params, tcfg))
    return _cache[arch]


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", [a + s for a in FAMILIES
                                  for s in ("", "-smoke")])
def test_configs_match_reference(arch):
    port, ref = get_config(arch), jax_config(arch)
    for f in dataclasses.fields(port):
        want, got = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "rglru" and got is not None:
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert ref.moe is None and ref.mla is None
    for prop in ("head_dim_", "padded_vocab", "n_periods", "layer_types"):
        assert getattr(port, prop) == getattr(ref, prop), prop


def test_registry_holds_the_served_families():
    """The families are registered and trained; no arch is served only
    (the bfloat16 archs train since bfloat16 training was ported, the MLA
    / MoE ones since their training was)."""
    assert set(FAMILIES) <= set(ARCH_IDS)
    assert SERVE_ONLY == ()
    from repro.configs import ARCH_IDS as REF_IDS
    assert sorted(ARCH_IDS) == sorted(REF_IDS)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_count_params_matches_reference(arch):
    assert T.count_params(get_config(arch)) == \
        JT.count_params(jax_config(arch))
    assert get_config(arch).param_count() == jax_config(arch).param_count()


@pytest.mark.parametrize("arch", FAMILIES)
def test_leaves_are_the_count_plus_what_it_leaves_out(arch):
    """The port's tree holds count_params + the qk-norm scales + RG-LRU's
    lam, as the reference's tree does."""
    jcfg, tcfg, params, tparams = _setup(arch)
    n_ref = sum(a.size for a in jax.tree.leaves(params))
    n_port = sum(t.numel() for t in tree_leaves(tparams))
    assert n_port == n_ref == T.count_params(tcfg) + T.uncounted_params(tcfg)
    mine = T.init_params(torch.Generator().manual_seed(0), tcfg)
    assert sum(t.numel() for t in tree_leaves(mine)) == n_port


# ------------------------------------------------------------------ bridge
@pytest.mark.parametrize("arch", FAMILIES)
def test_bridge_round_trip_is_exact(arch):
    _, tcfg, params, tparams = _setup(arch)
    back = bridge.lm_params_to_numpy(tparams, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    mine = bridge.lm_params_to_numpy(
        T.init_params(torch.Generator().manual_seed(0), tcfg), tcfg)
    assert jax.tree.structure(mine) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("variant", ["geglu", "gelu", "swiglu"])
def test_mlp_variants_match_reference(variant):
    p = jax.tree.map(np.asarray, JL.init_mlp(jax.random.PRNGKey(3), 48, 96,
                                             variant))
    x = np.random.default_rng(0).normal(size=(2, 5, 48)).astype(np.float32)
    want = np.asarray(JL.mlp(p, jnp.asarray(x), variant))
    tp = {k: {"w": torch.from_numpy(np.array(v["w"]))} for k, v in p.items()}
    got = L.mlp(tp, torch.from_numpy(x), variant).numpy()
    np.testing.assert_allclose(got, want, rtol=LAYER_TOL, atol=LAYER_TOL)
    mine = L.init_mlp(torch.Generator().manual_seed(0), 48, 96, variant)
    assert {k: tuple(v["w"].shape) for k, v in mine.items()} == \
        {k: v["w"].shape for k, v in p.items()}


def test_rms_head_norm_and_sinusoidal_pos_match_reference():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 7, 3, 32)) * 3).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(32,))).astype(np.float32)
    np.testing.assert_allclose(
        L.rms_head_norm(torch.from_numpy(scale), torch.from_numpy(x)).numpy(),
        np.asarray(JL.rms_head_norm(jnp.asarray(scale), jnp.asarray(x))),
        rtol=LAYER_TOL, atol=LAYER_TOL)
    # a non-contiguous view of the heads, as an einsum may return it
    xt = torch.from_numpy(x).transpose(1, 2)
    np.testing.assert_allclose(
        L.rms_head_norm(torch.from_numpy(scale), xt).numpy(),
        np.asarray(JL.rms_head_norm(jnp.asarray(scale),
                                    jnp.asarray(x).swapaxes(1, 2))),
        rtol=LAYER_TOL, atol=LAYER_TOL)
    # The frequencies exp(-log(1e4) i / half) of the two packages differ
    # by an ulp or two (their exp), which an angle pos * f carries as pos
    # times that, plus one ulp of the angle: 1e-6 holds below position 16;
    # up to musicgen's serving length each row is held to 1e-6 + pos *
    # 2.4e-7 (two ulps of a frequency <= 1, times the position).
    pos = np.arange(1100, dtype=np.int32)
    for d in (32, 256, 2048):
        got = L.sinusoidal_pos(torch.from_numpy(pos), d).numpy()
        want = np.asarray(JL.sinusoidal_pos(jnp.asarray(pos), d))
        np.testing.assert_allclose(got[:16], want[:16], rtol=0,
                                   atol=LAYER_TOL)
        err = np.abs(got - want).max(axis=-1)
        assert (err <= LAYER_TOL + pos * 2.4e-7).all(), float(err.max())


# ------------------------------------------------------------------ RG-LRU
def _rglru_params(cfg, seed=4):
    p = jax.tree.map(np.asarray, JR.init_rglru(jax.random.PRNGKey(seed),
                                               cfg))
    # nonzero biases so the gates are not symmetric around 0
    rng = np.random.default_rng(seed)
    for key in ("b_a", "b_i", "conv_b"):
        p[key] = (0.3 * rng.normal(size=p[key].shape)).astype(np.float32)
    return p, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)


def _rel_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RGLRU_RTOL * scale, f"{what}: {err:g} of {scale:g}"


# s >= d_conv - 1: the conv cache keeps the last 3 inputs (both packages)
@pytest.mark.parametrize("s", [3, 4, 37, 64])
def test_rglru_prefill_and_decode_match_reference(s):
    """rglru_prefill's output, state and conv cache, then 3 decode steps,
    within 1e-5 of the largest value."""
    jcfg, tcfg, _, _ = _setup("recurrentgemma-2b")
    p, tp = _rglru_params(jcfg)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    jy, jc = jax.jit(JR.rglru_prefill, static_argnums=1)(p, jcfg,
                                                         jnp.asarray(x))
    ty, tc = R.rglru_prefill(tp, tcfg, torch.from_numpy(x))
    decode = jax.jit(JR.rglru_decode, static_argnums=1)
    for step in range(4):
        _rel_close(ty.numpy(), jy, f"y step {step}")
        _rel_close(tc["state"].numpy(), jc["state"], f"state step {step}")
        assert tc["conv"].shape == jc["conv"].shape
        _rel_close(tc["conv"].numpy(), jc["conv"], f"conv step {step}")
        assert tc["pos"] == int(jc["pos"])
        xd = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = decode(p, jcfg, jnp.asarray(xd), jc)
        ty, tc = R.rglru_decode(tp, tcfg, torch.from_numpy(xd), tc)


def test_rglru_seq_folds_an_incoming_state():
    """rglru_seq with h0 (the reference's virtual step 0) equals the
    reference's; the train-mode block equals the prefill output."""
    jcfg, tcfg, _, _ = _setup("recurrentgemma-2b")
    p, tp = _rglru_params(jcfg, 5)
    rng = np.random.default_rng(6)
    xr = rng.normal(size=(2, 33, jcfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(2, jcfg.d_model)).astype(np.float32)
    jh, jlast = JR.rglru_seq(p, jcfg, jnp.asarray(xr), jnp.asarray(h0))
    th, tlast = R.rglru_seq(tp, tcfg, torch.from_numpy(xr),
                            torch.from_numpy(h0))
    _rel_close(th.numpy(), jh, "h")
    _rel_close(tlast.numpy(), jlast, "last")
    x = torch.from_numpy(xr)
    assert torch.equal(R.rglru_train(tp, tcfg, x),
                       R.rglru_prefill(tp, tcfg, x)[0])


def test_linear_scan_equals_the_recurrence():
    """The doubling scan against h_t = a_t h_{t-1} + b_t step by step."""
    rng = np.random.default_rng(7)
    for s in (1, 2, 3, 5, 16, 100):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 3)))
        b = torch.from_numpy(rng.normal(size=(2, s, 3)))
        want, h = [], torch.zeros(2, 3, dtype=torch.float64)
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(R._linear_scan(a, b),
                                   torch.stack(want, 1), rtol=1e-12,
                                   atol=1e-12)


def test_rglru_flops_and_profile_match_reference():
    for arch in FAMILIES:
        jc, tc = jax_config(arch), get_config(arch)
        if tc.rglru is not None:
            assert R.rglru_flops(tc) == JR.rglru_flops(jc)
        for seq in (1024, 37):
            a = dataclasses.asdict(JC.arch_profile(jc, seq))
            b = dataclasses.asdict(TC.arch_profile(tc, seq))
            assert a.keys() == b.keys() and a.pop("name") == b.pop("name")
            for key in a:
                np.testing.assert_allclose(np.asarray(b[key], np.float64),
                                           np.asarray(a[key], np.float64),
                                           rtol=1e-12, err_msg=key)


# ------------------------------------------------------------ whole models
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_logits_match_reference(arch):
    """The port's prefill logits at every position against the
    reference's teacher-forced forward (37 positions: past the reduced
    window of 16), and the train-mode loss against the reference's."""
    jcfg, tcfg, params, tparams = _setup(arch)
    batch = lm_stream(tcfg, 2, 37)[0]
    fwd = jax.jit(lambda p, b: JT.forward(p, jcfg, b, "train")[0])
    jlogits = np.asarray(fwd(params, batch))
    logits, _, caches = T.forward(tparams, tcfg, lm_batch_to_torch(batch),
                                  "prefill", capacity=40)
    k = (tcfg.n_codebooks,) if tcfg.frontend == "audio" else ()
    assert logits.shape == (2, 37, *k, tcfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert all(c is not None for c in caches)
    if tcfg.frontend != "audio":
        n_text = batch["tokens"].shape[1]
        batch["labels"] = np.random.default_rng(9).integers(
            0, tcfg.vocab_size, size=(2, n_text)).astype(np.int32)
    jloss = float(jax.jit(lambda p, b: JT.loss_fn(p, jcfg, b)[0])(params,
                                                                  batch))
    tloss = float(T.loss_fn(tparams, tcfg, lm_batch_to_torch(batch))[0])
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_then_decode_matches_teacher_forcing(arch):
    """Prefill(s-1) + decode(1) reproduces the last logits of prefill(s),
    with s past the window so the local caches are rings."""
    _, tcfg, _, tparams = _setup(arch)
    s, cap = 33, 48
    full_b = lm_batch_to_torch(lm_stream(tcfg, 2, s, seed=2)[0])
    if tcfg.frontend == "audio":
        head = {"codes": full_b["codes"][:, :, :s - 1]}
        last = {"codes": full_b["codes"][:, :, s - 1:]}
    else:
        head = dict(full_b, tokens=full_b["tokens"][:, :-1])
        last = {"tokens": full_b["tokens"][:, -1:]}
    full, _, _ = T.forward(tparams, tcfg, full_b, "prefill", capacity=cap)
    _, _, caches = T.forward(tparams, tcfg, head, "prefill", capacity=cap)
    dec, _, _ = T.forward(tparams, tcfg, last, "decode", caches=caches,
                          capacity=cap, pos_offset=s - 1)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_training_the_served_families_is_refused(arch):
    """Training the families is no longer refused: each ``-smoke`` train
    step builds (renamed too: the check reads what the config holds),
    steps once from its own init and gives finite metrics; the text archs
    build ``TransformerUnitModel``, the frontends stay refused there as in
    the reference's ``core/lm_unit.py``."""
    from repro_torch.configs import check_trainable, untrained_features
    from repro_torch.core import distributed as D
    from repro_torch.core.lm_unit import TransformerUnitModel
    from repro_torch.launch.train import synth_batch
    renamed = dataclasses.replace(get_config(arch), name="renamed")
    for cfg in (get_config(arch), renamed):
        assert untrained_features(cfg) == []
        check_trainable(cfg)
    cfg = get_config(arch + "-smoke")
    opts = D.DistOptions(cut=1)
    state = D.init_state(torch.Generator().manual_seed(0), cfg, opts)
    batch = synth_batch(cfg, torch.Generator().manual_seed(1), 4, 32, 2)
    state, m = D.make_train_step(cfg, opts)(state, batch)
    assert set(m) == {"loss", "ce", "aux", "grad_norm"}
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert int(state["step"]) == 1
    if cfg.frontend == "none":
        assert TransformerUnitModel(cfg).n_units > 1
    else:
        with pytest.raises(ValueError, match="text archs only"):
            TransformerUnitModel(cfg)


# the features the families brought, now trained (MLA and the MoE FFN
# too), and the one still served only
TRAINED_CHANGES = [
    dict(frontend="vision"), dict(pattern=("attn", "attn_local"), n_layers=2),
    dict(tail=("rglru",), n_layers=2), dict(qk_norm=True),
    dict(pos="sinusoidal"),
    dict(mlp_variant="geglu"), dict(mlp_variant="gelu"),
    dict(param_dtype="bfloat16"), dict(pattern=("mla_dense",)),
    dict(pattern=("attn_moe",)), dict(param_dtype="float16")]
REFUSED_CHANGES = [dict(param_dtype="float64")]


@pytest.mark.parametrize("change", TRAINED_CHANGES + REFUSED_CHANGES)
def test_training_refusal_follows_what_the_config_holds(change):
    """The refusal reads what a config holds, whatever its name: a trained
    arch that gains a frontend, local attention, RG-LRU, qk-norm,
    sinusoidal positions, a GeGLU / GeLU MLP, bfloat16 or float16
    parameters, an MLA layer or an MoE FFN still trains; one that gains
    float64 parameters is refused as served only.  The trained archs as
    they are pass."""
    from repro_torch.configs import check_trainable, untrained_features
    from repro_torch.core import distributed as D
    for arch in ("smollm-360m", "mamba2-780m"):
        assert untrained_features(get_config(arch)) == []
        check_trainable(get_config(arch + "-smoke"))
    cfg = dataclasses.replace(get_config("smollm-360m-smoke"), **change)
    if change in TRAINED_CHANGES:
        assert untrained_features(cfg) == []
        D.make_train_step(cfg, D.DistOptions())
        return
    assert untrained_features(cfg)
    with pytest.raises(NotImplementedError, match="served only"):
        D.make_train_step(cfg, D.DistOptions())
