"""Training of the dense, hybrid, vision and audio families against the
JAX package on the CPU: the layers' gradients against ``jax.grad`` of the
reference's (the GeGLU and GeLU MLPs, sinusoidal positions through the
audio embedding, qk-norm through attention, sliding-window flash at head
dim 256 under GQA and MQA), the sync-SFL ``make_train_step`` of
gemma3-4b, internvl2-1b and musicgen-large (sgd with and without clipping,
int8 smashed data, adamw over three steps; recurrentgemma-2b's are in
``test_torch_lm_train_rglru.py``), ``synth_batch``'s frontends and
``launch/train.py`` end to end.  Parameters come from the reference's
threefry init through ``repro_torch.bridge``; inputs are numpy draws.

The configs are the ``-smoke`` widths: gemma3-4b-smoke holds its period
(five local layers and the global one) and the tail of four local layers,
so cut 1 leaves the tail on the RSU; internvl2-1b and musicgen-large,
whose period is one layer, grow to three so both sides hold layers.  The
local layers' window is 16 and the sequence 32, so the window masks keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_grads_close, assert_params_within,
                           cap_torch_threads, grads_vs_jax, jax_lm_params,
                           lm_batch_to_torch, lm_configs, lm_train_batch,
                           run_train_steps)
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import train as TR
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

cap_torch_threads()

# the tolerances of tests/test_torch_lm_train.py
LOSS_RTOL = 1e-5      # one f32 forward through the stack
PARAM_TOL = 1e-5      # of the largest parameter, after one sgd step
ADAMW_LOSS_TOL = 1e-4  # adamw's first steps amplify f32 rounding
SGD_LR = 1e-2         # updates far above f32 rounding
GRAD_RTOL = 1e-5      # a layer's gradients, of each leaf's largest value
SEQ = 32              # past the smoke window of 16
ARCHS = ("gemma3-4b", "internvl2-1b", "musicgen-large")
CHANGES = {"gemma3-4b": {}, "internvl2-1b": dict(n_layers=3),
           "musicgen-large": dict(n_layers=3)}
_cache = {}


def _setup(arch):
    if arch not in _cache:
        jcfg, tcfg = lm_configs(arch, **CHANGES[arch])
        _cache[arch] = (jcfg, tcfg, jax_lm_params(jcfg))
    return _cache[arch]


def _run(arch, steps, **opts):
    jcfg, tcfg, params = _setup(arch)
    return run_train_steps(jcfg, tcfg, params, steps,
                           lambda i: lm_train_batch(tcfg, s=SEQ, seed=i),
                           **opts)


# ---------------------------------------------------------- 1. the MLPs
@pytest.mark.parametrize("variant", ["geglu", "gelu"])
def test_mlp_gradients_match_jax_grad(variant):
    p = jax.tree.map(np.asarray, JL.init_mlp(jax.random.PRNGKey(3), 48, 96,
                                             variant))
    x = np.random.default_rng(0).normal(size=(2, 5, 48)).astype(np.float32)
    _, _, got, want = grads_vs_jax(lambda p, x: JL.mlp(p, x, variant),
                                   lambda p, x: L.mlp(p, x, variant),
                                   (p, x))
    assert_grads_close(got, want, GRAD_RTOL)


def test_sinusoidal_positions_and_audio_embedding_gradient():
    """``sinusoidal_pos`` equals the reference's; the audio embedding
    (K codebook tables summed, the positions added) has the reference's
    gradient in each table."""
    pos = np.arange(37, dtype=np.int32)
    np.testing.assert_allclose(
        L.sinusoidal_pos(torch.from_numpy(pos), 64).numpy(),
        np.asarray(JL.sinusoidal_pos(jnp.asarray(pos), 64)),
        rtol=1e-6, atol=1e-6)
    jcfg, tcfg, params = _setup("musicgen-large")
    codes = lm_train_batch(tcfg, s=SEQ)["codes"]
    positions = np.arange(SEQ, dtype=np.int32)
    _, _, got, want = grads_vs_jax(
        lambda e: JT.embed_inputs({"embed": e}, jcfg, {
            "codes": jnp.asarray(codes)}, jnp.asarray(positions)),
        lambda e: T.embed_inputs({"embed": e}, tcfg, {
            "codes": torch.from_numpy(codes).long()},
            torch.from_numpy(positions)),
        (params["embed"],))
    assert_grads_close(got, want, GRAD_RTOL)


# ----------------------------------------------- 2. qk-norm, 3. windows
def _attn_params(jcfg, seed=5):
    p = jax.tree.map(np.asarray, JA.init_attn(jax.random.PRNGKey(seed),
                                              jcfg))
    rng = np.random.default_rng(seed)
    if jcfg.qk_norm:       # scales away from their init of ones
        for k in ("q_norm", "k_norm"):
            p[k] = (1.0 + 0.3 * rng.normal(size=p[k].shape)).astype(
                np.float32)
    return p


@pytest.mark.parametrize("window", [0, 16])
def test_qk_norm_attention_gradients_match_jax_grad(window):
    """gemma3's attention (qk-norm over head_dim, rope, GQA) under
    ``jax.grad``: every projection, both qk-norm scales and the input.
    The port's qk-norm runs the rmsnorm Function, whose backward is the
    backward kernel's plain version here."""
    jcfg, tcfg, _ = _setup("gemma3-4b")
    assert jcfg.qk_norm and tcfg.qk_norm
    p = _attn_params(jcfg)
    x = np.random.default_rng(1).normal(size=(2, SEQ, jcfg.d_model)).astype(
        np.float32)
    pos = np.arange(SEQ, dtype=np.int32)
    _, _, got, want = grads_vs_jax(
        lambda p, x: JA.attn_train(p, jcfg, x, jnp.asarray(pos), window),
        lambda p, x: A.attn_train(p, tcfg, x, torch.from_numpy(pos),
                                  window), (p, x))
    assert_grads_close(got, want, GRAD_RTOL)


def test_rms_head_norm_gradient_matches_jax_grad():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 4, 256)).astype(np.float32) * 3
    s = (1.0 + 0.2 * rng.normal(size=(256,))).astype(np.float32)
    _, _, got, want = grads_vs_jax(lambda s, x: JL.rms_head_norm(s, x),
                                   lambda s, x: L.rms_head_norm(s, x),
                                   (s, x))
    assert_grads_close(got, want, GRAD_RTOL)


# (b, s, h, kv, window): gemma3's 8 heads over 4 and recurrentgemma's 10
# over 1 at head dim 256, windows shorter than the sequence; at s 1024 the
# reference takes its chunked path (two query blocks of 512, keys sliced
# to the window's span)
WINDOW_CASES = {"gqa_8_4": (2, 40, 8, 4, 16), "mqa_10_1": (2, 40, 10, 1, 16),
                "mqa_chunked": (1, 1024, 2, 1, 100)}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_windowed_flash_gradients_match_jax_grad(case):
    b, s, h, kv, window = WINDOW_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.normal(size=(b, s, h, 256)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, 256)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, 256)).astype(np.float32)
    jcfg, _, _ = _setup("gemma3-4b")
    pos = jnp.arange(s, dtype=jnp.int32)
    _, _, got, want = grads_vs_jax(
        lambda q, k, v: JA._full_attention(jcfg, q, k, v, pos, pos, window),
        lambda q, k, v: FA.flash_attention(q, k, v, causal=True,
                                           window=window), (q, k, v))
    assert_grads_close(got, want, GRAD_RTOL)


# ----------------------------------------------------- 5. the train step
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("clip,compress", [(0.0, False), (1.0, True)])
def test_sgd_train_step_matches_reference(arch, clip, compress):
    jl, tl, jp, tp, jm, tm = _run(arch, 1, optimizer="sgd",
                                  learning_rate=SGD_LR, grad_clip=clip,
                                  compress_smashed=compress)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert_params_within(jp, tp, PARAM_TOL)
    if clip:
        np.testing.assert_allclose(float(tm[0]["grad_norm"]),
                                   float(jm[0]["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_train_trajectory_matches_reference(arch):
    jl, tl, *_ = _run(arch, 3)          # adamw, lr 3e-4, clip 1.0
    assert max(abs(a - b) for a, b in zip(jl, tl)) <= ADAMW_LOSS_TOL


def test_vision_loss_leaves_out_the_patches():
    """internvl2's loss is the text positions' alone: the train step's ce
    is the weighted cross-entropy of the logits past the ``n_patches``
    patch positions against the text labels."""
    from repro_torch.core import distributed as D
    _, tcfg, params = _setup("internvl2-1b")
    tparams = bridge.lm_params_to_torch(params, tcfg)
    b = lm_batch_to_torch(lm_train_batch(tcfg, s=SEQ))
    logits, _, _ = T.forward(tparams, tcfg, b, "train")
    assert logits.shape[1] == SEQ
    text = logits[:, tcfg.n_patches:]
    want = D.weighted_ce(text, b["labels"], b["weights"], tcfg.vocab_size)
    opts = D.DistOptions(cut=1, optimizer="sgd", learning_rate=0.0)
    state = {"params": tparams, "opt": D.make_optimizer(opts).init(tparams),
             "step": torch.zeros((), dtype=torch.int32)}
    _, m = D.make_train_step(tcfg, opts)(state, b)
    torch.testing.assert_close(m["ce"], want, rtol=1e-6, atol=0)


# --------------------------------------------------- synth_batch, the CLI
@pytest.mark.parametrize("arch", ["gemma3-4b", "recurrentgemma-2b",
                                  "internvl2-1b", "musicgen-large"])
def test_synth_batch_has_the_reference_shapes(arch):
    from repro.configs import get_config as jax_config
    from repro.launch import train as JTR
    cfg = get_config(arch).reduced()
    got = TR.synth_batch(cfg, torch.Generator().manual_seed(0), 8, 40, 4)
    want = JTR.synth_batch(jax_config(arch).reduced(),
                           jax.random.PRNGKey(0), 8, 40, 4)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].is_floating_point() == jnp.issubdtype(
            want[k].dtype, jnp.floating), k
    np.testing.assert_array_equal(got["weights"].numpy(),
                                  np.asarray(want["weights"]))
    ids = got["codes"] if "codes" in got else got["tokens"]
    assert int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab_size
    if "labels" in got:
        assert torch.equal(got["labels"][:, :-1], got["tokens"][:, 1:])
    if "patch_embeds" in got:
        assert 0.01 < float(got["patch_embeds"].std()) < 0.03
    with pytest.raises(ValueError, match="no text"):
        TR.synth_batch(get_config("internvl2-1b"), torch.Generator(), 8,
                       256, 4)


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-large"])
def test_train_cli_smoke_trains_the_frontends(arch, capsys):
    assert TR.main(["--arch", arch, "--smoke", "--steps", "2", "--batch",
                    "4", "--seq", str(SEQ), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "step    1 loss=" in out
    cfg = get_config(arch).reduced()
    res = TR.train(cfg, steps=2, batch=4, seq=SEQ, device="cpu")
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in res["metrics"])
    assert res["metrics"][0]["loss"] > 0
