"""Split-inference serving (paper §IV-C) of the dense, hybrid, vision and
audio families against the JAX package on the CPU:
``make_prefill_step`` / ``make_decode_step`` give the reference's logits
and caches at two cuts for gemma3-4b (local rings + global attention,
qk-norm), recurrentgemma-2b (RG-LRU + local MQA), internvl2-1b (patch
embeddings prepended) and musicgen-large (K codebooks in, K heads out) at
reduced width, grown to three periods; and the ``repro_torch.launch.serve``
CLI serves each of them on the CPU when asked to."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import (assert_lm_caches_close, cap_torch_threads,
                           jax_lm_params, lm_batch_to_torch, lm_configs,
                           lm_stream)
from repro.core import distributed as JD
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import distributed as D
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve
from repro_torch.models import transformer as T

cap_torch_threads()

TOL = 2e-4          # f32 logits and caches through 3 periods
# three periods each, so cuts 1 and 2 both leave layers on both sides
ARCHS = {"gemma3-4b": dict(n_layers=16), "recurrentgemma-2b":
         dict(n_layers=8), "internvl2-1b": dict(n_layers=3),
         "musicgen-large": dict(n_layers=3)}
PROMPT, STEPS = 37, 3       # 37 positions: past the reduced window of 16
_cache = {}


def _setup(arch):
    """(jax cfg, port cfg, numpy params, port params), built once."""
    if arch not in _cache:
        jcfg, tcfg = lm_configs(arch, **ARCHS[arch])
        params = jax_lm_params(jcfg)
        _cache[arch] = (jcfg, tcfg, params,
                        bridge.lm_params_to_torch(params, tcfg))
    return _cache[arch]


def _run(make_prefill, make_decode, params, prompt, steps, to_np, conv):
    cap = PROMPT + STEPS
    prefill, decode = make_prefill(cap), make_decode(cap)
    logits, caches = prefill(params, conv(prompt))
    out = [(to_np(logits), caches)]
    for i, batch in enumerate(steps):
        logits, caches = decode(params, conv(batch), caches, PROMPT + i)
        out.append((to_np(logits), caches))
    return out


@pytest.mark.parametrize("cut", [1, 2])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_serving_steps_match_reference(arch, cut):
    jcfg, tcfg, params, tparams = _setup(arch)
    prompt, steps = lm_stream(tcfg, 2, PROMPT, STEPS, seed=cut)
    before = dict(LAUNCHES)
    port = _run(lambda c: D.make_prefill_step(tcfg, D.DistOptions(cut=cut),
                                              c),
                lambda c: D.make_decode_step(tcfg, D.DistOptions(cut=cut),
                                             c),
                tparams, prompt, steps, lambda t: t.numpy().copy(),
                lm_batch_to_torch)
    assert LAUNCHES == before             # CPU tensors: plain versions only
    ref = _run(lambda c: jax.jit(JD.make_prefill_step(
                   jcfg, JD.DistOptions(cut=cut), c)),
               lambda c: jax.jit(JD.make_decode_step(
                   jcfg, JD.DistOptions(cut=cut), c)),
               params, prompt, steps, np.asarray, lambda b: b)
    k = (tcfg.n_codebooks,) if tcfg.frontend == "audio" else ()
    assert port[0][0].shape == (2, 1, *k, tcfg.padded_vocab)
    for step, ((lp, _), (lj, _)) in enumerate(zip(port, ref)):
        np.testing.assert_allclose(lp, lj, rtol=TOL, atol=TOL,
                                   err_msg=f"logits at step {step}")
    # caches after the last decode step (the port updates attention
    # caches in place, so earlier steps' dicts share these tensors)
    for side in (0, 1):
        assert_lm_caches_close(ref[-1][1][side], port[-1][1][side], TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_cli_runs_on_cpu_when_asked(arch, capsys):
    cfg = get_config(arch + "-smoke")
    prompt = 12 + (cfg.n_patches if cfg.frontend == "vision" else 0)
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", str(prompt),
                       "--decode-steps", "2"]) == 0
    out = capsys.readouterr().out
    k = f"{cfg.n_codebooks}, " if cfg.frontend == "audio" else ""
    assert (f"[serve] {arch}-smoke prefill({prompt}) -> logits "
            f"(2, 1, {k}2048)") in out
    assert "decode_ms_per_step=" in out and "device=cpu" in out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_result_is_finite_and_in_vocab(arch):
    """serve() at a prompt past the reduced window: the prompt batch of
    the arch's frontend, finite logits, sampled ids (one per codebook for
    audio) inside the true vocab, caches at the served length."""
    cfg = get_config(arch + "-smoke")
    params = T.init_params(torch.Generator().manual_seed(1), cfg)
    res = serve.serve(cfg, params, batch=3, prompt_len=20, decode_steps=4)
    prompt = res["prompt"]
    if cfg.frontend == "audio":
        assert prompt["codes"].shape == (3, cfg.n_codebooks, 20)
        assert res["logits"].shape == (3, 1, cfg.n_codebooks,
                                       cfg.padded_vocab)
        assert all(t.shape == (3, cfg.n_codebooks) for t in res["tokens"])
    else:
        assert res["logits"].shape == (3, 1, cfg.padded_vocab)
        assert all(t.shape == (3,) for t in res["tokens"])
    if cfg.frontend == "vision":
        assert prompt["tokens"].shape == (3, 20 - cfg.n_patches)
        assert prompt["patch_embeds"].shape == (3, cfg.n_patches,
                                                cfg.d_model)
        assert float(prompt["patch_embeds"].std()) < 0.05
    assert torch.isfinite(res["logits"]).all()
    assert len(res["tokens"]) == 4
    assert all(int(t.max()) < cfg.vocab_size for t in res["tokens"])
    for side in res["caches"]:                 # vehicle, RSU
        for seg in side:
            for period in seg or ():
                assert all(layer["pos"] == 24 for layer in period)
