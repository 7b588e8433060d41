"""Split-inference serving (paper §IV-C) of the port against the JAX
package on the CPU: ``make_prefill_step`` / ``make_decode_step`` give the
reference's logits and caches for the same token stream at two cuts, for
smollm-360m (GQA) and mamba2-780m at reduced width, and the
``repro_torch.launch.serve`` CLI runs on the CPU only when asked to."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import (assert_lm_caches_close, cap_torch_threads,
                           jax_lm_params, lm_configs)
from repro.core import distributed as JD
from repro_torch import bridge
from repro_torch.core import distributed as D
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve

cap_torch_threads()

TOL = 2e-4          # f32 logits and caches through 3 periods
ARCHS = {"smollm-gqa": ("smollm-360m", dict(n_layers=3, n_kv_heads=2)),
         "mamba2": ("mamba2-780m", dict(n_layers=3))}
PROMPT, STEPS = 37, 3       # 37: not a multiple of the SSD chunk (32)
_cache = {}


def _setup(name):
    """(jax cfg, port cfg, numpy params, port params), built once."""
    if name not in _cache:
        jcfg, tcfg = lm_configs(ARCHS[name][0], **ARCHS[name][1])
        params = jax_lm_params(jcfg)
        _cache[name] = (jcfg, tcfg, params,
                        bridge.lm_params_to_torch(params, tcfg))
    return _cache[name]


def _run_jax(jcfg, params, tokens, cut):
    opts = JD.DistOptions(cut=cut)
    cap = PROMPT + STEPS
    prefill = jax.jit(JD.make_prefill_step(jcfg, opts, cap))
    decode = jax.jit(JD.make_decode_step(jcfg, opts, cap))
    logits, caches = prefill(params, {"tokens": tokens[:, :PROMPT]})
    out = [(np.asarray(logits), caches)]
    for i in range(STEPS):
        logits, caches = decode(params,
                                {"tokens": tokens[:, PROMPT + i:][:, :1]},
                                caches, PROMPT + i)
        out.append((np.asarray(logits), caches))
    return out


def _run_port(tcfg, tparams, tokens, cut):
    opts = D.DistOptions(cut=cut)
    cap = PROMPT + STEPS
    prefill = D.make_prefill_step(tcfg, opts, cap)
    decode = D.make_decode_step(tcfg, opts, cap)
    tok = torch.from_numpy(tokens).long()
    logits, caches = prefill(tparams, {"tokens": tok[:, :PROMPT]})
    out = [(logits.numpy().copy(), caches)]
    for i in range(STEPS):
        logits, caches = decode(tparams,
                                {"tokens": tok[:, PROMPT + i:][:, :1]},
                                caches, PROMPT + i)
        out.append((logits.numpy().copy(), caches))
    return out


@pytest.mark.parametrize("cut", [1, 2])
@pytest.mark.parametrize("name", list(ARCHS))
def test_serving_steps_match_reference(name, cut):
    jcfg, tcfg, params, tparams = _setup(name)
    tokens = np.random.default_rng(cut).integers(
        0, tcfg.vocab_size, size=(2, PROMPT + STEPS)).astype(np.int32)
    before = dict(LAUNCHES)
    port = _run_port(tcfg, tparams, tokens, cut)
    assert LAUNCHES == before             # CPU tensors: plain versions only
    ref = _run_jax(jcfg, params, tokens, cut)
    assert port[0][0].shape == (2, 1, tcfg.padded_vocab)
    for step, ((lp, cp), (lj, cj)) in enumerate(zip(port, ref)):
        np.testing.assert_allclose(lp, lj, rtol=TOL, atol=TOL,
                                   err_msg=f"logits at step {step}")
    # caches after the last decode step (the port updates attention
    # caches in place, so earlier steps' dicts share these tensors)
    for side in (0, 1):
        assert_lm_caches_close(ref[-1][1][side], port[-1][1][side], TOL)


def test_compressed_smashed_is_the_reference_fake_quant():
    """compress_smashed: int8 quantize on the vehicle, dequantize at the
    RSU.  What the RSU receives is bit for bit the reference's
    ``fake_quant`` of the same tensor, and the compressed prefill is the
    split forward with that value at the cut.  (Logits are not compared
    with the reference's compressed run: int8 rounding is discontinuous,
    so smashed values one float32 ulp apart can land one int8 step apart.)
    """
    from repro.core.compression import fake_quant
    from repro_torch.core import compression as C
    from repro_torch.core import split as SP
    _, tcfg, _, tparams = _setup("smollm-gqa")
    rng = np.random.default_rng(5)
    smashed = (rng.normal(size=(2, PROMPT, tcfg.d_model)) * 3).astype(
        np.float32)
    got = D._cross(torch.from_numpy(smashed),
                   D.DistOptions(compress_smashed=True))
    assert np.array_equal(got.numpy(), np.asarray(fake_quant(smashed)))

    tok = torch.from_numpy(rng.integers(0, tcfg.vocab_size,
                                        size=(2, PROMPT)))
    cap = PROMPT + STEPS
    logits, _ = D.make_prefill_step(
        tcfg, D.DistOptions(cut=1, compress_smashed=True), cap)(
            tparams, {"tokens": tok})
    plain, _ = D.make_prefill_step(tcfg, D.DistOptions(cut=1), cap)(
        tparams, {"tokens": tok})
    client, server = SP.split_params(tparams, tcfg, 1)
    sm, positions, _, _ = SP.client_forward(client, tcfg, {"tokens": tok},
                                            1, capacity=cap)
    want, _, _ = SP.server_forward(server, tcfg,
                                   C.dequantize_int8(*C.quantize_int8(sm)),
                                   positions, 1, capacity=cap)
    assert torch.equal(logits, want[:, -1:])
    assert not torch.equal(logits, plain)   # the int8 trip changed them


def test_smashed_sharding_is_not_ported():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        D.DistOptions(smashed_sharding=object())


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m"])
def test_serve_cli_runs_on_cpu_when_asked(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12",
                       "--decode-steps", "2"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {arch}-smoke prefill(12) -> logits (2, 1, 2048)" in out
    assert "decode_ms_per_step=" in out and "device=cpu" in out


def test_serve_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "smollm-360m", "--smoke"])


def test_serve_result_is_finite_and_in_vocab():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("mamba2-780m-smoke")
    params = T.init_params(torch.Generator().manual_seed(1), cfg)
    res = serve.serve(cfg, params, batch=3, prompt_len=9, decode_steps=4)
    assert res["logits"].shape == (3, 1, cfg.padded_vocab)
    assert torch.isfinite(res["logits"]).all()
    assert len(res["tokens"]) == 4
    assert all(int(t.max()) < cfg.vocab_size for t in res["tokens"])
