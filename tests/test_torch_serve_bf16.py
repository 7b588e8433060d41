"""The bfloat16 archs against the JAX package on the CPU: qwen3-14b (qk-norm),
command-r-35b and dbrx-132b (``attn_moe``, 16 experts top-4), whose
``param_dtype`` is bfloat16.

Configs and ``count_params`` at full width equal the reference's;
``init_params`` builds the weights in bfloat16 (the MoE router in float32,
as the reference's); the bridge carries bfloat16 leaves bit for bit;
qwen3-14b and command-r-35b train (tests/test_torch_lm_train_bf16.py holds
that to the reference), dbrx-132b too (tests/test_torch_lm_train_moe_bf16.py).
Serving is held at the ``-smoke`` widths, grown to
three layers on both sides so that cut 1 leaves layers on both sides:

- in float32 (``param_dtype="float32"`` on both sides: the algorithm), the
  logits of a prefill and 3 decode steps and the caches within 2e-4, the
  tolerance of every float32 serving test;
- in bfloat16, where the two cannot agree bit for bit: the reference's
  prefill rounds its attention scores to bfloat16 (a bf16 einsum,
  ``src/repro/models/attention.py:72``) where the port's runs flash's
  float32 math, and the two frameworks round other ops at other places.
  Three things are held, against the reference run in float32 on the same
  bfloat16-valued weights ("f32" below), their tolerances stated here
  before the tests were first run:

  1. port-bf16 against reference-bf16: logits within BF16_ULPS = 8 ulps of
     bfloat16 at the largest |logit| of f32 (the logits are bfloat16, ulp
     2^-6 at 2-4; each side rounds every activation of ~10 ops a layer to
     8 significant bits, and those errors reach the logits through the
     head's d-term sums), the caches within 8 ulps at each cache's largest
     |value| of f32;
  2. port-bf16 and reference-bf16 each against f32 within the same 8 ulps;
  3. the port's root-mean-square error against f32 at most RMS_RATIO = 1.5
     times the reference's own.

  An MoE router picks its top-k from softmax probabilities that bfloat16
  activations perturb, so a near tie can go either way on either side (a
  discrete change of the output, not an error of the arithmetic).  Both
  sides' routing is recorded (the port's ``moe._route`` by chip_smoke.py's
  spy, the reference's through an ordered ``jax.debug.callback``); the
  checks hold on the batch
  rows (independent sequences) whose every token was routed alike in the
  three runs, which must be at least half of ROWS = 8; the others are
  counted and recorded (``record_property``).

Parameters come from the reference's threefry init (``param_dtype``
bfloat16) and cross through ``repro_torch.bridge``; inputs are numpy
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
from repro.core import distributed as JD
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import SERVE_ONLY, check_trainable, get_config
from repro_torch.configs import untrained_features
from repro_torch.core import distributed as D
from repro_torch.kernels import LAUNCHES
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

cap_torch_threads()

ARCHS = ("qwen3-14b", "command-r-35b", "dbrx-132b")
COUNTS = {"qwen3-14b": 14_785_336_320, "command-r-35b": 32_380_690_432,
          "dbrx-132b": 131_596_523_520}
F32_TOL = 2e-4
BF16_ULPS = 8
RMS_RATIO = 1.5
ROWS, PROMPT, STEPS, LAYERS = 8, 37, 3, 3
_cache = {}


def _configs(arch, dtype="bfloat16"):
    """(reference cfg, port cfg): ``arch``'s smoke config at LAYERS layers
    in ``dtype``, the same changes on both sides."""
    change = dict(n_layers=LAYERS, param_dtype=dtype)
    return (dataclasses.replace(jax_config(arch).reduced(), **change),
            dataclasses.replace(get_config(arch).reduced(), **change))


def _setup(arch):
    """(reference cfg, port cfg, numpy bf16 params, port params), once."""
    if arch not in _cache:
        jcfg, tcfg = _configs(arch)
        init = jax.jit(JT.init_params, static_argnums=1)
        params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
        _cache[arch] = (jcfg, tcfg, params,
                        bridge.lm_params_to_torch(params, tcfg))
    return _cache[arch]


def _chip_smoke():
    """The repo's ``chip_smoke.py`` as a module: its routing spy, its
    row-flip rule and bfloat16 ulp (its phase 10 holds the card to the
    CPU by the same rules)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("which", ["", "-smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, which):
    port, ref = get_config(arch + which), jax_config(arch + which)
    for f in dataclasses.fields(port):
        want, got = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "moe" and got is not None:
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    for prop in ("head_dim_", "padded_vocab", "n_periods", "layer_types"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.param_dtype == "bfloat16"


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_match_reference(arch):
    cfg = get_config(arch)
    assert T.count_params(cfg) == JT.count_params(jax_config(arch)) \
        == COUNTS[arch]
    assert cfg.param_count() == jax_config(arch).param_count()
    smoke = get_config(arch + "-smoke")
    assert T.count_params(smoke) == JT.count_params(
        jax_config(arch + "-smoke"))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_builds_bf16_and_the_bridge_round_trips(arch):
    """``init_params`` with no dtype builds cfg.param_dtype (bfloat16; the
    router float32), as many values as the reference's tree; the bridge
    carries the reference's bfloat16 leaves there and back bit for bit."""
    jcfg, tcfg, params, tparams = _setup(arch)
    mine = T.init_params(torch.Generator().manual_seed(0), tcfg)
    kinds = {str(a.dtype) for a in jax.tree.leaves(params)}
    assert kinds == ({"bfloat16", "float32"} if tcfg.moe else {"bfloat16"})
    for tree in (mine, tparams):
        leaves = tree_leaves(tree)
        assert sum(t.numel() for t in leaves) == sum(
            a.size for a in jax.tree.leaves(params)) == (
            T.count_params(tcfg) + T.uncounted_params(tcfg))
        assert {t.dtype for t in leaves} == {
            torch.bfloat16, *([torch.float32] if tcfg.moe else [])}
    if tcfg.moe:
        assert mine["segments"][0][0][0]["ffn"]["router"].dtype == \
            torch.float32
    assert {t.dtype for t in tree_leaves(T.init_params(
        torch.Generator().manual_seed(0), tcfg, torch.float32))} == \
        {torch.float32}
    back = bridge.lm_params_to_numpy(tparams, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


# ------------------------------------------------------------------ serving
def _serve(make_prefill, make_decode, params, prompt, steps, to_np, conv):
    """Logits of a prefill and the decode steps (float32 numpy, (1 +
    steps, rows, 1, V)) and the caches."""
    cap = PROMPT + STEPS
    prefill, decode = make_prefill(cap), make_decode(cap)
    logits, caches = prefill(params, conv(prompt))
    out = [to_np(logits)]
    for i, batch in enumerate(steps):
        logits, caches = decode(params, conv(batch), caches, PROMPT + i)
        out.append(to_np(logits))
    return np.stack(out), caches


def _port(tcfg, params, prompt, steps, cut=1):
    before = dict(LAUNCHES)
    out = _serve(lambda c: D.make_prefill_step(tcfg, D.DistOptions(cut=cut),
                                               c),
                 lambda c: D.make_decode_step(tcfg, D.DistOptions(cut=cut), c),
                 params, prompt, steps, lambda t: t.float().numpy(),
                 lm_batch_to_torch)
    assert LAUNCHES == before             # CPU tensors: plain versions only
    return out


def _ref(jcfg, params, prompt, steps, cut=1):
    return _serve(
        lambda c: jax.jit(JD.make_prefill_step(jcfg, JD.DistOptions(cut=cut),
                                               c)),
        lambda c: jax.jit(JD.make_decode_step(jcfg, JD.DistOptions(cut=cut),
                                              c)),
        params, prompt, steps, lambda a: np.asarray(a.astype(jnp.float32)),
        lambda b: b)


@pytest.mark.parametrize("cut", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_f32_serving_matches_reference(arch, cut):
    """The algorithm in float32: logits of a prefill and 3 decode steps,
    and the caches, within 2e-4 of the reference's."""
    jcfg, tcfg = _configs(arch, "float32")
    init = jax.jit(JT.init_params, static_argnums=1)
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1), jcfg))
    prompt, steps = lm_stream(tcfg, 2, PROMPT, STEPS, seed=cut)
    port, pc = _port(tcfg, bridge.lm_params_to_torch(params, tcfg), prompt,
                     steps, cut)
    ref, jc = _ref(jcfg, params, prompt, steps, cut)
    assert port.shape == (1 + STEPS, 2, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(port, ref, rtol=F32_TOL, atol=F32_TOL)
    for side in (0, 1):
        assert_lm_caches_close(jc[side], pc[side], F32_TOL)


def _ref_routes(monkeypatch, sink):
    """Record the reference's routing into ``sink[0]`` (a list, which the
    caller may swap between runs)."""
    real = JMOE._route

    def spy(p, cfg, xt):
        res = real(p, cfg, xt)
        jax.debug.callback(lambda idx: sink[0].append(np.asarray(idx)),
                           res[2], ordered=True)
        return res
    monkeypatch.setattr(JMOE, "_route", spy)


def _kv(tree):
    """Every K / V cache tensor in a nest of tuples, lists and dicts."""
    if isinstance(tree, dict):
        return [tree[key] for key in ("k", "v")]
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in _kv(sub)]
    return []


def _cache_leaves(caches, rows):
    """{(side, segment, period, layer, key): float32 numpy of ``rows``} of
    the port's caches, or of the reference's (stacked periods)."""
    out = {}
    for side, seg_list in enumerate(caches):
        for si, seg in enumerate(seg_list):
            if seg is None:
                continue
            if isinstance(seg, (list,)):        # the port: periods
                for i, period in enumerate(seg):
                    for j, layer in enumerate(period):
                        for key in ("k", "v"):
                            out[side, si, i, j, key] = \
                                layer[key].float().numpy()[rows]
            else:                               # the reference: stacked
                for j, layer in enumerate(seg):
                    for key in ("k", "v"):
                        a = np.asarray(layer[key].astype(jnp.float32))
                        for i in range(a.shape[0]):
                            out[side, si, i, j, key] = a[i][rows]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serving_three_way(arch, monkeypatch, record_property):
    """Prefill + 3 decode steps at cut 1 in bfloat16 on both sides, and
    the reference in float32 on the same bfloat16-valued weights: the
    three checks of the module docstring on the rows routed alike."""
    jcfg, tcfg, params, tparams = _setup(arch)
    j32 = dataclasses.replace(jcfg, param_dtype="float32")
    p32 = jax.tree.map(lambda a: a.astype(np.float32), params)
    prompt, steps = lm_stream(tcfg, ROWS, PROMPT, STEPS, seed=5)
    routes = {"ref": [], "f32": []}
    routes["port"], unwrap = CS._route_spy()
    try:
        port, pc = _port(tcfg, tparams, prompt, steps)
    finally:
        unwrap()
    sink = [routes["ref"]]
    _ref_routes(monkeypatch, sink)
    ref, rc = _ref(jcfg, params, prompt, steps)
    jax.effects_barrier()
    sink[0] = routes["f32"]
    f32, fc = _ref(j32, p32, prompt, steps)
    jax.effects_barrier()
    assert {str(t.dtype) for t in _kv(pc)} == {"torch.bfloat16"}
    assert {str(t.dtype) for t in _kv(rc)} == {"bfloat16"}
    assert port.shape == (1 + STEPS, ROWS, 1, tcfg.padded_vocab)
    n_moe = LAYERS * (1 + STEPS) if tcfg.moe else 0
    assert all(len(r) == n_moe for r in routes.values())
    flips = np.zeros(ROWS, bool)
    if tcfg.moe:
        ref_routes = {k: [torch.from_numpy(a) for a in routes[k]]
                      for k in ("ref", "f32")}
        flips = (CS._row_flips(routes["port"], ref_routes["ref"], ROWS)
                 | CS._row_flips(ref_routes["ref"], ref_routes["f32"],
                                 ROWS)).numpy()
    rows = np.flatnonzero(~flips)
    record_property("rows_routed_apart", int(flips.sum()))
    assert len(rows) >= ROWS // 2, f"{flips.sum()} of {ROWS} rows flipped"
    port, ref, f32 = (a[:, rows] for a in (port, ref, f32))
    tol = BF16_ULPS * CS._bf16_ulp(float(np.abs(f32).max()))
    errs = {"port_ref": np.abs(port - ref).max(),
            "port_f32": np.abs(port - f32).max(),
            "ref_f32": np.abs(ref - f32).max()}
    rms = {k: float(np.sqrt(np.mean(np.square(a - f32))))
           for k, a in (("port", port), ("ref", ref))}
    record_property("logit_errors", {k: float(v) for k, v in errs.items()})
    record_property("rms_vs_f32", rms)
    assert max(errs.values()) <= tol, (errs, tol)
    assert rms["port"] <= RMS_RATIO * rms["ref"], rms
    got, want, exact = (_cache_leaves(c, rows) for c in (pc, rc, fc))
    assert got.keys() == want.keys() == exact.keys()
    for key in got:
        ctol = BF16_ULPS * CS._bf16_ulp(float(np.abs(exact[key]).max()))
        for a, b in ((got[key], want[key]), (got[key], exact[key]),
                     (want[key], exact[key])):
            assert np.abs(a - b).max() <= ctol, (key, ctol)


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_training_is_accepted(arch, capsys):
    """bfloat16 parameters train: qwen3-14b, command-r-35b and dbrx-132b
    (whose MoE FFNs train too) build the train step and
    ``TransformerUnitModel`` and train through ``launch/train.py``; so do
    float16 parameters in every arch, and a non-float dtype is refused."""
    from repro_torch.core.lm_unit import TransformerUnitModel
    from repro_torch.launch import train as TR
    cfg = get_config(arch)
    assert "bfloat16 parameters" not in untrained_features(cfg)
    D.DistOptions(param_dtype="bfloat16")
    D.DistOptions(param_dtype="float16")
    with pytest.raises(NotImplementedError, match="float64"):
        D.DistOptions(param_dtype="float64")
    for c in (cfg, get_config(arch + "-smoke")):
        check_trainable(dataclasses.replace(c, param_dtype="float16"))
        with pytest.raises(NotImplementedError, match="float64 parameters"):
            check_trainable(dataclasses.replace(c, param_dtype="float64"))
    assert arch not in SERVE_ONLY and untrained_features(cfg) == []
    for c in (cfg, get_config(arch + "-smoke")):
        check_trainable(c)
        D.make_train_step(c, D.DistOptions())
    assert TransformerUnitModel(get_config(arch + "-smoke")).n_units > 1
    assert TR.main(["--arch", arch, "--smoke", "--steps", "1", "--batch",
                    "4", "--seq", "8", "--device", "cpu"]) == 0
    assert "step    0 loss=" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_bf16_arch_on_cpu_when_asked(arch, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12",
                       "--decode-steps", "2"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {arch}-smoke prefill(12) -> logits (2, 1, 2048)" in out
    assert "decode_ms_per_step=" in out and "device=cpu" in out
