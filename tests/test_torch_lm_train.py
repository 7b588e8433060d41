"""The LM lane's training path against the JAX package on the CPU:
``weighted_ce`` / ``cross_entropy`` at a padded vocab, the sync-SFL
``make_train_step`` (sgd with and without clipping, int8 smashed data,
adamw over three steps) at the reduced configs grown to three periods,
and ``launch/train.py`` end to end with a checkpoint.  Parameters come from
the reference's threefry init through ``repro_torch.bridge``; tokens and
weights are numpy draws."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_params_within, cap_torch_threads,
                           jax_lm_params, lm_batch_to_torch, lm_configs,
                           lm_train_batch, run_train_steps)
from repro.core import distributed as JD
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.ckpt import latest_step, restore_checkpoint
from repro_torch.core import distributed as D
from repro_torch.launch import train as TR
from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves

cap_torch_threads()

LOSS_RTOL = 1e-5      # one f32 forward through three periods
PARAM_TOL = 1e-5      # of the largest parameter, after one sgd step
ADAMW_LOSS_TOL = 1e-4  # adamw's first steps amplify f32 rounding
SGD_LR = 1e-2         # updates far above f32 rounding
_cache = {}


def _setup(arch):
    if arch not in _cache:
        jcfg, tcfg = lm_configs(arch, n_layers=3)
        _cache[arch] = (jcfg, tcfg, jax_lm_params(jcfg))
    return _cache[arch]


def _batch(cfg, seed=0):
    return lm_train_batch(cfg, s=16, seed=seed)


def _run_both(arch, steps, **opts):
    """The reference's jitted train step and the port's from the same
    parameters over the same batches.  Returns (ref losses, port losses,
    ref params, port params as numpy, ref metrics, port metrics)."""
    jcfg, tcfg, params = _setup(arch)
    return run_train_steps(jcfg, tcfg, params, steps,
                           lambda i: _batch(tcfg, seed=i), **opts)


def test_cross_entropy_matches_reference_at_padded_vocab():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 5, 2048)) * 4).astype(np.float32)
    labels = rng.integers(0, 500, size=(3, 5)).astype(np.int32)
    w = rng.random(3).astype(np.float32)
    want = float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                  500))
    got = float(L.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), 500))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want = float(JD.weighted_ce(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(w), 500))
    got = float(D.weighted_ce(torch.from_numpy(logits),
                              torch.from_numpy(labels), torch.from_numpy(w),
                              500))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the mask: a logit in the padded tail never wins the softmax
    logits[..., 1000] = 50.0
    want = float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                  500))
    got = float(L.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), 500))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m"])
@pytest.mark.parametrize("clip,compress", [(0.0, False), (1.0, True)])
def test_sgd_train_step_matches_reference(arch, clip, compress):
    jl, tl, jp, tp, jm, tm = _run_both(arch, 1, optimizer="sgd",
                                       learning_rate=SGD_LR, grad_clip=clip,
                                       compress_smashed=compress)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert_params_within(jp, tp, PARAM_TOL)
    if clip:
        np.testing.assert_allclose(float(tm[0]["grad_norm"]),
                                   float(jm[0]["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m"])
def test_adamw_train_trajectory_matches_reference(arch):
    jl, tl, *_ = _run_both(arch, 3)          # adamw, lr 3e-4, clip 1.0
    assert max(abs(a - b) for a, b in zip(jl, tl)) <= ADAMW_LOSS_TOL


def test_train_step_reports_finite_metrics_and_steps_the_count():
    _, tcfg, params = _setup("smollm-360m")
    opts = D.DistOptions(cut=1)
    tparams = bridge.lm_params_to_torch(params, tcfg)
    state = {"params": tparams, "opt": D.make_optimizer(opts).init(tparams),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = D.make_train_step(tcfg, opts)(state,
                                              lm_batch_to_torch(_batch(tcfg)))
    assert set(m) == {"loss", "ce", "aux", "grad_norm"}
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert float(m["aux"]) == 0.0 and int(state["step"]) == 1


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m"])
def test_dist_options_remat_sets_the_period_forwards(arch, monkeypatch):
    """``DistOptions.remat`` reaches the stack: with it on, each of the
    three periods runs its forward again in the backward; off, once.  The
    step's result is the same bit for bit."""
    from repro_torch.models import transformer as T
    _, tcfg, params = _setup(arch)
    calls = []
    run_period = T._run_period

    def counted(*a, **k):
        calls.append(1)
        return run_period(*a, **k)

    monkeypatch.setattr(T, "_run_period", counted)
    out = {}
    for remat in (True, False):
        opts = D.DistOptions(cut=1, optimizer="sgd", learning_rate=SGD_LR,
                             remat=remat)
        tparams = bridge.lm_params_to_torch(params, tcfg)
        state = {"params": tparams,
                 "opt": D.make_optimizer(opts).init(tparams),
                 "step": torch.zeros((), dtype=torch.int32)}
        calls.clear()
        state, m = D.make_train_step(tcfg, opts)(state,
                                                  lm_batch_to_torch(_batch(tcfg)))
        out[remat] = (len(calls), float(m["loss"]),
                      tree_leaves(state["params"]))
    assert out[True][0] == 2 * 3 and out[False][0] == 3
    assert out[True][1] == out[False][1]
    assert all(torch.equal(a, b) for a, b in zip(out[True][2],
                                                 out[False][2]))


def test_mamba2_trains_over_several_chunks():
    """seq 64 over the reduced config's chunk of 32: the SSD's decay
    overflows above the diagonal, and the gradient stays finite."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mamba2-780m").reduced(),
                              n_layers=3)
    res = TR.train(cfg, steps=2, batch=4, seq=64, cut=1, device="cpu")
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in res["metrics"])
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(res["state"]["params"]))


def test_param_count_matches_reference():
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    for arch in ("smollm-360m", "mamba2-780m", "smollm-360m-smoke",
                 "mamba2-780m-smoke"):
        assert get_config(arch).param_count() == \
            jax_config(arch).param_count()


def test_unported_dist_options_raise():
    """float64 parameters (bfloat16 and float16 train) and the mesh
    shapes are not ported."""
    D.DistOptions(param_dtype="bfloat16")
    D.DistOptions(param_dtype="float16")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        D.DistOptions(param_dtype="float64")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TR.main(["--arch", "smollm-360m", "--shape", "train_4k",
                 "--device", "cpu"])


def test_train_cli_smoke_writes_a_restorable_checkpoint(tmp_path, capsys):
    assert TR.main(["--arch", "mamba2-780m", "--smoke", "--steps", "2",
                    "--batch", "4", "--seq", "16", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "step    1 loss=" in out and "checkpoint ->" in out
    assert latest_step(str(tmp_path)) == 2
    # the same run through train(): the checkpoint holds its parameters
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-780m").reduced()
    res = TR.train(cfg, steps=2, batch=4, seq=16, device="cpu")
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in res["metrics"])
    assert len(res["step_s"]) == 2 and res["peak_bytes"] is None
    like = D.init_state(torch.Generator().manual_seed(7), cfg,
                        D.DistOptions())["params"]
    back = restore_checkpoint(str(tmp_path), 2, like)
    for a, b in zip(tree_leaves(back), tree_leaves(res["state"]["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.main(["--arch", "smollm-360m", "--smoke", "--steps", "1"])
