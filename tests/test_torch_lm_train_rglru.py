"""RG-LRU training and recurrentgemma-2b's train step against the JAX
package on the CPU.

The port's recurrence is a Hillis-Steele doubling
(``repro_torch.models.rglru._linear_scan``); the reference's is
``jax.lax.associative_scan``: the same recurrence summed in another
order.  The block's gradients (``w_a``, ``w_i``, ``b_a``, ``b_i``,
``lam``, the conv, the projections and the input) are held to
``jax.grad`` at a sequence length that is a power of two and at one that
is not, at the init's decays (0.9-0.999), at decays near 1 (lam from
17.5 up: ``1 - a^2`` falls under 1e-6 on every channel and the gate's
``clamp(1 - a^2, 1e-6)`` holds it there, so no gradient passes through
the square root) and near 0.  Between those (lam ~9-17) the float32 gate
is ill-conditioned on both sides: one ulp of a moves ``sqrt(1 - a^2)`` by
up to 6 % next to the clamp, and whether an element clamps flips with
that ulp.  There the clamp is held element by element: channels whose a
the two packages compute bit for bit have the reference's gradient,
clamped or not (``test_gates_clamp_where_the_decay_rounds_to_one``).
Then recurrentgemma-2b-smoke (its period R, R, local A and the tail R, R;
cut 1 leaves the tail on the RSU) through the sync-SFL
``make_train_step`` as ``test_torch_lm_train_families.py`` holds the other
families.  Parameters come from the reference's threefry init through
``repro_torch.bridge``; inputs are numpy draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_grads_close, assert_params_within,
                           cap_torch_threads, grads_vs_jax, jax_lm_params,
                           lm_configs, lm_train_batch, run_train_steps)
from repro.models import rglru as JR
from repro_torch.models import rglru as R

cap_torch_threads()

GRAD_RTOL = 1e-5      # of each leaf's largest gradient: the scan's sums in
#                       another order than the reference's tree
LOSS_RTOL = 1e-5      # the tolerances of tests/test_torch_lm_train.py
PARAM_TOL = 1e-5
ADAMW_LOSS_TOL = 1e-4
SGD_LR = 1e-2
SEQ = 32
# lam per regime: the init's linspace(2, 7) (decay 0.9-0.999), a large lam
# (decay near 1: from lam 17.5 up 1 - a^2 < 1e-6 and the gate clamps on
# every channel) and a negative one (decay near 0)
LAMS = {"init": None, "near_one": (17.5, 24.0), "near_zero": (-6.0, -1.0)}
_cache = {}


def _setup():
    if "cfg" not in _cache:
        jcfg, tcfg = lm_configs("recurrentgemma-2b")
        _cache["cfg"] = (jcfg, tcfg, jax_lm_params(jcfg))
    return _cache["cfg"]


def _block_params(regime, seed=4):
    """The reference's RG-LRU block parameters (numpy), lam set by the
    regime and the gate biases away from their zero init."""
    jcfg, _, _ = _setup()
    p = jax.tree.map(np.asarray, JR.init_rglru(jax.random.PRNGKey(seed),
                                               jcfg))
    rng = np.random.default_rng(seed)
    dr = p["lam"].shape[0]
    if LAMS[regime] is not None:
        p["lam"] = np.linspace(*LAMS[regime], dr).astype(np.float32)
    p["b_a"] = (0.5 * rng.normal(size=dr)).astype(np.float32)
    p["b_i"] = (0.5 * rng.normal(size=dr)).astype(np.float32)
    p["conv_b"] = (0.1 * rng.normal(size=dr)).astype(np.float32)
    return p


@pytest.mark.parametrize("regime", list(LAMS))
@pytest.mark.parametrize("s", [16, 23])
def test_rglru_block_gradients_match_jax_grad(regime, s):
    """The whole block (gate branch, projections, causal conv, gates,
    scan, output projection): its output within 1e-5 and every
    parameter's and the input's gradient within GRAD_RTOL of the leaf's
    largest."""
    jcfg, tcfg, _ = _setup()
    p = _block_params(regime)
    x = np.random.default_rng(s).normal(
        size=(2, s, jcfg.d_model)).astype(np.float32)
    tout, jout, got, want = grads_vs_jax(
        lambda p, x: JR.rglru_train(p, jcfg, x),
        lambda p, x: R.rglru_train(p, tcfg, x), (p, x))
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    assert_grads_close(got, want, GRAD_RTOL)


def test_gates_clamp_where_the_decay_rounds_to_one():
    """``_gates`` across the clamp: lam from 12 to 24, so 1 - a^2 runs
    from ~1e-4 down past 1e-6 to 0.  The gate matrices are diagonal, so
    every output element depends on its own input element alone (no sums
    in another order).  The port's a equals the reference's bit for bit
    on most elements and within one ulp elsewhere (exp / sigmoid
    implementations).  Where a is equal, the clamp's decision is equal,
    and the gated input and its gradient in the input are the
    reference's, clamped (no gradient through the square root) or not
    (a gradient ~1/sqrt(1 - a^2) through it)."""
    jcfg, tcfg, _ = _setup()
    dr = 256
    rng = np.random.default_rng(0)
    sub = {"w_a": np.diag(rng.uniform(0.5, 1.5, dr)).astype(np.float32),
           "w_i": np.diag(rng.uniform(0.5, 1.5, dr)).astype(np.float32),
           "b_a": rng.normal(size=dr).astype(np.float32),
           "b_i": rng.normal(size=dr).astype(np.float32),
           "lam": np.linspace(12.0, 24.0, dr).astype(np.float32)}
    xr = rng.normal(size=(2, 11, dr)).astype(np.float32)
    w = rng.normal(size=xr.shape).astype(np.float32)
    tsub = {k: torch.from_numpy(v) for k, v in sub.items()}
    ja, jg = JR._gates(jax.tree.map(jnp.asarray, sub), jcfg,
                       jnp.asarray(xr))
    ja, jg = np.asarray(ja), np.asarray(jg)
    jdx = np.asarray(jax.grad(lambda x: jnp.sum(
        JR._gates(jax.tree.map(jnp.asarray, sub), jcfg, x)[1] * w))(
        jnp.asarray(xr)))
    tx = torch.from_numpy(xr).requires_grad_()
    ta, tg = R._gates(tsub, tcfg, tx)
    (tdx,) = torch.autograd.grad((tg * torch.from_numpy(w)).sum(), tx)
    ta, tg, tdx = ta.detach().numpy(), tg.detach().numpy(), tdx.numpy()
    same = ja == ta
    assert same.mean() > 0.9
    assert np.abs(ja - ta).max() <= np.spacing(np.float32(0.5))
    clamped = (1.0 - np.square(ja)) < 1e-6
    assert (same & clamped).sum() > 100 and (same & ~clamped).sum() > 100
    np.testing.assert_allclose(tg[same], jg[same], rtol=1e-6, atol=0)
    big = float(np.abs(jdx).max())
    np.testing.assert_allclose(tdx[same], jdx[same], rtol=1e-5,
                               atol=1e-6 * big)
    # a clamped element's gradient has no 1/sqrt(1 - a^2) term; next to
    # the clamp the unclamped ones' does, and both sides have it
    near = same & ~clamped & ((1.0 - np.square(ja)) < 1e-5)
    assert near.any()


@pytest.mark.parametrize("s", [1, 2, 5, 8, 13, 64])
def test_linear_scan_equals_the_sequential_recurrence(s):
    """The doubling scan against the step-by-step recurrence in float64,
    forward and vjp."""
    rng = np.random.default_rng(s)
    a = torch.tensor(rng.uniform(0.0, 1.0, size=(3, s, 5)),
                     requires_grad=True)
    h = torch.tensor(rng.normal(size=(3, s, 5)), requires_grad=True)
    got = R._linear_scan(a, h)
    want, prev = [], torch.zeros(3, 5, dtype=torch.float64)
    for t in range(s):
        prev = a[:, t] * prev + h[:, t]
        want.append(prev)
    want = torch.stack(want, dim=1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    w = torch.tensor(rng.normal(size=(3, s, 5)))
    g1 = torch.autograd.grad((got * w).sum(), (a, h), allow_unused=True)
    g2 = torch.autograd.grad((want * w).sum(), (a, h))
    for x, y in zip(g1, g2):
        x = torch.zeros_like(y) if x is None else x     # s 1: a unread
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)


# ------------------------------------------- recurrentgemma's train step
def _run(steps, **opts):
    jcfg, tcfg, params = _setup()
    return run_train_steps(jcfg, tcfg, params, steps,
                           lambda i: lm_train_batch(tcfg, s=SEQ, seed=i),
                           **opts)


@pytest.mark.parametrize("clip,compress", [(0.0, False), (1.0, True)])
def test_sgd_train_step_matches_reference(clip, compress):
    jl, tl, jp, tp, jm, tm = _run(1, optimizer="sgd", learning_rate=SGD_LR,
                                  grad_clip=clip, compress_smashed=compress)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert_params_within(jp, tp, PARAM_TOL)
    if clip:
        np.testing.assert_allclose(float(tm[0]["grad_norm"]),
                                   float(jm[0]["grad_norm"]), rtol=1e-4)


def test_adamw_train_trajectory_matches_reference():
    jl, tl, *_ = _run(3)                # adamw, lr 3e-4, clip 1.0
    assert max(abs(a - b) for a, b in zip(jl, tl)) <= ADAMW_LOSS_TOL
