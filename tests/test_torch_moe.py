"""The MoE FFN (deepseek-v2-lite-16b's and dbrx-132b's) against the JAX
package on the CPU: the router (softmax, top-k with the reference's tie
order, renormalised gates, the aux loss) decision for decision; the dense
all-experts path; the grouped GShard dispatch with capacity drops (the
kept slots exact, the output within 1e-6); ``moe_forward`` on both paths;
the path threshold, group choice and capacity at full width.  Parameters
come from the reference's threefry init; inputs are numpy draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads, lm_configs
from repro.configs import get_config as jax_config
from repro.models import moe as JE
from repro_torch.configs import get_config
from repro_torch.models import moe as E

cap_torch_threads()

TOL = 1e-6          # f32 at d_model 256, summed in another order
ARCH = "deepseek-v2-lite-16b"


def _configs(**moe):
    jcfg, tcfg = lm_configs(ARCH)
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe))
    return jcfg, tcfg


def _params(jcfg, seed=0):
    p = jax.tree.map(np.asarray, JE.init_moe(jax.random.PRNGKey(seed), jcfg))
    return p, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)


def _x(t, d, seed):
    return np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)


def _route_both(jcfg, tcfg, p, tp, x):
    _, jg, ji, _, jaux = jax.jit(JE._route, static_argnums=1)(
        p, jcfg, jnp.asarray(x))
    probs, tg, ti, taux = E._route(tp, tcfg, torch.from_numpy(x))
    return (np.asarray(jg), np.asarray(ji), float(jaux)), (
        tg.numpy(), ti.numpy(), float(taux), probs)


def _ref_keep(idx, e, cap, g):
    """The reference's kept slots (moe.py's pos < cap), from its
    expert_idx, in jnp."""
    t, k = idx.shape
    onehot = jax.nn.one_hot(jnp.asarray(idx).reshape(g, t // g, k), e,
                            dtype=jnp.int32)
    flat = onehot.reshape(g, t // g * k, e)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    return np.asarray(jnp.sum(pos * onehot, axis=-1) < cap)


def test_init_moe_layout_and_the_f32_router():
    jcfg, tcfg = _configs()
    p, _ = _params(jcfg)
    mine = E.init_moe(torch.Generator().manual_seed(0), tcfg,
                      torch.float64)
    assert set(mine) == set(p) and set(mine["shared"]) == set(p["shared"])
    for key in ("router", "wi_gate", "wi_up", "wo"):
        assert tuple(mine[key].shape) == p[key].shape
    assert mine["router"].dtype == torch.float32
    assert mine["wo"].dtype == torch.float64


@pytest.mark.parametrize("t", [7, 64, 512])
def test_routing_decisions_match_reference(t, record_property):
    """Expert choices exact on random data; gates and aux within 1e-6.
    The smallest gap between the k-th and (k+1)-th probability is
    reported: a flip from summation order would sit at such a gap."""
    jcfg, tcfg = _configs()
    p, tp = _params(jcfg, 1)
    x = _x(t, jcfg.d_model, t)
    (jg, ji, jaux), (tg, ti, taux, probs) = _route_both(jcfg, tcfg, p, tp, x)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(taux, jaux, rtol=TOL, atol=TOL)
    k = tcfg.moe.top_k
    srt = torch.sort(probs, dim=-1, descending=True).values
    margin = float((srt[:, k - 1] - srt[:, k]).min())
    record_property("smallest_topk_margin", margin)
    print(f"t={t} smallest top-k margin {margin:g}")


@pytest.mark.parametrize("arch", [ARCH, "dbrx-132b"])
def test_top_k_ties_pick_the_lower_experts(arch):
    """A zero router: every probability is 1/E, and both packages pick
    experts 0..k-1 in that order, at the full config's E and k."""
    from repro.configs.dbrx_132b import CONFIG as JDBRX
    from repro_torch.configs.dbrx_132b import CONFIG as TDBRX
    jcfg, tcfg = ((jax_config(arch), get_config(arch)) if arch == ARCH
                  else (JDBRX, TDBRX))
    m = tcfg.moe
    p = {"router": np.zeros((8, m.n_experts), np.float32)}
    tp = {"router": torch.zeros(8, m.n_experts)}
    x = _x(5, 8, 0)
    (jg, ji, _), (tg, ti, _, _) = _route_both(jcfg, tcfg, p, tp, x)
    want = np.broadcast_to(np.arange(m.top_k), (5, m.top_k))
    np.testing.assert_array_equal(ji, want)
    np.testing.assert_array_equal(ti, want)
    np.testing.assert_allclose(tg, 1.0 / m.top_k, rtol=1e-7)
    # a tie inside the top k and one across its edge
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.1],
                          [0.25, 0.25, 0.25, 0.25, 0.0]])
    vals, idx = E.top_k(probs, 2)
    jv, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("t", [1, 18, 40])
def test_dense_path_matches_reference(t):
    jcfg, tcfg = _configs()
    assert E.uses_dense_path(tcfg, t)
    p, tp = _params(jcfg, 2)
    x = _x(t, jcfg.d_model, 10 + t)
    jy, jaux = jax.jit(JE.moe_forward, static_argnums=1)(p, jcfg,
                                                         jnp.asarray(x))
    ty, taux = E.moe_forward(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cf,g", [(0.5, 2), (0.5, 4), (2.0, 2)])
def test_grouped_path_drops_the_reference_slots(cf, g):
    """``_experts_grouped`` with ``n_groups`` given, from the reference's
    routing: the kept (token, choice) slots equal the reference's, the
    output is within 1e-6.  At capacity factor 0.5 slots are dropped."""
    jcfg, tcfg = _configs(capacity_factor=cf)
    p, tp = _params(jcfg, 3)
    t = 64
    x = _x(t, jcfg.d_model, 4)
    _, jg, ji, _, _ = JE._route(p, jcfg, jnp.asarray(x))
    want = np.asarray(jax.jit(JE._experts_grouped, static_argnums=(1, 5))(
        p, jcfg, jnp.asarray(x), jg, ji, g))
    got, keep = E._experts_grouped(tp, tcfg, torch.from_numpy(x),
                                   torch.from_numpy(np.array(jg)),
                                   torch.from_numpy(np.array(ji)).long(), g)
    m = tcfg.moe
    cap = max(4, min(int(np.ceil(t // g * m.top_k / m.n_experts * cf)),
                     t // g))
    ref_keep = _ref_keep(np.asarray(ji), m.n_experts, cap, g)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    if cf < 1:
        assert 0 < int(keep.sum()) < keep.numel()     # some dropped
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_moe_forward_on_the_grouped_path(monkeypatch):
    """With the dense budget at 0 on both sides, ``moe_forward`` takes the
    grouped path (the group choice, capacity, shared expert and aux of the
    reference's own call), and drops slots at capacity factor 0.5."""
    monkeypatch.setattr(JE, "DENSE_PATH_MAX_ELEMENTS", 0)
    monkeypatch.setattr(E, "DENSE_PATH_MAX_ELEMENTS", 0)
    kept = []
    grouped = E._experts_grouped

    def spy(*args):
        y, keep = grouped(*args)
        kept.append(keep)
        return y, keep
    monkeypatch.setattr(E, "_experts_grouped", spy)
    jcfg, tcfg = _configs(capacity_factor=0.5)
    p, tp = _params(jcfg, 5)
    x = np.random.default_rng(6).normal(size=(4, 600, jcfg.d_model)).astype(
        np.float32)            # t = 2400: 2 groups of 1200
    assert E._pick_groups(2400) == JE._pick_groups(2400) == 2
    jy, jaux = JE.moe_forward(p, jcfg, jnp.asarray(x))
    ty, taux = E.moe_forward(tp, tcfg, torch.from_numpy(x))
    assert len(kept) == 1 and kept[0].shape == (2, 1200, tcfg.moe.top_k)
    assert 0 < int(kept[0].sum()) < kept[0].numel()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL, atol=TOL)


def test_path_threshold_groups_and_capacity_match_reference():
    """The rule T * E * d_ff <= 2^27 on both sides of the edge (checked
    as a choice, no path run), the group choice and the capacity; at full
    width a batch-8 x 1024 prefill is grouped (8 groups, capacity 120),
    a decode step and a batch-1 x 1024 prefill are dense."""
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    m = tcfg.moe
    per_token = m.n_experts * m.d_ff_expert
    edge = E.DENSE_PATH_MAX_ELEMENTS // per_token
    assert E.DENSE_PATH_MAX_ELEMENTS == JE.DENSE_PATH_MAX_ELEMENTS == 2 ** 27
    for t in (1, 8, 1023, 1024, edge, edge + 1, 8192, 10 ** 5):
        ref = t * m.n_experts * JE._expert_ff(jcfg) <= \
            JE.DENSE_PATH_MAX_ELEMENTS
        assert E.uses_dense_path(tcfg, t) == ref, t
    assert E.uses_dense_path(tcfg, edge) and \
        not E.uses_dense_path(tcfg, edge + 1)
    assert E.uses_dense_path(tcfg, 8) and E.uses_dense_path(tcfg, 1024)
    assert not E.uses_dense_path(tcfg, 8192)
    assert E._pick_groups(8192) == 8 and E.capacity(8192, tcfg) == 120
    for t in (1, 7, 1000, 1024, 2400, 3001, 8192, 8191, 65536):
        assert E._pick_groups(t) == JE._pick_groups(t), t
        assert E.capacity(t, tcfg) == JE.capacity(t, jcfg), t


@pytest.mark.parametrize("arch", [ARCH, ARCH + "-smoke"])
def test_moe_flops_match_reference(arch):
    assert E.moe_flops(get_config(arch)) == JE.moe_flops(jax_config(arch))
