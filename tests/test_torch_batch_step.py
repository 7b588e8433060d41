"""One SFL batch step (make_sfl_batch_step) of the port against the JAX
oracle, same weights and batch, wire="none".

* sgd: loss and updated parameters within 1e-5 (float32 summation order of
  the convolutions; lr 1e-4 as in the paper, 1e-2 on the MLP), and the step
  moved the parameters by more than that tolerance;
* adam: parameters within 2*lr absolute (plus float32 rounding of the
  parameter): a coordinate whose tiny gradient differs in sign between the
  two summation orders moves by +lr on one side and -lr on the other."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (cap_torch_threads, leaves_np, max_abs_diff,
                           port_leaves_np, port_params_from_jax)
from repro import optim as JO
from repro.core import fedsim as JF
from repro.models import mlp_unit as JM
from repro.models import resnet as JR
from repro_torch import optim as TO
from repro_torch.core import fedsim as TF
from repro_torch.models import mlp_unit as TM

cap_torch_threads()


def _step_both(jmodel, tmodel, units, head, cut, opt, lr, x, y):
    cfg = dict(optimizer=opt, lr=lr, wire="none")
    jstep = JF.make_sfl_batch_step(jmodel, JF.SimConfig(**cfg), cut)
    tstep = TF.make_sfl_batch_step(tmodel, TF.SimConfig(**cfg), cut)
    jo, to = JO.from_name(opt, lr), TO.from_name(opt, lr)
    tu, th = port_params_from_jax(units, head)
    jr = jstep(units[:cut], units[cut:], head, jo.init(units[:cut]),
               jo.init({"units": units[cut:], "head": head}),
               {"images": jnp.asarray(x), "labels": jnp.asarray(y)})
    tr = tstep(tu[:cut], tu[cut:], th, to.init(tu[:cut]),
               to.init({"units": tu[cut:], "head": th}),
               {"images": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    j_new = leaves_np(list(jr[0]) + list(jr[1]), jr[2])
    t_new = port_leaves_np(list(tr[0]) + list(tr[1]), tr[2])
    moved = max_abs_diff(j_new, leaves_np(units, head))
    return float(jr[5]), float(tr[5]), max_abs_diff(j_new, t_new), moved


@pytest.fixture(scope="module")
def resnet_init():
    p = JR.init_resnet18(jax.random.PRNGKey(1))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = np.array([1, 2, 3, 4], np.int32)
    return p["units"], p["head"], x, y


@pytest.mark.parametrize("opt,lr", [("sgd", 1e-4), ("adam", 1e-4)])
@pytest.mark.parametrize("cut", [2, 8])
def test_resnet_batch_step_matches_jax(resnet_init, cut, opt, lr):
    units, head, x, y = resnet_init
    lj, lt, diff, moved = _step_both(JF.ResNetModel(), TF.ResNetModel(),
                                     units, head, cut, opt, lr, x, y)
    assert abs(lj - lt) <= 1e-5
    if opt == "sgd":
        assert diff <= 1e-5 and moved > 1e-5
    else:
        assert diff <= 2 * lr * (1 + 1e-3)


@pytest.mark.parametrize("opt,lr", [("sgd", 1e-2), ("adam", 1e-3)])
@pytest.mark.parametrize("cut", [2, 4, 6, 8])
def test_mlp_batch_step_matches_jax(cut, opt, lr):
    units, head = JM.MLPUnitModel().init(jax.random.PRNGKey(cut))
    rng = np.random.default_rng(cut)
    x = rng.normal(size=(8, 48)).astype(np.float32)
    y = (np.arange(8) % 10).astype(np.int32)
    lj, lt, diff, moved = _step_both(JM.MLPUnitModel(), TM.MLPUnitModel(),
                                     units, head, cut, opt, lr, x, y)
    assert abs(lj - lt) <= 1e-5
    if opt == "sgd":
        assert diff <= 1e-5 and moved > 1e-5
    else:
        assert diff <= 2 * lr * (1 + 1e-3)


def test_optimizers_match_jax_on_a_tree():
    """sgd / momentum / adam over a small tree, three updates in a row."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": [rng.normal(size=(4,)).astype(np.float32)]}
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32), params) for _ in range(3)]
    for name in ("sgd", "momentum", "adam"):
        jo, to = JO.from_name(name, 1e-2), TO.from_name(name, 1e-2)
        jp = jax.tree.map(jnp.asarray, params)
        tp = jax.tree.map(torch.from_numpy, params)
        js, ts = jo.init(jp), to.init(tp)
        for g in grads:
            ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
            jp = JO.apply_updates(jp, ju)
            tu, ts = to.update(jax.tree.map(torch.from_numpy, g), ts, tp)
            tp = TO.apply_updates(tp, tu)
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(
                jax.tree.map(lambda t: t.numpy(), tp))):
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)
        assert int(ts["count"]) == int(js["count"]) == 3
