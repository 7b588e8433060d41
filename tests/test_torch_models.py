"""The port's models against the JAX reference on the same weights (carried
by repro_torch.bridge) and the same numpy inputs: every ResNet18 unit
forward and the head loss at batch 2, and the split MLP.

Tolerance rtol=atol=1e-5 in float32: XLA:CPU and oneDNN sum convolutions in
different orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (cap_torch_threads, jax_params_np,
                           port_params_from_jax)
from repro.core import fedsim as JF
from repro.models import mlp_unit as JM
from repro.models import resnet as JR
from repro_torch import bridge
from repro_torch.core import fedsim as TF
from repro_torch.models import mlp_unit as TM
from repro_torch.models import resnet as TR

cap_torch_threads()

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def resnet_params():
    p = JR.init_resnet18(jax.random.PRNGKey(0))
    return p, port_params_from_jax(p["units"], p["head"])


def _unit_input(idx, batch=2, seed=0):
    """A numpy input of unit idx's entry shape (the smashed shape at
    split point idx; images for the stem)."""
    rng = np.random.default_rng(seed + idx)
    shape = (batch, 32, 32, 3) if idx == 0 else JR.smashed_shape(idx, batch)
    a = rng.normal(size=shape)
    return (np.abs(a) if idx else a).astype(np.float32)  # post-ReLU inputs


@pytest.mark.parametrize("idx", range(JR.N_UNITS))
def test_resnet_unit_forward_matches_jax(resnet_params, idx):
    p, (tu, _) = resnet_params
    x = _unit_input(idx)
    yj = np.asarray(JR._apply_unit(p["units"][idx], jnp.asarray(x), idx))
    yt = TR.apply_unit(tu[idx], torch.from_numpy(x), idx)
    assert tuple(yt.shape) == yj.shape
    np.testing.assert_allclose(yt.numpy(), yj, **TOL)


def test_resnet_head_loss_matches_jax(resnet_params):
    p, (_, th) = resnet_params
    feats = np.abs(np.random.default_rng(9).normal(
        size=(2, 4, 4, 512))).astype(np.float32)
    labels = np.array([3, 7], np.int32)
    lj, gj = JF.ResNetModel().head_loss(p["head"], jnp.asarray(feats),
                                        jnp.asarray(labels))
    lt, gt = TF.ResNetModel().head_loss(th, torch.from_numpy(feats),
                                        torch.from_numpy(labels))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)
    np.testing.assert_allclose(float(lt), float(lj), **TOL)


def test_resnet_shapes_and_profile_match():
    for cut in range(1, JR.N_UNITS + 1):
        assert TR.smashed_shape(cut, 16) == JR.smashed_shape(cut, 16)
    for i in range(JR.N_UNITS):
        assert TR.unit_flops(i) == JR.unit_flops(i)
    from repro.core import cost as JC
    from repro_torch.core import cost as TC
    a, b = JC.resnet_profile(), TC.resnet_profile()
    for field in ("unit_fwd_flops", "unit_param_bytes",
                  "smashed_bytes_per_sample", "head_flops",
                  "head_param_bytes", "smashed_trailing_dim"):
        assert getattr(a, field) == getattr(b, field), field


def test_resnet_init_structure_and_bridge_round_trip(resnet_params):
    p, (tu, th) = resnet_params
    units_np, head_np = jax_params_np(p["units"], p["head"])
    back_u, back_h = bridge.params_to_numpy(tu, th)
    for a, b in zip(jax.tree.leaves(units_np) + jax.tree.leaves(head_np),
                    jax.tree.leaves(back_u) + jax.tree.leaves(back_h)):
        assert np.array_equal(a, b)
    own_u, own_h = TF.ResNetModel().init(torch.Generator().manual_seed(0))
    for a, b in zip(own_u, tu):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], dict):
                assert all(a[k][j].shape == b[k][j].shape for j in a[k])
            else:
                assert a[k].shape == b[k].shape
    assert own_h["w"].shape == th["w"].shape


def test_mlp_units_and_head_match_jax():
    jm, tm = JM.MLPUnitModel(), TM.MLPUnitModel()
    units, head = jm.init(jax.random.PRNGKey(3))
    tu, th = port_params_from_jax(units, head)
    x = np.random.default_rng(2).normal(size=(8, 48)).astype(np.float32)
    y = np.arange(8, dtype=np.int32) % 10
    fj = jm.apply_units(units, jnp.asarray(x), 0)
    ft = tm.apply_units(tu, torch.from_numpy(x), 0)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL)
    lj, _ = jm.head_loss(head, fj, jnp.asarray(y))
    lt, _ = tm.head_loss(th, ft, torch.from_numpy(y))
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
    pj, pt = jm.profile(), tm.profile()
    assert pj.unit_fwd_flops == pt.unit_fwd_flops
    assert pj.unit_param_bytes == pt.unit_param_bytes


def test_mlp_fleet_data_replays_exactly():
    jc, jt = JM.make_mlp_fleet_data(4, 16, seed=5, n_test=32)
    tc, tt = TM.make_mlp_fleet_data(4, 16, seed=5, n_test=32)
    for a, b in zip(jc, tc):
        assert np.array_equal(a.images, b.images)
        assert np.array_equal(a.labels, b.labels)
    assert np.array_equal(np.asarray(jt["images"]), tt["images"])
    assert np.array_equal(np.asarray(jt["labels"]), tt["labels"])
