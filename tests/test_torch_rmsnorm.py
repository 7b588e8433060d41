"""rmsnorm's 16-bit input and its backward on the CPU.

The port's rmsnorm in bfloat16 and float16 (scale in float32 or x's dtype)
against the JAX package's Pallas kernel (interpret mode) and
``rmsnorm_ref``, at the reference's own test shapes, within one ulp of the
working type; ``rmsnorm_backward_plain`` (the closed-form gradient the
CUDA backward kernel is held to on the card) against ``jax.vjp`` of
``rmsnorm_ref`` and ``torch.func.vjp`` of ``rmsnorm_plain``; the backward
Function's ``vmap`` rule (shared, batched and only-batched scales, each
replica's dscale its own); and every autograd route (grad, ``vjp`` of
``vmap``, ``vmap`` of ``grad``, remat) reaching the backward dispatcher
with plain tensors, once per norm, so that on the card it launches the
kernel and never the plain vjp.  Inputs are numpy draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from _torch_parity import cap_torch_threads
from repro.kernels import ref as JREF
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import rmsnorm as RN

cap_torch_threads()

rmsnorm_ref = jax.jit(JREF.rmsnorm_ref)
SHAPES = [(8, 256), (2, 33, 512), (1, 7, 960)]     # tests/test_kernels.py
TORCH_16 = {"bf16": torch.bfloat16, "f16": torch.float16}
JAX_16 = {"bf16": jnp.bfloat16, "f16": jnp.float16}
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}   # stored fraction bits
GRAD_TOL = 1e-5     # of the largest gradient: float32 sums in other orders


def _normal(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _ulp(b: torch.Tensor) -> torch.Tensor:
    """One ulp of each value of the 16-bit tensor b, as float32."""
    m = MANTISSA[b.dtype]
    tiny = torch.finfo(b.dtype).tiny
    _, e = torch.frexp(b.float().abs().clamp_min(tiny))
    return torch.ldexp(torch.ones_like(b, dtype=torch.float32),
                       e - 1 - m)


def _within_one_ulp(a: torch.Tensor, b: torch.Tensor, atol: float = 0.0):
    assert a.dtype == b.dtype and a.shape == b.shape
    err = (a.float() - b.float()).abs()
    assert bool((err <= _ulp(b) + atol).all()), float(err.max())


def _jax_to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(dtype)


# ------------------------------------------------------ 16-bit forward
@pytest.mark.parametrize("same_scale", [False, True],
                         ids=["scale_f32", "scale_same"])
@pytest.mark.parametrize("dt", list(TORCH_16))
@pytest.mark.parametrize("shape", SHAPES)
def test_rmsnorm_16bit_matches_pallas_and_ref(shape, dt, same_scale):
    """x rounded to the 16-bit type first, so both packages see the same
    values; the products in float32 then rounded once, as the reference's
    astype: within one ulp (its float32 sums reassociate)."""
    tdt, jdt = TORCH_16[dt], JAX_16[dt]
    x32 = _normal(shape, 0, 2.0)
    g32 = _normal(shape[-1:], 1, 0.1, 1.0)
    x = torch.from_numpy(x32).to(tdt)
    g = torch.from_numpy(g32).to(tdt if same_scale else torch.float32)
    before = dict(LAUNCHES)
    got = RN.rmsnorm(x, g)
    assert LAUNCHES == before and got.dtype == tdt
    xj = jnp.asarray(x.float().numpy()).astype(jdt)
    gj = jnp.asarray(g.float().numpy()).astype(jdt if same_scale
                                               else jnp.float32)
    pallas = jax_rmsnorm(xj, gj, interpret=True)
    ref = rmsnorm_ref(xj, gj)
    assert pallas.dtype == ref.dtype == jdt
    _within_one_ulp(got, _jax_to_torch(pallas, tdt))
    _within_one_ulp(got, _jax_to_torch(ref, tdt))


def test_kernel_dtypes_are_checked():
    """What the kernels take; anything else raises (on the card, before a
    launch)."""
    f32, bf, h = torch.float32, torch.bfloat16, torch.float16
    for xd, sd in [(f32, f32), (bf, f32), (bf, bf), (h, f32), (h, h)]:
        RN._codes(torch.zeros(2, dtype=xd), torch.zeros(2, dtype=sd))
    for xd, sd in [(torch.float64, torch.float64), (bf, h), (h, bf),
                   (f32, bf), (torch.int32, f32)]:
        with pytest.raises(TypeError, match="rmsnorm kernels"):
            RN._codes(torch.zeros(2, dtype=xd), torch.zeros(2, dtype=sd))


# ------------------------------------------------------------- backward
@pytest.mark.parametrize("shape", SHAPES + [(3, 5, 1001)])
def test_rmsnorm_backward_plain_matches_jax_vjp(shape):
    x = _normal(shape, 2, 2.0)
    g = _normal(shape[-1:], 3, 0.1, 1.0)
    dy = _normal(shape, 4)
    got = RN.rmsnorm_backward_plain(torch.from_numpy(x), torch.from_numpy(g),
                                    torch.from_numpy(dy))
    _, vjp = jax.vjp(rmsnorm_ref, jnp.asarray(x), jnp.asarray(g))
    want_j = vjp(jnp.asarray(dy))
    _, tvjp = torch.func.vjp(RN.rmsnorm_plain, torch.from_numpy(x),
                             torch.from_numpy(g))
    want_t = tvjp(torch.from_numpy(dy))
    for a, bj, bt in zip(got, want_j, want_t):
        bj = np.asarray(bj)
        assert a.shape == bj.shape == bt.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), bj, rtol=0,
                                   atol=GRAD_TOL * np.abs(bj).max())
        torch.testing.assert_close(
            a, bt, rtol=0, atol=GRAD_TOL * float(bt.abs().max()))


@pytest.mark.parametrize("same_scale", [False, True],
                         ids=["scale_f32", "scale_same"])
@pytest.mark.parametrize("dt", list(TORCH_16))
def test_rmsnorm_backward_plain_16bit(dt, same_scale):
    """dx in x's dtype and dscale in the scale's, each the float32 result
    rounded once: within one ulp of the plain vjp's plus the float32
    reassociation (GRAD_TOL of the largest gradient), since dx subtracts
    two terms of similar size."""
    tdt = TORCH_16[dt]
    x = torch.from_numpy(_normal((4, 9, 256), 5, 2.0)).to(tdt)
    g = torch.from_numpy(_normal((256,), 6, 0.1, 1.0)).to(
        tdt if same_scale else torch.float32)
    dy = torch.from_numpy(_normal((4, 9, 256), 7)).to(tdt)
    dx, ds = RN.rmsnorm_backward_plain(x, g, dy)
    _, vjp = torch.func.vjp(RN.rmsnorm_plain, x, g)
    want_x, want_s = vjp(dy)
    assert dx.dtype == tdt and ds.dtype == g.dtype
    _within_one_ulp(dx, want_x, GRAD_TOL * float(want_x.float().abs().max()))
    if same_scale:
        _within_one_ulp(ds, want_s,
                        GRAD_TOL * float(want_s.float().abs().max()))
    else:
        torch.testing.assert_close(
            ds, want_s, rtol=0,
            atol=GRAD_TOL * float(want_s.abs().max()))


def test_rmsnorm_backward_checks_shapes():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="trailing dim"):
        RN.rmsnorm_backward(x, torch.ones(4), x)
    with pytest.raises(ValueError, match="does not match x"):
        RN.rmsnorm_backward(x, torch.ones(8), torch.zeros(2, 4))


# (x's in_dim, scale's in_dim, dy's in_dim) of a vmap over 3 replicas
VMAP_DIMS = {"shared_scale": (0, None, 0), "batched_scale": (0, 0, 0),
             "scale_only": (None, 0, 0), "dy_only": (None, None, 0),
             "moved_axis": (1, 0, 1)}


@pytest.mark.parametrize("case", list(VMAP_DIMS))
def test_backward_vmap_rule_keeps_each_replica_dscale(case):
    dims = VMAP_DIMS[case]
    base = [_normal((5, 7, 64), 8, 2.0), _normal((64,), 9, 0.1, 1.0),
            _normal((5, 7, 64), 10)]
    args = []
    for a, dim, seed in zip(base, dims, (11, 12, 13)):
        if dim is None:
            args.append(torch.from_numpy(a))
            continue
        st = np.stack([a + 0.1 * i * _normal(a.shape, seed) for i in
                       range(3)])
        args.append(torch.from_numpy(np.moveaxis(st, 0, dim).copy()))
    got = torch.func.vmap(RN.rmsnorm_backward, in_dims=dims)(*args)
    for i in range(3):
        sl = [a if d is None else a.select(d, i) for a, d in zip(args, dims)]
        want = RN.rmsnorm_backward_plain(*sl)
        for a, b in zip(got, want):
            torch.testing.assert_close(a[i], b, rtol=0, atol=1e-6 * float(
                b.abs().max()))


# ---------------------------------------------------- autograd routes
@pytest.fixture
def backward_calls(monkeypatch):
    """Every call of the backward dispatcher (the kernel on the card):
    (x's shape, groups, whether any input is a functorch wrapper)."""
    calls = []
    inner = RN._backward
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor

    def spy(x, scale, dy, eps, groups=0):
        calls.append((tuple(x.shape), groups,
                      wrapped(x) or wrapped(scale) or wrapped(dy)))
        return inner(x, scale, dy, eps, groups)

    monkeypatch.setattr(RN, "_backward", spy)
    return calls


def _route_inputs():
    x = torch.from_numpy(_normal((3, 4, 6, 32), 14, 2.0))
    s = torch.from_numpy(np.stack([_normal((32,), 15 + i, 0.1, 1.0)
                                   for i in range(3)]))
    return x, s


def _two_norms(a, b):
    return RN.rmsnorm(RN.rmsnorm(a, b) * 1.5, b)


def _per_slice_grads(x, s, dims):
    out = []
    for i in range(x.shape[0]):
        a = x[i]
        b = s if dims[1] is None else s[i]
        a, b = a.clone().requires_grad_(), b.clone().requires_grad_()
        out.append(torch.autograd.grad(_two_norms(a, b).square().sum(),
                                       (a, b)))
    return out


# route -> (backward calls, groups of each) for two norms over 3 replicas
ROUTES = {"grad": (2, 0), "remat": (2, 0), "vjp_of_vmap_fold": (2, 0),
          "vjp_of_vmap_loop": (6, 0), "vmap_of_grad_fold": (2, 3),
          "vmap_of_grad_loop": (2, 3)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_every_route_reaches_the_backward_kernel(route, backward_calls):
    """Each norm's backward reaches the dispatcher with plain tensors (the
    kernel on the card, never the plain vjp); ``vmap`` of ``grad`` folds
    the replicas into one call a norm with a dscale each; the gradients
    equal per-replica autograd."""
    x, s = _route_inputs()
    n_calls, groups = ROUTES[route]
    if route in ("grad", "remat"):
        a = x[0].clone().requires_grad_()
        b = s[0].clone().requires_grad_()
        fn = ((lambda u, v: checkpoint(_two_norms, u, v,
                                       use_reentrant=False))
              if route == "remat" else _two_norms)
        got = [torch.autograd.grad(fn(a, b).square().sum(), (a, b))]
        calls = list(backward_calls)
        want = _per_slice_grads(x[:1], s[:1], (0, 0))
    elif route.startswith("vjp_of_vmap"):
        dims = (0, None) if route.endswith("fold") else (0, 0)
        sv = s[0] if dims[1] is None else s
        out, vjp = torch.func.vjp(
            lambda a, b: torch.func.vmap(_two_norms, in_dims=dims)(a, b),
            x, sv)
        gx, gs = vjp(2 * out)
        got = [(gx[i], gs if dims[1] is None else gs[i]) for i in range(3)]
        calls = list(backward_calls)
        want = _per_slice_grads(x, sv, dims)
        if dims[1] is None:     # the shared scale's gradient sums replicas
            want = [(w[0], sum(v[1] for v in want)) for w in want]
    else:
        dims = (0, None) if route.endswith("fold") else (0, 0)
        sv = s[0] if dims[1] is None else s
        grad = torch.func.grad(lambda a, b: _two_norms(a, b).square().sum(),
                               argnums=(0, 1))
        gx, gs = torch.func.vmap(grad, in_dims=dims)(x, sv)
        got = [(gx[i], gs[i]) for i in range(3)]
        calls = list(backward_calls)
        want = _per_slice_grads(x, sv, dims)
    assert len(calls) == n_calls
    assert all(c[1] == groups and not c[2] for c in calls)
    for g_got, g_want in zip(got, want):
        for a, b in zip(g_got, g_want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(
                b.abs().max()))


def test_no_gradient_skips_both_functions(backward_calls):
    x, s = _route_inputs()
    with torch.no_grad():
        RN.rmsnorm(x.requires_grad_(), s[0])
    RN.rmsnorm(x.detach(), s[0])
    assert backward_calls == []
