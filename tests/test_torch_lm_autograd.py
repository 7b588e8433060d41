"""The LM kernels' autograd on the CPU: rmsnorm, flash_attention and
ssd_chunk_scan are ``torch.autograd.Function``s.  ssd's backward is
``torch.func.vjp`` of the plain version; rmsnorm's and flash's are
Functions of their own (the backward kernels on the card,
``rmsnorm_backward_plain`` and ``attention_backward_plain`` here) with a
``vmap`` rule.  Their gradients against plain autograd;
``torch.func.grad``, ``vjp`` of ``vmap`` (``CohortEngine``'s vmap
schedule) and ``vmap`` of ``grad`` (its fl round) against per-slice
loops, with the vmapped axis on the activations only (folded into the
kernel's batch or rows), on a parameter too (one call per replica), and
for rmsnorm on the scale alone; the SSD with the state's gradient
``None``; a model's gradients with remat on and off; the int8 smashed
boundary's straight-through gradient.  On the CPU the Functions' forward
is the plain version, so every rule here runs the same code as on the
card but the kernel."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads
from repro_torch.configs import get_config
from repro_torch.core import distributed as D
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import quant
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd as SSD
from repro_torch.models import transformer as T
from repro_torch.tree import tree_flatten

cap_torch_threads()

TOL = 1e-6        # the plain versions' own f32 rounding, reassociated


def _randn(*shape, seed=0, scale=1.0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape) * scale).to(dtype)


def _ssd_inputs(b, s, h, p, g, n, seed=0, lead=()):
    x = _randn(*lead, b, s, h, p, seed=seed, scale=0.5)
    dt = torch.nn.functional.softplus(_randn(*lead, b, s, h, seed=seed + 1)
                                      - 2.0)
    a_log = torch.log(torch.linspace(1.0, 4.0, h)).expand(*lead, h).clone()
    B = _randn(*lead, b, s, g, n, seed=seed + 2)
    C = _randn(*lead, b, s, g, n, seed=seed + 3)
    return x, dt, a_log, B, C


def _close(got, want, tol=TOL):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


# ------------------------------------------------------------- gradients
def test_rmsnorm_gradients_equal_plain_autograd():
    """The Function's backward is the closed form here (the kernel's plain
    version): equal to it bit for bit, and to autograd of the plain
    forward within float32 reassociation (1e-5 of each largest
    gradient)."""
    x = _randn(3, 7, 48, seed=0, scale=2.0).requires_grad_()
    s = (_randn(48, seed=1, scale=0.1) + 1.0).requires_grad_()
    w = _randn(3, 7, 48, seed=2)
    got = torch.autograd.grad((RN.rmsnorm(x, s) * w).sum(), (x, s))
    _close(got, RN.rmsnorm_backward_plain(x.detach(), s.detach(), w), 0.0)
    want = torch.autograd.grad((RN.rmsnorm_plain(x, s) * w).sum(), (x, s))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_flash_gradients_equal_plain_autograd(causal, window):
    """The Function's backward is the closed form here (the backward
    kernel's plain version, from the forward's lse): equal to it bit for
    bit, and to autograd of the plain forward within float32
    reassociation (TOL of each largest gradient)."""
    q = _randn(2, 11, 4, 32, seed=0).requires_grad_()
    k = _randn(2, 11, 2, 32, seed=1).requires_grad_()
    v = _randn(2, 11, 2, 32, seed=2).requires_grad_()
    w = _randn(2, 11, 4, 32, seed=3)
    got = torch.autograd.grad(
        (FA.flash_attention(q, k, v, causal=causal, window=window)
         * w).sum(), (q, k, v))
    scale = 32 ** -0.5
    _, lse = FA._plain_forward(q.detach(), k.detach(), v.detach(), causal,
                               window, scale)
    _close(got, FA.attention_backward_plain(
        q.detach(), k.detach(), v.detach(), lse, w, causal=causal,
        window=window, scale=scale), 0.0)
    want = torch.autograd.grad(
        (FA.attention_plain(q, k, v, causal=causal, window=window)
         * w).sum(), (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=TOL * float(b.abs().max()))


@pytest.mark.parametrize("use_state", [False, True])
def test_ssd_gradients_equal_plain_autograd(use_state):
    x, dt, a_log, B, C = _ssd_inputs(2, 13, 4, 8, 2, 4)
    ins = [t.requires_grad_() for t in (x, dt, a_log, B, C)]
    wy = _randn(2, 13, 4, 8, seed=9)
    ws = _randn(2, 4, 4, 8, seed=10)

    def loss(fn):
        y, st = fn(ins[0], ins[1], -torch.exp(ins[2]), ins[3], ins[4])
        out = (y * wy).sum()
        return out + (st * ws).sum() if use_state else out

    got = torch.autograd.grad(
        loss(lambda *a: SSD.ssd_chunk_scan(*a, chunk=4)), ins)
    want = torch.autograd.grad(loss(lambda *a: SSD.ssd_chunked(*a, 4)), ins)
    _close(got, want, 0.0)


def test_ssd_gradient_is_finite_where_the_decay_overflows():
    """dt * A summed over a chunk of 64 reaches -1024, so exp(cum_i -
    cum_j) above the diagonal overflows: the reference masks after exp and
    its gradient there is NaN; the port masks the exponent.  The gradient
    agrees with the literal recurrence's (no chunking)."""
    x, _, _, B, C = _ssd_inputs(2, 80, 4, 8, 1, 4)
    dt = torch.ones(2, 80, 4)
    a_log = torch.log(torch.full((4,), 16.0))

    def grads(fn):
        req = [t.clone().requires_grad_() for t in (x, dt, a_log, B, C)]
        y, st = fn(req[0], req[1], -torch.exp(req[2]), req[3], req[4])
        return torch.autograd.grad((y * 0.1).sum() + st.sum(), req)

    got = grads(lambda *a: SSD.ssd_chunk_scan(*a, chunk=64))
    want = grads(SSD.ssd_naive)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    # x, dt, B, C within 1e-5 of their largest gradient; A_log's true
    # gradient is ~1e-5 here, a sum over every position of terms that
    # cancel, in another order: within 1e-4 of the largest gradient
    scale = max(float(b.abs().max()) for b in want)
    for i, (a, b) in enumerate(zip(got, want)):
        tol = 1e-4 * scale if i == 2 else 1e-5 * float(b.abs().max())
        assert float((a - b).abs().max()) <= tol


# ------------------------------------------------------ torch.func rules
def _rms_case(batched):
    """``batched``: False the activations only, True the scale too,
    "scale" the scale alone (one x for every replica)."""
    x = _randn(3, 5, 6, 32, seed=0, scale=2.0)
    s = _randn(3, 32, seed=1, scale=0.1) + 1.0
    if not batched:
        s = s[0]
    if batched == "scale":
        x = x[0]
    return (lambda a, b: RN.rmsnorm(a, b)), (x, s), \
        (None if batched == "scale" else 0, 0 if batched else None)


def _flash_case(_):
    q = _randn(3, 2, 9, 4, 32, seed=0)
    k = _randn(3, 2, 9, 2, 32, seed=1)
    v = _randn(3, 2, 9, 2, 32, seed=2)
    return (lambda a, b, c: FA.flash_attention(a, b, c)), (q, k, v), \
        (0, 0, 0)


def _ssd_case(batched_a):
    x, dt, a_log, B, C = _ssd_inputs(2, 10, 4, 8, 2, 4, lead=(3,))
    if not batched_a:
        a_log = a_log[0]

    def fn(x, dt, al, B, C):
        return SSD.ssd_chunk_scan(x, dt, -torch.exp(al), B, C, chunk=4)[0]

    return fn, (x, dt, a_log, B, C), (0, 0, 0 if batched_a else None, 0, 0)


CASES = {"rmsnorm-act": (_rms_case, False), "rmsnorm-param": (_rms_case, True),
         "rmsnorm-scale": (_rms_case, "scale"),
         "flash-act": (_flash_case, None), "ssd-act": (_ssd_case, False),
         "ssd-param": (_ssd_case, True)}


def _slices(args, dims, i):
    return [a if d is None else a.select(d, i) for a, d in zip(args, dims)]


@pytest.mark.parametrize("case", list(CASES))
def test_vmap_equals_per_slice_calls(case):
    make, flag = CASES[case]
    fn, args, dims = make(flag)
    got = torch.func.vmap(fn, in_dims=dims)(*args)
    want = torch.stack([fn(*_slices(args, dims, i)) for i in range(3)])
    _close([got], [want], 0.0)


@pytest.mark.parametrize("case", list(CASES))
def test_vjp_of_vmap_equals_per_slice_vjps(case):
    """``CohortEngine._bucket_vmap``: vjp of the vmapped vehicle side."""
    make, flag = CASES[case]
    fn, args, dims = make(flag)
    diff = [i for i, d in enumerate(dims) if d is not None]

    def vfn(*d_args):
        full = list(args)
        for i, a in zip(diff, d_args):
            full[i] = a
        return torch.func.vmap(fn, in_dims=dims)(*full)

    out, vjp = torch.func.vjp(vfn, *[args[i] for i in diff])
    g = _randn(*out.shape, seed=11)
    got = vjp(g)
    for s in range(3):
        sl = _slices(args, dims, s)

        def one(*d_args):
            full = list(sl)
            for i, a in zip(diff, d_args):
                full[i] = a
            return fn(*full)

        _, vjp1 = torch.func.vjp(one, *[sl[i] for i in diff])
        _close([t[s] for t in got], vjp1(g[s]))


@pytest.mark.parametrize("case", list(CASES))
def test_vmap_of_grad_equals_per_slice_grads(case):
    """The fl round: vmap of grad over stacked replicas."""
    make, flag = CASES[case]
    fn, args, dims = make(flag)
    diff = tuple(i for i, d in enumerate(dims) if d is not None)

    def loss(*a):
        return fn(*a).square().sum()

    grad = torch.func.grad(loss, argnums=diff)
    got = torch.func.vmap(grad, in_dims=dims)(*args)
    for s in range(3):
        _close([t[s] for t in got], grad(*_slices(args, dims, s)))


def test_func_grad_equals_autograd():
    fn, args, dims = _ssd_case(True)
    one = [a.select(0, 0) for a in args]
    got = torch.func.grad(lambda *a: fn(*a).sum(), argnums=(0, 2))(*one)
    req = [a.clone().requires_grad_() for a in one]
    want = torch.autograd.grad(fn(*req).sum(), (req[0], req[2]))
    _close(got, want, 0.0)


# ------------------------------------------------------ model-level rules
@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m"])
def test_remat_gives_the_same_gradients(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=3)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves, rebuild = tree_flatten(params)
    grads = []
    for remat in (False, True):
        req = [t.detach().requires_grad_() for t in leaves]
        loss, _ = T.loss_fn(rebuild(req), cfg, batch, remat=remat)
        grads.append(torch.autograd.grad(loss, req))
    _close(grads[1], grads[0], 0.0)
    assert float(grads[0][0].abs().max()) > 0      # the embedding


def test_compressed_boundary_passes_the_gradient_straight_through():
    x = _randn(2, 9, 256, seed=0, scale=3.0).requires_grad_()
    w = _randn(2, 9, 256, seed=1)
    opts = D.DistOptions(compress_smashed=True)
    y = D._cross(x, opts)
    q, s = quant.quantize_int8(x.detach())
    assert torch.equal(y.detach(), quant.dequantize_int8(q, s))
    (g,) = torch.autograd.grad((y * w).sum(), x)
    assert torch.equal(g, w)
    assert D._cross(x, D.DistOptions()) is x
