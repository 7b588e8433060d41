"""The SSD chunk scan on 16-bit inputs against the JAX package on the CPU.

The reference's Pallas kernel (``repro/kernels/ssd.py``) takes any input
dtype: it widens x, dt, B and C to float32 as it loads them, computes in
float32 and writes y in x's dtype; its ``models/ssm.ssd_chunked`` does the
same and returns the float32 state.  The port's ``ssd_chunk_scan`` (its
plain version on CPU tensors; the CUDA kernels widen on load the same way)
is held to both in bfloat16 and float16, with dt and A in float32 (as the
model gives them) or in x's dtype:

- y of x's dtype within one ulp of that dtype plus F32_TOL of the
  reference's (both compute in float32 and round once), the state float32
  within F32_TOL;
- the gradients of ``sum(y * w)`` through the port's Function (its
  backward the plain version's vjp) against ``jax.grad`` of the
  reference's ``ssd_chunked`` in the 16-bit dtype and in float32 on the
  same values: each in its input's dtype; dt's and A's (float32) within
  F32_TOL of the leaf's largest; x's, B's and C's (16-bit) within
  GRAD_ULPS_F32 = 1 ulp of the dtype at the leaf's largest |value| of the
  float32 run, and within GRAD_ULPS_REF = 2 of the reference's 16-bit run.
  Both sides sum the cotangents of B and C over a group's heads in 16 bits
  (their repeat runs before the widening) and the reference also x's two
  uses, so a small element carries many of its own ulps; set from the
  readings over seeds 1-3: port against float32 at most 0.82 ulps at the
  largest, the reference's own run 1.04, port against reference 1.0.

Inputs are numpy float32 draws rounded once to the 16-bit dtype on each
side (the same values bit for bit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads, low_precision, ulp_np
from repro.kernels.ssd import ssd_chunk_scan as jax_ssd
from repro.models import ssm as JS
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ssd as SSD

cap_torch_threads()

ssd_chunked_ref = jax.jit(JS.ssd_chunked, static_argnums=5)
jax_ssd_kernel = jax.jit(jax_ssd, static_argnames=("chunk", "interpret"))

F32_TOL = 2e-5      # f32 tolerance of the reference's own kernel tests
CHUNK = 16
DTYPES = ("bfloat16", "float16")
# the gradient of sum(y * w) in float32, one compile for both dtypes' runs
grad_f32 = jax.jit(jax.grad(
    lambda x, dt, A, B, C, w: jnp.sum(JS.ssd_chunked(x, dt, A, B, C,
                                                     CHUNK)[0] * w),
    argnums=(0, 1, 2, 3, 4)))


def _inputs(dtype, dt16, seed=0):
    """(numpy arrays for the reference, tensors for the port) of x, dt, A,
    B, C: x / B / C in ``dtype``, dt and A too when ``dt16``; b 2, s 40
    (a ragged last chunk of 16), 4 heads over 2 groups, p 16, n 8."""
    rng = np.random.default_rng(seed)
    b, s, h, p, g, n = 2, 40, 4, 16, 2, 8
    x = (rng.normal(size=(b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(h,)) * 0.3)).astype(np.float32)
    B = (rng.normal(size=(b, s, g, n)) * 0.5).astype(np.float32)
    C = (rng.normal(size=(b, s, g, n)) * 0.5).astype(np.float32)
    low = [True, dt16, dt16, True, True]
    pairs = [low_precision(a, dtype) if lo else (a, torch.from_numpy(a))
             for a, lo in zip((x, dt, A, B, C), low)]
    return [a for a, _ in pairs], [t for _, t in pairs]


def _within(got, want, dtype, big=None):
    """|got - want| <= one ulp of ``dtype`` at |want| + F32_TOL (of
    ``big``, a leaf's largest |value|, when given; else absolute +
    relative)."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    bound = ulp_np(want, dtype) + (F32_TOL * max(big, 1.0) if big is not None
                                   else F32_TOL + F32_TOL * np.abs(want))
    err = np.abs(got - want)
    assert np.isfinite(got).all()
    assert (err <= bound).all(), float((err - bound).max())


@pytest.mark.parametrize("dt16", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_16bit_matches_reference_kernel_and_chunked(dtype, dt16):
    """y in x's dtype and the float32 state against the Pallas kernel
    (interpret) and ``ssd_chunked``; no kernel launch on CPU tensors."""
    ref_in, port_in = _inputs(dtype, dt16)
    before = dict(LAUNCHES)
    y, st = SSD.ssd_chunk_scan(*port_in, chunk=CHUNK)
    assert LAUNCHES == before
    assert y.dtype == port_in[0].dtype and st.dtype == torch.float32
    jin = [jnp.asarray(a) for a in ref_in]
    yk = jax_ssd_kernel(*jin, chunk=CHUNK, interpret=True)
    jy, jst = ssd_chunked_ref(*jin, CHUNK)
    assert yk.dtype == jy.dtype == jnp.dtype(dtype)
    y32 = y.float().numpy()
    _within(y32, yk, dtype)
    _within(y32, jy, dtype)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=F32_TOL,
                               atol=F32_TOL)


GRAD_ULPS_F32 = 1
GRAD_ULPS_REF = 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_16bit_gradients_match_jax_grad(dtype, record_property):
    """Every input's gradient of sum(y * w) in its own dtype on both sides
    (x / B / C 16-bit, dt / A float32), held as the module docstring says
    to ``jax.grad`` of the reference in the 16-bit dtype and in float32 on
    the same values (w rounded to the dtype, as y's cotangent is)."""
    ref_in, port_in = _inputs(dtype, False, seed=1)
    w = np.random.default_rng(9).normal(
        size=ref_in[0].shape).astype(np.float32)
    w_low = np.asarray(jnp.asarray(w).astype(dtype), dtype=np.float32)
    want = jax.jit(jax.grad(
        lambda *a: jnp.sum(JS.ssd_chunked(*a, CHUNK)[0].astype(jnp.float32)
                           * w), argnums=(0, 1, 2, 3, 4)))(
        *[jnp.asarray(a) for a in ref_in])
    exact = grad_f32(*[jnp.asarray(np.asarray(a, dtype=np.float32))
                       for a in ref_in], jnp.asarray(w_low))
    req = [t.clone().requires_grad_(True) for t in port_in]
    y, _ = SSD.ssd_chunk_scan(*req, chunk=CHUNK)
    got = torch.autograd.grad((y.float() * torch.from_numpy(w)).sum(), req)
    worst = {}
    for i, (g, r, f, t) in enumerate(zip(got, want, exact, port_in)):
        name = str(t.dtype).replace("torch.", "")
        assert g.dtype == t.dtype and str(r.dtype) == name, i
        g32, r32 = g.float().numpy(), np.asarray(r, dtype=np.float32)
        f32 = np.asarray(f)
        big = float(np.abs(f32).max())
        assert np.isfinite(g32).all(), i
        if name == "float32":
            assert np.abs(g32 - f32).max() <= F32_TOL * big, i
            assert np.abs(g32 - r32).max() <= F32_TOL * big, i
            continue
        ulp = float(ulp_np(np.float32(big), dtype))
        worst[i] = (float(np.abs(g32 - f32).max()) / ulp,
                    float(np.abs(g32 - r32).max()) / ulp)
        assert worst[i][0] <= GRAD_ULPS_F32, (i, worst[i])
        assert worst[i][1] <= GRAD_ULPS_REF, (i, worst[i])
    record_property("grad_ulps_vs_f32_and_ref", worst)
