"""flash_attention's backward on the CPU.

On a CUDA tensor the gradient of ``flash_attention`` is the hand-written
kernel ``repro_flash_attention_backward`` (``kernels/csrc/lm.cu``); on a
CPU tensor it is the kernel's plain version,
:func:`attention_backward_plain`, FlashAttention-2's closed form from the
forward's ``lse``: P = exp(S scale - lse), D = rowsum(P o dP), dS = P o
(dP - D), in float32, the gradients in q's dtype.  Held here:

- the closed form against ``torch.func.vjp`` of :func:`attention_plain`
  within 1e-6 of the largest gradient (float32 math in another order), at
  every head dim the kernel takes, GQA groups of 1, 2 and 4, causal and
  not, windows that mask keys, ``sq < sk`` and ``sq > sk`` with rows that
  see no key (their dq exactly 0); bfloat16 inputs one ulp of bfloat16
  more (both round float32 math once);
- on numpy inputs, against ``jax.vjp`` of the JAX package's
  ``attention_ref`` within 1e-5 of the largest gradient;
- the plain forward's ``lse`` against the logsumexp of the reference's
  masked scores (+inf where a row sees no key);
- ``_FlashBackward``'s ``vmap`` rule (the replicas folded into the batch)
  against the per-slice calls, bit for bit, and the wrapper's dispatch: a
  CPU tensor launches nothing.

The card holds the kernel to the closed form and to the plain vjp
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 4b and 10f)."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads
from repro.kernels import ref as JREF
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import flash_attention as FA

cap_torch_threads()

TOL = 1e-6       # float32 reassociation, of the largest gradient
JAX_TOL = 1e-5   # against the reference's jax.vjp, of the largest gradient
# (d, sq, sk, h, kv, causal, window): every head dim, GQA groups 1 / 2 / 4,
# a window that masks keys, sq < sk and sq > sk, rows with no visible key
# (non-causal under a window with sq > sk + window)
CASES = [(32, 16, 16, 4, 4, True, 0), (64, 24, 24, 4, 2, True, 0),
         (128, 40, 40, 8, 2, True, 0), (256, 20, 20, 4, 1, True, 0),
         (64, 33, 33, 4, 2, True, 8), (32, 40, 40, 2, 1, False, 0),
         (64, 20, 36, 4, 2, True, 0), (64, 36, 20, 4, 2, True, 0),
         (64, 40, 16, 4, 2, False, 8), (128, 16, 40, 4, 4, False, 12),
         (256, 30, 30, 2, 2, True, 5)]


def _inputs(d, sq, sk, h, kv, seed, b=2, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=shape).astype(np.float32) for shape in
              ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d), (b, sq, h, d))]
    return arrays, [torch.from_numpy(a).to(dtype) for a in arrays]


def _ulp(b: torch.Tensor) -> torch.Tensor:
    """One ulp of each value of a 16-bit tensor, as float32 (0 for a
    float32 one)."""
    if b.dtype == torch.float32:
        return torch.zeros_like(b)
    bits = {torch.bfloat16: 7, torch.float16: 10}[b.dtype]
    _, e = torch.frexp(b.float().abs().clamp_min(torch.finfo(b.dtype).tiny))
    return torch.ldexp(torch.ones_like(b, dtype=torch.float32),
                       e - 1 - bits)


def _closed_form(q, k, v, do, causal, window):
    scale = q.shape[-1] ** -0.5
    _, lse = FA._plain_forward(q, k, v, causal, window, scale)
    return FA.attention_backward_plain(q, k, v, lse, do, causal=causal,
                                       window=window, scale=scale)


def _no_key_rows(sq, sk, causal, window):
    return ~FA._mask(sq, sk, causal, window, torch.device("cpu")).any(-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d,sq,sk,h,kv,causal,window", CASES)
def test_closed_form_equals_plain_vjp(d, sq, sk, h, kv, causal, window,
                                      dtype):
    _, (q, k, v, do) = _inputs(d, sq, sk, h, kv, seed=d + sq, dtype=dtype)
    got = _closed_form(q, k, v, do, causal, window)
    _, vjp = torch.func.vjp(lambda a, b, c: FA.attention_plain(
        a, b, c, causal=causal, window=window), q, k, v)
    want = vjp(do)
    big = max(float(w.float().abs().max()) for w in want)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype == dtype and a.shape == w.shape
        err = (a.float() - w.float()).abs()
        assert bool((err <= _ulp(w) + TOL * big).all()), float(err.max())
    empty = _no_key_rows(sq, sk, causal, window)
    assert bool((got[0][:, empty] == 0).all())


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _reference_vjp(q, k, v, do, *, causal, window):
    _, vjp = jax.vjp(lambda a, b, c: JREF.attention_ref(
        a, b, c, causal=causal, window=window), q, k, v)
    return vjp(do)


@pytest.mark.parametrize("d,sq,sk,h,kv,causal,window",
                         [CASES[i] for i in (0, 2, 3, 4, 8, 9)])
def test_closed_form_equals_reference_vjp(d, sq, sk, h, kv, causal, window):
    """Against ``jax.vjp`` of the JAX package's ``attention_ref`` on the
    same numpy inputs and cotangent."""
    arrays, (q, k, v, do) = _inputs(d, sq, sk, h, kv, seed=7 * d + sq)
    got = _closed_form(q, k, v, do, causal, window)
    want = [np.asarray(w) for w in _reference_vjp(*arrays, causal=causal,
                                                  window=window)]
    big = max(float(np.abs(w).max()) for w in want)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=JAX_TOL * big)


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _reference_lse(q, k, causal, window):
    """logsumexp of ``attention_ref``'s masked float32 scores (its einsum,
    scale and -1e30 fill), +inf for a row with no visible key."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    qh = q.reshape(b, sq, kv, h // kv, d)
    s = jnp.einsum("bsngd,btnd->bngst", qh, k) / math.sqrt(d)
    qpos, kpos = jnp.arange(sq)[:, None], jnp.arange(sk)[None, :]
    mask = jnp.ones((sq, sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    lse = jax.nn.logsumexp(jnp.where(mask, s, -1e30), axis=-1)
    lse = jnp.where(jnp.any(mask, -1), lse, jnp.inf)
    return lse.reshape(b, h, sq)


@pytest.mark.parametrize("d,sq,sk,h,kv,causal,window",
                         [CASES[i] for i in (1, 3, 4, 6, 8, 9)])
def test_plain_lse_equals_reference_logsumexp(d, sq, sk, h, kv, causal,
                                              window):
    arrays, (q, k, v, _) = _inputs(d, sq, sk, h, kv, seed=3 * d + sk)
    o, lse = FA._plain_forward(q, k, v, causal, window, d ** -0.5)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, h, sq)
    assert torch.equal(o, FA.attention_plain(q, k, v, causal=causal,
                                             window=window))
    want = np.asarray(_reference_lse(arrays[0], arrays[1], causal=causal,
                                     window=window))
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(lse.numpy()), finite)
    assert bool((lse.numpy()[~finite] == np.inf).all())
    np.testing.assert_allclose(lse.numpy()[finite], want[finite], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("window", [0, 6])
def test_backward_vmap_rule_equals_per_slice_calls(window):
    """Two replicas of (q, k, v, lse, dO) folded into one call of the
    backward equal the per-replica calls bit for bit, and so do two
    replicas against one unbatched k / v (expanded)."""
    _, (q, k, v, do) = _inputs(64, 19, 19, 4, 2, seed=5, b=4)

    def fn(q, k, v, lse, do):
        return FA.flash_attention_backward(q, k, v, lse, do, window=window)

    def lse_of(q, k, v):
        return FA._plain_forward(q, k, v, True, window, 64 ** -0.5)[1]

    split = [t.reshape(2, 2, *t.shape[1:]) for t in (q, k, v, do)]
    qs, ks, vs, dos = split
    lses = torch.stack([lse_of(qs[r], ks[r], vs[r]) for r in range(2)])
    got = torch.func.vmap(fn)(qs, ks, vs, lses, dos)
    for r in range(2):
        for a, w in zip(got, fn(qs[r], ks[r], vs[r], lses[r], dos[r])):
            assert torch.equal(a[r], w)
    k0, v0 = ks[0], vs[0]
    lses = torch.stack([lse_of(qs[r], k0, v0) for r in range(2)])
    got = torch.func.vmap(fn, in_dims=(0, None, None, 0, 0))(
        qs, k0, v0, lses, dos)
    for r in range(2):
        for a, w in zip(got, fn(qs[r], k0, v0, lses[r], dos[r])):
            assert torch.equal(a[r], w)


def test_cpu_backward_launches_nothing():
    """The Function's backward on CPU tensors runs the closed form: no
    kernel launch is counted, and its gradients are the closed form's."""
    _, (q, k, v, do) = _inputs(32, 12, 12, 4, 2, seed=1)
    req = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(LAUNCHES)
    got = torch.autograd.grad(FA.flash_attention(*req), req, do)
    assert LAUNCHES == before
    for a, w in zip(got, _closed_form(q, k, v, do, True, 0)):
        assert torch.equal(a, w)
