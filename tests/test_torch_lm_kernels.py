"""Plain versions of the LM lane's kernels (flash attention, rmsnorm, SSD
chunk scan) against the JAX Pallas kernels in interpret mode and the JAX
oracles of ``repro/kernels/ref.py`` and ``repro/models/ssm.py``, on the
CPU.  Inputs are numpy draws handed to both packages.  The CUDA kernels are
held to these plain versions on the card (tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads
from repro.kernels import ref as JREF
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.ssd import ssd_chunk_scan as jax_ssd
from repro.models import ssm as JS
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd as SSD

cap_torch_threads()

# the JAX oracles jitted: op-by-op dispatch costs seconds per call here
attention_ref = jax.jit(JREF.attention_ref, static_argnames=("causal",
                                                            "window"))
rmsnorm_ref = jax.jit(JREF.rmsnorm_ref)
ssd_naive_ref = jax.jit(JREF.ssd_naive)
ssd_chunked_ref = jax.jit(JS.ssd_chunked, static_argnums=5)

F32_TOL = 2e-5      # f32 tolerance of the reference's own kernel tests


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# -------------------------------------------------------- flash attention
# (b, sq, sk, h, kv, d, causal, window): causal, window > 0, non-causal,
# sq / sk not multiples of the 32-row blocks, GQA, head_dim 64 and 128
FLASH_CASES = [
    (2, 64, 64, 4, 2, 64, True, 0),
    (1, 72, 72, 4, 4, 128, True, 0),
    (1, 96, 96, 4, 2, 64, True, 24),
    (2, 48, 80, 2, 2, 64, False, 0),
    (1, 40, 40, 6, 2, 128, True, 0),
    (1, 70, 70, 3, 1, 64, True, 16),
]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", FLASH_CASES)
def test_flash_plain_matches_pallas_and_ref(b, sq, sk, h, kv, d, causal,
                                            window):
    rng = np.random.default_rng(sq * 7 + d)
    q, k, v = (_normal(rng, (b, sq, h, d)), _normal(rng, (b, sk, kv, d)),
               _normal(rng, (b, sk, kv, d)))
    before = dict(LAUNCHES)
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window).numpy()
    assert LAUNCHES == before            # a CPU tensor runs the plain one
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, window=window, block_q=32, block_k=32,
                       interpret=True)
    ref = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_flash_fully_masked_rows_are_zero():
    """Non-causal, window 3, sk < sq: query rows 6 and 7 see no key and
    output 0."""
    rng = np.random.default_rng(3)
    q, k = _normal(rng, (1, 8, 2, 64)), _normal(rng, (1, 4, 2, 64))
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(k), causal=False,
                             window=3).numpy()
    ref = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                        causal=False, window=3)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)
    assert np.all(got[:, 6:] == 0) and np.all(np.abs(got[:, :6]).sum(-1) > 0)


def test_flash_wrapper_checks_shapes():
    q = torch.zeros(1, 8, 3, 64)
    k = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="heads"):
        FA.flash_attention(q, k, k)


# ---------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("shape", [(8, 256), (2, 33, 960), (3, 5, 1000),
                                   (4, 3072)])
def test_rmsnorm_plain_matches_pallas_and_ref(shape):
    rng = np.random.default_rng(shape[-1])
    x = _normal(rng, shape, 2.0)
    g = (_normal(rng, shape[-1:]) * 0.1 + 1.0).astype(np.float32)
    before = dict(LAUNCHES)
    got = RN.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    assert LAUNCHES == before
    pallas = jax_rmsnorm(jnp.asarray(x), jnp.asarray(g), interpret=True)
    ref = rmsnorm_ref(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_rmsnorm_wrapper_checks_scale():
    with pytest.raises(ValueError, match="trailing dim"):
        RN.rmsnorm(torch.zeros(2, 8), torch.ones(4))


# -------------------------------------------------------------------- ssd
def _ssd_inputs(rng, b, s, h, p, g, n):
    x = _normal(rng, (b, s, h, p), 0.5)
    dt = np.log1p(np.exp(_normal(rng, (b, s, h)))).astype(np.float32)
    A = (-np.exp(_normal(rng, (h,), 0.3))).astype(np.float32)
    B = _normal(rng, (b, s, g, n), 0.5)
    C = _normal(rng, (b, s, g, n), 0.5)
    return x, dt, A, B, C


# (s, chunk, g): padded s, several groups, one chunk
SSD_CASES = [(64, 32, 2), (100, 32, 2), (96, 32, 1), (40, 64, 4)]


@pytest.mark.parametrize("s,chunk,g", SSD_CASES)
def test_ssd_chunked_matches_jax_chunked(s, chunk, g):
    """y AND the final state (the prefill cache) within 1e-5."""
    x, dt, A, B, C = _ssd_inputs(np.random.default_rng(s + g), 2, s, 4, 16,
                                 g, 8)
    before = dict(LAUNCHES)
    y, st = SSD.ssd_chunk_scan(*map(torch.from_numpy, (x, dt, A, B, C)),
                               chunk=chunk)
    assert LAUNCHES == before
    jy, jst = ssd_chunked_ref(*map(jnp.asarray, (x, dt, A, B, C)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("s,chunk", [(64, 32), (100, 32)])
def test_ssd_naive_matches_pallas_and_chunked(s, chunk):
    """The literal recurrence (port) against the Pallas kernel (interpret)
    and the port's chunked form, y and final state."""
    x, dt, A, B, C = _ssd_inputs(np.random.default_rng(s), 2, s, 4, 32, 2,
                                 16)
    yn, stn = SSD.ssd_naive(*map(torch.from_numpy, (x, dt, A, B, C)))
    yk = jax_ssd(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk,
                 interpret=True)
    jyn, jstn = ssd_naive_ref(*map(jnp.asarray, (x, dt, A, B, C)))
    np.testing.assert_allclose(yn.numpy(), np.asarray(yk), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(yn.numpy(), np.asarray(jyn), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(stn.numpy(), np.asarray(jstn), rtol=2e-4,
                               atol=2e-4)
    yc, stc = SSD.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)),
                              chunk)
    np.testing.assert_allclose(yc.numpy(), yn.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(stc.numpy(), stn.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_ssd_wrapper_checks_shapes():
    x = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="pair"):
        SSD.ssd_chunk_scan(x, torch.zeros(1, 8, 3), torch.zeros(4),
                           torch.zeros(1, 8, 1, 8), torch.zeros(1, 8, 1, 8))
