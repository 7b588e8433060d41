"""flash_attention's 16-bit inputs on the CPU.

The port's flash_attention in bfloat16 and float16 (its plain version,
:func:`attention_plain`, which the CUDA kernel is held to on the card)
against the JAX package's Pallas kernel in interpret mode at the
reference's own shapes and tolerance (tests/test_kernels.py: 2e-2 for
bfloat16), and against ``attention_ref`` in the same dtype within one ulp
plus the reference's float32 tolerance (both compute in float32 and round
once; their float32 sums reassociate, and an output near zero, where terms
of size ~1 cancel, carries that float32 error, which an ulp of a tiny
value does not cover).  The 16-bit kernel's arithmetic
is emulated here (scores from the 16-bit values in float32, the online
softmax over key tiles, p split into hi = T(p) and lo = T(p - hi) against
the 16-bit v): its float32 result within flash's card tolerance (1e-4) of
the plain version's, and its 16-bit output within one ulp plus that; so
is the Hopper kernel's order (128-key tiles, exp2 with scale * log2(e)
folded into one fma a score, lo.v then hi.v), at d 128, also against the
Pallas kernel.  The wrapper refuses q, k and v of mixed dtypes and dtypes the kernel does not
take.  chip_smoke.py's split case, which the card checks the kernel on,
sees p's low half: without it the emulated output leaves the tolerance.  Inputs are numpy draws rounded to the working dtype first, so both
packages see the same values."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads
from repro.kernels import ref as JREF
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import flash_attention as FA

cap_torch_threads()

attention_ref = jax.jit(JREF.attention_ref, static_argnames=("causal",
                                                            "window"))
PALLAS_TOL = 2e-2   # the reference's bfloat16 tolerance of its own kernel
F32_TOL = 2e-5      # the reference's float32 tolerance of its own kernel
CARD_TOL = 1e-4     # flash's float32 tolerance on the card (chip_smoke.py)
TORCH_16 = {"bf16": torch.bfloat16, "f16": torch.float16}
JAX_16 = {"bf16": jnp.bfloat16, "f16": jnp.float16}
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}   # stored fraction bits
# tests/test_kernels.py's causal shapes (b, sq, sk, h, kv, d)
REF_SHAPES = [(2, 256, 256, 4, 2, 64), (1, 128, 128, 8, 8, 128),
              (1, 128, 128, 4, 1, 256), (2, 192, 192, 6, 3, 64)]
# the kernel's head dims and edges: (b, sq, sk, h, kv, d, causal, window)
EDGE_CASES = [(2, 37, 37, 4, 2, 32, True, 0), (1, 100, 100, 4, 2, 128, True, 0),
              (1, 70, 70, 4, 1, 256, True, 0), (2, 200, 200, 4, 2, 64, True, 48),
              (2, 48, 80, 2, 2, 64, False, 0), (1, 64, 16, 2, 1, 64, False, 8),
              (2, 1, 77, 4, 2, 64, False, 0), (1, 90, 90, 2, 1, 256, True, 40)]


def _ulp(b: torch.Tensor) -> torch.Tensor:
    """One ulp of each value of the 16-bit tensor b, as float32."""
    _, e = torch.frexp(b.float().abs().clamp_min(torch.finfo(b.dtype).tiny))
    return torch.ldexp(torch.ones_like(b, dtype=torch.float32),
                       e - 1 - MANTISSA[b.dtype])


def _within_one_ulp(a: torch.Tensor, b: torch.Tensor, atol: float = 0.0):
    assert a.dtype == b.dtype and a.shape == b.shape
    err = (a.float() - b.float()).abs()
    bound = _ulp(b) + atol + atol * b.float().abs()
    assert bool((err <= bound).all()), float(err.max())


def _qkv(b, sq, sk, h, kv, d, dtype, seed):
    """numpy normal draws rounded to ``dtype``: (torch q, k, v)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(dtype) for s in ((b, sq, h, d), (b, sk, kv, d),
                                      (b, sk, kv, d)))


def _to_jax(t: torch.Tensor, jdt):
    return jnp.asarray(t.float().numpy()).astype(jdt)


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(dtype)


@pytest.mark.parametrize("dt", list(TORCH_16))
@pytest.mark.parametrize("b,sq,sk,h,kv,d", REF_SHAPES)
def test_flash_16bit_matches_pallas_and_ref(b, sq, sk, h, kv, d, dt):
    """The wrapper on CPU tensors (the plain version, no launch) against
    the Pallas kernel (interpret) at the reference's 2e-2, and against
    attention_ref in the same dtype within one ulp plus 2e-5."""
    tdt, jdt = TORCH_16[dt], JAX_16[dt]
    q, k, v = _qkv(b, sq, sk, h, kv, d, tdt, sq + d)
    before = dict(LAUNCHES)
    got = FA.flash_attention(q, k, v, causal=True)
    assert LAUNCHES == before and got.dtype == tdt
    qj, kj, vj = (_to_jax(t, jdt) for t in (q, k, v))
    pallas = jax_flash(qj, kj, vj, causal=True, block_q=64, block_k=64,
                       interpret=True)
    ref = attention_ref(qj, kj, vj, causal=True)
    assert pallas.dtype == ref.dtype == jdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=PALLAS_TOL, atol=PALLAS_TOL)
    _within_one_ulp(got, _to_torch(ref, tdt), F32_TOL)


@pytest.mark.parametrize("dt", list(TORCH_16))
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", EDGE_CASES)
def test_flash_plain_16bit_matches_ref_at_edges(b, sq, sk, h, kv, d, causal,
                                                window, dt):
    tdt, jdt = TORCH_16[dt], JAX_16[dt]
    q, k, v = _qkv(b, sq, sk, h, kv, d, tdt, 7 * sq + d)
    got = FA.attention_plain(q, k, v, causal=causal, window=window)
    ref = attention_ref(*(_to_jax(t, jdt) for t in (q, k, v)),
                        causal=causal, window=window)
    _within_one_ulp(got, _to_torch(ref, tdt), F32_TOL)


LOG2E = np.float32(1.4426950408889634)   # flash_hopper.cu's FH_LOG2E


def _kernel_16bit_emulated(q, k, v, causal, window, block_k=64,
                           keep_lo=True, route="mma"):
    """The 16-bit kernel's arithmetic in float32: per key tile of
    ``block_k``, scores of the 16-bit values (exact products), the masks,
    the online max and rescaling, p = exp(s - m) summed into l in float32,
    and p.v as lo.v + hi.v with hi = T(p), lo = T(p - hi) (hi.v alone
    without ``keep_lo``).  ``route="hopper"`` takes the Hopper kernel's
    order instead: tiles of 128 keys, the max of the raw scores, p =
    exp2(fma(s, c, -m c)) with c = scale * log2(e) in float32 (the fma
    emulated in float64, whose product of two float32 values is exact),
    alpha = exp2((m_old - m) c), the output rescaled first, then lo.v, then
    hi.v added (the kernel's p is ex2.approx.ftz: within 2 ulp of exp2,
    a p below 2^-126 flushed to 0).  Returns the float32 output (before
    its one rounding to T)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g, scale, dt = h // kv, d ** -0.5, q.dtype
    hopper = route == "hopper"
    if hopper:
        block_k = 128
        c = float(np.float32(scale) * LOG2E)
    qf = q.float().reshape(b, sq, kv, g, d)
    m = torch.full((b, kv, g, sq), -float("inf"))
    l = torch.zeros((b, kv, g, sq))
    acc = torch.zeros((b, kv, g, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, block_k):
        kt, vt = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        kpos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        s = torch.einsum("bsngd,btnd->bngst", qf, kt.float())
        if not hopper:
            s = s * scale
        mask = torch.ones((sq, kt.shape[1]), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = s.masked_fill(~mask, -float("inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == -float("inf"), 0.0, m_new)
        if hopper:
            alpha = torch.exp2((m - m_use) * c)
            ms = (m_use * c)[..., None]
            p = torch.exp2((s.double() * c - ms.double()).float())
        else:
            alpha = torch.exp(m - m_use)
            p = torch.exp(s - m_use[..., None])
        hi = p.to(dt)
        lo = (p - hi.float()).to(dt) if keep_lo else torch.zeros_like(hi)
        lo_v = torch.einsum("bngst,btnd->bngsd", lo.float(), vt.float())
        hi_v = torch.einsum("bngst,btnd->bngsd", hi.float(), vt.float())
        l = l * alpha + p.sum(-1)
        if hopper:
            acc = acc * alpha[..., None] + lo_v + hi_v
        else:
            acc = acc * alpha[..., None] + (lo_v + hi_v)
        m = m_new
    o = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
                    0.0)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


@pytest.mark.parametrize("dt", list(TORCH_16))
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window",
                         EDGE_CASES + [(1, 256, 256, 4, 2, 64, True, 0)])
def test_kernel_split_arithmetic_within_card_tolerance(b, sq, sk, h, kv, d,
                                                       causal, window, dt):
    """The kernel's split of p keeps its float32 output within the card's
    float32 tolerance of the plain version's float32 math, so its 16-bit
    output is within one ulp plus that tolerance of the plain version's."""
    tdt = TORCH_16[dt]
    q, k, v = _qkv(b, sq, sk, h, kv, d, tdt, 11 * sq + d)
    emul = _kernel_16bit_emulated(q, k, v, causal, window)
    exact = FA.attention_plain(q.float(), k.float(), v.float(),
                               causal=causal, window=window)
    torch.testing.assert_close(emul, exact, rtol=CARD_TOL, atol=CARD_TOL)
    _within_one_ulp(emul.to(tdt), FA.attention_plain(
        q, k, v, causal=causal, window=window), CARD_TOL)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """The repo's ``chip_smoke.py`` as a module, for its split case."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dt", list(TORCH_16))
def test_split_case_sees_p_low_half(dt):
    """chip_smoke's split case, which the card holds the kernel to: the
    emulated kernel's output within one ulp plus the card tolerance of the
    plain version, and the same arithmetic without p's low half (and
    chip_smoke's own hi-only version) outside it, so a kernel that drops
    the lo.v product fails there."""
    cs, tdt = _chip_smoke(), TORCH_16[dt]
    q, k, v = cs.flash_split_case(tdt, device="cpu")
    want = FA.attention_plain(q, k, v, causal=False)
    split = _kernel_16bit_emulated(q, k, v, False, 0).to(tdt)
    hi_only = _kernel_16bit_emulated(q, k, v, False, 0, keep_lo=False)
    _within_one_ulp(split, want, CARD_TOL)
    assert cs.flash16_within(split, want)
    assert not cs.flash16_within(hi_only.to(tdt), want)
    assert not cs.flash16_within(cs.flash_hi_only(q, k, v), want)
    _within_one_ulp(cs.flash_hi_only(q, k, v), hi_only.to(tdt))


# the Hopper route's shapes (d 128, then d 64, which takes the route with
# the same tiles and order): EDGE_CASES' d-128 row, its window / non-causal
# (sq != sk) / masked-rows / one-query variants, and 256 keys over two
# 128-key tiles with 4 heads a kv head; the same edges at d 64, and
# smollm's 3 heads a kv head over a ragged 300 keys
HOPPER_EDGE_CASES = [c for c in EDGE_CASES if c[5] == 128] + [
    (2, 200, 200, 4, 2, 128, True, 48), (2, 48, 80, 2, 2, 128, False, 0),
    (1, 64, 16, 2, 1, 128, False, 8), (2, 1, 77, 4, 2, 128, False, 0),
    (1, 256, 256, 8, 2, 128, True, 0),
    (2, 200, 200, 4, 2, 64, True, 48), (2, 48, 80, 2, 2, 64, False, 0),
    (1, 64, 16, 2, 1, 64, False, 8), (2, 1, 77, 4, 2, 64, False, 0),
    (1, 300, 300, 6, 2, 64, True, 0)]


@pytest.mark.parametrize("dt", list(TORCH_16))
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", HOPPER_EDGE_CASES)
def test_hopper_order_within_card_tolerance(b, sq, sk, h, kv, d, causal,
                                            window, dt):
    """The Hopper kernel's order (128-key tiles, exp2 with the folded
    scale, lo.v then hi.v) keeps its float32 output within the card's
    float32 tolerance of the plain version's float32 math, and its 16-bit
    output within one ulp plus that of the plain version's."""
    tdt = TORCH_16[dt]
    q, k, v = _qkv(b, sq, sk, h, kv, d, tdt, 13 * sq + d)
    emul = _kernel_16bit_emulated(q, k, v, causal, window, route="hopper")
    exact = FA.attention_plain(q.float(), k.float(), v.float(),
                               causal=causal, window=window)
    torch.testing.assert_close(emul, exact, rtol=CARD_TOL, atol=CARD_TOL)
    _within_one_ulp(emul.to(tdt), FA.attention_plain(
        q, k, v, causal=causal, window=window), CARD_TOL)


@pytest.mark.parametrize("dt", list(TORCH_16))
def test_hopper_order_matches_pallas(dt):
    """The Hopper kernel's order at REF_SHAPES' d-128 case against the
    Pallas kernel (interpret) at the reference's 2e-2."""
    (b, sq, sk, h, kv, d), = [c for c in REF_SHAPES if c[5] == 128]
    tdt, jdt = TORCH_16[dt], JAX_16[dt]
    q, k, v = _qkv(b, sq, sk, h, kv, d, tdt, sq + d)
    emul = _kernel_16bit_emulated(q, k, v, True, 0, route="hopper").to(tdt)
    pallas = jax_flash(*(_to_jax(t, jdt) for t in (q, k, v)), causal=True,
                       block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(emul.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=PALLAS_TOL, atol=PALLAS_TOL)


@pytest.mark.parametrize("dt", list(TORCH_16))
def test_split_case_sees_p_low_half_on_hopper_order(dt):
    """chip_smoke's split case (d 128, so the card runs it on the Hopper
    route) through the Hopper kernel's order: within one ulp plus the card
    tolerance of the plain version with p's low half, outside without."""
    cs, tdt = _chip_smoke(), TORCH_16[dt]
    q, k, v = cs.flash_split_case(tdt, device="cpu")
    assert FA.flash_route(q, k, v) == "hopper"
    want = FA.attention_plain(q, k, v, causal=False)
    split = _kernel_16bit_emulated(q, k, v, False, 0, route="hopper")
    hi_only = _kernel_16bit_emulated(q, k, v, False, 0, keep_lo=False,
                                     route="hopper")
    _within_one_ulp(split.to(tdt), want, CARD_TOL)
    assert cs.flash16_within(split.to(tdt), want)
    assert not cs.flash16_within(hi_only.to(tdt), want)


def test_wrapper_refuses_mixed_and_other_dtypes():
    q, k, v = _qkv(1, 8, 8, 2, 1, 32, torch.bfloat16, 0)
    for args in ((q, k.float(), v), (q, k, v.half()), (q.float(), k, v),
                 (q.half(), k.half(), v)):
        with pytest.raises(TypeError, match="one dtype"):
            FA.flash_attention(*args)
    with pytest.raises(TypeError, match="one dtype"):
        FA.flash_attention(q.double(), k.double(), v.double())
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        out = FA.flash_attention(q.to(dtype), k.to(dtype), v.to(dtype))
        assert out.dtype == dtype and out.shape == q.shape
