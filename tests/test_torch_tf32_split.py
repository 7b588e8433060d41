"""The arithmetic route of the redesigned flash_attention and ssd_chunk_scan
kernels, emulated on the CPU: 3xTF32.

On the card both kernels run their matrix products on the tensor cores
(``mma.sync`` on tf32 operands).  Each float32 operand x is split into
big = tf32(x) and small = tf32(x - big), with tf32() the card's
``cvt.rna.tf32.f32`` (round to nearest, ties away from zero, to 10 mantissa
bits), and a.b is summed as a_small.b_big + a_big.b_small + a_big.b_big in
float32.  Here the same split is emulated with integer operations on the
float32 bits, and the plain versions' products (attention_plain's two,
ssd_chunked's four) are recomputed as 3-term split sums, at the card tests'
small cases and at a 1024-key / 1024-position slice of the serving path's
magnitudes (tolerances FLASH_TOL 1e-4, SSD_TOL 2e-4 of
tests/test_torch_cuda.py):

- the split's own error (the parts' products summed exactly, in float64,
  against the same function evaluated in float64) stays within a tenth of
  the tolerance.  The reference is float64, not the float32 plain version:
  with q and k scaled by 4 (scores up to ~80) the float32 result is itself
  1.5e-5 from the exact one, more than a tenth of FLASH_TOL;
- the split with float32 sums, as the tensor cores accumulate, stays within
  the tolerance of the float32 plain version, as the card tests hold the
  kernels.

The error of a single TF32 product (1xTF32), and the float32 plain
version's own error, are recorded (``record_property``), not asserted:
1xTF32 is the route the tolerances rule out.  Products of two tf32 values
are exact in float32, so float32 matmuls of the parts emulate the tensor
cores up to the order of the sums.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import cap_torch_threads
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd as SSD

cap_torch_threads()

FLASH_TOL, SSD_TOL = 1e-4, 2e-4      # the card tests' tolerances


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round float32 to 10 mantissa bits, to nearest,
    ties away from zero (the magnitude's bits rounded; the sign kept)."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & -0x2000
    return (sign | mag).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def einsum_split(terms: int, dtype: torch.dtype):
    """einsum of the float32-rounded operands' tf32 parts, summed in
    ``dtype``: terms 3 is 3xTF32 (the two correction products, then the
    large), terms 1 a single TF32 product."""
    def mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ab, as_ = split(a.float())
        bb, bs = split(b.float())

        def e(x, y):
            return torch.einsum(eq, x.to(dtype), y.to(dtype))
        if terms == 1:
            return e(ab, bb)
        return e(as_, bb) + e(ab, bs) + e(ab, bb)
    return mm


def einsum64(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, a.double(), b.double())


def _route_checks(record_property, fn, args, plain, tol):
    """fn(*args, mm) in float64 exact / 3xTF32 / 1xTF32 and in float32
    3xTF32; returns (split error over tol / 10, float32 route over tol)."""
    wide = [a.double() for a in args]
    exact = fn(*wide, einsum64)
    split3 = fn(*wide, einsum_split(3, torch.float64))
    split1 = fn(*wide, einsum_split(1, torch.float64))
    card = fn(*args, einsum_split(3, torch.float32))
    record_property("tf32_1x_err_over_tol", max(
        _worst(o, e, tol) for o, e in zip(split1, exact)))
    record_property("plain_f32_err_over_tol", max(
        _worst(p.double(), e, tol) for p, e in zip(plain, exact)))
    return (max(_worst(o, e, tol / 10) for o, e in zip(split3, exact)),
            max(_worst(o, p, tol) for o, p in zip(card, plain)))


def _worst(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Largest |got - want| / (tol + tol |want|): <= 1 means within tol in
    the form of torch.testing.assert_close(rtol=tol, atol=tol)."""
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                         # a tf32 neighbour of 1
    half_ulp = 2.0 ** -11
    x = torch.tensor([1.0 + half_ulp, -(1.0 + half_ulp),      # ties
                      1.0 + half_ulp * 0.999, 1.0 + half_ulp * 1.001,
                      one + half_ulp, 3.0, 0.0, -0.0, 1e-30, 3e38],
                     dtype=torch.float32)
    got = tf32(x)
    assert got[0] == one and got[1] == -one        # away from zero
    assert got[2] == 1.0 and got[3] == one
    assert got[4] == 1.0 + 2 * 2.0 ** -10          # tie away, odd neighbour
    assert got[5] == 3.0 and got[6] == 0.0 and torch.signbit(got[7])
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())      # 10 mantissa bits left
    r = np.random.default_rng(0).normal(size=100_000).astype(np.float32)
    r = torch.from_numpy(r) * 1e3
    big, small = split(r)
    assert float(((r - big).abs() / r.abs()).max()) <= 2.0 ** -11
    # big + small keeps ~21 bits: the residual is below 2^-21 relative
    assert float(((r - big - small).abs() / r.abs()).max()) <= 2.0 ** -21


def _normal(rng, shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float32))


def _attention(q, k, v, causal, window, mm):
    """attention_plain with its two products through ``mm``."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qh = q.reshape(b, sq, kv, h // kv, d)
    s = mm("bsngd,btnd->bngst", qh, k) * (1.0 / math.sqrt(d))
    mask = FA._mask(sq, sk, causal, window, q.device)
    p = torch.softmax(s.masked_fill(~mask, FA.MASKED), dim=-1)
    p = torch.where(mask.any(dim=-1)[:, None], p, 0.0)
    return mm("bngst,btnd->bsngd", p, v).reshape(b, sq, h, d)


# (b, sq, sk, h, kv, d, causal, window, qk_amp): the card tests' small
# cases, then 64 query rows over 1024 keys at the path's widths (d 64, 3
# heads per kv head)
FLASH_CASES = [(1, 100, 100, 4, 2, 128, True, 0, 1.0),
               (1, 70, 70, 4, 1, 256, True, 0, 1.0),
               (2, 37, 37, 4, 2, 32, True, 0, 1.0),
               (2, 200, 200, 4, 2, 64, True, 48, 1.0),
               (2, 48, 80, 2, 2, 64, False, 0, 1.0),
               (1, 64, 16, 2, 1, 64, False, 8, 1.0),
               (2, 1, 77, 4, 2, 64, False, 0, 1.0),
               (1, 90, 90, 2, 1, 256, True, 40, 1.0),
               (1, 256, 256, 4, 2, 64, True, 0, 4.0),
               (1, 64, 1024, 3, 1, 64, False, 0, 1.0)]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,qk_amp",
                         FLASH_CASES)
def test_flash_products_in_3xtf32_hold_the_tolerance(
        record_property, b, sq, sk, h, kv, d, causal, window, qk_amp):
    rng = np.random.default_rng(sq * 7 + sk + d)
    q = _normal(rng, (b, sq, h, d), qk_amp)
    k = _normal(rng, (b, sk, kv, d), qk_amp)
    v = _normal(rng, (b, sk, kv, d))
    plain = FA.attention_plain(q, k, v, causal=causal, window=window)
    split_err, card_err = _route_checks(
        record_property,
        lambda q, k, v, mm: (_attention(q, k, v, causal, window, mm),),
        (q, k, v), (plain,), FLASH_TOL)
    assert split_err <= 1.0 and card_err <= 1.0


def _ssd(x, dt, A, B, C, chunk, mm):
    """ssd_chunked with its four products through ``mm``."""
    b, s, h, p_ = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // chunk
    xc = x.reshape(b, nc, chunk, h, p_)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Cc = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cum = torch.cumsum(dtc * A, dim=2)
    total = cum[:, :, -1]
    cb = mm("bcihn,bcjhn->bchij", Cc, Bc)
    ci = cum.permute(0, 1, 3, 2)
    decay = torch.exp(ci[..., :, None] - ci[..., None, :])
    mask = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    scores = cb * torch.where(mask, decay, 0.0)
    dtj = dtc.permute(0, 1, 3, 2)
    y_intra = mm("bchij,bcjhp->bcihp", scores * dtj[..., None, :], xc)
    w = torch.exp(total[:, :, None, :] - cum) * dtc
    S = mm("bcjhn,bcjhp->bchnp", Bc * w[..., None], xc)
    state = torch.zeros((b, h, n, p_), dtype=x.dtype)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = torch.exp(total[:, c])[..., None, None] * state + S[:, c]
    y_inter = mm("bcihn,bchnp->bcihp", Cc * torch.exp(cum)[..., None],
                 torch.stack(prev, dim=1))
    y = (y_intra + y_inter).reshape(b, s + pad, h, p_)[:, :s]
    return y, state


def _ssd_inputs(rng, b, s, h, p, g, n):
    """As the card tests draw them: dt = softplus of a unit normal plus
    mamba2's dt_bias, A = -linspace(1, 16)."""
    x = _normal(rng, (b, s, h, p), 0.5)
    bias = torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, h)))
    dt = F.softplus(_normal(rng, (b, s, h)) + bias)
    A = -torch.linspace(1.0, 16.0, h)
    return x, dt, A, _normal(rng, (b, s, g, n)), _normal(rng, (b, s, g, n))


# (b, s, h, p, g, n, chunk): the card tests' small cases, then two heads
# of the path's mamba2 prefill at full length and widths
SSD_CASES = [(2, 300, 8, 64, 2, 128, 256), (2, 100, 4, 32, 2, 16, 32),
             (1, 40, 4, 16, 1, 16, 64), (2, 37, 32, 16, 1, 16, 32),
             (2, 333, 6, 64, 1, 128, 128), (1, 150, 7, 18, 1, 10, 64),
             (1, 1024, 2, 64, 1, 128, 256)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_products_in_3xtf32_hold_the_tolerance(record_property, b, s,
                                                   h, p, g, n, chunk):
    rng = np.random.default_rng(s + 13 * h + n)
    args = _ssd_inputs(rng, b, s, h, p, g, n)
    split_err, card_err = _route_checks(
        record_property, lambda *a: _ssd(*a[:5], chunk, a[5]), args,
        SSD.ssd_chunked(*args, chunk), SSD_TOL)
    assert split_err <= 1.0 and card_err <= 1.0
