"""flash_attention's backward on its Hopper route, on the CPU.

``flash_backward_route`` decides before a launch which CUDA kernels the
gradient takes: ``"hopper"`` (``csrc/flash_hopper_bwd.cu``: TMA, wgmma, a
producer and two consumer warpgroups) for bfloat16 or float16 q, k, v and
cotangent of one dtype at head dim 128 that TMA can map, ``"mma"``
(``csrc/lm.cu``) for everything else.  Held here:

- the rule on CPU tensors: each dtype and head dim, q / k / v as views of
  one fused projection (aligned and misaligned by one element), a strided
  cotangent, mixed dtypes, no query or no key, a scale <= 0; the rule
  matches the forward's ``flash_route`` where the cotangent is mappable;
- the two kernels' tile walks (the dQ kernel's 128-row query blocks over
  128-key tiles, twice, and the dK / dV kernel's 128-key blocks over the
  64-row query tiles of a GQA group's heads), emulated with the kernels'
  own bounds, warpgroup skips and mask-free tiles: every visible (query,
  key) pair computed exactly once by each kernel, no tile that holds one
  skipped, and a tile run without its mask holding only visible pairs,
  under causal and windowed masks, sq != sk, one query, and rows that see
  no key;
- the kernels' arithmetic, emulated in float32 on the CPU tile by tile (P
  by exp2 with scale.log2(e) and lse.log2(e) folded, masked scores -inf,
  D from a first walk over the key tiles, dS, the split products lo then
  hi) against ``jax.vjp`` of the JAX package's ``attention_ref`` on the
  same 16-bit values, within 1e-5 of the largest gradient, and the same
  arithmetic with P and dS rounded once to 16 bits (no lo half) outside
  the card's tolerance (1e-4 of the largest gradient plus one ulp), which
  is why the kernels keep the split.

The card holds the kernels to the closed form, the plain vjp and the mma
route (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 4b, 10f and
10g)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads
from repro.kernels import ref as JREF
from repro_torch.kernels import flash_attention as FA

cap_torch_threads()

DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}
JAX_TOL = 1e-5   # float32 math against the reference's, of the largest
CARD_TOL = 1e-4  # LM_TOL["flash_attention_backward"] of chip_smoke.py
# flash_hopper_bwd.cu's tiles: FB_BM rows a dQ block and keys a dQ tile or
# a dK / dV block, FB_BN queries a dK / dV tile; a warpgroup owns 64 rows
# (keys), a warp 16
BM, BN, WG, WARP = 128, 64, 64, 16
LOG2E = 1.4426950408889634


def _empty(b, sq, sk, h, kv, d, dtype):
    return (torch.empty((b, sq, h, d), dtype=dtype),
            torch.empty((b, sk, kv, d), dtype=dtype),
            torch.empty((b, sk, kv, d), dtype=dtype),
            torch.empty((b, sq, h, d), dtype=dtype))


# ------------------------------------------------------------------ the rule
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dt", [*DTYPES, "f32"])
def test_route_by_dtype_and_head_dim(dt, d):
    q, k, v, do = _empty(2, 40, 40, 4, 2, d, DTYPES.get(dt, torch.float32))
    want = "hopper" if dt != "f32" and d == 128 else "mma"
    assert FA.flash_backward_route(q, k, v, do) == want
    assert FA.flash_backward_route(q, k, v, do) == FA.flash_route(q, k, v)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_route_of_fused_projection_views_and_strided_cotangents(dt):
    """Slices of one fused qkv projection map; the same slices misaligned
    by one element do not; a cotangent that is a view of a wider tensor
    maps where its strides are multiples of 8, and a head stride of 130 or
    a trailing stride of 2 sends the call to the mma route."""
    dtype = DTYPES[dt]
    qkv = torch.zeros((2, 50, 8, 128), dtype=dtype)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    wide = torch.zeros((2, 50, 6, 128), dtype=dtype)
    assert FA.flash_backward_route(q, k, v, wide[:, :, 1:5]) == "hopper"
    odd = torch.zeros(2 * 50 * 8 * 128 + 1, dtype=dtype)[1:].view(
        2, 50, 8, 128)
    do = torch.zeros((2, 50, 4, 128), dtype=dtype)
    assert FA.flash_backward_route(odd[:, :, :4], odd[:, :, 4:6],
                                   odd[:, :, 6:], do) == "mma"
    odd_do = torch.zeros(2 * 50 * 4 * 128 + 1, dtype=dtype)[1:].view(
        2, 50, 4, 128)
    assert FA.flash_backward_route(q, k, v, odd_do) == "mma"
    head = torch.zeros((2, 50, 4, 130), dtype=dtype)[..., :128]
    assert head.stride(2) == 130
    assert FA.flash_backward_route(q, k, v, head) == "mma"
    step = torch.zeros((2, 50, 4, 256), dtype=dtype)[..., ::2]
    assert FA.flash_backward_route(q, k, v, step) == "mma"


def test_route_needs_one_dtype_a_query_a_key_and_a_positive_scale():
    q, k, v, do = _empty(1, 16, 16, 4, 2, 128, torch.bfloat16)
    assert FA.flash_backward_route(q, k, v, do, 0.5) == "hopper"
    assert FA.flash_backward_route(q, k, v, do.half()) == "mma"
    assert FA.flash_backward_route(q, k.half(), v, do) == "mma"
    assert FA.flash_backward_route(q, k, v, do, 0.0) == "mma"
    assert FA.flash_backward_route(q, k, v, do, -0.1) == "mma"
    assert FA.flash_backward_route(*_empty(1, 0, 16, 4, 2, 128,
                                           torch.bfloat16)) == "mma"
    assert FA.flash_backward_route(*_empty(1, 16, 0, 4, 2, 128,
                                           torch.bfloat16)) == "mma"


def test_cpu_backward_launches_nothing_on_either_route():
    """On CPU tensors the backward is the closed form whatever the route
    would be, and no route counts a launch."""
    g = torch.Generator().manual_seed(0)
    q, do = (torch.randn((1, 20, 4, 128), generator=g).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((1, 20, 2, 128), generator=g).to(torch.bfloat16)
            for _ in range(2))
    _, lse = FA._plain_forward(q, k, v, True, 0, 128 ** -0.5)
    before = dict(FA.BACKWARD_ROUTE_LAUNCHES)
    got = FA.flash_attention_backward(q, k, v, lse, do)
    want = FA.attention_backward_plain(q, k, v, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert FA.BACKWARD_ROUTE_LAUNCHES == before
    assert set(FA.BACKWARD_ROUTE_LAUNCHES) == set(FA.ROUTES)


# ------------------------------------------------------------- tile walks
def _visible(sq, sk, causal, window):
    qpos, kpos = np.arange(sq)[:, None], np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _dq_walk(sq, sk, causal, window):
    """Yield (rows, keys, full) for each key tile a live dQ warpgroup
    computes, per warp: the dQ kernel's bounds and skips."""
    for q0 in range(0, sq, BM):
        k_hi = min(sk, q0 + BM) if causal else sk
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        k_lo = k_lo // BM * BM
        ntiles = -(-(k_hi - k_lo) // BM) if k_hi > k_lo else 0
        for t in range(ntiles):
            kt = k_lo + t * BM
            for c in range(2):
                g0 = q0 + WG * c
                live = (g0 < sq and (not causal or kt <= g0 + WG - 1)
                        and (window <= 0 or kt + BM - 1 > g0 - window))
                if not live:
                    continue
                for w0 in range(g0, g0 + WG, WARP):
                    full = (kt + BM <= sk
                            and (not causal or kt + BM - 1 <= w0)
                            and (window <= 0 or kt > w0 + WARP - 1 - window))
                    yield range(w0, w0 + WARP), range(kt, kt + BM), full


def _dkdv_walk(sq, sk, causal, window, group):
    """Yield (queries, keys, full) for each (head, query tile) step a live
    dK / dV warpgroup computes, per warp: the dK / dV kernel's bounds and
    skips."""
    for k0 in range(0, sk, BM):
        q_lo = k0 if causal else 0
        q_hi = min(sq, k0 + BM - 1 + window) if window > 0 else sq
        q_lo = q_lo // BN * BN
        nqt = -(-(q_hi - q_lo) // BN) if q_hi > q_lo else 0
        for _head in range(group):
            for i in range(nqt):
                qt = q_lo + i * BN
                for c in range(2):
                    kw = k0 + WG * c
                    live = (kw < sk and (not causal or qt + BN - 1 >= kw)
                            and (window <= 0 or qt < kw + WG - 1 + window))
                    if not live:
                        continue
                    for w0 in range(kw, kw + WG, WARP):
                        full = (w0 + WARP <= sk
                                and (not causal or qt >= w0 + WARP - 1)
                                and (window <= 0
                                     or qt + BN - 1 - w0 < window))
                        yield range(qt, qt + BN), range(w0, w0 + WARP), full


def _computed(walk, sq, sk, mask):
    """How many times each (query, key) pair's p is computed nonzero along
    ``walk``: the pairs of each step inside the tensors, masked unless the
    step is mask-free (which then must hold only visible pairs)."""
    count = np.zeros((sq, sk), int)
    for rows, keys, full in walk:
        rows = np.array([r for r in rows if r < sq], int)
        keys = np.array([k for k in keys if k < sk], int)
        if not len(rows) or not len(keys):
            continue
        tile = mask[np.ix_(rows, keys)]
        if full:
            # a mask-free tile: queries past sq would have p = 0 (lse
            # +inf); inside the tensors every pair must be visible
            assert tile.all()
        count[np.ix_(rows, keys)] += tile
    return count


WALK_CASES = [(1024, 1024, True, 0), (200, 200, True, 48),
              (300, 300, False, 0), (130, 260, True, 100),
              (260, 130, True, 0), (48, 80, False, 0), (80, 48, True, 0),
              (1, 77, False, 0), (1, 300, True, 0), (64, 16, False, 8),
              (400, 400, False, 70), (129, 129, True, 1)]


@pytest.mark.parametrize("sq,sk,causal,window", WALK_CASES)
def test_tile_walks_compute_each_visible_pair_once(sq, sk, causal, window):
    mask = _visible(sq, sk, causal, window)
    dq = _computed(_dq_walk(sq, sk, causal, window), sq, sk, mask)
    np.testing.assert_array_equal(dq, mask.astype(int))
    group = 3
    dkdv = _computed(_dkdv_walk(sq, sk, causal, window, group), sq, sk,
                     mask)
    np.testing.assert_array_equal(dkdv, group * mask.astype(int))


def test_tile_walks_see_rows_without_keys():
    """Rows past sk + window see no key (non-causal window, sq > sk): the
    walks compute nothing for them, their dq and D stay 0."""
    sq, sk, window = 64, 16, 8
    mask = _visible(sq, sk, False, window)
    assert not mask[sk + window:].any()
    count = _computed(_dq_walk(sq, sk, False, window), sq, sk, mask)
    assert not count[sk + window:].any()


# ------------------------------------------------------------ the arithmetic
def _split(x, dtype, lo):
    hi = x.to(dtype).float()
    return hi, ((x - hi).to(dtype).float() if lo else torch.zeros_like(x))


def _emulate(q, k, v, do, lse, causal, window, scale, lo=True):
    """The Hopper kernels' float32 dq, dk and dv before their rounding,
    tile by tile: S and dP of the 16-bit values, masked scores -inf, p =
    exp2(S scale log2(e) - lse log2(e)), D over a first walk, dS = p (dP -
    D), then dQ += dS K, dV += P^T dO and dK += dS^T Q on the hi and lo
    halves of P and dS (lo first; ``lo`` False keeps hi alone)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group, dtype = h // kv, q.dtype
    mask = torch.from_numpy(_visible(sq, sk, causal, window))
    qf, kf, vf, of = (t.float() for t in (q, k, v, do))
    dq = torch.zeros((b, sq, h, d))
    dk = torch.zeros((b, sk, kv, d))
    dv = torch.zeros((b, sk, kv, d))
    for bi in range(b):
        for hq in range(h):
            kvh = hq // group
            qh, oh = qf[bi, :, hq], of[bi, :, hq]
            kh, vh = kf[bi, :, kvh], vf[bi, :, kvh]
            l2 = lse[bi, hq].float()[:, None] * LOG2E
            delta = torch.zeros(sq)
            for walk in range(2):
                for kt in range(0, sk, BM):
                    keys = slice(kt, min(sk, kt + BM))
                    s = (qh @ kh[keys].T).masked_fill(~mask[:, keys],
                                                      -math.inf)
                    p = torch.exp2(s * (scale * LOG2E) - l2)
                    dp = oh @ vh[keys].T
                    if walk == 0:
                        delta += (p * dp).sum(-1)
                        continue
                    ds = p * (dp - delta[:, None])
                    for part in reversed(_split(ds, dtype, lo)):
                        dq[bi, :, hq] += part @ kh[keys]
                    for part in reversed(_split(p, dtype, lo)):
                        dv[bi, keys, kvh] += part.T @ oh
                    for part in reversed(_split(ds, dtype, lo)):
                        dk[bi, keys, kvh] += part.T @ qh
    return dq * scale, dk * scale, dv


def _jax_grads(q, k, v, do, causal, window):
    """jax.vjp of attention_ref in float32 on the 16-bit values (jitted:
    one compile a shape)."""
    def grads(a, b, c, o):
        _, vjp = jax.vjp(lambda x, y, z: JREF.attention_ref(
            x, y, z, causal=causal, window=window), a, b, c)
        return vjp(o)
    args = [jnp.asarray(t.float().numpy()) for t in (q, k, v, do)]
    return [torch.from_numpy(np.array(g)) for g in jax.jit(grads)(*args)]


def _inputs(b, sq, sk, h, kv, seed, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
            for s in ((b, sq, h, 128), (b, sk, kv, 128), (b, sk, kv, 128),
                      (b, sq, h, 128))]


ARITH_CASES = [("bf16", (1, 200, 200, 4, 2, True, 0)),
               ("f16", (1, 150, 260, 2, 1, True, 100)),
               ("bf16", (1, 64, 16, 2, 1, False, 8))]


@pytest.mark.parametrize("dt,case", ARITH_CASES)
def test_emulated_kernels_match_jax_vjp(dt, case):
    b, sq, sk, h, kv, causal, window = case
    q, k, v, do = _inputs(b, sq, sk, h, kv, 7, DTYPES[dt])
    scale = 128 ** -0.5
    _, lse = FA._plain_forward(q, k, v, causal, window, scale)
    got = _emulate(q, k, v, do, lse, causal, window, scale)
    want = _jax_grads(q, k, v, do, causal, window)
    big = max(float(w.abs().max()) for w in want)
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= JAX_TOL * big


@pytest.mark.parametrize("dt", list(DTYPES))
def test_one_rounding_of_p_and_ds_misses_the_tolerance(dt):
    """P and dS rounded once to 16 bits (no lo half) put the rounded
    gradients outside 1e-4 of the largest plus one ulp, at a reduced d 128
    shape; the split holds them inside."""
    dtype = DTYPES[dt]
    q, k, v, do = _inputs(1, 256, 256, 2, 1, 11, dtype)
    scale = 128 ** -0.5
    _, lse = FA._plain_forward(q, k, v, True, 0, scale)
    want = [g.to(dtype) for g in _jax_grads(q, k, v, do, True, 0)]

    def within(got):
        big = max(float(w.float().abs().max()) for w in want)
        ulp = [torch.finfo(dtype).eps * 2.0 ** torch.floor(torch.log2(
            w.float().abs().clamp_min(torch.finfo(dtype).tiny)))
            for w in want]
        return all(bool(((a.to(dtype).float() - w.float()).abs()
                         <= CARD_TOL * big + u).all())
                   for a, w, u in zip(got, want, ulp))

    assert within(_emulate(q, k, v, do, lse, True, 0, scale))
    assert not within(_emulate(q, k, v, do, lse, True, 0, scale, lo=False))
