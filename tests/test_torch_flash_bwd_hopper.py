"""flash_attention's backward on its Hopper route, on the CPU.

``flash_backward_route`` decides before a launch which CUDA kernels the
gradient takes: ``"hopper"`` (``csrc/flash_hopper_bwd.cu``: TMA, wgmma, a
producer and two consumer warpgroups) for bfloat16 or float16 q, k, v and
cotangent of one dtype at head dim 128 or 256 that TMA can map, ``"mma"``
(``csrc/lm.cu``) for everything else.  Held here:

- the rule on CPU tensors: each dtype and head dim, beside the forward's
  ``flash_route`` (which differs since the d-64 forward and the d-256
  backward: 16-bit d 64 runs its forward on the Hopper route and its
  backward on the mma route, d 256 the other way round), q / k / v as
  views of one fused projection (aligned and misaligned by one element) at
  d 128 and 256, a strided cotangent, mixed dtypes, no query or no key, a
  scale <= 0;
- the kernels' tile walks, emulated with the kernels' own bounds,
  warpgroup skips, mask-free tiles and per-row mask limits: the dQ
  kernel's 128-row query blocks over key tiles of 128 (d 128) or 64 keys
  (d 256), twice; the dK / dV kernel's key blocks of 128 (two consumers of
  64 keys, d 128) or 64 keys (both consumers on the block's keys, each
  owning half the columns, d 256) over the 64-row query tiles of a GQA
  group's heads; and the forward's (``csrc/flash_hopper.cu``, d 64 and
  128) query blocks of 64 rows a consumer over 128-key tiles.  Every
  visible (query, key) pair is computed exactly once by each kernel (at
  d 256's dK / dV once for each half of the columns), no tile that holds
  one is skipped, a tile run without its mask holds only visible pairs,
  and a masked tile's per-row limits give exactly the visible pairs, under
  causal and windowed masks, sq != sk, one query, and rows that see no
  key;
- the kernels' arithmetic, emulated in float32 on the CPU tile by tile (P
  by exp2 with scale.log2(e) and lse.log2(e) folded, masked scores -inf,
  D from a first walk over the dQ kernel's key tiles, dS, the split
  products lo then hi; the dK / dV kernel's S^T and dP^T per 64-row query
  tile, whole, and at d 256 dK and dV in two halves of 128 columns)
  against ``jax.vjp`` of the JAX package's ``attention_ref`` on the same
  16-bit values, within 1e-5 of the largest gradient, at d 128 and 256,
  and the same arithmetic with P and dS rounded once to 16 bits (no lo
  half) outside the card's tolerance (1e-4 of the largest gradient plus
  one ulp), which is why the kernels keep the split.

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
# flash_hopper_bwd.cu's tiles (BwdCfg): QM rows a dQ block, QBK[d] keys a
# dQ tile, KB[d] keys a dK / dV block, BN queries a dK / dV tile; a
# warpgroup owns 64 rows (keys), a warp 16; at d 256 the dK / dV block's
# two consumers share its 64 keys, each owning 128 of the columns
QM, BN, WG, WARP = 128, 64, 64, 16
QBK = {128: 128, 256: 64}
KB = {128: 128, 256: 64}
# flash_hopper.cu's tiles, the same at d 64 and 128: 128 keys a tile, 64
# query rows a consumer, NC consumers a block
FK, NC = 128, 2
NONE = 1 << 30   # FH_NONE: a column offset past every tile
LOG2E = 1.4426950408889634
# the 16-bit routes that TMA can map, by head dim: (forward, backward)
ROUTES_16BIT = {32: ("mma", "mma"), 64: ("hopper", "mma"),
                128: ("hopper", "hopper"), 256: ("mma", "hopper")}


def _empty(b, sq, sk, h, kv, d, dtype):
    return (torch.empty((b, sq, h, d), dtype=dtype),
            torch.empty((b, sk, kv, d), dtype=dtype),
            torch.empty((b, sk, kv, d), dtype=dtype),
            torch.empty((b, sq, h, d), dtype=dtype))


# ------------------------------------------------------------------ the rule
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dt", [*DTYPES, "f32"])
def test_route_by_dtype_and_head_dim(dt, d):
    """16-bit: the backward on the Hopper route at d 128 and 256, the
    forward at d 64 and 128 (ROUTES_16BIT); float32: both on the mma
    route."""
    q, k, v, do = _empty(2, 40, 40, 4, 2, d, DTYPES.get(dt, torch.float32))
    fwd, bwd = ("mma", "mma") if dt == "f32" else ROUTES_16BIT[d]
    assert FA.flash_backward_route(q, k, v, do) == bwd
    assert FA.flash_route(q, k, v) == fwd


@pytest.mark.parametrize("dt", list(DTYPES))
def test_route_of_fused_projection_views_and_strided_cotangents(dt):
    """At d 128 and 256: slices of one fused qkv projection map; the same
    slices misaligned by one element do not; a cotangent that is a view of
    a wider tensor maps where its strides are multiples of 8, and a head
    stride of d + 2 or a trailing stride of 2 sends the call to the mma
    route."""
    dtype = DTYPES[dt]
    for d in (128, 256):
        qkv = torch.zeros((2, 50, 8, d), dtype=dtype)
        q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
        wide = torch.zeros((2, 50, 6, d), dtype=dtype)
        assert FA.flash_backward_route(q, k, v, wide[:, :, 1:5]) == "hopper"
        odd = torch.zeros(2 * 50 * 8 * d + 1, dtype=dtype)[1:].view(
            2, 50, 8, d)
        do = torch.zeros((2, 50, 4, d), dtype=dtype)
        assert FA.flash_backward_route(odd[:, :, :4], odd[:, :, 4:6],
                                       odd[:, :, 6:], do) == "mma"
        odd_do = torch.zeros(2 * 50 * 4 * d + 1, dtype=dtype)[1:].view(
            2, 50, 4, d)
        assert FA.flash_backward_route(q, k, v, odd_do) == "mma"
        head = torch.zeros((2, 50, 4, d + 2), dtype=dtype)[..., :d]
        assert head.stride(2) == d + 2
        assert FA.flash_backward_route(q, k, v, head) == "mma"
        step = torch.zeros((2, 50, 4, 2 * d), dtype=dtype)[..., ::2]
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


def _row_limits(rows, at, sk, causal, window):
    """The forward's and the dQ kernel's per-row limits (mask_acc): a
    row's visible keys as offsets from the tile's first column ``at``."""
    hi = np.array([(min(r, sk - 1) if causal else sk - 1) - at
                   for r in rows])
    lo = np.array([(r - window + 1 if window > 0 else 0) - at for r in rows])
    return lo, hi


def _key_limits(keys, at, sq, sk, causal, window):
    """The dK / dV kernel's per-key limits: a key's visible queries as
    offsets from the tile's first column ``at``, none past sk."""
    lo = np.array([NONE if key >= sk else (key if causal else 0) - at
                   for key in keys])
    hi = np.array([(key + window - 1 if window > 0 else sq) - at
                   for key in keys])
    return lo, hi


def _tile(lo, hi, width, full):
    """The pairs a warp computes on a tile: every one where the tile runs
    mask-free, else the columns inside each row's [lo, hi]."""
    if full:
        return np.ones((len(lo), width), bool)
    col = np.arange(width)[None, :]
    return (col >= lo[:, None]) & (col <= hi[:, None])


def _fwd_walk(sq, sk, causal, window):
    """Yield (rows, keys, pairs, 0) for each key tile a live forward
    consumer computes, per warp: flash_hopper.cu's bounds and skips."""
    bq = WG * NC
    for q0 in range(0, sq, bq):
        k_hi = min(sk, q0 + bq) if causal else sk
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        k_lo = k_lo // FK * FK
        ntiles = -(-(k_hi - k_lo) // FK) if k_hi > k_lo else 0
        for t in range(ntiles):
            kt = k_lo + t * FK
            for c in range(NC):
                g0 = q0 + WG * c
                live = (g0 < sq and (not causal or kt <= g0 + WG - 1)
                        and (window <= 0 or kt + FK - 1 > g0 - window))
                if not live:
                    continue
                for w0 in range(g0, g0 + WG, WARP):
                    full = (kt + FK <= sk
                            and (not causal or kt + FK - 1 <= w0)
                            and (window <= 0 or kt > w0 + WARP - 1 - window))
                    rows = range(w0, w0 + WARP)
                    lo, hi = _row_limits(rows, kt, sk, causal, window)
                    yield rows, range(kt, kt + FK), _tile(lo, hi, FK,
                                                          full), 0


def _dq_walk(sq, sk, causal, window, d):
    """Yield (rows, keys, pairs, 0) for each key tile a live dQ warpgroup
    computes, per warp: the dQ kernel's bounds and skips."""
    bk = QBK[d]
    for q0 in range(0, sq, QM):
        k_hi = min(sk, q0 + QM) if causal else sk
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        k_lo = k_lo // bk * bk
        ntiles = -(-(k_hi - k_lo) // bk) if k_hi > k_lo else 0
        for t in range(ntiles):
            kt = k_lo + t * bk
            for c in range(2):
                g0 = q0 + WG * c
                live = (g0 < sq and (not causal or kt <= g0 + WG - 1)
                        and (window <= 0 or kt + bk - 1 > g0 - window))
                if not live:
                    continue
                for w0 in range(g0, g0 + WG, WARP):
                    full = (kt + bk <= sk
                            and (not causal or kt + bk - 1 <= w0)
                            and (window <= 0 or kt > w0 + WARP - 1 - window))
                    rows = range(w0, w0 + WARP)
                    lo, hi = _row_limits(rows, kt, sk, causal, window)
                    yield rows, range(kt, kt + bk), _tile(lo, hi, bk,
                                                          full), 0


def _dkdv_walk(sq, sk, causal, window, group, d):
    """Yield (queries, keys, pairs, part) for each (head, query tile) step
    a live dK / dV warpgroup computes, per warp: the dK / dV kernel's
    bounds and skips; ``part`` the consumer's half of the columns at d 256
    (0 at d 128, where each consumer owns its keys' every column)."""
    kb = KB[d]
    for k0 in range(0, sk, kb):
        q_lo = k0 if causal else 0
        q_hi = min(sq, k0 + kb - 1 + window) if window > 0 else sq
        q_lo = q_lo // BN * BN
        nqt = -(-(q_hi - q_lo) // BN) if q_hi > q_lo else 0
        for _head in range(group):
            for i in range(nqt):
                qt = q_lo + i * BN
                for c in range(2):
                    kw = k0 + (0 if d == 256 else WG * c)
                    live = (kw < sk and (not causal or qt + BN - 1 >= kw)
                            and (window <= 0 or qt < kw + WG - 1 + window))
                    if not live:
                        continue
                    for w0 in range(kw, kw + WG, WARP):
                        full = (w0 + WARP <= sk
                                and (not causal or qt >= w0 + WARP - 1)
                                and (window <= 0
                                     or qt + BN - 1 - w0 < window))
                        keys = range(w0, w0 + WARP)
                        lo, hi = _key_limits(keys, qt, sq, sk, causal,
                                             window)
                        yield (range(qt, qt + BN), keys,
                               _tile(lo, hi, BN, full).T,
                               c if d == 256 else 0)


def _computed(walk, sq, sk, mask, by_key=False):
    """How many times each (query, key) pair's p is computed nonzero along
    ``walk``, per part: the pairs a step computes inside the tensors
    (queries past sq have p = 0: lse +inf), which must be visible ones;
    ``by_key``: the walk's pairs are (query, key) of a key-major step."""
    counts = {}
    for rows, keys, pairs, part in walk:
        count = counts.setdefault(part, np.zeros((sq, sk), int))
        ri = [i for i, r in enumerate(rows) if r < sq]
        ki = [i for i, k in enumerate(keys) if k < sk]
        if not ri or not ki:
            continue
        got = pairs[np.ix_(ri, ki)]
        idx = np.ix_([rows[i] for i in ri], [keys[i] for i in ki])
        # the kernel's own mask gives exactly the visible pairs
        np.testing.assert_array_equal(got, mask[idx])
        count[idx] += got
    return counts


WALK_CASES = [(1024, 1024, True, 0), (200, 200, True, 48),
              (300, 300, False, 0), (130, 260, True, 100),
              (260, 130, True, 0), (48, 80, False, 0), (80, 48, True, 0),
              (1, 77, False, 0), (1, 300, True, 0), (64, 16, False, 8),
              (400, 400, False, 70), (129, 129, True, 1)]


@pytest.mark.parametrize("sq,sk,causal,window", WALK_CASES)
def test_tile_walks_compute_each_visible_pair_once(sq, sk, causal, window):
    """At d 128 and 256: the dQ kernel computes each visible pair once, the
    dK / dV kernel once a GQA head (at d 256 once a half of the columns);
    the forward at d 64 and 128 once."""
    mask = _visible(sq, sk, causal, window)
    group = 3
    for d in (128, 256):
        counts = _computed(_dq_walk(sq, sk, causal, window, d), sq, sk,
                           mask)
        assert list(counts) in ([0], [])
        np.testing.assert_array_equal(counts.get(0, 0 * mask),
                                      mask.astype(int))
        counts = _computed(_dkdv_walk(sq, sk, causal, window, group, d), sq,
                           sk, mask)
        assert sorted(counts) in ([], [0] if d == 128 else [0, 1])
        for count in counts.values():
            np.testing.assert_array_equal(count, group * mask.astype(int))
    counts = _computed(_fwd_walk(sq, sk, causal, window), sq, sk, mask)
    np.testing.assert_array_equal(counts.get(0, 0 * mask), mask.astype(int))


def test_tile_walks_see_rows_without_keys():
    """Rows past sk + window see no key (non-causal window, sq > sk): the
    walks compute nothing for them, their dq and D stay 0, their output
    0."""
    sq, sk, window = 64, 16, 8
    mask = _visible(sq, sk, False, window)
    assert not mask[sk + window:].any()
    walks = [_dq_walk(sq, sk, False, window, 128),
             _dq_walk(sq, sk, False, window, 256),
             _fwd_walk(sq, sk, False, window)]
    for walk in walks:
        count = _computed(walk, sq, sk, mask)[0]
        assert not count[sk + window:].any()


# ------------------------------------------------------------ the arithmetic
def _split(x, dtype, lo):
    hi = x.to(dtype).float()
    return hi, ((x - hi).to(dtype).float() if lo else torch.zeros_like(x))


def _emulate(q, k, v, do, lse, causal, window, scale, lo=True):
    """The Hopper kernels' float32 dq, dk and dv before their rounding,
    tile by tile.  The dQ kernel over its key tiles (QBK[d]): S and dP of
    the 16-bit values, masked scores -inf, p = exp2(S scale log2(e) - lse
    log2(e)), D over a first walk, dS = p (dP - D), then dQ += dS K on dS's
    hi and lo halves (lo first; ``lo`` False keeps hi alone).  The dK / dV
    kernel over its key blocks (KB[d]) and 64-row query tiles of the
    group's heads: S^T and dP^T whole, P^T and dS^T, then dV += P^T dO and
    dK += dS^T Q on the split halves, into the consumer's columns (all of
    them at d 128, 128 each at d 256)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group, dtype = h // kv, q.dtype
    cols = [slice(0, d)] if d <= 128 else [slice(0, 128), slice(128, d)]
    mask = torch.from_numpy(_visible(sq, sk, causal, window))
    qf, kf, vf, of = (t.float() for t in (q, k, v, do))
    l2 = lse.float() * LOG2E
    dq = torch.zeros((b, sq, h, d))
    dk = torch.zeros((b, sk, kv, d))
    dv = torch.zeros((b, sk, kv, d))
    delta = torch.zeros((b, h, sq))
    for bi in range(b):
        for hq in range(h):
            kvh = hq // group
            qh, oh = qf[bi, :, hq], of[bi, :, hq]
            kh, vh = kf[bi, :, kvh], vf[bi, :, kvh]
            for walk in range(2):
                for kt in range(0, sk, QBK[d]):
                    keys = slice(kt, min(sk, kt + QBK[d]))
                    s = (qh @ kh[keys].T).masked_fill(~mask[:, keys],
                                                      -math.inf)
                    p = torch.exp2(s * (scale * LOG2E) - l2[bi, hq, :, None])
                    dp = oh @ vh[keys].T
                    if walk == 0:
                        delta[bi, hq] += (p * dp).sum(-1)
                        continue
                    ds = p * (dp - delta[bi, hq, :, None])
                    for part in reversed(_split(ds, dtype, lo)):
                        dq[bi, :, hq] += part @ kh[keys]
        for kvh in range(kv):
            kh, vh = kf[bi, :, kvh], vf[bi, :, kvh]
            for k0 in range(0, sk, KB[d]):
                keys = slice(k0, min(sk, k0 + KB[d]))
                for hq in range(kvh * group, (kvh + 1) * group):
                    qh, oh = qf[bi, :, hq], of[bi, :, hq]
                    for qt in range(0, sq, BN):
                        rows = slice(qt, min(sq, qt + BN))
                        st = (kh[keys] @ qh[rows].T).masked_fill(
                            ~mask[rows, keys].T, -math.inf)
                        pt = torch.exp2(st * (scale * LOG2E)
                                        - l2[bi, hq, None, rows])
                        dpt = vh[keys] @ oh[rows].T
                        dst = pt * (dpt - delta[bi, hq, None, rows])
                        for c in cols:
                            for part in reversed(_split(pt, dtype, lo)):
                                dv[bi, keys, kvh, c] += part @ oh[rows, c]
                            for part in reversed(_split(dst, dtype, lo)):
                                dk[bi, keys, kvh, c] += part @ qh[rows, c]
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


def _inputs(b, sq, sk, h, kv, seed, dtype, d=128):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
            for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d),
                      (b, sq, h, d))]


# (dtype, (b, sq, sk, h, kv, causal, window[, d])): d 128 unless given
ARITH_CASES = [("bf16", (1, 200, 200, 4, 2, True, 0)),
               ("f16", (1, 150, 260, 2, 1, True, 100)),
               ("bf16", (1, 64, 16, 2, 1, False, 8)),
               ("bf16", (1, 150, 150, 4, 2, True, 0, 256)),
               ("f16", (1, 130, 200, 2, 1, True, 70, 256)),
               ("f16", (1, 64, 16, 2, 1, False, 8, 256)),
               ("bf16", (1, 1, 77, 2, 2, False, 0, 256)),
               ("bf16", (1, 200, 90, 2, 1, True, 0, 256))]


@pytest.mark.parametrize("dt,case", ARITH_CASES)
def test_emulated_kernels_match_jax_vjp(dt, case):
    b, sq, sk, h, kv, causal, window, *dims = case
    d = dims[0] if dims else 128
    q, k, v, do = _inputs(b, sq, sk, h, kv, 7, DTYPES[dt], d)
    scale = d ** -0.5
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
