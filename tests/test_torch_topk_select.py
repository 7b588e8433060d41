"""The top-k selection of the ``sparsify_quant_pack`` kernel, emulated on
the CPU with integer operations and held exactly to the plain ``_topk_mask``
of the port and of the JAX package.

On the card one warp owns one group of g <= 128 values: lane l holds values
i = l + 32 t for the value slots t < ceil(g/32).  The kernel
(``kernels/csrc/codec.cu``) selects the exactly-k survivors by a radix
select with warp ballots:

- key = the float32 bits of |x| as uint32 (the sign bit cleared); lanes
  with i >= g hold no key and ballot 0;
- a NaN lane (bits of |x| above 0x7f800000, those of +inf) holds key 0,
  which no candidate of the descent (>= 1) reaches, is left out of the
  ``eq`` ballot, and sets its bit: the reference's NaN is beaten by nothing
  and beats nothing, so it survives beside the k winners;
- T = the largest t with #(key >= t) >= k, set bit by bit from bit 30 down,
  each count the popcounts of one ballot per slot; the descent stops as
  soon as a candidate's count equals k;
- keys > T survive, and a key == T survives when #(key > T) plus the
  popcounts of the earlier slots' ``eq`` ballots and of its own ``eq``
  ballot below its lane is < k;
- bitmap word t is the ballot of slot t's survivors.

Here the same steps run on numpy uint32 arrays of shape (groups, slots, 32
lanes), ballots as 32-bit masks, and the bitmaps are compared with the plain
versions' masks and with the bitmap words of the port's
``sparsify_quant_pack_ref``.  Tolerance: exact (every bit).

XLA on the CPU treats subnormal floats as zero in comparisons (checked at
import below); the port's plain version and the kernel order them as
values.  So the emulation is held to the JAX mask on the input with
subnormals flushed to +0 when XLA flushes, and to the port's mask on the
input as it is.  Either way a subnormal quantises to 0 (the scale is at
least 1e-8/127), so the two differ only in which zero-valued positions set
a bitmap bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import compression as JC
from repro_torch.core import compression as C

LANES = 32
SIGN = np.uint32(0x80000000)
INF_BITS = np.uint32(0x7f800000)          # keys above it are NaNs
# does XLA:CPU compare the smallest subnormal as zero?
JAX_FLUSHES_SUBNORMALS = not bool(jnp.float32(1e-45) > jnp.float32(0.0))


def popc(m: np.ndarray) -> np.ndarray:
    return np.bitwise_count(m.astype(np.uint32)).astype(np.int64)


def ballot(pred: np.ndarray) -> np.ndarray:
    """(..., 32) bool -> (...) uint32: bit l set when lane l's pred holds."""
    lanes = np.uint32(1) << np.arange(LANES, dtype=np.uint32)
    return np.bitwise_or.reduce(np.where(pred, lanes, np.uint32(0)), axis=-1)


def warp_select(xg: np.ndarray, k) -> np.ndarray:
    """The kernel's selection for groups xg (G, g) float32 with k survivors
    (an int, or one per group as (G, 1)) -> bitmap words (G, ceil(g/32))
    uint32, one ballot per value slot."""
    n_groups, g = xg.shape
    k = np.broadcast_to(np.asarray(k).reshape(-1, 1, 1), (n_groups, 1, 1))
    nt = -(-g // LANES)
    bits = np.zeros((n_groups, nt * LANES), np.uint32)
    bits[:, :g] = xg.astype(np.float32).view(np.uint32)
    key = (bits & ~SIGN).reshape(n_groups, nt, LANES)       # [grp, t, lane]
    live = (np.arange(nt * LANES) < g).reshape(1, nt, LANES)
    nan = live & (key > INF_BITS)
    key = np.where(nan, np.uint32(0), key)
    thr = np.zeros((n_groups, 1, 1), np.uint32)
    done = np.zeros((n_groups, 1, 1), bool)
    for b in range(30, -1, -1):
        cand = thr | np.uint32(1 << b)
        cnt = popc(ballot(live & (key >= cand))).sum(-1)[:, None, None]
        take = ~done & (cnt >= k)
        thr = np.where(take, cand, thr)
        done |= take & (cnt == k)           # the kernel leaves its loop
    ahead = popc(ballot(live & (key > thr))).sum(-1)          # (G,)
    eq = ballot(live & ~nan & (key == thr))                   # (G, nt)
    eq_before = np.cumsum(popc(eq), -1) - popc(eq)            # earlier slots
    lt = (np.uint32(1) << np.arange(LANES, dtype=np.uint32)) - np.uint32(1)
    rank = eq_before[..., None] + popc(eq[..., None] & lt)    # (G, nt, 32)
    keep = live & ((key > thr)
                   | ((key == thr) & (ahead[:, None, None] + rank < k)))
    return ballot(keep | nan)


def mask_words(mask: np.ndarray) -> np.ndarray:
    """(G, g) bool -> (G, ceil(g/32)) uint32 bitmap words."""
    n_groups, g = mask.shape
    nt = -(-g // LANES)
    padded = np.zeros((n_groups, nt * LANES), bool)
    padded[:, :g] = mask
    return ballot(padded.reshape(n_groups, nt, LANES))


def flush_subnormals(a: np.ndarray) -> np.ndarray:
    a = a.astype(np.float32)
    return np.where(np.abs(a) < np.finfo(np.float32).tiny,
                    np.float32(0.0), a)


# both plain versions end in `rank < k`, so k may be one per group (G, 1)
def port_words(xg: np.ndarray, k) -> np.ndarray:
    absx = torch.from_numpy(np.abs(xg.astype(np.float32)))
    kk = torch.from_numpy(np.asarray(k)) if np.ndim(k) else k
    return mask_words(C._topk_mask(absx, kk).numpy())


def jax_words(xg: np.ndarray, k) -> np.ndarray:
    mask = JC._topk_mask(jnp.abs(jnp.asarray(xg, jnp.float32)),
                         jnp.asarray(k))
    return mask_words(np.asarray(mask))


def check(xg: np.ndarray, k) -> None:
    got = warp_select(xg, k)
    np.testing.assert_array_equal(got, port_words(xg, k))
    # exactly k of the non-NaN values (all when fewer), and every NaN
    nan = np.isnan(xg).sum(-1)
    want = np.minimum(np.broadcast_to(np.asarray(k).reshape(-1),
                                      (len(xg),)), xg.shape[-1] - nan) + nan
    np.testing.assert_array_equal(popc(got).sum(-1), want)
    jax_in = flush_subnormals(xg) if JAX_FLUSHES_SUBNORMALS else xg
    np.testing.assert_array_equal(warp_select(jax_in, k),
                                  jax_words(xg, k))


def make_groups(fill: str, n_groups: int, g: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (n_groups, g)
    if fill == "normal":
        a = rng.normal(size=shape) * 3.0
    elif fill == "int_ties":
        a = rng.integers(-3, 4, size=shape)
    elif fill == "all_equal":
        a = np.where(rng.random(shape) < 0.5, -1.5, 1.5)
    elif fill == "all_zero":
        a = np.zeros(shape)
    elif fill == "nonfinite":
        # NaNs of both signs, quiet and signalling payloads (keys just above
        # and far above +inf's), and +-inf (ties of them) among normal
        # values and zeros (ties at key 0, a NaN lane's key); the last
        # group all NaN
        nans = np.array([0x7fc00000, 0xffc00000, 0x7f800001, 0xff800001,
                         0x7fffffff], np.uint32).view(np.float32)
        a = rng.normal(size=shape).astype(np.float32)
        a = np.where(rng.random(shape) < 0.2, np.float32(0.0), a)
        a = np.where(rng.random(shape) < 0.1,
                     rng.choice(nans, size=shape), a)
        infs = np.array([-np.inf, np.inf], np.float32)
        a = np.where(rng.random(shape) < 0.05, rng.choice(infs, size=shape),
                     a)
        a[-1] = nans[0]
    elif fill == "signed_zeros":
        # +0.0 / -0.0 with a few normal values among them
        a = np.where(rng.random(shape) < 0.5, -0.0, 0.0)
        a = np.where(rng.random(shape) < 0.1, rng.normal(size=shape), a)
    else:                                   # subnormals next to zeros
        sub = rng.integers(1, 1 << 23, size=shape).astype(np.uint32)
        sub = sub.view(np.float32) * np.where(rng.random(shape) < 0.5,
                                              np.float32(-1), np.float32(1))
        a = np.where(rng.random(shape) < 0.4, sub, 0.0)
        a = np.where(rng.random(shape) < 0.3, sub[:, ::-1], a)  # ties
        a = np.where(rng.random(shape) < 0.05, rng.normal(size=shape), a)
    return np.asarray(a, np.float32)


FILLS = ("normal", "int_ties", "all_equal", "all_zero", "signed_zeros",
         "subnormals", "nonfinite")


@pytest.mark.parametrize("g", [48, 64, 128])
@pytest.mark.parametrize("fill", FILLS)
def test_warp_select_matches_topk_mask(g, fill):
    """Every k from 1 to g over the same six groups, in one batch."""
    xg = make_groups(fill, 6, g, seed=g)
    ks = np.repeat(np.arange(1, g + 1), len(xg))[:, None]
    check(np.tile(xg, (g, 1)), ks)


@pytest.mark.parametrize("k_frac", [0.01, 0.1, 0.25, 0.3, 1.0])
@pytest.mark.parametrize("fill", ["normal", "int_ties", "subnormals",
                                  "nonfinite"])
def test_warp_select_padded_tail_matches_pack(k_frac, fill):
    """d = 200: two groups of 128, the second padded with 56 zeros that
    rank at their own indices; the emulated ballots equal the bitmap words
    of the port's sparsify_quant_pack_ref."""
    d = 200
    x = make_groups(fill, 8, d, seed=7)
    g, ng, k, wpg = C.wire_layout(d, k_frac)
    xg = np.zeros((8, ng * g), np.float32)
    xg[:, :d] = x
    xg = xg.reshape(-1, g)
    check(xg, k)
    buf = C.sparsify_quant_pack_ref(torch.from_numpy(x), k_frac).numpy()
    bw = -(-g // LANES)
    words = buf.reshape(-1, wpg)[:, :bw].view(np.uint32)
    np.testing.assert_array_equal(warp_select(xg, k), words)


def test_jax_flush_probe_matches_its_masks():
    """The flush the comparison with JAX assumes is what XLA does here:
    a subnormal ties with zero exactly when JAX_FLUSHES_SUBNORMALS."""
    xg = np.array([[0.0, 1e-45, 0.0, 2e-40]], np.float32)
    want = [[True, False, False, False]] if JAX_FLUSHES_SUBNORMALS \
        else [[False, False, False, True]]
    np.testing.assert_array_equal(
        np.asarray(JC._topk_mask(jnp.abs(jnp.asarray(xg)), 1)), want)


VALUES = [0.0, -0.0, 1e-45, -1e-45, 3e-39, 1.0, -1.0, 2.5, 1e30, -7.0,
          0.5, 1.17549435e-38]


@settings(max_examples=12, deadline=None, derandomize=True)
@given(st.data())
def test_warp_select_hypothesis(data):
    g = data.draw(st.sampled_from([1, 7, 32, 33, 64, 100, 128]), label="g")
    k = data.draw(st.integers(1, g), label="k")
    n_groups = 2             # few distinct shapes: XLA compiles per shape
    vals = data.draw(st.lists(
        st.one_of(st.sampled_from(VALUES),
                  st.floats(-1e6, 1e6, width=32, allow_subnormal=True)),
        min_size=n_groups * g, max_size=n_groups * g), label="values")
    check(np.asarray(vals, np.float32).reshape(n_groups, g), k)
