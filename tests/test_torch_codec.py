"""The port's plain codec is bit-exact against the JAX oracles
(repro.core.compression) at the main path's cut shapes and the edge cases:
padded tail group (d=200), k not a multiple of 4, tie-heavy integer inputs,
all-zero groups, and NaN / +-inf (the ``nonfinite`` fill), held to the
non-finite contract: int8 values, bitmap and value words bit for bit, scales
and decoded floats NaN exactly where the reference's are and bit for bit
elsewhere.  Every input and output dtype the reference takes (float32,
bfloat16, float16) goes through the kernel wrappers, which run the plain
versions on the CPU, and the boundary sites give back the sender's dtype
as the reference's do.  Also the byte accounting and the wrappers' CPU
dispatch and argument checks."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _codec_inputs import nonfinite_input, same_floats, same_wire
from _torch_parity import cap_torch_threads
from repro.core import compression as J
from repro_torch.core import compression as T
from repro_torch.core import distributed, fedsim
from repro_torch.kernels import LAUNCHES, quant, wire

cap_torch_threads()

# torch dtype and jax dtype of each float type the codec takes
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}

# the four ResNet18 cut shapes of the main path at batch 2, then the edges
SHAPES = [(2, 32, 32, 64), (2, 16, 16, 128), (2, 8, 8, 256), (2, 4, 4, 512),
          (3, 200), (5, 48)]
K_FRACS = [0.1, 0.25, 0.3, 1.0]
FILLS = ["normal", "ties", "zeros", "nonfinite"]


def make_input(shape, fill, seed=0):
    rng = np.random.default_rng(seed)
    if fill == "normal":
        a = rng.normal(size=shape) * 3.0
    elif fill == "ties":
        a = rng.integers(-3, 4, size=shape)
    elif fill == "nonfinite":
        return nonfinite_input(shape, seed)
    else:
        a = np.zeros(shape)
        half = shape[-1] // 2
        a[..., :half] = rng.normal(size=shape[:-1] + (half,))
        a[0] = 0.0                      # whole all-zero groups on row 0
    return a.astype(np.float32)


def cast(x, dtype):
    """x (f32 numpy) in ``dtype``: (torch tensor, jax array) of the same
    values (the 2-byte types: x rounded once, by torch, then widened
    exactly for jax)."""
    tdt, jdt = DTYPES[dtype]
    xt = torch.from_numpy(x).to(tdt)
    return xt, jnp.asarray(xt.to(torch.float32).numpy()).astype(jdt)


def f32(a):
    """A float array or tensor of any codec dtype, widened to f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


def j_quant(x):
    return _jit(J.quantize_int8)(jnp.asarray(x))


def j_pack(x, kf):
    return np.asarray(_jit(J.sparsify_quant_pack_ref, 1)(jnp.asarray(x), kf))


def j_unpack(buf, d, kf, dtype=jnp.float32):
    return _jit(J.wire_dequant_ref, 1, 2, 3, 4)(jnp.asarray(buf), d, kf,
                                                J.GROUP, dtype)


def j_dense(x, kf):
    return _jit(J.wire_topk_dense, 1)(jnp.asarray(x), kf)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("shape", SHAPES)
def test_quant_bit_exact_vs_jax_oracle(shape, fill, dtype):
    """Plain versions and wrappers (the plain versions on the CPU), x in
    every float dtype and dequantized to it."""
    xt, xj = cast(make_input(shape, fill), dtype)
    qj, sj = j_quant(xj)
    qt, st = T.quantize_int8(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(np.asarray(qj), qt.numpy())
    assert same_floats(sj, st.numpy())
    qw, sw = quant.quantize_int8(xt)
    assert torch.equal(qw, qt) and same_floats(sw.numpy(), st.numpy())
    dj = _jit(J.dequantize_int8, 2)(qj, sj, xj.dtype)
    dt = T.dequantize_int8(qt, st, xt.dtype)
    dw = quant.dequantize_int8(qt, st, dtype=xt.dtype)
    assert dt.dtype == dw.dtype == xt.dtype and dj.dtype == xj.dtype
    assert same_floats(f32(dj), f32(dt)) and same_floats(f32(dj), f32(dw))


# the 2-byte types at the path's keep-fraction
WIRE_DTYPE_CASES = ([("float32", kf) for kf in K_FRACS]
                    + [("bfloat16", 0.25), ("float16", 0.25)])


@pytest.mark.parametrize("dtype,k_frac", WIRE_DTYPE_CASES)
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("shape", SHAPES)
def test_wire_bit_exact_vs_jax_oracle(shape, fill, dtype, k_frac):
    """Plain versions and wrappers, x in every float dtype, unpacked to
    it."""
    xt, xj = cast(make_input(shape, fill), dtype)
    d = shape[-1]
    g, _, k, _ = T.wire_layout(d, k_frac)
    bj = np.asarray(j_pack(xj, k_frac))
    bt = T.sparsify_quant_pack_ref(xt, k_frac)
    assert bt.dtype == torch.int32 and bj.dtype == np.int32
    assert same_wire(bj, bt.numpy(), g, k)
    assert torch.equal(wire.sparsify_quant_pack(xt, k_frac), bt)
    uj = j_unpack(bj, d, k_frac, xj.dtype)
    ut = T.wire_dequant_ref(bt, d, k_frac, dtype=xt.dtype)
    uw = wire.unpack_dequant(bt, d, k_frac, dtype=xt.dtype)
    assert ut.dtype == uw.dtype == xt.dtype and uj.dtype == xj.dtype
    assert same_floats(f32(uj), f32(ut)) and same_floats(f32(uj), f32(uw))
    dj = j_dense(xj, k_frac)
    dt = T.wire_topk_dense(xt, k_frac)
    assert dt.dtype == xt.dtype and dj.dtype == xj.dtype
    assert same_floats(f32(dj), f32(dt))
    # round trip of the intermediate pieces (q, scale, mask)
    qj, sj, mj = _jit(J.unpack_wire, 1, 2)(jnp.asarray(bj), d, k_frac)
    qt, st, mt = T.unpack_wire(bt, d, k_frac)
    assert np.array_equal(np.asarray(qj), qt.numpy())
    assert same_floats(sj, st.numpy())
    assert np.array_equal(np.asarray(mj), mt.numpy())


def test_nan_survives_beside_the_k_winners():
    """A NaN is beaten by nothing and beats nothing: every NaN of a group
    sets its bit beside the k finite winners (three NaNs at k = 1 used to
    raise in the pack), its value slot >= k is dropped, the group's int8
    values are 0 and it decodes to NaN, as in the reference."""
    x = np.arange(1, 65, dtype=np.float32)[None].repeat(2, 0)
    x[0, [3, 10, 20]] = np.nan
    buf = T.sparsify_quant_pack_ref(torch.from_numpy(x), 0.001)   # k = 1
    bj = np.asarray(j_pack(x, 0.001))
    assert same_wire(bj, buf.numpy(), 64, 1)
    q, s, mask = T.unpack_wire(buf, 64, 0.001)
    assert mask[0].nonzero().ravel().tolist() == [3, 10, 20, 63]
    assert mask[1].nonzero().ravel().tolist() == [63]
    assert not q[0].any() and np.isnan(s[0].item())
    dense = T.wire_dequant_ref(buf, 64, 0.001)
    assert torch.isnan(dense[0]).all() and not torch.isnan(dense[1]).any()


def test_topk_exactly_k_with_ties():
    """All-equal groups keep exactly k survivors, the lowest indices."""
    x = np.ones((4, 128), np.float32)
    _, _, mask = T.sparsify_topk_int8(torch.from_numpy(x), 0.25)
    assert mask.sum(-1).tolist() == [32] * 4
    assert mask[:, :32].all() and not mask[:, 32:].any()


@pytest.mark.parametrize("k_frac", K_FRACS)
@pytest.mark.parametrize("d", [48, 64, 128, 200, 256, 512])
def test_layout_and_byte_accounting_match(d, k_frac):
    assert T.wire_layout(d, k_frac) == J.wire_layout(d, k_frac)
    assert T.wire_row_bytes(d, k_frac) == J.wire_row_bytes(d, k_frac)
    for scheme in T.WIRE_SCHEMES:
        assert T.wire_compression_ratio(scheme, trailing_dim=d,
                                        k_frac=k_frac) \
            == J.wire_compression_ratio(scheme, trailing_dim=d,
                                        k_frac=k_frac)
    assert T.compression_ratio(trailing_dim=d) == J.compression_ratio(
        trailing_dim=d)
    assert T.effective_group(d) == J.effective_group(d)
    x = torch.zeros(3, d)
    assert 4 * T.sparsify_quant_pack_ref(x, k_frac).shape[-1] \
        == T.wire_row_bytes(d, k_frac)


def test_wrappers_take_the_plain_version_on_cpu():
    x = torch.from_numpy(make_input((2, 8, 8, 256), "normal"))
    before = dict(LAUNCHES)
    q, s = quant.quantize_int8(x)
    qr, sr = T.quantize_int8(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(quant.dequantize_int8(q, s), T.dequantize_int8(q, s))
    buf = wire.sparsify_quant_pack(x, 0.25)
    assert torch.equal(buf, T.sparsify_quant_pack_ref(x, 0.25))
    assert torch.equal(wire.unpack_dequant(buf, 256, 0.25),
                       T.wire_dequant_ref(buf, 256, 0.25))
    assert dict(LAUNCHES) == before       # no kernel launched on the CPU


def test_wrappers_reject_bad_arguments():
    x = torch.zeros(2, 64)
    with pytest.raises(TypeError):
        quant.quantize_int8(x.double())
    with pytest.raises(TypeError):
        wire.sparsify_quant_pack(x.to(torch.int32))
    with pytest.raises(ValueError):
        quant.quantize_int8(x, group=256)
    buf = wire.sparsify_quant_pack(x)
    with pytest.raises(ValueError):
        wire.unpack_dequant(buf, 128)          # wrong d for this buffer
    q, s = quant.quantize_int8(x)
    with pytest.raises(ValueError):
        quant.dequantize_int8(q, s[:1])        # scales do not match q
    with pytest.raises(TypeError):
        quant.dequantize_int8(q.to(torch.int32), s)


def test_wrappers_reject_other_float_dtypes():
    """float64 (and any type but f32 / bf16 / f16) raises TypeError, for x,
    w and a decoder's output dtype."""
    x = torch.zeros(2, 64)
    buf = wire.sparsify_quant_pack(x)
    q, s = quant.quantize_int8(x)
    for bad in (torch.float64, torch.int8, torch.int32):
        with pytest.raises(TypeError):
            quant.dequantize_int8(q, s, dtype=bad)
        with pytest.raises(TypeError):
            wire.unpack_dequant(buf, 64, dtype=bad)
        with pytest.raises(TypeError):
            wire.unpack_dequant_matmul(buf, torch.zeros(64, 8, dtype=bad))
    with pytest.raises(TypeError):
        wire.sparsify_quant_pack(x.double())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("scheme", ["int8", "topk_int8"])
def test_boundary_sites_keep_the_senders_dtype(scheme, dtype):
    """The wire trip and the serving cut give back the sender's dtype, with
    the reference's values: ``fake_quant`` / ``wire_topk_dense``."""
    xt, xj = cast(make_input((4, 8, 64), "normal", seed=3), dtype)
    cfg = fedsim.SimConfig(wire=scheme)
    got, _ = fedsim.wire_trip(cfg, xt)
    want = (_jit(J.fake_quant)(xj) if scheme == "int8"
            else j_dense(xj, cfg.wire_k))
    assert got.dtype == xt.dtype and want.dtype == xj.dtype
    assert same_floats(f32(want), f32(got))
    if scheme == "int8":
        cross = distributed._cross(
            xt, distributed.DistOptions(compress_smashed=True))
        assert cross.dtype == xt.dtype
        assert same_floats(f32(want), f32(cross))
