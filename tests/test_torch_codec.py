"""The port's plain codec is bit-exact against the JAX oracles
(repro.core.compression) at the main path's cut shapes and the edge cases:
padded tail group (d=200), k not a multiple of 4, tie-heavy integer inputs,
all-zero groups, and NaN / +-inf (the ``nonfinite`` fill), held to the
non-finite contract: int8 values, bitmap and value words bit for bit, scales
and decoded floats NaN exactly where the reference's are and bit for bit
elsewhere.  Also the byte accounting and the kernel wrappers' CPU dispatch
and argument checks."""
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
from repro_torch.kernels import LAUNCHES, quant, wire

cap_torch_threads()

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


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


def j_quant(x):
    return _jit(J.quantize_int8)(jnp.asarray(x))


def j_pack(x, kf):
    return np.asarray(_jit(J.sparsify_quant_pack_ref, 1)(jnp.asarray(x), kf))


def j_unpack(buf, d, kf):
    return np.asarray(_jit(J.wire_dequant_ref, 1, 2)(jnp.asarray(buf), d, kf))


def j_dense(x, kf):
    return np.asarray(_jit(J.wire_topk_dense, 1)(jnp.asarray(x), kf))


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("shape", SHAPES)
def test_quant_bit_exact_vs_jax_oracle(shape, fill):
    x = make_input(shape, fill)
    qj, sj = j_quant(x)
    qt, st = T.quantize_int8(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(np.asarray(qj), qt.numpy())
    assert same_floats(sj, st.numpy())
    dj = np.asarray(_jit(J.dequantize_int8)(qj, sj))
    dt = T.dequantize_int8(qt, st).numpy()
    assert same_floats(dj, dt)


@pytest.mark.parametrize("k_frac", K_FRACS)
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("shape", SHAPES)
def test_wire_bit_exact_vs_jax_oracle(shape, fill, k_frac):
    x = make_input(shape, fill)
    d = shape[-1]
    g, _, k, _ = T.wire_layout(d, k_frac)
    bj = j_pack(x, k_frac)
    bt = T.sparsify_quant_pack_ref(torch.from_numpy(x), k_frac)
    assert bt.dtype == torch.int32 and bj.dtype == np.int32
    assert same_wire(bj, bt.numpy(), g, k)
    assert same_floats(j_unpack(bj, d, k_frac),
                       T.wire_dequant_ref(bt, d, k_frac).numpy())
    assert same_floats(j_dense(x, k_frac),
                       T.wire_topk_dense(torch.from_numpy(x),
                                         k_frac).numpy())
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
    bj = j_pack(x, 0.001)
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
        wire.sparsify_quant_pack(x.to(torch.bfloat16))
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
