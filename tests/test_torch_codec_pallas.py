"""The port's plain codec is bit-exact against the Pallas TPU kernels it
replaces, run as tests/test_kernels.py runs them (interpret=True on CPU):
repro.kernels.quant.quantize_int8/dequantize_int8 and
repro.kernels.wire.sparsify_quant_pack/unpack_dequant.  On NaN / +-inf
(the ``nonfinite`` fill) they are held to the non-finite contract: int8
values, bitmap and value words bit for bit, scales and decoded floats NaN
exactly where the kernels' are and bit for bit elsewhere.  bfloat16 cases
(input and decoded output), as tests/test_kernels.py runs the quant
kernels, go through the port's kernel wrappers (the plain versions on the
CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _codec_inputs import nonfinite_input, same_floats, same_wire
from _torch_parity import cap_torch_threads
from repro.kernels import quant as PQ
from repro.kernels import wire as PW
from repro_torch.core import compression as T
from repro_torch.kernels import quant, wire

cap_torch_threads()

SHAPES = [(2, 32, 32, 64), (2, 16, 16, 128), (2, 8, 8, 256), (2, 4, 4, 512),
          (3, 200)]
CASES = ([(s, "normal", 0.25) for s in SHAPES]
         + [((3, 200), "normal", kf) for kf in (0.1, 0.3, 1.0)]
         + [((2, 8, 8, 256), "ties", 0.25), ((4, 128), "zeros", 0.25)]
         + [((2, 8, 8, 256), "nonfinite", 0.25),
            ((14, 200), "nonfinite", 0.1), ((14, 64), "nonfinite", 0.001),
            ((7, 48), "nonfinite", 1.0)])
# bfloat16: a cut shape, the padded tail, the scenario shape, NaN / +-inf
BF16_CASES = [((2, 8, 8, 256), "normal", 0.25), ((3, 200), "normal", 0.1),
              ((8, 64), "ties", 0.25), ((2, 8, 8, 256), "nonfinite", 0.25),
              ((14, 200), "nonfinite", 0.1)]


def make_input(shape, fill, seed=1):
    rng = np.random.default_rng(seed)
    if fill == "normal":
        a = rng.normal(size=shape) * 3.0
    elif fill == "ties":
        a = rng.integers(-3, 4, size=shape)
    elif fill == "nonfinite":
        return nonfinite_input(shape, seed)
    else:
        a = np.zeros(shape)
    return a.astype(np.float32)


@pytest.mark.parametrize("shape,fill,k_frac", CASES)
def test_codec_bit_exact_vs_pallas_interpret(shape, fill, k_frac):
    x = make_input(shape, fill)
    d = shape[-1]
    g, _, k, _ = T.wire_layout(d, k_frac)
    xt = torch.from_numpy(x)
    qp, sp = PQ.quantize_int8(jnp.asarray(x), interpret=True)
    qt, st = T.quantize_int8(xt)
    assert np.array_equal(np.asarray(qp), qt.numpy())
    assert same_floats(sp, st.numpy())
    assert same_floats(PQ.dequantize_int8(qp, sp, interpret=True),
                       T.dequantize_int8(qt, st).numpy())
    bp = np.asarray(PW.sparsify_quant_pack(jnp.asarray(x), k_frac,
                                           interpret=True))
    bt = T.sparsify_quant_pack_ref(xt, k_frac)
    assert same_wire(bp, bt.numpy(), g, k)
    assert same_floats(PW.unpack_dequant(jnp.asarray(bp), d, k_frac,
                                         interpret=True),
                       T.wire_dequant_ref(bt, d, k_frac).numpy())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("shape,fill,k_frac", BF16_CASES)
def test_codec_bf16_bit_exact_vs_pallas_interpret(shape, fill, k_frac):
    xt = torch.from_numpy(make_input(shape, fill)).to(torch.bfloat16)
    xp = jnp.asarray(xt.to(torch.float32).numpy()).astype(jnp.bfloat16)
    d = shape[-1]
    g, _, k, _ = T.wire_layout(d, k_frac)
    qp, sp = PQ.quantize_int8(xp, interpret=True)
    qt, st = quant.quantize_int8(xt)
    assert np.array_equal(np.asarray(qp), qt.numpy())
    assert same_floats(sp, st.numpy())
    dp = PQ.dequantize_int8(qp, sp, dtype=jnp.bfloat16, interpret=True)
    dt = quant.dequantize_int8(qt, st, dtype=torch.bfloat16)
    assert dp.dtype == jnp.bfloat16 and dt.dtype == torch.bfloat16
    assert same_floats(_f32(dp), _f32(dt))
    bp = np.asarray(PW.sparsify_quant_pack(xp, k_frac, interpret=True))
    bt = wire.sparsify_quant_pack(xt, k_frac)
    assert same_wire(bp, bt.numpy(), g, k)
    up = PW.unpack_dequant(jnp.asarray(bp), d, k_frac, dtype=jnp.bfloat16,
                           interpret=True)
    ut = wire.unpack_dequant(bt, d, k_frac, dtype=torch.bfloat16)
    assert up.dtype == jnp.bfloat16 and ut.dtype == torch.bfloat16
    assert same_floats(_f32(up), _f32(ut))
