"""The port's plain codec is bit-exact against the Pallas TPU kernels it
replaces, run as tests/test_kernels.py runs them (interpret=True on CPU):
repro.kernels.quant.quantize_int8/dequantize_int8 and
repro.kernels.wire.sparsify_quant_pack/unpack_dequant."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads
from repro.kernels import quant as PQ
from repro.kernels import wire as PW
from repro_torch.core import compression as T

cap_torch_threads()

SHAPES = [(2, 32, 32, 64), (2, 16, 16, 128), (2, 8, 8, 256), (2, 4, 4, 512),
          (3, 200)]
CASES = ([(s, "normal", 0.25) for s in SHAPES]
         + [((3, 200), "normal", kf) for kf in (0.1, 0.3, 1.0)]
         + [((2, 8, 8, 256), "ties", 0.25), ((4, 128), "zeros", 0.25)])


def make_input(shape, fill, seed=1):
    rng = np.random.default_rng(seed)
    if fill == "normal":
        a = rng.normal(size=shape) * 3.0
    elif fill == "ties":
        a = rng.integers(-3, 4, size=shape)
    else:
        a = np.zeros(shape)
    return a.astype(np.float32)


@pytest.mark.parametrize("shape,fill,k_frac", CASES)
def test_codec_bit_exact_vs_pallas_interpret(shape, fill, k_frac):
    x = make_input(shape, fill)
    d = shape[-1]
    xt = torch.from_numpy(x)
    qp, sp = PQ.quantize_int8(jnp.asarray(x), interpret=True)
    qt, st = T.quantize_int8(xt)
    assert np.array_equal(np.asarray(qp), qt.numpy())
    assert np.array_equal(np.asarray(sp), st.numpy())
    assert np.array_equal(np.asarray(PQ.dequantize_int8(qp, sp,
                                                        interpret=True)),
                          T.dequantize_int8(qt, st).numpy())
    bp = np.asarray(PW.sparsify_quant_pack(jnp.asarray(x), k_frac,
                                           interpret=True))
    bt = T.sparsify_quant_pack_ref(xt, k_frac)
    assert np.array_equal(bp, bt.numpy())
    assert np.array_equal(
        np.asarray(PW.unpack_dequant(jnp.asarray(bp), d, k_frac,
                                     interpret=True)),
        T.wire_dequant_ref(bt, d, k_frac).numpy())
