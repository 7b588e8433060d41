"""Kernel 5, ``unpack_dequant_matmul``, on the CPU: its plain version
(``repro_torch.core.compression.wire_dequant_matmul_ref``) against the JAX
oracle ``repro.core.compression.wire_dequant_matmul_ref`` and the Pallas
kernel ``repro.kernels.wire.unpack_dequant_matmul`` (interpret=True, as
tests/test_kernels.py runs it), at that test's shapes and mlp9's; the
autograd Function's gradients against autograd through the dense
composition; w in bfloat16 / float16 through the kernel wrapper (the plain
version on the CPU) against the oracle and the Pallas kernel given the
same w; and mlp9's packed RSU entry on the FederationSim path.

Tolerances: the unpack and the dequantized slabs are exact (bit-equal);
only each slab's product sums in the BLAS's order, which torch's CPU matmul
and XLA's dot need not share, so the products agree within 1e-6 of the
largest output.  Gradients within 1e-5 (float32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads
from repro.core import compression as JC
from repro.kernels import wire as PW
from repro_torch.core import compression as C
from repro_torch.core import fedsim as TF
from repro_torch.kernels import launch_counts, wire
from repro_torch.models import mlp_unit as TM

cap_torch_threads()

# (rows, d, n): tests/test_kernels.py:169-180 at 16 rows, then mlp9's cut
SHAPES = [(16, 256, 64), (16, 200, 32), (16, 48, 16), (16, 64, 64)]


def _inputs(rows, d, n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, d)) * 5.0).astype(np.float32)
    w = rng.normal(size=(d, n)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("rows,d,n", SHAPES)
def test_plain_matches_jax_oracle_and_pallas(rows, d, n):
    x, w = _inputs(rows, d, n)
    buf = C.sparsify_quant_pack_ref(torch.from_numpy(x))
    jbuf = JC.sparsify_quant_pack_ref(jnp.asarray(x))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    # the dequantized slabs are exact
    g, ng, k, wpg = C.wire_layout(d)
    q, scale, _ = C._unpack_groups(buf.reshape(rows, ng, wpg), g, k)
    jq, jscale, _ = JC._unpack_groups(jbuf.reshape(rows, ng, wpg), g, k)
    for j in range(ng):
        ref = np.asarray(jq[:, j].astype(jnp.float32) * jscale[:, j, None])
        np.testing.assert_array_equal(C.dequant_slab(q, scale, j).numpy(),
                                      ref)
    got = C.wire_dequant_matmul_ref(buf, torch.from_numpy(w)).numpy()
    for want in (JC.wire_dequant_matmul_ref(jbuf, jnp.asarray(w)),
                 PW.unpack_dequant_matmul(jbuf, jnp.asarray(w),
                                          interpret=True)):
        want = np.asarray(want)
        assert got.shape == want.shape == (rows, n)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("rows,d,n", [(16, 64, 64), (16, 200, 32)])
def test_2byte_w_matches_jax_oracle_and_pallas(rows, d, n, dtype):
    """w in bf16 / f16 is widened exactly: the wrapper's output is the f32
    w's bit for bit, and the oracle's and the Pallas kernel's within the
    products' tolerance."""
    x, w = _inputs(rows, d, n, seed=1)
    wt = torch.from_numpy(w).to(getattr(torch, dtype))
    wj = jnp.asarray(wt.to(torch.float32).numpy()).astype(dtype)
    buf = wire.sparsify_quant_pack(torch.from_numpy(x))
    jbuf = jnp.asarray(buf.numpy())
    got = wire.unpack_dequant_matmul(buf, wt)
    assert got.dtype == torch.float32
    assert torch.equal(got, wire.unpack_dequant_matmul(buf, wt.float()))
    for want in (JC.wire_dequant_matmul_ref(jbuf, wj),
                 PW.unpack_dequant_matmul(jbuf, wj, interpret=True)):
        want = np.asarray(want)
        assert want.dtype == np.float32
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_wrapper_takes_plain_version_on_cpu():
    x, w = _inputs(8, 64, 64, seed=1)
    buf = C.sparsify_quant_pack_ref(torch.from_numpy(x))
    before = launch_counts()
    out = wire.unpack_dequant_matmul(buf, torch.from_numpy(w))
    assert torch.equal(out, C.wire_dequant_matmul_ref(buf,
                                                      torch.from_numpy(w)))
    assert launch_counts() == before          # no kernel launch on the CPU
    with pytest.raises(ValueError, match="ng\\*wpg"):
        wire.unpack_dequant_matmul(buf[:, :-1], torch.from_numpy(w))
    with pytest.raises(TypeError):
        wire.unpack_dequant_matmul(buf.float(), torch.from_numpy(w))


@pytest.mark.parametrize("d,n", [(64, 64), (200, 32)])
def test_autograd_function_matches_dense_composition(d, n):
    """relu(dequant_matmul(buf, w) + b): dW, db and the cut-layer gradient
    (g @ w^T at the product) equal autograd through relu(dense @ w + b);
    the Function keeps only the int32 buffer and w for its backward."""
    x, w0 = _inputs(16, d, n, seed=2)
    buf = C.sparsify_quant_pack_ref(torch.from_numpy(x))
    dense = C.wire_dequant_ref(buf, d).requires_grad_(True)
    b0 = np.random.default_rng(3).normal(size=n).astype(np.float32)
    target = torch.from_numpy(
        np.random.default_rng(4).normal(size=(16, n)).astype(np.float32))

    def loss_of(h):
        return ((h - target) ** 2).mean()

    w = torch.from_numpy(w0).requires_grad_(True)
    b = torch.from_numpy(b0).requires_grad_(True)
    entry = wire.dequant_matmul(buf, w)
    saved = entry.grad_fn.saved_tensors
    assert all(t.dtype == torch.int32 or tuple(t.shape) == (d, n)
               for t in saved)
    assert not any(t.dtype == torch.float32 and tuple(t.shape) == (16, d)
                   for t in saved)
    gw, gb, g_entry = torch.autograd.grad(
        loss_of(torch.relu(entry + b)), [w, b, entry])
    g_cut = g_entry @ w.detach().t()

    w2 = torch.from_numpy(w0).requires_grad_(True)
    b2 = torch.from_numpy(b0).requires_grad_(True)
    rw, rb, rcut = torch.autograd.grad(
        loss_of(torch.relu(dense @ w2 + b2)), [w2, b2, dense])
    for a, r in ((gw, rw), (gb, rb), (g_cut, rcut)):
        assert float((a - r).abs().max()) <= 1e-5


def test_mlp9_rsu_entry_reads_the_packed_buffer(monkeypatch):
    """On topk_int8 the mlp9 RSU side starts from the buffer itself (every
    client batch step goes through the packed entry), and the bytes that
    crossed the wire stay the buffers' own."""
    calls = []
    real = TM.MLPUnitModel.apply_units_packed

    def spy(self, units, buf, start, k_frac):
        calls.append((buf.dtype, start))
        return real(self, units, buf, start, k_frac)

    monkeypatch.setattr(TM.MLPUnitModel, "apply_units_packed", spy)
    clients, test = TM.make_mlp_fleet_data(4, 16, seed=5, n_test=16)
    cfg = TF.SimConfig(n_clients=4, batch_size=8, local_steps=1, lr=1e-2,
                       rounds=1, optimizer="sgd", wire="topk_int8",
                       eval_every=0)
    sim = TF.FederationSim(TM.MLPUnitModel(), clients, test, cfg,
                           device="cpu")
    (m,) = sim.run()
    assert len(calls) == sim.engine.batch_steps == 4
    assert all(dt == torch.int32 and 1 <= cut <= 8 for dt, cut in calls)
    assert np.isfinite(m.loss)
    # uplink + downlink, 7 words per (row, group) of 64 values at k = 16
    assert sim.engine.wire_bytes == 4 * 2 * 8 * 7 * 4
