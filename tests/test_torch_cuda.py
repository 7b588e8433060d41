"""The codec's CUDA kernels against their plain PyTorch versions on the
card (torch.equal: the codec is bit-exact), and a short mlp9 run on cuda
against the same run on the CPU.  Needs a CUDA card and nvcc:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips with the reason.  This file imports no
jax (the card machine has none)."""
import numpy as np
import pytest
import torch

from repro_torch.core import compression as C
from repro_torch.kernels import LAUNCHES, launch_counts, quant, wire

pytestmark = pytest.mark.cuda

CASES = [((16, 32, 32, 64), 0.25, "normal"), ((16, 16, 16, 128), 0.25,
                                              "normal"),
         ((16, 8, 8, 256), 0.25, "normal"), ((16, 4, 4, 512), 0.25,
                                             "normal"),
         ((64, 200), 0.1, "normal"), ((64, 200), 0.3, "normal"),
         ((64, 200), 1.0, "normal"), ((16, 8, 8, 256), 0.25, "ties"),
         ((4, 128), 0.25, "zeros"), ((7, 48), 0.25, "normal")]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to build and run the "
                    "codec kernels")
    return torch.device("cuda")


def _input(shape, fill, dev, seed=0):
    rng = np.random.default_rng(seed)
    if fill == "normal":
        a = rng.normal(size=shape) * 3.0
    elif fill == "ties":
        a = rng.integers(-3, 4, size=shape)
    else:
        a = np.zeros(shape)
    return torch.from_numpy(a.astype(np.float32)).to(dev)


@pytest.mark.parametrize("shape,k_frac,fill", CASES)
def test_kernels_equal_plain_versions(dev, shape, k_frac, fill):
    x = _input(shape, fill, dev)
    d = shape[-1]
    before = launch_counts()
    q, s = quant.quantize_int8(x)
    qr, sr = C.quantize_int8(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(quant.dequantize_int8(q, s), C.dequantize_int8(q, s))
    buf = wire.sparsify_quant_pack(x, k_frac)
    assert torch.equal(buf, C.sparsify_quant_pack_ref(x, k_frac))
    assert torch.equal(wire.unpack_dequant(buf, d, k_frac),
                       C.wire_dequant_ref(buf, d, k_frac))
    after = launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)


def test_wrappers_refuse_non_contiguous(dev):
    x = torch.zeros(8, 128, device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        quant.quantize_int8(x)
    with pytest.raises(ValueError, match="contiguous"):
        wire.sparsify_quant_pack(x)
    n = LAUNCHES["quantize_int8"]
    quant.quantize_int8(x.contiguous())
    assert LAUNCHES["quantize_int8"] == n + 1


def test_mlp_sim_on_cuda_matches_cpu(dev):
    from repro_torch.core import fedsim
    from repro_torch.models.mlp_unit import MLPUnitModel, make_mlp_fleet_data
    cfg = fedsim.SimConfig(n_clients=4, batch_size=8, local_epochs=1,
                           lr=1e-2, rounds=1, optimizer="sgd",
                           wire="int8")
    clients, test = make_mlp_fleet_data(4, 32)
    cpu = fedsim.FederationSim(MLPUnitModel(), clients, test, cfg,
                               device="cpu")
    gpu = fedsim.FederationSim(MLPUnitModel(), clients, test, cfg,
                               device=dev)
    before = launch_counts()
    (mc,), (mg,) = cpu.run(), gpu.run()
    steps = gpu.engine.batch_steps
    assert launch_counts()["quantize_int8"] - before["quantize_int8"] \
        == 2 * steps
    assert mc.cuts == mg.cuts
    assert abs(mc.loss - mg.loss) <= 1e-4
    for a, b in zip(cpu.units, gpu.units):
        for k in a:
            torch.testing.assert_close(b[k].cpu(), a[k], rtol=0, atol=1e-4)
