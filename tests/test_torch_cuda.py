"""The port's CUDA kernels against their plain PyTorch versions on the
card — the codec bit-exact (on NaN / +-inf input under the non-finite
contract: NaN exactly where the plain version's is, every other float,
int8 and word bit for bit), unpack_dequant_matmul /
rmsnorm / flash attention / SSD within stated float32 tolerances at their
paths' shapes and edge shapes (rmsnorm and its backward kernel also in
bfloat16 and float16 within one ulp, unaligned, the backward twice bit
for bit and under ``vmap`` of ``grad``; flash in bfloat16 and float16
within one ulp plus its float32 tolerance, twice bit for bit, strided and
unaligned, on the route ``flash_route`` picks — d 128 on the Hopper
kernel, which the mma route forced at the same shapes agrees with and
which refuses what it does not take; flash's backward kernels in all
three dtypes against its closed form and the plain vjp, twice bit for
bit, strided, and one launch under ``vmap`` of ``grad``, on the route
``flash_backward_route`` picks — 16-bit d 128 on the Hopper kernels,
held with the mma route forced at the same inputs, one launch under
``vmap`` of ``grad`` there too, and what they refuse going to the mma
kernels, counted by route) — short mlp9
runs (single RSU under the
loop and under vmap with the launch counts each schedule implies, one
multi-RSU scenario round on topk_int8, and a window of the parallel
server schedule with its launch formula) on cuda against the same runs on
the CPU, the parallel window's determinism (two runs, and the dense layout
beside the ragged one, bit for bit), the fault and streaming planes on
the scenario path (K = 4 windows equal to K = 1 on the card, the codec
launch formula under dropouts, the two-cell trace with both planes on
against the CPU), the reduced city paged (card against CPU, two runs bit
for bit, launches per page, the paged peak memory below the unpaged),
resnet18 under vmap against the loop on the card, the reduced LM configs
served on cuda against the CPU (the bfloat16 archs' on bfloat16 weights),
the optimizers' in-place step against their functional form bit for bit,
a reduced bfloat16 train step (the donated one) against the CPU, the
MoE's grouped dispatch with drops on cuda against the CPU, a reduced
deepseek train step (MLA, MoE on both paths, routing compared first)
against the CPU and the MoE's dense path under ``vmap``.  Needs a CUDA
card and nvcc:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips with the reason.  This file imports no
jax (the card machine has none)."""
import functools

import numpy as np
import pytest
import torch
from _codec_inputs import nonfinite_input, same_floats, same_wire

from repro_torch.core import compression as C
from repro_torch.kernels import LAUNCHES, launch_counts, quant, wire
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd as SSD

pytestmark = pytest.mark.cuda

CASES = [((16, 32, 32, 64), 0.25, "normal"), ((16, 16, 16, 128), 0.25,
                                              "normal"),
         ((16, 8, 8, 256), 0.25, "normal"), ((16, 4, 4, 512), 0.25,
                                             "normal"),
         ((64, 200), 0.1, "normal"), ((64, 200), 0.3, "normal"),
         ((64, 200), 1.0, "normal"), ((16, 8, 8, 256), 0.25, "ties"),
         ((4, 128), 0.25, "zeros"), ((7, 48), 0.25, "normal"),
         # the scenario path's cut (mlp9 at batch 8 and 16); the selection's
         # edges: k = 1 (k_frac 0.001), +-0.0 beside subnormals and ties of
         # them, all-equal groups of 128
         ((8, 64), 0.25, "normal"), ((16, 64), 0.25, "normal"),
         ((16, 128), 0.001, "normal"), ((16, 64), 0.001, "ties"),
         ((16, 128), 0.25, "subnormal"), ((16, 200), 0.1, "subnormal"),
         ((32, 128), 0.25, "equal"), ((32, 128), 1.0, "equal"),
         # NaN, -NaN, +-inf, whole NaN groups beside finite ones; k = 1
         # with three NaNs in a group; the padded tail group
         ((16, 8, 8, 256), 0.25, "nonfinite"), ((14, 64), 0.001, "nonfinite"),
         ((21, 200), 0.1, "nonfinite"), ((8, 64), 0.25, "nonfinite")]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to build and run the "
                    "port's kernels")
    from repro_torch.device import set_float32_precision
    set_float32_precision()      # the plain versions' matmuls without TF32
    return torch.device("cuda")


def _input(shape, fill, dev, seed=0):
    rng = np.random.default_rng(seed)
    if fill == "normal":
        a = rng.normal(size=shape) * 3.0
    elif fill == "ties":
        a = rng.integers(-3, 4, size=shape)
    elif fill == "equal":
        a = np.where(rng.random(shape) < 0.5, -1.5, 1.5)
    elif fill == "nonfinite":
        return torch.from_numpy(nonfinite_input(shape, seed)).to(dev)
    elif fill == "subnormal":
        # +-0.0 and +-subnormals (repeated: ties), a few normal values
        sub = (rng.integers(1, 1 << 23, size=shape).astype(np.uint32)
               .view(np.float32) * np.where(rng.random(shape) < 0.5,
                                            np.float32(-1), np.float32(1)))
        a = np.where(rng.random(shape) < 0.5, -0.0, 0.0).astype(np.float32)
        a = np.where(rng.random(shape) < 0.4, sub, a)
        a = np.where(rng.random(shape) < 0.2, sub[..., ::-1], a)
        a = np.where(rng.random(shape) < 0.05, rng.normal(size=shape), a)
    else:
        a = np.zeros(shape)
    return torch.from_numpy(a.astype(np.float32)).to(dev)


def _same(a, b):
    return same_floats(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("shape,k_frac,fill", CASES)
def test_kernels_equal_plain_versions(dev, shape, k_frac, fill):
    x = _input(shape, fill, dev)
    d = shape[-1]
    g, _, k, _ = C.wire_layout(d, k_frac)
    before = launch_counts()
    q, s = quant.quantize_int8(x)
    qr, sr = C.quantize_int8(x)
    assert torch.equal(q, qr) and _same(s, sr)
    assert _same(quant.dequantize_int8(q, s), C.dequantize_int8(q, s))
    buf = wire.sparsify_quant_pack(x, k_frac)
    assert same_wire(buf.cpu().numpy(),
                     C.sparsify_quant_pack_ref(x, k_frac).cpu().numpy(), g, k)
    assert _same(wire.unpack_dequant(buf, d, k_frac),
                 C.wire_dequant_ref(buf, d, k_frac))
    after = launch_counts()
    codec = ("quantize_int8", "dequantize_int8", "sparsify_quant_pack",
             "unpack_dequant")
    assert all(after[k] == before[k] + (k in codec) for k in after)


# (rows, d, group): custom groups (g = 48, 32), padded tail groups (d =
# 200, 208), d and g not multiples of 16 (40), d and g not multiples of 4
# (a custom g = 45, d = 50): the kernel's vector and one-value paths
DEQUANT_SHAPES = [(16, 96, 48), (7, 48, 128), (33, 256, 32), (64, 200, 128),
                  (9, 208, 128), (5, 40, 128), (6, 90, 45), (3, 50, 128)]


@pytest.mark.parametrize("rows,d,group", DEQUANT_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_dequantize_kernel_widths_and_alignment(dev, rows, d, group,
                                                offset):
    """dequantize_int8 at custom groups, padded tails and odd widths, from
    an aligned q and from a contiguous one a byte past alignment; NaN and
    inf scales beside finite ones."""
    rng = np.random.default_rng(rows * d + offset)
    ng = -(-d // min(group, d))
    flat = torch.from_numpy(rng.integers(-127, 128, size=rows * d + offset)
                            .astype(np.int8)).to(dev)
    q = flat[offset:].view(rows, d)
    s = (np.abs(rng.normal(size=(rows, ng))) / 127).astype(np.float32)
    s[0, 0], s[-1, -1] = np.nan, np.inf
    s = torch.from_numpy(s).to(dev)
    n = LAUNCHES["dequantize_int8"]
    got = quant.dequantize_int8(q, s, group=group)
    assert LAUNCHES["dequantize_int8"] == n + 1
    assert _same(got, C.dequantize_int8(q, s, group=group))


# (rows, d, group): g 32 / 48 / 64 / 128 (g = min(group, d)) at d 48 /
# 64 / 200 / 256 / 960 (padded tail groups at 200 and 960), then odd
# widths and groups (the scalar path: d = 50, g = 45, g = 13)
QUANT_SHAPES = ([(7, d, g) for g in (32, 48, 64, 128)
                 for d in (48, 64, 200, 256, 960)]
                + [(16384, 64, 128), (9, 50, 128), (6, 90, 45),
                   (4, 13, 128)])


@pytest.mark.parametrize("rows,d,group", QUANT_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("fill", ["normal", "nonfinite"])
def test_quantize_kernel_widths_and_alignment(dev, rows, d, group, offset,
                                              fill):
    """quantize_int8 against its plain version at the g / d grid of the
    index map, from an aligned x and from a contiguous view one value past
    alignment (the scalar path), on normal and NaN / +-inf input; one
    launch a call."""
    flat = _input((rows * d + offset,), "normal", dev, seed=rows * d)
    if fill == "nonfinite":
        flat[offset:] = torch.from_numpy(
            nonfinite_input((rows, d), rows).ravel()).to(dev)
    x = flat[offset:].view(rows, d)
    n = LAUNCHES["quantize_int8"]
    q, s = quant.quantize_int8(x, group)
    assert LAUNCHES["quantize_int8"] == n + 1
    qr, sr = C.quantize_int8(x, group)
    assert torch.equal(q, qr) and _same(s, sr)


HALF_CASES = [((16, 8, 8, 256), 0.25, "normal"), ((8, 64), 0.25, "normal"),
              ((64, 200), 0.1, "normal"), ((7, 48), 0.25, "normal"),
              ((16, 64), 0.001, "ties"), ((16, 8, 8, 256), 0.25, "nonfinite"),
              ((21, 200), 0.1, "nonfinite")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,k_frac,fill", HALF_CASES)
def test_codec_kernels_in_2byte_dtypes(dev, shape, k_frac, fill, dtype):
    """All five codec functions with a bf16 / f16 input or output, against
    their plain versions (words, int8 and scales those of x.float(); the
    decoders' output rounded once to the dtype; kernel 5's f32 output
    within its tolerance, NaN rows where the plain version's are); each
    call one launch of its kernel."""
    x = _input(shape, fill, dev).to(dtype)
    d = shape[-1]
    g, _, k, _ = C.wire_layout(d, k_frac)
    before = launch_counts()
    q, s = quant.quantize_int8(x)
    qr, sr = C.quantize_int8(x)
    assert torch.equal(q, qr) and _same(s, sr)
    qf, sf = quant.quantize_int8(x.float())
    assert torch.equal(q, qf) and _same(s, sf)
    dq = quant.dequantize_int8(q, s, dtype=dtype)
    dqr = C.dequantize_int8(q, s, dtype)
    assert dq.dtype == dtype and _same(dq.float(), dqr.float())
    buf = wire.sparsify_quant_pack(x, k_frac)
    want = C.sparsify_quant_pack_ref(x, k_frac).cpu().numpy()
    assert same_wire(buf.cpu().numpy(), want, g, k)
    up = wire.unpack_dequant(buf, d, k_frac, dtype=dtype)
    upr = C.wire_dequant_ref(buf, d, k_frac, dtype=dtype)
    assert up.dtype == dtype and _same(up.float(), upr.float())
    rows = x.numel() // d
    w = _randn((d, 32), dev, 7, (2.0 / d) ** 0.5).to(dtype)
    mm = wire.unpack_dequant_matmul(buf.view(rows, -1), w, k_frac)
    mmr = C.wire_dequant_matmul_ref(buf.view(rows, -1), w, k_frac)
    nan = torch.isnan(mmr)
    assert mm.dtype == torch.float32 and torch.equal(torch.isnan(mm), nan)
    torch.testing.assert_close(mm[~nan], mmr[~nan], rtol=MM_TOL, atol=MM_TOL)
    after = launch_counts()
    codec = ("quantize_int8", "dequantize_int8", "sparsify_quant_pack",
             "unpack_dequant", "unpack_dequant_matmul")
    assert all(after[n] == before[n] + (n in codec) + (n == "quantize_int8")
               for n in after)


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
                           wire="int8", cohort_parallel="unroll")
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


def _uneven_mlp(sizes=(16, 24, 32, 40)):
    """mlp9 shards of unequal size: replicas run different numbers of
    local steps, so buckets hold slots that sit steps out."""
    import dataclasses

    from repro_torch.models.mlp_unit import make_mlp_fleet_data
    clients, test = make_mlp_fleet_data(4, max(sizes), seed=2, n_test=64)
    return ([dataclasses.replace(c, images=c.images[:n], labels=c.labels[:n])
             for c, n in zip(clients, sizes)], test)


def _flat(sim):
    from repro_torch.tree import tree_leaves
    return np.concatenate([t.detach().cpu().numpy().ravel()
                           for t in tree_leaves([sim.units, sim.head])])


@pytest.mark.parametrize("wire", ["int8", "topk_int8"])
def test_vmap_on_cuda_matches_loop_on_cpu(dev, wire):
    """asfl under auto (= vmap on the card) against the loop on the CPU
    from the same weights: equal cuts, wire bytes and steps, loss and
    parameters within 1e-4; codec launches as the vmap schedule implies
    (the uplink once per (bucket, local step) on the stacked smashed
    tensor, the downlink once per client batch step; on topk_int8 mlp9's
    RSU reads the packed buffer, so the uplink unpacks nothing and the
    fused matmul's backward unpacks once per client batch step)."""
    from repro_torch.core import fedsim
    from repro_torch.models.mlp_unit import MLPUnitModel
    clients, test = _uneven_mlp()
    kw = dict(n_clients=4, batch_size=8, local_epochs=1, lr=1e-2, rounds=2,
              optimizer="sgd", wire=wire)
    cpu = fedsim.FederationSim(MLPUnitModel(), clients, test,
                               fedsim.SimConfig(cohort_parallel="unroll",
                                                **kw), device="cpu")
    gpu = fedsim.FederationSim(MLPUnitModel(), clients, test,
                               fedsim.SimConfig(**kw), device=dev)
    assert gpu.engine.mode == "vmap"
    hc = cpu.run()
    before = launch_counts()
    hg = gpu.run()
    got = {k: v - before[k] for k, v in launch_counts().items()}
    steps = gpu.engine.batch_steps
    local = [len(c) // 8 for c in clients]
    buckets = 0
    for m in hg:
        most = {}
        for cut, n in zip(m.cuts, local):
            most[cut] = max(most.get(cut, 0), n)
        buckets += sum(most.values())
    want = dict.fromkeys(got, 0)
    if wire == "int8":
        want.update(quantize_int8=buckets + steps,
                    dequantize_int8=buckets + steps)
    else:
        want.update(sparsify_quant_pack=buckets + steps,
                    unpack_dequant=2 * steps, unpack_dequant_matmul=steps)
    assert steps == cpu.engine.batch_steps == 2 * sum(local)
    assert got == want
    assert gpu.engine.wire_bytes == cpu.engine.wire_bytes
    for a, b in zip(hc, hg):
        assert a.cuts == b.cuts and abs(a.loss - b.loss) <= 1e-4
    assert np.abs(_flat(cpu) - _flat(gpu)).max() <= 1e-4


@pytest.mark.parametrize("scheme", ["asfl", "fl"])
def test_resnet_vmap_matches_loop_on_cuda(dev, scheme):
    """resnet18 (batch 4, one local step, wire none) under vmap and under
    the loop, both on the card: parameters and loss within 1e-4."""
    from repro_torch.core import fedsim
    from repro_torch.data.pipeline import make_federated_data
    clients, test = make_federated_data(0, n_train=64, n_test=8)
    sims = []
    for mode in ("vmap", "unroll"):
        cfg = fedsim.SimConfig(scheme=scheme, batch_size=4, local_steps=1,
                               lr=1e-2, rounds=1, optimizer="sgd",
                               eval_every=0, cohort_parallel=mode)
        sim = fedsim.FederationSim(fedsim.ResNetModel(), clients, test, cfg,
                                   device=dev)
        sims.append((sim, sim.run()[0]))
    (sv, mv), (sl, ml) = sims
    assert mv.cuts == ml.cuts and abs(mv.loss - ml.loss) <= 1e-4
    assert sv.engine.batch_steps == sl.engine.batch_steps == 4
    assert np.abs(_flat(sv) - _flat(sl)).max() <= 1e-4


# ------------------------------------------------- unpack_dequant_matmul
# each slab's float32 products summed in another order than the plain
# version's matmul (TF32 off for both); the slabs themselves are exact
MM_TOL = 1e-5
# (rows, d, n): mlp9's cut at batch 8 and 16, tests/test_kernels.py's
# shapes, a ragged tile / last group / column edge, a wide case, one row
# and a partial 8-row tile; then each tile height the host picks (8 rows
# at 300 rows, 16 at the wide case, at 4096 x 128 over two column blocks
# and at 4096 x 70 with 4-byte copies and a ragged last group)
MM_CASES = [(8, 64, 64), (16, 64, 64), (16, 256, 64), (16, 200, 32),
            (16, 48, 16), (37, 130, 70), (4096, 512, 64), (1, 64, 64),
            (9, 64, 64), (300, 256, 64), (4096, 256, 128), (4096, 130, 70)]


def _mm_inputs(dev, rows, d, n, seed=6):
    """Smashed values and He-initialised weights, as mlp9 has them."""
    x = _randn((rows, d), dev, seed)
    w = _randn((d, n), dev, seed + 1, (2.0 / d) ** 0.5)
    return wire.sparsify_quant_pack(x), w


@pytest.mark.parametrize("rows,d,n", MM_CASES)
def test_unpack_dequant_matmul_matches_plain(dev, rows, d, n):
    buf, w = _mm_inputs(dev, rows, d, n)
    cnt = LAUNCHES["unpack_dequant_matmul"]
    got = wire.unpack_dequant_matmul(buf, w)
    assert LAUNCHES["unpack_dequant_matmul"] == cnt + 1
    torch.testing.assert_close(got, C.wire_dequant_matmul_ref(buf, w),
                               rtol=MM_TOL, atol=MM_TOL)


@pytest.mark.parametrize("rows,d,n", [(16, 64, 64), (21, 200, 32),
                                      (37, 130, 70)])
def test_unpack_dequant_matmul_nonfinite(dev, rows, d, n):
    """NaN and +-inf smashed values: a group that decodes to NaN makes its
    output row NaN, as in the plain version; the other rows agree within
    MM_TOL."""
    x = torch.from_numpy(nonfinite_input((rows, d), rows)).to(dev)
    w = _randn((d, n), dev, rows + 1, (2.0 / d) ** 0.5)
    buf = wire.sparsify_quant_pack(x)
    got = wire.unpack_dequant_matmul(buf, w)
    want = C.wire_dequant_matmul_ref(buf, w)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and nan.any() and not nan.all()
    torch.testing.assert_close(got[~nan], want[~nan], rtol=MM_TOL,
                               atol=MM_TOL)


def test_unpack_dequant_matmul_does_not_materialize(dev):
    """The call allocates its output and nothing of the dense smashed
    tensor's size; the gradient keeps only the int32 buffer and w."""
    rows, d, n = 4096, 512, 64
    buf, w = _mm_inputs(dev, rows, d, n)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = wire.unpack_dequant_matmul(buf, w)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    assert grew < 4 * out.numel() + 4 * rows * d
    entry = wire.dequant_matmul(buf, w.requires_grad_(True))
    assert not any(t.dtype == torch.float32 and tuple(t.shape) == (rows, d)
                   for t in entry.grad_fn.saved_tensors)


def test_dequant_matmul_gradient_on_cuda(dev):
    """dW through the backward's unpack_dequant kernel equals autograd
    through the dense composition on the card."""
    buf, w0 = _mm_inputs(dev, 16, 64, 64)
    w = w0.clone().requires_grad_(True)
    g = _randn((16, 64), dev, 9)
    (gw,) = torch.autograd.grad((wire.dequant_matmul(buf, w) * g).sum(),
                                [w])
    dense = C.wire_dequant_ref(buf, 64)
    torch.testing.assert_close(gw, dense.t() @ g, rtol=MM_TOL, atol=MM_TOL)


def test_mlp9_scenario_round_on_cuda_matches_cpu(dev):
    """One topk_int8 round of the multi-RSU engine on the card and on the
    CPU from the same weights: the same cuts and loads, the kernels
    launched as the design implies (per client batch step: pack up and
    down; unpack for the vehicle's residual, the RSU's dW and the
    downlink; the fused matmul once), parameters within 1e-4."""
    from repro_torch import api
    spec = api.ExperimentSpec(
        model="mlp9",
        train=api.TrainConfig(rounds=1, local_steps=2, batch_size=8,
                              lr=1e-3, optimizer="sgd", eval_every=0,
                              wire="topk_int8"),
        fleet=api.FleetConfig(n_vehicles=16, scenario="highway_corridor",
                              round_interval_s=10.0,
                              per_vehicle_samples=64))
    cpu = api.run(spec, device="cpu")
    gpu = api.run(spec, device=dev)
    steps = gpu.diagnostics["client_batch_steps"]
    launches = gpu.diagnostics["kernel_launches"]
    assert steps > 0
    assert launches["unpack_dequant_matmul"] == steps
    assert launches["sparsify_quant_pack"] == 2 * steps
    assert launches["unpack_dequant"] == 3 * steps
    (mc,), (mg,) = cpu.history, gpu.history
    assert (mc.cuts, mc.rsu_loads) == (mg.cuts, mg.rsu_loads)
    assert abs(mc.loss - mg.loss) <= 1e-4
    ca = np.concatenate([p.ravel() for u in cpu.final_params[0]
                         for p in u.values()])
    ga = np.concatenate([p.ravel() for u in gpu.final_params[0]
                         for p in u.values()])
    assert np.abs(ca - ga).max() <= 1e-4


def _parallel_engine(device, layout="ragged"):
    """A reduced parallel window: 16 vehicles on the highway, 2 rounds as
    one window (superstep 2), topk_int8 with error feedback."""
    from repro_torch import api
    spec = api.ExperimentSpec(
        model="mlp9",
        train=api.TrainConfig(rounds=2, local_steps=2, batch_size=8,
                              lr=1e-3, optimizer="sgd", eval_every=0,
                              wire="topk_int8", server_schedule="parallel"),
        fleet=api.FleetConfig(n_vehicles=16, scenario="highway_corridor",
                              round_interval_s=10.0,
                              per_vehicle_samples=64),
        runtime=api.RuntimeConfig(superstep=2, superstep_layout=layout))
    return api.build_engine(spec, device=device)


def _engine_params(eng):
    return np.concatenate([t.detach().cpu().numpy().ravel()
                           for u in eng.units for t in u.values()]
                          + [t.detach().cpu().numpy().ravel()
                             for t in eng.head.values()])


def test_parallel_window_on_cuda_matches_cpu(dev):
    """The parallel schedule's window on the card and on the CPU from the
    same weights: the same cuts and loads, the codec kernels launched as
    the schedule implies (per (cut bucket, local step) two packs and two
    unpacks, per (cut bucket, RSU, local step) one fused matmul),
    parameters within 1e-4."""
    cpu = _parallel_engine("cpu")
    hc = cpu.run()
    gpu = _parallel_engine(dev)
    before = launch_counts()
    hg = gpu.run()
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    b, rb = gpu.bucket_steps, gpu.rsu_bucket_steps
    assert rb >= b > 0
    assert launches["sparsify_quant_pack"] == 2 * b
    assert launches["unpack_dequant"] == 2 * b
    assert launches["unpack_dequant_matmul"] == rb
    assert launches["quantize_int8"] == launches["dequantize_int8"] == 0
    assert gpu.batch_steps == 2 * sum(m.n_scheduled for m in hg)
    for mc, mg in zip(hc, hg):
        assert (mc.cuts, mc.rsu_loads) == (mg.cuts, mg.rsu_loads)
        assert abs(mc.loss - mg.loss) <= 1e-4
    assert np.abs(_engine_params(cpu) - _engine_params(gpu)).max() <= 1e-4


def test_parallel_window_is_deterministic_on_cuda(dev):
    """No float atomics on the parallel path: two runs of the same window
    on the card, and the dense layout beside the ragged one, give the
    same losses, parameters and residuals bit for bit."""
    runs = []
    for layout in ("ragged", "ragged", "dense"):
        eng = _parallel_engine(dev, layout)
        hist = eng.run()
        runs.append(([m.loss for m in hist], _engine_params(eng),
                     [r.cpu().numpy() for r in eng.wire_res
                      if r is not None]))
    for other in runs[1:]:
        assert other[0] == runs[0][0]
        np.testing.assert_array_equal(other[1], runs[0][1])
        for a, b in zip(other[2], runs[0][2]):
            np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """The repo's ``chip_smoke.py`` as a module, for its phase-10 inputs,
    its launch formula and its rmsnorm tolerances."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------- LM kernels
# rmsnorm: the sum of squares is reduced in another order and rsqrtf is
# within 2 ulp, so a few float32 ulps of outputs of magnitude <= ~10.
RMS_TOL = 2e-5
# flash: float32 sums over up to 1024 keys in another order than the plain
# softmax + matmul, plus the online rescaling by exp(m_old - m_new); the
# reference's own 2e-5 covers at most 256 keys.
FLASH_TOL = 1e-4
# ssd: exp of differences of prefix sums of dt*A (|cum| up to a few hundred
# at the path's shapes, where one ulp is ~3e-5), summed in another order:
# the reference's tolerance of its SSD kernel (test_kernels.py).
SSD_TOL = 2e-4


def _randn(shape, dev, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float32)).to(dev)


# the serving prefills' widths (smollm, mamba2 and its gated norm,
# gemma3 / recurrentgemma, internvl2, musicgen), gemma3's qk-norm over
# head_dim 256 (q's rows at prefill, k's at a decode step), decode, edges
# (d not a multiple of the vector; d past the registers' 8192 float32)
RMS_SHAPES = [(8, 1024, 960), (8, 1024, 1536), (8, 1024, 3072),
              (8, 1024, 2560), (8, 1024, 896), (8, 1024, 2048),
              (65536, 256), (32, 256), (8, 1, 960), (2, 12, 256),
              (5, 7, 1001), (3, 6), (3, 9000)]
# x's dtype, the scale's (chip_smoke.py's names): float32, and bfloat16 /
# float16 with a scale of x's dtype or a float32 one
RMS_DTYPES = {"f32": (torch.float32, torch.float32),
              "bf16": (torch.bfloat16, torch.bfloat16),
              "bf16_f32scale": (torch.bfloat16, torch.float32),
              "f16": (torch.float16, torch.float16),
              "f16_f32scale": (torch.float16, torch.float32)}


def _rms_close(got, want, scale_tol=0.0):
    """``chip_smoke._rms_ok``: float32 within RMS_TOL (absolute +
    relative), 16-bit within one ulp of the working type (the float32
    results differ by a few float32 ulps and are rounded once), each plus
    ``scale_tol`` (a gradient's float32 reassociation where it subtracts
    terms of similar size)."""
    err = float((got.float() - want.float()).abs().max())
    assert _chip_smoke()._rms_ok(got, want, scale_tol), err


def _rms_inputs(shape, dtype, dev, seed=0, unaligned=False):
    x_dt, s_dt = RMS_DTYPES[dtype]
    x = _randn(shape, dev, seed, 2.0).to(x_dt)
    if unaligned:           # one element past a 16-byte boundary
        buf = torch.empty(x.numel() + 1, dtype=x_dt, device=dev)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(shape)
    return x, (_randn(shape[-1:], dev, seed + 1, 0.1) + 1.0).to(s_dt)


@pytest.mark.parametrize("dtype", list(RMS_DTYPES))
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_kernel_matches_plain(dev, shape, dtype):
    x, g = _rms_inputs(shape, dtype, dev)
    n = LAUNCHES["rmsnorm"]
    got = RN.rmsnorm(x, g)
    assert LAUNCHES["rmsnorm"] == n + 1
    _rms_close(got, RN.rmsnorm_plain(x, g))


@pytest.mark.parametrize("dtype", list(RMS_DTYPES))
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_backward_kernel_matches_plain(dev, shape, dtype):
    """dx and dscale against the closed-form plain version and the plain
    vjp (for 16-bit input: within one ulp plus RMS_TOL of the largest
    gradient); one launch a call; two calls bit for bit (no atomics)."""
    x, g = _rms_inputs(shape, dtype, dev)
    dy = _randn(shape, dev, 7).to(x.dtype)
    n = LAUNCHES["rmsnorm_backward"]
    got = RN.rmsnorm_backward(x, g, dy)
    assert LAUNCHES["rmsnorm_backward"] == n + 1
    assert got[0].dtype == x.dtype and got[1].dtype == g.dtype
    again = RN.rmsnorm_backward(x, g, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _, vjp = torch.func.vjp(RN.rmsnorm_plain, x, g)
    for want in (RN.rmsnorm_backward_plain(x, g, dy), vjp(dy)):
        for a, b in zip(got, want):
            _rms_close(a, b, _chip_smoke()._grad_tol(b))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 96, 960), (64, 256), (3, 9000),
                                   (5, 7, 1001)])
def test_rmsnorm_kernels_take_unaligned_rows(dev, shape, dtype):
    """x one element past a 16-byte boundary: the scalar routes."""
    x, g = _rms_inputs(shape, dtype, dev, unaligned=True)
    dy = _randn(shape, dev, 7).to(x.dtype)
    _rms_close(RN.rmsnorm(x, g), RN.rmsnorm_plain(x, g))
    for a, b in zip(RN.rmsnorm_backward(x, g, dy),
                    RN.rmsnorm_backward_plain(x, g, dy)):
        _rms_close(a, b, _chip_smoke()._grad_tol(b))


def test_rmsnorm_kernels_refuse_other_dtypes(dev):
    x = torch.ones(4, 64, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="rmsnorm kernels"):
        RN.rmsnorm(x, torch.ones(64, dtype=torch.float64, device=dev))
    x = torch.ones(4, 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError, match="rmsnorm kernels"):
        RN.rmsnorm_backward(x, torch.ones(64, dtype=torch.float16,
                                          device=dev), x)


@pytest.mark.parametrize("batched_scale", [False, True])
def test_rmsnorm_backward_vmap_of_grad_on_cuda(dev, batched_scale):
    """The fl round's ``vmap`` of ``grad`` on the card: one backward launch
    for both replicas (the forward: one, or one a replica with a scale
    each), each replica's dscale its own, within the gradient tolerance of
    the per-replica grads."""
    x = _randn((2, 4, 64, 960), dev, 0, 2.0)
    g = _randn((960,), dev, 1, 0.1) + 1.0
    s = torch.stack([g, g * 1.01]) if batched_scale else g
    dims = (0, 0 if batched_scale else None)
    grad = torch.func.grad(lambda a, b: RN.rmsnorm(a, b).square().sum(),
                           argnums=(0, 1))
    n = launch_counts()
    got = torch.func.vmap(grad, in_dims=dims)(x, s)
    grew = {k: v - n[k] for k, v in launch_counts().items()}
    assert grew["rmsnorm"] == (2 if batched_scale else 1)
    assert grew["rmsnorm_backward"] == 1
    for r in range(2):
        want = grad(x[r], s[r] if batched_scale else s)
        for a, b in zip((t[r] for t in got), want):
            _rms_close(a, b, _chip_smoke()._grad_tol(b))


# (b, sq, sk, h, kv, d, causal, window, qk_amp): the path's smollm
# prefill, then GQA / ragged / head dims / window / non-causal / fully
# masked rows; one query row; sk not a multiple of the key tile (64 at
# d 64); d 256 with a window; the path's 15 heads over 5 kv heads at a
# small s; q and k scaled by 4, so the scores (|s| up to ~80) would show a
# single-TF32 route's ~1e-3 relative error; then the served families'
# prefills: gemma3's global and local layers (d 256, 8 heads over 4; the
# window masks keys at s 1088), recurrentgemma's local MQA (10 over 1,
# window 2048), internvl2 (14 over 2), musicgen (MHA 32 / 32)
FLASH_CASES = [(8, 1024, 1024, 15, 5, 64, True, 0, 1.0),
               (1, 100, 100, 4, 2, 128, True, 0, 1.0),
               (1, 70, 70, 4, 1, 256, True, 0, 1.0),
               (2, 37, 37, 4, 2, 32, True, 0, 1.0),
               (2, 200, 200, 4, 2, 64, True, 48, 1.0),
               (2, 48, 80, 2, 2, 64, False, 0, 1.0),
               (1, 64, 16, 2, 1, 64, False, 8, 1.0),
               (2, 1, 77, 4, 2, 64, False, 0, 1.0),
               (2, 150, 150, 6, 3, 64, True, 0, 1.0),
               (1, 90, 90, 2, 1, 256, True, 40, 1.0),
               (2, 96, 96, 15, 5, 64, True, 0, 1.0),
               (1, 256, 256, 4, 2, 64, True, 0, 4.0),
               (8, 1024, 1024, 8, 4, 256, True, 0, 1.0),
               (8, 1088, 1088, 8, 4, 256, True, 1024, 1.0),
               (8, 1024, 1024, 10, 1, 256, True, 2048, 1.0),
               (8, 1024, 1024, 14, 2, 64, True, 0, 1.0),
               (8, 1024, 1024, 32, 32, 64, True, 0, 1.0)]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,qk_amp",
                         FLASH_CASES)
def test_flash_kernel_matches_plain(dev, b, sq, sk, h, kv, d, causal,
                                    window, qk_amp):
    q = _randn((b, sq, h, d), dev, 2, qk_amp)
    k = _randn((b, sk, kv, d), dev, 3, qk_amp)
    v = _randn((b, sk, kv, d), dev, 4)
    n = LAUNCHES["flash_attention"]
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    assert LAUNCHES["flash_attention"] == n + 1
    want = FA.attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)


def test_flash_kernel_reads_strided_qkv(dev):
    """q / k / v as views of one fused projection (no copies)."""
    qkv = _randn((2, 50, 8, 64), dev, 5)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = FA.flash_attention(q, k, v)
    want = FA.attention_plain(q, k, v)
    torch.testing.assert_close(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)


# the 16-bit kernel: float32's cases, and the bfloat16 archs' prefills
# (qwen3-14b 40 heads over 8, command-r-35b 64 over 8, d 128)
FLASH16_CASES = FLASH_CASES + [(8, 1024, 1024, 40, 8, 128, True, 0, 1.0),
                               (8, 1024, 1024, 64, 8, 128, True, 0, 1.0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,qk_amp",
                         FLASH16_CASES)
def test_flash_kernel_16bit_matches_plain(dev, b, sq, sk, h, kv, d, causal,
                                          window, qk_amp, dtype):
    """bfloat16 / float16 q, k and v: the output in their dtype within one
    ulp of it plus flash's float32 tolerance of the plain version (both
    compute in float32 and round once), a second call bit for bit."""
    cs = _chip_smoke()
    q = _randn((b, sq, h, d), dev, 2, qk_amp).to(dtype)
    k = _randn((b, sk, kv, d), dev, 3, qk_amp).to(dtype)
    v = _randn((b, sk, kv, d), dev, 4).to(dtype)
    n = LAUNCHES["flash_attention"]
    routes = dict(FA.ROUTE_LAUNCHES)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    again = FA.flash_attention(q, k, v, causal=causal, window=window)
    assert LAUNCHES["flash_attention"] == n + 2
    route = "hopper" if d in (64, 128) else "mma"
    assert FA.ROUTE_LAUNCHES[route] == routes[route] + 2
    want = FA.attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and torch.equal(got, again)
    err = (got.float() - want.float()).abs()
    assert bool((err <= cs._ulp(want) + FLASH_TOL
                 + FLASH_TOL * want.float().abs()).all()), float(err.max())


# the Hopper route's shapes: FLASH16_CASES' d-64 and d-128 rows (smollm's
# prefill, windows, non-causal with sq != sk, rows with no visible key, one
# query, scores scaled by 4) and the d-128 edges, then ragged s at both
HOPPER_CASES = [c for c in FLASH16_CASES if c[5] in (64, 128)] + [
    (2, 200, 200, 4, 2, 128, True, 48, 1.0),
    (2, 48, 80, 2, 2, 128, False, 0, 1.0),
    (1, 64, 16, 2, 1, 128, False, 8, 1.0),
    (2, 1, 77, 4, 2, 128, False, 0, 1.0),
    (8, 1087, 1087, 40, 8, 128, True, 0, 1.0),
    (2, 1087, 1087, 15, 5, 64, True, 0, 1.0),
    (2, 130, 260, 4, 2, 64, True, 100, 1.0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,qk_amp",
                         HOPPER_CASES)
def test_flash_16bit_hopper_route_against_mma_route(dev, b, sq, sk, h, kv, d,
                                                    causal, window, qk_amp,
                                                    dtype):
    """At the Hopper route's shapes: two calls take it, bit for bit, and
    the mma route forced at the same shape agrees with it within one ulp
    plus flash's float32 tolerance (each is held to the plain version so
    by test_flash_kernel_16bit_matches_plain)."""
    cs = _chip_smoke()
    q = _randn((b, sq, h, d), dev, 2, qk_amp).to(dtype)
    k = _randn((b, sk, kv, d), dev, 3, qk_amp).to(dtype)
    v = _randn((b, sk, kv, d), dev, 4).to(dtype)
    scale = d ** -0.5
    assert FA.flash_route(q, k, v) == "hopper"
    routes = dict(FA.ROUTE_LAUNCHES)
    got = FA._forward(q, k, v, causal, window, scale)
    again = FA._forward(q, k, v, causal, window, scale)
    mma = FA._forward(q, k, v, causal, window, scale, route="mma")
    assert {r: n - routes[r] for r, n in FA.ROUTE_LAUNCHES.items()} == {
        "hopper": 2, "mma": 1}
    assert torch.equal(got, again) and got.dtype == dtype
    assert cs.flash16_within(got, mma)
    assert cs.flash16_within(got, FA.attention_plain(
        q, k, v, causal=causal, window=window))


def test_flash_hopper_route_refuses_what_it_does_not_take(dev):
    """Forced onto the Hopper route, d 256 and d 32 (16-bit d 64 takes
    it since the d-64 forward was added), float32 and misaligned views at
    d 128 and d 64 raise before a launch: nothing falls back to the mma
    route."""
    bf = torch.bfloat16
    q256 = _randn((1, 32, 2, 256), dev, 7).to(bf)
    q32 = _randn((1, 32, 2, 32), dev, 10).to(bf)
    f32 = _randn((1, 32, 2, 128), dev, 8)
    odd = _randn((1 * 32 * 2 * 128 + 1,), dev, 9).to(bf)[1:].view(
        1, 32, 2, 128)
    odd64 = _randn((1 * 32 * 2 * 64 + 1,), dev, 11).to(bf)[1:].view(
        1, 32, 2, 64)
    n, routes = LAUNCHES["flash_attention"], dict(FA.ROUTE_LAUNCHES)
    for t in (q256, q32, f32, odd, odd64):
        assert FA.flash_route(t, t, t) == "mma"
        with pytest.raises(RuntimeError, match="cudaError 1"):
            FA._forward(t, t, t, True, 0, t.shape[-1] ** -0.5,
                        route="hopper")
    assert LAUNCHES["flash_attention"] == n and FA.ROUTE_LAUNCHES == routes


def test_flash_16bit_strided_views_take_their_routes(dev):
    """q / k / v as views of one fused bfloat16 projection at d 128 (the
    Hopper route reads them through TMA) and the same views misaligned by
    one element (the mma route): each within one ulp plus flash's float32
    tolerance of the plain version."""
    cs = _chip_smoke()
    for d in (128, 64):
        qkv = _randn((2, 50, 8, d), dev, 5).to(torch.bfloat16)
        odd = _randn((2 * 50 * 8 * d + 1,), dev, 6).to(torch.bfloat16)
        odd = odd[1:].view(2, 50, 8, d)
        for t, route in ((qkv, "hopper"), (odd, "mma")):
            q, k, v = t[:, :, :4], t[:, :, 4:6], t[:, :, 6:]
            before = FA.ROUTE_LAUNCHES[route]
            got = FA.flash_attention(q, k, v)
            assert FA.ROUTE_LAUNCHES[route] == before + 1
            assert cs.flash16_within(got, FA.attention_plain(q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernel_16bit_keeps_p_low_half(dev, dtype):
    """chip_smoke's split case, whose output nearly cancels: the kernel
    within one ulp plus flash's float32 tolerance of the plain version,
    where p.v without p's low half falls outside it."""
    cs = _chip_smoke()
    q, k, v = cs.flash_split_case(dtype, device=dev)
    got = FA.flash_attention(q, k, v, causal=False)
    want = FA.attention_plain(q, k, v, causal=False)
    assert got.dtype == dtype and cs.flash16_within(got, want)
    assert not cs.flash16_within(cs.flash_hi_only(q, k, v), want)


def test_flash_kernel_16bit_reads_strided_qkv_and_refuses_mixed(dev):
    """q / k / v as views of one fused bfloat16 projection (no copies),
    and an unaligned one (plain copies in place of cp.async); q, k and v
    of mixed dtypes raise before a launch."""
    cs = _chip_smoke()
    qkv = _randn((2, 50, 8, 64), dev, 5).to(torch.bfloat16)
    odd = _randn((2 * 50 * 8 * 64 + 1,), dev, 6).to(torch.bfloat16)
    odd = odd[1:].view(2, 50, 8, 64)
    for t in (qkv, odd):
        q, k, v = t[:, :, :4], t[:, :, 4:6], t[:, :, 6:]
        got = FA.flash_attention(q, k, v)
        want = FA.attention_plain(q, k, v)
        err = (got.float() - want.float()).abs()
        assert bool((err <= cs._ulp(want) + FLASH_TOL
                     + FLASH_TOL * want.float().abs()).all())
    n = LAUNCHES["flash_attention"]
    with pytest.raises(TypeError, match="one dtype"):
        FA.flash_attention(q, k.float(), v)
    assert LAUNCHES["flash_attention"] == n


# flash's backward kernel (three launches a call, counted as one): every
# head dim, GQA groups, windows that mask keys, sq != sk with rows that see
# no key, and the bfloat16 archs' training shape (qwen3-14b) and gemma3's
# bf16 d 256 (local and global), then d 256's edges of the Hopper route
# (sq > sk, non-causal sq < sk, rows with no key, one query);
# (b, sq, sk, h, kv, d, causal, window)
FLASH_BWD_CASES = [(2, 37, 37, 4, 2, 32, True, 0),
                   (2, 100, 100, 4, 2, 128, True, 0),
                   (1, 70, 70, 4, 1, 256, True, 0),
                   (2, 200, 200, 4, 2, 64, True, 48),
                   (2, 48, 80, 2, 2, 64, False, 0),
                   (1, 64, 16, 2, 1, 64, False, 8),
                   (2, 80, 48, 4, 2, 128, True, 0),
                   (2, 1, 77, 4, 2, 64, False, 0),
                   (1, 90, 90, 2, 1, 256, True, 40),
                   (2, 150, 150, 6, 3, 32, False, 20),
                   (8, 1024, 1024, 40, 8, 128, True, 0),
                   (4, 1024, 1024, 8, 4, 256, True, 1024),
                   (4, 1024, 1024, 8, 4, 256, True, 0),
                   (2, 80, 48, 4, 2, 256, True, 0),
                   (2, 48, 80, 2, 2, 256, False, 0),
                   (1, 64, 16, 2, 1, 256, False, 8),
                   (2, 1, 77, 4, 2, 256, False, 0),
                   (1, 200, 200, 4, 2, 256, True, 48)]


def _flash_bwd_within(a, b, tol=FLASH_TOL):
    """A gradient within flash's float32 tolerance of the largest of ``b``
    and, in 16 bits, one ulp of the dtype more (both sides round float32
    math once)."""
    cs = _chip_smoke()
    bound = tol * max(float(b.float().abs().max()), 1.0)
    if a.dtype != torch.float32:
        bound = bound + cs._ulp(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(torch.isfinite(a).all())
            and bool(((a.float() - b.float()).abs() <= bound).all()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_plain(dev, b, sq, sk, h, kv, d,
                                             causal, window, dtype):
    """The forward's lse within 1e-4 of the plain one (+inf exactly where
    a row sees no key); the backward kernel against the closed form on the
    kernel's lse and, below the training shapes, against the plain vjp;
    two calls bit for bit, one launch each; rows with no key get dq 0."""
    q = _randn((b, sq, h, d), dev, 2).to(dtype)
    k = _randn((b, sk, kv, d), dev, 3).to(dtype)
    v = _randn((b, sk, kv, d), dev, 4).to(dtype)
    do = _randn((b, sq, h, d), dev, 5).to(dtype)
    scale = d ** -0.5
    _, lse = FA._attend(q, k, v, causal, window, scale)
    _, lse_p = FA._plain_forward(q, k, v, causal, window, scale)
    seen = torch.isfinite(lse_p)
    assert torch.equal(seen, torch.isfinite(lse))
    assert bool(((lse - lse_p).abs()[seen] <= 1e-4).all())
    n = LAUNCHES["flash_attention_backward"]
    got = FA.flash_attention_backward(q, k, v, lse, do, causal=causal,
                                      window=window)
    again = FA.flash_attention_backward(q, k, v, lse, do, causal=causal,
                                        window=window)
    assert LAUNCHES["flash_attention_backward"] == n + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = FA.attention_backward_plain(q, k, v, lse, do, causal=causal,
                                       window=window, scale=scale)
    assert all(_flash_bwd_within(a, w) for a, w in zip(got, want))
    if sq * sk * h * b <= 2 ** 24:
        _, vjp = torch.func.vjp(lambda x, y, z: FA.attention_plain(
            x, y, z, causal=causal, window=window), q, k, v)
        assert all(_flash_bwd_within(a, w) for a, w in zip(got, vjp(do)))
    empty = ~FA._mask(sq, sk, causal, window, dev).any(-1)
    assert bool((got[0][:, empty] == 0).all())


def test_flash_backward_kernel_reads_strided_inputs(dev):
    """q / k / v as views of one fused projection and a cotangent that is
    a view with a contiguous trailing dim, each dtype, one of them
    misaligned by one element (the kernel's plain-load staging): within
    tolerance of the closed form; a non-contiguous trailing dim is copied
    first; mixed dtypes raise before a launch."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for odd in (False, True):
            n_el = 2 * 50 * 8 * 64
            base = _randn((n_el + 1,), dev, 6).to(dtype)
            qkv = (base[1:] if odd else base[:-1]).view(2, 50, 8, 64)
            q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
            do = _randn((2, 50, 8, 64), dev, 7).to(dtype)[:, :, 2:6]
            _, lse = FA._attend(q, k, v, True, 0, 0.125)
            got = FA.flash_attention_backward(q, k, v, lse, do)
            want = FA.attention_backward_plain(q, k, v, lse, do,
                                               scale=0.125)
            assert all(_flash_bwd_within(a, w) for a, w in zip(got, want))
            t_do = do.transpose(2, 3).contiguous().transpose(2, 3)
            assert t_do.stride(-1) != 1
            got_t = FA.flash_attention_backward(q, k, v, lse, t_do)
            assert all(torch.equal(a, b) for a, b in zip(got, got_t))
    n = LAUNCHES["flash_attention_backward"]
    with pytest.raises(TypeError, match="cotangent"):
        FA.flash_attention_backward(q, k, v, lse, do.float())
    assert LAUNCHES["flash_attention_backward"] == n


def test_flash_backward_under_vmap_of_grad_is_one_launch(dev):
    """The fl round's ``vmap`` of ``grad`` through flash: one forward and
    one backward launch for both replicas, each replica's gradients those
    of its own grad (the same kernels on a smaller batch)."""
    args = [_randn((2, 2, 40, h, 64), dev, i).to(torch.bfloat16)
            for i, h in enumerate((6, 2, 2))]
    grad = torch.func.grad(lambda q, k, v: FA.flash_attention(
        q, k, v).float().square().sum(), argnums=(0, 1, 2))
    n, nf = LAUNCHES["flash_attention"], LAUNCHES["flash_attention_backward"]
    got = torch.func.vmap(grad)(*args)
    assert LAUNCHES["flash_attention"] == n + 1
    assert LAUNCHES["flash_attention_backward"] == nf + 1
    for r in range(2):
        want = grad(*[a[r] for a in args])
        assert all(_flash_bwd_within(a[r], w) for a, w in zip(got, want))


def _bwd_routes(before):
    """Backward launches by route since ``before``."""
    return {r: n - before[r] for r, n in FA.BACKWARD_ROUTE_LAUNCHES.items()}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window",
                         [c for c in FLASH_BWD_CASES if c[5] in (128, 256)])
def test_flash_backward_hopper_route_matches_closed_form_and_mma(
        dev, b, sq, sk, h, kv, d, causal, window, dtype):
    """16-bit d 128 and 256 take the Hopper backward
    (csrc/flash_hopper_bwd.cu):
    its gradients within tolerance of the closed form, two calls bit for
    bit, and the mma route forced at the same inputs within tolerance of
    the same closed form; launches counted by route exactly."""
    q = _randn((b, sq, h, d), dev, 12).to(dtype)
    k = _randn((b, sk, kv, d), dev, 13).to(dtype)
    v = _randn((b, sk, kv, d), dev, 14).to(dtype)
    do = _randn((b, sq, h, d), dev, 15).to(dtype)
    scale = d ** -0.5
    _, lse = FA._attend(q, k, v, causal, window, scale)
    assert FA.flash_backward_route(q, k, v, do, scale) == "hopper"
    n, before = (LAUNCHES["flash_attention_backward"],
                 dict(FA.BACKWARD_ROUTE_LAUNCHES))
    got = FA.flash_attention_backward(q, k, v, lse, do, causal=causal,
                                      window=window)
    again = FA.flash_attention_backward(q, k, v, lse, do, causal=causal,
                                        window=window)
    mma = FA._backward(q, k, v, lse, do, causal, window, scale,
                       route="mma")
    assert _bwd_routes(before) == {"hopper": 2, "mma": 1}
    assert LAUNCHES["flash_attention_backward"] == n + 3
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = FA.attention_backward_plain(q, k, v, lse, do, causal=causal,
                                       window=window, scale=scale)
    assert all(_flash_bwd_within(a, w) for a, w in zip(got, want))
    assert all(_flash_bwd_within(m, w) for m, w in zip(mma, want))
    empty = ~FA._mask(sq, sk, causal, window, dev).any(-1)
    assert bool((got[0][:, empty] == 0).all())


def test_flash_backward_refused_shapes_take_the_mma_route(dev):
    """What the Hopper backward does not take goes to the mma kernels,
    counted there (float32, 16-bit d 64, misaligned views of a fused
    projection at d 128 and 256, a cotangent with a head stride of 130),
    within tolerance of the closed form; forcing the Hopper route on such
    inputs raises before a launch, counting nothing."""
    f32 = [_randn((2, 50, s, 128), dev, 20 + i) for i, s in
           enumerate((4, 2, 2, 4))]
    d64 = [_randn((2, 50, s, 64), dev, 30 + i).to(torch.bfloat16)
           for i, s in enumerate((4, 2, 2, 4))]
    flat = _randn((2 * 50 * 8 * 128 + 1,), dev, 40).to(torch.bfloat16)
    qkv = flat[1:].view(2, 50, 8, 128)
    odd = [qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:],
           _randn((2, 50, 4, 128), dev, 41).to(torch.bfloat16)]
    wide = _randn((2, 50, 4, 130), dev, 42).to(torch.bfloat16)
    strided = [_randn((2, 50, s, 128), dev, 50 + i).to(torch.bfloat16)
               for i, s in enumerate((4, 2, 2))] + [wide[..., :128]]
    flat256 = _randn((2 * 50 * 8 * 256 + 1,), dev, 43).to(torch.bfloat16)
    qkv256 = flat256[1:].view(2, 50, 8, 256)
    odd256 = [qkv256[:, :, :4], qkv256[:, :, 4:6], qkv256[:, :, 6:],
              _randn((2, 50, 4, 256), dev, 44).to(torch.bfloat16)]
    for q, k, v, do in (f32, d64, odd, strided, odd256):
        scale = q.shape[-1] ** -0.5
        assert FA.flash_backward_route(q, k, v, do, scale) == "mma"
        _, lse = FA._attend(q, k, v, True, 0, scale)
        n, before = (LAUNCHES["flash_attention_backward"],
                     dict(FA.BACKWARD_ROUTE_LAUNCHES))
        got = FA.flash_attention_backward(q, k, v, lse, do)
        assert _bwd_routes(before) == {"hopper": 0, "mma": 1}
        assert LAUNCHES["flash_attention_backward"] == n + 1
        want = FA.attention_backward_plain(q, k, v, lse, do, scale=scale)
        assert all(_flash_bwd_within(a, w) for a, w in zip(got, want))
        with pytest.raises(RuntimeError, match="cudaError"):
            FA._backward(q, k, v, lse, do, True, 0, scale, route="hopper")
        assert _bwd_routes(before) == {"hopper": 0, "mma": 1}
        assert LAUNCHES["flash_attention_backward"] == n + 1


def test_flash_backward_under_vmap_of_grad_is_one_hopper_launch(dev):
    """``vmap`` of ``grad`` through flash at d 128 in bfloat16: one
    forward and one backward launch for both replicas, the backward on the
    Hopper route, each replica's gradients those of its own grad."""
    args = [_randn((2, 2, 40, h, 128), dev, 60 + i).to(torch.bfloat16)
            for i, h in enumerate((6, 2, 2))]
    grad = torch.func.grad(lambda q, k, v: FA.flash_attention(
        q, k, v).float().square().sum(), argnums=(0, 1, 2))
    n, nf = LAUNCHES["flash_attention"], LAUNCHES["flash_attention_backward"]
    before = dict(FA.BACKWARD_ROUTE_LAUNCHES)
    got = torch.func.vmap(grad)(*args)
    assert LAUNCHES["flash_attention"] == n + 1
    assert LAUNCHES["flash_attention_backward"] == nf + 1
    assert _bwd_routes(before) == {"hopper": 1, "mma": 0}
    for r in range(2):
        want = grad(*[a[r] for a in args])
        assert all(_flash_bwd_within(a[r], w) for a, w in zip(got, want))


def test_flash_backward_under_vmap_of_grad_is_one_hopper_launch_at_d256(dev):
    """``vmap`` of ``grad`` through flash at d 256 in bfloat16 (gemma3's
    head dim, 4 heads over 2, a window of 24): one forward launch on the
    mma route and one backward launch on the Hopper route for both
    replicas, each replica's gradients those of its own grad."""
    args = [_randn((2, 2, 40, h, 256), dev, 70 + i).to(torch.bfloat16)
            for i, h in enumerate((4, 2, 2))]
    grad = torch.func.grad(lambda q, k, v: FA.flash_attention(
        q, k, v, window=24).float().square().sum(), argnums=(0, 1, 2))
    n, nf = LAUNCHES["flash_attention"], LAUNCHES["flash_attention_backward"]
    before, fwd = dict(FA.BACKWARD_ROUTE_LAUNCHES), dict(FA.ROUTE_LAUNCHES)
    got = torch.func.vmap(grad)(*args)
    assert LAUNCHES["flash_attention"] == n + 1
    assert LAUNCHES["flash_attention_backward"] == nf + 1
    assert _bwd_routes(before) == {"hopper": 1, "mma": 0}
    assert FA.ROUTE_LAUNCHES["mma"] == fwd["mma"] + 1
    for r in range(2):
        want = grad(*[a[r] for a in args])
        assert all(_flash_bwd_within(a[r], w) for a, w in zip(got, want))


@pytest.mark.parametrize("arch", ["qwen3-14b", "command-r-35b",
                                  "dbrx-132b"])
def test_reduced_bf16_serving_on_cuda_matches_cpu(dev, arch):
    """The bfloat16 archs' -smoke configs (weights in bfloat16) served on
    the card and on the CPU from the same weights and inputs (chip_smoke's
    phase 10): logits within 8 ulps of bfloat16 at the largest, over 8
    rows, those the MoE routed apart (a near tie) left out, at most
    half."""
    row = _chip_smoke().reduced_arch_cpu_vs_card(arch)
    assert row["dtype"] == "bfloat16" and row["ok"], row


def _ssd_inputs(dev, b, s, h, p, g, n, seed=0):
    """Inputs distributed as mamba2's prefill gives them: dt = softplus of
    a unit normal plus the model's dt_bias, A = -linspace(1, 16)."""
    x = _randn((b, s, h, p), dev, seed, 0.5)
    bias = torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, h))).to(dev)
    dt = torch.nn.functional.softplus(_randn((b, s, h), dev, seed + 1)
                                      + bias)
    A = -torch.linspace(1.0, 16.0, h).to(dev)
    B = _randn((b, s, g, n), dev, seed + 2)
    C = _randn((b, s, g, n), dev, seed + 3)
    return x, dt, A, B, C


# (b, s, h, p, g, n, chunk): the path's mamba2 prefill, then ragged s,
# groups, chunk < 64, s < chunk, the reduced config; two groups of 8 heads
# at the path's n and p; s a multiple of neither the chunk nor 64 at chunk
# 128; chunk 64; 7 heads with p and n not multiples of 4 (4-byte copies)
SSD_CASES = [(8, 1024, 48, 64, 1, 128, 256), (2, 300, 8, 64, 2, 128, 256),
             (2, 100, 4, 32, 2, 16, 32), (1, 40, 4, 16, 1, 16, 64),
             (2, 37, 32, 16, 1, 16, 32), (1, 512, 16, 64, 2, 128, 256),
             (2, 333, 6, 64, 1, 128, 128), (1, 200, 8, 64, 1, 128, 64),
             (1, 150, 7, 18, 1, 10, 64)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain(dev, b, s, h, p, g, n, chunk):
    x, dt, A, B, C = _ssd_inputs(dev, b, s, h, p, g, n)
    cnt = LAUNCHES["ssd_chunk_scan"]
    y, st = SSD.ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)
    assert LAUNCHES["ssd_chunk_scan"] == cnt + 1
    y_ref, st_ref = SSD.ssd_chunked(x, dt, A, B, C, chunk)
    torch.testing.assert_close(y, y_ref, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(st, st_ref, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("dt16", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_kernel_16bit_matches_plain(dev, b, s, h, p, g, n, chunk, dtype,
                                        dt16):
    """x / B / C in bfloat16 or float16 (dt and A float32 or, with
    ``dt16``, x's dtype): y of x's dtype within one ulp of it plus SSD_TOL
    of the plain version on the same inputs, the state float32 within
    SSD_TOL (both compute in float32)."""
    x, dt, A, B, C = _ssd_inputs(dev, b, s, h, p, g, n)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    if dt16:
        dt, A = dt.to(dtype), A.to(dtype)
    cnt = LAUNCHES["ssd_chunk_scan"]
    y, st = SSD.ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)
    assert LAUNCHES["ssd_chunk_scan"] == cnt + 1
    y_ref, st_ref = SSD.ssd_chunked(x, dt, A, B, C, chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    assert _chip_smoke()._ssd16_close((y, st), (y_ref, st_ref))


def test_ssd_kernel_refuses_mixed_dtypes(dev):
    x, dt, A, B, C = _ssd_inputs(dev, 1, 64, 4, 16, 1, 16)
    with pytest.raises(TypeError, match="one dtype"):
        SSD.ssd_chunk_scan(x.half(), dt, A, B.bfloat16(), C.bfloat16())
    with pytest.raises(TypeError, match="float32 or x's dtype"):
        SSD.ssd_chunk_scan(x.half(), dt.bfloat16(), A, B.half(), C.half())


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m"])
def test_reduced_lm_serving_on_cuda_matches_cpu(dev, arch):
    """Same weights, same tokens: prefill + 3 decode steps on the card
    (kernels) and on the CPU (plain versions), logits within 2e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=3)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 40)))
    outs = {}
    for where in ("cpu", dev):
        p = tree_map(lambda a: a.to(where), params)
        opts = D.DistOptions(cut=1)
        prefill = D.make_prefill_step(cfg, opts, 40)
        decode = D.make_decode_step(cfg, opts, 40)
        t = tok.to(where)
        logits, caches = prefill(p, {"tokens": t[:, :37]})
        seq = [logits.cpu()]
        for i in range(3):
            logits, caches = decode(p, {"tokens": t[:, 37 + i:38 + i]},
                                    caches, 37 + i)
            seq.append(logits.cpu())
        outs[str(where)] = seq
    for a, b in zip(outs["cpu"], outs[str(dev)]):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["gemma3-4b", "recurrentgemma-2b",
                                  "internvl2-1b", "musicgen-large",
                                  "deepseek-v2-lite-16b"])
def test_reduced_family_serving_on_cuda_matches_cpu(dev, arch):
    """The reduced dense / hybrid / vision / audio archs at their own depth
    (past the window of 16): prefill + 3 decode steps on the card and on
    the CPU from the same weights, logits within 2e-4, and the card's
    flash and rmsnorm launches as the model implies."""
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cs = _chip_smoke()
    cfg = get_config(arch).reduced()
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    prompt, steps = cs._reduced_stream(cfg)
    n, cap = cs.REDUCED_PROMPT, cs.REDUCED_PROMPT + cs.REDUCED_STEPS
    outs = {}
    for where in ("cpu", dev):
        p = tree_map(lambda a: a.to(where), params)
        opts = D.DistOptions(cut=1)
        prefill = D.make_prefill_step(cfg, opts, cap)
        decode = D.make_decode_step(cfg, opts, cap)
        before = dict(LAUNCHES)
        logits, caches = prefill(p, tree_map(lambda a: a.to(where), prompt))
        seq = [logits.cpu()]
        for i, batch in enumerate(steps):
            logits, caches = decode(p, tree_map(lambda a: a.to(where),
                                                batch), caches, n + i)
            seq.append(logits.cpu())
        outs[str(where)] = seq
        grew = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    want = cs._expected_launches(cfg, decode_steps=len(steps))
    assert {k: grew[k] for k in want} == want
    for a, b in zip(outs["cpu"], outs[str(dev)]):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)


def test_moe_grouped_path_on_cuda_matches_cpu(dev):
    """The reduced deepseek MoE's grouped GShard dispatch at capacity
    factor 0.5 (2,400 tokens, 2 groups): the router's choices equal on
    the card and the CPU; from the same choices, the kept slots equal with
    some dropped, and the outputs within 1e-5 of the largest."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe as E
    from repro_torch.tree import tree_map
    cfg = get_config("deepseek-v2-lite-16b-smoke")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    p = E.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2400, cfg.d_model)).astype(np.float32))
    assert E._pick_groups(2400) == 2
    _, gates, idx, _ = E._route(p, cfg, x)
    outs = {}
    for where in ("cpu", dev):
        pp = tree_map(lambda a: a.to(where), p)
        _, _, card_idx, _ = E._route(pp, cfg, x.to(where))
        y, keep = E._experts_grouped(pp, cfg, x.to(where), gates.to(where),
                                     idx.to(where), None)
        outs[str(where)] = (card_idx.cpu(), y.cpu(), keep.cpu())
    (i_c, y_c, k_c), (i_d, y_d, k_d) = outs["cpu"], outs[str(dev)]
    assert torch.equal(i_d, i_c)
    assert torch.equal(k_d, k_c) and 0 < int(k_c.sum()) < k_c.numel()
    err = float((y_d - y_c).abs().max())
    assert err <= 1e-5 * float(y_c.abs().max()), err


# ------------------------------------------------------- LM autograd
# ssd's backward is the plain version's vjp on the same inputs; rmsnorm's
# and flash's are their backward kernels.  With the loss sum(w * y) the
# cotangent does not depend on the forward, so kernel and all-plain
# gradients differ only by the order of the sums: held at the forward
# tolerances above, relative to the largest gradient.
def _grads(fn, args, w):
    req = [a.detach().clone().requires_grad_() for a in args]
    out = fn(*req)
    return out.detach(), torch.autograd.grad((out * w).sum(), req)


def _autograd_case(name, dev):
    if name == "rmsnorm":
        args = (_randn((4, 64, 960), dev, 0, 2.0),
                _randn((960,), dev, 1, 0.1) + 1.0)
        return RN.rmsnorm, RN.rmsnorm_plain, args, RMS_TOL
    if name == "flash_attention":
        args = tuple(_randn(s, dev, i) for i, s in enumerate(
            [(4, 96, 15, 64), (4, 96, 5, 64), (4, 96, 5, 64)]))
        return (lambda q, k, v: FA.flash_attention(q, k, v),
                lambda q, k, v: FA.attention_plain(q, k, v), args, FLASH_TOL)
    x, dt, A, B, C = _ssd_inputs(dev, 4, 300, 8, 64, 1, 128)
    return (lambda x, dt, al, B, C: SSD.ssd_chunk_scan(
                x, dt, -torch.exp(al), B, C, chunk=256)[0],
            lambda x, dt, al, B, C: SSD.ssd_chunked(
                x, dt, -torch.exp(al), B, C, 256)[0],
            (x, dt, torch.log(-A), B, C), SSD_TOL)


LM_KERNELS = ["rmsnorm", "flash_attention", "ssd_chunk_scan"]


@pytest.mark.parametrize("name", LM_KERNELS)
def test_lm_function_gradients_on_cuda_match_plain(dev, name):
    fn, plain, args, tol = _autograd_case(name, dev)
    w = _randn(tuple(plain(*args).shape), dev, 9)
    n, nb = LAUNCHES[name], LAUNCHES["rmsnorm_backward"]
    nf = LAUNCHES["flash_attention_backward"]
    y_k, g_k = _grads(fn, args, w)
    assert LAUNCHES[name] == n + 1
    # rmsnorm's and flash's backward launch their kernels; ssd's nothing
    assert LAUNCHES["rmsnorm_backward"] == nb + (name == "rmsnorm")
    assert LAUNCHES["flash_attention_backward"] == nf + (
        name == "flash_attention")
    y_p, g_p = _grads(plain, args, w)
    torch.testing.assert_close(y_k, y_p, rtol=tol, atol=tol)
    assert all(bool(torch.isfinite(g).all()) for g in g_k)
    big = max(float(g.abs().max()) for g in g_p)
    for a, b in zip(g_k, g_p):
        assert float((a - b).abs().max()) <= tol * max(big, 1.0)


@pytest.mark.parametrize("name", LM_KERNELS)
def test_lm_function_vmap_on_cuda(dev, name):
    """Folded into the batch / rows: bit for bit the per-slice calls; a
    parameter per replica (rmsnorm's scale, the SSD's A_log): one call per
    replica, within the forward tolerance."""
    fn, _, args, tol = _autograd_case(name, dev)
    split = [a.reshape(2, a.shape[0] // 2, *a.shape[1:]) for a in args]
    dims = [0] * len(args)
    pi = {"rmsnorm": 1, "ssd_chunk_scan": 2}.get(name)
    if pi is not None:
        dims[pi] = None
        split[pi] = args[pi]
    n = LAUNCHES[name]
    got = torch.func.vmap(fn, in_dims=tuple(dims))(*split)
    assert LAUNCHES[name] == n + 1
    want = torch.stack([fn(*[s[i] if d == 0 else s for s, d in
                             zip(split, dims)]) for i in range(2)])
    assert torch.equal(got, want)
    if pi is not None:
        split[pi] = torch.stack([args[pi], args[pi] * 1.01])
        n = LAUNCHES[name]
        got = torch.func.vmap(fn)(*split)
        assert LAUNCHES[name] == n + 2
        want = torch.stack([fn(*[s[i] for s in split]) for i in range(2)])
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m"])
@pytest.mark.parametrize("compress", [False, True])
def test_reduced_lm_train_step_on_cuda_matches_cpu(dev, arch, compress):
    """One sgd train step (clip 1.0, remat) of the reduced config grown to
    three periods from the same weights and batch: the card's update within
    1 % of the largest update of the CPU's, losses within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=3)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 65)))
    w = torch.tensor([0.5, 0.5, 0.25, 0.25])
    opts = D.DistOptions(cut=1, optimizer="sgd", learning_rate=1e-2,
                         compress_smashed=compress)
    outs = {}
    for where in ("cpu", dev):
        # the step donates its state: the CPU's copy must not be params
        p = tree_map(lambda a: a.to(where, copy=True), params)
        state = {"params": p, "opt": D.make_optimizer(opts).init(p),
                 "step": torch.zeros((), dtype=torch.int32, device=where)}
        new, m = D.make_train_step(cfg, opts)(
            state, {"tokens": toks[:, :-1].to(where),
                    "labels": toks[:, 1:].to(where), "weights": w.to(where)})
        outs[str(where)] = ([t.cpu() for t in tree_leaves(new["params"])],
                            float(m["loss"]))
    (pa, la), (pb, lb) = outs["cpu"], outs[str(dev)]
    moved = max(float((a - a0).abs().max())
                for a, a0 in zip(pa, tree_leaves(params)))
    diff = max(float((a - b).abs().max()) for a, b in zip(pa, pb))
    assert diff <= 1e-2 * moved and abs(la - lb) <= 1e-4


def _spy_routes(E, record):
    """Wrap ``E._route`` to append each call's expert choices (on the CPU)
    to ``record``; returns the function that undoes the wrap."""
    route = E._route

    def spy(p, cfg, xt):
        res = route(p, cfg, xt)
        record.append(res[2].cpu())
        return res
    E._route = spy
    return lambda: setattr(E, "_route", route)


@pytest.mark.parametrize("grouped", [False, True])
def test_reduced_deepseek_train_step_on_cuda_matches_cpu(dev, grouped):
    """One sgd train step (clip 1.0, remat, cut 1) of deepseek-v2-lite-16b-
    smoke (an MLA + MoE period, the MLA + dense tail) from the same weights
    and batch on the card and the CPU, on the dense MoE path and on the
    grouped one (the dense budget 0, capacity factor 0.5, slots dropped).
    The routing is compared first: every router call's (token, choice)
    slots, the forward's and the remat recompute's, equal on both; then
    the card's update within 1 % of the largest update of the CPU's, the
    loss and the aux within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.models import moe as E
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("deepseek-v2-lite-16b-smoke")
    if grouped:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 65)))
    w = torch.tensor([0.5, 0.5, 0.25, 0.25])
    opts = D.DistOptions(cut=1, optimizer="sgd", learning_rate=1e-2)
    budget = E.DENSE_PATH_MAX_ELEMENTS
    outs, routes = {}, {}
    try:
        if grouped:
            E.DENSE_PATH_MAX_ELEMENTS = 0
        for where in ("cpu", dev):
            p = tree_map(lambda a: a.to(where, copy=True), params)
            state = {"params": p, "opt": D.make_optimizer(opts).init(p),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=where)}
            routes[str(where)] = []
            undo = _spy_routes(E, routes[str(where)])
            try:
                new, m = D.make_train_step(cfg, opts)(
                    state, {"tokens": toks[:, :-1].to(where),
                            "labels": toks[:, 1:].to(where),
                            "weights": w.to(where)})
            finally:
                undo()
            outs[str(where)] = ([t.cpu() for t in tree_leaves(
                new["params"])], float(m["loss"]), float(m["aux"]))
    finally:
        E.DENSE_PATH_MAX_ELEMENTS = budget
    ra, rb = routes["cpu"], routes[str(dev)]
    assert len(ra) == len(rb) == 2            # the forward and the remat
    apart = sum(int((a != b).sum()) for a, b in zip(ra, rb))
    assert apart == 0, f"{apart} (token, choice) slots routed apart"
    (pa, la, xa), (pb, lb, xb) = outs["cpu"], outs[str(dev)]
    moved = max(float((a - a0).abs().max())
                for a, a0 in zip(pa, tree_leaves(params)))
    diff = max(float((a - b).abs().max()) for a, b in zip(pa, pb))
    assert diff <= 1e-2 * moved and abs(la - lb) <= 1e-4
    assert xa > 0 and abs(xa - xb) <= 1e-4


def test_moe_dense_path_under_vmap_on_cuda(dev):
    """``_experts_dense`` (its gate matrix an out-of-place scatter) under
    ``torch.func.vmap`` over two replicas' parameters, tokens and routing
    on the card: equal to the per-replica calls within 1e-6 of the
    largest, and the CPU's within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as E
    from repro_torch.tree import tree_map
    cfg = get_config("deepseek-v2-lite-16b-smoke")
    reps = [E.init_moe(torch.Generator().manual_seed(i), cfg)
            for i in range(2)]
    stacked = tree_map(lambda *a: torch.stack(a), *reps)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 40, cfg.d_model)).astype(np.float32))
    routed = [E._route(reps[i], cfg, x[i]) for i in range(2)]
    gates = torch.stack([r[1] for r in routed])
    idx = torch.stack([r[2] for r in routed])

    def fn(p, xt, g, i):
        return E._experts_dense(p, cfg, xt, g, i)

    got = torch.func.vmap(fn)(*tree_map(lambda a: a.to(dev),
                                        (stacked, x, gates, idx)))
    want = torch.stack([fn(*tree_map(lambda a: a.to(dev),
                                     (reps[i], x[i], gates[i], idx[i])))
                        for i in range(2)])
    cpu = torch.func.vmap(fn)(stacked, x, gates, idx)
    big = float(cpu.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * big
    assert float((got.cpu() - cpu).abs().max()) <= 1e-5 * big


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_inplace_on_cuda_equals_functional(dev, name, dtype):
    """The optimizer's in-place step on the card against its functional
    form from the same parameters and gradients (clip 1.0), three steps,
    in slices (a leaf over CHUNK values): parameters, moments and the norm
    bit for bit, in the storage it was given."""
    from repro_torch import optim
    from repro_torch.optim import optimizers as O
    from repro_torch.tree import tree_leaves, tree_map
    make = {"sgd": lambda: optim.sgd(1e-2),
            "momentum": lambda: optim.momentum(1e-2, nesterov=True),
            "adamw": lambda: optim.adamw(3e-3, weight_decay=0.01)}[name]
    opt = make()
    rng = np.random.default_rng(0)

    def tree(scale):
        return {k: torch.from_numpy((scale * rng.normal(size=s)).astype(
            np.float32)).to(dev, dtype)
            for k, s in (("big", (O.CHUNK // 1024 + 3, 1024)),
                         ("w", (96, 33)), ("b", (33,)))}

    params = tree(1.0)
    mine = tree_map(lambda t: t.clone(), params)
    state, my_state = opt.init(params), opt.init(mine)
    ptrs = [t.data_ptr() for t in tree_leaves(mine)]
    for step in range(3):
        grads = tree(0.5 + step)
        clipped, norm = optim.clip_by_global_norm(grads, 1.0)
        updates, state = opt.update(clipped, state, params)
        params = optim.apply_updates(params, updates)
        glist = tree_leaves(grads)
        scale, my_norm = optim.clip_scale(glist, 1.0)
        my_state = opt.update_(glist, my_state, tree_leaves(mine), scale)
        assert torch.equal(norm, my_norm)
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves([params, state]), tree_leaves([mine, my_state])))
    assert [t.data_ptr() for t in tree_leaves(mine)] == ptrs


@pytest.mark.parametrize("arch", ["qwen3-14b", "command-r-35b"])
@pytest.mark.parametrize("compress", [False, True])
def test_reduced_bf16_train_step_on_cuda_matches_cpu(dev, arch, compress):
    """One adamw train step (lr 1e-2, clip 1.0, remat) of the bfloat16
    arch's reduced config grown to three layers from the same bfloat16
    weights and batch, the donated step on the card and on the CPU.  A
    bfloat16 parameter rounds away an update below half its ulp, so the
    gradient is held where it is float32: each leaf's first moment
    (``(1 - b1) g``) within BF16_MOMENT_RTOL of the CPU's in norm, the
    loss within 1e-3; the card's parameters bfloat16 in their own
    storage, its moments float32 and finite."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=3)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 65)))
    w = torch.tensor([0.5, 0.5, 0.25, 0.25])
    opts = D.DistOptions(cut=1, optimizer="adamw", learning_rate=1e-2,
                         compress_smashed=compress)
    outs = {}
    for where in ("cpu", dev):
        p = tree_map(lambda a: a.to(where, copy=True), params)
        ptrs = [t.data_ptr() for t in tree_leaves(p)]
        state = {"params": p, "opt": D.make_optimizer(opts).init(p),
                 "step": torch.zeros((), dtype=torch.int32, device=where)}
        new, m = D.make_train_step(cfg, opts)(
            state, {"tokens": toks[:, :-1].to(where),
                    "labels": toks[:, 1:].to(where), "weights": w.to(where)})
        assert [t.data_ptr() for t in tree_leaves(new["params"])] == ptrs
        outs[str(where)] = ([t.cpu() for t in tree_leaves(new["params"])],
                            [t.cpu() for t in tree_leaves(new["opt"]["m"])],
                            float(m["loss"]))
    (_, ma, la), (pb, mb, lb) = outs["cpu"], outs[str(dev)]
    assert {t.dtype for t in pb} == {torch.bfloat16}
    assert {t.dtype for t in mb} == {torch.float32}
    assert all(bool(torch.isfinite(t).all()) for t in mb)
    assert abs(la - lb) <= cs.BF16_LOSS_TOL
    assert cs._moment_rel_err(ma, mb) <= cs.BF16_MOMENT_RTOL


@pytest.mark.parametrize("name,rule", [("rmsnorm", "fold"),
                                       ("rmsnorm", "loop"),
                                       ("flash_attention", "fold"),
                                       ("ssd_chunk_scan", "fold"),
                                       ("ssd_chunk_scan", "loop")])
def test_lm_function_vjp_of_vmap_on_cuda(dev, name, rule):
    """CohortEngine's vehicle side under its ``vmap`` schedule: vjp of the
    vmapped Function against the per-replica vjps, with only activations
    carrying the replica axis (``fold``: one launch for both replicas) and
    with a parameter per replica too (``loop``: one launch each; rmsnorm's
    and flash's backward kernels the same).  Both backward passes are the
    same backward (the plain version's vjp, or a backward kernel), on the
    folded batch or on one replica, so the gradients differ only in the
    order of their sums: within the forward tolerance of the largest
    gradient."""
    fn, _, args, tol = _autograd_case(name, dev)
    vin = [a.reshape(2, a.shape[0] // 2, *a.shape[1:]) for a in args]
    dims = [0] * len(args)
    pi = {"rmsnorm": 1, "ssd_chunk_scan": 2}.get(name)
    if rule == "fold" and pi is not None:
        dims[pi], vin[pi] = None, args[pi]
    elif rule == "loop":
        vin[pi] = torch.stack([args[pi], args[pi] * 1.01])
    diff = [i for i, d in enumerate(dims) if d is not None]

    def with_diff(base, d_args):
        full = list(base)
        for i, a in zip(diff, d_args):
            full[i] = a
        return full

    n, nb = LAUNCHES[name], LAUNCHES["rmsnorm_backward"]
    nf = LAUNCHES["flash_attention_backward"]
    out, vjp = torch.func.vjp(
        lambda *d: torch.func.vmap(fn, in_dims=tuple(dims))(
            *with_diff(vin, d)), *[vin[i] for i in diff])
    g = _randn(tuple(out.shape), dev, 11)
    got = vjp(g)
    calls = 1 if rule == "fold" else 2
    assert LAUNCHES[name] == n + calls
    assert LAUNCHES["rmsnorm_backward"] == nb + calls * (name == "rmsnorm")
    assert LAUNCHES["flash_attention_backward"] == nf + calls * (
        name == "flash_attention")
    for r in range(2):
        sl = [a if d is None else a[r] for a, d in zip(vin, dims)]
        _, vjp1 = torch.func.vjp(lambda *d: fn(*with_diff(sl, d)),
                                 *[sl[i] for i in diff])
        want = vjp1(g[r])
        big = max(float(t.abs().max()) for t in want)
        for a, b in zip((t[r] for t in got), want):
            assert bool(torch.isfinite(a).all())
            assert float((a - b).abs().max()) <= tol * max(big, 1.0)


@pytest.mark.parametrize("arch", ["gemma3-4b", "recurrentgemma-2b",
                                  "internvl2-1b", "musicgen-large"])
def test_reduced_family_train_step_on_cuda_matches_cpu(dev, arch):
    """One sgd train step (clip 1.0, remat) of a family's reduced config
    (``chip_smoke._train_smoke_config``: gemma3 / recurrentgemma with their
    period and tail, internvl2 / musicgen at three layers) on the card and
    on the CPU from the same weights and batch (patch embeddings and
    codebooks as ``launch.train.synth_batch`` draws them): the card's
    update within 1 % of the largest update, losses within 1e-4, and the
    card's launches those ``chip_smoke._train_launches`` gives (qk-norm's
    rows included, nothing for an RG-LRU mixer)."""
    from repro_torch.core import distributed as D
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    cs = _chip_smoke()
    cfg = cs._train_smoke_config(arch)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    batch = synth_batch(cfg, torch.Generator().manual_seed(0), 4, 64, 2)
    opts = D.DistOptions(cut=1, optimizer="sgd", learning_rate=1e-2)
    outs = {}
    for where in ("cpu", dev):
        p = tree_map(lambda a: a.to(where, copy=True), params)
        state = {"params": p, "opt": D.make_optimizer(opts).init(p),
                 "step": torch.zeros((), dtype=torch.int32, device=where)}
        reset_launches()
        new, m = D.make_train_step(cfg, opts)(
            state, {k: v.to(where) for k, v in batch.items()})
        outs[str(where)] = ([t.cpu() for t in tree_leaves(new["params"])],
                            float(m["loss"]))
    counts = launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(cs._train_launches(cfg, False, 1))
    assert counts == want
    (pa, la), (pb, lb) = outs["cpu"], outs[str(dev)]
    moved = max(float((a - a0).abs().max())
                for a, a0 in zip(pa, tree_leaves(params)))
    diff = max(float((a - b).abs().max()) for a, b in zip(pa, pb))
    assert diff <= 1e-2 * moved and abs(la - lb) <= 1e-4


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m"])
def test_reduced_lm_train_step_launches_follow_remat(dev, arch):
    """``DistOptions.remat`` on the card: with it on each of the three
    periods launches its kernels again in the backward, off once; the
    final norm once either way."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.kernels import reset_launches
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=3)
    mixer = "flash_attention" if arch == "smollm-360m" else "ssd_chunk_scan"
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 65))).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "weights": torch.full((4,), 0.25, device=dev)}
    for remat, fwd in ((True, 2), (False, 1)):
        opts = D.DistOptions(cut=1, optimizer="sgd", remat=remat)
        p = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        state = {"params": p, "opt": D.make_optimizer(opts).init(p),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        reset_launches()
        D.make_train_step(cfg, opts)(state, batch)
        counts = launch_counts()
        assert counts["rmsnorm"] == fwd * 2 * 3 + 1
        assert counts["rmsnorm_backward"] == 2 * 3 + 1
        assert counts[mixer] == fwd * 3
        assert counts["flash_attention_backward"] == 3 * (
            mixer == "flash_attention")


# ------------------------------------------ the fault and streaming planes
# a reduced highway cell: 16 vehicles, topk_int8 with error feedback, the
# faults of chip_smoke.py's phase 10k (a deadline every round catches) and
# its streaming settings with a buffer of 2
PLANE_FAULTS = dict(dropout_rate=0.3, upload_loss_rate=0.1,
                    rsu_outage_rate=0.2, straggler_factor=0.001)
PLANE_STREAM = dict(churn_rate=0.2, buffer_size=2, kernel="poly",
                    alpha=0.5)


def _plane_engine(device, schedule, k, faulted=True, streamed=False):
    from repro_torch import api
    spec = api.ExperimentSpec(
        model="mlp9",
        train=api.TrainConfig(rounds=4, local_steps=2, batch_size=8,
                              lr=1e-3, optimizer="sgd", eval_every=0,
                              wire="topk_int8", server_schedule=schedule),
        fleet=api.FleetConfig(n_vehicles=16, scenario="highway_corridor",
                              round_interval_s=10.0, cloud_sync_every=2,
                              per_vehicle_samples=64),
        faults=api.FaultsConfig(**(PLANE_FAULTS if faulted else {})),
        stream=api.StreamConfig(**(PLANE_STREAM if streamed else {})),
        runtime=api.RuntimeConfig(superstep=k))
    return api.build_engine(spec, device=device)


@pytest.mark.parametrize("schedule,streamed", [("sequential", False),
                                               ("parallel", False),
                                               ("streaming", True)])
def test_plane_window_equals_rounds_on_cuda(dev, schedule, streamed):
    """Under faults (and churn with the buffer on streaming), a K = 4
    window trains the same bits on the card as four windows of one
    round."""
    runs = []
    for k in (1, 4):
        eng = _plane_engine(dev, schedule, k, streamed=streamed)
        hist = eng.run()
        runs.append(([m.loss for m in hist], _engine_params(eng),
                     [r.cpu().numpy() for r in eng.wire_res
                      if r is not None], hist))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    for a, b in zip(runs[0][2], runs[1][2]):
        np.testing.assert_array_equal(a, b)
    hist = runs[0][3]
    assert sum(m.n_dropout for m in hist) > 0
    if streamed:
        assert sum(m.stream_merges for m in hist) > 0


def test_plane_codec_launches_on_cuda(dev):
    """Parallel schedule under dropouts on the card: 2 packs and 2 unpacks
    per (cut bucket, local step) with an active slot, one fused matmul per
    (cut bucket, RSU, local step) with one, counted from the plans."""
    eng = _plane_engine(dev, "parallel", 1)
    plans = []
    real = eng._plan

    def spy(*args):
        plans.append(real(*args))
        return plans[-1]

    eng._plan = spy
    before = launch_counts()
    hist = eng.run()
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    buckets = runs = 0
    for p in plans:
        for s in range(2):
            act = (p["cuts"] > 0) & (p["dstep"] > s)
            buckets += len(np.unique(p["cuts"][act]))
            runs += len(set(zip(p["cuts"][act].tolist(),
                                p["serving"][act].tolist())))
    assert sum(m.n_dropout for m in hist) > 0
    assert launches["sparsify_quant_pack"] == launches["unpack_dequant"] \
        == 2 * buckets
    assert launches["unpack_dequant_matmul"] == runs
    assert eng.batch_steps == sum(int(p["dstep"][p["cuts"] > 0].sum())
                                  for p in plans)


@pytest.mark.parametrize("schedule", ["sequential", "streaming"])
def test_plane_trace_on_cuda_matches_cpu(dev, schedule):
    """The two-cell trace with both planes on (chip_smoke.py's phase 10k
    settings) on the card and on the CPU from the same weights: the same
    plans and telemetry, parameters within 1e-4 of the largest."""
    import dataclasses

    from repro_torch.core import channel, fedsim, scenario
    from repro_torch.models.mlp_unit import MLPUnitModel, make_mlp_fleet_data
    times = np.arange(5, dtype=np.float64) * 5.0
    x = np.stack([np.linspace(300.0, 900.0, 5), np.full(5, 250.0)], -1)
    pos = np.stack([x, np.zeros_like(x)], axis=-1)
    rsus = np.array([[300.0, 0.0], [900.0, 0.0]])
    cfg = fedsim.SimConfig(
        rounds=4, local_steps=2, batch_size=8, lr=1e-3, optimizer="sgd",
        wire="topk_int8", round_interval_s=5.0, eval_every=0,
        server_schedule=schedule, fault_dropout=0.3, fault_upload_loss=0.2,
        fault_rsu_outage=0.3, fault_straggler=1e-7, stream_churn_rate=0.3,
        stream_seed=5, stream_buffer_size=2, stream_kernel="poly")
    clients, test = make_mlp_fleet_data(2, 24, seed=0, n_test=64)
    out = []
    for where in ("cpu", dev):
        sc = scenario.TraceReplay(times, pos, rsus,
                                  ch=channel.ChannelConfig(
                                      fading_std_db=0.0, rsu_range_m=320.0),
                                  seed=0)
        eng = fedsim.ScenarioEngine(MLPUnitModel(), clients, test, cfg, sc,
                                    cloud_sync_every=2, device=where)
        hist = eng.run()
        out.append(([dataclasses.astuple(m)[6:] for m in hist],
                    [m.loss for m in hist], _engine_params(eng)))
    (tc, lc, pc), (tg, lg, pg) = out
    assert tc == tg
    np.testing.assert_allclose(lg, lc, atol=1e-4)
    assert np.abs(pc - pg).max() <= 1e-4 * np.abs(pc).max()


# --------------------------------------------- the city and slot paging
def _small_city_engine(device, page):
    """tests/test_fleet_sharding.py's reduced city (64 vehicles, 2 x 2),
    topk_int8, 4 rounds in one window, parallel ragged."""
    from repro_torch.core import fedsim, scenario
    from repro_torch.models.mlp_unit import MLPUnitModel, make_mlp_fleet_data
    cfg = fedsim.SimConfig(rounds=4, local_steps=2, batch_size=8, lr=1e-2,
                           optimizer="sgd", wire="topk_int8",
                           round_interval_s=5.0, eval_every=0, superstep=4,
                           server_schedule="parallel", page_slots=page)
    clients, test = make_mlp_fleet_data(64, 24, seed=0, n_test=64)
    sc = scenario.make_scenario("city", 64, seed=1, grid_x=2, grid_y=2)
    return fedsim.ScenarioEngine(MLPUnitModel(), clients, test, cfg, sc,
                                 cloud_sync_every=2, device=device)


def test_paged_city_on_cuda(dev):
    """The reduced city paged at 4 on the card: within 1e-4 of the largest
    parameter of the CPU's run, two runs bit for bit, the codec launched
    per page (two packs and two unpacks per (cut bucket page, local step),
    one fused matmul per (cut bucket page, RSU run, local step)), and a
    peak memory below the unpaged run's."""
    cpu = _small_city_engine("cpu", 4)
    cpu.run()
    runs, peaks = [], {}
    for page in (4, 4, 0):
        eng = _small_city_engine(dev, page)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        hist = eng.run()
        torch.cuda.synchronize()
        after = launch_counts()
        peaks[page] = torch.cuda.max_memory_allocated()
        if page:
            launches = {k: after[k] - before[k] for k in after}
            b, rb = eng.bucket_steps, eng.rsu_bucket_steps
            assert launches["sparsify_quant_pack"] == 2 * b
            assert launches["unpack_dequant"] == 2 * b
            assert launches["unpack_dequant_matmul"] == rb
            runs.append(([m.loss for m in hist], _engine_params(eng),
                         [r.cpu().numpy() for r in eng.wire_res
                          if r is not None], b))
    assert runs[0][3] == cpu.bucket_steps > len(cpu.history) * 2
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    for a, b in zip(runs[0][2], runs[1][2]):
        np.testing.assert_array_equal(a, b)
    pc = _engine_params(cpu)
    assert np.abs(pc - runs[0][1]).max() <= 1e-4 * np.abs(pc).max()
    assert peaks[4] < peaks[0]
