"""flash_attention's route choice on the CPU.

``flash_route`` decides before a launch which CUDA kernel a call takes:
``"hopper"`` (``csrc/flash_hopper.cu``: wgmma / TMA) for bfloat16 or float16
q, k and v at head dim 64 or 128 that TMA can map, ``"mma"``
(``csrc/lm.cu``) for everything else: float32, 16-bit d 32 and 256.  It is
held here at every 16-bit flash case of chip_smoke.py's phase 4b
(``FLASH16_CASES`` and the split case), the same shapes in float32, the
bfloat16 archs' prefills through the model's own q / k / v projections
(phase 8's s 1024 and phase 9's s 1023, on the full configs' head geometry
at a small width), the 16-bit training layers of phase 10g (smollm-360m in
float16 at d 64, gemma3-4b in bfloat16 at d 256, qwen3-14b at d 128) with
the backward's rule beside the forward's, dbrx-132b-smoke's d 32, and
q / k / v views at d 64 and 128: slices of one fused projection, a view
misaligned by one element, head or sequence strides not a multiple of 8
elements, a non-contiguous trailing dim.  On the CPU the wrapper runs the
plain version whatever the route and launches nothing."""
import functools
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as ATT

DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}
BF16_ARCHS = ("qwen3-14b", "command-r-35b", "dbrx-132b")
# the forward's route of 16-bit q / k / v that TMA can map, by head dim:
# d 64 on the Hopper route since its d-64 kernel, d 256 on the mma route
FWD_ROUTE_16BIT = {32: "mma", 64: "hopper", 128: "hopper", 256: "mma"}


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """The repo's ``chip_smoke.py`` as a module, for its case tables."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _empty(b, sq, sk, h, kv, d, dtype):
    """Unwritten q, k and v of the case's shapes (the route reads only
    dtypes, shapes, strides and addresses)."""
    return (torch.empty((b, sq, h, d), dtype=dtype),
            torch.empty((b, sk, kv, d), dtype=dtype),
            torch.empty((b, sk, kv, d), dtype=dtype))


def _phase4b_cases():
    return [(label, shape[:6]) for label, shape, _ in
            _chip_smoke().FLASH16_CASES]


@pytest.mark.parametrize("dt", [*DTYPES, "f32"])
@pytest.mark.parametrize("label,shape", _phase4b_cases())
def test_route_at_phase4b_flash_cases(label, shape, dt):
    """16-bit at d 64 and 128 takes the Hopper route (smollm's prefill,
    the d-64 edges, the d-128 edges and the bf16 archs' prefills), d 32
    and 256 the mma route; float32 always the mma route."""
    dtype = DTYPES.get(dt, torch.float32)
    q, k, v = _empty(*shape, dtype)
    want = "mma" if dt == "f32" else FWD_ROUTE_16BIT[shape[5]]
    assert FA.flash_route(q, k, v) == want


@pytest.mark.parametrize("dt", list(DTYPES))
def test_route_of_the_split_case(dt):
    cs = _chip_smoke()
    q, k, v = cs.flash_split_case(DTYPES[dt], device="cpu")
    assert cs.FLASH_SPLIT_SHAPE[5] == 128
    assert FA.flash_route(q, k, v) == "hopper"
    assert FA.flash_route(q.float(), k.float(), v.float()) == "mma"


@pytest.mark.parametrize("s", [1024, 1023])
@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_route_of_bf16_arch_prefills(arch, s):
    """The model's own q / k / v (projections, qk-norm, rope) on the full
    config's head geometry and dtype at a width of 64, batch 1: the Hopper
    route at phase 8's prompt (s 1024) and phase 9's s - 1."""
    import dataclasses
    full = get_config(arch)
    cfg = dataclasses.replace(full, d_model=64, head_dim=full.head_dim_)
    assert cfg.param_dtype == "bfloat16" and cfg.head_dim_ == 128
    p = ATT.init_attn(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((1, s, 64), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    q, k, v = ATT._qkv(p, cfg, x, torch.arange(s))
    assert q.shape == (1, s, cfg.n_heads, 128)
    assert k.shape == v.shape == (1, s, cfg.n_kv_heads, 128)
    assert FA.flash_route(q, k, v) == "hopper"


# phase 10g's 16-bit training layers at a small width: (arch, dtype, the
# forward's route, the backward's route)
TRAIN_16BIT = [("smollm-360m", torch.float16, "hopper", "mma"),
               ("gemma3-4b", torch.bfloat16, "mma", "hopper"),
               ("qwen3-14b", torch.bfloat16, "hopper", "hopper")]


@pytest.mark.parametrize("arch,dtype,fwd,bwd", TRAIN_16BIT)
def test_route_of_16bit_training_layers(arch, dtype, fwd, bwd):
    """The model's own q / k / v (projections, qk-norm, rope) on the full
    config's head geometry in the training dtype at a width of 64, batch
    1, s 1024, and a cotangent of q's shape: smollm in float16 (d 64)
    runs its forward on the Hopper route and its backward on the mma
    route, gemma3 in bfloat16 (d 256) the other way round, qwen3 (d 128)
    both on the Hopper route."""
    import dataclasses
    full = get_config(arch)
    cfg = dataclasses.replace(full, d_model=64, head_dim=full.head_dim_,
                              param_dtype=str(dtype).split(".")[1])
    p = ATT.init_attn(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((1, 1024, 64), generator=torch.Generator().manual_seed(1)
                    ).to(dtype)
    q, k, v = ATT._qkv(p, cfg, x, torch.arange(1024))
    assert q.dtype == dtype and q.shape[-1] == full.head_dim_
    assert FA.flash_route(q, k, v) == fwd
    assert FA.flash_backward_route(q, k, v, torch.empty_like(q)) == bwd


def test_route_of_dbrx_smoke():
    """dbrx-132b-smoke (phase 10) has d 32: the mma route."""
    cfg = get_config("dbrx-132b").reduced()
    assert cfg.head_dim_ == 32
    q, k, v = _empty(2, 37, 37, cfg.n_heads, cfg.n_kv_heads, 32,
                     torch.bfloat16)
    assert FA.flash_route(q, k, v) == "mma"


def test_route_of_strided_and_misaligned_views():
    """Slices of one fused projection (test_flash_kernel_reads_strided_qkv's
    views, at d 64 in float32, and at d 64 and 128 in bfloat16 and
    float16), the same views misaligned by one element, and at d 128 a
    sequence stride of 8 * 130 + 1 values, a head stride of 130 and a
    trailing stride of 2."""
    f32 = torch.zeros((2, 50, 8, 64))
    assert FA.flash_route(f32[:, :, :4], f32[:, :, 4:6], f32[:, :, 6:]) \
        == "mma"
    for dtype, d in ((dt, d) for dt in DTYPES.values() for d in (64, 128)):
        qkv = torch.zeros((2, 50, 8, d), dtype=dtype)
        views = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
        assert FA.flash_route(*views) == "hopper"
        odd = torch.zeros(2 * 50 * 8 * d + 1, dtype=dtype)[1:].view(
            2, 50, 8, d)
        assert FA.flash_route(odd[:, :, :4], odd[:, :, 4:6],
                              odd[:, :, 6:]) == "mma"
        if d == 64:
            continue
        seq = torch.zeros((2, 50 * (8 * 130 + 1)), dtype=dtype).view(
            2, 50, 8 * 130 + 1)[..., :8 * 130].view(2, 50, 8, 130)
        assert seq.stride(1) % 8 and FA.flash_route(
            seq[..., :128], seq[..., :128], seq[..., :128]) == "mma"
        head = torch.zeros((2, 50, 8, 130), dtype=dtype)[..., :128]
        assert head.stride(2) == 130 and FA.flash_route(
            head, head, head) == "mma"
        step = torch.zeros((2, 50, 8, 256), dtype=dtype)[..., ::2]
        assert FA.flash_route(step, step, step) == "mma"


def test_route_needs_one_dtype_a_key_and_a_positive_scale():
    bf = torch.bfloat16
    q, k, v = _empty(1, 16, 16, 4, 2, 128, bf)
    assert FA.flash_route(q, k, v) == "hopper"
    assert FA.flash_route(q, k, v, scale=0.5) == "hopper"
    assert FA.flash_route(q, k.half(), v) == "mma"
    assert FA.flash_route(q, k, v, scale=0.0) == "mma"
    assert FA.flash_route(q, k, v, scale=-0.1) == "mma"
    q0, k0, v0 = _empty(1, 16, 0, 4, 2, 128, bf)
    assert FA.flash_route(q0, k0, v0) == "mma"


def test_cpu_calls_launch_nothing_on_either_route():
    """The wrapper on CPU tensors runs the plain version at a Hopper shape
    and counts no launch, of either route."""
    q, k, v = (torch.randn(s, generator=torch.Generator().manual_seed(i))
               .to(torch.bfloat16) for i, s in
               enumerate([(1, 20, 4, 128), (1, 20, 2, 128), (1, 20, 2, 128)]))
    before, routes = dict(LAUNCHES), dict(FA.ROUTE_LAUNCHES)
    got = FA.flash_attention(q, k, v)
    assert torch.equal(got, FA.attention_plain(q, k, v))
    assert LAUNCHES == before and FA.ROUTE_LAUNCHES == routes
    assert set(FA.ROUTE_LAUNCHES) == set(FA.ROUTES) == {"hopper", "mma"}
