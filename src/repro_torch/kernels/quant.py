"""Per-group symmetric int8 quantisation of smashed data (``wire="int8"``).

Replaces the Pallas TPU kernels of ``repro/kernels/quant.py``:
``quantize_int8`` (``_quant_kernel``) and ``dequantize_int8``
(``_dequant_kernel``), with the same signatures and bit-exact results.

Bound on H100: bytes.  Quantize reads 4 bytes and writes 1 (+4 per group)
per value; dequantize the reverse; a handful of flops per value, far below
the card's ~20 flops/byte ridge for f32.  Quantize keeps each group in
registers: one warp per group (g <= 128, so <= 4 values per lane), amax by
a warp-shuffle max, no shared memory and no block synchronisation.
Dequantize gives a thread 4 consecutive int8 of one group (one 4-byte load
beside its scale's, one float4 store: a warp's loads and stores are
contiguous) on a 2-D (run, row) grid, so no index needs a 64-bit divide;
widths and groups that are not multiples of 4 and misaligned tensors take
one value a thread.  At the main path's sizes (0.5-4 MB per call) launch
overhead, not bandwidth, dominates.

Non-finite input.  For any f32 input (NaN, +-inf, +-0.0 and subnormals
included) the kernels and the plain versions give the reference's int8
values bit for bit, its scales bit for bit where they are finite or +-inf
and NaN exactly where they are NaN (payloads aside: XLA keeps the input's,
torch and CUDA canonicalise it), and its dequantized floats, NaN where they
are NaN.  A group holding a NaN has a NaN scale, one holding +-inf an inf
scale; every int8 of such a group is 0 (a NaN quotient casts to 0) and it
dequantizes to NaN.

The plain PyTorch versions (``repro_torch.core.compression``) run for CPU
tensors; CUDA tensors always go to the kernel (``kernels/csrc/codec.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.core import compression as C
from repro_torch.kernels import LAUNCHES, _build

GROUP = C.GROUP
MAX_GROUP = 128  # the kernels hold one group in one warp (<= 4 per lane)


def _check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() < 1 or t.shape[-1] < 1:
        raise ValueError(f"{name} needs a non-empty trailing dim, got shape "
                         f"{tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous for the CUDA kernel")


def _check_group(group: int) -> None:
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"group={group} must be in [1, {MAX_GROUP}]")


def launch(name: str, device: torch.device, *args) -> None:
    """Launch ``repro_<name>`` on the current stream of ``device``; raise
    if the launch was refused; count it."""
    lib = _build.load().lib
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"repro_{name}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")
    LAUNCHES[name] += 1


def quantize_int8(x: torch.Tensor, group: int = GROUP):
    """x (..., d) f32 -> (q int8 (..., d), scales f32 (..., ceil(d/g)))
    with g = min(group, d), the tail group zero-padded internally."""
    _check_tensor(x, "x", torch.float32)
    _check_group(group)
    if x.device.type == "cpu":
        return C.quantize_int8(x, group)
    *lead, d = x.shape
    g, ng = C._group_shape(d, group)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((*lead, ng), dtype=torch.float32, device=x.device)
    launch("quantize_int8", x.device, x.data_ptr(), q.data_ptr(),
           scales.data_ptr(), x.numel() // d, d, g, ng)
    return q, scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    group: int = GROUP) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` -> f32 (..., d)."""
    _check_tensor(q, "q", torch.int8)
    _check_tensor(scales, "scales", torch.float32)
    _check_group(group)
    *lead, d = q.shape
    ng = scales.shape[-1]
    if tuple(scales.shape[:-1]) != tuple(lead):
        raise ValueError(f"scales {tuple(scales.shape)} do not match q "
                         f"{tuple(q.shape)}")
    g, ng_default = C._group_shape(d, group)
    if ng != ng_default:
        g = d // ng                     # custom exactly-dividing group
    if g < 1 or ng * g < d or g > MAX_GROUP:
        raise ValueError(f"{ng} scales cannot cover a trailing dim of {d} "
                         f"with group={group}")
    if q.device != scales.device:
        raise ValueError("q and scales must be on the same device")
    if q.device.type == "cpu":
        return C.dequantize_int8(q, scales, torch.float32, group)
    x = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    launch("dequantize_int8", q.device, q.data_ptr(), scales.data_ptr(),
           x.data_ptr(), q.numel() // d, d, g, ng)
    return x
