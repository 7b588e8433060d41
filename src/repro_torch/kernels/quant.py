"""Per-group symmetric int8 quantisation of smashed data (``wire="int8"``).

Replaces the Pallas TPU kernels of ``repro/kernels/quant.py``:
``quantize_int8`` (``_quant_kernel``) and ``dequantize_int8``
(``_dequant_kernel``), with the same signatures, dtypes and bit-exact
results.  As the reference's kernels do, ``quantize_int8`` takes x in
float32, bfloat16 or float16 and widens it to f32 exactly as it reads it
(so q and scales are those of ``x.float()``), and ``dequantize_int8``
returns the ``dtype`` it is asked for (float32, bfloat16 or float16): the
product q x scale in f32, rounded once to ``dtype`` to nearest even, as
XLA's ``astype`` does.  Any other dtype raises ``TypeError``.

Bound on H100: bytes.  Quantize reads 4 (or 2) bytes and writes 1 (+4 per
group) per value; dequantize the reverse; a handful of flops per value,
far below the card's ~20 flops/byte ridge for f32.  Quantize keeps each
group in registers: a group takes W lanes of 4 consecutive values each (W
the next power of two of ceil(g/4): 32 at g = 128, 16 at g = 64), amax by a
segmented warp-shuffle max (one ``redux.sync`` at W = 32), one 16-byte
(f32) or 8-byte (bf16/f16) load and one 32-bit store of 4 int8 a lane, on
a 2-D (lanes, rows) grid, so no index needs a 64-bit divide.  Dequantize
gives a thread 4 consecutive int8 of one group (one 4-byte load beside its
scale's, one 16- or 8-byte store: a warp's loads and stores are
contiguous) on a 2-D (run, row) grid.
Widths and groups that are not multiples of 4 and misaligned tensors take
one value a load.  At the main path's sizes (0.5-4 MB per call) launch
overhead, not bandwidth, dominates.

Non-finite input.  For any input (NaN, +-inf, +-0.0 and subnormals
included, in every input dtype; a bf16 or f16 NaN widens to an f32 NaN)
the kernels and the plain versions give the reference's int8 values bit
for bit, its scales bit for bit where they are finite or +-inf and NaN
exactly where they are NaN (payloads aside: XLA keeps the input's, torch
and CUDA canonicalise it), and its dequantized floats in every output
dtype, NaN where they are NaN.  A group holding a NaN has a NaN scale,
one holding +-inf an inf scale; every int8 of such a group is 0 (a NaN
quotient casts to 0) and it dequantizes to NaN.

The plain PyTorch versions (``repro_torch.core.compression``) run for CPU
tensors; CUDA tensors always go to the kernel (``kernels/csrc/codec.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.core import compression as C
from repro_torch.kernels import LAUNCHES, _build

GROUP = C.GROUP
MAX_GROUP = 128  # the kernels hold one group in one warp (<= 4 per lane)
# the floating-point types the codec takes, and their code in the C
# interface (kernels/csrc/codec.cu)
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_tensor(t: torch.Tensor, name: str, dtypes) -> None:
    """Raise unless ``t`` is a non-empty tensor of one of ``dtypes`` (a
    dtype or a collection of them) on the CPU, or contiguous on CUDA."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if isinstance(dtypes, torch.dtype):
        dtypes = (dtypes,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {tuple(dtypes)}, got "
                        f"{t.dtype}")
    if t.dim() < 1 or t.shape[-1] < 1:
        raise ValueError(f"{name} needs a non-empty trailing dim, got shape "
                         f"{tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous for the CUDA kernel")


def float_code(dtype: torch.dtype) -> int:
    """The C interface's code for a float dtype; TypeError for any other."""
    if dtype not in FLOAT_CODES:
        raise TypeError(f"dtype must be one of {tuple(FLOAT_CODES)}, got "
                        f"{dtype}")
    return FLOAT_CODES[dtype]


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
    """x (..., d) f32 / bf16 / f16 -> (q int8 (..., d), scales f32 (...,
    ceil(d/g))) with g = min(group, d), the tail group zero-padded
    internally."""
    _check_tensor(x, "x", FLOAT_CODES)
    _check_group(group)
    if x.device.type == "cpu":
        return C.quantize_int8(x, group)
    *lead, d = x.shape
    g, ng = C._group_shape(d, group)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((*lead, ng), dtype=torch.float32, device=x.device)
    launch("quantize_int8", x.device, x.data_ptr(), q.data_ptr(),
           scales.data_ptr(), x.numel() // d, d, g, ng, FLOAT_CODES[x.dtype])
    return q, scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    group: int = GROUP,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` -> ``dtype`` (..., d) (f32, bf16 or
    f16), the reference kernel's argument order."""
    code = float_code(dtype)
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
        return C.dequantize_int8(q, scales, dtype, group)
    x = torch.empty(q.shape, dtype=dtype, device=q.device)
    launch("dequantize_int8", q.device, q.data_ptr(), scales.data_ptr(),
           x.data_ptr(), q.numel() // d, d, g, ng, code)
    return x


class _FakeQuant(torch.autograd.Function):
    """Quantise-dequantise with a straight-through gradient (twin of the
    reference's ``core.compression.fake_quant``)."""

    @staticmethod
    def forward(x):
        q, scales = quantize_int8(x)
        return dequantize_int8(q, scales, dtype=x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant(x: torch.Tensor) -> torch.Tensor:
    """x after one int8 trip (``quantize_int8`` then ``dequantize_int8``:
    the two kernels on a CUDA tensor); its gradient passes straight
    through."""
    return _FakeQuant.apply(x)
