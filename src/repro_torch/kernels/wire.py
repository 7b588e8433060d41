"""Fused topk_int8 wire for smashed data (``wire="topk_int8"``).

Replaces the Pallas TPU kernels of ``repro/kernels/wire.py``:
``sparsify_quant_pack`` (``_pack_kernel`` -> ``_pack_tile``) and
``unpack_dequant`` (``_unpack_dequant_kernel`` -> ``_unpack_tile``), with
the same signatures and bit-exact int32 words / dequantized floats; and
``unpack_dequant_matmul`` (``_unpack_matmul_kernel``), the RSU's first
matmul reading the packed buffer itself, with the same signature and an
f32 result whose slabs are exact and whose sums are in another order.

Dtypes, as the reference's kernels: ``sparsify_quant_pack`` takes x and
``unpack_dequant_matmul`` takes w in float32, bfloat16 or float16, each
widened to f32 exactly as the kernel reads it (so the words are those of
``x.float()``, and kernel 5's f32 output that of ``w.float()``);
``unpack_dequant`` returns the ``dtype`` it is asked for, the f32 product
rounded once to nearest even.  Any other dtype raises ``TypeError``.

Wire format per group of g values (exactly k survivors)::

    [ bitmap: ceil(g/32) words | scale: 1 word (f32 bitcast) |
      values: ceil(k/4) words, 4 int8 lanes each, survivor order ]

Bound on H100: bytes.  Pack reads 4 bytes per value and writes ~0.45
(words per group / g); unpack the reverse.  The design keeps one group in
one warp, values in registers.  Pack selects its exactly-k survivors by a
radix select over the bits of |x| with warp ballots: the k-th largest key
T is found bit by bit from the top (one compare per held value, one ballot
per 32 values and popcounts a bit, stopping once a candidate's count is
exactly k), then keys above T survive and keys equal to T by their rank in
index order (popcounts of the ``eq`` ballots) — so no value is compared
with every other value of its group.  The bitmap is the survivors'
ballots, slots come by popcount, and the first ceil(k/4) lanes assemble
the value words from a per-warp shared byte row: the dense f32 group never
round-trips through device memory and no block-level synchronisation is
needed.  Unpack is one warp per group: one coalesced load of the group's
words, then bitmap, scale and value words by warp shuffles and slots by
popcounts (the decode kernel 5 shares), so no load waits on another.  At
0.5-4 MB per call launch overhead dominates.

``unpack_dequant_matmul`` gives each block of 128 threads a 16 row by 64
column output tile when that still gives every SM a block, else an 8 row
one.  Per group it starts the w slab's copy to shared memory
(``cp.async``) first; meanwhile each warp reads its rows' group words with
one coalesced load per row and decodes them by warp shuffles into a
shared g-wide slab; after one barrier each thread sums its register patch
over the group in order.  The next group's copy and words are in flight
while a group computes.

Non-finite input.  For any input (NaN, +-inf, +-0.0 and subnormals
included, in every input dtype; a bf16 or f16 NaN widens to an f32 NaN)
the kernels and the plain versions follow the reference: bitmap and value
words bit for bit; scale words bit for bit where the reference's
scale is finite or +-inf and NaN exactly where it is NaN (payloads aside:
XLA keeps the input's, torch and CUDA canonicalise it); ``unpack_dequant``'s
floats equal, NaN where they are NaN, and ``unpack_dequant_matmul``'s
output NaN where the plain version's is (a NaN or inf scale makes the
group's survivors NaN).  A group holding a NaN has a NaN scale, one holding
+-inf an inf scale, and every int8 of it is 0, so it decodes to NaN.  In
the top-k a NaN is beaten by nothing and beats nothing: each NaN survives
beside the k winners, its bit set and its value slot (>= k) dropped.  On
the reference's side XLA on the CPU compares subnormals as zero, so on a
group of zeros and subnormals its bitmap may keep other zero-valued
positions than the port's; the values and dequantized floats agree.

The plain PyTorch versions (``repro_torch.core.compression``) run for CPU
tensors; CUDA tensors always go to the kernel (``kernels/csrc/codec.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.core import compression as C
from repro_torch.kernels.quant import (FLOAT_CODES, _check_group,
                                       _check_tensor, float_code, launch)

GROUP = C.GROUP
WIRE_K = C.WIRE_K


def sparsify_quant_pack(x: torch.Tensor, k_frac: float = WIRE_K,
                        group: int = GROUP) -> torch.Tensor:
    """x (..., d) f32 / bf16 / f16 -> packed int32 wire buffer (...,
    ng*wpg), under the non-finite contract above (exact ties go to the
    lower index)."""
    _check_tensor(x, "x", FLOAT_CODES)
    _check_group(group)
    if x.device.type == "cpu":
        return C.sparsify_quant_pack_ref(x, k_frac, group)
    *lead, d = x.shape
    g, ng, k, wpg = C.wire_layout(d, k_frac, group)
    buf = torch.empty((*lead, ng * wpg), dtype=torch.int32, device=x.device)
    launch("sparsify_quant_pack", x.device, x.data_ptr(), buf.data_ptr(),
           x.numel() // d, d, g, ng, k, wpg, FLOAT_CODES[x.dtype])
    return buf


def unpack_dequant(buf: torch.Tensor, d: int, k_frac: float = WIRE_K,
                   group: int = GROUP,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Packed buffer (..., ng*wpg) -> dense ``dtype`` (..., d) (f32, bf16
    or f16)."""
    code = float_code(dtype)
    _check_tensor(buf, "buf", torch.int32)
    _check_group(group)
    g, ng, k, wpg = C.wire_layout(d, k_frac, group)
    *lead, words = buf.shape
    if words != ng * wpg:
        raise ValueError(f"buf trailing dim {words} != ng*wpg = {ng * wpg} "
                         f"for d={d}, k_frac={k_frac}, group={group}")
    if buf.device.type == "cpu":
        return C.wire_dequant_ref(buf, d, k_frac, group, dtype)
    x = torch.empty((*lead, d), dtype=dtype, device=buf.device)
    launch("unpack_dequant", buf.device, buf.data_ptr(), x.data_ptr(),
           buf.numel() // words, d, g, ng, k, wpg, code)
    return x


def unpack_dequant_matmul(buf: torch.Tensor, w: torch.Tensor,
                          k_frac: float = WIRE_K, group: int = GROUP
                          ) -> torch.Tensor:
    """Packed buffer (rows, ng*wpg) int32 @ w (d, n) f32 / bf16 / f16 ->
    (rows, n) f32, dequantizing one g-wide slab at a time inside the
    product: the dense (rows, d) tensor is never formed."""
    _check_tensor(buf, "buf", torch.int32)
    _check_tensor(w, "w", FLOAT_CODES)
    _check_group(group)
    if buf.dim() != 2 or w.dim() != 2:
        raise ValueError(f"buf must be (rows, words) and w (d, n), got "
                         f"{tuple(buf.shape)} and {tuple(w.shape)}")
    if buf.device != w.device:
        raise ValueError("buf and w must be on the same device")
    d, n = w.shape
    g, ng, k, wpg = C.wire_layout(d, k_frac, group)
    rows, words = buf.shape
    if words != ng * wpg:
        raise ValueError(f"buf trailing dim {words} != ng*wpg = {ng * wpg} "
                         f"for d={d}, k_frac={k_frac}, group={group}")
    if buf.device.type == "cpu":
        return C.wire_dequant_matmul_ref(buf, w, k_frac, group)
    out = torch.empty((rows, n), dtype=torch.float32, device=buf.device)
    launch("unpack_dequant_matmul", buf.device, buf.data_ptr(), w.data_ptr(),
           out.data_ptr(), rows, d, n, g, ng, k, wpg, FLOAT_CODES[w.dtype])
    return out


class _DequantMatmul(torch.autograd.Function):
    """:func:`unpack_dequant_matmul` with a gradient for ``w``.  The
    forward saves the int32 buffer and ``w`` only, never an f32 tensor of
    the smashed shape; the backward unpacks the buffer again (the
    ``unpack_dequant`` kernel) for ``dW = dense(buf)^T @ g``.  The buffer
    has no gradient: the caller takes the cut-layer gradient ``g @ w^T``
    from the gradient at this function's output."""

    @staticmethod
    def forward(ctx, buf, w, k_frac, group):
        ctx.save_for_backward(buf, w)
        ctx.k_frac, ctx.group = k_frac, group
        return unpack_dequant_matmul(buf, w, k_frac, group)

    @staticmethod
    def backward(ctx, g):
        buf, w = ctx.saved_tensors
        dense = unpack_dequant(buf, w.shape[0], ctx.k_frac, ctx.group)
        return None, dense.t() @ g, None, None


def dequant_matmul(buf: torch.Tensor, w: torch.Tensor,
                   k_frac: float = WIRE_K, group: int = GROUP
                   ) -> torch.Tensor:
    """Differentiable (in ``w``) :func:`unpack_dequant_matmul`."""
    return _DequantMatmul.apply(buf, w, k_frac, group)
