"""Fused topk_int8 wire for smashed data (``wire="topk_int8"``).

Replaces the Pallas TPU kernels of ``repro/kernels/wire.py``:
``sparsify_quant_pack`` (``_pack_kernel`` -> ``_pack_tile``) and
``unpack_dequant`` (``_unpack_dequant_kernel`` -> ``_unpack_tile``), with
the same signatures and bit-exact int32 words / dequantized floats.

Wire format per group of g values (exactly k survivors)::

    [ bitmap: ceil(g/32) words | scale: 1 word (f32 bitcast) |
      values: ceil(k/4) words, 4 int8 lanes each, survivor order ]

Bound on H100: bytes.  Pack reads 4 bytes per value and writes ~0.45
(words per group / g); unpack the reverse.  The pairwise rank costs g
comparisons per value (<= 128), still only a few microseconds of issue at
the main path's sizes.  The design keeps one group in one warp: values in
registers, |x| in a 512-byte per-warp shared row for the rank, the bitmap
as warp ballots, survivor slots by popcount, and value words assembled by
the first ceil(k/4) lanes from a per-warp shared byte row — so the dense
f32 group never round-trips through device memory and no block-level
synchronisation is needed.  Unpack is one warp per group with slots from
popcount.  At 0.5-4 MB per call launch overhead dominates.

The plain PyTorch versions (``repro_torch.core.compression``) run for CPU
tensors; CUDA tensors always go to the kernel (``kernels/csrc/codec.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.core import compression as C
from repro_torch.kernels.quant import (_check_group, _check_tensor, launch)

GROUP = C.GROUP
WIRE_K = C.WIRE_K


def sparsify_quant_pack(x: torch.Tensor, k_frac: float = WIRE_K,
                        group: int = GROUP) -> torch.Tensor:
    """x (..., d) f32 -> packed int32 wire buffer (..., ng*wpg)."""
    _check_tensor(x, "x", torch.float32)
    _check_group(group)
    if x.device.type == "cpu":
        return C.sparsify_quant_pack_ref(x, k_frac, group)
    *lead, d = x.shape
    g, ng, k, wpg = C.wire_layout(d, k_frac, group)
    buf = torch.empty((*lead, ng * wpg), dtype=torch.int32, device=x.device)
    launch("sparsify_quant_pack", x.device, x.data_ptr(), buf.data_ptr(),
           x.numel() // d, d, g, ng, k, wpg)
    return buf


def unpack_dequant(buf: torch.Tensor, d: int, k_frac: float = WIRE_K,
                   group: int = GROUP) -> torch.Tensor:
    """Packed buffer (..., ng*wpg) -> dense f32 (..., d)."""
    _check_tensor(buf, "buf", torch.int32)
    _check_group(group)
    g, ng, k, wpg = C.wire_layout(d, k_frac, group)
    *lead, words = buf.shape
    if words != ng * wpg:
        raise ValueError(f"buf trailing dim {words} != ng*wpg = {ng * wpg} "
                         f"for d={d}, k_frac={k_frac}, group={group}")
    if buf.device.type == "cpu":
        return C.wire_dequant_ref(buf, d, k_frac, group)
    x = torch.empty((*lead, d), dtype=torch.float32, device=buf.device)
    launch("unpack_dequant", buf.device, buf.data_ptr(), x.data_ptr(),
           buf.numel() // words, d, g, ng, k, wpg)
    return x
