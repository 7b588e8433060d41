"""Cut-boundary codec, plain PyTorch versions (twin of
``repro.core.compression``).

These functions are the plain versions behind the five CUDA kernels in
:mod:`repro_torch.kernels.quant` and :mod:`repro_torch.kernels.wire`: the
kernel wrappers run them for tensors on the CPU, and ``chip_smoke.py``
holds each kernel against them on the card.  They are bit-exact against the
JAX oracles (``tests/test_torch_codec.py``): same int8 values, same scales,
same int32 wire words, same dequantized floats.  The one product,
:func:`wire_dequant_matmul_ref`, has bit-exact slabs and leaves each
slab's sum order to the BLAS (``tests/test_torch_wire_matmul.py``).

Bit-exactness traps, each mirrored from the reference:

* the scale is ``max(amax, 1e-8) * INV127`` — a *multiply* by f32(1/127),
  never a division by 127;
* ``round(x / scale)`` is a true division followed by round-half-to-even
  (``torch.round``);
* value words put byte 3 into bits 24-31 of a *signed* int32 (the words are
  assembled in int64 and wrapped to int32);
* the scale word is the f32 bit pattern of the scale (a bitcast);
* top-k ranks by pairwise comparison with ties going to the lower index —
  never ``torch.topk``, whose tie order is unspecified;
* NaN and +-inf: the amax and the max with 1e-8 keep a NaN, so a group
  holding one has a NaN scale (+-inf: an inf scale); a NaN quotient is set
  to 0 before the int8 cast (XLA's cast); in the top-k a NaN is beaten by
  nothing and beats nothing, so it survives beside the k winners and its
  value slot (>= k) is dropped.

topk_int8 wire format per quantisation group of g values (exactly k
survivors):

    [ bitmap: ceil(g/32) words | scale: 1 word (f32 bitcast) |
      values: ceil(k/4) words, 4 int8 lanes each, survivor order ]
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

GROUP = 128  # quantisation group along the trailing axis
# scale = amax * f32(1/127): a multiply, as in the reference
INV127 = float(np.float32(1.0 / 127.0))
WIRE_SCHEMES = ("none", "int8", "topk_int8")
WIRE_K = 0.25  # default keep-fraction per group for topk_int8


def _group_shape(d: int, group: int) -> Tuple[int, int]:
    """(group size, group count): g = min(group, d), tail zero-padded."""
    g = min(group, max(d, 1))
    return g, -(-d // g)


def _grouped(x: torch.Tensor, group: int):
    """Zero-pad the trailing dim to the group boundary and reshape to
    (..., ng, g); returns (xg, g, ng, d)."""
    *lead, d = x.shape
    g, ng = _group_shape(d, group)
    pad = ng * g - d
    if pad:
        x = torch.cat([x, x.new_zeros((*lead, pad))], dim=-1)
    return x.reshape(*lead, ng, g), g, ng, d


def _scale_of(absx: torch.Tensor) -> torch.Tensor:
    """(..., ng, g) |x| -> (..., ng, 1) scale = max(amax, 1e-8) * INV127."""
    amax = absx.amax(dim=-1, keepdim=True)
    return torch.clamp_min(amax, 1e-8) * INV127


def _round_clip(xg: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to [-127, 127]; a NaN quotient (NaN scale,
    inf / inf) is 0, as XLA casts it, before any integer cast sees it."""
    r = torch.clamp(torch.round(xg / scale), -127, 127)
    return torch.where(torch.isnan(r), torch.zeros_like(r), r)


def quantize_int8(x: torch.Tensor, group: int = GROUP
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(trailing-)group symmetric int8: (q int8 (..., d), scales f32
    (..., ceil(d/g))).  A non-divisible trailing dim is zero-padded
    internally; the pad never changes a scale and is sliced off q."""
    xg, g, ng, d = _grouped(x, group)
    xg = xg.to(torch.float32)
    scale = _scale_of(xg.abs())
    q = _round_clip(xg, scale).to(torch.int8)
    lead = x.shape[:-1]
    return q.reshape(*lead, ng * g)[..., :d], scale[..., 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32,
                    group: int = GROUP) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`.  The group is min(group, d) unless
    the scale count says the producer used an exactly dividing custom
    group, which then wins (the reference's rule)."""
    *lead, d = q.shape
    ng = scale.shape[-1]
    g, ng_default = _group_shape(d, group)
    if ng != ng_default:
        g = d // ng
    pad = ng * g - d
    if pad:
        q = torch.cat([q, q.new_zeros((*lead, pad))], dim=-1)
    xg = q.reshape(*lead, ng, g).to(torch.float32) * scale[..., None]
    return xg.reshape(*lead, ng * g)[..., :d].to(dtype)


def effective_group(trailing_dim, group: int = GROUP):
    """The group size :func:`quantize_int8` uses for trailing dim d."""
    d = np.asarray(trailing_dim)
    return np.minimum(group, np.maximum(d, 1))


def compression_ratio(dtype_bytes: int = 4, group: int = GROUP,
                      trailing_dim: Optional[Union[int, np.ndarray]] = None
                      ) -> Union[float, np.ndarray]:
    """Bytes(fp) / bytes(int8 + f32 scale per group)."""
    if trailing_dim is None:
        return dtype_bytes * group / (group + 4.0)
    d = np.asarray(trailing_dim)
    g = effective_group(d, group)
    ng = -(-d // g)
    ratio = dtype_bytes * d / (d + 4.0 * ng)
    return float(ratio) if np.ndim(ratio) == 0 else ratio


# ---------------------------------------------------------- topk_int8 wire

def wire_layout(d: int, k_frac: float = WIRE_K, group: int = GROUP
                ) -> Tuple[int, int, int, int]:
    """(g, ng, k, words_per_group) for trailing dim ``d``."""
    g, ng = _group_shape(d, group)
    k = int(min(max(int(round(float(k_frac) * g)), 1), g))
    wpg = -(-g // 32) + 1 + -(-k // 4)
    return g, ng, k, wpg


def _topk_mask(absx: torch.Tensor, k: int) -> torch.Tensor:
    """Per-group top-k mask over the trailing axis by pairwise rank, ties
    to the lower index: element i is beaten by j when |x_j| > |x_i| or
    (|x_j| == |x_i| and j < i); it survives when fewer than k beat it."""
    g = absx.shape[-1]
    idx = torch.arange(g, device=absx.device)
    lower = idx[None, :] < idx[:, None]                 # [i, j]: j < i
    a_i = absx[..., :, None]
    a_j = absx[..., None, :]
    beats = (a_j > a_i) | ((a_j == a_i) & lower)
    return beats.sum(dim=-1) < k


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> the same bits as signed int32."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _pack_groups(q: torch.Tensor, scale: torch.Tensor, mask: torch.Tensor,
                 k: int) -> torch.Tensor:
    """(..., ng, g) q / (..., ng) scale / (..., ng, g) mask ->
    (..., ng, wpg) int32 words."""
    *lead, ng, g = q.shape
    bw, vw = -(-g // 32), -(-k // 4)
    m64 = mask.to(torch.int64)
    if bw * 32 - g:
        m64 = torch.cat([m64, m64.new_zeros((*lead, ng, bw * 32 - g))], -1)
    shifts = torch.arange(32, device=q.device, dtype=torch.int64)
    bitmap = (m64.reshape(*lead, ng, bw, 32) << shifts).sum(-1)
    # survivor compaction: the i-th masked value goes to slot i; slots >= k
    # (a NaN survives beside the k winners) go to the discard slot k
    pos = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    slot = torch.where(mask & (pos < k), pos, torch.full_like(pos, k))
    vals = q.new_zeros((*lead, ng, k + 1), dtype=torch.int64)
    vals.scatter_(-1, slot, q.to(torch.int64))
    vals = vals[..., :k]
    if vw * 4 - k:
        vals = torch.cat([vals, vals.new_zeros((*lead, ng, vw * 4 - k))], -1)
    lanes = 8 * torch.arange(4, device=q.device, dtype=torch.int64)
    words = ((vals.reshape(*lead, ng, vw, 4) & 0xFF) << lanes).sum(-1)
    sword = scale.to(torch.float32).contiguous().view(torch.int32)
    return torch.cat([_wrap_int32(bitmap), sword[..., None],
                      _wrap_int32(words)], dim=-1)


def _unpack_groups(buf: torch.Tensor, g: int, k: int):
    """(..., ng, wpg) int32 -> (q int32 (..., ng, g), scale (..., ng),
    mask bool (..., ng, g)).  Exact inverse of :func:`_pack_groups`."""
    *lead, ng, _ = buf.shape
    bw = -(-g // 32)
    bitmap = buf[..., :bw]
    scale = buf[..., bw].contiguous().view(torch.float32)
    words = buf[..., bw + 1:]
    shifts = torch.arange(32, device=buf.device, dtype=torch.int32)
    mask = ((bitmap[..., None] >> shifts) & 1).reshape(
        *lead, ng, bw * 32)[..., :g].to(torch.bool)
    lanes = 8 * torch.arange(4, device=buf.device, dtype=torch.int32)
    vals = ((words[..., None] >> lanes) & 0xFF).reshape(*lead, ng, -1)[..., :k]
    vals = vals - 256 * (vals > 127).to(torch.int32)       # sign-extend
    pos = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    q = torch.gather(vals, -1, pos.clamp(0, k - 1))
    q = torch.where(mask & (pos < k), q, torch.zeros_like(q))
    return q, scale, mask


def sparsify_topk_int8(x: torch.Tensor, k_frac: float = WIRE_K,
                       group: int = GROUP):
    """Top-k sparsify + int8 quantise: (q int8 (..., d) zero off-mask,
    scales f32 (..., ng), mask bool (..., d))."""
    xg, g, ng, d = _grouped(x, group)
    k = wire_layout(d, k_frac, group)[2]
    xg = xg.to(torch.float32)
    absx = xg.abs()
    scale = _scale_of(absx)
    mask = _topk_mask(absx, k)
    q = torch.where(mask, _round_clip(xg, scale), torch.zeros_like(xg))
    lead = x.shape[:-1]
    return (q.to(torch.int8).reshape(*lead, ng * g)[..., :d],
            scale[..., 0],
            mask.reshape(*lead, ng * g)[..., :d])


def sparsify_quant_pack_ref(x: torch.Tensor, k_frac: float = WIRE_K,
                            group: int = GROUP) -> torch.Tensor:
    """x (..., d) -> packed wire buffer int32 (..., ng*wpg)."""
    xg, g, ng, d = _grouped(x, group)
    k, wpg = wire_layout(d, k_frac, group)[2:]
    xg = xg.to(torch.float32)
    absx = xg.abs()
    scale = _scale_of(absx)
    mask = _topk_mask(absx, k)
    q = torch.where(mask, _round_clip(xg, scale), torch.zeros_like(xg))
    buf = _pack_groups(q.to(torch.int32), scale[..., 0], mask, k)
    return buf.reshape(*x.shape[:-1], ng * wpg)


def unpack_wire(buf: torch.Tensor, d: int, k_frac: float = WIRE_K,
                group: int = GROUP):
    """Packed buffer (..., ng*wpg) -> (q int8 (..., d), scales (..., ng),
    mask bool (..., d))."""
    g, ng, k, wpg = wire_layout(d, k_frac, group)
    *lead, _ = buf.shape
    q, scale, mask = _unpack_groups(buf.reshape(*lead, ng, wpg), g, k)
    return (q.to(torch.int8).reshape(*lead, ng * g)[..., :d],
            scale,
            mask.reshape(*lead, ng * g)[..., :d])


def wire_dequant_ref(buf: torch.Tensor, d: int, k_frac: float = WIRE_K,
                     group: int = GROUP,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Packed buffer -> dense (..., d): unpack + dequantise."""
    q, scale, _ = unpack_wire(buf, d, k_frac, group)
    return dequantize_int8(q, scale, dtype, group)


def dequant_slab(q: torch.Tensor, scale: torch.Tensor, j: int
                 ) -> torch.Tensor:
    """Group ``j`` of unpacked groups (q (rows, ng, g), scale (rows, ng))
    as a dense f32 (rows, g) slab."""
    return q[:, j].to(torch.float32) * scale[:, j, None]


def wire_dequant_matmul_ref(buf: torch.Tensor, w: torch.Tensor,
                            k_frac: float = WIRE_K, group: int = GROUP
                            ) -> torch.Tensor:
    """Packed buffer (rows, ng*wpg) @ w (d, n) -> (rows, n) f32, one g-wide
    slab per group accumulated in group order (the reference's order), so
    the dense smashed tensor is never formed at full width.  A ragged last
    group meets zero rows of ``w``."""
    d, n = w.shape
    g, ng, k, wpg = wire_layout(d, k_frac, group)
    rows = buf.shape[0]
    q, scale, _ = _unpack_groups(buf.reshape(rows, ng, wpg), g, k)
    pad = ng * g - d
    wp = torch.cat([w, w.new_zeros((pad, n))]) if pad else w
    wg = wp.reshape(ng, g, n).to(torch.float32)
    acc = torch.zeros((rows, n), dtype=torch.float32, device=buf.device)
    for j in range(ng):
        acc = acc + dequant_slab(q, scale, j) @ wg[j]
    return acc


def wire_topk_dense(x: torch.Tensor, k_frac: float = WIRE_K,
                    group: int = GROUP) -> torch.Tensor:
    """Dense value after one wire trip: sparsify -> quantise -> dequantise."""
    q, s, _ = sparsify_topk_int8(x, k_frac, group)
    return dequantize_int8(q, s, x.dtype, group)


# ------------------------------------------------------- byte accounting

def wire_row_bytes(trailing_dim, k_frac: float = WIRE_K, group: int = GROUP):
    """Packed topk_int8 bytes for one row of trailing dim d."""
    d = np.asarray(trailing_dim)
    g = effective_group(d, group)
    ng = -(-d // g)
    k = np.clip(np.round(k_frac * g).astype(np.int64), 1, g)
    wpg = -(-g // 32) + 1 + -(-k // 4)
    out = 4.0 * ng * wpg
    return float(out) if np.ndim(out) == 0 else out


def wire_compression_ratio(wire: str = "topk_int8", dtype_bytes: int = 4,
                           group: int = GROUP, trailing_dim=None,
                           k_frac: float = WIRE_K):
    """Dense-fp bytes / wire bytes for a scheme (both directions)."""
    if wire not in WIRE_SCHEMES:
        raise ValueError(f"unknown wire scheme {wire!r}; one of "
                         f"{WIRE_SCHEMES}")
    if wire == "none":
        return 1.0
    if wire == "int8":
        return compression_ratio(dtype_bytes, group, trailing_dim)
    d = np.asarray(group if trailing_dim is None else trailing_dim)
    ratio = dtype_bytes * d / wire_row_bytes(d, k_frac, group)
    return float(ratio) if np.ndim(ratio) == 0 else ratio
