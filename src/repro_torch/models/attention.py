"""Attention of the LM lane (twin of ``repro.models.attention``): GQA,
qk-norm, causal + sliding-window masks, KV-cache decode.

Training and prefill run the flash kernel
(:mod:`repro_torch.kernels.flash_attention`, differentiable: its backward
is the flash backward kernel), where query and key positions are both
``arange(s)``.  Decode — one query
against a cache with ``k_pos`` and ring slots — stays the plain
:func:`_sdpa`, as the reference computes it outside any Pallas kernel.

The einsum layouts are the reference's: ``wq (d, h, hd)``, ``wk / wv
(d, kv, hd)``, ``wo (h, hd, d)``.  qk-norm scales ``q_norm`` / ``k_norm``
(hd,) normalise q and k over head_dim with the rmsnorm kernel.

Decode writes the new key and value into the cache tensors in place (the
reference returns new arrays): a copy of every layer's cache per generated
token would move the whole cache once per step.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L

Params = Dict[str, Any]
NEG_INF = -2.0e38


def init_attn(gen: torch.Generator, cfg: ArchConfig,
              dtype=torch.float32) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": L.trunc_normal(gen, (d, h, hd), 1.0 / math.sqrt(d), dtype),
        "wk": L.trunc_normal(gen, (d, kv, hd), 1.0 / math.sqrt(d), dtype),
        "wv": L.trunc_normal(gen, (d, kv, hd), 1.0 / math.sqrt(d), dtype),
        "wo": L.trunc_normal(gen, (h, hd, d), 1.0 / math.sqrt(h * hd),
                             dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return p


def _qkv(p: Params, cfg: ArchConfig, x: torch.Tensor,
         positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dnk->bsnk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dnk->bsnk", x, p["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = L.rms_head_norm(p["q_norm"], q)
        k = L.rms_head_norm(p["k_norm"], k)
    if cfg.pos == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, q_pos, k_pos, window: int, scale: float):
    """One score block (plain).  q (b,sq,n,g,hd), k/v (b,sk,n,hd),
    q_pos (sq,), k_pos (sk,) — k_pos < 0 marks invalid slots."""
    s = torch.einsum("bsngh,btnh->bngst", q, k).float() * scale
    mask = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] >= 0)
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # rows with no valid key produce uniform junk; zero them
    p = torch.where(mask.any(dim=-1)[:, None], p, 0.0).to(v.dtype)
    return torch.einsum("bngst,btnh->bsngh", p, v)


def _full_attention(q, k, v, window: int):
    """Causal self-attention with q and k positions both ``arange(s)``:
    the flash kernel for CUDA tensors, its plain version on the CPU."""
    return FA.flash_attention(q, k, v, causal=True, window=window)


def attn_train(p: Params, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Causal self-attention over the full sequence (no cache)."""
    q, k, v = _qkv(p, cfg, x, positions)
    o = _full_attention(q, k, v, window)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))


def attn_flops(cfg: ArchConfig, seq: int, window: int = 0) -> int:
    """Per-token matmul FLOPs for one attention layer at context ``seq``."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    proj = 2 * d * hd * (2 * h + 2 * kv)
    ctx = min(seq, window) if window > 0 else seq
    sdpa = 2 * 2 * h * hd * ctx  # qk + pv
    return proj + sdpa


def init_cache(cfg: ArchConfig, batch: int, capacity: int, window: int,
               dtype=torch.float32, device=None) -> Params:
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    size = min(window, capacity) if window > 0 else capacity
    return {
        "k": torch.zeros((batch, size, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, kv, hd), dtype=dtype, device=device),
        "k_pos": torch.full((size,), -1, dtype=torch.int32, device=device),
        "pos": 0,
    }


def attn_prefill(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, capacity: int,
                 window: int = 0) -> Tuple[torch.Tensor, Params]:
    """Full-sequence attention that also returns a filled KV cache."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    o = _full_attention(q, k, v, window)
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    cache = init_cache(cfg, b, capacity, window, k.dtype, x.device)
    size = cache["k"].shape[1]
    if window > 0 and s >= size:
        # ring buffer: slot of position p is p % size
        shift = s % size
        cache["k"] = torch.roll(k[:, s - size:], shift, dims=1)
        cache["v"] = torch.roll(v[:, s - size:], shift, dims=1)
        kp = torch.arange(s - size, s, dtype=torch.int32, device=x.device)
        cache["k_pos"] = torch.roll(kp, shift, dims=0)
    else:
        n = min(s, size)
        cache["k"][:, :n] = k[:, :n]
        cache["v"][:, :n] = v[:, :n]
        cache["k_pos"][:n] = torch.arange(n, dtype=torch.int32,
                                          device=x.device)
    cache["pos"] = s
    return y, cache


def attn_decode(p: Params, cfg: ArchConfig, x: torch.Tensor,
                cache: Params, window: int = 0
                ) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  x (b, 1, d).  Updates the cache tensors in
    place and returns them with ``pos + 1``."""
    b = x.shape[0]
    pos = cache["pos"]
    # a fill on the device: torch.tensor([pos]) would copy from the host
    # and wait for the stream once per layer
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    size = cache["k"].shape[1]
    slot = pos % size if window > 0 else min(pos, size - 1)
    ck, cv, kp = cache["k"], cache["v"], cache["k_pos"]
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    kp[slot] = pos
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    qh = q.reshape(b, 1, kvh, h // kvh, hd)
    o = _sdpa(qh, ck, cv, positions, kp, window, 1.0 / math.sqrt(hd))
    o = o.reshape(b, 1, h, hd)
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return y, {"k": ck, "v": cv, "k_pos": kp, "pos": pos + 1}
