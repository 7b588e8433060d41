"""Multi-head Latent Attention of the LM lane (twin of
``repro.models.mla``; DeepSeek-V2).  The KV cache stores only the
compressed latent ``c_kv`` (kv_lora_rank) and the shared rotary key
(qk_rope_dim); decode uses the absorbed formulation (``q_nope`` absorbed
through ``w_uk``, so scores are taken directly against the latent cache).

The einsum layouts are the reference's: ``wq (d, h, qk)``, ``w_dkv (d,
r)``, ``w_kr (d, rope)``, ``w_uk (r, h, nope)``, ``w_uv (r, h, v)``, ``wo
(h, v, d)``.  ``kv_norm`` normalises the latent with the rmsnorm kernel.
The attention itself is plain PyTorch, as the reference computes it with
einsums outside any Pallas kernel.

Two departures from the reference, neither of them in the values:
:func:`mla_prefill` computes the latents once and reuses them for the
cache (the reference computes them twice on the same inputs), and
:func:`mla_decode` writes the new latent into the cache tensors in place
(the reference returns new arrays), as the attention decode does.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import NEG_INF

Params = Dict[str, Any]


def init_mla(gen: torch.Generator, cfg: ArchConfig,
             dtype=torch.float32) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    s = 1.0 / math.sqrt(d)
    sr = 1.0 / math.sqrt(m.kv_lora_rank)
    return {
        "wq": L.trunc_normal(gen, (d, h, qk), s, dtype),
        "w_dkv": L.trunc_normal(gen, (d, m.kv_lora_rank), s, dtype),
        "w_kr": L.trunc_normal(gen, (d, m.qk_rope_dim), s, dtype),
        "kv_norm": L.init_rmsnorm(m.kv_lora_rank, dtype, gen.device),
        "w_uk": L.trunc_normal(gen, (m.kv_lora_rank, h, m.qk_nope_dim), sr,
                               dtype),
        "w_uv": L.trunc_normal(gen, (m.kv_lora_rank, h, m.v_head_dim), sr,
                               dtype),
        "wo": L.trunc_normal(gen, (h, m.v_head_dim, d),
                             1.0 / math.sqrt(h * m.v_head_dim), dtype),
    }


def _latents(p: Params, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """(c_kv (b, s, r) through kv_norm, k_rope (b, s, rope) rotated)."""
    c_kv = L.rmsnorm(p["kv_norm"], x @ p["w_dkv"].to(x.dtype))
    # (b, s, rope) has no head axis: the angles (s, half) broadcast
    k_rope = L.apply_rope(x @ p["w_kr"].to(x.dtype), positions,
                          cfg.rope_theta)
    return c_kv, k_rope


def _queries(p: Params, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor):
    m = cfg.mla
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _scale(cfg: ArchConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim)


def _attend(p: Params, cfg: ArchConfig, x: torch.Tensor,
            positions: torch.Tensor, c_kv: torch.Tensor,
            k_rope: torch.Tensor) -> torch.Tensor:
    """Causal attention over materialised K / V from the latents (the
    reference's train / prefill path)."""
    q_nope, q_rope = _queries(p, cfg, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"].to(x.dtype))
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uv"].to(x.dtype))
    scores = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
              + torch.einsum("bshk,btk->bhst", q_rope, k_rope)
              ).float() * _scale(cfg)
    mask = positions[None, :] <= positions[:, None]      # (s, t)
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bhst,bthk->bshk", probs, v)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))


def mla_train(p: Params, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Naive (materialised K/V) path for train / prefill."""
    c_kv, k_rope = _latents(p, cfg, x, positions)
    return _attend(p, cfg, x, positions, c_kv, k_rope)


def init_mla_cache(cfg: ArchConfig, batch: int, capacity: int,
                   dtype=torch.float32, device=None) -> Params:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, capacity, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, capacity, m.qk_rope_dim), dtype=dtype,
                              device=device),
        "pos": 0,
    }


def mla_prefill(p: Params, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, capacity: int
                ) -> Tuple[torch.Tensor, Params]:
    """:func:`mla_train`'s output and a cache holding the first
    ``min(s, capacity)`` latents, from one computation of the latents."""
    b, s, _ = x.shape
    c_kv, k_rope = _latents(p, cfg, x, positions)
    y = _attend(p, cfg, x, positions, c_kv, k_rope)
    cache = init_mla_cache(cfg, b, capacity, c_kv.dtype, x.device)
    n = min(s, capacity)
    cache["c_kv"][:, :n] = c_kv[:, :n]
    cache["k_rope"][:, :n] = k_rope[:, :n]
    cache["pos"] = s
    return y, cache


def mla_decode(p: Params, cfg: ArchConfig, x: torch.Tensor,
               cache: Params) -> Tuple[torch.Tensor, Params]:
    """Absorbed decode of one token, x (b, 1, d): scores against the latent
    cache, O(S * (r + rope)).  The new latent goes to slot
    ``min(pos, size - 1)`` in place; keys at slots <= pos attend.  Returns
    the cache tensors with ``pos + 1``."""
    pos = cache["pos"]
    # a fill on the device: torch.tensor([pos]) would copy from the host
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    c_new, kr_new = _latents(p, cfg, x, positions)
    c_all, kr_all = cache["c_kv"], cache["k_rope"]
    size = c_all.shape[1]
    slot = min(pos, size - 1)
    c_all[:, slot] = c_new[:, 0]
    kr_all[:, slot] = kr_new[:, 0]

    q_nope, q_rope = _queries(p, cfg, x, positions)
    # absorb: q' = q_nope @ W_uk -> (b, 1, h, r); scores vs the latents
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"].to(x.dtype))
    scores = (torch.einsum("bshr,btr->bhst", q_abs, c_all)
              + torch.einsum("bshk,btk->bhst", q_rope, kr_all)
              ).float() * _scale(cfg)
    kpos = torch.arange(size, device=x.device)
    scores = scores.masked_fill((kpos > pos)[None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhst,btr->bshr", probs, c_all)
    o = torch.einsum("bshr,rhk->bshk", o_lat, p["w_uv"].to(x.dtype))
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return y, {"c_kv": c_all, "k_rope": kr_all, "pos": pos + 1}


def mla_flops(cfg: ArchConfig, seq: int) -> int:
    """Per-token matmul FLOPs for one MLA layer at context ``seq``."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    proj = 2 * d * (h * qk + m.kv_lora_rank + m.qk_rope_dim) \
        + 2 * m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim) \
        + 2 * h * m.v_head_dim * d
    sdpa = 2 * 2 * h * qk * seq
    return proj + sdpa
