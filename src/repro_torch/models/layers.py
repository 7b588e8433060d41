"""Shared building blocks of the LM lane (twin of ``repro.models.layers``):
plain functions over dicts of tensors, the reference's parameter layout.

``trunc_normal`` draws with a ``torch.Generator``; its values differ from
the reference's threefry draw by construction, so parity tests carry the
reference's parameters over with :mod:`repro_torch.bridge`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as K

Params = Dict[str, Any]


_TRUNC = 2.0
# 2 * Phi(+-2) - 1: the uniform range whose erfinv is the normal on [-2, 2]
_U_HI = math.erf(_TRUNC / math.sqrt(2))
_U_LO = -_U_HI


def trunc_normal(gen: torch.Generator, shape, stddev: float,
                 dtype=torch.float32) -> torch.Tensor:
    """stddev * a standard normal truncated to [-2, 2] (inverse CDF of a
    uniform draw), drawn in float32 on the generator's device and cast once
    to ``dtype``; in place, so a leaf costs its float32 draw and its cast
    (command-r-35b's 2.1e9-value embedding: 8.4 GB and 4.2 GB)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    t.uniform_(_U_LO, _U_HI, generator=gen)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-_TRUNC, _TRUNC).mul_(stddev)
    return t.to(dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> Params:
    """Fan-in scaled dense kernel, no bias."""
    return {"w": trunc_normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in),
                              dtype)}


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].to(x.dtype)


def init_rmsnorm(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The rmsnorm kernel for a CUDA tensor, its plain version on the CPU."""
    return K.rmsnorm(x, p["scale"], eps)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMSNorm over the trailing head_dim of (..., head_dim), the
    same function as :func:`rmsnorm` (the rmsnorm kernel for a CUDA
    tensor)."""
    return K.rmsnorm(x.contiguous(), scale, eps)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, variant: str,
             dtype=torch.float32) -> Params:
    if variant in ("swiglu", "geglu"):
        return {"wi_gate": init_dense(gen, d_model, d_ff, dtype),
                "wi_up": init_dense(gen, d_model, d_ff, dtype),
                "wo": init_dense(gen, d_ff, d_model, dtype)}
    if variant == "gelu":
        return {"wi": init_dense(gen, d_model, d_ff, dtype),
                "wo": init_dense(gen, d_ff, d_model, dtype)}
    raise ValueError(variant)


def mlp(p: Params, x: torch.Tensor, variant: str) -> torch.Tensor:
    if variant == "swiglu":
        return dense(p["wo"], F.silu(dense(p["wi_gate"], x))
                     * dense(p["wi_up"], x))
    if variant == "geglu":
        return dense(p["wo"], F.gelu(dense(p["wi_gate"], x),
                                     approximate="tanh")
                     * dense(p["wi_up"], x))
    if variant == "gelu":
        return dense(p["wo"], F.gelu(dense(p["wi"], x), approximate="tanh"))
    raise ValueError(variant)


def mlp_flops(d_model: int, d_ff: int, variant: str) -> int:
    """matmul FLOPs per token (multiply-accumulate counted as 2)."""
    n_mats = 3 if variant in ("swiglu", "geglu") else 2
    return 2 * n_mats * d_model * d_ff


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, n_heads, head_dim) or (..., seq, head_dim);
    positions: broadcastable to (..., seq)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    angles = positions.to(torch.float32)[..., None] * freqs
    if x.dim() == angles.dim() + 2:       # a head axis between seq and dim
        angles = angles[..., None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """(..., seq) positions -> (..., seq, d_model): sines then cosines."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  true_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean token cross-entropy.  logits (..., V_pad), labels (...) int.
    Padded vocab entries (>= true_vocab) get -1e9 added, as in the
    reference."""
    return per_token_ce(logits, labels, true_vocab).mean()


def per_token_ce(logits: torch.Tensor, labels: torch.Tensor,
                 true_vocab: Optional[int] = None) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` per position, in float32,
    with the padded-vocab mask of :func:`cross_entropy`."""
    logits = logits.to(torch.float32)
    vpad = logits.shape[-1]
    if true_vocab is not None and true_vocab < vpad:
        mask = torch.cat([
            torch.zeros((true_vocab,), dtype=torch.float32,
                        device=logits.device),
            torch.full((vpad - true_vocab,), -1e9, dtype=torch.float32,
                       device=logits.device)])
        logits = logits + mask
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold
