"""RG-LRU recurrent block of the LM lane (twin of ``repro.models.rglru``;
Griffin / RecurrentGemma, arXiv:2402.19427).

Block: x -> {gate branch: linear + GeLU} x {recurrent branch: linear ->
causal conv1d (width 4) -> RG-LRU} -> output linear.  The linear recurrence
h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t) runs over the sequence in
train and prefill as a log-depth scan in float32, and as one step in
decode; the state is constant-size.

The reference evaluates the recurrence with ``jax.lax.associative_scan``,
outside any Pallas kernel.  The port's :func:`_linear_scan` is plain
PyTorch: Hillis-Steele doubling over the pairs (a, h) with the
reference's combine ``(a_l a_r, a_r h_l + h_r)``, ceil(log2 s) steps (10
at s = 1024), each a few elementwise kernels over the whole sequence.  The
sums are taken in another order than the reference's tree, so the two
agree to float32 rounding.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


def _d_rnn(cfg: ArchConfig) -> int:
    return cfg.rglru.d_rnn or cfg.d_model


def init_rglru(gen: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32) -> Params:
    r = cfg.rglru
    d, dr = cfg.d_model, _d_rnn(cfg)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "w_gate": L.init_dense(gen, d, dr, dtype),
        "w_x": L.init_dense(gen, d, dr, dtype),
        "conv_w": L.trunc_normal(gen, (r.d_conv, dr),
                                 1.0 / math.sqrt(r.d_conv), dtype),
        "conv_b": torch.zeros((dr,), dtype=dtype, device=dev),
        "w_a": L.trunc_normal(gen, (dr, dr), 1.0 / math.sqrt(dr), dtype),
        "b_a": torch.zeros((dr,), **f32),
        "w_i": L.trunc_normal(gen, (dr, dr), 1.0 / math.sqrt(dr), dtype),
        "b_i": torch.zeros((dr,), **f32),
        # Lambda init so a = sigmoid(L)^(c r) gives decay ~0.9..0.999
        "lam": torch.linspace(2.0, 7.0, dr, **f32),
        "w_out": L.init_dense(gen, dr, d, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x (b, s, c), w (width, c)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    y = torch.zeros_like(x)
    for i in range(width):
        y = y + pad[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
    return y + b.to(x.dtype)


def _gates(p: Params, cfg: ArchConfig, xr: torch.Tensor):
    """Returns (a, gated input) of the recurrence, float32."""
    r32 = xr.float()
    rgate = torch.sigmoid(r32 @ p["w_a"].float() + p["b_a"])
    igate = torch.sigmoid(r32 @ p["w_i"].float() + p["b_i"])
    log_a = cfg.rglru.c_exponent * rgate * F.logsigmoid(p["lam"])
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-6)) \
        * (igate * r32)
    return a, gated


def _linear_scan(a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t h_{t-1} + h_t along dim 1 (Hillis-Steele
    doubling; no in-place writes, so autograd can run through it)."""
    s = a.shape[1]
    off = 1
    while off < s:
        h = torch.cat([h[:, :off], a[:, off:] * h[:, :-off] + h[:, off:]],
                      dim=1)
        if 2 * off < s:         # the last step reads no further products
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return h


def rglru_seq(p: Params, cfg: ArchConfig, xr: torch.Tensor,
              h0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear recurrence over the sequence.  xr (b, s, dr) post-conv;
    returns (h (b, s, dr) in xr's dtype, final state (b, dr) float32)."""
    a, gated = _gates(p, cfg, xr)
    if h0 is not None:
        # fold the incoming state in as a virtual step 0
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        gated = torch.cat([h0[:, None].float(), gated], dim=1)
    hv = _linear_scan(a, gated)
    if h0 is not None:
        hv = hv[:, 1:]
    return hv.to(xr.dtype), hv[:, -1]


def _rglru_full(p: Params, cfg: ArchConfig, x: torch.Tensor, h0):
    gate = F.gelu(L.dense(p["w_gate"], x), approximate="tanh")
    xr = L.dense(p["w_x"], x)
    xr_conv = _causal_conv(xr, p["conv_w"], p["conv_b"])
    h, h_last = rglru_seq(p, cfg, xr_conv, h0)
    return L.dense(p["w_out"], gate * h), (xr, h_last)


def rglru_train(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return _rglru_full(p, cfg, x, None)[0]


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None) -> Params:
    dr = _d_rnn(cfg)
    return {
        "conv": torch.zeros((batch, cfg.rglru.d_conv - 1, dr), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, dr), dtype=torch.float32,
                             device=device),
        "pos": 0,
    }


def rglru_prefill(p: Params, cfg: ArchConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Params]:
    y, (xr_pre, h_last) = _rglru_full(p, cfg, x, None)
    # a copy: a view would keep the whole (b, s, dr) projection alive
    conv = xr_pre[:, -(cfg.rglru.d_conv - 1):, :].clone()
    return y, {"conv": conv, "state": h_last.float(), "pos": x.shape[1]}


def rglru_decode(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 cache: Params) -> Tuple[torch.Tensor, Params]:
    """One step (plain).  x (b, 1, d)."""
    gate = F.gelu(L.dense(p["w_gate"], x), approximate="tanh")   # (b,1,dr)
    xr = L.dense(p["w_x"], x)
    window = torch.cat([cache["conv"], xr], dim=1)
    conv_out = (torch.einsum("bwc,wc->bc", window, p["conv_w"].to(x.dtype))
                + p["conv_b"].to(x.dtype))[:, None, :]
    a, gated = _gates(p, cfg, conv_out)
    h = a[:, 0] * cache["state"] + gated[:, 0]
    y = L.dense(p["w_out"], gate * h[:, None].to(x.dtype))
    return y, {"conv": window[:, 1:], "state": h, "pos": cache["pos"] + 1}


def rglru_flops(cfg: ArchConfig) -> int:
    d, dr = cfg.d_model, _d_rnn(cfg)
    return (2 * d * dr * 3 + 2 * dr * dr * 2 + 2 * cfg.rglru.d_conv * dr
            + 10 * dr)
