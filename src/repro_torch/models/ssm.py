"""Mamba2 block of the LM lane (twin of ``repro.models.ssm``): SSD,
state-space duality (arXiv:2405.21060).

Training and prefill run the chunked SSD through the ``ssd_chunk_scan``
kernel (:mod:`repro_torch.kernels.ssd`, differentiable: its backward is
the plain version's), which also returns the final state the prefill
cache keeps (training drops it); the gated norm ``rmsnorm(y * silu(z))`` over d_inner runs the
rmsnorm kernel.  Decode is the plain one-step recurrence over the constant-
size (heads, d_state, head_dim) state.  The in-projection is the
reference's fused one (``SSMConfig.fused_proj=True``, what every arch
uses).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ssd as K
from repro_torch.kernels.ssd import ssd_chunked  # noqa: F401  (the twin)
from repro_torch.models import layers as L

Params = Dict[str, Any]


def dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def init_ssm(gen: torch.Generator, cfg: ArchConfig,
             dtype=torch.float32) -> Params:
    s = cfg.ssm
    d_inner, n_heads, conv_dim = dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": L.init_dense(gen, cfg.d_model, d_in_proj, dtype),
        "conv_w": L.trunc_normal(gen, (s.d_conv, conv_dim),
                                 1.0 / math.sqrt(s.d_conv), dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        "D": torch.ones((n_heads,), **f32),
        "dt_bias": torch.log(torch.expm1(
            torch.linspace(1e-3, 1e-1, n_heads, **f32))),
        "norm": L.init_rmsnorm(d_inner, dtype, dev),
        "out_proj": L.init_dense(gen, d_inner, cfg.d_model, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x (b,s,c), w (width,c)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    y = torch.zeros_like(x)
    for i in range(width):
        y = y + pad[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
    return y + b.to(x.dtype)


def _split_proj(p: Params, cfg: ArchConfig, u: torch.Tensor):
    """Returns (z, xBC before the conv, dt) as views of one projection."""
    d_inner, _, conv_dim = dims(cfg)
    zxbcdt = L.dense(p["in_proj"], u)
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:d_inner + conv_dim],
            zxbcdt[..., d_inner + conv_dim:])


def _conv_xbc(p: Params, cfg: ArchConfig, xBC: torch.Tensor) -> torch.Tensor:
    """Causal conv + silu over the xBC streams."""
    return F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))


def _unpack_xbc(cfg: ArchConfig, xBC: torch.Tensor):
    """Views x (..., h, p), B and C (..., g, n) of xBC (no copies: the
    kernel reads them through their strides)."""
    s = cfg.ssm
    d_inner, n_heads, _ = dims(cfg)
    gn = s.n_groups * s.d_state
    lead = xBC.shape[:-1]
    x = xBC[..., :d_inner].reshape(*lead, n_heads, s.head_dim)
    B = xBC[..., d_inner:d_inner + gn].reshape(*lead, s.n_groups, s.d_state)
    C = xBC[..., d_inner + gn:].reshape(*lead, s.n_groups, s.d_state)
    return x, B, C


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
                   device=None) -> Params:
    s = cfg.ssm
    _, n_heads, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, n_heads, s.d_state, s.head_dim),
                             dtype=torch.float32, device=device),
        "pos": 0,
    }


def ssm_train(p: Params, cfg: ArchConfig, u: torch.Tensor) -> torch.Tensor:
    return _ssm_full_keep(p, cfg, u)[0]


def ssm_prefill(p: Params, cfg: ArchConfig, u: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    y, (xBC_pre, state) = _ssm_full_keep(p, cfg, u)
    # a copy: a view would keep the whole (b, s, conv_dim) projection alive
    conv = xBC_pre[:, -(cfg.ssm.d_conv - 1):, :].clone()
    return y, {"conv": conv, "state": state, "pos": u.shape[1]}


def _ssm_full_keep(p: Params, cfg: ArchConfig, u: torch.Tensor):
    """The block over a full sequence; also returns the *pre-conv* xBC (for
    the conv cache) and the SSD's final state."""
    z, xBC_pre, dt = _split_proj(p, cfg, u)
    xBC = _conv_xbc(p, cfg, xBC_pre)
    x, B, C = _unpack_xbc(cfg, xBC)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = K.ssd_chunk_scan(x, dt, A, B, C, chunk=cfg.ssm.chunk)
    y = y + x * p["D"][:, None].to(x.dtype)
    b, sl = u.shape[0], u.shape[1]
    y = y.reshape(b, sl, dims(cfg)[0])
    y = L.rmsnorm(p["norm"], y * F.silu(z))
    return L.dense(p["out_proj"], y), (xBC_pre, state)


def ssm_decode(p: Params, cfg: ArchConfig, u: torch.Tensor,
               cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-step recurrence (plain).  u (b, 1, d)."""
    s = cfg.ssm
    b = u.shape[0]
    z, xBC_new, dt = _split_proj(p, cfg, u)           # (b,1,·)
    window = torch.cat([cache["conv"], xBC_new], dim=1)  # (b,d_conv,c)
    conv_out = (torch.einsum("bwc,wc->bc", window, p["conv_w"].to(u.dtype))
                + p["conv_b"].to(u.dtype))[:, None, :]
    x, B, C = _unpack_xbc(cfg, F.silu(conv_out))
    x, B, C = x[:, 0], B[:, 0], C[:, 0]
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (b,h)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                              # (b,h)
    rep = dims(cfg)[1] // s.n_groups
    Bh = B.repeat_interleave(rep, dim=1)               # (b,h,n)
    Ch = C.repeat_interleave(rep, dim=1)
    upd = torch.einsum("bhn,bhp->bhnp", Bh.float() * dt[..., None],
                       x.float())
    state = a[..., None, None] * cache["state"] + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch.float(), state)
    y = y.to(u.dtype) + x * p["D"][:, None].to(u.dtype)
    y = y.reshape(b, 1, dims(cfg)[0])
    y = L.rmsnorm(p["norm"], y * F.silu(z))
    y = L.dense(p["out_proj"], y)
    return y, {"conv": window[:, 1:], "state": state,
               "pos": cache["pos"] + 1}


def ssm_flops(cfg: ArchConfig, seq: int, kind: str) -> int:
    """Per-token matmul-ish FLOPs for one mamba2 block."""
    s = cfg.ssm
    d_inner, n_heads, conv_dim = dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads
    proj = 2 * cfg.d_model * d_in_proj + 2 * d_inner * cfg.d_model
    conv = 2 * s.d_conv * conv_dim
    if kind == "decode":
        ssd = 4 * n_heads * s.d_state * s.head_dim
    else:
        q = s.chunk
        ssd = (2 * n_heads * s.d_state * q      # CB^T per token (q cols)
               + 2 * n_heads * q * s.head_dim   # scores @ x
               + 4 * n_heads * s.d_state * s.head_dim)  # state in/out
    return proj + conv + ssd
