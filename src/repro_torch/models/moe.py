"""Mixture-of-Experts FFN of the LM lane (twin of ``repro.models.moe``),
with the reference's two formulations and its rule between them:

* **Grouped GShard dispatch / combine** (train / prefill): tokens are
  tiled into groups of ~1024, each group builds a (tpg, E, capacity)
  one-hot dispatch, and a (token, expert) slot past its expert's capacity
  is dropped.  The dispatch position is the exclusive cumsum over the
  token-major flattened (tpg * k, E) one-hot, as in the reference, so the
  same slots drop.
* **Dense** (decode / small batches): every expert runs on every token
  and the router gates the sum; nothing is dropped.

The dense path runs when ``T * E * d_ff <= DENSE_PATH_MAX_ELEMENTS``, the
grouped one otherwise.  The router's top-k takes, on a tie, the lower
expert index first (``jax.lax.top_k``'s order; a stable descending sort),
since the order of the k choices feeds the capacity positions.  The
dispatch and combine are the reference's one-hot einsums; the dense path
multiplies the tokens into each expert's weights as they lie (a broadcast
``matmul``), where an einsum over ``td,edf`` would copy every expert's
weights into one GEMM operand.

DBRX: 16 routed top-4.  DeepSeek-V2-Lite: 64 routed top-6 + 2 shared.
The aux load-balance loss follows Switch / GShard.

Both paths train by autograd of these ops, as the reference's by
``jax.grad``: the gates' gradient reaches the router through the top-k's
chosen probabilities (the same experts as ``jax.lax.top_k``'s, ties
included) and the renormalisation; a dropped slot's gate is zeroed before
the combine, so no gradient reaches it; the aux loss's gradient flows
through the mean router probabilities alone (its token fractions come from
an integer one-hot).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]

TARGET_TOKENS_PER_GROUP = 1024
DENSE_PATH_MAX_ELEMENTS = 2 ** 27   # T*E*d_ff budget for the dense path


def _expert_ff(cfg: ArchConfig) -> int:
    return cfg.moe.d_ff_expert or cfg.d_ff


def init_moe(gen: torch.Generator, cfg: ArchConfig,
             dtype=torch.float32) -> Params:
    """The router is float32 whatever ``dtype`` (as in the reference)."""
    m = cfg.moe
    d, ff, e = cfg.d_model, _expert_ff(cfg), m.n_experts
    std_in, std_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p = {
        "router": L.trunc_normal(gen, (d, e), std_in, torch.float32),
        "wi_gate": L.trunc_normal(gen, (e, d, ff), std_in, dtype),
        "wi_up": L.trunc_normal(gen, (e, d, ff), std_in, dtype),
        "wo": L.trunc_normal(gen, (e, ff, d), std_out, dtype),
    }
    if m.n_shared:
        p["shared"] = L.init_mlp(gen, d, m.n_shared * ff, "swiglu", dtype)
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (int64) as a comparison with ``arange(n)``,
    the reference's ``jax.nn.one_hot``: ``F.one_hot`` checks its indices'
    range with a data-dependent read, which ``vmap`` of ``grad`` (the
    engines' ``fl`` round) cannot batch."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, descending,
    a tie to the lower index first (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: Params, cfg: ArchConfig, xt: torch.Tensor):
    """(t, d) -> (probs (t, E), gate_vals (t, k), expert_idx (t, k),
    aux)."""
    m = cfg.moe
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, m.top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = _one_hot(expert_idx, m.n_experts).float()
    frac_tokens = onehot.sum(1).mean(0)
    frac_probs = probs.mean(0)
    aux = (m.n_experts * torch.sum(frac_tokens / m.top_k * frac_probs)
           * m.aux_loss_weight)
    return probs, gate_vals, expert_idx, aux


def _experts_dense(p: Params, cfg: ArchConfig, xt, gate_vals, expert_idx):
    """All-experts compute, router-gated sum (decode path).  The gate
    matrix is an out-of-place ``scatter`` into zeros (the reference's
    one-hot sum, the same values), so ``torch.func.vmap`` batches it over
    replicas' indices and gates."""
    t = xt.shape[0]
    w = torch.zeros((t, cfg.moe.n_experts), dtype=torch.float32,
                    device=xt.device).scatter(1, expert_idx, gate_vals)
    # (t, d) @ (e, d, f) -> (e, t, f): each expert's weights as they lie
    h = F.silu(torch.matmul(xt, p["wi_gate"].to(xt.dtype)))
    h = h * torch.matmul(xt, p["wi_up"].to(xt.dtype))
    out = torch.matmul(h, p["wo"].to(xt.dtype))               # (e, t, d)
    return torch.einsum("te,etd->td", w.to(xt.dtype), out)


def _pick_groups(t: int) -> int:
    g = max(t // TARGET_TOKENS_PER_GROUP, 1)
    while g > 1 and t % g:
        g -= 1
    return g


def _capacity(tpg: int, m) -> int:
    return max(4, min(int(math.ceil(tpg * m.top_k / m.n_experts
                                    * m.capacity_factor)), tpg))


def _experts_grouped(p: Params, cfg: ArchConfig, xt, gate_vals, expert_idx,
                     n_groups: Optional[int]):
    """GShard grouped dispatch / combine (train / prefill path).  Returns
    (y (t, d), keep (g, tpg, k): the (token, choice) slots within their
    expert's capacity)."""
    m = cfg.moe
    t, d = xt.shape
    e, k = m.n_experts, m.top_k
    g = n_groups or _pick_groups(t)
    tpg = t // g
    cap = _capacity(tpg, m)

    xg = xt.reshape(g, tpg, d)
    idx = expert_idx.reshape(g, tpg, k)
    gates = gate_vals.reshape(g, tpg, k)

    onehot = _one_hot(idx, e)                                 # (g,tpg,k,e)
    flat = onehot.reshape(g, tpg * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, tpg, k, e)
    pos = (pos * onehot).sum(-1)                              # (g,tpg,k)
    keep = pos < cap
    gates = torch.where(keep, gates, 0.0)

    # a dropped slot's row of the position one-hot is zeroed by its gate
    slot = _one_hot(pos.clamp(max=cap - 1), cap).float() * gates[..., None]
    combine = torch.einsum("gtke,gtkc->gtec",
                           (onehot * keep[..., None]).float(), slot)
    dispatch = (combine > 0).to(xt.dtype)                     # (g,tpg,e,cap)

    expert_in = torch.einsum("gtec,gtd->gecd", dispatch, xg)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in,
                            p["wi_gate"].to(xt.dtype)))
    h = h * torch.einsum("gecd,edf->gecf", expert_in,
                         p["wi_up"].to(xt.dtype))
    expert_out = torch.einsum("gecf,efd->gecd", h, p["wo"].to(xt.dtype))
    y = torch.einsum("gtec,gecd->gtd", combine.to(xt.dtype), expert_out)
    return y.reshape(t, d), keep


def uses_dense_path(cfg: ArchConfig, n_tokens: int) -> bool:
    """The reference's rule: the dense path while T * E * d_ff fits."""
    return (n_tokens * cfg.moe.n_experts * _expert_ff(cfg)
            <= DENSE_PATH_MAX_ELEMENTS)


def moe_forward(p: Params, cfg: ArchConfig, x: torch.Tensor,
                n_groups: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) -> (y, aux_loss)."""
    m = cfg.moe
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    _, gate_vals, expert_idx, aux = _route(p, cfg, xt)
    if uses_dense_path(cfg, xt.shape[0]):
        y = _experts_dense(p, cfg, xt, gate_vals, expert_idx)
    else:
        y, _ = _experts_grouped(p, cfg, xt, gate_vals, expert_idx,
                                n_groups)
    if m.n_shared:
        y = y + L.mlp(p["shared"], xt, "swiglu")
    return y.reshape(x.shape), aux


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Per-expert capacity of a group when ``n_tokens`` take the grouped
    path."""
    return _capacity(n_tokens // _pick_groups(n_tokens), cfg.moe)


def moe_flops(cfg: ArchConfig) -> int:
    """Active matmul FLOPs per token (routed top-k + shared)."""
    m, d, ff = cfg.moe, cfg.d_model, _expert_ff(cfg)
    per_expert = 2 * 3 * d * ff
    return m.top_k * per_expert + m.n_shared * per_expert + 2 * d * m.n_experts
