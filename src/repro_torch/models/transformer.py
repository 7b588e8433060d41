"""Config-driven assembly of the LM lane (twin of
``repro.models.transformer``) for the ported layer kinds ``ATTN`` and
``SSM``.

The stack is a list of *segments*; a segment repeats a pattern of layer
kinds over ``n_periods``.  The reference stacks each segment's parameters
along a leading period axis and runs ``lax.scan`` over it; the port keeps a
Python list of periods, each a tuple of per-layer parameter dicts
(``params["segments"][segment][period][position]``), and loops.  Cut-layer
splitting (:mod:`repro_torch.core.split`) addresses the stack at period
granularity through ``start`` / ``end``.

Modes: ``prefill`` (full sequence, returns the caches) and ``decode`` (one
token, consumes and returns the caches).  ``train`` comes with the LM
training slice.  No ported layer has an auxiliary loss, so the functions
return no ``aux``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN, SSM, ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

Params = Dict[str, Any]
MODES = ("prefill", "decode")


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (the port has "
                               f"layer kinds {ATTN!r} and {SSM!r}, text "
                               f"input, modes {MODES})")


def init_layer(gen: torch.Generator, cfg: ArchConfig, kind: str,
               dtype=torch.float32) -> Params:
    dev = gen.device
    p: Params = {"norm1": L.init_rmsnorm(cfg.d_model, dtype, dev)}
    if kind == ATTN:
        p["mixer"] = A.init_attn(gen, cfg, dtype)
    elif kind == SSM:
        p["mixer"] = S.init_ssm(gen, cfg, dtype)
        return p  # the mamba block has no separate FFN
    else:
        raise _not_ported(f"layer kind {kind!r}")
    p["norm2"] = L.init_rmsnorm(cfg.d_model, dtype, dev)
    p["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_variant, dtype)
    return p


def apply_layer(p: Params, cfg: ArchConfig, kind: str, x: torch.Tensor,
                mode: str, positions, cache, capacity: int
                ) -> Tuple[torch.Tensor, Any]:
    """Returns (x, new_cache)."""
    if mode not in MODES:
        raise _not_ported(f"mode {mode!r}")
    h = L.rmsnorm(p["norm1"], x)
    if kind == ATTN:
        if mode == "prefill":
            h, new_cache = A.attn_prefill(p["mixer"], cfg, h, positions,
                                          capacity)
        else:
            h, new_cache = A.attn_decode(p["mixer"], cfg, h, cache)
    elif kind == SSM:
        if mode == "prefill":
            h, new_cache = S.ssm_prefill(p["mixer"], cfg, h)
        else:
            h, new_cache = S.ssm_decode(p["mixer"], cfg, h, cache)
        return x + h, new_cache
    else:
        raise _not_ported(f"layer kind {kind!r}")
    x = x + h
    h = L.rmsnorm(p["norm2"], x)
    return x + L.mlp(p["ffn"], h, cfg.mlp_variant), new_cache


def init_layer_cache(cfg: ArchConfig, kind: str, batch: int, capacity: int,
                     dtype=torch.float32, device=None) -> Any:
    if kind == ATTN:
        return A.init_cache(cfg, batch, capacity, 0, dtype, device)
    if kind == SSM:
        return S.init_ssm_cache(cfg, batch, dtype, device)
    raise _not_ported(f"layer kind {kind!r}")


def segments_of(cfg: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    segs = [(tuple(cfg.pattern), cfg.n_periods)]
    if cfg.tail:
        segs.append((tuple(cfg.tail), 1))
    return segs


def total_periods(cfg: ArchConfig) -> int:
    return sum(n for _, n in segments_of(cfg))


def _scan_segment(periods, cfg: ArchConfig, pattern, x: torch.Tensor,
                  mode: str, positions, caches, capacity: int):
    """Run the given periods of one segment in order (the reference's
    ``lax.scan`` over stacked periods).  ``caches`` holds one entry per
    period in decode mode.  Returns (x, per-period caches)."""
    out = []
    for k, period in enumerate(periods):
        pc = caches[k] if caches is not None else None
        new = []
        for i, kind in enumerate(pattern):
            x, nc = apply_layer(period[i], cfg, kind, x, mode, positions,
                                pc[i] if pc is not None else None, capacity)
            new.append(nc)
        out.append(tuple(new))
    return x, out


def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32) -> Params:
    """Random parameters drawn from ``gen``, on the generator's device."""
    if cfg.frontend != "none":
        raise _not_ported(f"frontend {cfg.frontend!r}")
    vp, d = cfg.padded_vocab, cfg.d_model
    return {
        "embed": L.trunc_normal(gen, (vp, d), d ** -0.5, dtype),
        "head": L.trunc_normal(gen, (d, vp), d ** -0.5, dtype),
        "final_norm": L.init_rmsnorm(d, dtype, gen.device),
        "segments": [[tuple(init_layer(gen, cfg, kind, dtype)
                            for kind in pat) for _ in range(n)]
                     for pat, n in segments_of(cfg)],
    }


def embed_inputs(p: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                 positions: torch.Tensor) -> torch.Tensor:
    """batch -> (b, s, d) activations (the vehicle-side input boundary)."""
    if cfg.frontend != "none" or cfg.pos != "rope":
        raise _not_ported(f"frontend {cfg.frontend!r} / pos {cfg.pos!r}")
    return p["embed"][batch["tokens"]]


def unembed(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(p["final_norm"], x)
    logits = x @ p["head"].to(x.dtype)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def forward_core(p: Params, cfg: ArchConfig, x: torch.Tensor, mode: str,
                 positions=None, caches=None, capacity: int = 0,
                 start: int = 0, end: Optional[int] = None):
    """Run periods [start, end) of the stack.  ``caches`` (decode) covers
    every period of each segment, as :func:`init_caches` with the default
    range or a prefill returns it.  Returns (x, caches)."""
    end = total_periods(cfg) if end is None else end
    out_caches = []
    off = 0
    for si, (pat, n) in enumerate(segments_of(cfg)):
        lo, hi = max(start - off, 0), min(end - off, n)
        if lo < hi:
            seg_c = caches[si][lo:hi] if caches is not None else None
            x, nc = _scan_segment(p["segments"][si][lo:hi], cfg, pat, x,
                                  mode, positions, seg_c, capacity)
            out_caches.append(nc)
        else:
            out_caches.append(None)
        off += n
    return x, tuple(out_caches)


def init_caches(cfg: ArchConfig, batch: int, capacity: int,
                dtype=torch.float32, start: int = 0,
                end: Optional[int] = None, device=None):
    """Per-segment lists of per-period caches for periods [start, end)."""
    end = total_periods(cfg) if end is None else end
    caches = []
    off = 0
    for pat, n in segments_of(cfg):
        lo, hi = max(start - off, 0), min(end - off, n)
        caches.append([tuple(init_layer_cache(cfg, t, batch, capacity, dtype,
                                              device) for t in pat)
                       for _ in range(hi - lo)] if lo < hi else None)
        off += n
    return tuple(caches)


def positions_of(cfg: ArchConfig, batch, mode: str,
                 pos_offset: int = 0) -> torch.Tensor:
    """Token positions of a step: ``[pos_offset]`` in decode, else
    ``arange(s)``."""
    dev = batch["tokens"].device
    if mode == "decode":
        return torch.full((1,), pos_offset, dtype=torch.int32, device=dev)
    return torch.arange(batch["tokens"].shape[1], dtype=torch.int32,
                        device=dev)


def forward(p: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            mode: str = "prefill", caches=None, capacity: int = 0,
            pos_offset: int = 0):
    """Full model: embed -> stack -> head.  Returns (logits, caches)."""
    positions = positions_of(cfg, batch, mode, pos_offset)
    x = embed_inputs(p, cfg, batch, positions)
    x, caches = forward_core(p, cfg, x, mode, positions, caches, capacity)
    return unembed(p, cfg, x), caches
