"""Config-driven assembly of the LM lane (twin of
``repro.models.transformer``) for every layer kind of the reference:
``ATTN``, ``ATTN_LOCAL`` (sliding window ``cfg.window``), ``ATTN_MOE``
(attention + an MoE FFN), ``MLA_DENSE`` / ``MLA_MOE`` (multi-head latent
attention + a dense or MoE FFN), ``SSM`` and ``RGLRU``, with text, vision
(patch embeddings prepended) and audio (codebook embeddings summed, one
head per codebook) inputs.

The stack is a list of *segments*; a segment repeats a pattern of layer
kinds over ``n_periods``.  The reference stacks each segment's parameters
along a leading period axis and runs ``lax.scan`` over it; the port keeps a
Python list of periods, each a tuple of per-layer parameter dicts
(``params["segments"][segment][period][position]``), and loops.  Cut-layer
splitting (:mod:`repro_torch.core.split`) addresses the stack at period
granularity through ``start`` / ``end``.

Modes: ``train`` (full sequence, no cache), ``prefill`` (full sequence,
returns the caches) and ``decode`` (one token, consumes and returns the
caches).  In ``train`` mode with ``remat`` each period runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are recomputed
in the backward, the reference's ``jax.checkpoint`` of the scan body.  Its
policy is the reference's trace-time switch :data:`REMAT_POLICY`
(:func:`set_remat_policy`): ``None`` recomputes everything; ``"dots"``
(``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``) saves the
outputs of the matrix products without batch dims -- the projections --
and recomputes the rest (:func:`_dots_policy`).
An MoE FFN returns the router's aux load-balance loss; :func:`forward_core`
and :func:`forward` return its sum over the layers they ran (the float
0.0 where none is an MoE layer), and :func:`loss_fn` adds it to the loss,
as the reference does.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, ATTN_MOE, MLA_DENSE,
                                      MLA_MOE, RGLRU, SSM, ArchConfig)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as M
from repro_torch.models import moe as E
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S

Params = Dict[str, Any]
MODES = ("train", "prefill", "decode")
KINDS = (ATTN, ATTN_LOCAL, ATTN_MOE, MLA_DENSE, MLA_MOE, SSM, RGLRU)
_ATTN_KINDS = (ATTN, ATTN_LOCAL, ATTN_MOE)
_MLA_KINDS = (MLA_DENSE, MLA_MOE)
_MOE_KINDS = (ATTN_MOE, MLA_MOE)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (the port has "
                               f"layer kinds {KINDS}, modes {MODES})")


def _unknown_kind(kind: str):
    return ValueError(f"unknown layer kind {kind!r}; known: {KINDS}")


def init_layer(gen: torch.Generator, cfg: ArchConfig, kind: str,
               dtype=torch.float32) -> Params:
    dev = gen.device
    p: Params = {"norm1": L.init_rmsnorm(cfg.d_model, dtype, dev)}
    if kind in _ATTN_KINDS:
        p["mixer"] = A.init_attn(gen, cfg, dtype)
    elif kind in _MLA_KINDS:
        p["mixer"] = M.init_mla(gen, cfg, dtype)
    elif kind == SSM:
        p["mixer"] = S.init_ssm(gen, cfg, dtype)
        return p  # the mamba block has no separate FFN
    elif kind == RGLRU:
        p["mixer"] = R.init_rglru(gen, cfg, dtype)
    else:
        raise _unknown_kind(kind)
    p["norm2"] = L.init_rmsnorm(cfg.d_model, dtype, dev)
    if kind in _MOE_KINDS:
        p["ffn"] = E.init_moe(gen, cfg, dtype)
    else:
        p["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_variant,
                              dtype)
    return p


def _window(cfg: ArchConfig, kind: str) -> int:
    return cfg.window if kind == ATTN_LOCAL else 0


def apply_layer(p: Params, cfg: ArchConfig, kind: str, x: torch.Tensor,
                mode: str, positions, cache, capacity: int
                ) -> Tuple[torch.Tensor, Any, Any]:
    """Returns (x, aux_loss, new_cache); ``aux_loss`` is the float 0.0
    but for an MoE FFN."""
    if mode not in MODES:
        raise _not_ported(f"mode {mode!r}")
    aux = 0.0
    h = L.rmsnorm(p["norm1"], x)
    new_cache = None
    if kind in _ATTN_KINDS:
        w = _window(cfg, kind)
        if mode == "train":
            h = A.attn_train(p["mixer"], cfg, h, positions, w)
        elif mode == "prefill":
            h, new_cache = A.attn_prefill(p["mixer"], cfg, h, positions,
                                          capacity, w)
        else:
            h, new_cache = A.attn_decode(p["mixer"], cfg, h, cache, w)
    elif kind in _MLA_KINDS:
        if mode == "train":
            h = M.mla_train(p["mixer"], cfg, h, positions)
        elif mode == "prefill":
            h, new_cache = M.mla_prefill(p["mixer"], cfg, h, positions,
                                         capacity)
        else:
            h, new_cache = M.mla_decode(p["mixer"], cfg, h, cache)
    elif kind == RGLRU:
        if mode == "train":
            h = R.rglru_train(p["mixer"], cfg, h)
        elif mode == "prefill":
            h, new_cache = R.rglru_prefill(p["mixer"], cfg, h)
        else:
            h, new_cache = R.rglru_decode(p["mixer"], cfg, h, cache)
    elif kind == SSM:
        if mode == "train":
            h = S.ssm_train(p["mixer"], cfg, h)
        elif mode == "prefill":
            h, new_cache = S.ssm_prefill(p["mixer"], cfg, h)
        else:
            h, new_cache = S.ssm_decode(p["mixer"], cfg, h, cache)
        return x + h, aux, new_cache
    else:
        raise _unknown_kind(kind)
    x = x + h
    h = L.rmsnorm(p["norm2"], x)
    if kind in _MOE_KINDS:
        h, aux = E.moe_forward(p["ffn"], cfg, h)
    else:
        h = L.mlp(p["ffn"], h, cfg.mlp_variant)
    return x + h, aux, new_cache


def init_layer_cache(cfg: ArchConfig, kind: str, batch: int, capacity: int,
                     dtype=torch.float32, device=None) -> Any:
    if kind in _ATTN_KINDS:
        return A.init_cache(cfg, batch, capacity, _window(cfg, kind), dtype,
                            device)
    if kind in _MLA_KINDS:
        return M.init_mla_cache(cfg, batch, capacity, dtype, device)
    if kind == SSM:
        return S.init_ssm_cache(cfg, batch, dtype, device)
    if kind == RGLRU:
        return R.init_rglru_cache(cfg, batch, dtype, device)
    raise _unknown_kind(kind)


def segments_of(cfg: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    segs = [(tuple(cfg.pattern), cfg.n_periods)]
    if cfg.tail:
        segs.append((tuple(cfg.tail), 1))
    return segs


def total_periods(cfg: ArchConfig) -> int:
    return sum(n for _, n in segments_of(cfg))


def _run_period(period, cfg: ArchConfig, pattern, x: torch.Tensor,
                mode: str, positions, pc, capacity: int):
    new, aux = [], 0.0
    for i, kind in enumerate(pattern):
        x, a, nc = apply_layer(period[i], cfg, kind, x, mode, positions,
                               pc[i] if pc is not None else None, capacity)
        aux = aux + a
        new.append(nc)
    return x, aux, tuple(new)


# Remat policy of a period in train mode (a perf knob, read when a period
# runs): None = full recompute; "dots" = save the outputs of the matrix
# products without batch dims (fewer recomputed GEMMs in the backward, more
# activation memory), as the reference's switch of the same name.
REMAT_POLICY: Optional[str] = None
REMAT_POLICIES = (None, "dots")


def set_remat_policy(name: Optional[str]) -> None:
    """``None`` or ``"dots"`` (the reference's ``set_remat_policy``)."""
    global REMAT_POLICY
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; known: "
                         f"{REMAT_POLICIES}")
    REMAT_POLICY = name


_aten = torch.ops.aten
_UNBATCHED = (_aten.mm.default, _aten.addmm.default)
_BATCHED = (_aten.bmm.default, _aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save what ``dots_with_no_batch_dims_saveable`` saves: a product
    with no batch dims.  The port's dense layers (``x @ w``, an MoE's
    ``xt @ w`` over its experts' weights) reach ``mm``; its einsum
    projections (``bsd,dhk->bshk``) reach ``bmm`` with a batch of one;
    attention's q.k^T and p.v, the SSD's and an MoE's per-expert products
    reach ``bmm`` over a real batch and are recomputed.  (A product whose
    batch happens to be one, b * heads = 1, is saved too: memory only, the
    values are the same.)  The kernels' ctypes launches write into
    ``torch.empty`` buffers, which are recomputed, so every kernel runs
    again in the recompute."""
    if op in _UNBATCHED:
        return CheckpointPolicy.MUST_SAVE
    if op in _BATCHED:      # bmm(a, b) / baddbmm(c, a, b): a's batch
        a = args[1] if op is _aten.baddbmm.default else args[0]
        if a.shape[0] == 1:
            return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context():
    """The ``context_fn`` of a period's ``checkpoint`` under
    :data:`REMAT_POLICY` (None: torch's default, full recompute)."""
    if REMAT_POLICY == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    return noop_context_fn


def _scan_segment(periods, cfg: ArchConfig, pattern, x: torch.Tensor,
                  mode: str, positions, caches, capacity: int,
                  remat: bool = False):
    """Run the given periods of one segment in order (the reference's
    ``lax.scan`` over stacked periods).  ``caches`` holds one entry per
    period in decode mode; ``remat`` (train mode only) recomputes each
    period in the backward.  Returns (x, aux loss summed over the periods,
    per-period caches)."""
    out, aux = [], 0.0
    for k, period in enumerate(periods):
        if remat and mode == "train":
            x, a = checkpoint(
                lambda pp, h: _run_period(pp, cfg, pattern, h, mode,
                                          positions, None, capacity)[:2],
                period, x, use_reentrant=False,
                context_fn=_remat_context())
            aux = aux + a
            out.append((None,) * len(pattern))
            continue
        pc = caches[k] if caches is not None else None
        x, a, new = _run_period(period, cfg, pattern, x, mode, positions,
                                pc, capacity)
        aux = aux + a
        out.append(new)
    return x, aux, out


def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype=None) -> Params:
    """Random parameters drawn from ``gen``, on the generator's device, in
    ``dtype`` (a torch dtype or its name; None: ``cfg.param_dtype``, as the
    reference); each leaf is drawn in float32 and cast once, and the MoE
    router stays float32.  The audio frontend keeps one embedding table
    (K, vp, d) and one head (d, K, vp) over its K codebooks."""
    if cfg.frontend not in ("none", "vision", "audio"):
        raise _not_ported(f"frontend {cfg.frontend!r}")
    dtype = cfg.param_dtype if dtype is None else dtype
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    vp, d = cfg.padded_vocab, cfg.d_model
    k = (cfg.n_codebooks,) if cfg.frontend == "audio" else ()
    return {
        "embed": L.trunc_normal(gen, (*k, vp, d), d ** -0.5, dtype),
        "head": L.trunc_normal(gen, (d, *k, vp), d ** -0.5, dtype),
        "final_norm": L.init_rmsnorm(d, dtype, gen.device),
        "segments": [[tuple(init_layer(gen, cfg, kind, dtype)
                            for kind in pat) for _ in range(n)]
                     for pat, n in segments_of(cfg)],
    }


def embed_inputs(p: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                 positions: torch.Tensor) -> torch.Tensor:
    """batch -> (b, s, d) activations (the vehicle-side input boundary):
    ``tokens`` (b, s); for vision also ``patch_embeds`` (b, n_patches, d),
    prepended; for audio ``codes`` (b, K, s), the K codebook embeddings
    summed."""
    if cfg.pos not in ("rope", "sinusoidal"):
        raise _not_ported(f"pos {cfg.pos!r}")
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        tok = p["embed"][batch["tokens"]]
        x = torch.cat([batch["patch_embeds"].to(tok.dtype), tok], dim=1)
    elif cfg.frontend == "audio":
        codes = batch["codes"]                      # (b, K, s)
        x = p["embed"][0][codes[:, 0]]
        for k in range(1, cfg.n_codebooks):
            x = x + p["embed"][k][codes[:, k]]
    else:
        x = p["embed"][batch["tokens"]]
    if cfg.pos == "sinusoidal":
        x = x + L.sinusoidal_pos(positions, cfg.d_model).to(x.dtype)
    return x


def unembed(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """(b, s, d) -> logits (b, s, vp), or (b, s, K, vp) for audio."""
    x = L.rmsnorm(p["final_norm"], x)
    if cfg.frontend == "audio":
        logits = torch.einsum("bsd,dkv->bskv", x, p["head"].to(x.dtype))
    else:
        logits = x @ p["head"].to(x.dtype)
    return L.softcap(logits, cfg.logit_softcap)


def forward_core(p: Params, cfg: ArchConfig, x: torch.Tensor, mode: str,
                 positions=None, caches=None, capacity: int = 0,
                 start: int = 0, end: Optional[int] = None,
                 remat: bool = False):
    """Run periods [start, end) of the stack.  ``caches`` (decode) covers
    every period of each segment, as :func:`init_caches` with the default
    range or a prefill returns it; ``remat`` acts in train mode only.
    Returns (x, aux loss, caches)."""
    end = total_periods(cfg) if end is None else end
    segments, seg_caches = [], []
    off = 0
    for si, (_, n) in enumerate(segments_of(cfg)):
        lo, hi = max(start - off, 0), min(end - off, n)
        segments.append(p["segments"][si][lo:hi] if lo < hi else None)
        seg_caches.append(caches[si][lo:hi]
                          if caches is not None and lo < hi else None)
        off += n
    return run_segments(segments, cfg, x, mode, positions,
                        seg_caches if caches is not None else None,
                        capacity, remat)


def run_segments(segments, cfg: ArchConfig, x: torch.Tensor, mode: str,
                 positions=None, caches=None, capacity: int = 0,
                 remat: bool = False):
    """Run each segment's given periods in order (None: none of that
    segment's), ``caches`` (decode) holding one list per segment for
    those periods.  Returns (x, the aux loss summed over every period,
    per-segment caches, None where a segment ran no period): the stack's
    forward and each side of the split run this one loop."""
    out_caches = []
    aux = 0.0
    for si, (pat, _) in enumerate(segments_of(cfg)):
        if segments[si] is None:
            out_caches.append(None)
            continue
        seg_c = caches[si] if caches is not None else None
        x, a, nc = _scan_segment(segments[si], cfg, pat, x, mode, positions,
                                 seg_c, capacity, remat)
        aux = aux + a
        out_caches.append(nc)
    return x, aux, tuple(out_caches)


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
    """Positions of a step: ``[pos_offset]`` in decode, else ``arange(s)``
    over the whole input (vision: the patches and the text; audio: the
    frames)."""
    if cfg.frontend == "audio":
        ref = batch["codes"]
        s = ref.shape[2]
    else:
        ref = batch["tokens"]
        s = ref.shape[1]
        if cfg.frontend == "vision" and mode != "decode":
            s += cfg.n_patches
    if mode == "decode":
        return torch.full((1,), pos_offset, dtype=torch.int32,
                          device=ref.device)
    return torch.arange(s, dtype=torch.int32, device=ref.device)


def forward(p: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            mode: str = "prefill", caches=None, capacity: int = 0,
            pos_offset: int = 0, remat: bool = False):
    """Full model: embed -> stack -> head.  Returns (logits, aux loss,
    caches)."""
    positions = positions_of(cfg, batch, mode, pos_offset)
    x = embed_inputs(p, cfg, batch, positions)
    x, aux, caches = forward_core(p, cfg, x, mode, positions, caches,
                                  capacity, remat=remat)
    return unembed(p, cfg, x), aux, caches


def loss_fn(p: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            remat: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean next-token cross-entropy of the full model in train mode (audio:
    over the K codebooks of each frame; vision: on the text positions).
    Returns (ce + aux, {"ce", "aux"}): ``aux`` is the MoE layers' summed
    load-balance loss (0 without one)."""
    logits, aux, _ = forward(p, cfg, batch, "train", remat=remat)
    if cfg.frontend == "audio":
        ce = L.cross_entropy(logits, batch["codes"].transpose(1, 2),
                             cfg.vocab_size)
    else:
        if cfg.frontend == "vision":
            logits = logits[:, cfg.n_patches:]
        ce = L.cross_entropy(logits, batch["labels"], cfg.vocab_size)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + aux, {"ce": ce, "aux": aux}


def count_params(cfg: ArchConfig) -> int:
    """Analytic parameter count, the reference's formula term for term
    (roofline MODEL_FLOPS = 6 N D).  Like the reference's, it leaves out
    the qk-norm scales (2 * head_dim per attention layer) and RG-LRU's
    ``lam`` (d_rnn per RG-LRU layer); it counts every value of an MLA
    layer and an MoE FFN."""
    d, ff, vp = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    total = 0
    for kind in cfg.layer_types:
        n = 2 * d  # norms
        if kind in _ATTN_KINDS:
            n += d * cfg.head_dim_ * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
        elif kind in _MLA_KINDS:
            m = cfg.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            n += d * (cfg.n_heads * qk + m.kv_lora_rank + m.qk_rope_dim)
            n += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
            n += cfg.n_heads * m.v_head_dim * d + m.kv_lora_rank
        elif kind == SSM:
            d_inner, n_heads, conv_dim = S.dims(cfg)
            n = d + d * (2 * d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
                         + n_heads)
            n += cfg.ssm.d_conv * conv_dim + conv_dim + 3 * n_heads
            n += d_inner + d_inner * d
            total += n
            continue
        elif kind == RGLRU:
            dr = cfg.rglru.d_rnn or d
            n += (d * dr * 2 + dr * d + 2 * dr * dr + 3 * dr
                  + cfg.rglru.d_conv * dr)
        else:
            raise _unknown_kind(kind)
        if kind in _MOE_KINDS:
            m = cfg.moe
            n += d * m.n_experts  # router
            n += (m.n_experts + m.n_shared) * 3 * d * (m.d_ff_expert or ff)
        else:
            n += (3 if cfg.mlp_variant in ("swiglu", "geglu") else 2) * d * ff
        total += n
    k = cfg.n_codebooks if cfg.frontend == "audio" else 1
    return total + 2 * vp * d * k + d


def uncounted_params(cfg: ArchConfig) -> int:
    """The values :func:`count_params` leaves out: the qk-norm scales and
    RG-LRU's ``lam``.  The tree of :func:`init_params` holds
    ``count_params(cfg) + uncounted_params(cfg)`` values."""
    kinds = cfg.layer_types
    n = 0
    if cfg.qk_norm:
        n += 2 * cfg.head_dim_ * sum(kinds.count(k) for k in _ATTN_KINDS)
    if RGLRU in kinds:
        n += (cfg.rglru.d_rnn or cfg.d_model) * kinds.count(RGLRU)
    return n
