"""Cut-layer splitting of the LM lane's parameters (twin of
``repro.core.split``; paper §III-A: ω = {ω^V; ω^S}).

The cut is at *period* granularity (:mod:`repro_torch.models.transformer`).
``split_params`` / ``join_params`` are exact inverses; the halves share the
parameter tensors (no copies).  In ``train`` mode both halves run their
periods with remat on by default, as the reference's ``_run_sliced``
always does; ``remat=False`` keeps every period's activations instead.
The caches are whatever each layer kind keeps (attention's K / V, MLA's
latent ``c_kv`` / ``k_rope``, SSM and RG-LRU states), carried per period.
Each side returns the aux load-balance loss of its MoE layers, summed (the
float 0.0 where it holds none), as the reference's does: the train step
adds both sides' to its objective, the prefill and decode steps drop it.
Under remat the aux comes out of each checkpointed period beside its
activations, so its gradient reaches the router through the recompute.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T

Params = Dict[str, Any]


def valid_cuts(cfg: ArchConfig) -> List[int]:
    """Period boundaries 1..P-1 (both sides keep at least one period)."""
    return list(range(1, T.total_periods(cfg)))


def clamp_cut(cfg: ArchConfig, cut: int) -> int:
    return max(1, min(cut, T.total_periods(cfg) - 1))


def split_params(params: Params, cfg: ArchConfig, cut: int
                 ) -> Tuple[Params, Params]:
    """Vehicle side: embed + periods [0, cut).  RSU side: periods [cut, P)
    + final norm + head."""
    cut = clamp_cut(cfg, cut)
    client: Params = {"embed": params["embed"], "segments": []}
    server: Params = {"final_norm": params["final_norm"],
                      "head": params["head"], "segments": []}
    off = 0
    for si, (_, n) in enumerate(T.segments_of(cfg)):
        lo = max(cut - off, 0)
        seg = params["segments"][si]
        client["segments"].append(seg[:lo] if lo > 0 else None)
        server["segments"].append(seg[lo:] if lo < n else None)
        off += n
    return client, server


def join_params(client: Params, server: Params, cfg: ArchConfig) -> Params:
    segs = []
    for c_seg, s_seg in zip(client["segments"], server["segments"]):
        segs.append(list(c_seg or []) + list(s_seg or []))
    return {"embed": client["embed"], "segments": segs,
            "final_norm": server["final_norm"], "head": server["head"]}


def client_forward(client: Params, cfg: ArchConfig, batch, cut: int,
                   mode: str = "prefill", caches=None, capacity: int = 0,
                   pos_offset: int = 0, remat: bool = True):
    """Vehicle-side forward: embed + periods [0, cut) -> smashed data.
    Returns (smashed, positions, aux loss, caches).  ``remat`` acts in
    train mode only."""
    positions = T.positions_of(cfg, batch, mode, pos_offset)
    x = T.embed_inputs(client, cfg, batch, positions)
    x, aux, new_caches = T.run_segments(client["segments"], cfg, x, mode,
                                        positions, caches, capacity, remat)
    return x, positions, aux, new_caches


def server_forward(server: Params, cfg: ArchConfig, smashed, positions,
                   cut: int, mode: str = "prefill", caches=None,
                   capacity: int = 0, remat: bool = True):
    """RSU-side forward: periods [cut, P) + head -> (logits, aux loss,
    caches).  ``remat`` acts in train mode only."""
    x, aux, new_caches = T.run_segments(server["segments"], cfg, smashed,
                                        mode, positions, caches, capacity,
                                        remat)
    return T.unembed(server, cfg, x), aux, new_caches


def init_split_caches(cfg: ArchConfig, batch: int, capacity: int, cut: int,
                      dtype=torch.float32, device=None):
    """(client_caches, server_caches) for decode at the given cut."""
    cut = clamp_cut(cfg, cut)
    return (T.init_caches(cfg, batch, capacity, dtype, 0, cut, device),
            T.init_caches(cfg, batch, capacity, dtype, cut,
                          T.total_periods(cfg), device))
