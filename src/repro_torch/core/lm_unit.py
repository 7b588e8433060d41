"""Transformer-as-UnitModel adapter (twin of ``repro.core.lm_unit``): the
federation simulator over an LM arch's config -- SFL / ASFL with the
paper's message flow on LM stacks, not only the paper's ResNet18.

Unit granularity: unit 0 = the token embedding (always vehicle-side: raw
tokens never leave the vehicle, the paper's privacy argument); units 1..P
= the stack's periods, each a tuple of per-layer parameter dicts (the
port's period layout; :func:`repro_torch.bridge.lm_units_to_torch` carries
the reference's, whose periods are stacked on a leading axis of size 1);
the head (final norm + LM head) lives with the RSU.  Batches use the
fedsim convention: ``images`` = token ids (b, s), ``labels`` = next-token
ids (b, s).  The units run in ``train`` mode without remat, as the
reference's do, so the engines' ``torch.func`` transforms take them whole.
The units are built in the config's ``param_dtype`` (bfloat16 for qwen3-14b,
command-r-35b and dbrx-132b), as the reference's.  An MoE unit's aux
load-balance loss is dropped, as the reference's ``apply_units`` drops it:
the federation loss of an MoE arch is the cross-entropy alone.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch import bridge
from repro_torch.configs import check_trainable
from repro_torch.configs.base import ArchConfig
from repro_torch.core import cost
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


class TransformerUnitModel:
    def __init__(self, cfg: ArchConfig):
        if cfg.frontend != "none":
            raise ValueError("the fedsim LM adapter takes text archs only")
        check_trainable(cfg)
        self.cfg = cfg
        self.name = cfg.name
        # (segment index, pattern) per period, in stack order
        self._period_seg: List[Tuple[int, Tuple[str, ...]]] = []
        for si, (pat, n) in enumerate(T.segments_of(cfg)):
            self._period_seg += [(si, pat)] * n
        self.n_units = 1 + len(self._period_seg)

    def init(self, gen: torch.Generator):
        """Random parameters drawn from ``gen`` (on its device) as
        (units, head)."""
        params = T.init_params(gen, self.cfg)
        units: List = [{"embed": params["embed"]}]
        for seg in params["segments"]:
            units += list(seg)
        head = {"final_norm": params["final_norm"], "head": params["head"]}
        return units, head

    def apply_units(self, units, x, start: int):
        cfg = self.cfg
        for i, u in enumerate(units, start):
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=x.device)
            if i == 0:
                x = T.embed_inputs(u, cfg, {"tokens": x}, positions)
            else:
                _, pat = self._period_seg[i - 1]
                x, _, _ = T._scan_segment([u], cfg, pat, x, "train",
                                          positions, None, 0, remat=False)
        return x

    def head_loss(self, head, feats, labels):
        logits = T.unembed(head, self.cfg, feats)
        return L.cross_entropy(logits, labels, self.cfg.vocab_size), logits

    def head_predict(self, head, feats):
        return T.unembed(head, self.cfg, feats)

    def params_to_numpy(self, units, head):
        """(units, head) in the reference's layout, as numpy arrays."""
        return bridge.lm_units_to_numpy(units, head)

    def profile(self, seq: int = 64) -> cost.SplitProfile:
        """The cost model's profile at ``seq`` tokens a sample (the
        reference's 64 by default), the embedding unit prepended."""
        prof = cost.arch_profile(self.cfg, seq=seq, param_bytes_per=4)
        emb_bytes = self.cfg.padded_vocab * self.cfg.d_model * 4
        prof.unit_fwd_flops.insert(0, 0.0)
        prof.unit_param_bytes.insert(0, emb_bytes)
        prof.smashed_bytes_per_sample.insert(
            0, prof.smashed_bytes_per_sample[0])
        return prof
