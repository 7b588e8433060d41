"""Per-cut communication / computation / energy accounting (twin of
``repro.core.cost``, the parts the ResNet, MLP and LM profiles need).

The analytic model behind the paper's Fig. 5a/5b: the SFL/ASFL round per
vehicle, the FL round (full model on the vehicle) and the sequential SL
chain.  numpy throughout, in the reference's float64 order: the port's
numbers equal the reference's to float64 rounding.  Smashed traffic is
charged at its on-wire size in both directions (activations up, cut-layer
gradients down); model transfer stays dense fp32.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import compression

BYTES_F32 = 4
BWD_FWD_RATIO = 2.0  # backward pass ~ 2x forward FLOPs


@dataclasses.dataclass
class SplitProfile:
    name: str
    unit_fwd_flops: List[float]            # per-sample forward FLOPs per unit
    unit_param_bytes: List[int]            # parameter bytes per unit
    smashed_bytes_per_sample: List[float]  # at cut c (index c-1), forward
    head_flops: float = 0.0
    head_param_bytes: int = 0
    # trailing dim of the smashed tensor at cut c (index c-1): the axis the
    # wire groups along; None = unknown (assume GROUP-divisible)
    smashed_trailing_dim: Optional[List[int]] = None

    @property
    def n_units(self) -> int:
        return len(self.unit_fwd_flops)

    def client_fwd_flops(self, cut: int) -> float:
        return float(sum(self.unit_fwd_flops[:cut]))

    def server_fwd_flops(self, cut: int) -> float:
        return float(sum(self.unit_fwd_flops[cut:]) + self.head_flops)

    def full_param_bytes(self) -> int:
        return int(sum(self.unit_param_bytes) + self.head_param_bytes)


def wire_smashed_ratio(profile: SplitProfile, cuts, wire: str = "none",
                       wire_k: Optional[float] = None, group: int = 128):
    """Dense-fp32 / on-wire bytes for the smashed tensors at each cut (both
    directions ride the same wire)."""
    if wire == "none":
        return 1.0
    td = profile.smashed_trailing_dim
    trailing = (None if td is None
                else np.asarray(td)[np.asarray(cuts, dtype=np.int64) - 1])
    if wire_k is None:
        wire_k = compression.WIRE_K
    return compression.wire_compression_ratio(wire, BYTES_F32, group,
                                              trailing, wire_k)


def effective_comm_bytes(profile: SplitProfile, cuts, steps, batch: int,
                         wire: str = "none", wire_k: Optional[float] = None,
                         include_model_transfer: bool = True,
                         model_upload=True):
    """(up, down) bytes for one round: smashed traffic at on-wire size in
    both directions, model transfer (aggregation up + fresh copy down)
    dense fp32.  ``model_upload`` (scalar or bool array over the fleet)
    drops the aggregation upload of a vehicle whose update never went out
    (a mid-round dropout); its fresh-copy download and every smashed
    exchange in ``steps`` are still charged."""
    cuts = np.asarray(cuts, dtype=np.int64)
    smashed = (np.asarray(profile.smashed_bytes_per_sample)[cuts - 1] * batch
               / wire_smashed_ratio(profile, cuts, wire, wire_k))
    up = np.asarray(steps) * smashed
    down = np.asarray(steps) * smashed
    if include_model_transfer:
        bytes_cum = np.concatenate([[0], np.cumsum(profile.unit_param_bytes)])
        up = up + bytes_cum[cuts] * np.asarray(model_upload)
        down = down + bytes_cum[cuts]
    return up, down


def resnet_profile() -> SplitProfile:
    from repro_torch.models import resnet as R
    unit_flops = [float(R.unit_flops(i)) for i in range(R.N_UNITS)]
    unit_bytes = [(3 * 3 * 3 * 64 + 2 * 64) * BYTES_F32]
    cin = 64
    for cout, stride in zip(R.STAGE_CHANNELS, R.STAGE_STRIDES):
        n = 3 * 3 * cin * cout + 2 * cout + 3 * 3 * cout * cout + 2 * cout
        if stride != 1 or cin != cout:
            n += cin * cout + 2 * cout
        unit_bytes.append(n * BYTES_F32)
        cin = cout
    smashed = [float(np.prod(R.smashed_shape(c, 1)[1:])) * BYTES_F32
               for c in range(1, R.N_UNITS + 1)]
    return SplitProfile(
        name="resnet18",
        unit_fwd_flops=unit_flops,
        unit_param_bytes=unit_bytes,
        smashed_bytes_per_sample=smashed,
        head_flops=2 * 512 * 10,
        head_param_bytes=(512 * 10 + 10) * BYTES_F32,
        smashed_trailing_dim=[R.smashed_shape(c, 1)[-1]
                              for c in range(1, R.N_UNITS + 1)],
    )


def arch_profile(cfg, seq: int, param_bytes_per: int = 2) -> SplitProfile:
    """SplitProfile of an LM arch at period granularity (every layer kind:
    attention, local attention, attention + MoE, MLA + dense / MoE, SSM,
    RG-LRU); smashed data = (seq, d_model) activations at the period
    boundary."""
    import dataclasses as dc

    from repro_torch.configs.base import (ATTN, ATTN_LOCAL, ATTN_MOE,
                                          MLA_DENSE, MLA_MOE, RGLRU, SSM)
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import attn_flops
    from repro_torch.models.layers import mlp_flops
    from repro_torch.models.mla import mla_flops
    from repro_torch.models.moe import moe_flops
    from repro_torch.models.rglru import rglru_flops
    from repro_torch.models.ssm import ssm_flops

    def layer_flops(kind: str) -> float:
        if kind == SSM:
            return float(ssm_flops(cfg, seq, "train"))
        if kind in (ATTN, ATTN_MOE):
            f = attn_flops(cfg, seq)
        elif kind == ATTN_LOCAL:
            f = attn_flops(cfg, seq, cfg.window)
        elif kind in (MLA_DENSE, MLA_MOE):
            f = mla_flops(cfg, seq)
        elif kind == RGLRU:
            f = rglru_flops(cfg)
        else:
            raise ValueError(kind)
        if kind in (ATTN_MOE, MLA_MOE):
            f += moe_flops(cfg)
        else:
            f += mlp_flops(cfg.d_model, cfg.d_ff, cfg.mlp_variant)
        return float(f)

    # the audio frontend's K codebook embeddings and heads
    n_k = cfg.n_codebooks if cfg.frontend == "audio" else 1

    def layer_params(kind: str) -> int:
        # the analytic counter over a 1-layer pseudo-config
        one = dc.replace(cfg, n_layers=1, pattern=(kind,), tail=())
        base = T.count_params(one)
        emb = one.padded_vocab * one.d_model * n_k
        head = one.d_model * one.padded_vocab * n_k
        return (base - emb - head - one.d_model) * param_bytes_per

    unit_flops, unit_bytes = [], []
    for pat, n in T.segments_of(cfg):
        for _ in range(n):
            unit_flops.append(float(sum(layer_flops(kind) for kind in pat)
                                    * seq))
            unit_bytes.append(int(sum(layer_params(kind) for kind in pat)))
    smashed = [float(seq * cfg.d_model * param_bytes_per)] * len(unit_flops)
    vp = cfg.padded_vocab * n_k
    return SplitProfile(
        name=cfg.name,
        unit_fwd_flops=unit_flops,
        unit_param_bytes=unit_bytes,
        smashed_bytes_per_sample=smashed,
        head_flops=float(2 * cfg.d_model * vp * seq),
        head_param_bytes=2 * vp * cfg.d_model * param_bytes_per,
        smashed_trailing_dim=[cfg.d_model] * len(unit_flops),
    )


@dataclasses.dataclass
class RoundCost:
    """One vehicle's (or one SL chain's) round cost."""
    comm_bytes_up: float
    comm_bytes_down: float
    t_client_compute: float
    t_server_compute: float
    t_comm: float
    energy_j: float

    @property
    def comm_bytes(self) -> float:
        return self.comm_bytes_up + self.comm_bytes_down

    @property
    def latency(self) -> float:
        return self.t_client_compute + self.t_server_compute + self.t_comm


def sfl_client_round_cost(profile: SplitProfile, cut: int, n_batches: int,
                          batch: int, rate_bps: float, client_flops: float,
                          server_flops: float, local_epochs: int = 1,
                          tx_power_w: float = 0.5,
                          compute_power_w: float = 15.0,
                          include_model_transfer: bool = True,
                          wire: str = "none",
                          wire_k: Optional[float] = None) -> RoundCost:
    """One SFL round for one vehicle: K local epochs of (client fwd ->
    smashed up -> server fwd/bwd -> grad down -> client bwd), then the
    client-model upload and the fresh-copy download."""
    steps = n_batches * local_epochs
    up, down = effective_comm_bytes(profile, cut, steps, batch, wire, wire_k,
                                    include_model_transfer)
    up, down = float(up), float(down)
    c_fwd = profile.client_fwd_flops(cut) * batch
    s_fwd = profile.server_fwd_flops(cut) * batch
    t_client = steps * c_fwd * (1 + BWD_FWD_RATIO) / client_flops
    t_server = steps * s_fwd * (1 + BWD_FWD_RATIO) / server_flops
    t_comm = (up + down) / max(rate_bps / 8, 1e-9)       # rate in bits/s
    energy = (compute_power_w * t_client
              + tx_power_w * (up * 8 / max(rate_bps, 1e-9)))
    return RoundCost(up, down, t_client, t_server, t_comm, energy)


@dataclasses.dataclass
class RoundCostArrays:
    """Per-vehicle round cost; every field an np array over the fleet (and
    optionally a candidate-cut axis)."""
    comm_bytes_up: np.ndarray
    comm_bytes_down: np.ndarray
    t_client_compute: np.ndarray
    t_server_compute: np.ndarray
    t_comm: np.ndarray
    energy_j: np.ndarray

    @property
    def comm_bytes(self) -> np.ndarray:
        return self.comm_bytes_up + self.comm_bytes_down

    @property
    def latency(self) -> np.ndarray:
        return self.t_client_compute + self.t_server_compute + self.t_comm


def sfl_round_cost_arrays(profile: SplitProfile, cuts, n_batches, batch: int,
                          rates_bps, client_flops, server_flops: float,
                          local_epochs: int = 1, tx_power_w=0.5,
                          compute_power_w=15.0,
                          include_model_transfer: bool = True,
                          wire: str = "none", wire_k: Optional[float] = None,
                          model_upload=True) -> RoundCostArrays:
    """:func:`sfl_client_round_cost` over the fleet; everything broadcasts.
    Under faults, pass each vehicle's *performed* steps as ``n_batches``
    (with ``local_epochs=1``) and a ``model_upload`` mask, so a dropout is
    charged only the work it did."""
    cuts = np.asarray(cuts, dtype=np.int64)
    fwd_cum = np.concatenate([[0.0], np.cumsum(profile.unit_fwd_flops)])
    steps = np.asarray(n_batches) * local_epochs
    up, down = effective_comm_bytes(profile, cuts, steps, batch, wire,
                                    wire_k, include_model_transfer,
                                    model_upload)
    c_fwd = fwd_cum[cuts] * batch
    s_fwd = (fwd_cum[-1] - fwd_cum[cuts] + profile.head_flops) * batch
    t_client = steps * c_fwd * (1 + BWD_FWD_RATIO) / np.asarray(client_flops)
    t_server = steps * s_fwd * (1 + BWD_FWD_RATIO) / server_flops
    rate = np.asarray(rates_bps, dtype=np.float64)
    t_comm = (up + down) / np.maximum(rate / 8, 1e-9)
    energy = (np.asarray(compute_power_w) * t_client
              + np.asarray(tx_power_w) * (up * 8 / np.maximum(rate, 1e-9)))
    b = np.broadcast_arrays(up, down, t_client, t_server, t_comm, energy)
    return RoundCostArrays(*[np.asarray(a, dtype=np.float64) for a in b])


def fl_round_cost_arrays(profile: SplitProfile, n_batches, batch: int,
                         rates_bps, client_flops, local_epochs: int = 1,
                         tx_power_w=0.5, compute_power_w=15.0
                         ) -> RoundCostArrays:
    """:func:`fl_client_round_cost` over the fleet."""
    steps = np.asarray(n_batches) * local_epochs
    full = float(profile.full_param_bytes())
    fwd = (profile.client_fwd_flops(profile.n_units)
           + profile.head_flops) * batch
    t_client = steps * fwd * (1 + BWD_FWD_RATIO) / np.asarray(client_flops)
    rate = np.asarray(rates_bps, dtype=np.float64)
    t_comm = 2 * full / np.maximum(rate / 8, 1e-9)
    energy = (np.asarray(compute_power_w) * t_client
              + np.asarray(tx_power_w) * (full * 8 / np.maximum(rate, 1e-9)))
    b = np.broadcast_arrays(np.full_like(t_client, full),
                            np.full_like(t_client, full),
                            t_client, np.zeros_like(t_client), t_comm, energy)
    return RoundCostArrays(*[np.asarray(a, dtype=np.float64) for a in b])


def fl_client_round_cost(profile: SplitProfile, n_batches: int, batch: int,
                         rate_bps: float, client_flops: float,
                         local_epochs: int = 1, tx_power_w: float = 0.5,
                         compute_power_w: float = 15.0) -> RoundCost:
    """FL: the full model trains on the vehicle; model up and down once a
    round."""
    steps = n_batches * local_epochs
    full = profile.full_param_bytes()
    fwd = (profile.client_fwd_flops(profile.n_units)
           + profile.head_flops) * batch
    t_client = steps * fwd * (1 + BWD_FWD_RATIO) / client_flops
    t_comm = 2 * full / max(rate_bps / 8, 1e-9)
    energy = (compute_power_w * t_client
              + tx_power_w * (full * 8 / max(rate_bps, 1e-9)))
    return RoundCost(full, full, t_client, 0.0, t_comm, energy)


def sl_round_cost(profile: SplitProfile, cut: int,
                  n_batches_per_client: Sequence[int], batch: int,
                  rates_bps: Sequence[float], client_flops: Sequence[float],
                  server_flops: float, local_epochs: int = 1) -> RoundCost:
    """Sequential SL: vehicles served one after another (their times add
    up); the vehicle-side model hops vehicle -> vehicle between turns."""
    up = down = t_c = t_s = t_comm = energy = 0.0
    for nb, r, cf in zip(n_batches_per_client, rates_bps, client_flops):
        c = sfl_client_round_cost(profile, cut, nb, batch, r, cf,
                                  server_flops, local_epochs,
                                  include_model_transfer=True)
        up += c.comm_bytes_up
        down += c.comm_bytes_down
        t_c += c.t_client_compute
        t_s += c.t_server_compute
        t_comm += c.t_comm
        energy += c.energy_j
    return RoundCost(up, down, t_c, t_s, t_comm, energy)
