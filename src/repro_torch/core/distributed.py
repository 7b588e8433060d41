"""Split-inference serving steps of the LM lane (the serving half of
``repro.core.distributed``; paper §IV-C).

``make_prefill_step`` / ``make_decode_step`` run the vehicle-side periods,
send the smashed activations across the cut, and run the RSU-side periods
and the head.  With ``compress_smashed`` the smashed tensor crosses as int8:
the vehicle quantizes and the RSU dequantizes with the codec kernels
(:mod:`repro_torch.kernels.quant`), the forward value of the reference's
``fake_quant``.  The training step, and the mesh placement of the smashed
tensor (``smashed_sharding``), are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core import split as SP
from repro_torch.kernels import quant


@dataclasses.dataclass
class DistOptions:
    cut: int = 2
    compress_smashed: bool = False
    smashed_sharding: Optional[Any] = None

    def __post_init__(self):
        if self.smashed_sharding is not None:
            raise NotImplementedError("smashed_sharding (the mesh placement "
                                      "of the smashed tensor) is not ported "
                                      "yet")


def _cross(smashed, opts: DistOptions):
    """The smashed tensor as the RSU receives it."""
    if not opts.compress_smashed:
        return smashed
    q, scales = quant.quantize_int8(smashed)          # vehicle
    return quant.dequantize_int8(q, scales, dtype=smashed.dtype)   # RSU


def make_prefill_step(cfg: ArchConfig, opts: DistOptions,
                      capacity: int) -> Callable:
    """Prefill: vehicle-side periods over the prompt, one smashed upload,
    RSU-side periods fill their caches.  ``step(params, batch)`` returns
    (last-position logits (b, 1, V), (client caches, server caches))."""
    cut = SP.clamp_cut(cfg, opts.cut)

    def prefill_step(params, batch):
        client, server = SP.split_params(params, cfg, cut)
        smashed, positions, c_caches = SP.client_forward(
            client, cfg, batch, cut, "prefill", capacity=capacity)
        logits, s_caches = SP.server_forward(
            server, cfg, _cross(smashed, opts), positions, cut, "prefill",
            capacity=capacity)
        return logits[:, -1:], (c_caches, s_caches)

    return prefill_step


def make_decode_step(cfg: ArchConfig, opts: DistOptions,
                     capacity: int) -> Callable:
    """Decode: ONE new token against the caches.  ``step(params, batch,
    caches, pos)`` returns (logits (b, 1, V), caches)."""
    cut = SP.clamp_cut(cfg, opts.cut)

    def decode_step(params, batch, caches, pos: int):
        client, server = SP.split_params(params, cfg, cut)
        c_caches, s_caches = caches
        smashed, positions, c_caches = SP.client_forward(
            client, cfg, batch, cut, "decode", caches=c_caches,
            capacity=capacity, pos_offset=pos)
        logits, s_caches = SP.server_forward(
            server, cfg, _cross(smashed, opts), positions, cut, "decode",
            caches=s_caches, capacity=capacity)
        return logits, (c_caches, s_caches)

    return decode_step
