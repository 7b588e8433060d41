"""Device resolution and float32 precision for the port.

Every entry point (``api.run``, ``api.build_engine``, ``FederationSim``)
resolves its device here.  The default is ``cuda``: with no card and no
explicit ``device="cpu"`` the call raises — it never falls back to the CPU,
so a number measured on the CPU can never be mistaken for a device number.

This is also the one place the port sets matmul precision: TF32 is turned
off for both matmuls and cuDNN convolutions.  cuDNN runs float32 convolutions
in TF32 by default (about three decimal digits), which would put the card's
ResNet numbers far outside the parity tolerances held against the CPU and
the JAX reference.  bfloat16 and float16 matmuls keep float32 partial
sums too (``allow_bf16_reduced_precision_reduction`` and
``allow_fp16_reduced_precision_reduction`` off): cuBLAS may otherwise add
the partial sums of a split-K GEMM in 16 bits, where the reference's dot
accumulates in float32 and rounds once.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_float32_precision() -> None:
    """Full float32 for matmuls and convolutions (TF32 off), and float32
    partial sums in bfloat16 and float16 matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``.  Raises when a CUDA device is asked for (or
    defaulted to) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' explicitly to run on the CPU")
        set_float32_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    return dev


def device_name(device: Optional[torch.device]) -> str:
    """Human-readable device name for diagnostics."""
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
