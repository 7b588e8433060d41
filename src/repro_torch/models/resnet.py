"""ResNet18 as 9 split units (twin of ``repro.models.resnet``).

The stack is [stem] + 8 BasicBlocks; the paper's 9 split points are the unit
boundaries.  Three layout rules keep the port numerically on top of the
reference:

* **NHWC at every unit boundary.**  The cut-boundary wire groups along the
  trailing (channel) axis, so the smashed tensor must be NHWC like the
  reference's.  Inside a unit the convolutions run on the NCHW *view* of the
  NHWC tensor (``x.permute(0, 3, 1, 2)``, channels-last memory, no copy).
* **"SAME" padding is computed, not assumed.**  With stride 2 on an even
  input JAX pads 3x3 convolutions by (0, 1) on H and W, so the port pads
  explicitly with ``F.pad`` and convolves with ``padding=0``
  (``padding=1`` would shift the sampling grid by one pixel).  1x1 stride-2
  projections take no pad.
* **BatchNorm uses batch statistics in train and eval**, with the
  population variance — written out, because ``nn.BatchNorm2d`` in eval mode
  uses running statistics.

Conv weights are OIHW (PyTorch's layout); ``repro_torch.bridge`` converts
the reference's HWIO weights.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

N_UNITS = 9          # stem + 8 basic blocks (the paper's 9 split points)
STAGE_CHANNELS = (64, 64, 128, 128, 256, 256, 512, 512)
STAGE_STRIDES = (1, 1, 2, 1, 2, 1, 2, 1)


def _conv_init(gen: torch.Generator, kh, kw, cin, cout) -> torch.Tensor:
    fan_in = kh * kw * cin
    return torch.randn((cout, cin, kh, kw), generator=gen) \
        * math.sqrt(2.0 / fan_in)


def _bn_init(c) -> Params:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def init_resnet18(gen: torch.Generator, n_classes: int = 10) -> Params:
    """Random init with the reference's recipe (He-normal convs, unit BN,
    1/sqrt(512) head) drawn from a torch generator on the CPU."""
    units: List[Params] = [{"conv": _conv_init(gen, 3, 3, 3, 64),
                            "bn": _bn_init(64)}]
    cin = 64
    for cout, stride in zip(STAGE_CHANNELS, STAGE_STRIDES):
        blk = {"conv1": _conv_init(gen, 3, 3, cin, cout),
               "bn1": _bn_init(cout),
               "conv2": _conv_init(gen, 3, 3, cout, cout),
               "bn2": _bn_init(cout)}
        if stride != 1 or cin != cout:
            blk["proj"] = _conv_init(gen, 1, 1, cin, cout)
            blk["bn_proj"] = _bn_init(cout)
        units.append(blk)
        cin = cout
    head = {"w": torch.randn((512, n_classes), generator=gen)
            * math.sqrt(1.0 / 512),
            "b": torch.zeros(n_classes)}
    return {"units": units, "head": head}


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """(lo, hi) padding of XLA's "SAME" for size n, kernel k, stride s."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC x, OIHW w -> NHWC, "SAME" padding."""
    xn = x.permute(0, 3, 1, 2)                      # NCHW view, no copy
    kh, kw = w.shape[2], w.shape[3]
    ph = _same_pad(xn.shape[2], kh, stride)
    pw = _same_pad(xn.shape[3], kw, stride)
    if any(ph) or any(pw):
        xn = F.pad(xn, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xn, w, stride=stride)
    return y.permute(0, 2, 3, 1)


def _bn(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), keepdim=True, unbiased=False)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * p["scale"] + p["bias"]


def apply_unit(p: Params, x: torch.Tensor, idx: int) -> torch.Tensor:
    """Unit ``idx`` on an NHWC tensor; returns NHWC."""
    if idx == 0:
        return torch.relu(_bn(p["bn"], _conv(x, p["conv"], 1)))
    stride = STAGE_STRIDES[idx - 1]
    h = torch.relu(_bn(p["bn1"], _conv(x, p["conv1"], stride)))
    h = _bn(p["bn2"], _conv(h, p["conv2"], 1))
    sc = x
    if "proj" in p:
        sc = _bn(p["bn_proj"], _conv(x, p["proj"], stride))
    return torch.relu(h + sc)


def _hw_at(cut: int) -> int:
    """Spatial size of the activation at split point `cut` (32x32 inputs)."""
    if cut <= 3:
        return 32
    return 32 // (2 ** min((cut - 2) // 2, 3))


def smashed_shape(cut: int, batch: int) -> Tuple[int, ...]:
    """NHWC activation shape at split point `cut` for 32x32 inputs."""
    if not 1 <= cut <= N_UNITS:
        raise ValueError(f"cut={cut} outside [1, {N_UNITS}]")
    ch = 64 if cut == 1 else STAGE_CHANNELS[cut - 2]
    hw = _hw_at(cut)
    return (batch, hw, hw, ch)


def unit_flops(idx: int) -> int:
    """Forward matmul FLOPs per sample for unit idx (3x3 convs dominate)."""
    if idx == 0:
        return 2 * 32 * 32 * 3 * 3 * 3 * 64
    cout = STAGE_CHANNELS[idx - 1]
    cin = 64 if idx == 1 else STAGE_CHANNELS[idx - 2]
    stride = STAGE_STRIDES[idx - 1]
    hw_out = _hw_at(idx + 1) if idx < N_UNITS - 1 else 4
    f = 2 * hw_out * hw_out * 3 * 3 * cin * cout          # conv1
    f += 2 * hw_out * hw_out * 3 * 3 * cout * cout        # conv2
    if stride != 1 or cin != cout:
        f += 2 * hw_out * hw_out * cin * cout
    return f
