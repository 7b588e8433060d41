"""Flash attention: blocked online-softmax attention with causal and
sliding-window masks and GQA.

Replaces the Pallas TPU kernel of ``repro/kernels/flash_attention.py``
(``flash_attention`` -> ``_fa_kernel``) with two CUDA kernels behind one
entry (``repro_flash_attention``), which take q ``(b, sq, h, d)`` and k / v
``(b, sk, kv, d)`` of one dtype, float32, bfloat16 or float16, with ``h %
kv == 0`` and d in {32, 64, 128, 256}, read through their strides (the
trailing dim must be contiguous), and write a contiguous ``(b, sq, h, d)``
in that dtype.  As the Pallas kernel, both compute in float32 (scores,
softmax and p.v of the upcast values) and round once to q's dtype.  Query
and key positions both start at 0; a row with no visible key outputs 0.

Routes.  :func:`flash_route` picks one before the launch and passes it to
C; ``ROUTE_LAUNCHES`` counts launches per route (``LAUNCHES`` counts them
all).  ``"hopper"`` (``kernels/csrc/flash_hopper.cu``) takes bfloat16 /
float16 at d 128 that TMA can map, the bfloat16 archs' prefills:
FlashAttention-3's shape, a TMA producer warpgroup and two wgmma consumer
warpgroups.  ``"mma"`` (``kernels/csrc/lm.cu``) takes the rest: float32,
16-bit d 32 / 64 / 256 and views TMA cannot map.  The Hopper kernel refuses
what it does not take (the call raises); nothing falls back to the other
route.

Bound on H100: operations.  The causal triangle needs 4 * d flops per
visible (query, key) pair and head (q.k and p.v), which at the serving
path's prefill is ~10x the time its bytes take.  Both products run on the
tensor cores.  float32: 3xTF32 (float32 operands split into two TF32
parts, three products each), which keeps float32 accuracy: the floor is
three times the flops over the TF32 rate of 495 TFLOP/s (NVIDIA's H100 SXM
data sheet), beside the float32 floor at 67 TFLOP/s.  bfloat16 / float16:
q.k^T as one 16-bit product (exact products, float32 sums) and p.v as two
(p split into a 16-bit high and low part against the exact 16-bit v, lo.v
then hi.v): the floor is the flops of q.k^T plus twice those of p.v over
989 TFLOP/s (dense bf16 / f16).  The ``"mma"`` route is FlashAttention-2's
design: one warp per 16 query rows (32 at d 64) on mma.sync, the scores,
m, l and the output in registers, the score accumulators reused as the left
operand of p.v (P never goes through shared memory), K / V tiles
double-buffered with asynchronous copies.  The ``"hopper"`` route keeps p
in registers the same way (the A operand of a register-sourced wgmma) and
takes exp2 with the scale folded into one FFMA a score.  Both skip key
tiles above the diagonal or left of the window and start the longest
causal rows first.

:func:`attention_plain` is the plain PyTorch version (twin of
``repro.kernels.ref.attention_ref``); the wrapper runs it for CPU tensors
only.  CUDA tensors always go to the kernel, or the wrapper raises.

Autograd.  :func:`flash_attention` is a ``torch.autograd.Function``: its
forward is the kernel (the plain version on the CPU); its backward is
``torch.func.vjp`` of :func:`attention_plain` on the saved q, k and v,
plain PyTorch that recomputes the scores (the JAX package has no backward
kernel; hand-written dq / dk / dv kernels are still to be written).  On
bfloat16 q, k and v (the bf16 archs' training) the forward takes the
kernel's 16-bit route and the backward the plain version's float32 math,
its gradients in q's dtype.  Its ``vmap`` rule folds the vmapped axis into
the batch, ``(n, b, ...) -> (n*b, ...)``, one kernel call: q, k and v are
activations in every caller (no parameter carries the axis; an unbatched
one is expanded).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import fold_replicas
from repro_torch.kernels.quant import FLOAT_CODES, launch

HEAD_DIMS = (32, 64, 128, 256)   # 32: the reduced configs
MASKED = -1e30
ROUTES = {"mma": 0, "hopper": 1}   # the C dispatcher's route argument
# kernel launches by route (LAUNCHES["flash_attention"] counts them all)
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: Optional[float] = None) -> str:
    """The kernel route a CUDA call takes: ``"hopper"`` (wgmma / TMA,
    ``csrc/flash_hopper.cu``) for bfloat16 or float16 q, k and v at head
    dim 128 that TMA can map (every ``data_ptr`` 16-byte aligned, the
    batch, sequence and head strides multiples of 8 elements, the trailing
    stride 1), with at least one key and a positive scale; ``"mma"``
    (``csrc/lm.cu``) for everything else."""
    tensors = (q, k, v)
    ok = (q.dtype in (torch.bfloat16, torch.float16)
          and q.dtype == k.dtype == v.dtype and q.shape[-1] == 128
          and k.shape[1] > 0 and (scale is None or scale > 0)
          and all(t.data_ptr() % 16 == 0 and t.stride(-1) == 1
                  and all(s % 8 == 0 for s in t.stride()[:3])
                  for t in tensors))
    return "hopper" if ok else "mma"


def _mask(sq: int, sk: int, causal: bool, window: int,
          device: torch.device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (b,sq,h,d), k/v (b,sk,kv,d) -> (b,sq,h,d).  GQA by head grouping."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qh = q.reshape(b, sq, kv, g, d).float()
    s = torch.einsum("bsngd,btnd->bngst", qh, k.float()) * scale
    mask = _mask(sq, sk, causal, window, q.device)
    s = s.masked_fill(~mask, MASKED)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1)[:, None], p, 0.0)
    o = torch.einsum("bngst,btnd->bsngd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (b, sq, h, d); k/v (b, sk, kv, d); GQA when h > kv.  Returns
    (b, sq, h, d); differentiable in q, k and v."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (b,sq,h,d) and k = v (b,sk,kv,d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, kv, dk = k.shape
    if k.shape[0] != b or dk != d or h % kv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"pair (batch, head_dim, heads % kv_heads)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on the same device")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in FLOAT_CODES:
        raise TypeError(f"q, k and v must share one dtype of "
                        f"{tuple(FLOAT_CODES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    return _Flash.apply(q, k, v, bool(causal), int(window), float(scale))


def _forward(q, k, v, causal: bool, window: int, scale: float, *,
             route: Optional[str] = None):
    """The plain version for CPU tensors, the kernel for CUDA ones: on the
    route :func:`flash_route` picks, or on ``route`` (a test forcing
    ``"mma"`` at a shape the Hopper route takes; the Hopper kernel refuses
    a shape it does not take, and the call raises)."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"q is on unsupported device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous trailing dim")
    route = route or flash_route(q, k, v, scale)
    if route not in ROUTES:
        raise ValueError(f"route {route!r} not in {tuple(ROUTES)}")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), o.data_ptr(), b, sq, sk, h, kv, d, *q.stride()[:3],
           *k.stride()[:3], *v.stride()[:3], int(causal), int(window),
           float(scale), FLOAT_CODES[q.dtype], ROUTES[route])
    ROUTE_LAUNCHES[route] += 1
    return o


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, causal, window, scale):
        return _forward(q, k, v, causal, window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale = inputs
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        _, vjp = torch.func.vjp(
            lambda a, b, c: attention_plain(a, b, c, **ctx.opts), q, k, v)
        return (*vjp(g), None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale):
        n = info.batch_size
        o = _Flash.apply(*(fold_replicas(t, dim, n) for t, dim in
                           zip((q, k, v), in_dims[:3])),
                         causal, window, scale)
        return o.reshape(n, -1, *o.shape[1:]), 0
