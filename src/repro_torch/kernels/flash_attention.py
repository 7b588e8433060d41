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
float16 at d 64 or 128 (``HOPPER_FORWARD_DIMS``) that TMA can map, the
bfloat16 archs' prefills and a float16 smollm's forward: FlashAttention-3's
shape, a TMA producer warpgroup and wgmma consumer warpgroups.  ``"mma"``
(``kernels/csrc/lm.cu``) takes the rest: float32, 16-bit d 32 / 256 and
views TMA cannot map.  The Hopper kernel refuses
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
forward is the kernel (the plain version on the CPU), which also writes
each row's log-sum-exp ``lse`` (b, h, sq) in float32 (+inf for a row with
no visible key); its backward is the backward kernel
``repro_flash_attention_backward`` (``kernels/csrc/lm.cu``), which replaces
no TPU kernel (the JAX package's flash_attention has no custom_vjp; JAX
differentiates ``attention_ref``): the gradients from q, k, v, lse and the
cotangent, no atomics, with :func:`attention_backward_plain` its plain
version for CPU tensors.  :func:`flash_backward_route` picks its route
before the launch (``BACKWARD_ROUTE_LAUNCHES`` counts them): ``"hopper"``
(``kernels/csrc/flash_hopper_bwd.cu``) for 16-bit d 128 or 256
(``HOPPER_BACKWARD_DIMS``) that TMA can map, FlashAttention-3's backward in
two launches (dQ with D, then dK / dV: a TMA producer and two wgmma
consumer warpgroups each); ``"mma"`` (``lm.cu``) for the rest,
FlashAttention-2's in three (D, dK / dV, dQ).  The two rules differ: 16-bit
d 64 runs its forward on the Hopper route and its backward on the mma
route, 16-bit d 256 the other way round.
Either call counts as one launch.  Its gradients come in q's dtype, from
float32 math on the 16-bit inputs as they are.  Bound on H100:
operations, 10 d flops a visible pair and head for the five products
(either route runs S and dP three times, and on 16-bit inputs splits p
and dS into hi / lo halves as the forward splits p: 24 d).
The backward is a Function of its own (``_FlashBackward``) where a
``torch.func`` transform wraps its inputs: its ``vmap`` rule folds the
replicas into the batch, so ``vmap`` of ``grad`` makes one kernel call.
The forward's ``vmap`` rule folds the vmapped axis into the batch, ``(n,
b, ...) -> (n*b, ...)``, one kernel call: q, k and v are activations in
every caller (no parameter carries the axis; an unbatched one is
expanded).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import fold_replicas
from repro_torch.kernels.quant import FLOAT_CODES, launch

HEAD_DIMS = (32, 64, 128, 256)   # 32: the reduced configs
MASKED = -1e30
ROUTES = {"mma": 0, "hopper": 1}   # the C dispatchers' route argument
# the 16-bit head dims the Hopper kernels take: the forward's
# (csrc/flash_hopper.cu) and the backward's (csrc/flash_hopper_bwd.cu)
HOPPER_FORWARD_DIMS = (64, 128)
HOPPER_BACKWARD_DIMS = (128, 256)
# kernel launches by route (LAUNCHES["flash_attention"] counts them all),
# and the backward's (LAUNCHES["flash_attention_backward"])
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
BACKWARD_ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def _tma_ok(*tensors: torch.Tensor) -> bool:
    """Whether TMA can map every tensor: its ``data_ptr`` 16-byte aligned,
    the batch, sequence and head strides multiples of 8 elements (16-bit),
    the trailing stride 1."""
    return all(t.data_ptr() % 16 == 0 and t.stride(-1) == 1
               and all(s % 8 == 0 for s in t.stride()[:3]) for t in tensors)


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: Optional[float] = None) -> str:
    """The kernel route a CUDA call takes: ``"hopper"`` (wgmma / TMA,
    ``csrc/flash_hopper.cu``) for bfloat16 or float16 q, k and v at a head
    dim of ``HOPPER_FORWARD_DIMS`` (64, 128) that TMA can map (every
    ``data_ptr`` 16-byte aligned, the batch, sequence and head strides
    multiples of 8 elements, the trailing stride 1), with at least one key
    and a positive scale; ``"mma"`` (``csrc/lm.cu``) for everything
    else."""
    ok = (q.dtype in (torch.bfloat16, torch.float16)
          and q.dtype == k.dtype == v.dtype
          and q.shape[-1] in HOPPER_FORWARD_DIMS
          and k.shape[1] > 0 and (scale is None or scale > 0)
          and _tma_ok(q, k, v))
    return "hopper" if ok else "mma"


def flash_backward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor,
                         scale: Optional[float] = None) -> str:
    """The backward kernels' route: ``"hopper"`` (``csrc/flash_hopper_bwd.cu``)
    for bfloat16 or float16 q, k, v and cotangent ``do`` of one dtype at a
    head dim of ``HOPPER_BACKWARD_DIMS`` (128, 256) that TMA can map (as
    :func:`flash_route`), with at least one query and one key and a
    positive scale; ``"mma"`` (``csrc/lm.cu``) for everything else.  Not
    the forward's rule: d 64 goes to the mma route here, d 256 to the
    Hopper route."""
    ok = (q.dtype in (torch.bfloat16, torch.float16)
          and q.dtype == k.dtype == v.dtype == do.dtype
          and q.shape[-1] in HOPPER_BACKWARD_DIMS
          and q.shape[1] > 0 and k.shape[1] > 0
          and (scale is None or scale > 0) and _tma_ok(q, k, v, do))
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


def _scores(q, k, causal, window, scale):
    """The masked float32 scores (b, kv, g, sq, sk) (masked: MASKED) and
    the mask (sq, sk)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qh = q.reshape(b, sq, kv, h // kv, d).float()
    s = torch.einsum("bsngd,btnd->bngst", qh, k.float()) * scale
    mask = _mask(sq, sk, causal, window, q.device)
    return s.masked_fill(~mask, MASKED), mask


def _plain_forward(q, k, v, causal, window, scale):
    """(o, lse): :func:`attention_plain`'s output and each row's
    log-sum-exp of its scaled scores (b, h, sq) in float32, +inf for a row
    with no visible key, as the kernels write it."""
    b, sq, h, d = q.shape
    s, mask = _scores(q, k, causal, window, scale)
    seen = mask.any(dim=-1)[:, None]
    p = torch.where(seen, torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bngst,btnd->bsngd", p, v.float())
    lse = torch.where(seen[..., 0], torch.logsumexp(s, dim=-1), math.inf)
    return (o.reshape(b, sq, h, d).to(q.dtype),
            lse.reshape(b, h, sq))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (b,sq,h,d), k/v (b,sk,kv,d) -> (b,sq,h,d).  GQA by head grouping."""
    b, sq, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s, mask = _scores(q, k, causal, window, scale)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1)[:, None], p, 0.0)
    o = torch.einsum("bngst,btnd->bsngd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, lse: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: int = 0,
                             scale: Optional[float] = None):
    """(dq, dk, dv) of :func:`attention_plain` at q, k, v for the cotangent
    ``do``, in closed form (FlashAttention-2's) from the forward's ``lse``
    (b, h, sq): P = exp(S scale - lse) on the visible pairs, dP = dO V^T,
    D = rowsum(P o dP), dS = P o (dP - D), dV = P^T dO, dK = scale dS^T Q,
    dQ = scale dS K; float32 math, the gradients in q's dtype.  D is the
    softmax backward's sum, as the vjp forms it (not rowsum(dO o O): a
    16-bit O is rounded)."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.reshape(b, sq, kv, g, d).float()
    dof = do.reshape(b, sq, kv, g, d).float()
    kf, vf = k.float(), v.float()
    # a masked score is MASKED: its p is 0, and so is a row's with no
    # visible key (lse +inf)
    s, _ = _scores(q, k, causal, window, scale)
    p = torch.exp(s - lse.reshape(b, kv, g, sq, 1))
    dp = torch.einsum("bsngd,btnd->bngst", dof, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dv = torch.einsum("bngst,bsngd->btnd", p, dof)
    dk = torch.einsum("bngst,bsngd->btnd", ds, qf) * scale
    dq = torch.einsum("bngst,btnd->bsngd", ds, kf) * scale
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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
    return _Flash.apply(q, k, v, bool(causal), int(window), float(scale))[0]


def _check_cuda(*ts: torch.Tensor) -> None:
    """Raise unless the CUDA tensors ``ts`` take the kernels: a head dim
    of HEAD_DIMS and a contiguous trailing dim."""
    if ts[0].device.type != "cuda":
        raise ValueError(f"q is on unsupported device {ts[0].device}")
    if ts[0].shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {ts[0].shape[-1]} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("q, k, v (and the cotangent) need a contiguous "
                         "trailing dim")


def _attend(q, k, v, causal: bool, window: int, scale: float, *,
            route: Optional[str] = None):
    """(o, lse): the plain version for CPU tensors, the kernel for CUDA
    ones: on the route :func:`flash_route` picks, or on ``route`` (a test
    forcing ``"mma"`` at a shape the Hopper route takes; the Hopper kernel
    refuses a shape it does not take, and the call raises)."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if q.device.type == "cpu":
        return _plain_forward(q, k, v, causal, window, scale)
    _check_cuda(q, k, v)
    route = route or flash_route(q, k, v, scale)
    if route not in ROUTES:
        raise ValueError(f"route {route!r} not in {tuple(ROUTES)}")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, sq, sk, h, kv, d,
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
           int(window), float(scale), FLOAT_CODES[q.dtype], ROUTES[route])
    ROUTE_LAUNCHES[route] += 1
    return o, lse


def _forward(q, k, v, causal: bool, window: int, scale: float, *,
             route: Optional[str] = None) -> torch.Tensor:
    """The output of :func:`_attend`."""
    return _attend(q, k, v, causal, window, scale, route=route)[0]


def _backward(q, k, v, lse, do, causal: bool, window: int, scale: float,
              *, route: Optional[str] = None):
    """(dq, dk, dv): :func:`attention_backward_plain` for CPU tensors, the
    backward kernels for CUDA ones (one call counted, whatever the
    kernels it launches) on the route :func:`flash_backward_route` picks,
    or on ``route`` (a test forcing ``"mma"`` at a shape the Hopper route
    takes; the Hopper kernels refuse a shape they do not take, and the
    call raises); the gradients contiguous, in q's dtype."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, lse, do, causal=causal,
                                        window=window, scale=scale)
    if do.stride(-1) != 1:
        do = do.contiguous()
    _check_cuda(q, k, v, do)
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if (tuple(do.shape) != (b, sq, h, d) or tuple(lse.shape) != (b, h, sq)
            or tuple(v.shape) != (b, sk, kv, d) or h % kv):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, the cotangent "
                         f"{tuple(do.shape)} and lse {tuple(lse.shape)} do "
                         f"not pair")
    if (not q.dtype == k.dtype == v.dtype == do.dtype
            or q.dtype not in FLOAT_CODES or lse.dtype != torch.float32):
        raise TypeError(f"q, k, v and the cotangent must share one dtype of "
                        f"{tuple(FLOAT_CODES)} and lse be float32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}, "
                        f"{lse.dtype}")
    if not all(t.device == q.device for t in (k, v, lse, do)):
        raise ValueError("q, k, v, lse and the cotangent must be on one "
                         "device")
    route = route or flash_backward_route(q, k, v, do, scale)
    if route not in ROUTES:
        raise ValueError(f"route {route!r} not in {tuple(ROUTES)}")
    lse = lse.contiguous()
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, kv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    launch("flash_attention_backward", q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, kv, d,
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *do.stride()[:3], int(causal), int(window), float(scale),
           FLOAT_CODES[q.dtype], ROUTES[route])
    BACKWARD_ROUTE_LAUNCHES[route] += 1
    return dq, dk, dv


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, lse: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: int = 0,
                             scale: Optional[float] = None):
    """(dq, dk, dv) of :func:`flash_attention` at q, k, v for the
    cotangent ``do``, from the forward's ``lse`` (b, h, sq): the backward
    kernel for CUDA tensors, :func:`attention_backward_plain` for CPU
    ones; under ``torch.func.vmap`` one call for every replica."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _call_backward(q, k, v, lse, do, bool(causal), int(window),
                          float(scale))


def _call_backward(q, k, v, lse, do, causal, window, scale):
    """The backward Function where a ``torch.func`` transform wraps an
    input (its ``vmap`` rule), the dispatcher directly otherwise."""
    if any(map(torch._C._functorch.is_functorch_wrapped_tensor,
               (q, k, v, lse, do))):
        return _FlashBackward.apply(q, k, v, lse, do, causal, window, scale)
    return _backward(q, k, v, lse, do, causal, window, scale)


def _unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    """A folded ``(n*b, ...)`` result back to ``(n, b, ...)``."""
    return t.reshape(n, -1, *t.shape[1:])


class _FlashBackward(torch.autograd.Function):
    """flash's gradient as a Function of its own, so that under
    ``torch.func.vmap`` of ``grad`` (the fl round), where the backward
    receives batched tensors, its ``vmap`` rule folds the replicas into the
    batch: one kernel call."""

    @staticmethod
    def forward(q, k, v, lse, do, causal, window, scale):
        return _backward(q, k, v, lse, do, causal, window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, q, k, v, lse, do, causal, window, scale):
        n = info.batch_size
        grads = _call_backward(*(fold_replicas(t, dim, n) for t, dim in
                                 zip((q, k, v, lse, do), in_dims[:5])),
                               causal, window, scale)
        return tuple(_unfold(t, n) for t in grads), (0, 0, 0)


class _Flash(torch.autograd.Function):
    """(o, lse); lse is not differentiable."""

    @staticmethod
    def forward(q, k, v, causal, window, scale):
        return _attend(q, k, v, causal, window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale = inputs
        lse = output[1]
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, lse)
        ctx.opts = (causal, window, scale)

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, lse = ctx.saved_tensors
        return (*_call_backward(q, k, v, lse, g, *ctx.opts), None, None,
                None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale):
        n = info.batch_size
        o, lse = _Flash.apply(*(fold_replicas(t, dim, n) for t, dim in
                                zip((q, k, v), in_dims[:3])),
                              causal, window, scale)
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)
