"""Mamba2 SSD chunk scan (state-space duality, arXiv:2405.21060).

Replaces the Pallas TPU kernel of ``repro/kernels/ssd.py``
(``ssd_chunk_scan`` -> ``_ssd_kernel``).  Inputs: x ``(b, s, h, p)``, dt
``(b, s, h)`` (already softplus'ed), A ``(h,)`` (negative), B / C
``(b, s, g, n)`` with ``h / g`` heads per group.  Unlike the TPU kernel,
which kept the recurrent state in scratch memory and dropped it, this one
returns the final state ``(b, h, n, p)`` beside y: the prefill cache needs
it.

The CUDA kernels (``kernels/csrc/lm.cu``, ``repro_ssd_chunk_scan``) take
x, B and C in float32, bfloat16 or float16 (one dtype) and dt and A each
in float32 or x's dtype, with p <= 64, n <= 128 and chunk <= 256, reading
x / dt / B / C through their strides (trailing dims of x, B and C
contiguous).  As the reference's kernel, they widen every input to float32
as they load it, keep every intermediate (prefix sums, C.B^T, chunk
states) and the returned state in float32, and write y in x's dtype,
rounded once.

Bound on H100: operations.  With C.B^T computed once per (batch, group,
chunk), the chunked form needs ~1.96e10 flops at mamba2-780m's prefill
(C.B^T, scores @ x, C.H and the state update) against ~0.2 GB of inputs
and outputs.  The design is Mamba2's own chunked decomposition
(arXiv:2405.21060 section 6), four kernels behind this one call: the
prefix sums of dt*A; C.B^T once per group, shared by its heads; per
(batch, head) the chunks' own states walked in order, with the
inter-chunk pass in registers; then per 128-row tile of a chunk C.H for
the incoming state and the intra-chunk tiles.  Every product runs on the
tensor cores in 3xTF32 (float32 operands split into two TF32 parts, three
products each), which keeps float32 accuracy: the floor is three times
the flops over the TF32 rate of 495 TFLOP/s (NVIDIA's H100 SXM data
sheet), 0.12 ms at that shape, beside the float32 floor at 67 TFLOP/s,
0.29 ms.  The intermediates (prefix sums, C.B^T, the chunks' incoming
states) live in a scratch tensor this wrapper allocates.

:func:`ssd_chunked` (twin of ``repro.models.ssm.ssd_chunked``) is the plain
PyTorch version the wrapper runs for CPU tensors only; :func:`ssd_naive`
(twin of ``repro.kernels.ref.ssd_naive``, the literal recurrence) is the
ground truth of the tests.  CUDA tensors always go to the kernel, or the
wrapper raises.

Autograd.  :func:`ssd_chunk_scan` is a ``torch.autograd.Function``: its
forward is the kernels (the plain version on the CPU); its backward is
``torch.func.vjp`` of :func:`ssd_chunked` on the saved inputs, plain
PyTorch that recomputes the chunked scan (the JAX package has no backward
kernel; a hand-written reverse chunk scan is still to be written); each
gradient comes back in its input's dtype, as ``jax.vjp`` of the
reference gives it.  The
state's gradient may be ``None`` (training drops the state): the backward
then differentiates y alone.  Its ``vmap`` rule folds a vmapped axis that only
the activations x, dt, B and C carry into the batch ``b`` (one call);
where ``A`` carries it (``-exp(A_log)`` of a parameter per replica, as
under ``CohortEngine``'s ``vmap``) it loops over the replicas, one call
each.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, fold_replicas
from repro_torch.kernels.quant import FLOAT_CODES, launch

MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 64, 128, 256


def ssd_chunked(x, dt, A, B, C, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,s,h,p), dt (b,s,h) [post-softplus], A (h,) [<0], B,C (b,s,g,n).
    Returns y (b,s,h,p) and the final state (b,h,n,p) f32."""
    b, s, h, p_ = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // chunk
    xc = x.reshape(b, nc, chunk, h, p_).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()
    Cc = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()

    la = dtc * A                                       # (b,nc,q,h), <= 0
    cum = torch.cumsum(la, dim=2)                      # inclusive
    total = cum[:, :, -1]                              # (b,nc,h)

    # intra-chunk (the quadratic "attention-like" block).  The mask goes
    # on the exponent, before exp: above the diagonal cum_i - cum_j > 0 can
    # overflow exp to inf, which the reference masks after exp -- the same
    # forward, but its gradient there is 0 * inf = NaN.
    cb = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    ci = cum.permute(0, 1, 3, 2)                       # (b,nc,h,q)
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()
    decay = torch.exp(torch.where(mask, ci[..., :, None] - ci[..., None, :],
                                  -torch.inf))
    scores = cb * decay
    dtj = dtc.permute(0, 1, 3, 2)                      # (b,nc,h,q_j)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", scores * dtj[..., None, :],
                           xc)

    # per-chunk outgoing state: sum_j exp(total - cum_j) dt_j B_j x_j
    w = torch.exp(total[:, :, None, :] - cum) * dtc    # (b,nc,q,h)
    S = torch.einsum("bcjhn,bcjhp->bchnp", Bc * w[..., None], xc)

    # inter-chunk recurrence
    state = torch.zeros((b, h, n, p_), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = torch.exp(total[:, c])[..., None, None] * state + S[:, c]
    hprev = torch.stack(prev, dim=1)                   # (b,nc,h,n,p)
    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           Cc * torch.exp(cum)[..., None], hprev)
    y = (y_intra + y_inter).reshape(b, s + pad, h, p_)[:, :s]
    return y.to(x.dtype), state


def ssd_naive(x, dt, A, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(s * n * p) literal recurrence.  Returns (y, final state)."""
    b, s, h, p_ = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=2).float()
    Ch = C.repeat_interleave(rep, dim=2).float()
    xf, dtf = x.float(), dt.float()
    state = torch.zeros((b, h, n, p_), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        a = torch.exp(dtf[:, t] * A)[..., None, None]
        upd = torch.einsum("bhn,bhp->bhnp", Bh[:, t] * dtf[:, t, :, None],
                           xf[:, t])
        state = a * state + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,s,h,p), dt (b,s,h) [post-softplus], A (h,) [<0], B/C (b,s,g,n).
    Returns y (b,s,h,p) and the final state (b,h,n,p) f32, differentiable
    in x, dt, A, B and C."""
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"need x (b,s,h,p), dt (b,s,h), B = C (b,s,g,n); "
                         f"got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, p_ = x.shape
    g, n = B.shape[2], B.shape[3]
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B.shape[:2]) != (b, s) or h % g):
        raise ValueError(f"shapes do not pair: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}")
    if not (x.device == dt.device == A.device == B.device == C.device):
        raise ValueError("x, dt, A, B and C must be on the same device")
    return _SSD.apply(x, dt, A, B, C, int(chunk))


def _forward(x, dt, A, B, C, chunk: int):
    """The plain version for CPU tensors, the kernels for CUDA ones."""
    b, s, h, p_ = x.shape
    g, n = B.shape[2], B.shape[3]
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"x is on unsupported device {x.device}")
    if (x.dtype not in FLOAT_CODES or not x.dtype == B.dtype == C.dtype
            or any(t.dtype not in (torch.float32, x.dtype) for t in (dt, A))):
        raise TypeError(f"the ssd_chunk_scan kernel takes x, B and C of one "
                        f"dtype in {tuple(FLOAT_CODES)} and dt, A in float32 "
                        f"or x's dtype; got x {x.dtype}, dt {dt.dtype}, A "
                        f"{A.dtype}, B {B.dtype}, C {C.dtype}")
    if p_ > MAX_HEAD_DIM or n > MAX_STATE or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"head_dim {p_} > {MAX_HEAD_DIM}, d_state {n} > "
                         f"{MAX_STATE} or chunk {chunk} outside "
                         f"[1, {MAX_CHUNK}]")
    if any(t.stride(-1) != 1 for t in (x, B, C)) or not A.is_contiguous():
        raise ValueError("x, B and C need a contiguous trailing dim and A "
                         "must be contiguous")
    y = torch.empty((b, s, h, p_), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, n, p_), dtype=torch.float32, device=x.device)
    # the kernels' intermediates: cum / dt, C.B^T per group, chunk states
    work = torch.empty(
        _build.load().lib.repro_ssd_workspace_floats(b, s, h, p_, g, n, chunk),
        dtype=torch.float32, device=x.device)
    launch("ssd_chunk_scan", x.device, x.data_ptr(), dt.data_ptr(),
           A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
           state.data_ptr(), work.data_ptr(), b, s, h, p_, g, n, chunk,
           *x.stride()[:3], *dt.stride(), B.stride(0), B.stride(1),
           B.stride(2), C.stride(0), C.stride(1), C.stride(2),
           FLOAT_CODES[x.dtype], FLOAT_CODES[dt.dtype], FLOAT_CODES[A.dtype])
    return y, state


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(x, dt, A, B, C, chunk):
        return _forward(x, dt, A, B, C, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, A, B, C, chunk = inputs
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, gy, gstate):
        inputs = ctx.saved_tensors
        if gy is None and gstate is None:
            return (None,) * 6
        chunk = ctx.chunk
        if gstate is None:
            _, vjp = torch.func.vjp(
                lambda *a: ssd_chunked(*a, chunk)[0], *inputs)
            grads = vjp(gy)
        else:
            _, vjp = torch.func.vjp(
                lambda *a: ssd_chunked(*a, chunk), *inputs)
            if gy is None:
                gy = torch.zeros_like(inputs[0])
            grads = vjp((gy, gstate))
        return (*grads, None)

    @staticmethod
    def vmap(info, in_dims, x, dt, A, B, C, chunk):
        n = info.batch_size
        acts = (x, dt, B, C)
        act_dims = (in_dims[0], in_dims[1], in_dims[3], in_dims[4])
        if in_dims[2] is None:      # activations only: fold into the batch
            fx, fdt, fB, fC = (fold_replicas(t, d, n)
                               for t, d in zip(acts, act_dims))
            y, state = _SSD.apply(fx, fdt, A, fB, fC, chunk)
            return ((y.reshape(n, -1, *y.shape[1:]),
                     state.reshape(n, -1, *state.shape[1:])), (0, 0))

        def slot(t, dim, i):        # an A per replica: one call each
            return t if dim is None else t.select(dim, i).contiguous()

        outs = [_SSD.apply(*(slot(t, d, i) for t, d in
                             zip((x, dt, A, B, C), in_dims[:5])), chunk)
                for i in range(n)]
        return ((torch.stack([o[0] for o in outs]),
                 torch.stack([o[1] for o in outs])), (0, 0))
