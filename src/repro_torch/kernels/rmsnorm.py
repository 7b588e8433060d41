"""RMSNorm: ``x * rsqrt(mean(x^2) + eps) * scale`` over the trailing dim,
and its gradient.

The forward replaces the Pallas TPU kernel of ``repro/kernels/rmsnorm.py``
(``rmsnorm`` -> ``_rmsnorm_kernel``); the backward replaces no TPU kernel
(the JAX package differentiates ``rmsnorm_ref`` by autodiff).  Both CUDA
kernels (``kernels/csrc/lm.cu``, ``repro_rmsnorm`` and
``repro_rmsnorm_backward``) take x in float32, bfloat16 or float16 and the
scale in float32 or x's dtype, compute in float32 and write x's dtype (the
backward's dscale in the scale's), as ``rmsnorm_ref`` does.  Any other
dtype raises ``TypeError``.

Bound on H100: bytes.  The forward reads x and writes y, the backward reads
x and dy and writes dx, with a few flops a value.  Each row is read once
into registers in 16-byte vectors and written from them: a warp a row up to
1024 float32 (2048 16-bit) values, with the sums by warp shuffles alone; a
block a row up to 8192 float32; a scalar block that reads the row again
otherwise (d not a multiple of the vector, an unaligned pointer).  The
backward's dscale is a column sum over the rows: each block keeps partials
while it walks its rows, writes one row of them, and a second kernel sums
them in a fixed order, so two runs agree bit for bit (no atomics).

:func:`rmsnorm_plain` and :func:`rmsnorm_backward_plain` (its closed-form
gradient) are the plain PyTorch versions (twins of
``repro.kernels.ref.rmsnorm_ref`` and its vjp); the wrappers run them for
CPU tensors only.  CUDA tensors always go to the kernels, or the wrappers
raise.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant import FLOAT_CODES, launch

EPS = 1e-6


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = EPS) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _grads_f32(x, scale, dy, eps):
    """float32 dx and the per-row terms of dscale (dy * x * r)."""
    xf, dyf = x.float(), dy.float()
    gdy = dyf * scale.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    dot = (gdy * xf).sum(dim=-1, keepdim=True)
    dx = r * gdy - xf * (r * r * r * dot / x.shape[-1])
    return dx, dyf * xf * r


def rmsnorm_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                           dy: torch.Tensor, eps: float = EPS):
    """The gradient of :func:`rmsnorm_plain` in closed form: per row, with
    r = rsqrt(mean(x^2) + eps), dx = r * (dy * scale) - x * r^3 *
    sum(dy * scale * x) / d, and dscale = sum over the rows of dy * x * r;
    float32 math, dx in x's dtype and dscale in the scale's."""
    dx, terms = _grads_f32(x, scale, dy, eps)
    return (dx.to(x.dtype),
            terms.reshape(-1, x.shape[-1]).sum(0).to(scale.dtype))


def _codes(x: torch.Tensor, scale: torch.Tensor):
    """The kernels' dtype codes; TypeError for a dtype they do not take."""
    if x.dtype not in FLOAT_CODES or scale.dtype not in (torch.float32,
                                                         x.dtype):
        raise TypeError(f"the rmsnorm kernels take x in "
                        f"{tuple(FLOAT_CODES)} and the scale in float32 or "
                        f"x's dtype (got {x.dtype}, {scale.dtype})")
    return FLOAT_CODES[x.dtype], FLOAT_CODES[scale.dtype]


def _on_cuda(*ts: torch.Tensor) -> bool:
    """False for CPU tensors; True for contiguous CUDA ones; raises
    otherwise."""
    if ts[0].device.type == "cpu":
        return False
    if ts[0].device.type != "cuda":
        raise ValueError(f"x is on unsupported device {ts[0].device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the rmsnorm kernels take contiguous tensors")
    return True


def _forward(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if not _on_cuda(x, scale):
        return rmsnorm_plain(x, scale, eps)
    xc, sc = _codes(x, scale)
    d = x.shape[-1]
    y = torch.empty_like(x)
    launch("rmsnorm", x.device, x.data_ptr(), scale.data_ptr(), y.data_ptr(),
           x.numel() // d if d else 0, d, eps, xc, sc)
    return y


@functools.lru_cache(maxsize=256)
def _backward_blocks(device: int, rows: int, d: int, groups: int, xc: int,
                     sc: int) -> int:
    """The backward kernel's blocks a group (its workspace is groups x
    blocks x d floats), from the card's resident blocks."""
    with torch.cuda.device(device):
        return _build.load().lib.repro_rmsnorm_backward_blocks(
            rows, d, groups, xc, sc)


def _backward(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
              eps: float, groups: int = 0):
    """(dx, dscale): the closed-form plain version for a CPU tensor, the
    backward kernel for a CUDA one.  With ``groups`` > 0, x and dy hold
    that many replicas' rows one after the other (leading dim first), the
    scale is shared (d,) or one a replica (groups, d), and dscale is
    (groups, d): each replica's own sum."""
    d = x.shape[-1]
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if not _on_cuda(x, scale, dy):
        if not groups:
            return rmsnorm_backward_plain(x, scale, dy, eps)
        dx, terms = _grads_f32(x.reshape(groups, -1, d),
                               scale.reshape(-1, 1, d),
                               dy.reshape(groups, -1, d), eps)
        return (dx.reshape(x.shape).to(x.dtype),
                terms.sum(1).to(scale.dtype))
    xc, sc = _codes(x, scale)
    n = max(groups, 1)
    rows = (x.numel() // d if d else 0) // n
    dx = torch.empty_like(x)
    dscale = torch.empty((n, d), dtype=scale.dtype, device=x.device)
    blocks = _backward_blocks(x.device.index, rows, d, n, xc, sc)
    work = torch.empty(n * blocks * d, dtype=torch.float32, device=x.device)
    launch("rmsnorm_backward", x.device, x.data_ptr(), scale.data_ptr(),
           dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(), work.data_ptr(),
           rows, d, n, blocks, int(scale.dim() == 2), eps, xc, sc)
    return dx, (dscale if groups else dscale[0])


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float = EPS):
    """(dx, dscale) of :func:`rmsnorm` at x for the cotangent dy: the
    backward kernel for CUDA tensors, :func:`rmsnorm_backward_plain` for
    CPU ones; under ``torch.func.vmap`` one call for every replica."""
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match the "
                         f"trailing dim {d} of x {tuple(x.shape)}")
    return _call_backward(x, scale, dy, eps)


def _call_backward(x, scale, dy, eps):
    """The backward Function where a ``torch.func`` transform wraps an
    input (its ``vmap`` rule), the dispatcher directly otherwise
    (``Function.apply`` costs host time on each of 65-97 calls a step)."""
    if _wrapped(x, scale, dy):
        return _RMSNormBackward.apply(x, scale, dy, eps)
    return _backward(x, scale, dy, eps)


class _RMSNormBackward(torch.autograd.Function):
    """rmsnorm's gradient as a Function of its own, so that under
    ``torch.func.vmap`` of ``grad`` (the fl round), where the backward
    receives batched tensors, its ``vmap`` rule folds the replicas into
    one kernel call and keeps each replica's dscale."""

    @staticmethod
    def forward(x, scale, dy, eps):
        return _backward(x, scale, dy, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, scale, dy, eps):
        n = info.batch_size
        xd, sd, gd = in_dims[:3]

        def stacked(t, dim):
            t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
            return t.contiguous()

        if sd is not None:
            scale = scale.movedim(sd, 0).contiguous()
        return _backward(stacked(x, xd), scale, stacked(dy, gd), eps,
                         groups=n), (0, 0)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(x, scale, eps):
        return _forward(x, scale, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, eps = inputs
        ctx.save_for_backward(x, scale)
        ctx.eps = eps

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        gx, gs = _call_backward(x, scale, g.contiguous(), ctx.eps)
        return gx, gs, None

    @staticmethod
    def vmap(info, in_dims, x, scale, eps):
        xd, sd = in_dims[0], in_dims[1]
        if sd is None:              # activations only: fold into the rows
            return _RMSNorm.apply(x.movedim(xd, 0).contiguous(), scale,
                                  eps), 0
        n = info.batch_size         # a scale per replica: one call each
        xs = [x] * n if xd is None else x.movedim(xd, 0).unbind(0)
        ss = scale.movedim(sd, 0).unbind(0)
        return torch.stack([_RMSNorm.apply(a.contiguous(), b.contiguous(),
                                           eps)
                            for a, b in zip(xs, ss)]), 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = EPS) -> torch.Tensor:
    """x (..., d), scale (d,) -> (..., d) in x's dtype; differentiable in
    both (the backward kernel for CUDA tensors).  Where nothing records a
    gradient and no ``torch.func`` transform is active, it calls the kernel
    (or the plain version) without the autograd Function."""
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match the "
                         f"trailing dim {d} of x {tuple(x.shape)}")
    if x.device != scale.device:
        raise ValueError("x and scale must be on the same device")
    if not _needs_function(x, scale):
        return _forward(x, scale, eps)
    return _RMSNorm.apply(x, scale, eps)


def _needs_function(x: torch.Tensor, scale: torch.Tensor) -> bool:
    """Whether the call needs the Function: autograd would record it, or a
    ``torch.func`` transform wraps an input (its ``vmap`` rule).  Decode
    needs neither, and ``Function.apply`` costs host time on each of its
    65-97 calls a step."""
    return ((torch.is_grad_enabled()
             and (x.requires_grad or scale.requires_grad))
            or _wrapped(x, scale))


def _wrapped(*ts: torch.Tensor) -> bool:
    """Whether a ``torch.func`` transform wraps any of ``ts``."""
    return any(map(torch._C._functorch.is_functorch_wrapped_tensor, ts))
