"""RMSNorm: ``x * rsqrt(mean(x^2) + eps) * scale`` over the trailing dim.

Replaces the Pallas TPU kernel of ``repro/kernels/rmsnorm.py``
(``rmsnorm`` -> ``_rmsnorm_kernel``).  The CUDA kernel
(``kernels/csrc/lm.cu``, ``repro_rmsnorm``) computes in float32 with one
block per row; it takes float32 only (the bf16 input of the reference is
still to port).

Bound on H100: bytes.  Each value is read once and written once with a
handful of flops, so the floor is 2 * rows * d * 4 bytes over 3.35 TB/s.
The design reads the row with float4 loads where d % 4 == 0 (scalar loads
otherwise), reduces the sum of squares with warp shuffles and one
shared-memory step, and re-reads the row from cache for the scaled write.

:func:`rmsnorm_plain` is the plain PyTorch version (twin of
``repro.kernels.ref.rmsnorm_ref``); the wrapper runs it for CPU tensors
only.  CUDA tensors always go to the kernel, or the wrapper raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant import launch

EPS = 1e-6


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = EPS) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _forward(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    d = x.shape[-1]
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"x is on unsupported device {x.device}")
    if x.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"the rmsnorm kernel takes float32 (got {x.dtype}, "
                        f"{scale.dtype}); bf16 is not ported yet")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous for the CUDA kernel")
    y = torch.empty_like(x)
    launch("rmsnorm", x.device, x.data_ptr(), scale.data_ptr(), y.data_ptr(),
           x.numel() // d if d else 0, d, eps)
    return y


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
        _, vjp = torch.func.vjp(
            lambda a, s: rmsnorm_plain(a, s, ctx.eps), x, scale)
        gx, gs = vjp(g)
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
    both.  Where nothing records a gradient and no ``torch.func``
    transform is active, it calls the kernel (or the plain version)
    without the autograd Function."""
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
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return ((torch.is_grad_enabled()
             and (x.requires_grad or scale.requires_grad))
            or wrapped(x) or wrapped(scale))
