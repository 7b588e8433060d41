"""Learning-rate schedules of the step count (twin of
``repro.optim.schedules``): each maps the optimizer's int32 ``count``
tensor to a float32 learning rate with tensor ops only, so a schedule runs
under ``torch.func.vmap`` and never reads the device from the host."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda count: torch.full((), lr, dtype=torch.float32,
                                    device=count.device)


def linear_warmup(lr: float, warmup_steps: int):
    def f(count):
        frac = torch.clamp(count.to(torch.float32) / max(warmup_steps, 1),
                           max=1.0)
        return lr * frac
    return f


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def f(count):
        frac = torch.clamp(count.to(torch.float32) / max(decay_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return lr * ((1 - alpha) * cos + alpha)
    return f


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  alpha: float = 0.0):
    def f(count):
        c = count.to(torch.float32)
        warm = lr * c / max(warmup_steps, 1)
        frac = torch.clamp((c - warmup_steps)
                           / max(decay_steps - warmup_steps, 1), 0.0, 1.0)
        cos = lr * ((1 - alpha) * 0.5 * (1.0 + torch.cos(math.pi * frac))
                    + alpha)
        return torch.where(c < warmup_steps, warm, cos)
    return f
