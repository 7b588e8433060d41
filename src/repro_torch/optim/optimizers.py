"""Functional optimizers over trees of tensors (twin of ``repro.optim``).

``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; :func:`apply_updates` adds the updates.  The arithmetic follows
the reference op for op — adam is ``-lr*(m/bc1)/(sqrt(v/bc2)+eps)`` with
float32 ``bc = 1 - b**count`` — so ``torch.optim.Adam`` (which rounds its
denominator differently) is deliberately not used.  States mirror the
parameter tree, so the engines can slice an RSU state to a cut suffix.

``lr`` is a float or a schedule of the step count (:mod:`.schedules`).
Everything stays on tensors, with no host read (no ``.item()``) and no
copy from the host (constants are fills), so
``torch.func.vmap(opt.update)`` steps stacked replicas
(``CohortEngine._bucket_vmap``) and :func:`clip_by_global_norm` never
waits on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def _count0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=_first_leaf(params).device)


def _lr(lr: Schedule, count: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(count)
    # a fill, not a copy from the host: a CUDA copy from pageable memory
    # waits for the stream, and an update must not
    return torch.full((), lr, dtype=torch.float32, device=count.device)


def from_name(name: str, lr: Schedule) -> Optimizer:
    """Optimizer by config name (adam | sgd | momentum)."""
    if name == "adam":
        return adam(lr)
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr)
    raise ValueError(f"unknown optimizer {name!r} "
                     f"(expected adam | sgd | momentum)")


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return {"count": _count0(params)}

    def update(grads, state, params=None):
        step = _lr(lr, state["count"])
        upd = tree_map(lambda g: -step * g.to(torch.float32), grads)
        return upd, {"count": state["count"] + 1}

    return Optimizer(init, update)


def momentum(lr: Schedule, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"count": _count0(params),
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params)}

    def update(grads, state, params=None):
        step = _lr(lr, state["count"])
        mu = tree_map(lambda m, g: beta * m + g.to(torch.float32),
                      state["mu"], grads)
        if nesterov:
            upd = tree_map(lambda m, g: -step * (beta * m
                                                 + g.to(torch.float32)),
                           mu, grads)
        else:
            upd = tree_map(lambda m: -step * m, mu)
        return upd, {"count": state["count"] + 1, "mu": mu}

    return Optimizer(init, update)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return adamw(lr, b1, b2, eps, weight_decay=0.0)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam with decoupled weight decay: ``-lr * weight_decay * p`` added
    to the Adam update (the reference's order)."""
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"count": _count0(params),
                "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params=None):
        c = state["count"] + 1
        step = _lr(lr, state["count"])
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_
                     + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        cf = c.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full((), b1, dtype=torch.float32,
                                       device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.full((), b2, dtype=torch.float32,
                                       device=cf.device), cf)
        def upd(m_, v_, p):
            u = -step * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u - step * weight_decay * p.to(torch.float32)
            return u

        updates = tree_map(upd, m, v, params if params is not None else m)
        return updates, {"count": c, "m": m, "v": v}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype),
                    params, updates)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a device
    scalar)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-9))``.  Returns
    (clipped grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm
