"""Functional optimizers over trees of tensors (twin of ``repro.optim``).

``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; :func:`apply_updates` adds the updates.  ``update_(grads, state,
params, scale)`` is the donated form of ``update`` + ``apply_updates`` (the
torch counterpart of XLA's per-leaf fusion with the state's buffers
donated): ``params`` and ``grads`` are lists of leaves in the tree's
order, and it walks them one leaf at a time, clip (``scale``, from
:func:`clip_scale`) -> moments -> update -> parameter, writing the moments
and the parameter into their own storage and dropping each gradient from
``grads`` once used.  The extra memory is a few scratch slices of at most
CHUNK values.  Every value is the functional form's bit for bit: the same
operations in the same order with the same roundings (a slice is a slice
of elementwise work; ``b1*m + (1-b1)*g`` stays two products and one sum).
The arithmetic follows the reference op for op — adam is ``-lr*(m/bc1)/(sqrt(v/bc2)+eps)`` with
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


# the elementwise work of the in-place step and of :func:`global_norm`
# over a leaf runs in slices of at most this many values (64 MiB of
# float32), so its scratch stays a few slices whatever the leaf's size
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)
    # (grads list, state, params list, clip scale or None) -> new state;
    # moments and parameters written in place, grads consumed
    update_: Callable[..., Any]


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


def _chunks(*leaves):
    """Matching flat slices of at most CHUNK values of same-shaped leaves
    (one whole-leaf slice when a leaf is not contiguous)."""
    if not all(t.is_contiguous() for t in leaves):
        return [leaves]
    return zip(*(t.view(-1).split(CHUNK) for t in leaves))


def _walk(grads, params, slots, scale):
    """Leaf by leaf, slice by slice: (parameter slice, its gradient slice
    clipped as :func:`clip_by_global_norm` clips, ``g * scale.to(g.dtype)``,
    then ``.to(float32)`` in scratch of its own, slot slices), each
    gradient taken out of ``grads`` before its slices are handed out.  No
    gradient's storage is written: autograd may hand two leaves one
    tensor."""
    for i, p in enumerate(params):
        g, grads[i] = grads[i], None
        s = None if scale is None else scale.to(g.dtype)
        pieces = _chunks(p, g, *(slot[i] for slot in slots))
        del g
        for pc, gc, *sc in pieces:
            if s is not None:
                gc = gc * s
            yield pc, gc.to(torch.float32, copy=True), sc
        pc = gc = sc = pieces = None


def _apply_(p: torch.Tensor, u: torch.Tensor) -> None:
    """``p = (p.float() + u).to(p.dtype)`` in ``p``'s storage (``u`` is
    scratch)."""
    if p.dtype == torch.float32:
        p.add_(u)
    else:
        u.add_(p)            # float32 + the exact float32 of p, commuted
        p.copy_(u)           # the rounding of .to(p.dtype)


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

    def update_(grads, state, params, scale=None):
        neg = -_lr(lr, state["count"])
        for p, gf, _ in _walk(grads, params, (), scale):
            gf.mul_(neg)                             # -step * g
            _apply_(p, gf)
        return {"count": state["count"] + 1}

    return Optimizer(init, update, update_)


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

    def update_(grads, state, params, scale=None):
        neg = -_lr(lr, state["count"])
        for p, gf, (m,) in _walk(grads, params,
                                 (tree_leaves(state["mu"]),), scale):
            m.mul_(beta).add_(gf)                    # beta * m + g
            if nesterov:
                u = m * beta
                u.add_(gf)
                u.mul_(neg)                          # -step * (beta*m + g)
            else:
                u = m * neg                          # -step * m
            _apply_(p, u)
        return {"count": state["count"] + 1, "mu": state["mu"]}

    return Optimizer(init, update, update_)


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
        bc1, bc2 = corrections(c)

        def upd(m_, v_, p):
            u = -step * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u - step * weight_decay * p.to(torch.float32)
            return u

        updates = tree_map(upd, m, v, params if params is not None else m)
        return updates, {"count": c, "m": m, "v": v}

    def corrections(c):
        cf = c.to(torch.float32)
        return tuple(1 - torch.pow(torch.full((), b, dtype=torch.float32,
                                              device=cf.device), cf)
                     for b in (b1, b2))

    def update_(grads, state, params, scale=None):
        c = state["count"] + 1
        step = _lr(lr, state["count"])
        neg, decay = -step, step * weight_decay
        bc1, bc2 = corrections(c)
        slots = (tree_leaves(state["m"]), tree_leaves(state["v"]))
        for p, gf, (m, v) in _walk(grads, params, slots, scale):
            t = torch.square(gf)
            t.mul_(1 - b2)
            v.mul_(b2).add_(t)                       # b2*v + (1-b2)*g^2
            torch.mul(gf, 1 - b1, out=t)
            m.mul_(b1).add_(t)                       # b1*m + (1-b1)*g
            torch.div(m, bc1, out=t)
            t.mul_(neg)                              # -step * (m / bc1)
            torch.div(v, bc2, out=gf)
            gf.sqrt_().add_(eps)                     # sqrt(v / bc2) + eps
            t.div_(gf)
            if weight_decay:
                gf.copy_(p)
                gf.mul_(decay)                       # step * wd * p
                t.sub_(gf)
            _apply_(p, t)
        return {"count": c, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update, update_)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype),
                    params, updates)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a device
    scalar).  A leaf of more than CHUNK values is summed by slices, so its
    float32 copy never exists whole."""
    def sq(t):
        return torch.sum(torch.square(t.to(torch.float32)))

    def leaf_sq(t):
        if t.numel() <= CHUNK or not t.is_contiguous():
            return sq(t)
        return sum(sq(c) for c in t.view(-1).split(CHUNK))

    return torch.sqrt(sum(leaf_sq(t) for t in tree_leaves(tree)))


def clip_scale(grads, max_norm: float):
    """(the factor ``min(1, max_norm / (norm + 1e-9))``, the global norm)
    of :func:`clip_by_global_norm`; ``update_`` takes the factor."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-9))``.  Returns
    (clipped grads, the norm before clipping)."""
    scale, norm = clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm
