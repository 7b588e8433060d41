"""Carry parameters between the JAX reference and the port.

The reference draws its initial parameters (``fedsim.FederationSim.reset``,
``models/resnet.py``, ``models/mlp_unit.py``, ``transformer.init_params``)
and its ResNet data with threefry ``jax.random``, which torch cannot
replay.  Parity tests therefore hand the reference's arrays to the port
through this bridge: the reference's trees with every leaf turned into a
numpy array (``np.asarray``) on one side, the port's tensors on the other.

ResNet / MLP lane, ``(units, head)``: 4-D leaves are convolution weights,
HWIO in the reference and OIHW in the port; every other leaf (BatchNorm,
dense / MLP weights, biases) is carried as is.

LM lane: :func:`lm_params_to_torch` unstacks each segment's leading period
axis into the port's per-period entries
(``segments[segment][period][position]``) and keeps the einsum layouts and
each leaf's dtype (MLA's projections and ``kv_norm``, an MoE FFN's experts,
shared MLP and its float32 ``router`` are per-period slices like any leaf);
:func:`lm_params_to_numpy` stacks them back, so a round trip is exact.
A bfloat16 leaf (numpy's is ``ml_dtypes.bfloat16``, which neither
``torch.from_numpy`` nor ``Tensor.numpy`` takes) crosses as a view of its
bits as int16, so it too is carried bit for bit.
:func:`lm_units_to_torch` / :func:`lm_units_to_numpy` do the same for the
``TransformerUnitModel`` layout ``(units, head)``.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

_LM_TOP = ("embed", "head", "final_norm")


def _tensor(a) -> torch.Tensor:
    """A numpy array -> a tensor that owns a copy of it, bfloat16 too."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a numpy array (``ml_dtypes.bfloat16`` for bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)                 # HWIO -> OIHW
    return _tensor(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    a = _array(t)
    if a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)                 # OIHW -> HWIO
    return np.ascontiguousarray(a)


def params_to_torch(units, head, device="cpu") -> Tuple[list, Any]:
    """Reference-layout arrays ``(units, head)`` -> port tensors."""
    return ([tree_map(lambda a: _to_torch(a, device), u) for u in units],
            tree_map(lambda a: _to_torch(a, device), head))


def params_to_numpy(units, head) -> Tuple[list, Any]:
    """Port tensors ``(units, head)`` -> reference-layout numpy arrays."""
    return ([tree_map(_to_numpy, u) for u in units], tree_map(_to_numpy, head))


def lm_params_to_torch(params, cfg, device="cpu"):
    """Reference LM params (numpy leaves, segments stacked over periods)
    -> the port's params (per-period entries)."""
    from repro_torch.models import transformer as T

    def conv(a):
        return _tensor(a).to(device)

    out = {k: tree_map(conv, params[k]) for k in _LM_TOP}
    out["segments"] = [
        [tuple(tree_map(lambda a: conv(np.asarray(a)[i]), seg[j])
               for j in range(len(pat))) for i in range(n)]
        for (pat, n), seg in zip(T.segments_of(cfg), params["segments"])]
    return out


def lm_params_to_numpy(params, cfg):
    """Inverse of :func:`lm_params_to_torch`: numpy leaves, each segment's
    layers stacked along a leading period axis (tuples, as the reference
    keeps them)."""
    from repro_torch.models import transformer as T

    out = {k: tree_map(_array, params[k]) for k in _LM_TOP}
    out["segments"] = tuple(
        tuple(tree_map(lambda *xs: np.stack([_array(x) for x in xs]),
                       *[period[j] for period in seg])
              for j in range(len(pat)))
        for (pat, _), seg in zip(T.segments_of(cfg), params["segments"]))
    return out


def lm_units_to_torch(units, head) -> Tuple[list, Any]:
    """The reference's ``TransformerUnitModel`` layout (unit 0 ``{"embed"}``,
    then one unit per period: a tuple of per-layer dicts whose leaves carry
    a leading period axis of size 1; numpy leaves) -> the port's (the same
    tuples without that axis)."""
    out = [tree_map(_tensor, units[0])]
    out += [tree_map(lambda a: _tensor(np.asarray(a)[0]), u)
            for u in units[1:]]
    return out, tree_map(_tensor, head)


def lm_units_to_numpy(units, head) -> Tuple[list, Any]:
    """Inverse of :func:`lm_units_to_torch`."""
    out = [tree_map(_array, units[0])]
    out += [tree_map(lambda t: _array(t)[None], tuple(u)) for u in units[1:]]
    return out, tree_map(_array, head)
