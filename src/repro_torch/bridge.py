"""Carry parameters between the JAX reference and the port.

The reference draws its initial parameters (``fedsim.FederationSim.reset``,
``models/resnet.py``, ``models/mlp_unit.py``) and its ResNet data with
threefry ``jax.random``, which torch cannot replay.  Parity tests therefore
hand the reference's arrays to the port through this bridge: the reference's
``(units, head)`` with every leaf turned into a numpy array
(``np.asarray``) on one side, the port's tensors on the other.

Layouts: 4-D leaves are convolution weights, HWIO in the reference and OIHW
in the port; every other leaf (BatchNorm, dense / MLP weights, biases) is
carried as is.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)                 # HWIO -> OIHW
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
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
