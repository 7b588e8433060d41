"""Tree <-> ``.npz`` checkpointing (twin of ``repro.ckpt.checkpoint``) over
the port's trees of tensors (nested dicts / lists / tuples).

Leaves are stored under their tree path (``"segments/0/3/1/mixer/wq"``);
restore rebuilds into a reference tree (``like``) so structure, dtypes and
devices round-trip exactly.  Files are named ``ckpt_{step:08d}.npz`` as in
the reference; writes are atomic (tmp file + rename), so a killed run never
leaves a torn checkpoint.  The port's per-period layout differs from the
reference's stacked segments, so a JAX checkpoint is not read here.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import tree_map


def _paths(tree, prefix=""):
    """(path, leaf) pairs in the tree's order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for path, leaf in _paths(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()       # .npz has no bfloat16: widened exactly
        flat[path] = t.numpy()
    return flat


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **_flatten(tree))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.fullmatch(r"ckpt_(\d+)\.npz", f))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: Any) -> Any:
    """The checkpoint of ``step`` in the structure of ``like``, each leaf
    in the dtype and on the device of ``like``'s."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        flat = dict(data)
    keys = iter(p for p, _ in _paths(like))

    def load(ref):
        key = next(keys)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        ref = torch.as_tensor(ref)
        arr = flat[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{tuple(ref.shape)}")
        return torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)

    return tree_map(load, like)
