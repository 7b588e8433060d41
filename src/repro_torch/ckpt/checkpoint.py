"""Tree <-> ``.npz`` checkpointing (twin of ``repro.ckpt.checkpoint``) over
the port's trees of tensors (nested dicts / lists / tuples).

Leaves are stored under their tree path (``"segments/0/3/1/mixer/wq"``);
restore rebuilds into a reference tree (``like``) so structure, dtypes and
devices round-trip exactly.  Files are named ``ckpt_{step:08d}.npz`` as in
the reference; writes are atomic (tmp file + rename), so a killed run never
leaves a torn checkpoint.

:func:`restore_reference_checkpoint` reads the JAX package's LM
checkpoints into a port LM parameter tree.  The reference keys a leaf by
its pytree path (``"['segments']/[0]/[1]/['mixer']/['A_log']"``), with
each segment's periods stacked along a leading axis and bfloat16 leaves
widened exactly to float32; the port keeps one entry a period
(``segments[segment][period][position]``), so each port leaf reads its
period's slice of the stacked leaf.  Only numpy is needed.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

# a tree path as (is a dict key, key or index) pairs
_Path = Tuple[Tuple[bool, Any], ...]


def _paths(tree):
    """(path, leaf) pairs in the tree's order, the path's steps joined by
    "/"."""
    return [("/".join(str(k) for _, k in steps), leaf)
            for steps, leaf in _typed_paths(tree)]


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


def _typed_paths(tree, prefix: _Path = ()) -> List[Tuple[_Path, Any]]:
    """(path, leaf) pairs in the tree's order, each path step marked as a
    dict key or a sequence index."""
    if isinstance(tree, dict):
        items = [((True, k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [((False, i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for step, v in items:
        out += _typed_paths(v, prefix + (step,))
    return out


def _reference_key(path: _Path) -> str:
    """The reference's ``"/".join(str(p) for p in path)`` of a pytree path:
    ``['name']`` for a dict key, ``[i]`` for a sequence index."""
    return "/".join(f"[{k!r}]" if is_key else f"[{k}]"
                    for is_key, k in path)


def restore_reference_checkpoint(directory: str, step: int,
                                 like: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's checkpoint of ``step`` (``ckpt_{step:08d}.npz``,
    written by ``repro.ckpt.save_checkpoint`` of an LM parameter tree) in
    the structure of the port LM parameter tree ``like``
    (``segments[segment][period][position]``), each leaf in the dtype and
    on the device of ``like``'s.  A leaf under ``segments`` reads its
    period's slice of the reference's stacked leaf, which must hold as
    many periods as ``like``'s segment; a leaf the reference widened from
    bfloat16 to float32 is cast back exactly.  A missing key raises
    ``KeyError``, a shape that does not match ``ValueError``."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        flat = dict(data)
    leaves = []
    for steps, ref in _typed_paths(like):
        if steps[0] == (True, "segments"):
            # (segments, segment, period, position, ...) -> the reference's
            # (segments, segment, position, ...), sliced at the period
            seg, period = steps[1][1], steps[2][1]
            key = _reference_key(steps[:2] + steps[3:])
            lead = (len(like["segments"][seg]),)
        else:
            key, period, lead = _reference_key(steps), None, ()
        if key not in flat:
            raise KeyError(f"reference checkpoint missing leaf {key}")
        ref = torch.as_tensor(ref)
        arr = flat[key]
        if tuple(arr.shape) != lead + tuple(ref.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{lead + tuple(ref.shape)}")
        if period is not None:
            arr = np.ascontiguousarray(arr[period])
        leaves.append(torch.from_numpy(arr).to(device=ref.device,
                                               dtype=ref.dtype))
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
