"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Each wrapper runs its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.  ``LAUNCHES`` counts kernel
launches per wrapper (incremented only where a kernel is launched), so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

KERNELS = ("quantize_int8", "dequantize_int8", "sparsify_quant_pack",
           "unpack_dequant", "unpack_dequant_matmul", "rmsnorm",
           "rmsnorm_backward", "flash_attention", "flash_attention_backward",
           "ssd_chunk_scan")
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def fold_replicas(t, dim, n: int):
    """A ``vmap`` rule's input with its replica axis (``dim``, or None
    where it is shared: expanded) folded into the leading batch axis, so
    the kernel takes all ``n`` replicas in one call."""
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:])
