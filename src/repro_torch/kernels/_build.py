"""Build and load the port's CUDA library (nvcc + ctypes).

Every source in ``kernels/csrc/*.cu`` (the codec, ``codec.cu``, the LM
lane, ``lm.cu``, and flash's Hopper routes, ``flash_hopper.cu`` forward and
``flash_hopper_bwd.cu`` backward, which share ``flash_hopper.cuh``) has a
plain C interface, so each compiles in seconds with
``nvcc`` alone (no PyTorch headers).  The sources compile to objects in
parallel, one ``nvcc`` each, all started together, and link into one shared
library that ctypes loads.  The library is built at first use into
``build/kernels/`` at the repository root (listed in ``.gitignore``), named
by a hash of every source, header and the flags, so an edited source or
header rebuilds and a stale library is never loaded.

No ``--use_fast_math``: the codec is bit-exact against its plain version only
with IEEE division and round-half-to-even, and the LM kernels' tolerances
assume IEEE ``expf``.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# C entry point -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    # the codec's last int: the dtype code (kernels/csrc/codec.cu)
    "repro_quantize_int8": [_P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "repro_dequantize_int8": [_P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "repro_sparsify_quant_pack": [_P, _P, _LL, *[_I] * 6, _P],
    "repro_unpack_dequant": [_P, _P, _LL, *[_I] * 6, _P],
    "repro_unpack_dequant_matmul": [_P, _P, _P, _LL, *[_I] * 7, _P],
    # rmsnorm's last ints: x's and scale's dtype codes (as the codec's)
    "repro_rmsnorm": [_P, _P, _P, _LL, _I, _F, _I, _I, _P],
    "repro_rmsnorm_backward": [*[_P] * 6, _LL, *[_I] * 4, _F, _I, _I, _P],
    "repro_rmsnorm_backward_blocks": [_LL, *[_I] * 4],
    # flash: q, k, v, o and lse (float32, each row's log-sum-exp), then b,
    # sq, sk, h, kv, d, q / k / v's strides, causal, window, scale, the
    # dtype code of q / k / v / o (as the codec's) and, for the
    # dispatcher, the route (0 mma.sync, 1 Hopper)
    "repro_flash_attention": [*[_P] * 5, *[_I] * 6, *[_LL] * 9, _I, _I, _F,
                              _I, _I, _P],
    "repro_flash_attention_hopper": [*[_P] * 5, *[_I] * 6, *[_LL] * 9, _I,
                                     _I, _F, _I, _P],
    # its gradient: q, k, v, dO, lse, D (float32 scratch), dq, dk, dv, then
    # b, sq, sk, h, kv, d, q / k / v / dO's strides, causal, window, scale,
    # the dtype code and, for the dispatcher, the route (0 mma.sync, 1
    # Hopper)
    "repro_flash_attention_backward": [*[_P] * 9, *[_I] * 6, *[_LL] * 12, _I,
                                       _I, _F, _I, _I, _P],
    "repro_flash_attention_backward_hopper": [*[_P] * 9, *[_I] * 6,
                                              *[_LL] * 12, _I, _I, _F, _I,
                                              _P],
    # the dynamic shared memory of the Hopper kernels at a head dim: the
    # forward's (d), the backward's (0 dQ or 1 dK / dV, d)
    "repro_flash_hopper_smem_bytes": [_I],
    "repro_flash_hopper_bwd_smem_bytes": [_I, _I],
    # ssd's last ints: the dtype codes of x / B / C / y, of dt and of A
    "repro_ssd_chunk_scan": [*[_P] * 8, *[_I] * 7, *[_LL] * 12, _I, _I, _I,
                             _P],
    "repro_ssd_workspace_floats": [_I] * 7,
}
# entry points that return something other than a cudaError_t
RESTYPES = {"repro_ssd_workspace_floats": _LL}


def sources():
    """Every CUDA source of the port, in a fixed order."""
    return sorted(_CSRC.glob("*.cu"))


class KernelLibrary:
    """The loaded library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_s: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.build_s = build_s          # 0.0 when a cached build was loaded
        self.log = log                  # nvcc / ptxas output of the build


_LOADED: Optional[KernelLibrary] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "port's CUDA kernels cannot be built")


def _run_all(cmds):
    """Run the commands concurrently; raise with the log of any failure.
    Returns the combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    srcs = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*srcs, *sorted(_CSRC.glob("*.cuh"))):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    tag = digest.hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _BUILD_DIR / f"libreprokernels-{tag}.so"
    build_s, log = 0.0, ""
    if not so.exists():
        t0 = time.perf_counter()
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
            objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
            log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                            for src, o in zip(srcs, objs)])
            out = Path(tmp) / "lib.so"
            log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
                              *map(str, objs)]])
            os.replace(out, so)         # atomic: concurrent builders agree
        build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    _LOADED = KernelLibrary(lib, so, build_s, log)
    return _LOADED
